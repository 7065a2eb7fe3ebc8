"""Trainer: optimizer factories, the train step, fit, validate and predict.

Counterpart of ``replay_tpu/nn/train.py`` on one device. The JAX trainer jits
one SPMD program over a mesh; here :meth:`Trainer.train_step` runs eagerly on
one card, and :meth:`Trainer.train_steps` (``fit(scan_chunk=K)``), the JAX
``lax.scan`` of K steps, is one CUDA graph of K steps per chunk length,
replayed with one launch (:mod:`replay_tpu_torch.nn.graphs`), fed by a
device-prefetch stage (:mod:`replay_tpu_torch.data.nn.prefetch`). The mesh,
sharding, remat and the production features of ``fit`` (checkpoints,
recovery, loggers, tracing, health) are later slices (``ROADMAP.md`` queue 1). ``precision="bf16"`` is the JAX trainer's: the model
computes in bf16 while the flat parameter buffer, the optimizer state and the
sentinel stay f32 (:mod:`replay_tpu_torch.nn.precision`).

What carries over exactly:

* The optimizers are optax's, written as torch ops over one flat f32 buffer of
  all parameters: ``adam`` with coupled L2 decay (``add_decayed_weights``
  chained in front), ``adamw`` with decoupled decay, ``sgd`` with optional
  momentum (``trace``), ``clip_by_global_norm`` first in the chain, and the
  learning-rate schedules evaluated as functions of the optimizer's own step
  count, as optax evaluates them (not ``torch.optim.lr_scheduler``'s stepping).
* The non-finite sentinel: a NaN/Inf loss or gradient norm leaves parameters
  and optimizer state as they were (``torch.where``, no host sync), while
  ``step`` advances and ``bad_steps`` counts the skip.
* The ``valid`` row flags gate the target mask, so batch-padding rows carry no
  loss.

PyTorch idiom inside: the model's parameters are views into the state's flat
buffer, so the model always computes with the state it was last bound to, and
a step updates that buffer, the optimizer state and ``bad_steps`` in place —
the JAX step donates its state, so the old state is as dead there as here, and
a captured chunk keeps reading and writing the same tensors. The loss's callbacks are the model's own
``get_logits`` and ``get_item_weights``, and autograd adds every gradient of
the tied item table (input embedding, K3's ``dW``, the label gather).
"""

from __future__ import annotations

import functools
import inspect
import itertools
import logging
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from replay_tpu_torch.data.nn.prefetch import DevicePrefetcher, prefetch as prefetch_batches
from replay_tpu_torch.device import DeviceLike, resolve_device, to_device
from replay_tpu_torch.metrics.builder import MetricsBuilder
from replay_tpu_torch.nn.graphs import Graph, capture
from replay_tpu_torch.nn.precision import Precision

logger = logging.getLogger("replay_tpu_torch")

Batch = Dict[str, Any]
OptState = List[Dict[str, torch.Tensor]]
Schedule = Callable[[torch.Tensor], Any]


def _signature_names(func) -> List[str]:
    if func is None:
        return []
    return [p.name for p in inspect.signature(func).parameters.values() if p.name != "self"]


# --------------------------------------------------------------------------- #
# Learning-rate schedules: optax's, as functions of an int32 count tensor
# --------------------------------------------------------------------------- #
def _constant(value: float) -> Schedule:
    return lambda count: value


def _exponential_decay(init_value: float, transition_steps: int, decay_rate: float) -> Schedule:
    """optax.exponential_decay(staircase=True, transition_begin=0)."""
    if transition_steps <= 0 or decay_rate == 0:
        return _constant(init_value)

    def schedule(count):
        p = torch.floor(count / transition_steps)
        return torch.where(count <= 0, init_value, init_value * torch.pow(decay_rate, p))

    return schedule


def _linear(init_value: float, end_value: float, transition_steps: int) -> Schedule:
    """optax.linear_schedule (polynomial_schedule with power 1, transition_begin=0)."""
    if transition_steps <= 0:
        return _constant(init_value)

    def schedule(count):
        count = torch.clamp(count, 0, transition_steps)
        frac = 1 - count / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def _cosine_decay(init_value: float, decay_steps: int, alpha: float) -> Schedule:
    """optax.cosine_decay_schedule(exponent=1.0)."""
    if not decay_steps > 0:
        msg = f"The cosine_decay_schedule requires positive decay_steps, got decay_steps={decay_steps}."
        raise ValueError(msg)

    def schedule(count):
        count = torch.clamp(count.to(torch.float32), max=float(decay_steps))
        cosine_decay = 0.5 * (1 + torch.cos(math.pi * count / float(decay_steps)))
        return init_value * ((1 - alpha) * cosine_decay + alpha)

    return schedule


def _warmup_cosine(init_value: float, peak_value: float, warmup_steps: int, decay_steps: int) -> Schedule:
    """optax.warmup_cosine_decay_schedule(end_value=0.0): join at ``warmup_steps``."""
    warmup = _linear(init_value, peak_value, warmup_steps)
    decay = _cosine_decay(peak_value, decay_steps - warmup_steps, 0.0)

    def schedule(count):
        return torch.where(count < warmup_steps, warmup(count), decay(count - warmup_steps))

    return schedule


@dataclass
class LRSchedulerFactory:
    """Learning-rate schedule factory.

    ``kind="constant"`` | ``"step"`` (decay by ``gamma`` every ``step_size``
    optimizer steps, the StepLR equivalent) | ``"warmup_linear"`` (linear 0→lr
    over ``warmup_steps``) | ``"warmup_cosine"`` (linear warmup then cosine
    decay to 0 over ``total_steps``). The schedule is a function of the
    optimizer's step count, which advances only on steps the sentinel accepts.
    """

    kind: str = "constant"
    step_size: int = 1000
    gamma: float = 0.5
    warmup_steps: int = 100
    total_steps: int = 10_000

    def create(self, learning_rate: float) -> Schedule:
        if self.kind == "constant":
            return _constant(learning_rate)
        if self.kind == "step":
            return _exponential_decay(learning_rate, self.step_size, self.gamma)
        if self.kind == "warmup_linear":
            return _linear(0.0, learning_rate, self.warmup_steps)
        if self.kind == "warmup_cosine":
            return _warmup_cosine(0.0, learning_rate, self.warmup_steps, self.total_steps)
        msg = f"Unknown scheduler kind: {self.kind}"
        raise ValueError(msg)


# --------------------------------------------------------------------------- #
# Gradient transformations: optax's, over one flat f32 parameter buffer
# --------------------------------------------------------------------------- #
class _Transform:
    """``init(params) -> state``; ``update(updates, state, params) -> (updates, state)``."""

    def init(self, params: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def update(self, updates, state, params):
        raise NotImplementedError


def _count(params: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=params.device)


class _ScaleByAdam(_Transform):
    def __init__(self, b1: float, b2: float, eps: float = 1e-8) -> None:
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        return {"count": _count(params), "mu": torch.zeros_like(params), "nu": torch.zeros_like(params)}

    def update(self, updates, state, params):
        mu = (1 - self.b1) * updates + self.b1 * state["mu"]
        nu = (1 - self.b2) * (updates * updates) + self.b2 * state["nu"]
        count = state["count"] + 1
        mu_hat = mu / (1 - self.b1**count)
        nu_hat = nu / (1 - self.b2**count)
        return mu_hat / (torch.sqrt(nu_hat) + self.eps), {"count": count, "mu": mu, "nu": nu}


class _AddDecayedWeights(_Transform):
    def __init__(self, weight_decay: float) -> None:
        self.weight_decay = weight_decay

    def update(self, updates, state, params):
        return updates + self.weight_decay * params, state


class _Trace(_Transform):
    def __init__(self, decay: float) -> None:
        self.decay = decay

    def init(self, params):
        return {"trace": torch.zeros_like(params)}

    def update(self, updates, state, params):
        trace = updates + self.decay * state["trace"]
        return trace, {"trace": trace}


class _ScaleByLearningRate(_Transform):
    """``-lr · updates``; a schedule is evaluated at the count before this step."""

    def __init__(self, learning_rate) -> None:
        self.learning_rate = learning_rate

    def init(self, params):
        return {"count": _count(params)} if callable(self.learning_rate) else {}

    def update(self, updates, state, params):
        if not callable(self.learning_rate):
            return -self.learning_rate * updates, state
        step_size = -1 * self.learning_rate(state["count"])
        return updates * step_size, {"count": state["count"] + 1}


class _ClipByGlobalNorm(_Transform):
    """optax.clip_by_global_norm: ``(g / ‖g‖) · max_norm`` when ``‖g‖ ≥ max_norm``,
    with no epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6)."""

    def __init__(self, max_norm: float) -> None:
        self.max_norm = max_norm

    def update(self, updates, state, params):
        g_norm = global_norm(updates)
        return torch.where(g_norm < self.max_norm, updates, (updates / g_norm) * self.max_norm), state


class GradientTransformation:
    """A chain of transformations (optax.chain), state one dict per link."""

    def __init__(self, *transforms: _Transform) -> None:
        self.transforms = transforms

    def init(self, params: torch.Tensor) -> OptState:
        return [t.init(params) for t in self.transforms]

    def update(self, updates: torch.Tensor, state: OptState, params: torch.Tensor):
        new_state = []
        for transform, link in zip(self.transforms, state):
            updates, link = transform.update(updates, link, params)
            new_state.append(link)
        return updates, new_state


def global_norm(updates: torch.Tensor) -> torch.Tensor:
    """``sqrt(Σ g²)`` over the flat gradient, as optax.global_norm."""
    return torch.sqrt(torch.sum(updates * updates))


@dataclass
class OptimizerFactory:
    """Optimizer factory: ``adam`` | ``adamw`` | ``sgd`` (+ optional momentum),
    with gradient clipping and a pluggable LR schedule."""

    name: str = "adam"
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    betas: Tuple[float, float] = (0.9, 0.999)
    momentum: float = 0.0
    clip_grad_norm: Optional[float] = None
    scheduler: Optional[LRSchedulerFactory] = None

    def create(self) -> GradientTransformation:
        lr = self.scheduler.create(self.learning_rate) if self.scheduler else self.learning_rate
        b1, b2 = self.betas
        if self.name == "adam":
            links = [_ScaleByAdam(b1, b2), _ScaleByLearningRate(lr)]
            if self.weight_decay:
                links.insert(0, _AddDecayedWeights(self.weight_decay))
        elif self.name == "adamw":
            links = [_ScaleByAdam(b1, b2), _AddDecayedWeights(self.weight_decay), _ScaleByLearningRate(lr)]
        elif self.name == "sgd":
            links = [_ScaleByLearningRate(lr)]
            if self.momentum:
                links.insert(0, _Trace(self.momentum))
            if self.weight_decay:
                links.insert(0, _AddDecayedWeights(self.weight_decay))
        else:
            msg = f"Unknown optimizer: {self.name}"
            raise ValueError(msg)
        if self.clip_grad_norm:
            links.insert(0, _ClipByGlobalNorm(self.clip_grad_norm))
        return GradientTransformation(*links)


# --------------------------------------------------------------------------- #
# TrainState
# --------------------------------------------------------------------------- #
@dataclass
class TrainState:
    """Everything a train step mutates.

    ``flat_params`` holds every parameter of the model, in
    ``model.named_parameters()`` order; ``params`` maps their names to views of
    it (the model's own ``nn.Parameter`` objects once the state is bound).
    ``bad_steps`` counts optimizer updates the non-finite sentinel discarded: on
    such steps ``step`` and ``rng`` still advance, but ``params`` and
    ``opt_state`` keep their values. ``rng`` is the state of the CPU
    ``torch.Generator`` that seeds each step's dropout.
    """

    step: int
    flat_params: torch.Tensor
    params: Dict[str, torch.Tensor]
    opt_state: OptState
    bad_steps: torch.Tensor
    rng: torch.Tensor


def _where_into(good: torch.Tensor, new: OptState, old: OptState) -> None:
    """``old`` ← ``where(good, new, old)``, link by link, in place (one
    select a tensor, written over its own input)."""
    for link, before in zip(new, old):
        for key, value in link.items():
            if value is not before[key]:
                torch.where(good, value, before[key], out=before[key])


def _tree_map(fn: Callable[..., Any], *trees: Any) -> Any:
    """``fn`` over the leaves of nested dicts of the same keys."""
    if isinstance(trees[0], Mapping):
        keys = list(trees[0])
        if any(list(tree) != keys for tree in trees[1:]):
            msg = f"batches differ in their keys: {[sorted(tree) for tree in trees]}"
            raise ValueError(msg)
        return {key: _tree_map(fn, *(tree[key] for tree in trees)) for key in keys}
    return fn(*trees)


def _leaves(tree: Any) -> List[Any]:
    if isinstance(tree, Mapping):
        return [leaf for value in tree.values() for leaf in _leaves(value)]
    return [tree]


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _chunk_schedule(batches: Iterable[Batch], chunk: int):
    """Group a batch stream into ``("scan", [chunk batches])`` and, for the
    short tail, ``("step", batch)`` items, in stream order: one chunk length
    and the per-step program, never a zoo of chunk lengths. The JAX
    ``_chunk_schedule`` also breaks chunks at health steps; health is not
    ported (``ROADMAP.md`` queue 1, 'The rest of Trainer.fit')."""
    buffered: List[Batch] = []
    for batch in batches:
        buffered.append(batch)
        if len(buffered) == chunk:
            yield ("scan", list(buffered))
            buffered.clear()
    for leftover in buffered:
        yield ("step", leftover)


@dataclass
class _Placed:
    """A stacked chunk on the device, and the event its copies recorded on
    the feed stream (``None`` when it was placed on the consumer's stream)."""

    batch: Batch
    event: Optional[torch.cuda.Event] = None


@dataclass
class _ChunkGraph:
    """K optimizer steps captured as one CUDA graph: it reads the static
    ``[K, ...]`` batch, writes the state's own tensors in place and the
    per-step ``[K]`` loss, sentinel flag and gradient norm."""

    graph: Graph
    batch: Batch
    metrics: Dict[str, torch.Tensor]
    state_tensors: List[torch.Tensor]


# fit arguments of the JAX signature that the port does not have yet: passing
# one with anything but its JAX default raises, naming the ROADMAP.md item
# (the JAX scan branch lands checkpoints, recovery, health and preemption at
# chunk boundaries; here they raise with or without scan_chunk)
_UNPORTED_FIT_ARGS = {
    "checkpoint_manager": (None, "'The rest of Trainer.fit' (checkpoints)"),
    "checkpoint_every": (None, "'The rest of Trainer.fit' (checkpoints)"),
    "resume": (False, "'The rest of Trainer.fit' (checkpoints)"),
    "monitor": (None, "'The rest of Trainer.fit' (best-state tracking, early stop)"),
    "patience": (None, "'The rest of Trainer.fit' (best-state tracking, early stop)"),
    "mode": ("max", "'The rest of Trainer.fit' (best-state tracking, early stop)"),
    "loggers": (None, "'The rest of Trainer.fit' (loggers)"),
    "profile_steps": (None, "'The rest of Trainer.fit' (profiling)"),
    "profile_dir": (None, "'The rest of Trainer.fit' (profiling)"),
    "recovery": (None, "'The rest of Trainer.fit' (recovery)"),
    "detect_anomalies": (None, "'The rest of Trainer.fit' (recovery)"),
    "handle_preemption": (None, "'The rest of Trainer.fit' (recovery)"),
    "tracer": (None, "'The rest of Trainer.fit' (tracing)"),
    "trace_path": (None, "'The rest of Trainer.fit' (tracing)"),
    "metrics_port": (None, "'The rest of Trainer.fit' (loggers)"),
    "slo_rules": (None, "'The rest of Trainer.fit' (loggers)"),
    "flight_path": (None, "'The rest of Trainer.fit' (loggers)"),
}


# --------------------------------------------------------------------------- #
# Trainer
# --------------------------------------------------------------------------- #
@dataclass
class Trainer:
    """Fits, validates and predicts with a model and a loss.

    :param model: module with ``forward`` (training forward → hidden states),
        ``get_logits(hidden, candidates)`` and ``forward_inference``.
    :param loss: a :mod:`replay_tpu_torch.nn.loss` callable (or ``"ce"``); its
        ``logits_callback`` is bound per step to the model's ``get_logits``.
    :param optimizer: optimizer factory (default Adam 1e-3).
    :param seed: seeds the CPU generator that seeds each step's dropout.
    :param precision: mixed-precision rung, ``"bf16"`` / ``"f32"`` / a
        :class:`~replay_tpu_torch.nn.precision.Precision`. Applied at
        construction: the model is cloned with its compute ``dtype`` set to the
        rung's (its parameters, and so the optimizer state, stay f32), and
        loss-consumed logits are up-cast to the rung's f32 accumulation dtype.
        ``None`` (default) changes nothing.
    :param device: ``"cuda"`` by default; raises without a card unless given
        ``"cpu"``. The model is moved there.
    :param label_field / mask fields: batch keys, as in the JAX trainer.
    """

    model: Any
    loss: Any
    optimizer: OptimizerFactory = field(default_factory=OptimizerFactory)
    seed: int = 0
    feature_field: str = "feature_tensors"
    padding_mask_field: str = "padding_mask"
    label_field: str = "positive_labels"
    target_mask_field: str = "target_padding_mask"
    negative_field: str = "negative_labels"
    precision: Optional[Any] = None
    device: DeviceLike = "cuda"

    def __post_init__(self) -> None:
        if isinstance(self.loss, str):
            from replay_tpu_torch.nn import loss as loss_zoo

            if self.loss.lower() == "bce":
                msg = "loss='bce' is not ported yet: ROADMAP.md queue 1, 'Other losses'"
                raise NotImplementedError(msg)
            if self.loss.lower() != "ce":
                msg = (
                    f"Unknown loss shorthand {self.loss!r}; use 'ce', or pass a "
                    "replay_tpu_torch.nn.loss instance"
                )
                raise ValueError(msg)
            self.loss = loss_zoo.CE()
        self.precision = Precision.resolve(self.precision)
        if self.precision is not None:
            self.model = self.precision.apply_to_model(self.model)
        self.device = resolve_device(self.device)
        self.model.to(self.device)
        self._tx = self.optimizer.create()
        self._forward_params = _signature_names(type(self.model).forward)
        self._inference_params = _signature_names(type(self.model).forward_inference)
        # batch-supplied get_logits keyword arguments (TwoTower's
        # item_feature_tensors, the catalog's feature arrays)
        self._logits_extra_params = [
            name
            for name in _signature_names(getattr(type(self.model), "get_logits", None))
            if name not in ("hidden", "candidates_to_score")
        ]
        # dropout draws from torch's global generator: seed it per step from
        # the state's own generator, only where a rate is non-zero
        self._stochastic = any(getattr(m, "dropout_rate", 0.0) for m in self.model.modules())
        self._loss_checked = False
        self._bound: Optional[torch.Tensor] = None  # the flat buffer the model's parameters view
        # K-step CUDA graphs by (K, batch layout), all tied to one state's tensors
        self._chunk_graphs: Dict[Any, _ChunkGraph] = {}
        self._feed_stream: Optional[torch.cuda.Stream] = None
        # eager warm-up steps run before chunk captures, one a capture (each
        # launches every kernel of one step once)
        self.capture_warmups = 0
        self.last_step_metrics: Optional[Dict[str, Any]] = None
        self.history: List[Dict[str, float]] = []

    # -- state ------------------------------------------------------------- #
    def init_state(self, example_batch: Batch, params: Optional[Mapping[str, Any]] = None) -> TrainState:
        """Step 0 with fresh optimizer moments.

        ``params`` seeds the state with existing weights (a ``state_dict``,
        e.g. ``convert.flax_to_torch`` of a JAX param tree); without it the
        model's own weights, drawn from its generator at construction, are the
        start. ``example_batch`` is the JAX signature's: the port's modules
        know their shapes at construction and do not need it.
        """
        named = list(self.model.named_parameters())
        dtypes = {p.dtype for _, p in named}
        if len(dtypes) != 1:
            msg = f"the trainer keeps one flat parameter buffer and needs one dtype, got {sorted(map(str, dtypes))}"
            raise TypeError(msg)
        if params is not None:
            missing = [name for name, _ in named if name not in params]
            if missing:
                msg = f"params lacks {missing}"
                raise KeyError(msg)
        pieces = []
        for name, current in named:
            value = current if params is None else params[name]
            value = value.detach() if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
            if tuple(value.shape) != tuple(current.shape):
                msg = f"params[{name!r}] has shape {tuple(value.shape)}, the model {tuple(current.shape)}"
                raise ValueError(msg)
            pieces.append(value.reshape(-1).to(self.device, current.dtype))
        flat = torch.cat(pieces)
        state = TrainState(
            step=0,
            flat_params=flat,
            params={},
            opt_state=self._tx.init(flat),
            bad_steps=torch.zeros((), dtype=torch.int32, device=self.device),
            rng=torch.Generator().manual_seed(self.seed).get_state(),
        )
        self._bind(state)
        return state

    def _bind(self, state: TrainState) -> None:
        """Make the model's parameters views of ``state.flat_params`` (host
        work only: a captured step reads the buffer through these views)."""
        if self._bound is state.flat_params:
            return
        offset = 0
        views = {}
        for name, current in list(self.model.named_parameters()):
            size = current.numel()
            view = nn.Parameter(state.flat_params[offset : offset + size].view(current.shape))
            *path, leaf = name.split(".")
            setattr(self.model.get_submodule(".".join(path)), leaf, view)
            views[name] = view
            offset += size
        state.params = views
        self._bound = state.flat_params

    # -- train ------------------------------------------------------------- #
    def _check_loss_contract(self) -> None:
        model, loss = self.model, self.loss
        if getattr(loss, "needs_item_embeddings", False) and not hasattr(type(model), "get_item_weights"):
            msg = (
                f"{type(loss).__name__} needs the raw item table but "
                f"{type(model).__name__} defines no get_item_weights() method."
            )
            raise ValueError(msg)
        if getattr(loss, "requires_tying_head", False) and not getattr(model, "logits_via_item_weights", False):
            msg = (
                f"{type(loss).__name__} reconstructs logits as "
                "hidden . get_item_weights()^T, which only matches get_logits for "
                "bias-free tying-head models (declared via "
                f"logits_via_item_weights=True); {type(model).__name__} makes no "
                "such declaration."
            )
            raise ValueError(msg)
        self._loss_checked = True

    def _loss_value(self, batch: Batch, target_mask: torch.Tensor) -> torch.Tensor:
        model, loss = self.model, self.loss
        kwargs = {name: batch[name] for name in self._forward_params if name in batch}
        if "deterministic" in self._forward_params:
            kwargs["deterministic"] = False
        hidden = model(**kwargs)
        logits_extra = {name: batch[name] for name in self._logits_extra_params if name in batch}
        logits_callback = functools.partial(model.get_logits, **logits_extra) if logits_extra else model.get_logits
        if self.precision is not None and self.precision.casts_logits:
            # f32 loss accumulation under a narrow compute dtype: candidate-
            # shaped logits are a bf16 x bf16 product (full-catalog logits
            # already promote through the f32 item table)
            logits_callback = self.precision.wrap_logits_callback(logits_callback)
        loss.logits_callback = logits_callback
        if getattr(loss, "needs_item_embeddings", False):
            loss.item_embeddings_callback = model.get_item_weights
        return loss(
            hidden,
            batch.get(self.feature_field, {}),
            batch[self.label_field],
            batch.get(self.negative_field),
            batch[self.padding_mask_field],
            target_mask,
        )

    def _update(self, state: TrainState, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The device part of one step on a batch already on the device:
        forward, loss, gradient, the sentinel and the optimizer update, all
        written into the state's own tensors. Returns ``(loss, good,
        grad_norm)``. Device ops only, so a CUDA graph can capture it."""
        # batch-padding rows (fixed-shape final batch) get zero loss weight
        target_mask = batch[self.target_mask_field]
        if "valid" in batch:
            target_mask = target_mask & batch["valid"][(slice(None),) + (None,) * (target_mask.dim() - 1)]
        params = list(state.params.values())
        loss_value = self._loss_value(batch, target_mask)
        grads = torch.autograd.grad(loss_value, params, allow_unused=True)
        with torch.no_grad():
            flat_grad = torch.cat(
                [(g if g is not None else torch.zeros_like(p)).reshape(-1) for g, p in zip(grads, params)]
            )
            loss_value = loss_value.detach()
            grad_norm = global_norm(flat_grad)
            # the non-finite sentinel: one flag decides, on the device, whether
            # this update may touch the state
            good = torch.isfinite(loss_value) & torch.isfinite(grad_norm)
            updates, opt_state = self._tx.update(flat_grad, state.opt_state, state.flat_params)
            state.flat_params.copy_(torch.where(good, state.flat_params + updates, state.flat_params))
            _where_into(good, opt_state, state.opt_state)
            state.bad_steps.add_((~good).to(torch.int32))
        return loss_value, good, grad_norm

    def _step(self, state: TrainState, batch: Batch) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """:meth:`_update`, its dropout seeded from the state's generator
        where the model has a non-zero rate; advances ``step`` and ``rng``."""
        generator = torch.Generator()
        generator.set_state(state.rng)
        if self._stochastic:
            step_seed = int(torch.randint(2**62, (1,), generator=generator))
            devices = [self.device] if self.device.type == "cuda" else []
            with torch.random.fork_rng(devices=devices):
                torch.manual_seed(step_seed)
                metrics = self._update(state, batch)
        else:
            metrics = self._update(state, batch)
        state.step += 1
        state.rng = generator.get_state()
        return metrics

    def _prepare(self, state: TrainState) -> None:
        if not self._loss_checked:
            self._check_loss_contract()
        self._bind(state)

    def train_step(self, state: TrainState, batch: Batch) -> Tuple[TrainState, torch.Tensor]:
        """One optimizer step. Returns ``(state, loss)``; the step metrics —
        ``loss``, the sentinel's ``good`` flag and ``grad_norm``, all device
        scalars — stay readable on :attr:`last_step_metrics` until the next step.

        The state's tensors are updated in place and the same state returned
        (the JAX step donates its state: the old one is not used again)."""
        self._prepare(state)
        loss_value, good, grad_norm = self._step(state, to_device(batch, self.device))
        self.last_step_metrics = {"loss": loss_value, "good": good, "grad_norm": grad_norm}
        return state, loss_value

    # -- K steps a dispatch ------------------------------------------------ #
    @staticmethod
    def _stack_chunk(batches: Sequence[Batch]) -> Batch:
        """K same-shape host batches stacked into one ``[K, ...]`` tree (the
        chunk program's input), with a clear error when they cannot stack."""
        try:
            return _tree_map(lambda *xs: np.stack([_host(x) for x in xs]), *list(batches))
        except ValueError as exc:
            msg = (
                "scan chunking stacks every batch of a chunk into one fixed "
                f"[K, ...] program input, but stacking failed: {exc}. All "
                "batches must share one shape and key structure — length-"
                "bucketed batchers emit a SET of widths and cannot drive "
                "fit(scan_chunk=...)."
            )
            raise ValueError(msg) from exc

    def _place_chunk(self, stacked: Batch, stream: Optional[torch.cuda.Stream] = None) -> _Placed:
        """A stacked chunk on the device. With a ``stream`` (the device feed,
        on the feeder thread): each leaf through pinned host memory, copied
        with ``non_blocking=True`` on that stream, and an event recorded after
        the copies, which the consumer's stream waits on."""
        if stream is None or self.device.type != "cuda":
            return _Placed(to_device(stacked, self.device))
        with torch.cuda.stream(stream):
            batch = _tree_map(
                lambda x: torch.from_numpy(np.ascontiguousarray(x)).pin_memory().to(self.device, non_blocking=True),
                stacked,
            )
            event = torch.cuda.Event()
            event.record(stream)
        return _Placed(batch, event)

    def _chunk_placer(self) -> Callable[[Any], Optional[_Placed]]:
        """The device-feed ``place`` callable for ``fit(scan_chunk=...)``:
        stack and place a chunk on the feeder thread, so that the next chunk's
        copy to the card overlaps the running chunk; single steps pass
        through unplaced (the per-step path places its own batch)."""
        if self.device.type == "cuda" and self._feed_stream is None:
            self._feed_stream = torch.cuda.Stream(device=self.device)

        def place(item):
            kind, payload = item
            if kind != "scan":
                return None
            return self._place_chunk(self._stack_chunk(payload), self._feed_stream)

        return place

    def _chunk_graph(self, state: TrainState, batch: Batch, steps: int) -> _ChunkGraph:
        """The K-step graph for this chunk length and batch layout, captured
        on first use against ``state``'s own tensors; a new state (another
        ``init_state``, another ``fit(state=...)``) drops the old graphs and
        captures anew. One eager warm-up step runs first, on a copy of the
        state, so that the state is untouched until the first replay."""
        tensors = [state.flat_params, *(t for link in state.opt_state for t in link.values()), state.bad_steps]
        key = (steps, tuple((tuple(t.shape), t.dtype) for t in _leaves(batch)))
        cached = next(iter(self._chunk_graphs.values()), None)
        if cached is not None and (
            len(cached.state_tensors) != len(tensors) or any(a is not b for a, b in zip(cached.state_tensors, tensors))
        ):
            self._chunk_graphs.clear()
        if key in self._chunk_graphs:
            return self._chunk_graphs[key]
        static = _tree_map(lambda x: x.clone(), batch)
        metrics = {
            "loss": torch.empty(steps, dtype=torch.float32, device=self.device),
            "good": torch.empty(steps, dtype=torch.bool, device=self.device),
            "grad_norm": torch.empty(steps, dtype=torch.float32, device=self.device),
        }
        scratch = TrainState(
            step=state.step,
            flat_params=state.flat_params.clone(),
            params={},
            opt_state=[{name: value.clone() for name, value in link.items()} for link in state.opt_state],
            bad_steps=state.bad_steps.clone(),
            rng=state.rng,
        )

        def warmup():
            self._bind(scratch)
            self._update(scratch, _tree_map(lambda x: x[0], static))
            self._bind(state)

        def run():
            for index in range(steps):
                values = self._update(state, _tree_map(lambda x: x[index], static))
                for name, value in zip(("loss", "good", "grad_norm"), values):
                    metrics[name][index].copy_(value)

        graph, _ = capture(run, self.device, warmup=warmup)
        self.capture_warmups += 1
        chunk = _ChunkGraph(graph, static, metrics, tensors)
        self._chunk_graphs[key] = chunk
        return chunk

    def _run_chunk(self, state: TrainState, placed: _Placed, steps: int) -> Tuple[TrainState, np.ndarray]:
        """K steps on a placed ``[K, ...]`` chunk: on the card one replay of
        the chunk's graph, on the CPU K eager steps. Sets
        :attr:`last_step_metrics` to ``[K]`` tensors; returns the losses."""
        self._prepare(state)
        if self.device.type != "cuda":
            values = [self._step(state, _tree_map(lambda x: x[index], placed.batch)) for index in range(steps)]
            metrics = {
                name: torch.stack([v[position] for v in values])
                for position, name in enumerate(("loss", "good", "grad_norm"))
            }
        else:
            if self._stochastic:
                msg = (
                    "train_steps / fit(scan_chunk=...) with dropout on the card is not ported yet: "
                    "ROADMAP.md queue 1, 'The rest of Trainer.fit' (dropout inside a captured chunk)"
                )
                raise NotImplementedError(msg)
            current = torch.cuda.current_stream(self.device)
            if placed.event is not None:
                current.wait_event(placed.event)
                for leaf in _leaves(placed.batch):
                    leaf.record_stream(current)
            chunk = self._chunk_graph(state, placed.batch, steps)
            _tree_map(lambda static, value: static.copy_(value), chunk.batch, placed.batch)
            chunk.graph.replay()
            metrics = {name: value.clone() for name, value in chunk.metrics.items()}
            # at dropout 0 the per-step path draws nothing: rng stays as it is
            state.step += steps
        self.last_step_metrics = metrics
        return state, metrics["loss"].cpu().numpy()

    def train_steps(self, state: TrainState, batches: Sequence[Batch]) -> Tuple[TrainState, np.ndarray]:
        """``len(batches)`` optimizer steps in ONE dispatch: the same math as
        K :meth:`train_step` calls, bit for bit. On the card the K steps are
        one CUDA graph (captured on the first chunk of this length, replayed
        after), the JAX ``lax.scan``'s counterpart; on the CPU they run
        eagerly. Returns ``(state, losses)`` with the ``[K]`` losses as numpy;
        :attr:`last_step_metrics` holds the ``[K]`` ``loss``, ``good`` and
        ``grad_norm`` tensors. Dropout > 0 raises on the card."""
        batches = list(batches)
        return self._run_chunk(state, self._place_chunk(self._stack_chunk(batches)), len(batches))

    def fit(
        self,
        train_batches: Iterable[Batch] | Callable[..., Iterable[Batch]],
        epochs: int = 1,
        state: Optional[TrainState] = None,
        val_batches: Optional[
            Callable[[], Iterable[Batch]] | Dict[str, Callable[[], Iterable[Batch]]]
        ] = None,
        metrics: Sequence[str] = ("ndcg", "recall", "map"),
        top_k: Sequence[int] = (1, 5, 10),
        item_count: Optional[int] = None,
        postprocessors: Sequence[Callable] = (),
        log_every: int = 100,
        prefetch: int = 0,
        scan_chunk: Optional[int] = None,
        device_feed: bool = True,
        **unported: Any,
    ) -> TrainState:
        """Train for ``epochs`` passes; validates after each epoch when
        ``val_batches`` is given, appending one record per epoch to
        :attr:`history`. A dict of validation factories runs each stream in
        turn, prefixing its metric keys with the stream's name.

        ``train_batches`` may be a re-iterable, a zero- or one-arg callable
        returning an iterable (the arg is the epoch), or a one-shot iterator
        (materialized once if several epochs are requested). An epoch's ``train_loss`` averages the steps the
        sentinel accepted (NaN when it accepted none). ``log_every`` logs the
        loss every that many steps, counted across epochs.

        ``prefetch=n`` builds batches ``n`` ahead on a background thread.
        ``scan_chunk=K`` runs each epoch's full groups of K batches through
        :meth:`train_steps` (one CUDA graph replay a chunk on the card) and the
        short tail through :meth:`train_step`; the ``[K]`` losses and sentinel
        flags fan out into the epoch's accounting exactly as K steps would.
        With ``device_feed=True`` a feeder thread stacks and copies the next
        chunk to the card while the current one runs
        (:class:`~replay_tpu_torch.data.nn.prefetch.DevicePrefetcher`); with
        ``False`` each chunk is placed on the fit thread.

        The other arguments of the JAX ``fit`` (checkpoints, recovery, loggers,
        tracing, ...) raise ``NotImplementedError`` naming their
        ``ROADMAP.md`` item when given anything but their JAX default.
        """
        for name, value in unported.items():
            if name not in _UNPORTED_FIT_ARGS:
                msg = f"fit() got an unexpected keyword argument {name!r}"
                raise TypeError(msg)
            default, item = _UNPORTED_FIT_ARGS[name]
            if value != default:
                msg = f"fit({name}=...) is not ported yet: ROADMAP.md queue 1, {item}"
                raise NotImplementedError(msg)
        if scan_chunk is not None:
            scan_chunk = int(scan_chunk)
            if scan_chunk < 1:
                msg = "scan_chunk must be >= 1 (optimizer steps per lax.scan dispatch)"
                raise ValueError(msg)
        one_shot = None
        if not callable(train_batches) and iter(train_batches) is train_batches:
            # a generator: re-iteration is impossible, materialize once
            one_shot = list(train_batches) if epochs > 1 else train_batches

        def batches_for(epoch: int):
            if one_shot is not None:
                return one_shot
            if callable(train_batches):
                takes_epoch = len(_signature_names(train_batches)) >= 1
                return train_batches(epoch) if takes_epoch else train_batches()
            return train_batches

        executed = 0
        for epoch in range(epochs):
            # the epoch's accepted-loss sum and count, in f32 and int32. The
            # per-step loop adds on the device (reading the loss would sync
            # every step); the chunked loop adds the fetched [K] values on the
            # host, the same IEEE f32 adds in the same order. Sentinel-skipped
            # steps contribute 0 (their loss is non-finite)
            epoch_loss, epoch_good = None, None

            def account(loss_value, good, step: int) -> None:
                nonlocal epoch_loss, epoch_good, executed
                if isinstance(loss_value, torch.Tensor):
                    safe_loss, flag = torch.where(good, loss_value, 0.0), good.to(torch.int32)
                else:
                    safe_loss, flag = np.float32(loss_value) if good else np.float32(0.0), np.int32(bool(good))
                epoch_loss = safe_loss if epoch_loss is None else epoch_loss + safe_loss
                epoch_good = flag if epoch_good is None else epoch_good + flag
                executed += 1
                if log_every and executed % log_every == 0:
                    logger.info("step %d: loss %.6f", step, float(loss_value))

            stream = batches_for(epoch)
            if prefetch:
                stream = prefetch_batches(iter(stream), depth=prefetch)
            try:
                if scan_chunk:
                    state = self._fit_chunked(stream, state, scan_chunk, device_feed, account)
                else:
                    for batch in stream:
                        if state is None:
                            state = self.init_state(batch)
                        state, loss_value = self.train_step(state, batch)
                        account(loss_value, self.last_step_metrics["good"], state.step)
            finally:
                if prefetch:
                    stream.close()  # joins the prefetch thread, also when a step raised
            good_count = int(epoch_good) if epoch_good is not None else 0
            record = {
                "epoch": epoch,
                "train_loss": float(epoch_loss) / good_count if good_count else float("nan"),
            }
            if val_batches is not None and state is not None:
                streams = val_batches if isinstance(val_batches, dict) else {"": val_batches}
                for stream_name, factory in streams.items():
                    stream_metrics = self.validate(
                        state,
                        factory(),
                        metrics=metrics,
                        top_k=top_k,
                        item_count=item_count,
                        postprocessors=postprocessors,
                    )
                    prefix = f"{stream_name}/" if stream_name else ""
                    record.update({f"{prefix}{k}": v for k, v in stream_metrics.items()})
            self.history.append(record)
            if not log_every:
                logger.info("epoch %d: %s", epoch, record)
        if state is None:
            msg = "fit() received no batches"
            raise ValueError(msg)
        return state

    def _fit_chunked(self, batches, state, chunk: int, device_feed: bool, account) -> Optional[TrainState]:
        """One epoch of ``fit(scan_chunk=chunk)``: full chunks through
        :meth:`_run_chunk`, the tail per step, each step's loss and flag to
        ``account`` on the host, in stream order."""
        batches = iter(batches)
        first = next(batches, None)
        if first is None:
            return state
        if state is None:
            state = self.init_state(first)
        items = _chunk_schedule(itertools.chain([first], batches), chunk)
        feed = DevicePrefetcher(items, self._chunk_placer(), depth=1) if device_feed else ((i, None) for i in items)
        try:
            for (kind, payload), placed in feed:
                if kind == "step":
                    state, loss_value = self.train_step(state, payload)
                    account(float(loss_value), bool(self.last_step_metrics["good"]), state.step)
                    continue
                if placed is None:  # device_feed=False: stacked and placed on this thread
                    placed = self._place_chunk(self._stack_chunk(payload))
                start = state.step
                state, losses = self._run_chunk(state, placed, len(payload))
                goods = self.last_step_metrics["good"].cpu().numpy()
                for index in range(len(payload)):
                    account(losses[index], goods[index], start + index + 1)
        finally:
            if isinstance(feed, DevicePrefetcher):
                feed.close()
        return state

    # -- eval / predict ---------------------------------------------------- #
    def predict_logits(
        self, state: TrainState, batch: Batch, candidates: Optional[Any] = None
    ) -> torch.Tensor:
        """Next-item logits [B, num_items] (or [B, K] for candidates)."""
        self._bind(state)
        batch = to_device(batch, self.device)
        kwargs = {name: batch[name] for name in self._inference_params if name in batch}
        if candidates is not None:
            candidates = to_device(candidates, self.device)
        with torch.no_grad():
            return self.model.forward_inference(**kwargs, candidates_to_score=candidates)

    # -- vocabulary ------------------------------------------------------- #
    def resize_vocabulary(
        self, state: TrainState, new_cardinality: int, init_tensor=None, carry_opt_state: bool = True,
        init: str = "mean", rng=None,
    ) -> TrainState:
        """Not ported: item-table surgery with the optimizer moments resized."""
        msg = (
            "Trainer.resize_vocabulary is not ported yet: ROADMAP.md queue 1, "
            "'BERT4Rec, TwoTower and the vocabulary' (nn/vocabulary.py)"
        )
        raise NotImplementedError(msg)

    def finetune(
        self, state: TrainState, train_batches, new_cardinality: Optional[int] = None, init: str = "xavier",
        epochs: int = 1, **fit_kwargs,
    ) -> TrainState:
        """Not ported: the continual-training entry (a catalog resize, then fit)."""
        msg = (
            "Trainer.finetune is not ported yet: ROADMAP.md queue 1, "
            "'BERT4Rec, TwoTower and the vocabulary' (nn/vocabulary.py)"
        )
        raise NotImplementedError(msg)

    # -- eval-time catalog cache (item towers) ------------------------------ #
    def _precompute_catalog(self, state: TrainState, batch: Batch) -> Optional[torch.Tensor]:
        """The catalog through the model's item tower, ``[num_items, E]``,
        encoded once per evaluation pass (``None`` for models without
        ``encode_items``): each validate / predict_top_k call encodes it anew
        with the state's current weights."""
        if not hasattr(type(self.model), "encode_items"):
            return None
        self._bind(state)
        features = batch.get("item_feature_tensors")
        with torch.no_grad():
            return self.model.encode_items(
                item_feature_tensors=None if features is None else to_device(features, self.device)
            )

    def _catalog_logits(self, state: TrainState, batch: Batch, catalog: torch.Tensor) -> torch.Tensor:
        """Query embeddings scored against the precomputed catalog."""
        self._bind(state)
        batch = to_device(batch, self.device)
        with torch.no_grad():
            queries = self.model.get_query_embeddings(batch[self.feature_field], batch[self.padding_mask_field])
            return queries @ catalog.T

    def _scored(self, state: TrainState, batches: Iterable[Batch], candidates: Optional[Any] = None):
        """Each batch with its next-item logits: against the catalog encoded
        once for the whole pass where the model has an item tower and no
        candidates are given, else through ``predict_logits``."""
        iterator = iter(batches)
        first = next(iterator, None)
        if first is None:
            return
        catalog = self._precompute_catalog(state, first) if candidates is None else None
        for batch in itertools.chain([first], iterator):
            if catalog is not None:
                yield batch, self._catalog_logits(state, batch, catalog)
            else:
                yield batch, self.predict_logits(state, batch, candidates)

    def validate(
        self,
        state: TrainState,
        batches: Iterable[Batch],
        metrics: Sequence[str] = ("ndcg", "recall", "map"),
        top_k: Sequence[int] = (1, 5, 10),
        item_count: Optional[int] = None,
        postprocessors: Sequence[Callable] = (),
    ) -> Mapping[str, float]:
        """Top-k metrics over validation batches (ground_truth/train padded with
        −1, as MetricsBuilder takes them)."""
        builder = MetricsBuilder(metrics=metrics, top_k=top_k, item_count=item_count)
        for batch, logits in self._scored(state, batches):
            batch = to_device(batch, self.device)
            for post in postprocessors:
                logits = post(logits, batch)
            top_ids = torch.topk(logits, builder.max_k, dim=-1).indices
            builder.add_prediction(top_ids, batch["ground_truth"], batch.get("train"), batch.get("valid"))
        return builder.get_metrics()

    def predict_top_k(
        self,
        state: TrainState,
        batches: Iterable[Batch],
        k: int,
        postprocessors: Sequence[Callable] = (),
        candidates: Optional[Any] = None,
        query_id_field: str = "query_id",
    ):
        """Top-k recommendations as (query_ids, item_ids, scores) numpy arrays:
        score → postprocess → top-k → accumulate; candidate ids are mapped back
        to catalog ids when ``candidates`` is given."""
        if isinstance(batches, Mapping):  # a single batch: iterating it would
            batches = [batches]  # yield its string keys
        all_queries, all_items, all_scores = [], [], []
        for batch, logits in self._scored(state, batches, candidates):
            batch = to_device(batch, self.device)
            if candidates is not None:
                # visible to postprocessors (SeenItemsFilter's candidate matching)
                batch = {**batch, "candidates_to_score": to_device(candidates, self.device)}
            for post in postprocessors:
                logits = post(logits, batch)
            scores, top_idx = torch.topk(logits, k, dim=-1)
            top_ids = batch["candidates_to_score"][top_idx] if candidates is not None else top_idx
            valid = batch["valid"].cpu().numpy() if "valid" in batch else np.ones(top_ids.shape[0], bool)
            all_items.append(top_ids.cpu().numpy()[valid])
            all_scores.append(scores.cpu().numpy()[valid])
            if query_id_field in batch:
                all_queries.append(batch[query_id_field].cpu().numpy()[valid])
        items = np.concatenate(all_items) if all_items else np.zeros((0, k), np.int64)
        scores = np.concatenate(all_scores) if all_scores else np.zeros((0, k), np.float32)
        queries = np.concatenate(all_queries) if all_queries else np.arange(items.shape[0])
        return queries, items, scores
