"""Trainer: optimizer factories, the train step, fit, validate and predict.

Counterpart of ``replay_tpu/nn/train.py`` on one device. The JAX trainer jits
one SPMD program over a mesh; here :meth:`Trainer.train_step` runs eagerly on
one card, and :meth:`Trainer.train_steps` (``fit(scan_chunk=K)``), the JAX
``lax.scan`` of K steps, is one CUDA graph of K steps per chunk length,
replayed with one launch (:mod:`replay_tpu_torch.nn.graphs`), fed by a
device-prefetch stage (:mod:`replay_tpu_torch.data.nn.prefetch`). ``fit`` has
the JAX training lifecycle: checkpoints and ``resume``
(:mod:`replay_tpu_torch.utils.checkpoint`), best-state tracking and early
stop, :class:`RecoveryPolicy` rollbacks, :class:`PreemptionHandler` and the
event sinks (:mod:`replay_tpu_torch.obs.events`), and its observability:
model health at a cadence (:mod:`replay_tpu_torch.obs.health`), span tracing
and goodput (:mod:`replay_tpu_torch.obs.trace`), a profile window with
per-scope device time and every program's roofline
(:mod:`replay_tpu_torch.obs.profile`, :mod:`replay_tpu_torch.obs.roofline`),
the live metrics plane (:mod:`replay_tpu_torch.obs.metrics`, ``exporter``,
``slo``) and the flight recorder (:mod:`replay_tpu_torch.obs.blackbox`). The
mesh and sharding arguments are later slices (``ROADMAP.md`` queue 1).
``precision="bf16"`` is the JAX trainer's: the model computes in
bf16 while the flat parameter buffer, the optimizer state and the sentinel
stay f32 (:mod:`replay_tpu_torch.nn.precision`). ``remat_policy`` is the JAX
trainer's too: the model is cloned with ``remat=True`` and the resolved
policy (:func:`_resolve_remat_policy`, :mod:`replay_tpu_torch.nn.remat`), so
each encoder block's forward, attention kernels included, runs again in the
backward pass; the recompute reads the forward's dropout draws back, so a
remat step, eager or captured, equals a step without remat.

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

Dropout: the model's ``F.dropout`` draws from the default generator of the
trainer's device (Philox on the card, its seed and offset; the CPU's
Mersenne twister on the CPU). ``TrainState.rng`` holds that generator's
state for the run: every step, eager or captured, runs with the generator
set to it and writes back what the step advanced it to, then gives the
caller's generator state back. A CUDA graph replays its dropout with the
generator's seed and offset at replay time and advances the offset by what
its K steps draw, so one replay equals K eager steps bit for bit, two
replays draw different masks, and a checkpoint of ``rng`` restores the
stream of masks. The masks are torch's, not JAX's: parity with the JAX
package holds at dropout 0 only. A ``needs_rng`` loss (SCE) draws its
projection from the same stream, after the step's dropout (the JAX step
splits a key of its own for the loss), so its draws repeat from the seed and
a captured step draws what the eager one does.

Vocabulary: :meth:`Trainer.resize_vocabulary` and :meth:`Trainer.finetune`
grow the item table of a trained state (:mod:`replay_tpu_torch.nn.vocabulary`):
the flat parameter buffer and each flat moment buffer are rebuilt with the
rows inserted at the table's offset, the model's item embedding modules are
rebuilt at the new size, and every captured program of the old shapes (chunk
graphs, evaluation graphs) is dropped.

Evaluation: the programs the JAX trainer jits for ``validate``,
``predict_top_k``, ``predict_dataframe``, ``predict_logits`` and
``predict_query_embeddings`` (``eval_logits``, ``encode_items``,
``get_query_embeddings``, and the metric sums) replay CUDA graphs on the card,
one per program and input shape, each reading a static copy of the
parameters that every evaluation call copies in once (so a graph never reads
weights that training, a rollback or another state changed since); on the
CPU the same programs run eagerly. A capture or replay that fails raises.
Postprocessors, the top-k (``models/ann.py::top_k``, ``jax.lax.top_k``'s
order among ties) and the running metric totals run between the replays.
``predict_dataframe`` returns a :class:`~replay_tpu_torch.utils.types.ColumnTable`
where the JAX trainer returns a pandas frame (the port never imports pandas).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
import itertools
import logging
import math
import os
import signal as _signal
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from replay_tpu_torch.data.nn.prefetch import DevicePrefetcher, prefetch as prefetch_batches
from replay_tpu_torch.device import DeviceLike, resolve_device, to_device
from replay_tpu_torch.metrics.builder import MetricsBuilder, metric_program
from replay_tpu_torch.models.ann import top_k as _top_k
from replay_tpu_torch.nn.compiled import bind
from replay_tpu_torch.nn.graphs import Graph, capture, runner, signature
from replay_tpu_torch.nn.precision import Precision
from replay_tpu_torch.nn.remat import checkpoint_dots, checkpoint_dots_with_no_batch_dims
from replay_tpu_torch.obs import health as health_module
from replay_tpu_torch.obs import profile as profile_module
from replay_tpu_torch.obs.collectors import CompileTracker, MemoryMonitor, StepTelemetry
from replay_tpu_torch.obs.events import ConsoleLogger, JsonlLogger, MultiLogger, RunLogger, TrainerEvent
from replay_tpu_torch.obs.health import HealthConfig
from replay_tpu_torch.obs.profile import scope
from replay_tpu_torch.obs.trace import Tracer, goodput_breakdown, traced_iterator
from replay_tpu_torch.utils.types import ColumnTable

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
    ``opt_state`` keep their values. ``rng`` is the state of the generator
    the model's dropout draws from (the default generator of the trainer's
    device: 16 bytes of Philox seed and offset on the card), a CPU ``uint8``
    tensor. A step sets that generator to ``rng`` and puts the caller's state
    back after it, without a lock: while a trainer runs (``fit``,
    ``train_step``, ``train_steps``) it owns the device's default generator,
    and no other thread may draw from it (another trainer on the same device
    included), or the resumed and the uninterrupted runs part without an
    error.
    """

    step: int
    flat_params: torch.Tensor
    params: Dict[str, torch.Tensor]
    opt_state: OptState
    bad_steps: torch.Tensor
    rng: torch.Tensor


def _clone_state(state: TrainState) -> TrainState:
    """A copy of ``state`` that no step writes into."""
    return TrainState(
        step=state.step,
        flat_params=state.flat_params.clone(),
        params={},
        opt_state=[{key: value.clone() for key, value in link.items()} for link in state.opt_state],
        bad_steps=state.bad_steps.clone(),
        rng=state.rng.clone(),
    )


# --------------------------------------------------------------------------- #
# Resilience: recovery policy + preemption handling (docs/robustness.md)
# --------------------------------------------------------------------------- #
@dataclass
class RecoveryPolicy:
    """When and how ``Trainer.fit`` rolls back a diverging run.

    Two triggers share one response (restore the last checkpoint — always
    finite, because the sentinel never lets a non-finite update into the
    state — and back the learning rate off by ``lr_backoff``):

    * ``max_consecutive_bad`` sentinel-skipped steps in a row;
    * a monitored-metric blowup at epoch end: the monitored value went
      non-finite, or worsened past ``blowup_factor`` × the best seen (``mode=
      "min"``: value > best × factor; ``mode="max"``: value < best / factor).
      ``blowup_factor=None`` keeps only the non-finite check.

    ``max_restarts`` bounds the rollbacks of one fit call; exhausting it
    raises ``RuntimeError``. A rollback restores the state only: the batch
    stream keeps moving forward, so the poisoned window is not replayed.
    """

    max_consecutive_bad: int = 5
    max_restarts: int = 3
    lr_backoff: float = 0.5
    blowup_factor: Optional[float] = None

    def __post_init__(self) -> None:
        if self.max_consecutive_bad < 1:
            msg = "max_consecutive_bad must be >= 1"
            raise ValueError(msg)
        if self.max_restarts < 0:
            msg = "max_restarts must be >= 0"
            raise ValueError(msg)
        if not 0.0 < self.lr_backoff <= 1.0:
            msg = "lr_backoff must be in (0, 1]"
            raise ValueError(msg)
        if self.blowup_factor is not None and self.blowup_factor <= 1.0:
            msg = "blowup_factor must be > 1"
            raise ValueError(msg)


class PreemptionHandler:
    """SIGTERM/SIGINT → request a checkpoint at the next step boundary.

    ``fit`` installs one around its training loop (when a checkpoint manager
    is attached): the first signal only sets a flag, the loop saves a
    position-stamped mid-epoch checkpoint at the current step boundary (the
    next chunk boundary under ``scan_chunk``) and returns cleanly, and
    ``fit(resume=True)`` continues from that batch. A second signal falls
    through to the previously installed handler, so a double Ctrl-C still
    exits. Off the main thread ``signal.signal`` is unavailable: installation
    is then a no-op and only :meth:`request` sets the flag.
    """

    def __init__(self, signals: Sequence[int] = (_signal.SIGTERM, _signal.SIGINT)) -> None:
        self.signals = tuple(signals)
        self.requested = False
        self.signal_name: Optional[str] = None
        self._previous: Dict[int, Any] = {}
        self._installed = False

    def request(self, signum: Optional[int] = None) -> None:
        self.requested = True
        if signum is not None:
            self.signal_name = _signal.Signals(signum).name

    def _handle(self, signum, frame) -> None:
        if self.requested:  # second signal: defer to the original behaviour
            previous = self._previous.get(signum)
            if callable(previous):
                previous(signum, frame)
                return
            raise KeyboardInterrupt
        logger.warning(
            "received %s: checkpointing at the next step boundary, then exiting", _signal.Signals(signum).name
        )
        self.request(signum)

    def __enter__(self) -> "PreemptionHandler":
        try:
            for sig in self.signals:
                self._previous[sig] = _signal.signal(sig, self._handle)
            self._installed = True
        except ValueError:  # not the main thread: restore what was installed
            for sig, previous in self._previous.items():
                _signal.signal(sig, previous)
            self._previous.clear()
            self._installed = False
        return self

    def __exit__(self, *exc_info) -> None:
        if self._installed:
            for sig, previous in self._previous.items():
                _signal.signal(sig, previous)
            self._previous.clear()
            self._installed = False


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


def _flat(kwargs: Mapping[str, Any]) -> Tuple[Tuple[Any, ...], List[Any]]:
    """Keyword arguments (values, or dicts of values) as a layout and a flat
    list of inputs: the form a captured program takes them in."""
    layout, inputs = [], []
    for name, value in kwargs.items():
        if isinstance(value, Mapping):
            layout.append((name, tuple(value)))
            inputs.extend(value.values())
        else:
            layout.append((name, None))
            inputs.append(value)
    return tuple(layout), inputs


def _nested(layout: Tuple[Any, ...], inputs: Sequence[Any]) -> Dict[str, Any]:
    """The keyword arguments of :func:`_flat`'s layout and inputs."""
    kwargs, at = {}, 0
    for name, keys in layout:
        if keys is None:
            kwargs[name] = inputs[at]
            at += 1
        else:
            kwargs[name] = dict(zip(keys, inputs[at : at + len(keys)]))
            at += len(keys)
    return kwargs


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _chunk_schedule(
    batches: Iterable[Batch],
    chunk: int,
    health_every: Optional[int] = None,
    start: int = 0,
):
    """Group a batch stream into ``("scan", [chunk batches])`` items and
    ``("step", batch)`` items, in stream order: one chunk length and the
    per-step program, never a zoo of chunk lengths. A step whose 1-based
    executed position (counted from ``start``, the fit's executed steps) lands
    on a ``health_every`` cadence boundary runs singly, through the
    health-instrumented per-step program, as do the (< chunk) leftovers before
    it and the epoch's short tail. With ``health_every ≡ 1 (mod chunk)`` every
    gap between health steps packs into full chunks."""
    buffered: List[Batch] = []
    position = start

    def flush():
        for leftover in buffered:
            yield ("step", leftover)
        buffered.clear()

    for batch in batches:
        position += 1
        if health_every and position % health_every == 0:
            yield from flush()
            yield ("step", batch)
            continue
        buffered.append(batch)
        if len(buffered) == chunk:
            yield ("scan", list(buffered))
            buffered.clear()
    yield from flush()


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


class _LayoutCheckedManager:
    """A fit's checkpoint manager whose saves carry the trainer's layout mark
    and whose restores refuse a checkpoint of the other layout
    (:meth:`Trainer._check_layout`); everything else is the manager's."""

    def __init__(self, manager: Any, trainer: "Trainer") -> None:
        self._manager = manager
        self._trainer = trainer

    def __getattr__(self, name: str) -> Any:
        return getattr(self._manager, name)

    def save(self, step: int, state: Any, history=None, metadata=None, process_metadata=None) -> None:
        metadata = {**(metadata or {}), **self._trainer._layout_metadata()}
        self._manager.save(step, state, history=history, metadata=metadata, process_metadata=process_metadata)

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        step = step if step is not None else self._manager.latest_step()
        try:
            metadata = self._manager.metadata(step) if step is not None else {}
        except (OSError, ValueError):
            metadata = None  # unreadable: the manager's restore says so
        if isinstance(metadata, dict):
            self._trainer._check_layout(metadata, f"step_{step}")
        return self._manager.restore(template, step=step)


def _sync(value: Any) -> None:
    """Wait for a device value (a span fenced on the loss, as JAX's
    ``block_until_ready``)."""
    if isinstance(value, torch.Tensor) and value.is_cuda:
        torch.cuda.current_stream(value.device).synchronize()


def _resolve_remat_policy(policy: Any):
    """``Trainer(remat_policy=...)`` spellings → a selective-checkpoint policy
    function (or None = save nothing, i.e. full rematerialization)."""
    if policy is True or policy == "full":
        return None  # recompute everything
    if isinstance(policy, str):
        names = {"dots": checkpoint_dots, "dots_no_batch": checkpoint_dots_with_no_batch_dims}
        if policy not in names:
            msg = (
                f"unknown remat_policy {policy!r}; use 'full', 'dots', "
                "'dots_no_batch', or a selective-checkpoint policy callable"
            )
            raise ValueError(msg)
        return names[policy]
    if callable(policy):
        return policy
    msg = f"remat_policy must be a string, True, or callable; got {policy!r}"
    raise ValueError(msg)


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
    :param seed: seeds ``TrainState.rng``, the stream the dropout masks come from.
        The trainer owns its device's default generator while it steps (see
        :class:`TrainState`): one stepping trainer per device, and no other
        thread drawing from that generator meanwhile.
    :param precision: mixed-precision rung, ``"bf16"`` / ``"f32"`` / a
        :class:`~replay_tpu_torch.nn.precision.Precision`. Applied at
        construction: the model is cloned with its compute ``dtype`` set to the
        rung's (its parameters, and so the optimizer state, stay f32), and
        loss-consumed logits are up-cast to the rung's f32 accumulation dtype.
        ``None`` (default) changes nothing.
    :param remat_policy: activation checkpointing for the encoder stack:
        ``"full"`` (or ``True``: recompute every block activation in the
        backward), ``"dots"`` (keep the matrix products' outputs, recompute
        the rest), ``"dots_no_batch"`` (keep only the products without a batch
        dimension), or a torch selective-checkpoint policy function. The model
        is cloned with ``remat=True`` and the policy; a model without a
        ``remat`` field (TwoTower, TiSasRec) is refused. ``None`` (default)
        leaves remat off.
    :param device: ``"cuda"`` by default; raises without a card unless given
        ``"cpu"``. The model is moved there.
    :param label_field / mask fields: batch keys, as in the JAX trainer.
    :param compile_tracker: counts and times each program's first builds
        (graph captures, first calls at a shape, kernel builds); its report
        rides ``on_fit_end`` as ``compile``.
    :param tracer: an enabled :class:`~replay_tpu_torch.obs.trace.Tracer`
        traces every fit (``fit(tracer=...)`` traces one).
    :param health: a :class:`~replay_tpu_torch.obs.health.HealthConfig`: the
        per-step program computes the health record (norms, update ratios,
        activation stats, attention entropy, logits stats, embedding
        coverage) and ``fit`` fetches it every ``cadence`` steps. ``None``
        runs the step exactly as before.
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
    compile_tracker: CompileTracker = field(default_factory=CompileTracker)
    tracer: Optional[Tracer] = None
    health: Optional[HealthConfig] = None
    precision: Optional[Any] = None
    device: DeviceLike = "cuda"
    remat_policy: Optional[Any] = None

    def __post_init__(self) -> None:
        if isinstance(self.loss, str):
            from replay_tpu_torch.nn import loss as loss_zoo

            # only losses constructible with no arguments qualify as shorthands;
            # parametrized ones (SCE, LogInCE, LogOutCE, sampled variants) need
            # an explicit instance
            by_name = {name.lower(): getattr(loss_zoo, name) for name in ("CE", "BCE")}
            if self.loss.lower() not in by_name:
                msg = (
                    f"Unknown loss shorthand {self.loss!r}; use one of "
                    f"{sorted(by_name)}, or pass a replay_tpu_torch.nn.loss instance "
                    "(losses with required parameters, e.g. SCE/LogInCE/LogOutCE, "
                    "must be instantiated by the caller)"
                )
                raise ValueError(msg)
            self.loss = by_name[self.loss.lower()]()
        self.precision = Precision.resolve(self.precision)
        if self.precision is not None:
            self.model = self.precision.apply_to_model(self.model)
        if self.remat_policy is not None:
            # activation-checkpointed blocks: clone the model with remat on
            # and the policy plumbed to its encoder stack
            if not hasattr(self.model, "remat"):
                msg = (
                    f"remat_policy={self.remat_policy!r} needs a model with a "
                    f"remat field (SasRec/Bert4Rec); {type(self.model).__name__} "
                    "has none"
                )
                raise ValueError(msg)
            policy = _resolve_remat_policy(self.remat_policy)
            self.model = self.model.clone(remat=True, remat_policy=policy)
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
        # dropout (where a rate is non-zero) and a needs_rng loss (SCE's
        # projection) draw from the device's default generator, set to the
        # state's stream for each step
        self._stochastic = any(getattr(m, "dropout_rate", 0.0) for m in self.model.modules()) or bool(
            getattr(self.loss, "needs_rng", False)
        )
        self._lr_scale = 1.0  # RecoveryPolicy backoff multiplier (1.0 = none)
        self._loss_checked = False
        self._bound: Optional[torch.Tensor] = None  # the flat buffer the model's parameters view
        # K-step CUDA graphs by (K, batch layout), all tied to one state's tensors
        self._chunk_graphs: Dict[Any, _ChunkGraph] = {}
        self._feed_stream: Optional[torch.cuda.Stream] = None
        # the evaluation programs and the metric sums: CUDA graphs on the
        # card, one per program and input shape; the programs themselves on the CPU
        self._eval_runner = runner(self._eval_program, self.device)
        self._metric_runner = runner(metric_program, self.device)
        # eager warm-up steps run before chunk captures, one a capture (each
        # launches every kernel of one step once)
        self.capture_warmups = 0
        self.last_step_metrics: Optional[Dict[str, Any]] = None
        # the most recent fetched health record (python scalars and lists),
        # refreshed by fit every health.cadence steps
        self.last_health: Optional[Dict[str, Any]] = None
        # {name: (steps, batch)}: a copy of the first batch each program
        # (train_step, train_scan) ran, so the analyses can run it again
        self._programs: Dict[str, Tuple[int, Batch]] = {}
        # {program: [(kernel, scope)]}: a chunk graph's eager warm-up, traced
        # while a fit that profiles captures it (obs/profile.py)
        self._graph_kernels: Dict[str, List[Tuple[str, Optional[str]]]] = {}
        self._trace_warmups = False
        self._builds = 0  # the generation of the step programs (a new optimizer: a new one)
        self._state: Optional[TrainState] = None  # the state the model is bound to
        # the live metrics plane (fit(metrics_port=...) / fit(slo_rules=...)):
        # the registry outlives the fit; the exporter exposes its port while live
        self.metrics_registry = None
        self.metrics_exporter = None
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
            rng=torch.Generator(device=self.device).manual_seed(self.seed).get_state(),
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
        self._state = state

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

    def _loss_value(self, batch: Batch, target_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The step's loss and the model's hidden states."""
        model, loss = self.model, self.loss
        kwargs = {name: batch[name] for name in self._forward_params if name in batch}
        if "deterministic" in self._forward_params:
            kwargs["deterministic"] = False
        # named scopes (a profile window only) label the device time by stage
        with scope("forward"):
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
        if getattr(loss, "needs_rng", False):
            # the stream dropout draws from, set to state.rng for the step
            # (eager and captured alike): the JAX step's loss_rng
            loss.rng = self._generator()
        with scope("loss"):
            value = loss(
                hidden,
                batch.get(self.feature_field, {}),
                batch[self.label_field],
                batch.get(self.negative_field),
                batch[self.padding_mask_field],
                target_mask,
            )
        return value, hidden

    def _update(
        self, state: TrainState, batch: Batch, health: Optional[HealthConfig] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, Optional[Dict[str, Any]]]:
        """The device part of one step on a batch already on the device:
        forward, loss, gradient, the sentinel and the optimizer update, all
        written into the state's own tensors. Returns ``(loss, good,
        grad_norm, health)``: ``health`` is the step's health record (device
        tensors) under a :class:`HealthConfig`, else ``None``. Device ops
        only, so a CUDA graph can capture it (the graphs capture no health)."""
        # batch-padding rows (fixed-shape final batch) get zero loss weight
        target_mask = batch[self.target_mask_field]
        if "valid" in batch:
            target_mask = target_mask & batch["valid"][(slice(None),) + (None,) * (target_mask.dim() - 1)]
        params = list(state.params.values())
        capture = (
            health_module.capture_intermediates()
            if health is not None and health.capture_intermediates
            else contextlib.nullcontext(None)
        )
        with capture as intermediates:
            loss_value, hidden = self._loss_value(batch, target_mask)
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
            record = None
            if health is not None:
                # read before the update: the JAX record holds the step's
                # pre-update parameters
                record = self._health_record(health, state, flat_grad, updates, intermediates, hidden, batch, grad_norm)
            state.flat_params.copy_(torch.where(good, state.flat_params + updates, state.flat_params))
            _where_into(good, opt_state, state.opt_state)
            state.bad_steps.add_((~good).to(torch.int32))
        return loss_value, good, grad_norm, record

    def _health_record(
        self, health: HealthConfig, state: TrainState, flat_grad: torch.Tensor, updates: torch.Tensor,
        intermediates, hidden: torch.Tensor, batch: Batch, grad_norm: torch.Tensor,
    ) -> Dict[str, Any]:
        """The JAX train step's health block: the group norms over named
        views of the flat buffers, the captured stage stats and entropies,
        and the last position's logits stats (streamed over the catalog for a
        loss that never builds the full logits)."""
        model, loss = self.model, self.loss
        grad_views, update_views, offset = {}, {}, 0
        for name, param in state.params.items():
            size = param.numel()
            grad_views[name] = flat_grad[offset : offset + size].view(param.shape)
            update_views[name] = updates[offset : offset + size].view(param.shape)
            offset += size
        logits, streamed = None, None
        if health.logits_stats and hasattr(type(model), "get_logits"):
            last_hidden = (hidden[:, -1, :] if hidden.dim() == 3 else hidden).detach()
            if getattr(loss, "avoid_full_logits", False):
                if getattr(model, "logits_via_item_weights", False) and hasattr(type(model), "get_item_weights"):
                    with scope("health_logits"):
                        streamed = health_module.streamed_logits_stats(last_hidden, model.get_item_weights())
                else:
                    streamed = {"skipped": torch.ones((), dtype=torch.float32, device=hidden.device)}
                    logger.warning(
                        "health.logits_stats: %s avoids full logits and %s has no bias-free tying head to "
                        "stream stats from — the health record carries logits={'skipped': 1.0} instead",
                        type(loss).__name__, type(model).__name__,
                    )
            else:
                extra = {name: batch[name] for name in self._logits_extra_params if name in batch}
                with scope("health_logits"):
                    logits = model.get_logits(last_hidden, None, **extra)
        with scope("health"):
            record = health_module.health_metrics(
                health, {name: p.detach() for name, p in state.params.items()}, grad_views, update_views,
                intermediates, logits,
            )
        if streamed is not None:
            record["logits"] = streamed
        record["grad_norm_global"] = grad_norm
        return record

    def _generator(self) -> torch.Generator:
        """The generator the model's dropout draws from: the default one of
        the trainer's device."""
        if self.device.type != "cuda":
            return torch.default_generator
        torch.cuda.init()
        index = self.device.index if self.device.index is not None else torch.cuda.current_device()
        return torch.cuda.default_generators[index]

    @contextlib.contextmanager
    def _generator_kept(self):
        """Give the caller's generator state back on the way out."""
        generator = self._generator()
        saved = generator.get_state()
        try:
            yield generator
        finally:
            generator.set_state(saved)

    @contextlib.contextmanager
    def _dropout_stream(self, state: TrainState):
        """The dropout generator set to ``state.rng`` for the body, and
        ``state.rng`` set to what the body advanced it to (host work only)."""
        with self._generator_kept() as generator:
            generator.set_state(state.rng)
            yield
            state.rng = generator.get_state()

    def _step(self, state: TrainState, batch: Batch, health: Optional[HealthConfig] = None):
        """:meth:`_update` with the dropout masks drawn from ``state.rng``
        where the model has a non-zero rate; advances ``step`` and ``rng``."""
        if self._stochastic:
            with self._dropout_stream(state):
                metrics = self._update(state, batch, health)
        else:
            metrics = self._update(state, batch, health)
        state.step += 1
        return metrics

    def _prepare(self, state: TrainState) -> None:
        if not self._loss_checked:
            self._check_loss_contract()
        self._bind(state)

    def _refuse_dropped_segments(self, batch: Batch, params: Sequence[str], method: str) -> None:
        """Refuse a packed batch (``segment_ids``) that the model's ``method``
        cannot take: the keyword filtering would drop the key, and attention
        and loss would cross packed segments. Host work only, before any step
        or graph capture (the JAX trainer's refusal in its train step)."""
        if "segment_ids" in batch and "segment_ids" not in params:
            msg = (
                f"batch carries 'segment_ids' (packed sequences) but "
                f"{type(self.model).__name__}.{method} accepts no segment_ids "
                "parameter — training would silently attend and compute "
                "loss across packed segment boundaries. Use an unpacked "
                "batcher for this model, or plumb segment_ids through "
                "its attention path (nn.mask.segment_attention_mask)."
            )
            raise ValueError(msg)

    def train_step(self, state: TrainState, batch: Batch) -> Tuple[TrainState, torch.Tensor]:
        """One optimizer step. Returns ``(state, loss)``; the step metrics —
        ``loss``, the sentinel's ``good`` flag and ``grad_norm``, all device
        scalars — stay readable on :attr:`last_step_metrics` until the next step.

        The state's tensors are updated in place and the same state returned
        (the JAX step donates its state: the old one is not used again)."""
        self._refuse_dropped_segments(batch, self._forward_params, "forward")
        self._prepare(state)
        with self._h2d_span():
            placed = to_device(batch, self.device)
        self._record_template("train_step", placed, 1)
        with self.compile_tracker.observe("train_step", key=(self._builds, signature(_leaves(placed)))):
            loss_value, good, grad_norm, record = self._step(state, placed, self.health)
        self.last_step_metrics = {"loss": loss_value, "good": good, "grad_norm": grad_norm}
        if record is not None:
            self.last_step_metrics["health"] = record
        return state, loss_value

    def _h2d_span(self):
        """An ``h2d`` span when an enabled tracer is attached, else a no-op."""
        if self.tracer is not None and self.tracer.enabled:
            return self.tracer.span("h2d")
        return contextlib.nullcontext()

    def traced_train_step(self, state: TrainState, batch: Batch) -> Tuple[TrainState, torch.Tensor]:
        """:meth:`train_step` under the attached tracer's ``train_step`` span.

        Waits for the loss inside the span (an unfenced span would time the
        launches, not the step) and carves the build time of a step that
        built its program (the first call at a shape: kernel builds, cuBLAS
        set-up) out into a nested ``compile`` span. A plain
        :meth:`train_step` when tracing is off."""
        tracer = self.tracer
        if tracer is None or not tracer.enabled:
            return self.train_step(state, batch)
        compile_before = self.compile_tracker.total_compile_seconds
        with tracer.span("train_step") as step_span:
            state, loss_value = self.train_step(state, batch)
            _sync(loss_value)
        compile_delta = self.compile_tracker.total_compile_seconds - compile_before
        if compile_delta > 0:
            tracer.carve(step_span, "compile", compile_delta)
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

    def _chunk_placer(self, tracer: Optional[Tracer] = None) -> Callable[[Any], Optional[_Placed]]:
        """The device-feed ``place`` callable for ``fit(scan_chunk=...)``:
        stack and place a chunk on the feeder thread, so that the next chunk's
        copy to the card overlaps the running chunk; single steps pass
        through unplaced (the per-step path places its own batch). With an
        enabled ``tracer`` the copy is an ``h2d`` span on the feeder thread,
        fenced there: ``trace.json`` shows the overlap, while the fit
        thread's goodput counts only what the feed could not hide."""
        if self.device.type == "cuda" and self._feed_stream is None:
            self._feed_stream = torch.cuda.Stream(device=self.device)
        traced = tracer is not None and tracer.enabled

        def place(item):
            kind, payload = item
            if kind != "scan":
                return None
            if not traced:
                return self._place_chunk(self._stack_chunk(payload), self._feed_stream)
            with tracer.span("h2d", steps=len(payload)):
                placed = self._place_chunk(self._stack_chunk(payload), self._feed_stream)
                if placed.event is not None:
                    placed.event.synchronize()
            return placed

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

        def traced_warmup():
            # a fit that profiles: the warm-up's kernels and scopes, which
            # the replays' kernels take position by position (obs/profile.py)
            self._graph_kernels["train_scan"] = profile_module.traced_kernel_scopes(warmup)

        def run():
            for index in range(steps):
                values = self._update(state, _tree_map(lambda x: x[index], static))
                for name, value in zip(("loss", "good", "grad_norm"), values):
                    metrics[name][index].copy_(value)

        # the warm-up draws from the dropout generator; the capture records
        # its draws as offsets from the generator's state at each replay
        start = time.perf_counter()
        with self._generator_kept():
            graph, _ = capture(run, self.device, warmup=traced_warmup if self._trace_warmups else warmup)
        self.compile_tracker.record("train_scan", time.perf_counter() - start)
        self.capture_warmups += 1
        chunk = _ChunkGraph(graph, static, metrics, tensors)
        self._chunk_graphs[key] = chunk
        return chunk

    def _chunk_graph_for(self, state: TrainState, placed: _Placed, steps: int) -> _ChunkGraph:
        """The chunk graph for a placed chunk, captured now if it has none,
        once the chunk's copies are done (card only)."""
        current = torch.cuda.current_stream(self.device)
        if placed.event is not None:
            current.wait_event(placed.event)
            for leaf in _leaves(placed.batch):
                leaf.record_stream(current)
        return self._chunk_graph(state, placed.batch, steps)

    def _run_chunk(self, state: TrainState, placed: _Placed, steps: int) -> Tuple[TrainState, np.ndarray]:
        """K steps on a placed ``[K, ...]`` chunk: on the card one replay of
        the chunk's graph, on the CPU K eager steps. Sets
        :attr:`last_step_metrics` to ``[K]`` tensors; returns the losses."""
        self._refuse_dropped_segments(placed.batch, self._forward_params, "forward")
        self._prepare(state)
        self._record_template("train_scan", placed.batch, steps)
        if self.device.type != "cuda":
            with self.compile_tracker.observe("train_scan", key=(self._builds, steps, signature(_leaves(placed.batch)))):
                values = [self._step(state, _tree_map(lambda x: x[index], placed.batch)) for index in range(steps)]
            metrics = {
                name: torch.stack([v[position] for v in values])
                for position, name in enumerate(("loss", "good", "grad_norm"))
            }
        else:
            chunk = self._chunk_graph_for(state, placed, steps)
            _tree_map(lambda static, value: static.copy_(value), chunk.batch, placed.batch)
            # the replay's masks continue state.rng's stream, as K steps would
            with self._dropout_stream(state) if self._stochastic else contextlib.nullcontext():
                chunk.graph.replay()
            metrics = {name: value.clone() for name, value in chunk.metrics.items()}
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
        ``grad_norm`` tensors."""
        batches = list(batches)
        return self._run_chunk(state, self._place_chunk(self._stack_chunk(batches)), len(batches))

    # -- program introspection (obs/profile.py, obs/roofline.py) ------------ #
    def _record_template(self, name: str, batch: Batch, steps: int) -> None:
        """Keep a copy of the first batch a program ran (once per name), so
        that the analyses can run the program again on a copy of the state."""
        if name not in self._programs:
            self._programs[name] = (steps, _tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, batch))

    def _program_run(self, name: str) -> Tuple[Callable[..., Any], Tuple[Any, ...]]:
        """``(run, args)``: one call of program ``name`` (``steps`` optimizer
        steps on its recorded batch, the per-step one with this trainer's
        health) on a copy of the bound state, leaving the live state, the
        dropout generator and the model's binding as they were."""
        steps, batch = self._programs[name]
        live = self._state
        scratch = _clone_state(live)
        health = self.health if name == "train_step" else None

        def run(flat_params, opt_state, bad_steps, batch):
            self._bind(scratch)
            try:
                with self._generator_kept():
                    for index in range(steps):
                        one = batch if name == "train_step" else _tree_map(lambda x: x[index], batch)
                        out = self._update(scratch, one, health)
            finally:
                self._bind(live)
            return out

        return run, (scratch.flat_params, scratch.opt_state, scratch.bad_steps, batch)

    def analyze_programs(self, extra_flops: Optional[Mapping[str, float]] = None) -> Dict[str, Any]:
        """The roofline record of every program this trainer ran
        (``train_step``, ``train_scan``; :func:`replay_tpu_torch.obs.roofline.analyze_program`):
        FLOPs counted over one call on a copy of the state (K1–K3 through
        ``fused_ce_flops``), an eager bytes count, the allocator's memory, and
        memory- vs compute-bound with the predicted ceiling. ``extra_flops``
        maps a program name to FLOPs the counter cannot see."""
        from replay_tpu_torch.obs.roofline import analyze_program

        out: Dict[str, Any] = {}
        for name in self._programs:
            if self._state is None:
                break
            run, args = self._program_run(name)
            record = analyze_program(run, *args, extra_flops=(extra_flops or {}).get(name, 0.0), device=self.device)
            if record is not None:
                out[name] = record
        return out

    def _profile_payload(self, profile_dir: str, launches: Optional[Mapping[str, int]] = None) -> Dict[str, Any]:
        """A profiled fit's analyses: the per-scope device time of its capture
        (obs/profile.py; replays through the traced warm-ups), each
        program's roofline record, and the kernel launches counted in the
        window. Best-effort: a capture that cannot be read logs a warning."""
        payload: Dict[str, Any] = {}
        try:
            payload["device_time"] = profile_module.attribute_capture(
                profile_dir, self._graph_kernels, kernels=profile_module.TRACE_NAMES
            )
        except (OSError, ValueError) as exc:
            logger.warning("device-time attribution failed for %s: %s", profile_dir, exc)
        else:
            if launches is not None:
                payload["device_time"]["launches"] = dict(launches)
        rooflines = self.analyze_programs()
        if rooflines:
            payload["roofline"] = rooflines
        return payload

    def fit(self, *args, **kwargs) -> TrainState:
        try:
            return self._fit_impl(*args, **kwargs)
        except BaseException:
            # a raising fit must not leak the live metrics endpoint: the
            # non-raising exits (and the recovery-exhausted raise) close it
            # in finish_trace; this catches every other exit
            if self.metrics_exporter is not None:
                self.metrics_exporter.close()
                self.metrics_exporter = None
            self._trace_warmups = False
            raise

    def _fit_impl(
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
        checkpoint_manager=None,
        checkpoint_every: Optional[int] = None,
        resume: bool = False,
        monitor: Optional[str] = None,
        patience: Optional[int] = None,
        mode: str = "max",
        prefetch: int = 0,
        scan_chunk: Optional[int] = None,
        device_feed: bool = True,
        loggers: Optional[RunLogger | Sequence[RunLogger]] = None,
        profile_steps: Optional[Tuple[int, int]] = None,
        profile_dir: Optional[str] = None,
        recovery: Optional[RecoveryPolicy] = None,
        detect_anomalies: Optional[bool] = None,
        handle_preemption: Optional[bool] = None,
        tracer: Optional[Tracer | bool] = None,
        trace_path: Optional[str] = None,
        metrics_port: Optional[int] = None,
        slo_rules: Optional[Sequence[Any]] = None,
        flight_path: Optional[str] = None,
    ) -> TrainState:
        """Train for ``epochs`` passes; validates after each epoch when
        ``val_batches`` is given, appending one record per epoch to
        :attr:`history`. A dict of validation factories runs each stream in
        turn, prefixing its metric keys with the stream's name. The JAX
        ``fit``'s semantics, argument by argument:

        ``train_batches`` may be a re-iterable (a ``SequenceBatcher`` or
        ``TransformedBatches``: its ``set_epoch`` is called, so shuffling
        advances per epoch), a zero- or one-arg callable returning an
        iterable (the arg is the epoch), or a one-shot iterator (materialized
        once if several epochs are requested). An epoch's ``train_loss``
        averages the steps the sentinel accepted (NaN when it accepted none).

        ``monitor`` (a history key, e.g. ``"recall@10"`` or ``"train_loss"``)
        turns on best-state tracking: fit returns the best state seen, marks
        the winning checkpoint, and with ``patience`` stops after that many
        epochs without improvement (Lightning's ModelCheckpoint + EarlyStopping).

        ``checkpoint_manager`` saves at every epoch end; ``checkpoint_every``
        also mid-epoch every that many steps, with the stream position
        (``epoch``, ``step_in_epoch``), the LR scale and the epoch's running
        loss sum in the metadata. ``resume=True`` restores the manager's
        latest valid checkpoint, its history, the monitored best and the LR
        scale, then fast-forwards the (deterministic, epoch-seeded) stream to
        the saved position, or seeks through a batcher's cursor, so a killed
        run continues as the uninterrupted one would, bit for bit; a run that
        was already complete returns its (best) checkpoint.

        ``prefetch=n`` builds batches ``n`` ahead on a background thread.
        ``scan_chunk=K`` runs each epoch's full groups of K batches through
        :meth:`train_steps` (one CUDA graph replay a chunk on the card) and the
        short tail through :meth:`train_step`; the ``[K]`` losses and sentinel
        flags fan out into the epoch's accounting exactly as K steps would.
        With ``device_feed=True`` a feeder thread stacks and copies the next
        chunk to the card while the current one runs
        (:class:`~replay_tpu_torch.data.nn.prefetch.DevicePrefetcher`). Under
        ``scan_chunk`` a ``checkpoint_every`` boundary crossed inside a chunk
        saves at the chunk end, a preemption exits at the next chunk boundary,
        and a rollback triggered mid-chunk drops the rest of that chunk's
        accounting while the stream position advances.

        ``loggers`` attaches event sinks (:mod:`replay_tpu_torch.obs.events`):
        ``on_fit_start``, ``on_train_step`` every step (one host read of the
        loss a step), ``on_anomaly``, ``on_recovery``, ``on_checkpoint``,
        ``on_preemption``, ``on_validation_end``, ``on_epoch_end`` and
        ``on_fit_end``. ``log_every`` is itself a sink, a ``ConsoleLogger``:
        alone, it sees every ``log_every``-th executed step, counted across
        epochs.

        ``detect_anomalies`` checks the sentinel on the host every step and
        emits ``on_anomaly`` per skipped step (default: on with ``recovery``
        or explicit ``loggers``). ``recovery`` attaches a
        :class:`RecoveryPolicy`: after ``max_consecutive_bad`` skipped steps
        (counted even with ``detect_anomalies=False``) or an epoch-end blowup
        of the monitored metric, fit restores the manager's latest checkpoint
        (before any save, a snapshot of the initial state), backs the LR off,
        emits ``on_recovery`` and goes on forward in the stream, at most
        ``max_restarts`` times, then raises ``RuntimeError``.
        ``handle_preemption`` (default: on with a ``checkpoint_manager``)
        installs SIGTERM/SIGINT handlers for the loop (:class:`PreemptionHandler`).

        Model health: with a :class:`HealthConfig` on :attr:`health` the
        per-step program also computes the health record; fit fetches it
        every ``cadence`` executed steps (one host read), attaches it as a
        ``health`` payload to the next ``on_train_step`` and to every
        ``on_epoch_end``, keeps it on :attr:`last_health`, and, with a
        ``HealthWatcher``, emits ``on_health_warning`` on a blowup (a
        rollback too, with ``trigger_recovery`` and a ``recovery`` policy).
        Under ``scan_chunk`` every ``cadence``-th step runs singly through the
        health-instrumented per-step program; the other steps stay in the
        K-step graphs, which compute no health.

        Tracing: ``tracer=True`` (or a :class:`~replay_tpu_torch.obs.trace.Tracer`)
        records the ``data_wait`` / ``h2d`` / ``compile`` / ``train_step`` /
        ``validation`` / ``checkpoint`` / ``recovery`` spans, writes a Chrome
        trace ``trace.json`` to ``trace_path`` (default: the first
        ``JsonlLogger``'s run directory) at ``on_fit_end``, at
        ``on_preemption`` and when the recovery budget runs out, and adds a
        ``goodput`` breakdown of the fit thread's wall clock to every
        ``on_epoch_end`` and ``on_fit_end`` (``spans`` too, on the latter). A
        tracer given as an argument scopes to this fit. A traced step waits
        for its loss.

        Profiling: ``profile_steps=(start, stop)`` records a ``torch.profiler``
        window over those executed steps (rounded out to chunk boundaries)
        into ``profile_dir`` (default: the first ``JsonlLogger``'s
        ``run_dir/profile``, else ``./torch_profile``), with the named scopes
        open; ``on_fit_end`` then carries ``device_time`` (per-scope device
        time, :mod:`replay_tpu_torch.obs.profile`, and the kernel launches
        counted in the window) and ``roofline`` (each program's record,
        :meth:`analyze_programs`).

        The live metrics plane: ``metrics_port`` serves a
        :class:`~replay_tpu_torch.obs.metrics.MetricsLogger` registry over
        HTTP while the fit runs (``/metrics``, ``/snapshot``, ``/healthz``;
        ``0`` binds an ephemeral port, read from :attr:`metrics_exporter`; a
        port that cannot bind logs a warning and serves nothing);
        ``slo_rules`` attaches an :class:`~replay_tpu_torch.obs.slo.SLOWatchdog`
        whose ``on_slo_violation`` / ``on_slo_recovery`` events go through
        the same sinks. ``flight_path`` (default: ``$REPLAY_TPU_FLIGHT_PATH``)
        records the event stream into a flight ring that survives SIGKILL
        (:mod:`replay_tpu_torch.obs.blackbox`). Each of them implies per-step
        events, like any explicit sink; the exporter and the ring close at
        fit end.

        One deviation: a resumed epoch's ``train_loss`` covers the whole
        epoch (the JAX fit averages only the steps after the resume).
        """
        if checkpoint_manager is not None:
            checkpoint_manager = _LayoutCheckedManager(checkpoint_manager, self)
        if checkpoint_manager is not None and not self.history:
            # resume: earlier epochs' records survive the restart
            self.history = list(checkpoint_manager.history())
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
            if hasattr(train_batches, "set_epoch"):
                train_batches.set_epoch(epoch)
            return train_batches

        if mode not in ("max", "min"):
            msg = "mode must be 'max' or 'min'"
            raise ValueError(msg)
        if patience is not None and patience < 1:
            msg = "patience must be >= 1 (it counts consecutive non-improving epochs)"
            raise ValueError(msg)

        def reject_bucketed(source) -> None:
            """A bucketed batcher cannot feed the chunks: fail up front, on the
            fit argument and on what a factory returns."""
            if getattr(source, "bucket_boundaries", None) or (
                hasattr(source, "scan_compatible") and not source.scan_compatible
            ):
                msg = (
                    "fit(scan_chunk=...) stacks K batches into one [K, B, L] chunk, which "
                    f"requires ONE fixed batch shape; {type(source).__name__}(bucket_boundaries=...) "
                    "emits a set of widths. Drop the bucketing or the scan_chunk."
                )
                raise ValueError(msg)

        if scan_chunk is not None:
            scan_chunk = int(scan_chunk)
            if scan_chunk < 1:
                msg = "scan_chunk must be >= 1 (optimizer steps per lax.scan dispatch)"
                raise ValueError(msg)
            reject_bucketed(train_batches)

        if state is not None:
            # continual-training guard: a table grown without its optimizer
            # moments (or the reverse) fails here, naming the table, before
            # any step trains on moments that no longer line up with the rows
            from replay_tpu_torch.nn.vocabulary import validate_optimizer_state

            schema = getattr(self.model, "schema", None)
            if schema is not None:
                validate_optimizer_state(state.params or dict(self.model.named_parameters()), state.opt_state, schema)

        start_epoch, skip_steps, pending_restore_step = 0, 0, None
        resumed_best_step, pending_stream_cursor, resumed_sums = None, None, None
        if resume:
            if checkpoint_manager is None:
                msg = "resume=True needs a checkpoint_manager"
                raise ValueError(msg)
            if state is not None:
                msg = (
                    "resume=True restores the manager's latest checkpoint; "
                    "passing state= as well is ambiguous (the explicit state "
                    "would silently win). Drop one of the two."
                )
                raise ValueError(msg)
            latest = checkpoint_manager.latest_step()
            if latest is not None:
                meta = checkpoint_manager.metadata(latest)
                if meta.get("mid_epoch"):
                    start_epoch = int(meta["epoch"])
                    skip_steps = int(meta["step_in_epoch"])
                    pending_stream_cursor = checkpoint_manager.process_metadata(latest).get(
                        "stream_cursor"
                    ) or meta.get("stream_cursor")
                    if meta.get("epoch_good") is not None:
                        resumed_sums = (np.float32(meta["epoch_loss"]), np.int32(meta["epoch_good"]))
                elif "epoch" in meta:
                    start_epoch = int(meta["epoch"]) + 1
                else:
                    msg = (
                        f"Checkpoint step {latest} carries no data-iterator "
                        "position ('epoch' missing from its metadata — saved by "
                        "a manual save_checkpoint); resuming would silently "
                        "retrain from epoch 0 on top of the restored weights. "
                        "Restore explicitly via restore_checkpoint and pass state= instead."
                    )
                    raise ValueError(msg)
                if meta.get("lr_scale"):
                    # the killed run had backed its LR off; resuming at the
                    # full rate would rerun the divergence
                    self._set_lr_scale(float(meta["lr_scale"]))
                pending_restore_step = latest
                resumed_best_step = checkpoint_manager.best_step()
                logger.info(
                    "resuming from step %d (epoch %d, fast-forward %d batches)", latest, start_epoch, skip_steps
                )

        best_value, best_state, stale_epochs = None, None, 0
        if resume and monitor is not None:
            # seed the monitored best from the restored history (and the
            # winning checkpoint's sidecar, which survives a lost history)
            seen_values = [r[monitor] for r in self.history if monitor in r and math.isfinite(r[monitor])]
            if seen_values:
                best_value = max(seen_values) if mode == "max" else min(seen_values)
            if resumed_best_step is not None:
                try:
                    sidecar_value = checkpoint_manager.metadata(resumed_best_step).get(monitor)
                except (OSError, ValueError):
                    sidecar_value = None
                if (
                    isinstance(sidecar_value, (int, float))
                    and not isinstance(sidecar_value, bool)
                    and math.isfinite(sidecar_value)
                    and (
                        best_value is None
                        or (mode == "max" and sidecar_value > best_value)
                        or (mode == "min" and sidecar_value < best_value)
                    )
                ):
                    best_value = float(sidecar_value)

        # -- event sinks -------------------------------------------------- #
        explicit_loggers: List[RunLogger] = []
        if loggers is not None:
            # duck-typed: a single sink is anything with log_event
            explicit_loggers = [loggers] if hasattr(loggers, "log_event") else list(loggers)
        # -- the live metrics plane (obs/metrics.py, exporter.py, slo.py) --- #
        # the MetricsLogger is an explicit sink: live gauges need per-step events
        metrics_logger = None
        if self.metrics_exporter is not None:
            # a previous fit raised before its terminal event: free the port
            self.metrics_exporter.close()
            self.metrics_exporter = None
        if metrics_port is not None or slo_rules:
            from replay_tpu_torch.obs.exporter import MetricsExporter
            from replay_tpu_torch.obs.metrics import MetricsLogger
            from replay_tpu_torch.obs.slo import SLOWatchdog

            metrics_logger = MetricsLogger()
            self.metrics_registry = metrics_logger.registry
            if slo_rules:
                # emit is pointed at the sink fan-out once run_logger exists
                metrics_logger.watchdog = SLOWatchdog(slo_rules, metrics_logger.registry)
            explicit_loggers.append(metrics_logger)
            if metrics_port is not None:
                self.metrics_exporter = MetricsExporter(
                    metrics_logger.registry, port=metrics_port, identity={"process_index": 0}
                ).start()
        # -- the flight ring (obs/blackbox.py): survives SIGKILL ----------- #
        flight_path = flight_path or os.environ.get("REPLAY_TPU_FLIGHT_PATH")
        flight_logger = None
        if flight_path:
            from replay_tpu_torch.obs.blackbox import BlackboxLogger

            try:
                flight_logger = BlackboxLogger(flight_path, meta={"role": "fit", "pid": os.getpid(), "process_index": 0})
            except OSError as exc:
                # the black box must never take down the run it records
                logger.warning("flight recorder: cannot open %s (%s); fit runs unrecorded", flight_path, exc)
            else:
                explicit_loggers.append(flight_logger)
        sinks: List[RunLogger] = list(explicit_loggers)
        if log_every:
            # alone, the console receives events at log_every cadence already
            sinks.append(ConsoleLogger(every=log_every if explicit_loggers else 1))
        run_logger: Optional[RunLogger] = MultiLogger(sinks) if len(sinks) > 1 else (sinks[0] if sinks else None)
        if metrics_logger is not None and metrics_logger.watchdog is not None:
            # violations ride the same fan-out as every other event
            metrics_logger.watchdog.emit = run_logger.log_event
        event_every = 1 if explicit_loggers else (log_every or 0)

        def first_run_dir() -> Optional[str]:
            queue: List[RunLogger] = list(explicit_loggers)
            while queue:  # MultiLogger nests sinks: search them too
                sink = queue.pop(0)
                if isinstance(sink, JsonlLogger):
                    return sink.run_dir
                if isinstance(sink, MultiLogger):
                    queue.extend(sink.loggers)
            return None

        # -- span tracing and goodput (obs/trace.py) ------------------------ #
        prior_tracer = self.tracer
        tracer_from_arg = tracer is not None
        if tracer is True:
            tracer = Tracer()
        if isinstance(tracer, Tracer):
            self.tracer = tracer  # train_step's h2d spans route through it too
        trace = self.tracer if self.tracer is not None and self.tracer.enabled else None
        tracing = trace is not None
        if tracing and trace_path is None and first_run_dir() is not None:
            trace_path = os.path.join(first_run_dir(), "trace.json")
        # goodput windows decompose this thread's wall clock: other threads'
        # spans (the feeder's h2d) overlap it, so they stay out of the fractions
        fit_trace_base = trace.snapshot(only_current_thread=True) if tracing else {}
        fit_summary_base = trace.summary() if tracing else {}
        fit_trace_t0 = time.perf_counter()

        def span(name: str, **args):
            """A trace span when tracing, else a no-op context."""
            return trace.span(name, **args) if tracing else contextlib.nullcontext()

        def trace_window(base: Dict[str, float], t0: float) -> Dict[str, Any]:
            """Goodput record over this thread's spans since (base, t0)."""
            current = trace.snapshot(only_current_thread=True)
            diff = {name: current.get(name, 0.0) - base.get(name, 0.0) for name in current}
            return goodput_breakdown(diff, time.perf_counter() - t0)

        def fit_spans() -> Dict[str, Dict[str, float]]:
            """Per-name span totals over this fit (all threads)."""
            out: Dict[str, Dict[str, float]] = {}
            for name, entry in trace.summary().items():
                prev = fit_summary_base.get(name, {"count": 0, "seconds": 0.0, "self_seconds": 0.0})
                count = entry["count"] - prev["count"]
                if count > 0:
                    out[name] = {
                        "count": count,
                        "seconds": entry["seconds"] - prev["seconds"],
                        "self_seconds": entry["self_seconds"] - prev["self_seconds"],
                    }
            return out

        def save_trace(when: str = "") -> None:
            try:
                trace.save(trace_path)
            except OSError as exc:
                logger.warning("trace.json not written to %s%s: %s", trace_path, when, exc)

        def finish_trace() -> None:
            """Terminal work: write trace.json, stop the exporter, close the
            flight ring, and detach a tracer given as a fit argument."""
            if tracing and trace_path is not None:
                save_trace()
            if tracer_from_arg:
                self.tracer = prior_tracer
            if self.metrics_exporter is not None:
                self.metrics_exporter.close()
                self.metrics_exporter = None
            if flight_logger is not None:
                flight_logger.close()
            self._trace_warmups = False

        def emit(name: str, step=None, epoch=None, **payload) -> None:
            if run_logger is not None:
                run_logger.log_event(TrainerEvent(event=name, step=step, epoch=epoch, payload=payload))
            if name == "on_preemption" and tracing and trace_path is not None:
                # flush the span tree before the shutdown-window save
                save_trace(" at preemption")
            if name == "on_fit_end":
                # every non-raising exit ends in exactly one on_fit_end
                finish_trace()

        # -- resilience ----------------------------------------------------- #
        # host-side anomaly checks cost one device sync per step, so they
        # default on only where that sync already happens or is required
        check_anomalies = (
            detect_anomalies if detect_anomalies is not None else (recovery is not None or bool(explicit_loggers))
        )
        consecutive_bad, restarts = 0, 0
        initial_snapshot: Optional[TrainState] = None  # rollback target before any checkpoint
        last_grad_norm = None

        # -- model health (obs/health.py) ----------------------------------- #
        # the per-step program computes the record; the host fetches it every
        # cadence steps. The K-step graphs compute none: under scan_chunk the
        # cadence steps run singly (_chunk_schedule breaks the chunks there)
        health_cfg = self.health
        health_watcher = health_cfg.watcher if health_cfg is not None else None
        health_every = health_cfg.cadence if (scan_chunk and health_cfg is not None) else None
        if health_every:
            logger.info(
                "scan_chunk=%d with health cadence %d: every %dth step runs the health-instrumented "
                "per-step program; cadence ≡ 1 (mod scan_chunk) keeps full chunks between health steps",
                scan_chunk, health_every, health_every,
            )
        pending_health: Optional[Dict[str, Any]] = None
        # per-fit scope: a second fit must not carry the previous fit's record
        self.last_health = None

        def do_recovery(reason: str, epoch: int) -> TrainState:
            with span("recovery", reason=reason):
                return _do_recovery(reason, epoch)

        def _do_recovery(reason: str, epoch: int) -> TrainState:
            """Roll back to the last checkpoint (else the initial snapshot),
            back the LR off, and return the state to continue from. The
            stream is not rewound: recovery moves forward through the data."""
            nonlocal restarts, consecutive_bad, last_grad_norm, pending_health
            restarts += 1
            consecutive_bad = 0
            # the discarded trajectory's records must not describe the restored one
            last_grad_norm, pending_health, self.last_health = None, None, None
            if health_watcher is not None:
                health_watcher.reset()
            if restarts > recovery.max_restarts:
                emit("on_recovery", epoch=epoch, reason=reason, restarts=restarts, exhausted=True)
                # this raise skips on_fit_end: persist the trace now
                finish_trace()
                msg = (
                    f"RecoveryPolicy budget exhausted: {restarts - 1} restarts "
                    f"(max_restarts={recovery.max_restarts}) did not stabilize "
                    f"the run (last trigger: {reason})"
                )
                raise RuntimeError(msg)
            target = checkpoint_manager.latest_step() if checkpoint_manager is not None else None
            if target is not None:
                new_state = checkpoint_manager.restore(state, step=target)
            else:
                new_state = _clone_state(initial_snapshot)
            self._set_lr_scale(self._lr_scale * recovery.lr_backoff)
            logger.warning(
                "recovery %d/%d (%s): rolled back to %s, lr scale now %.3g",
                restarts, recovery.max_restarts, reason,
                f"checkpoint step {target}" if target is not None else "initial state", self._lr_scale,
            )
            emit("on_recovery", step=new_state.step, epoch=epoch, reason=reason,
                 restarts=restarts, restored_step=target, lr_scale=self._lr_scale)
            self._bind(new_state)
            return new_state

        def save_mid_epoch(preempted: bool = False) -> None:
            # one position-stamping path for periodic and preemption saves
            extra: Dict[str, Any] = {"preempted": True} if preempted else {}
            if self._lr_scale != 1.0:  # recovery backoff survives the resume
                extra["lr_scale"] = self._lr_scale
            process_extra = None
            if cursor_source is not None:
                try:
                    cursor_meta = cursor_source.cursor_for(n_steps).to_metadata()
                except KeyError as exc:
                    logger.warning(
                        "stream cursor unavailable at step %d (%s); resume will fall back to fast-forwarding",
                        n_steps, exc,
                    )
                else:
                    extra["stream_cursor"] = cursor_meta
                    process_extra = {"stream_cursor": cursor_meta}
            # the epoch's running loss sum and count: a resume continues them
            sums = {
                "epoch_loss": float(epoch_loss) if epoch_loss is not None else 0.0,
                "epoch_good": int(epoch_good) if epoch_good is not None else 0,
            }
            with span("checkpoint"):
                checkpoint_manager.save(
                    state.step, state, history=self.history,
                    metadata={"mid_epoch": True, "epoch": epoch, "step_in_epoch": n_steps, **sums, **extra},
                    process_metadata=process_extra,
                )
            emit("on_checkpoint", step=state.step, epoch=epoch, mid_epoch=True, step_in_epoch=n_steps, **extra)

        install_preemption = handle_preemption if handle_preemption is not None else checkpoint_manager is not None
        preemption = PreemptionHandler() if install_preemption else None

        telemetry = StepTelemetry(warmup_steps=1)
        memory = MemoryMonitor([self.device])
        lr_schedule = (
            self.optimizer.scheduler.create(self.optimizer.learning_rate) if self.optimizer.scheduler else None
        )

        def current_lr(step: int) -> float:
            # every schedule kind is linear in its peak rate: scaling its
            # value equals rebuilding it from the scaled rate
            if lr_schedule is None:
                return float(self.optimizer.learning_rate) * self._lr_scale
            return float(lr_schedule(torch.tensor(max(step, 0), dtype=torch.int32))) * self._lr_scale

        def fit_end_payload() -> Dict[str, Any]:
            payload: Dict[str, Any] = {
                "telemetry": telemetry.summary(),
                "compile": self.compile_tracker.report(),
                "peak_memory_bytes": memory.peak_bytes(),
                "history_len": len(self.history),
            }
            if memory.observed_samples:
                # the chunk-boundary samples: this fit's own high-water mark
                payload["peak_memory_sampled_bytes"] = memory.observed_peak_bytes
                payload["peak_memory_samples"] = memory.observed_samples
            if state is not None:
                payload["bad_steps"] = int(state.bad_steps)
            input_record = input_summary()
            if input_record is not None:
                payload["input"] = input_record
            if tracing:
                payload["goodput"] = trace_window(fit_trace_base, fit_trace_t0)
                payload["spans"] = fit_spans()
            if profile_capture_dir is not None:
                close_profile()  # a window still open when the fit ended
                payload.update(self._profile_payload(profile_capture_dir, profile_launches))
            return payload

        # -- the profile window (obs/profile.py) ---------------------------- #
        if profile_steps is not None:
            profile_start, profile_stop = int(profile_steps[0]), int(profile_steps[1])
            if profile_stop <= profile_start or profile_start < 0:
                msg = f"profile_steps must be a valid [start, stop) window, got {profile_steps}"
                raise ValueError(msg)
            # the chunk graph captured in this fit traces its warm-up, whose
            # kernels the replays in the window take their scopes from
            self._trace_warmups = True
            if "train_scan" not in self._graph_kernels:
                self._chunk_graphs.clear()
        profile_stack = contextlib.ExitStack()
        profile_active = False
        profile_capture_dir: Optional[str] = None  # set when the window opens
        profile_launches: Optional[Dict[str, int]] = None
        launches_at_open: Dict[str, int] = {}

        def open_profile(steps: int) -> None:
            """Open the window if it starts within the next ``steps`` executed steps."""
            nonlocal profile_active, profile_capture_dir, launches_at_open
            if profile_steps is None or profile_active or profile_capture_dir is not None:
                return
            if not measured_total <= profile_start < measured_total + steps:
                return
            run_dir = first_run_dir()
            profile_capture_dir = profile_dir or (os.path.join(run_dir, "profile") if run_dir else "torch_profile")
            profile_stack.enter_context(profile_module.trace(profile_capture_dir))
            launches_at_open = profile_module.launch_counts()
            profile_active = True

        def close_profile() -> None:
            nonlocal profile_active, profile_launches
            if profile_active:
                counted = profile_module.launch_counts()
                profile_launches = {name: counted[name] - launches_at_open[name] for name in counted}
                profile_stack.close()
                profile_active = False

        measured_total = 0  # steps executed by this fit call
        last_emitted_at = 0
        tokens_real_total = tokens_grid_total = tick_tokens_real = tick_tokens_grid = 0

        def count_tokens(batch: Batch) -> None:
            nonlocal tokens_real_total, tokens_grid_total
            mask = batch.get(self.padding_mask_field)
            if mask is None or getattr(mask, "ndim", 0) != 2:
                return
            mask = _host(mask)
            valid = batch.get("valid")
            tokens_real_total += int(mask[_host(valid)].sum()) if valid is not None else int(mask.sum())
            tokens_grid_total += mask.size

        def input_summary() -> Optional[Dict[str, float]]:
            if not tokens_grid_total:
                return None
            steps_per_sec = telemetry.summary().get("steps_per_sec")
            tokens_per_step = tokens_real_total / max(measured_total, 1)
            effective = (
                tokens_per_step * steps_per_sec
                if steps_per_sec is not None and math.isfinite(steps_per_sec)
                else float("nan")
            )
            return {
                "tokens_real": tokens_real_total,
                "tokens_grid": tokens_grid_total,
                "padding_fraction": 1.0 - tokens_real_total / tokens_grid_total,
                "effective_tokens_per_sec": effective,
            }

        def telemetry_tick(batch: Batch) -> Dict[str, float]:
            """Fold the steps since the last tick into the telemetry window."""
            nonlocal last_emitted_at, tick_tokens_real, tick_tokens_grid
            delta = measured_total - last_emitted_at
            last_emitted_at = measured_total
            reference = batch.get(self.padding_mask_field)
            rows = int(reference.shape[0]) if reference is not None else None
            tick = telemetry.tick(samples=rows * delta if rows else None, steps=delta)
            window_real = tokens_real_total - tick_tokens_real
            window_grid = tokens_grid_total - tick_tokens_grid
            tick_tokens_real, tick_tokens_grid = tokens_real_total, tokens_grid_total
            nan = float("nan")
            tick["padding_fraction"] = 1.0 - window_real / window_grid if window_grid else nan
            tick["effective_tokens_per_sec"] = window_real / delta * tick["steps_per_sec"] if delta else nan
            return tick

        emit(
            "on_fit_start", epoch=start_epoch, epochs=epochs, model=type(self.model).__name__,
            loss=type(self.loss).__name__, optimizer=self.optimizer.name,
            learning_rate=self.optimizer.learning_rate, resumed=bool(resume and pending_restore_step is not None),
            **(self.precision.describe() if self.precision is not None else {}),
        )

        if pending_restore_step is not None and start_epoch >= epochs:
            # the run is already complete: return its checkpoint — the
            # monitored best when one is marked, as the uninterrupted fit did
            first = next(iter(batches_for(0)), None)
            if first is None:
                msg = "fit() received no batches"
                raise ValueError(msg)
            restore_step = pending_restore_step
            if monitor is not None and resumed_best_step is not None:
                restore_step = resumed_best_step
            restored = checkpoint_manager.restore(self.init_state(first), step=restore_step)
            self._bind(restored)
            logger.info("resume: run already complete at step %d", restore_step)
            emit("on_fit_end", step=restore_step, epoch=start_epoch, note="resume: run already complete",
                 **fit_end_payload())
            return restored

        def start(batch: Batch) -> None:
            """Per-batch preamble: the state's first batch initializes it (or
            restores the checkpoint a resume names), and the recovery
            snapshot is taken before the first step."""
            nonlocal state, pending_restore_step, initial_snapshot
            if state is None:
                state = self.init_state(batch)
                if pending_restore_step is not None:
                    state = checkpoint_manager.restore(state, step=pending_restore_step)
                    self._bind(state)
                    pending_restore_step = None
            if recovery is not None and initial_snapshot is None:
                initial_snapshot = _clone_state(state)

        def account_step(batch: Batch, loss_value, good, grad_norm, epoch: int,
                         step_id: Optional[int] = None, bad_total: Optional[int] = None,
                         health_record: Optional[Mapping[str, Any]] = None) -> bool:
            """Bookkeeping for one optimizer step, shared by single steps
            (device scalars: the epoch sums add on the device) and the chunk
            fan-out (host values: the same IEEE f32 adds on the host): the
            epoch sums, the health fetch at the cadence and its watcher, the
            anomaly events, the profile window's end, the step event. Returns
            True when a recovery rollback fired."""
            nonlocal epoch_loss, epoch_good, n_steps, measured_total, last_grad_norm, consecutive_bad, state
            nonlocal pending_health
            rolled_back = False
            if isinstance(loss_value, torch.Tensor):
                if epoch_loss is not None and not isinstance(epoch_loss, torch.Tensor):
                    # a resumed epoch's sums, and the chunks' before a tail step, are on the host
                    epoch_loss = torch.tensor(epoch_loss, device=self.device)
                    epoch_good = torch.tensor(epoch_good, device=self.device)
                safe_loss, good_flag = torch.where(good, loss_value, 0.0), good.to(torch.int32)
            else:
                safe_loss = np.float32(loss_value) if bool(good) else np.float32(0.0)
                good_flag = np.int32(bool(good))
            epoch_loss = safe_loss if epoch_loss is None else epoch_loss + safe_loss
            epoch_good = good_flag if epoch_good is None else epoch_good + good_flag
            n_steps += 1
            measured_total += 1
            count_tokens(batch)
            last_grad_norm = grad_norm
            if health_cfg is not None and health_record is not None and measured_total % health_cfg.cadence == 0:
                # the health sync: one host read of the step's small record
                fetched = health_module.to_host(health_record)
                self.last_health = pending_health = fetched
                if health_watcher is not None:
                    warning = health_watcher.observe(fetched)
                    if warning is not None:
                        emit("on_health_warning", step=state.step if step_id is None else step_id, epoch=epoch,
                             **warning)
                        if health_watcher.trigger_recovery and recovery is not None:
                            state = do_recovery("health_warning", epoch)
                            epoch_loss, epoch_good = None, None
                            rolled_back = True
            if check_anomalies or recovery is not None:
                # a recovery policy sees every bad step, even with events off
                if not bool(good):
                    consecutive_bad += 1
                    if check_anomalies:
                        emit(
                            "on_anomaly", step=state.step if step_id is None else step_id, epoch=epoch,
                            loss=float(loss_value), grad_norm=float(grad_norm), consecutive_bad=consecutive_bad,
                            bad_steps_total=int(state.bad_steps) if bad_total is None else bad_total,
                        )
                    if recovery is not None and consecutive_bad >= recovery.max_consecutive_bad:
                        state = do_recovery("consecutive_bad_steps", epoch)
                        # the epoch average describes the restored trajectory
                        epoch_loss, epoch_good = None, None
                        rolled_back = True
                else:
                    consecutive_bad = 0
            if profile_active and measured_total >= profile_stop:
                close_profile()
            if event_every and measured_total % event_every == 0:
                emit_step = state.step if step_id is None else step_id
                tick = telemetry_tick(batch)
                emit(
                    "on_train_step", step=emit_step, epoch=epoch, loss=float(loss_value),
                    # the rate the optimizer applied: schedules are indexed by
                    # the steps completed before the update
                    lr=current_lr(emit_step - 1), samples_per_sec=tick["samples_per_sec"],
                    steps_per_sec=tick["steps_per_sec"], step_seconds=tick["step_seconds"],
                    effective_tokens_per_sec=tick["effective_tokens_per_sec"],
                    padding_fraction=tick["padding_fraction"],
                    # a health record fetched since the last emission rides the next step event
                    **({"health": pending_health} if pending_health is not None else {}),
                )
                pending_health = None
            return rolled_back

        def preempted_exit(epoch: int, boundary_saved: bool) -> bool:
            """At a step (or chunk) boundary: honour a preemption request by
            saving a position-stamped checkpoint; True when fit must return."""
            if preemption is None or not preemption.requested:
                return False
            emit("on_preemption", step=state.step, epoch=epoch, signal=preemption.signal_name)
            if checkpoint_manager is not None and not boundary_saved:
                save_mid_epoch(preempted=True)
            logger.warning("preemption: checkpoint saved at step %d; exiting fit", state.step)
            emit("on_fit_end", step=state.step, epoch=epoch, preempted=True, **fit_end_payload())
            return True

        stopped_early = False
        cursor_source = None  # the current epoch's resumable batch source
        epoch_loss = epoch_good = None
        n_steps = 0
        # the per-epoch goodput window: opens here and again right after each
        # on_epoch_end, so consecutive windows tile the fit's wall clock
        epoch_trace_base = trace.snapshot(only_current_thread=True) if tracing else {}
        epoch_trace_t0 = time.perf_counter()
        # profile_stack closes a window still open on any exit
        with profile_stack, (preemption or contextlib.nullcontext()):
            for epoch in range(start_epoch, epochs):
                # n_steps = position in the epoch's stream (skipped batches
                # included, keeping checkpoint_every aligned across resumes)
                epoch_loss, epoch_good, n_steps = None, None, 0
                skipped = 0
                last_batch = None
                epoch_needs_mark = True  # discounts the inter-epoch gap from the telemetry window
                epoch_batches = batches_for(epoch)
                cursor_source = epoch_batches if getattr(epoch_batches, "supports_cursor", False) else None
                if pending_stream_cursor is not None and epoch == start_epoch and cursor_source is not None:
                    recorded = int(pending_stream_cursor.get("batches", -1))
                    if recorded == skip_steps:
                        # seek: the batcher resumes mid-epoch without re-reading
                        cursor_source.restore_cursor(pending_stream_cursor)
                        skipped = n_steps = skip_steps
                    else:
                        logger.warning(
                            "stream cursor records %d batches but the checkpoint position is %d; "
                            "falling back to fast-forward", recorded, skip_steps,
                        )
                    pending_stream_cursor = None
                if epoch == start_epoch and resumed_sums is not None:
                    epoch_loss, epoch_good = resumed_sums
                    resumed_sums = None
                if scan_chunk:
                    # a factory hid its batcher from the fit-start check
                    reject_bucketed(epoch_batches)
                source = prefetch_batches(iter(epoch_batches), depth=prefetch) if prefetch else epoch_batches
                # traced: every next() is a data_wait span (chunked, the
                # feeder consumes the stream, and the wait on the feed is timed)
                stream = traced_iterator(source, trace) if tracing and not scan_chunk else source
                try:
                    batch_iter = iter(stream)
                    first_batch = None
                    for batch in batch_iter:
                        start(batch)
                        if epoch == start_epoch and skipped < skip_steps:
                            # fast-forward: the stream is deterministic per
                            # epoch, so consuming without stepping lands on the position
                            skipped += 1
                            n_steps += 1
                            continue
                        first_batch = batch
                        break
                    rest = itertools.chain([first_batch], batch_iter) if first_batch is not None else iter(())
                    # without scan_chunk every batch is one "step" item
                    items = (
                        _chunk_schedule(rest, scan_chunk, health_every, start=measured_total)
                        if scan_chunk
                        else (("step", b) for b in rest)
                    )
                    feed = (
                        DevicePrefetcher(items, self._chunk_placer(trace), depth=1)
                        if scan_chunk and device_feed and first_batch is not None
                        else ((item, None) for item in items)
                    )
                    feed_stream = traced_iterator(feed, trace) if tracing and scan_chunk else feed
                    try:
                        for (kind, payload), placed in feed_stream:
                            if epoch_needs_mark:
                                telemetry.mark()
                                epoch_needs_mark = False
                            steps_before = n_steps
                            if kind == "step":
                                # a health-cadence or tail step through the
                                # per-step program; device scalars: the epoch
                                # sums add on the device
                                open_profile(1)
                                state, loss_value = self.traced_train_step(state, payload)
                                step_metrics = self.last_step_metrics
                                account_step(
                                    payload, loss_value, step_metrics["good"], step_metrics["grad_norm"], epoch,
                                    health_record=step_metrics.get("health"),
                                )
                                last_batch = payload
                            else:  # K optimizer steps in one replay
                                k = len(payload)
                                if placed is None:  # device_feed=False: placed on this thread
                                    with self._h2d_span():
                                        placed = self._place_chunk(self._stack_chunk(payload))
                                if profile_steps is not None and not profile_active and self.device.type == "cuda":
                                    # a window opening at this chunk finds its
                                    # graph captured, the warm-up traced
                                    self._prepare(state)
                                    self._chunk_graph_for(state, placed, k)
                                open_profile(k)
                                first_step = state.step
                                compile_before = self.compile_tracker.total_compile_seconds
                                with span("train_step", steps=k) as step_span:
                                    # the [K] losses come to the host: the span is fenced
                                    state, losses = self._run_chunk(state, placed, k)
                                if tracing:
                                    compile_delta = self.compile_tracker.total_compile_seconds - compile_before
                                    if compile_delta > 0:
                                        trace.carve(step_span, "compile", compile_delta)
                                memory.observe()  # the chunk-boundary memory sample
                                goods = self.last_step_metrics["good"].cpu().numpy()
                                grad_norms = self.last_step_metrics["grad_norm"].cpu().numpy()
                                bad_in_chunk = np.cumsum(~goods)
                                bad_before = None
                                if (check_anomalies or recovery is not None) and bad_in_chunk[-1]:
                                    bad_before = int(state.bad_steps) - int(bad_in_chunk[-1])
                                for i in range(k):
                                    rolled_back = account_step(
                                        payload[i], losses[i], goods[i], grad_norms[i], epoch,
                                        step_id=first_step + i + 1,
                                        bad_total=bad_before + int(bad_in_chunk[i]) if bad_before is not None else None,
                                    )
                                    if rolled_back:
                                        # the rest of the chunk belongs to the
                                        # discarded trajectory: consumed, not accounted
                                        n_steps += k - (i + 1)
                                        measured_total += k - (i + 1)
                                        break
                                last_batch = payload[-1]
                            boundary_saved = False
                            if (
                                checkpoint_every
                                and checkpoint_manager is not None
                                and n_steps // checkpoint_every > steps_before // checkpoint_every
                            ):
                                # a boundary crossed inside a chunk saves at its end
                                save_mid_epoch()
                                boundary_saved = True
                            if preempted_exit(epoch, boundary_saved):
                                return state
                    finally:
                        if isinstance(feed, DevicePrefetcher):
                            feed.close()
                finally:
                    if prefetch:
                        source.close()  # joins the prefetch thread, also when a step raised
                good_count = int(epoch_good) if epoch_good is not None else 0
                record = {
                    "epoch": epoch,
                    "train_loss": float(epoch_loss) / good_count if good_count else float("nan"),
                }
                if event_every and measured_total > last_emitted_at and last_batch is not None:
                    telemetry_tick(last_batch)  # the epoch's tail steps, before validation
                if val_batches is not None and state is not None:
                    streams = val_batches if isinstance(val_batches, dict) else {"": val_batches}
                    with span("validation"):
                        for stream_name, factory in streams.items():
                            stream_metrics = self.validate(
                                state, factory(), metrics=metrics, top_k=top_k, item_count=item_count,
                                postprocessors=postprocessors,
                            )
                            prefix = f"{stream_name}/" if stream_name else ""
                            record.update({f"{prefix}{k}": v for k, v in stream_metrics.items()})
                    emit("on_validation_end", step=state.step, epoch=epoch, record=record)
                self.history.append(record)
                epoch_payload: Dict[str, Any] = {"record": record}
                if state is not None:
                    epoch_payload["bad_steps"] = int(state.bad_steps)
                if last_grad_norm is not None:
                    epoch_payload["grad_norm"] = float(last_grad_norm)
                input_record = input_summary()
                if input_record is not None:
                    epoch_payload["input"] = input_record
                if health_cfg is not None and self.last_health is not None:
                    epoch_payload["health"] = self.last_health
                if tracing:
                    # phase fractions over this epoch's wall clock, summing to 1
                    epoch_payload["goodput"] = trace_window(epoch_trace_base, epoch_trace_t0)
                    # what follows (this epoch's checkpoint) bills to the next epoch
                    epoch_trace_base = trace.snapshot(only_current_thread=True)
                    epoch_trace_t0 = time.perf_counter()
                emit("on_epoch_end", step=state.step if state is not None else None, epoch=epoch, **epoch_payload)
                if not log_every:
                    logger.info("epoch %d: %s", epoch, record)

                if recovery is not None and monitor is not None and monitor in record and epoch_good is not None:
                    # epoch-level blowup guard: roll back before this epoch's
                    # checkpoint could become the rollback target
                    value = float(record[monitor])
                    blown = not math.isfinite(value)
                    if (
                        not blown
                        and recovery.blowup_factor is not None
                        and best_value is not None
                        and math.isfinite(best_value)
                    ):
                        blown = (
                            value > best_value * recovery.blowup_factor
                            if mode == "min"
                            else value < best_value / recovery.blowup_factor
                        )
                    if blown:
                        state = do_recovery("metric_blowup", epoch)
                        continue

                improved = False
                if monitor is not None:
                    if monitor not in record:
                        msg = f"monitor '{monitor}' not in the epoch record {sorted(record)}"
                        raise KeyError(msg)
                    value = record[monitor]
                    improved = (
                        best_value is None
                        or (mode == "max" and value > best_value)
                        or (mode == "min" and value < best_value)
                    )
                    if improved:
                        # a copy: the next step writes into the live state
                        best_state = _clone_state(state)
                        best_value, stale_epochs = value, 0
                    else:
                        stale_epochs += 1
                if checkpoint_manager is not None and state is not None:
                    metadata = {"epoch": epoch}
                    if self._lr_scale != 1.0:  # recovery backoff survives resume
                        metadata["lr_scale"] = self._lr_scale
                    if monitor:
                        metadata.update({"best": improved, monitor: value})
                    with span("checkpoint"):
                        checkpoint_manager.save(state.step, state, history=self.history, metadata=metadata)
                        if improved:
                            checkpoint_manager.mark_best(state.step)
                    emit("on_checkpoint", step=state.step, epoch=epoch, mid_epoch=False,
                         best=bool(improved) if monitor else None)
                if monitor is not None and patience is not None and stale_epochs >= patience:
                    logger.info("early stop: no %s improvement for %d epochs", monitor, patience)
                    stopped_early = True
                    break
        if state is None:
            msg = "fit() received no batches"
            raise ValueError(msg)
        if best_state is None and resumed_best_step is not None and monitor is not None:
            # no epoch after the resume beat the earlier best: return that
            # state, as the uninterrupted run would have
            best_state = checkpoint_manager.restore(state, step=resumed_best_step)
        emit("on_fit_end", step=state.step, stopped_early=stopped_early, **fit_end_payload())
        if best_state is not None:
            self._bind(best_state)
            return best_state
        return state

    # the public entry is the exception-safe wrapper above; its help() reads as the real thing
    fit.__doc__ = _fit_impl.__doc__

    # -- learning-rate backoff and checkpoints ------------------------------ #
    def _set_lr_scale(self, scale: float) -> None:
        """Rebuild the optimizer with the base learning rate scaled by
        ``scale`` (RecoveryPolicy backoff). The optimizer state's layout is
        the same for any rate, so a restored ``opt_state`` keeps working; the
        captured chunk graphs baked the old rate in and are dropped."""
        self._lr_scale = float(scale)
        factory = dataclasses.replace(self.optimizer, learning_rate=self.optimizer.learning_rate * self._lr_scale)
        self._tx = factory.create()
        self._chunk_graphs.clear()
        self._builds += 1  # the step programs are new: their next calls build anew

    def save_checkpoint(self, path: str, state: TrainState, backend: Optional[str] = None) -> None:
        """Write the whole state (params, optimizer state, ``bad_steps``,
        the dropout generator's state) to ``path`` (``.npz`` + ``.json``)."""
        from replay_tpu_torch.utils.checkpoint import save_pytree

        save_pytree(path, state, {"step": state.step, **self._layout_metadata()}, backend=backend)

    def restore_checkpoint(self, path: str, example_batch: Batch) -> TrainState:
        """Rebuild a state from disk into a fresh ``init_state``'s template."""
        from replay_tpu_torch.utils.checkpoint import load_metadata, restore_pytree

        self._check_layout(load_metadata(path), path)
        state = restore_pytree(path, self.init_state(example_batch))
        self._bind(state)
        return state

    def _layout_metadata(self) -> Dict[str, Any]:
        """A checkpoint's mark of the scanned encoder layout (flax's
        ``nn.scan`` tree, ``[N, ...]`` leaves under ``blocks``), which the
        flat parameter buffer cannot show: the loop layout holds as many
        values in another order. Nothing for the loop layout, whose metadata
        stays the JAX trainer's."""
        scanned = any(getattr(module, "scan_blocks", False) for module in self.model.modules())
        return {"scan_blocks": True} if scanned else {}

    def _check_layout(self, metadata: Mapping[str, Any], where: str) -> None:
        """Refuse a checkpoint of the other encoder layout, as the JAX
        restore refuses the other param tree."""
        saved, current = bool(metadata.get("scan_blocks")), bool(self._layout_metadata())
        if saved != current:
            layouts = {True: "scan_blocks=True (stacked [N, ...] blocks)", False: "the loop layout (block_<i>)"}
            msg = (
                f"checkpoint {where} holds {layouts[saved]} but the model has {layouts[current]}: "
                "checkpoints do not mix across scan_blocks"
            )
            raise ValueError(msg)

    # -- eval / predict ---------------------------------------------------- #
    def _eval_program(self, key: Tuple[Any, ...]) -> Callable[..., Any]:
        """The evaluation program of ``key = (kind, layout, shapes)``, bound
        to the model (``nn/compiled.py::bind``): ``"logits"`` is
        ``forward_inference`` (JAX's ``eval_logits``), ``"items"`` the
        catalog's ``encode_items``, ``"queries"`` ``get_query_embeddings``.
        ``layout`` rebuilds the model's keyword arguments from the flat inputs."""
        kind, layout = key[0], key[1]

        def run(model, *inputs):
            kwargs = _nested(layout, inputs)
            if kind == "logits":
                return model.forward_inference(**kwargs)
            if kind == "items":
                return model.encode_items(**kwargs)
            return model.get_query_embeddings(**kwargs)

        return bind(self.model, run)

    def _evaluate(self, kind: str, params: Mapping[str, torch.Tensor], kwargs: Mapping[str, Any]):
        """Run ``kind``'s program on ``kwargs`` (tensors on the trainer's
        device, one level of nested dicts) with ``params``: a graph replay on
        the card (after a capture, for a new shape), the program on the CPU."""
        layout, inputs = _flat(kwargs)
        return self._eval_runner((kind, layout, signature(inputs)), params, inputs)

    def _eval_params(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """A new mapping of ``state``'s parameters: the graphs copy it into
        their static parameters at its first replay (a mapping is installed by
        identity), once per evaluation call."""
        self._bind(state)
        return dict(self.model.named_parameters())

    def _logits(self, params: Mapping[str, torch.Tensor], batch: Batch, candidates: Optional[torch.Tensor]):
        self._refuse_dropped_segments(batch, self._inference_params, "forward_inference")
        kwargs = {name: batch[name] for name in self._inference_params if name in batch and name != "candidates_to_score"}
        return self._evaluate("logits", params, {**kwargs, "candidates_to_score": candidates})

    def predict_logits(
        self, state: TrainState, batch: Batch, candidates: Optional[Any] = None
    ) -> torch.Tensor:
        """Next-item logits [B, num_items] (or [B, K] for candidates)."""
        params = self._eval_params(state)
        batch = to_device(batch, self.device)
        if candidates is not None:
            candidates = to_device(candidates, self.device)
        return self._logits(params, batch, candidates)

    # -- vocabulary ------------------------------------------------------- #
    def resize_vocabulary(
        self, state: TrainState, new_cardinality: int, init_tensor=None, carry_opt_state: bool = True,
        init: str = "mean", rng: Optional[torch.Generator] = None,
    ) -> TrainState:
        """Catalog growth between or during fits: item-table surgery with the
        optimizer moments resized in lockstep (:mod:`replay_tpu_torch.nn.vocabulary`).

        ``carry_opt_state=True`` (the continual-training path) keeps every
        trained row's moments and starts the cold rows' at zero; ``False``
        starts a fresh optimizer state. ``init`` picks the cold rows when no
        ``init_tensor`` is given: ``"mean"`` (the reference default) or
        ``"xavier"`` (``set_item_embeddings_by_size``, drawn from ``rng``, a
        CPU ``torch.Generator``). Step, ``rng`` and ``bad_steps`` carry over.

        The state returned holds new tensors (``state`` is spent, as after a
        step) and the model is bound to it: its item embedding modules are
        rebuilt at the new size, and every captured program of the old shapes
        (the chunk graphs, the evaluation graphs) is dropped, so none of them
        replays again."""
        from replay_tpu_torch.nn.embedding import fit_tables
        from replay_tpu_torch.nn.vocabulary import resize_item_embeddings, set_item_embeddings_by_size

        schema = self.model.schema
        self._bind(state)
        params = dict(state.params)
        opt_state = state.opt_state if carry_opt_state else None
        if init == "xavier" and init_tensor is None:
            result = set_item_embeddings_by_size(params, schema, new_cardinality, rng=rng, opt_state=opt_state)
        elif init == "mean" or init_tensor is not None:
            result = resize_item_embeddings(params, schema, new_cardinality, init_tensor, opt_state=opt_state)
        else:
            msg = f"unknown init {init!r}: use 'mean' or 'xavier'"
            raise ValueError(msg)
        params, opt_state = result if carry_opt_state else (result, None)
        # the embedding modules whose table changed size get a table of the new
        # size, which _bind below makes a view of the new flat buffer
        fit_tables(self.model, params)
        with torch.no_grad():
            flat = torch.cat([params[name].detach().reshape(-1) for name, _ in self.model.named_parameters()])
        flat = flat.to(self.device, state.flat_params.dtype)
        grown = TrainState(
            step=state.step,
            flat_params=flat,
            params={},
            opt_state=opt_state if opt_state is not None else self._tx.init(flat),
            bad_steps=state.bad_steps.clone(),
            rng=state.rng.clone(),
        )
        # every program captured for the old shapes goes: the chunk graphs, and
        # the evaluation graphs, keyed by their inputs, which a resize leaves as
        # they were (a replay would read the old table's static copy)
        self._chunk_graphs.clear()
        self._graph_kernels.clear()
        self._programs.clear()
        if hasattr(self._eval_runner, "close"):
            self._eval_runner.close()
        self._builds += 1
        self._bind(grown)
        return grown

    def finetune(
        self, state: TrainState, train_batches, new_cardinality: Optional[int] = None, init: str = "xavier",
        epochs: int = 1, **fit_kwargs,
    ) -> TrainState:
        """The continual-training entry: optionally grow the catalog (moments
        carried, ``init`` cold rows: xavier by default), then ``fit`` from the
        given trained state on the fresh interaction tail. A shrink raises."""
        schema = self.model.schema
        feature_name = schema.item_id_feature_name
        if new_cardinality is not None and feature_name is not None:
            if new_cardinality < schema[feature_name].cardinality:
                msg = (
                    f"finetune cannot shrink the catalog "
                    f"({schema[feature_name].cardinality} -> {new_cardinality})"
                )
                raise ValueError(msg)
            if new_cardinality > schema[feature_name].cardinality:
                state = self.resize_vocabulary(state, new_cardinality, carry_opt_state=True, init=init)
        return self.fit(train_batches, epochs=epochs, state=state, **fit_kwargs)

    # -- eval-time catalog cache (item towers) ------------------------------ #
    def _precompute_catalog(self, params: Mapping[str, torch.Tensor], batch: Batch) -> Optional[torch.Tensor]:
        """The catalog through the model's item tower, ``[num_items, E]``,
        encoded once per evaluation pass (``None`` for models without
        ``encode_items``): each validate / predict_top_k call encodes it anew
        with the state's current weights."""
        if not hasattr(type(self.model), "encode_items"):
            return None
        features = batch.get("item_feature_tensors")
        features = None if features is None else to_device(features, self.device)
        return self._evaluate("items", params, {"item_feature_tensors": features})

    def _query_embeddings(self, params: Mapping[str, torch.Tensor], batch: Batch) -> torch.Tensor:
        """The ``"queries"`` program (``get_query_embeddings``) on a batch on
        the trainer's device."""
        self._refuse_dropped_segments(batch, (), "get_query_embeddings")
        return self._evaluate(
            "queries", params,
            {"feature_tensors": batch[self.feature_field], "padding_mask": batch[self.padding_mask_field]},
        )

    def _catalog_logits(self, params: Mapping[str, torch.Tensor], batch: Batch, catalog: torch.Tensor) -> torch.Tensor:
        """Query embeddings scored against the precomputed catalog (the
        product outside the program, as in the JAX trainer)."""
        queries = self._query_embeddings(params, batch)
        with torch.no_grad():
            return queries @ catalog.T

    def _scored(self, state: TrainState, batches: Iterable[Batch], candidates: Optional[Any] = None):
        """Each batch (on the trainer's device) with its next-item logits:
        against the catalog encoded once for the whole pass where the model
        has an item tower and no candidates are given, else the logits
        program. The state's parameters are copied to the programs once."""
        iterator = iter(batches)
        first = next(iterator, None)
        if first is None:
            return
        params = self._eval_params(state)
        if candidates is not None:
            candidates = to_device(candidates, self.device)
        catalog = self._precompute_catalog(params, first) if candidates is None else None
        for batch in itertools.chain([first], iterator):
            batch = to_device(batch, self.device)
            if catalog is not None:
                yield batch, self._catalog_logits(params, batch, catalog)
            else:
                yield batch, self._logits(params, batch, candidates)

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
        builder = MetricsBuilder(metrics=metrics, top_k=top_k, item_count=item_count, programs=self._metric_runner)
        for batch, logits in self._scored(state, batches):
            for post in postprocessors:
                logits = post(logits, batch)
            _, top_ids = _top_k(logits, builder.max_k)
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
            if candidates is not None:
                # visible to postprocessors (SeenItemsFilter's candidate matching)
                batch = {**batch, "candidates_to_score": to_device(candidates, self.device)}
            for post in postprocessors:
                logits = post(logits, batch)
            scores, top_idx = _top_k(logits, k)
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

    def predict_dataframe(self, state: TrainState, batches: Iterable[Batch], k: int, **kwargs) -> ColumnTable:
        """:meth:`predict_top_k` as a tidy ``query_id``, ``item_id``,
        ``rating`` table (the PandasTopItemsCallback equivalent): each query
        repeated ``k`` times, its items best first. A :class:`ColumnTable`
        where the JAX trainer returns a pandas frame."""
        queries, items, scores = self.predict_top_k(state, batches, k, **kwargs)
        return ColumnTable(
            {"query_id": np.repeat(queries, k), "item_id": items.reshape(-1), "rating": scores.reshape(-1)}
        )

    def predict_query_embeddings(self, state: TrainState, batches: Iterable[Batch]):
        """Last-position query embeddings [N, E] (the reference
        QueryEmbeddingsPredictionCallback), e.g. for two-stage features: the
        ``"queries"`` program (``get_query_embeddings``; a CUDA graph per
        input shape on the card), the ``valid`` rows kept. Returns
        ``(query_ids, embeddings)``, the ids ``arange(N)`` where the batches
        carry no ``query_id``."""
        chunks, queries = [], []
        params = None
        for batch in batches:
            params = self._eval_params(state) if params is None else params
            batch = to_device(batch, self.device)
            embeddings = self._query_embeddings(params, batch).cpu().numpy()
            valid = batch["valid"].cpu().numpy() if "valid" in batch else np.ones(embeddings.shape[0], bool)
            chunks.append(embeddings[valid])
            if "query_id" in batch:
                queries.append(batch["query_id"].cpu().numpy()[valid])
        embeddings = np.concatenate(chunks) if chunks else np.zeros((0, 0))
        query_ids = np.concatenate(queries) if queries else np.arange(len(embeddings))
        return query_ids, embeddings
