"""Model-health diagnostics: layer-wise norms, update ratios, activation
stats, attention entropy, and an early-warning watcher.

Counterpart of ``replay_tpu/obs/health.py``. The JAX step computes the health
record inside its jitted program, reading the stage stats and attention
entropies that the model bodies ``sow`` into flax's ``intermediates``
collection when the step makes it mutable. The port makes that collection an
explicit capture: :func:`capture_intermediates` opens it for one step (the
trainer opens it only for a health step), the model bodies call
:func:`sow_stage_stats` and :func:`sow` under :func:`sow_scope` names, and
without an open capture each of them returns at once, so a step without
health runs exactly the ops it ran before.

* per-parameter-group gradient / parameter / update norms and the
  update-to-param ratio, groups from the parameter names (``embeddings`` /
  ``block_<i>`` / ``head``: the port keeps flax's names, so the groups are
  the JAX groups);
* activation RMS + absmax per named stage and per-head attention entropy
  (on the unfused attention route only: kernels K4 and K5 never build the
  weights, as in JAX);
* logits stats of the last position, from the full ``[B, I]`` logits or, for
  losses that never build them (``CEFused``), streamed over catalog blocks
  (:func:`streamed_logits_stats`), and the fraction of embedding rows this
  batch's gradients touched.

Everything stays on the device until ``Trainer.fit`` fetches the record
every ``cadence`` steps. :class:`HealthWatcher` turns the fetched stream into
an early warning, as in JAX.
"""

from __future__ import annotations

import contextlib
import math
import re
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import torch

__all__ = [
    "HealthConfig",
    "HealthWatcher",
    "capture_intermediates",
    "capturing",
    "flatten_health",
    "health_metrics",
    "param_group_key",
    "sow",
    "sow_scope",
    "sow_stage_stats",
    "streamed_logits_stats",
]

_BLOCK_RE = re.compile(r"(block_\d+)")
_EPS = 1e-12


# --------------------------------------------------------------------------- #
# configuration
# --------------------------------------------------------------------------- #
@dataclass(frozen=True)
class HealthConfig:
    """What the health-enabled train step computes and how often it is fetched.

    ``cadence`` is the host fetch/emit period in steps. ``groups`` controls
    the per-group norm/ratio block; ``activation_stats`` the sowed per-stage
    RMS/absmax; ``attention_entropy`` the per-head entropies; ``logits_stats``
    the last-position scoring-head stats; ``embedding_coverage`` the fraction
    of embedding rows with non-zero gradient this batch. ``watcher`` attaches
    an early-warning :class:`HealthWatcher` evaluated at every fetch.
    """

    cadence: int = 10
    groups: bool = True
    activation_stats: bool = True
    attention_entropy: bool = True
    logits_stats: bool = True
    embedding_coverage: bool = True
    watcher: Optional["HealthWatcher"] = None

    def __post_init__(self) -> None:
        if self.cadence < 1:
            msg = "cadence must be >= 1 (steps between host fetches)"
            raise ValueError(msg)

    @property
    def capture_intermediates(self) -> bool:
        """Whether the train step must run the forward under a capture."""
        return self.activation_stats or self.attention_entropy


# --------------------------------------------------------------------------- #
# early warning (host-side; copied from the JAX module)
# --------------------------------------------------------------------------- #
@dataclass
class HealthWatcher:
    """EWMA blowup detector over the health stream (host-side, O(1) state).

    Tracks an exponentially-weighted moving average of the global gradient
    norm and the max per-group update ratio; a finite observation exceeding
    ``blowup_factor`` × its EWMA (after ``warmup`` clean observations) is a
    warning, fired through ``on_health_warning`` before loss/grads go
    non-finite. Warned values are not folded into the EWMA, and :meth:`reset`
    clears the state after a RecoveryPolicy rollback.

    ``trigger_recovery=True`` asks ``fit`` to treat a warning like a sentinel
    trigger: the RecoveryPolicy (when attached) rolls back immediately.
    """

    alpha: float = 0.3
    blowup_factor: float = 5.0
    warmup: int = 3
    trigger_recovery: bool = False
    _ewma: Dict[str, float] = field(default_factory=dict, repr=False)
    _seen: int = field(default=0, repr=False)

    def __post_init__(self) -> None:
        if not 0.0 < self.alpha <= 1.0:
            msg = "alpha must be in (0, 1]"
            raise ValueError(msg)
        if self.blowup_factor <= 1.0:
            msg = "blowup_factor must be > 1"
            raise ValueError(msg)
        if self.warmup < 1:
            msg = "warmup must be >= 1"
            raise ValueError(msg)

    @staticmethod
    def _signals(record: Mapping[str, Any]) -> Dict[str, float]:
        signals: Dict[str, float] = {}
        # "grad_norm" proper is the per-GROUP dict; the global norm rides the
        # health record as grad_norm_global (the trainer reuses the sentinel's)
        value = record.get("grad_norm_global", record.get("grad_norm"))
        if isinstance(value, (int, float)) and not isinstance(value, bool):
            signals["grad_norm"] = float(value)
        ratios = record.get("update_ratio")
        if isinstance(ratios, Mapping):
            finite = [
                float(v)
                for v in ratios.values()
                if isinstance(v, (int, float)) and math.isfinite(float(v))
            ]
            if finite:
                signals["update_ratio_max"] = max(finite)
        return signals

    def observe(self, record: Mapping[str, Any]) -> Optional[Dict[str, Any]]:
        """Fold one fetched health record in; a blowup returns the warning
        payload (signal, value, ewma, factor), a clean record returns None.
        Non-finite values are ignored: the sentinel owns those."""
        warning: Optional[Dict[str, Any]] = None
        signals = self._signals(record)
        clean = True
        for name, value in signals.items():
            if not math.isfinite(value):
                continue
            baseline = self._ewma.get(name)
            blown = (
                baseline is not None
                and self._seen >= self.warmup
                and baseline > 0.0
                and value > self.blowup_factor * baseline
            )
            if blown:
                clean = False
                if warning is None:
                    warning = {
                        "signal": name,
                        "value": value,
                        "ewma": baseline,
                        "factor": value / baseline,
                        "blowup_factor": self.blowup_factor,
                    }
                continue  # a blowing-up value must not become the baseline
            self._ewma[name] = (
                value if baseline is None else self.alpha * value + (1 - self.alpha) * baseline
            )
        if signals and clean:
            self._seen += 1
        return warning

    def reset(self) -> None:
        """Forget the baseline (call after a rollback)."""
        self._ewma.clear()
        self._seen = 0


# --------------------------------------------------------------------------- #
# the capture: flax's `intermediates` collection, made explicit
# --------------------------------------------------------------------------- #
_LOCAL = threading.local()
_NULL = contextlib.nullcontext()


class _Capture:
    def __init__(self) -> None:
        self.values: Dict[str, List[torch.Tensor]] = {}
        self.path: List[str] = []


def _current() -> Optional[_Capture]:
    return getattr(_LOCAL, "capture", None)


def capturing() -> bool:
    """Whether a capture is open on this thread (a health step's forward)."""
    return _current() is not None


@contextlib.contextmanager
def capture_intermediates() -> Iterator[Dict[str, List[torch.Tensor]]]:
    """Open the capture for the enclosed forward; yields ``{path: [values]}``,
    which every :func:`sow` inside writes into (one entry per call, as flax's
    ``sow`` appends: BERT4Rec's repeated passes give several)."""
    previous = _current()
    _LOCAL.capture = _Capture()
    try:
        yield _LOCAL.capture.values
    finally:
        _LOCAL.capture = previous


def sow_scope(name: str):
    """A path segment for the sows inside (a block's name); a shared no-op
    context when no capture is open."""
    capture = _current()
    if capture is None:
        return _NULL
    return _scoped(capture, name)


@contextlib.contextmanager
def _scoped(capture: _Capture, name: str):
    capture.path.append(name)
    try:
        yield
    finally:
        capture.path.pop()


def sow(name: str, value: torch.Tensor) -> None:
    """Append ``value`` under ``<scope path>/name``; a no-op without a capture."""
    capture = _current()
    if capture is None:
        return
    capture.values.setdefault("/".join([*capture.path, name]), []).append(value)


def sow_stage_stats(module: Any, name: str, x: torch.Tensor) -> None:
    """Sow ``<name>_rms`` / ``<name>_absmax`` scalars for one named stage.

    A no-op unless a capture is open (the health step); ``module`` is the
    JAX signature's and unused here."""
    if not capturing():
        return
    with torch.no_grad():
        x32 = x.detach().to(torch.float32)
        sow(f"{name}_rms", torch.sqrt(torch.mean(x32 * x32)))
        sow(f"{name}_absmax", torch.max(torch.abs(x32)))


def attention_entropy(weights: torch.Tensor, padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-head mean attention entropy ``[H]`` of ``[B, H, L, L]`` weights,
    over the valid query rows only (padded rows are one-hot and would drag
    the signal toward collapse), as the JAX attention module computes it."""
    with torch.no_grad():
        w32 = weights.detach().to(torch.float32)
        entropy = -torch.sum(w32 * torch.log(w32 + 1e-9), dim=-1)  # [B, H, L]
        if padding_mask is None:
            return torch.mean(entropy, dim=(0, 2))
        valid = padding_mask.to(w32.dtype)
        return torch.sum(entropy * valid[:, None, :], dim=(0, 2)) / torch.clamp(torch.sum(valid), min=1.0)


# --------------------------------------------------------------------------- #
# the health record (device tensors; computed by the trainer's health step)
# --------------------------------------------------------------------------- #
def param_group_key(path_str: str) -> str:
    """Parameter-group key for one parameter path: ``block_<i>`` for encoder
    blocks, ``embeddings`` for any embedding table (feature/positional/mask),
    ``head`` for everything else (norms, aggregator projections, towers)."""
    match = _BLOCK_RE.search(path_str)
    if match:
        return match.group(1)
    if "embed" in path_str.lower():
        return "embeddings"
    return "head"


def _flatten(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    if isinstance(tree, Mapping):
        for key, value in tree.items():
            yield from _flatten(value, f"{prefix}.{key}" if prefix else str(key))
    else:
        yield prefix, tree


def _grouped_leaves(tree: Any) -> Dict[str, List[Tuple[str, torch.Tensor]]]:
    groups: Dict[str, List[Tuple[str, torch.Tensor]]] = {}
    for path, leaf in _flatten(tree):
        groups.setdefault(param_group_key(path), []).append((path, leaf))
    return groups


def _group_norm(leaves: List[Tuple[str, torch.Tensor]]) -> torch.Tensor:
    total = sum(torch.sum(torch.square(leaf.to(torch.float32))) for _, leaf in leaves)
    return torch.sqrt(total)


def _iter_sowed(tree: Any, prefix: str = ""):
    """(path, values) pairs of a capture (``{path: [values]}``) or of a
    nested mapping of flax's form (a tuple of values per site)."""
    if isinstance(tree, Mapping):
        for key, value in tree.items():
            yield from _iter_sowed(value, f"{prefix}/{key}" if prefix else str(key))
    else:
        values = list(tree) if isinstance(tree, (tuple, list)) else [tree]
        yield prefix, values


def _mean_of(values: List[torch.Tensor]) -> torch.Tensor:
    if len(values) == 1:
        return values[0]
    return torch.mean(torch.stack(values), dim=0)


@torch.no_grad()
def health_metrics(
    config: HealthConfig,
    params: Any,
    grads: Any,
    updates: Any,
    intermediates: Optional[Mapping[str, Any]] = None,
    logits: Optional[torch.Tensor] = None,
) -> Dict[str, Any]:
    """The ``health`` record of one train step, as device tensors.

    ``params``/``grads``/``updates`` map parameter names (the port's dotted
    names, or nested mappings) to the step's pre-update parameters, raw
    gradients and optimizer-produced updates; ``intermediates`` is a capture
    (:func:`capture_intermediates`); ``logits`` an optional logits tensor for
    the logits-stats block.
    """
    health: Dict[str, Any] = {}
    param_groups = _grouped_leaves(params)
    if config.groups:
        grad_groups = _grouped_leaves(grads)
        update_groups = _grouped_leaves(updates)
        health["grad_norm"] = {g: _group_norm(leaves) for g, leaves in grad_groups.items()}
        health["param_norm"] = {g: _group_norm(leaves) for g, leaves in param_groups.items()}
        health["update_norm"] = {g: _group_norm(leaves) for g, leaves in update_groups.items()}
        health["update_ratio"] = {
            g: health["update_norm"][g] / (health["param_norm"][g] + _EPS)
            for g in health["update_norm"]
            if g in health["param_norm"]
        }
    if config.embedding_coverage:
        # feature vocabulary tables only ("embedding_<feature>"): positional
        # and mask tables are touched every batch
        def is_vocab_table(path_str: str, leaf) -> bool:
            return "embedding_" in path_str and getattr(leaf, "ndim", 0) == 2

        tables = [leaf for path, leaf in param_groups.get("embeddings", []) if is_vocab_table(path, leaf)]
        grad_tables = [
            leaf for path, leaf in _grouped_leaves(grads).get("embeddings", []) if is_vocab_table(path, leaf)
        ]
        if grad_tables:
            touched = sum(torch.sum(torch.any(g != 0, dim=tuple(range(1, g.ndim)))) for g in grad_tables)
            total_rows = sum(t.shape[0] for t in tables) or 1
            health["embedding_coverage"] = touched.to(torch.float32) / float(total_rows)
    if intermediates is not None and (config.activation_stats or config.attention_entropy):
        activations: Dict[str, Dict[str, Any]] = {}
        entropies: Dict[str, Any] = {}
        for path, values in _iter_sowed(intermediates):
            leaf_name = path.rsplit("/", 1)[-1]
            if config.attention_entropy and leaf_name == "attention_entropy":
                match = _BLOCK_RE.search(path)
                entropies[match.group(1) if match else path] = _mean_of(values)
            elif config.activation_stats and leaf_name.endswith(("_rms", "_absmax")):
                stage, _, stat = leaf_name.rpartition("_")
                activations.setdefault(stage, {})[stat] = _mean_of(values)
        if activations:
            health["activations"] = activations
        if entropies:
            health["attention_entropy"] = entropies  # {block: [H] nats}
            health["attention_entropy_mean"] = torch.mean(
                torch.cat([torch.ravel(e) for e in entropies.values()])
            )
    if config.logits_stats and logits is not None:
        logits32 = logits.to(torch.float32)
        health["logits"] = {
            "mean": torch.mean(logits32),
            "absmax": torch.max(torch.abs(logits32)),
            "std": torch.std(logits32, correction=0),
        }
    return health


@torch.no_grad()
def streamed_logits_stats(hidden: torch.Tensor, table: torch.Tensor, chunk: int = 4096) -> Dict[str, torch.Tensor]:
    """Last-position logits stats without building ``[B, num_items]``.

    The losses that avoid the full logits (``CEFused``) must not see the
    health collector build them either: this sweeps the catalog in
    ``[B, chunk]`` blocks (one cuBLAS product a block), accumulating sum,
    sum of squares and absmax — the same ``mean``/``std``/``absmax`` as the
    full-logits block up to f32 reassociation across blocks. Gradient-free.
    """
    hidden = hidden.detach().to(torch.float32)  # [B, E]
    table = table.detach().to(torch.float32)  # [I, E]
    num_items = table.shape[0]
    chunk = max(1, min(int(chunk), num_items))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    sumsq = torch.zeros_like(total)
    absmax = torch.zeros_like(total)
    for start in range(0, num_items, chunk):
        logits = hidden @ table[start : start + chunk].T  # [B, <= chunk]
        total = total + torch.sum(logits)
        sumsq = sumsq + torch.sum(logits * logits)
        absmax = torch.maximum(absmax, torch.max(torch.abs(logits)))
    count = float(hidden.shape[0] * num_items)
    mean = total / count
    variance = torch.clamp(sumsq / count - mean * mean, min=0.0)
    return {"mean": mean, "absmax": absmax, "std": torch.sqrt(variance)}


# --------------------------------------------------------------------------- #
# host-side helpers
# --------------------------------------------------------------------------- #
def to_host(record: Any) -> Any:
    """A fetched health record: tensors become python floats (scalars) or
    lists (vectors), as the JAX fit's ``tree.map(tolist | float)``."""
    if isinstance(record, Mapping):
        return {key: to_host(value) for key, value in record.items()}
    if isinstance(record, torch.Tensor):
        return record.tolist() if record.dim() else float(record)
    return record


def flatten_health(record: Mapping[str, Any], prefix: str = "health") -> Dict[str, Any]:
    """Flatten a fetched health record to ``{tag: scalar-or-vector}``."""
    flat: Dict[str, Any] = {}

    def walk(node: Any, tag: str) -> None:
        if isinstance(node, Mapping):
            for key, value in node.items():
                walk(value, f"{tag}/{key}")
        else:
            flat[tag] = node

    walk(record, prefix)
    return flat
