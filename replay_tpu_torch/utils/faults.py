"""Deterministic fault injection for training and serving (docs/robustness.md).

Counterpart of ``replay_tpu/utils/faults.py``: the failure modes
``Trainer.fit`` and the scoring service must survive, injected through one
small harness so every recovery path runs reproducibly:

* :class:`NaNInjector` poisons chosen batches of a stream (the non-finite
  sentinel and the ``RecoveryPolicy`` rollback);
* :class:`SignalAtStep` raises a real SIGTERM/SIGINT at a chosen batch index
  (:class:`~replay_tpu_torch.nn.train.PreemptionHandler`, through the OS);
* :class:`KillAtStep` SIGKILLs a process at a chosen batch index (no handler
  runs: recovery must come from the checkpoints' atomic writes);
* :func:`truncate_file` chops a checkpoint payload as a crash mid-write would
  (``CheckpointManager``'s integrity scan);
* :class:`EngineErrorAt` makes a wrapped callable (e.g.
  ``ScoringEngine.encode``) raise :class:`InjectedFault` at chosen call
  indices (the serve circuit breaker and future-failure paths);
* :class:`LatencySpike` delays a wrapped callable at chosen call indices
  (deadline enforcement, queue-bound shedding and the client-side
  ``score(timeout=...)`` abandonment drop).

Positions are 0-based global indices (batch indices for the stream
injectors, call indices for the callable injectors) counted across every
``wrap`` call of one injector, so a multi-epoch ``fit`` stream — or a
long-lived serve worker — hits the same absolute positions whatever the
epoch boundaries.
"""

from __future__ import annotations

import functools
import os
import signal
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Sequence

import numpy as np


class InjectedFault(RuntimeError):
    """A fault raised by the chaos harness — never by real engine code, so
    tests and the chaos bench can tell injected failures from organic ones."""


def inject_nan(batch: Dict[str, Any], fields: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """A copy of ``batch`` with every float leaf replaced by all-NaN.

    Integer/bool leaves (ids, masks, labels) pass through untouched — a "NaN
    batch" means the continuous features are poisoned, which drives the loss
    AND every gradient non-finite in one forward/backward. ``fields`` narrows
    the poisoning to the given top-level batch keys. Raises if nothing was
    poisoned: a silently-clean "fault" would make a recovery test vacuous.
    """

    poisoned = 0

    def poison(value):
        nonlocal poisoned
        if isinstance(value, dict):
            return {key: poison(item) for key, item in value.items()}
        if isinstance(value, (list, tuple)):
            return type(value)(poison(item) for item in value)
        array = np.asarray(value)
        if np.issubdtype(array.dtype, np.floating):
            poisoned += 1
            return np.full_like(array, np.nan)
        return value

    out = {
        key: (poison(value) if fields is None or key in fields else value)
        for key, value in batch.items()
    }
    if not poisoned:
        msg = (
            "inject_nan found no float leaves to poison "
            f"(fields={list(fields) if fields is not None else 'all'}); "
            "the batch must carry at least one float feature for a NaN fault"
        )
        raise ValueError(msg)
    return out


class NaNInjector:
    """Poison the batches at the given global stream positions.

    >>> injector = NaNInjector(at_steps=(2, 5))
    >>> # trainer.fit(lambda epoch: injector.wrap(make_batches(epoch)), ...)
    """

    def __init__(self, at_steps: Iterable[int], fields: Optional[Sequence[str]] = None) -> None:
        self.at_steps = frozenset(int(s) for s in at_steps)
        self.fields = fields
        self.position = 0  # global batch index across wrap() calls
        self.injected_at: list = []

    def wrap(self, batches: Iterable[Dict[str, Any]]) -> Iterator[Dict[str, Any]]:
        for batch in batches:
            if self.position in self.at_steps:
                self.injected_at.append(self.position)
                batch = inject_nan(batch, self.fields)
            self.position += 1
            yield batch


class SignalAtStep:
    """Raise a real OS signal just before yielding batch ``at_step``.

    The default SIGTERM models a preemption notice arriving while the trainer
    is fetching data; with ``fit``'s PreemptionHandler installed the flag is
    set immediately and honored at the next step boundary. Fires at most once
    per instance.
    """

    def __init__(self, at_step: int, sig: int = signal.SIGTERM) -> None:
        self.at_step = int(at_step)
        self.sig = sig
        self.position = 0  # global batch index across wrap() calls
        self.raised = False

    def wrap(self, batches: Iterable[Dict[str, Any]]) -> Iterator[Dict[str, Any]]:
        for batch in batches:
            if self.position == self.at_step and not self.raised:
                self.raised = True
                signal.raise_signal(self.sig)
            self.position += 1
            yield batch


class KillAtStep:
    """SIGKILL a process just before yielding batch ``at_step``.

    The uncatchable upgrade of :class:`SignalAtStep`: SIGKILL never reaches a
    handler, so a wrapped training stream dies mid-epoch exactly as a
    preempted/OOM-killed worker would — whatever survives is what the atomic
    checkpoint + cursor sidecar design actually guarantees. By default the
    injector kills ITS OWN process (a worker wraps its own stream); ``pid``
    retargets it at another process, and :meth:`fire` sends the kill
    immediately — a chaos harness uses it to SIGKILL another process:

    >>> # training worker: dies fetching global batch 4, no cleanup runs
    >>> # trainer.fit(lambda epoch: KillAtStep(4).wrap(batches(epoch)), ...)
    >>> # fleet chaos: hard-kill a replica server process
    >>> # KillAtStep(pid=server.pid).fire()
    """

    def __init__(
        self, at_step: int = 0, pid: Optional[int] = None, sig: int = signal.SIGKILL
    ) -> None:
        self.at_step = int(at_step)
        self.pid = pid
        self.sig = sig
        self.position = 0  # global batch index across wrap() calls
        self.fired = False

    def fire(self) -> None:
        """Send the kill now. Does not return when targeting ``os.getpid()``."""
        self.fired = True
        os.kill(self.pid if self.pid is not None else os.getpid(), self.sig)

    def wrap(self, batches: Iterable[Dict[str, Any]]) -> Iterator[Dict[str, Any]]:
        for batch in batches:
            if self.position == self.at_step and not self.fired:
                self.fire()
            self.position += 1
            yield batch


def truncate_file(path: str, keep_fraction: float = 0.5, keep_bytes: Optional[int] = None) -> int:
    """Truncate ``path`` in place — the on-disk state a crash mid-write leaves
    behind (for non-atomic writers) or a partially-synced copy. Returns the
    new size in bytes."""
    size = os.path.getsize(path)
    keep = int(size * keep_fraction) if keep_bytes is None else min(keep_bytes, size)
    with open(path, "r+b") as fh:
        fh.truncate(keep)
    return keep


class _CallIndexInjector:
    """Shared scaffolding for the callable injectors: one GLOBAL call-index
    counter across every ``wrap()`` target (the callable analog of the stream
    injectors' global batch indices), ``injected_at`` recording the calls that
    fired, and a :meth:`_fire` hook run BEFORE the wrapped call — raising from
    it suppresses the call entirely, returning lets it proceed."""

    def __init__(self, at_calls: Iterable[int]) -> None:
        self.at_calls = frozenset(int(c) for c in at_calls)
        self.position = 0  # global call index across wrap() targets
        self.injected_at: list = []

    def _fire(self, position: int) -> None:
        raise NotImplementedError

    def wrap(self, fn: Callable) -> Callable:
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            position = self.position
            self.position += 1
            if position in self.at_calls:
                self.injected_at.append(position)
                self._fire(position)
            return fn(*args, **kwargs)

        return wrapped


class EngineErrorAt(_CallIndexInjector):
    """Make a wrapped callable raise :class:`InjectedFault` at the given
    global call indices — the serve-side chaos injector.

    >>> injector = EngineErrorAt(at_calls=range(3))
    >>> # service.engine.encode = injector.wrap(service.engine.encode)
    >>> # the first 3 encodes now fail; consecutive failures trip the breaker

    The fault raises BEFORE the wrapped call, so an injected failure costs no
    device work — exactly like a transport/runtime error surfacing at
    dispatch. ``injected_at`` records the call indices that actually fired.
    """

    def _fire(self, position: int) -> None:
        msg = f"injected engine error at call {position}"
        raise InjectedFault(msg)


class LatencySpike(_CallIndexInjector):
    """Delay a wrapped callable by ``duration_s`` at the given global call
    indices — models a device stall / host GC pause / network hiccup without
    changing any result. ``injected_at`` records the calls that slept.
    """

    def __init__(self, at_calls: Iterable[int], duration_s: float = 0.05) -> None:
        super().__init__(at_calls)
        self.duration_s = float(duration_s)

    def _fire(self, position: int) -> None:
        time.sleep(self.duration_s)


def wrap_method(obj: Any, name: str, injector: Any) -> Any:
    """Instance-patch ``obj.name`` with ``injector.wrap`` (chaos entrypoint:
    ``wrap_method(service.engine, "encode", EngineErrorAt(...))``). Returns
    the original bound method so callers can restore it."""
    original = getattr(obj, name)
    setattr(obj, name, injector.wrap(original))
    return original
