"""Step timing, program builds and device memory for ``Trainer.fit``'s events.

Counterpart of ``replay_tpu/obs/collectors.py``: :class:`StepTelemetry` as
in JAX; :class:`CompileTracker` counts and times a program's first builds,
which in the port are a CUDA-graph capture (a chunk graph, an evaluation
graph), the first call of an eager program at a new shape, and each kernel
library that :mod:`replay_tpu_torch.ops.build` compiles at first use;
:class:`MemoryMonitor` reads ``torch.cuda.memory_stats`` under the JAX
names (``bytes_in_use``, ``peak_bytes_in_use``).
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Any, Callable, Dict, Hashable, Mapping, Optional, Sequence

import numpy as np
import torch


class StepTelemetry:
    """Steady-state *and* instantaneous step timing.

    Call :meth:`mark` once before the first step, then :meth:`tick` after each
    step (or each observed group of ``steps`` steps); each tick returns the
    instantaneous rates since the previous mark/tick. :meth:`summary` returns
    the steady-state record — shape-stable: the same keys come back whether or
    not anything was measured (NaN-filled), so JSONL consumers never KeyError.

    ``warmup_steps`` ticks are excluded from the steady-state window (compile
    happens on the first step); pass a device ``result`` to fence with
    ``a synchronize`` when the caller has not already synchronized.
    """

    def __init__(self, warmup_steps: int = 1, samples_per_step: Optional[int] = None) -> None:
        self.warmup_steps = max(int(warmup_steps), 0)
        self.samples_per_step = samples_per_step
        self._count = 0
        self._last: Optional[float] = None
        self._start: Optional[float] = None
        self._measured_samples = 0.0
        self._measured_steps = 0

    @staticmethod
    def _fence(result: Any) -> None:
        if isinstance(result, torch.Tensor) and result.is_cuda:
            torch.cuda.synchronize(result.device)

    def mark(self, result: Any = None) -> None:
        """Set the reference point for the next tick's instantaneous rate.

        Re-marking after a pause (validation, checkpointing) RESUMES the
        steady-state window: the gap since the last tick is discounted, so
        non-training wall time never dilutes the summary rates.
        """
        self._fence(result)
        now = time.perf_counter()
        if self._start is not None and self._last is not None:
            self._start += now - self._last
        self._last = now

    def tick(self, result: Any = None, samples: Optional[float] = None, steps: int = 1) -> Dict[str, float]:
        """Record ``steps`` completed steps totalling ``samples`` samples."""
        self._fence(result)
        now = time.perf_counter()
        nan = float("nan")
        if samples is None and self.samples_per_step is not None:
            samples = self.samples_per_step * steps
        before_count, before_time = self._count, self._last
        self._count += steps
        record = {
            "step": float(self._count),
            "step_seconds": nan,
            "steps_per_sec": nan,
            "samples_per_sec": nan,
        }
        if before_time is not None:
            elapsed = now - before_time
            if elapsed > 0:
                record["step_seconds"] = elapsed / steps
                record["steps_per_sec"] = steps / elapsed
                if samples is not None:
                    record["samples_per_sec"] = samples / elapsed
        self._last = now
        if self._count <= self.warmup_steps:
            # still inside warmup: the steady-state clock starts at this
            # tick's END (its wall time includes compile)
            self._start = now
        else:
            measured = min(steps, self._count - self.warmup_steps)
            frac = measured / steps
            if measured < steps:
                # the tick spans the warmup boundary: prorate its window so
                # the post-warmup portion is neither discarded (NaN summaries
                # on short runs) nor counted against zero elapsed (inflation)
                if before_time is not None and now > before_time:
                    self._start = now - (now - before_time) * frac
                else:
                    self._start, measured, frac = now, 0, 0.0
            elif self._start is None:
                # warmup_steps=0: the window is anchored at mark() time; a
                # tick with no anchor at all has no time base and is dropped
                if before_time is not None:
                    self._start = before_time
                else:
                    self._start, measured, frac = now, 0, 0.0
            self._measured_steps += measured
            if samples:
                self._measured_samples += samples * frac
        return record

    def summary(self, result: Any = None) -> Dict[str, float]:
        """Steady-state record over every post-warmup tick (shape-stable)."""
        self._fence(result)
        nan = float("nan")
        record = {
            "steps": float(self._measured_steps),
            "elapsed_seconds": nan,
            "steps_per_sec": nan,
            "samples_per_sec": nan,
        }
        if self._start is not None and self._measured_steps > 0:
            # the window ends at the LAST TICK, not at this call: summary()
            # typically runs after validation/checkpointing whose wall time
            # must not dilute the steady-state training rate
            end = self._last if self._last is not None else time.perf_counter()
            elapsed = end - self._start
            if elapsed > 0:
                record["elapsed_seconds"] = elapsed
                record["steps_per_sec"] = self._measured_steps / elapsed
                if self._measured_samples:
                    record["samples_per_sec"] = self._measured_samples / elapsed
        return record


class CompileTracker:
    """Counts the first builds of each program and the wall time they took.

    The JAX tracker counts jit traces; the port's programs are built when
    first run at a shape (an eager program, whose first call builds kernels
    and sets up cuBLAS) or captured as a CUDA graph. :meth:`observe` around a
    program's call counts one build when its ``key`` (a shape) is new and
    attributes the call's wall time to it; kernel libraries that
    :mod:`replay_tpu_torch.ops.build` compiles inside the call are counted
    under ``kernel:<name>`` with their own seconds. :meth:`wrap` does the
    same for a plain function, keyed by its arguments' shapes and dtypes. A
    run at fixed shapes shows one build per program; more is a shape leak.
    """

    def __init__(self) -> None:
        self._traces: Dict[str, int] = {}
        self._compile_seconds: Dict[str, float] = {}
        self._seen: Dict[str, set] = {}

    def _add(self, name: str, seconds: float) -> None:
        self._traces[name] = self._traces.get(name, 0) + 1
        self._compile_seconds[name] = self._compile_seconds.get(name, 0.0) + seconds

    @contextlib.contextmanager
    def observe(self, name: str, key: Hashable = None):
        """Attribute the enclosed call's wall time to building ``name`` iff
        ``key`` was not seen for it before (first call, new shape)."""
        from replay_tpu_torch.ops import build

        self._traces.setdefault(name, 0)
        seen = self._seen.setdefault(name, set())
        fresh = key not in seen
        builds_before = len(build.BUILD_LOG)
        start = time.perf_counter()
        try:
            yield
        finally:
            if fresh:
                seen.add(key)
                self._add(name, time.perf_counter() - start)
            for library, seconds in build.BUILD_LOG[builds_before:]:
                self._add(f"kernel:{library}", seconds)

    def wrap(self, fn: Callable, name: Optional[str] = None) -> Callable:
        """``fn`` with each call under :meth:`observe`, keyed by the shapes and
        dtypes of its tensor and array arguments (and the structure around
        them): the first call at each key counts one build of ``name`` (the
        function's name by default), as a JAX retrace would."""
        label = name or getattr(fn, "__name__", "fn")
        self._traces.setdefault(label, 0)

        @functools.wraps(fn)
        def observed(*args, **kwargs):
            with self.observe(label, _shape_key((args, kwargs))):
                return fn(*args, **kwargs)

        return observed

    def record(self, name: str, seconds: float) -> None:
        """Count one build of ``name`` that took ``seconds`` (a graph capture)."""
        self._add(name, seconds)

    @property
    def traces(self) -> Dict[str, int]:
        return dict(self._traces)

    @property
    def compile_seconds(self) -> Dict[str, float]:
        return dict(self._compile_seconds)

    @property
    def total_compile_seconds(self) -> float:
        return float(sum(self._compile_seconds.values()))

    def report(self) -> Dict[str, Dict[str, float]]:
        """{name: {traces, compile_seconds}} over every observed program."""
        return {
            name: {
                "traces": count,
                "compile_seconds": round(self._compile_seconds.get(name, 0.0), 4),
            }
            for name, count in sorted(self._traces.items())
        }


def _shape_key(value: Any) -> Hashable:
    """What a call is built for: tensors and arrays by shape and dtype, inside
    the structure of the mappings and sequences around them; any other value
    by its type."""
    if isinstance(value, (torch.Tensor, np.ndarray)):
        return tuple(value.shape), str(value.dtype)
    if isinstance(value, Mapping):
        return tuple((key, _shape_key(item)) for key, item in value.items())
    if isinstance(value, (list, tuple)):
        return tuple(_shape_key(item) for item in value)
    return type(value).__name__


class MemoryMonitor:
    """Per-device allocator snapshots and the cross-device peak.

    Reads ``torch.cuda.memory_stats`` of each CUDA device (all visible ones
    by default), with ``bytes_in_use`` and ``peak_bytes_in_use`` (the JAX
    names) taken from the allocator's current and peak allocated bytes. On a
    machine without a card every accessor returns an empty snapshot or
    ``None``, as the JAX monitor does on a CPU backend.
    """

    def __init__(self, devices: Optional[Sequence[Any]] = None) -> None:
        self._devices = devices
        # chunk-boundary sampling (observe()): the windowed high-water mark
        # over explicit samples, vs the allocator's process-lifetime peak
        self.observed_peak_bytes: Optional[int] = None
        self.observed_samples: int = 0

    def _resolve(self):
        if self._devices is None:
            count = torch.cuda.device_count() if torch.cuda.is_available() else 0
            self._devices = [torch.device("cuda", index) for index in range(count)]
        return [torch.device(d) for d in self._devices if torch.device(d).type == "cuda"]

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        stats = {}
        for device in self._resolve():
            raw = torch.cuda.memory_stats(device)
            if not raw:
                continue
            record = {
                key: float(value)
                for key, value in raw.items()
                if isinstance(value, (int, float)) and not isinstance(value, bool)
            }
            record["bytes_in_use"] = float(raw.get("allocated_bytes.all.current", 0))
            record["peak_bytes_in_use"] = float(raw.get("allocated_bytes.all.peak", 0))
            record["bytes_reserved"] = float(raw.get("reserved_bytes.all.current", 0))
            stats[str(device)] = record
        return stats

    def _max_over_devices(self, key: str) -> Optional[int]:
        values = [s[key] for s in self.snapshot().values() if key in s]
        return int(max(values)) if values else None

    def peak_bytes(self) -> Optional[int]:
        """Max ``peak_bytes_in_use`` over devices (None when unavailable)."""
        return self._max_over_devices("peak_bytes_in_use")

    def bytes_in_use(self) -> Optional[int]:
        return self._max_over_devices("bytes_in_use")

    def observe(self) -> Optional[int]:
        """Sample the current cross-device peak into the observed window.

        The chunked fit calls this at every chunk boundary, so
        ``observed_peak_bytes`` tracks the fit's own high-water mark. Without
        a card it returns None and the sample is not counted.
        """
        peak = self.peak_bytes()
        if peak is None:
            return None
        self.observed_samples += 1
        if self.observed_peak_bytes is None or peak > self.observed_peak_bytes:
            self.observed_peak_bytes = peak
        return peak
