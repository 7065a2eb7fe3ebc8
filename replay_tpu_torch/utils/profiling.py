"""Profiling hooks: a device trace of a region and steady-state throughput.

Counterpart of ``replay_tpu/utils/profiling.py``. :func:`trace` wraps a
region in a ``torch.profiler`` session (CPU and, where there is a card, CUDA
activities) and writes its Chrome trace into ``log_dir``: the profile window
of :func:`replay_tpu_torch.obs.profile.trace`, which ``Trainer.fit``'s
``profile_steps`` opens too. :class:`StepTimer` measures steady-state
steps/s and samples/s the way ``bench.py`` does (fenced, warm-up excluded).

For per-step rates, build counting and device memory see
:mod:`replay_tpu_torch.obs` (``StepTelemetry`` generalises this timer).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str, *, create_perfetto_link: bool = False, python_tracer_level: int = 0):
    """Capture a device trace of the enclosed region into ``log_dir``.

    ``python_tracer_level=0`` (the default) keeps Python function events out
    of the capture, as in JAX: a busy host loop emits millions of them.
    A level above 0 records them (``with_stack``). ``create_perfetto_link``
    has no torch counterpart (the JAX profiler serves the trace to Perfetto's
    UI) and raises; open the written ``*.pt.trace.json`` in Perfetto instead.
    """
    from replay_tpu_torch.obs import profile

    if create_perfetto_link:
        msg = (
            "create_perfetto_link has no torch.profiler counterpart: open the "
            "*.pt.trace.json written into log_dir in Perfetto instead"
        )
        raise NotImplementedError(msg)
    with profile.trace(str(log_dir), with_stack=int(python_tracer_level) > 0):
        yield


def _fence(result: Any) -> None:
    """Wait for the card where ``result`` holds a CUDA tensor (at any depth
    of its dicts, lists, tuples and dataclasses, such as a ``TrainState``)."""
    stack = [result]
    while stack:
        value = stack.pop()
        if isinstance(value, torch.Tensor):
            if value.is_cuda:
                torch.cuda.synchronize(value.device)
                return
        elif isinstance(value, dict):
            stack.extend(value.values())
        elif isinstance(value, (list, tuple)):
            stack.extend(value)
        elif dataclasses.is_dataclass(value) and not isinstance(value, type):
            stack.extend(getattr(value, f.name) for f in dataclasses.fields(value))


class StepTimer:
    """Steady-state throughput: call ``tick(result)`` once per step."""

    def __init__(self, warmup_steps: int = 3, samples_per_step: Optional[int] = None) -> None:
        self.warmup_steps = warmup_steps
        self.samples_per_step = samples_per_step
        self._count = 0
        self._start: Optional[float] = None

    def tick(self, result=None) -> None:
        self._count += 1
        if self._count == self.warmup_steps:
            if result is not None:
                _fence(result)
            self._start = time.perf_counter()

    def finish(self, result=None) -> dict:
        """Steady-state record — shape-stable: always ``steps`` (measured,
        post-warmup), ``steps_per_sec`` and ``samples_per_sec``, NaN-filled
        when nothing was measured, so JSONL consumers never KeyError."""
        if result is not None:
            _fence(result)
        measured = self._count - self.warmup_steps
        if self._start is None or measured <= 0:
            return {
                "steps": max(measured, 0),
                "steps_per_sec": float("nan"),
                "samples_per_sec": float("nan"),
            }
        elapsed = time.perf_counter() - self._start
        return {
            "steps": measured,
            "steps_per_sec": measured / elapsed,
            "samples_per_sec": (
                measured * self.samples_per_step / elapsed
                if self.samples_per_step
                else float("nan")
            ),
        }
