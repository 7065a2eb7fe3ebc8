"""Step timing for ``Trainer.fit``'s events.

Counterpart of ``StepTelemetry`` in ``replay_tpu/obs/collectors.py`` (the
JAX module's retrace counter and memory monitor are not copied: the port
reads the card's memory through ``torch.cuda``, and its compiled programs are
captured graphs, ``ROADMAP.md`` queue 1, item 5).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

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
