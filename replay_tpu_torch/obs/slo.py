"""Declarative SLO watchdogs over the live metrics registry.

The threshold-gated half of the live observability plane: operators declare
rules over metric names (:mod:`replay_tpu_torch.obs.metrics`), the watchdog
evaluates them at step/batch cadence (the :class:`~replay_tpu_torch.obs.metrics.
MetricsLogger` calls :meth:`SLOWatchdog.evaluate` after every bridged
``on_train_step`` / ``on_serve_batch``), and breaches flow as
``on_slo_violation`` events through the SAME sinks every other event uses —
so a violation lands in ``events.jsonl``, prints on the console
(:class:`~replay_tpu_torch.obs.events.ConsoleLogger`'s warning-class render), counts
in the registry (``replay_slo_violations_total``).

Breach→recovery state machine (per rule)::

    ok ──condition holds──▶ breaching (counts consecutive evaluations)
    breaching ──held for `for_steps` evals──▶ VIOLATION (one on_slo_violation)
    violation ──condition clears──▶ ok       (one on_slo_recovery, with the
                                              breach duration + eval count)

Firing on the *transition* (not per evaluation) is what makes "a NaN step
trips the bad_steps rule exactly once" testable, and the recovery event's
``breach_seconds`` is what distinguishes a transient spike from a sustained
breach in the report. The clock is injectable for deterministic tests.

Copied from ``replay_tpu/obs/slo.py`` (host-only, stdlib only).
"""

from __future__ import annotations

import operator
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence

from .events import TrainerEvent
from .metrics import MetricsRegistry

__all__ = ["SLORule", "SLOWatchdog"]

_OPS: Dict[str, Callable[[float, float], bool]] = {
    ">": operator.gt,
    ">=": operator.ge,
    "<": operator.lt,
    "<=": operator.le,
    "==": operator.eq,
    "!=": operator.ne,
}


@dataclass(frozen=True)
class SLORule:
    """One declarative threshold over a registry metric.

    :param metric: registry name, with the ``:stat`` suffix for histograms
        (``replay_serve_queue_wait_ms:p99``, ``replay_train_step_seconds:mean``
        — see :meth:`~replay_tpu_torch.obs.metrics.MetricsRegistry.value`).
    :param op: comparison the *breach* satisfies — ``"replay_train_bad_steps"
        > 0`` breaches when bad steps appear.
    :param threshold: the boundary value.
    :param for_steps: consecutive evaluations the condition must hold before
        the violation fires (1 = immediately). Debounces flappy metrics:
        ``for_steps=5`` on a p99 gauge means five consecutive steps over
        budget, not one unlucky scrape.
    :param labels: label set selecting one series of a labeled metric —
        required for metrics that only exist labeled
        (``replay_serve_degraded_total`` is per ``to=``,
        ``replay_goodput_fraction`` per ``phase=``, ``replay_serve_lane_depth``
        per ``lane=``); the unlabeled read of such a metric is permanent
        "no data" and the rule would never evaluate.
    :param name: label for events/metrics; defaults to
        ``"<metric>{k=v}<op><threshold>"``.
    """

    metric: str
    op: str
    threshold: float
    for_steps: int = 1
    labels: Optional[Mapping[str, str]] = None
    name: Optional[str] = None

    def __post_init__(self) -> None:
        if self.op not in _OPS:
            msg = f"unknown op {self.op!r}; use one of {sorted(_OPS)}"
            raise ValueError(msg)
        if self.for_steps < 1:
            msg = "for_steps must be >= 1 (consecutive breaching evaluations)"
            raise ValueError(msg)

    @property
    def label(self) -> str:
        if self.name:
            return self.name
        rendered = (
            "{" + ",".join(f"{k}={v}" for k, v in sorted(self.labels.items())) + "}"
            if self.labels
            else ""
        )
        return f"{self.metric}{rendered}{self.op}{self.threshold:g}"

    def breached(self, value: float) -> bool:
        return _OPS[self.op](value, self.threshold)


@dataclass
class _RuleState:
    consecutive: int = 0
    active: bool = False
    breach_started: Optional[float] = None
    fired: int = 0


class SLOWatchdog:
    """Evaluate a rule set against a registry; emit transition events.

    ``emit`` receives :class:`TrainerEvent` records — wire it to the run's
    sink fan-out (``Trainer.fit`` points it at the same ``MultiLogger`` every
    other event flows through). A metric that does not exist yet is treated
    as "no data": the rule's state is untouched (a rule on a serve gauge must
    not flap while only training events have arrived).

    Thread-light: evaluations are serialized by the caller (the bridge calls
    from whatever thread delivered the event, but one event at a time per
    sink fan-out); state transitions are simple python so a rare concurrent
    pair of evaluations cannot corrupt more than one consecutive-count.
    """

    def __init__(
        self,
        rules: Sequence[SLORule],
        registry: MetricsRegistry,
        emit: Optional[Callable[[TrainerEvent], None]] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.rules = tuple(rules)
        labels = [rule.label for rule in self.rules]
        if len(set(labels)) != len(labels):
            msg = f"duplicate SLO rule labels: {sorted(labels)}"
            raise ValueError(msg)
        self.registry = registry
        self.emit = emit
        self.clock = clock
        self._state: Dict[str, _RuleState] = {rule.label: _RuleState() for rule in self.rules}

    # -- introspection ------------------------------------------------------ #
    @property
    def active(self) -> List[str]:
        """Labels of rules currently in violation."""
        return [label for label, state in self._state.items() if state.active]

    def stats(self) -> Dict[str, Mapping[str, Any]]:
        return {
            label: {
                "active": state.active,
                "consecutive": state.consecutive,
                "fired": state.fired,
            }
            for label, state in self._state.items()
        }

    # -- evaluation --------------------------------------------------------- #
    def _send(self, event: TrainerEvent) -> None:
        if self.emit is not None:
            self.emit(event)

    def evaluate(self, step: Optional[int] = None) -> List[TrainerEvent]:
        """One pass over every rule; returns the transition events emitted."""
        now = self.clock()
        emitted: List[TrainerEvent] = []
        for rule in self.rules:
            state = self._state[rule.label]
            value = self.registry.value(rule.metric, labels=rule.labels)
            if value is None:
                continue  # no data yet: neither a breach nor a recovery
            if rule.breached(value):
                state.consecutive += 1
                if state.breach_started is None:
                    state.breach_started = now
                if not state.active and state.consecutive >= rule.for_steps:
                    state.active = True
                    state.fired += 1
                    self.registry.set(
                        "replay_slo_breached", 1.0, labels={"rule": rule.label}
                    )
                    event = TrainerEvent(
                        event="on_slo_violation",
                        step=step,
                        payload={
                            "rule": rule.label,
                            "metric": rule.metric,
                            "op": rule.op,
                            "threshold": rule.threshold,
                            "value": value,
                            "consecutive": state.consecutive,
                        },
                    )
                    emitted.append(event)
                    self._send(event)
            else:
                if state.active:
                    breach_seconds = (
                        now - state.breach_started
                        if state.breach_started is not None
                        else 0.0
                    )
                    self.registry.set(
                        "replay_slo_breached", 0.0, labels={"rule": rule.label}
                    )
                    event = TrainerEvent(
                        event="on_slo_recovery",
                        step=step,
                        payload={
                            "rule": rule.label,
                            "metric": rule.metric,
                            "value": value,
                            "breach_seconds": breach_seconds,
                            "breached_evaluations": state.consecutive,
                        },
                    )
                    emitted.append(event)
                    self._send(event)
                state.active = False
                state.consecutive = 0
                state.breach_started = None
        return emitted
