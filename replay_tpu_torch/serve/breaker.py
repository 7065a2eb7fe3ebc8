"""Circuit breaker over the scoring engine: closed → open → half-open → closed.

Copied from ``replay_tpu/serve/breaker.py``: host-only, unit-testable with an
injected clock. The serving analog of training's ``RecoveryPolicy``: where
the trainer counts consecutive sentinel-skipped steps before a rollback, the
service counts consecutive :class:`~replay_tpu_torch.serve.engine.ScoringEngine`
failures before it stops sending traffic at a broken device path.

State machine:

* **closed** — normal traffic. ``failure_threshold`` CONSECUTIVE recorded
  failures trip the breaker (one success resets the streak).
* **open** — encode traffic is refused at admission (the service degrades or
  sheds instead; see ``docs/serving.md``). After ``reset_timeout_s`` the next
  ``allow()`` transitions to half-open.
* **half-open** — up to ``half_open_max_probes`` requests are admitted as
  probes while the rest stay refused. One recorded success closes the breaker
  (full reset); one recorded failure reopens it and restarts the timer. A
  probe may also VANISH without an outcome (shed downstream, deadline-expired
  or cancelled before it reached the engine) — after ``reset_timeout_s`` with
  no outcome the probe slots are reclaimed and a fresh probe is admitted, so
  an abandoned probe can never wedge the breaker in half-open.

Thread-safe: ``allow()`` runs on client threads at admission,
``record_success``/``record_failure`` on the serve worker per engine call (a
micro-batch is ONE engine call, so a batch-wide exception counts once).
Transitions invoke ``on_transition(old, new, info)`` — the service forwards
these as ``on_breaker`` events.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Optional

__all__ = ["CircuitBreaker"]

STATES = ("closed", "open", "half_open")


class CircuitBreaker:
    """Consecutive-failure breaker with a timed half-open probe window.

    :param failure_threshold: consecutive failures that open the breaker.
    :param reset_timeout_s: seconds the breaker stays open before the next
        ``allow()`` moves it to half-open.
    :param half_open_max_probes: probes admitted per half-open window before
        an outcome lands (more ``allow()`` calls are refused meanwhile).
    :param clock: monotonic-seconds source (injectable for tests).
    :param on_transition: ``(old_state, new_state, info: dict) -> None``,
        called OUTSIDE the breaker lock after every state change.
    """

    def __init__(
        self,
        failure_threshold: int = 5,
        reset_timeout_s: float = 2.0,
        half_open_max_probes: int = 1,
        clock: Callable[[], float] = time.monotonic,
        on_transition: Optional[Callable[[str, str, Dict[str, Any]], None]] = None,
    ) -> None:
        if failure_threshold < 1:
            msg = "failure_threshold must be >= 1"
            raise ValueError(msg)
        if half_open_max_probes < 1:
            msg = "half_open_max_probes must be >= 1"
            raise ValueError(msg)
        self.failure_threshold = int(failure_threshold)
        self.reset_timeout_s = float(reset_timeout_s)
        self.half_open_max_probes = int(half_open_max_probes)
        self.on_transition = on_transition
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._consecutive_failures = 0
        self._opened_at: Optional[float] = None
        self._probes_in_flight = 0
        self._probe_admitted_at: Optional[float] = None
        # accounting
        self.opens = 0
        self.closes = 0
        self.refusals = 0
        self.failures = 0
        self.successes = 0

    # -- queries ------------------------------------------------------------- #
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def retry_after_s(self) -> Optional[float]:
        """Remaining open window (None unless open)."""
        with self._lock:
            if self._state != "open" or self._opened_at is None:
                return None
            return max(self._opened_at + self.reset_timeout_s - self._clock(), 0.0)

    # -- the gate ------------------------------------------------------------ #
    def allow(self) -> bool:
        """May one more request enter the guarded path right now?

        Closed: always. Open: refuse until ``reset_timeout_s`` elapses, then
        transition to half-open and admit the first probe. Half-open: admit
        while fewer than ``half_open_max_probes`` probes are in flight.
        """
        transition = None
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if (
                    self._opened_at is not None
                    and self._clock() - self._opened_at >= self.reset_timeout_s
                ):
                    transition = self._transition_locked("half_open")
                    self._probes_in_flight = 1
                    self._probe_admitted_at = self._clock()
                else:
                    self.refusals += 1
                    allowed = False
            if self._state == "half_open" and transition is None:
                if self._probes_in_flight >= self.half_open_max_probes and (
                    self._probe_admitted_at is not None
                    and self._clock() - self._probe_admitted_at >= self.reset_timeout_s
                ):
                    # every admitted probe vanished without an outcome (shed,
                    # deadline-expired or cancelled before the engine): reclaim
                    # the slots — an abandoned probe must not wedge half-open
                    self._probes_in_flight = 0
                if self._probes_in_flight < self.half_open_max_probes:
                    self._probes_in_flight += 1
                    self._probe_admitted_at = self._clock()
                    allowed = True
                else:
                    self.refusals += 1
                    allowed = False
            elif transition is not None:
                allowed = True
        self._fire(transition)
        return allowed

    # -- outcomes ------------------------------------------------------------ #
    def record_success(self) -> None:
        """A guarded call succeeded: reset the streak; a half-open probe's
        success closes the breaker entirely."""
        transition = None
        with self._lock:
            self.successes += 1
            self._consecutive_failures = 0
            if self._state == "half_open":
                transition = self._transition_locked("closed")
        self._fire(transition)

    def record_failure(self) -> None:
        """A guarded call failed: extend the streak; at ``failure_threshold``
        the breaker opens, and any half-open probe failure reopens it."""
        transition = None
        with self._lock:
            self.failures += 1
            self._consecutive_failures += 1
            if self._state == "half_open" or (
                self._state == "closed"
                and self._consecutive_failures >= self.failure_threshold
            ):
                transition = self._transition_locked("open")
        self._fire(transition)

    # -- internals ----------------------------------------------------------- #
    def _transition_locked(self, new_state: str):
        old_state, self._state = self._state, new_state
        if new_state == "open":
            self.opens += 1
            self._opened_at = self._clock()
            self._probes_in_flight = 0
            self._probe_admitted_at = None
        elif new_state == "closed":
            self.closes += 1
            self._opened_at = None
            self._probes_in_flight = 0
            self._probe_admitted_at = None
            self._consecutive_failures = 0
        return (
            old_state,
            new_state,
            {
                "consecutive_failures": self._consecutive_failures,
                "opens": self.opens,
            },
        )

    def _fire(self, transition) -> None:
        if transition is not None and self.on_transition is not None:
            self.on_transition(*transition)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._consecutive_failures,
                "opens": self.opens,
                "closes": self.closes,
                "refusals": self.refusals,
                "failures": self.failures,
                "successes": self.successes,
            }
