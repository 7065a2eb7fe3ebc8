"""Serving-resilience exceptions: every way the service says "no" quickly.

Copied from ``replay_tpu/serve/errors.py`` (host-only, no array framework).

The reference's serving runtime fails requests through HTTP status codes; here
the same taxonomy rides :class:`concurrent.futures.Future` exceptions so a
client can branch on WHY a request was refused — and, for the retryable
refusals, on WHEN to come back:

* :class:`RequestShed` — admission control: the lane's bounded queue is full
  (or the breaker-degraded paths were saturated too). Retryable; carries the
  observed queue depth and a ``retry_after_s`` hint.
* :class:`DeadlineExceeded` — the request's end-to-end ``deadline_ms`` expired
  while it was still queued, so the batch builder dropped it BEFORE it could
  burn a device slot (abandoned work never reaches the accelerator).
* :class:`CircuitOpen` — the engine breaker is open and no degraded mode could
  absorb the request. Retryable after ``retry_after_s`` (the breaker's
  remaining open window).
* :class:`ServiceClosed` — the service stopped (or its worker exhausted the
  restart budget); every pending future is failed with this rather than left
  to hang.

* :class:`NoHealthyReplica` — the FLEET-level refusal (``serve/fleet.py``):
  no replica on the user's ring order could take the request (all dead,
  draining, or every retry exhausted). Carries the fleet's health map at
  refusal time.

All subclass :class:`ServeError` (itself a ``RuntimeError``), so
``except ServeError`` catches exactly the service's own refusals while real
engine exceptions — the thing the breaker counts — pass through untouched.
"""

from __future__ import annotations

from typing import Hashable, Optional


class ServeError(RuntimeError):
    """Base class for the scoring service's own request refusals."""


class RequestShed(ServeError):
    """Admission control refused the request: the lane's queue is full.

    :param lane: the saturated lane (as routed — e.g. ``('encode', 16)``).
    :param depth: queue depth observed at refusal.
    :param max_depth: the configured per-lane bound.
    :param retry_after_s: hint — roughly how long until the backlog drains
        enough to admit new work (depth x recent per-batch dispatch time).
    """

    def __init__(
        self,
        lane: Hashable,
        depth: int,
        max_depth: int,
        retry_after_s: Optional[float] = None,
    ) -> None:
        self.lane = lane
        self.depth = int(depth)
        self.max_depth = int(max_depth)
        self.retry_after_s = retry_after_s
        hint = f", retry after ~{retry_after_s:.3f}s" if retry_after_s is not None else ""
        super().__init__(
            f"request shed: lane {lane!r} queue at {depth}/{max_depth}{hint}"
        )


class DeadlineExceeded(ServeError):
    """The request's end-to-end deadline expired before batch build.

    Dropped requests never reach the device: an expired waiter costs queue
    bookkeeping, not a scoring slot.
    """

    def __init__(self, waited_s: float, deadline_s: float) -> None:
        self.waited_s = float(waited_s)
        self.deadline_s = float(deadline_s)
        super().__init__(
            f"deadline exceeded: waited {waited_s * 1000.0:.1f} ms "
            f"of a {deadline_s * 1000.0:.1f} ms budget"
        )


class CircuitOpen(ServeError):
    """The engine breaker is open and no degraded mode could serve this.

    :param retry_after_s: remaining open window before the breaker will
        half-open and admit a probe.
    """

    def __init__(self, retry_after_s: Optional[float] = None) -> None:
        self.retry_after_s = retry_after_s
        hint = f"; retry after ~{retry_after_s:.3f}s" if retry_after_s is not None else ""
        super().__init__(f"scoring engine circuit is open{hint}")


class ServiceClosed(ServeError):
    """The service stopped; this request will never be served.

    The message deliberately contains "not running": the micro-batcher's
    pre-resilience contract (``RuntimeError`` matching that phrase) stays
    intact for existing callers.
    """

    def __init__(self, detail: str = "service is not running") -> None:
        super().__init__(detail)


class NoHealthyReplica(ServeError):
    """The fleet router found no replica able to take this request.

    :param replicas: replica ids consulted (the ring membership at refusal).
    :param cause: the last per-replica refusal, when the router got that far
        (e.g. the final :class:`RequestShed` after retries were exhausted).
    """

    def __init__(self, replicas=(), cause: Optional[BaseException] = None) -> None:
        self.replicas = list(replicas)
        self.cause = cause
        detail = f" (last refusal: {cause!r})" if cause is not None else ""
        super().__init__(
            f"no healthy replica among {self.replicas or '<empty fleet>'}{detail}"
        )


class ServiceClosed(ServeError):
    """The service stopped; this request will never be served.

    The message deliberately contains "not running": the micro-batcher's
    pre-resilience contract (``RuntimeError`` matching that phrase) stays
    intact for existing callers.
    """

    def __init__(self, detail: str = "service is not running") -> None:
        super().__init__(detail)
