"""The serving fleet: N scoring replicas behind a consistent-hash router.

Copied from ``replay_tpu/serve/fleet.py`` (host-only: the fleet holds no
tensor; each replica's encode runs on its own engine). One
:class:`~replay_tpu_torch.serve.ScoringService` is one device's worth of
programs and one ``UserStateCache`` — a single point of failure that cannot
serve millions of users. :class:`ServingFleet` composes N of them:

* **routing** — users map to replicas on a :class:`~.router.HashRing`
  (bounded movement: adding/removing a replica remigrates ~1/N of users, so
  the per-user state caches on every OTHER replica stay hot through
  membership changes and rollouts).
* **health** — a monitor thread drives each replica's
  ``healthy → degraded → draining → dead`` state from heartbeats plus the
  gauges the replica already exports (lane depth, breaker state, windowed
  error rate). Every transition is one ``on_replica_health`` event; a death
  additionally emits ``on_failover``.
* **failover** — a dead home replica's users are served by the next replica
  on their ring order. The rerouted users' caches are COLD there by
  construction; with ``ScoringService(cold_miss="fallback")`` those requests
  ride the degradation ladder (visible in ``served_by``) instead of
  erroring, and they return home — caches intact — when the replica revives.
* **hedging** — an idempotent request still unanswered after a p99-derived
  delay races a second replica; the first answer wins and the loser is
  cancelled through the existing future-cancel path (the batch build skips
  cancelled waiters before any device work).
* **router-level admission control** — a replica's
  :class:`~replay_tpu_torch.serve.errors.RequestShed` / ``CircuitOpen`` refusal is
  retried with capped exponential backoff that honors ``retry_after_s``
  (:class:`~.router.BackoffPolicy`) — but ONLY for idempotent requests
  (``new_items`` traffic mutates the home cache at submit; re-sending it
  would double-land the interaction), and an ANSWER is never retried: a
  degraded response (``served_by != "primary"``) is the ladder working, not
  a failure to shop around.
* **drain protocol** — :meth:`drain` stops NEW traffic to a replica and waits
  for its lanes to empty (zero orphaned waiters), the caller hot-swaps
  weights through the promotion path, :meth:`rejoin` restores it.
  :meth:`rolling_swap` runs that end-to-end across the fleet: a zero-downtime
  fleet-wide rollout.

The fleet is duck-typed over its replicas (the
``submit/heartbeat/stats/start/close`` surface: an in-process
``ScoringService`` or a :class:`~replay_tpu_torch.serve.RemoteReplica`), so the
routing, failover, hedging and drain logic is host-only-testable
(``tests/_torch/test_torch_fleet.py``) exactly like the micro-batcher and
breaker underneath it. Several in-process replicas may share one card: each
holds its own engine, CUDA graphs and serve worker, and the fleet never
touches a tensor. The replicas' own ``device`` decides where they run; the
fleet adds no device of its own and never moves one.
"""

from __future__ import annotations

import heapq
import itertools
import threading
import time
from concurrent.futures import CancelledError, Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, Callable, Dict, Hashable, List, Mapping, Optional, Sequence, Tuple

from replay_tpu_torch.obs import TraceContext, Tracer, TrainerEvent

from .errors import CircuitOpen, NoHealthyReplica, RequestShed, ServiceClosed
from .futures import safe_fail, safe_set_result
from .router import BackoffPolicy, HashRing, ReplicaHealth

__all__ = ["ReplicaHandle", "ServingFleet"]

# latency histogram bounds in ms (the p99-derived hedge delay's material)
_LATENCY_MS_BUCKETS = (
    0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
    2500.0, 5000.0,
)


class ReplicaHandle:
    """One fleet slot: a scoring service, its ring id, and its health."""

    def __init__(self, replica_id: str, service: Any, clock: Callable[[], float]) -> None:
        self.replica_id = replica_id
        self.service = service
        self.health = ReplicaHealth(replica_id, clock=clock)
        # last heartbeat's cumulative counters — the monitor's windowed
        # error-rate material (cumulative rates would never recover)
        self.last_requests = 0.0
        self.last_errors = 0.0
        self.routed = 0
        self.answered = 0
        # per-replica resilience accounting (stats()["per_replica"], rendered
        # by obs.report): hedges LANDED here as the racing twin, wins where
        # this replica's hedge answered first, cancels where its twin lost,
        # and retries this replica's refusals caused
        self.hedges = 0
        self.hedge_wins = 0
        self.hedge_cancelled = 0
        self.retries = 0


class _Flight:
    """One client request's in-flight state across primaries/hedges/retries."""

    __slots__ = (
        "user_id", "kwargs", "client", "idempotent", "home", "attempt",
        "tried", "inflight", "scheduled", "retry_scheduled", "failure",
        "hedged", "hedge_replica", "submitted_at", "trace", "trace_t0", "lock",
    )

    def __init__(self, user_id, kwargs, client, idempotent, home, submitted_at,
                 trace=None, trace_t0=0.0):
        self.user_id = user_id
        self.kwargs = kwargs
        self.client = client
        self.idempotent = idempotent
        self.home = home
        self.attempt = 0
        self.tried: List[str] = []
        self.inflight: Dict[Future, str] = {}
        self.scheduled = 0  # timers (hedge/retry) not yet fired
        self.retry_scheduled = False  # at most ONE retry timer per flight
        self.failure: Optional[BaseException] = None
        self.hedged = False
        self.hedge_replica: Optional[str] = None  # who the hedge raced on
        self.submitted_at = submitted_at
        # distributed-trace identity: a TraceContext minted at admission when
        # the fleet tracer is on (None otherwise — the disabled hot path
        # carries no per-request trace state), and the router-tracer-relative
        # admission timestamp anchoring the root "request" span
        self.trace: Optional[TraceContext] = trace
        self.trace_t0 = trace_t0
        self.lock = threading.Lock()


class ServingFleet:
    """N scoring replicas behind a consistent-hash router with failover.

    :param replicas: ``{replica_id: service}`` (or a sequence, auto-named
        ``r0..rN``). A "service" is anything with the ``ScoringService``
        surface: ``submit(user_id, ...) -> Future``, ``heartbeat()``,
        ``start()``, ``close()``, ``stats()`` and (for :meth:`drain`) a
        ``batcher.idle``/``queued_depth`` view.
    :param vnodes: hash-ring virtual nodes per replica (see :class:`HashRing`).
    :param hedge_ms: hedge delay. ``None`` (default) derives it from the
        fleet's own observed p99 (never below ``hedge_floor_ms``); ``0``
        disables hedging.
    :param backoff: router-level retry policy for shed/circuit-open refusals
        of idempotent requests; ``None`` builds :class:`BackoffPolicy`
        defaults. ``BackoffPolicy(max_retries=0)`` disables retries.
    :param heartbeat_interval_s: monitor cadence. ``None`` starts NO monitor
        thread — callers (tests, load generators) invoke :meth:`poll` themselves.
    :param heartbeat_misses: consecutive failed heartbeats before a replica
        is declared dead.
    :param degrade_depth_fraction: lane backlog (queued / max_depth) beyond
        which a replica is marked degraded.
    :param degrade_error_rate: windowed error rate beyond which a replica is
        marked degraded (evaluated only on windows with >= 8 requests).
    :param logger: any :class:`~replay_tpu_torch.obs.RunLogger`; receives
        ``on_fleet_start`` / ``on_replica_health`` / ``on_failover`` /
        ``on_hedge`` / ``on_fleet_end``.
    :param tracer: the ROUTER's :class:`~replay_tpu_torch.obs.Tracer` (the "router"
        track of the merged fleet trace). When enabled, every :meth:`submit`
        mints a :class:`~replay_tpu_torch.obs.TraceContext` and propagates it to the
        replica (``service.submit(..., _trace=...)`` as pure JSON) on every
        launch — primary, hedge and retry alike — while the router records its
        own hops (``route`` / ``hedge_wait`` / ``backoff_wait`` /
        ``failover_reroute`` / ``hedge_cancel``) and the root ``request`` span
        keyed by the same trace_id. ``None`` (default) disables tracing: no
        context is minted, no kwarg injected — the hot path is unchanged.
    """

    def __init__(
        self,
        replicas: Any,
        vnodes: int = 64,
        hedge_ms: Optional[float] = None,
        hedge_floor_ms: float = 20.0,
        backoff: Optional[BackoffPolicy] = None,
        heartbeat_interval_s: Optional[float] = 0.25,
        heartbeat_misses: int = 3,
        degrade_depth_fraction: float = 0.75,
        degrade_error_rate: float = 0.5,
        logger=None,
        tracer: Optional[Tracer] = None,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if isinstance(replicas, Mapping):
            named = dict(replicas)
        else:
            named = {f"r{i}": service for i, service in enumerate(replicas)}
        if not named:
            msg = "a fleet needs at least one replica"
            raise ValueError(msg)
        self._clock = clock
        self.logger = logger
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self.handles: Dict[str, ReplicaHandle] = {
            str(rid): ReplicaHandle(str(rid), service, clock)
            for rid, service in named.items()
        }
        self.ring = HashRing(tuple(self.handles), vnodes=vnodes)
        self.hedge_ms = hedge_ms
        self.hedge_floor_ms = float(hedge_floor_ms)
        self.backoff = backoff if backoff is not None else BackoffPolicy()
        self.heartbeat_interval_s = heartbeat_interval_s
        self.heartbeat_misses = int(heartbeat_misses)
        self.degrade_depth_fraction = float(degrade_depth_fraction)
        self.degrade_error_rate = float(degrade_error_rate)

        self._lock = threading.Lock()  # counters
        self._health_lock = threading.Lock()  # every health transition
        self._requests = 0
        self._answered = 0
        self._errors = 0
        self._reroutes = 0
        self._retries = 0
        self._hedges = 0
        self._hedge_wins = 0
        self._hedge_cancelled = 0
        self._failovers = 0
        self._no_healthy_refusals = 0
        from replay_tpu_torch.obs.metrics import Histogram

        self._latency_ms = Histogram(_LATENCY_MS_BUCKETS)

        # one scheduler thread for hedge timers and retry backoff: a heap of
        # (due, seq, fn) under a condition — bounded threads no matter the
        # request rate
        self._timers: List[Tuple[float, int, Callable[[], None]]] = []
        self._timer_seq = itertools.count()
        self._timer_wake = threading.Condition()
        self._scheduler: Optional[threading.Thread] = None
        self._monitor: Optional[threading.Thread] = None
        self._running = False

    # -- lifecycle ----------------------------------------------------------- #
    def start(self) -> "ServingFleet":
        if self._running:
            return self
        self._running = True
        for handle in self.handles.values():
            handle.service.start()
        self._scheduler = threading.Thread(
            target=self._run_timers, name="fleet-scheduler", daemon=True
        )
        self._scheduler.start()
        if self.heartbeat_interval_s is not None:
            self._monitor = threading.Thread(
                target=self._run_monitor, name="fleet-monitor", daemon=True
            )
            self._monitor.start()
        self._emit(
            "on_fleet_start",
            {
                "replicas": sorted(self.handles),
                "vnodes": self.ring.vnodes,
                "hedge_ms": self.hedge_ms,
                "hedge_floor_ms": self.hedge_floor_ms,
                "max_retries": self.backoff.max_retries,
                "heartbeat_interval_s": self.heartbeat_interval_s,
            },
        )
        return self

    def close(self) -> None:
        """Stop the monitor/scheduler and close every replica. Replica
        ``close()`` resolves each service's own pending futures (the
        no-orphaned-waiters contract), so fleet shutdown hangs nothing."""
        if not self._running:
            return
        self._running = False
        with self._timer_wake:
            self._timer_wake.notify_all()
        for thread in (self._monitor, self._scheduler):
            if thread is not None:
                thread.join(timeout=5.0)
        self._monitor = self._scheduler = None
        # fire whatever the scheduler did not get to (or left past the join
        # timeout) on THIS thread: a hedge/retry timer scheduled before the
        # shutdown must still run so its flight's scheduled-count drops and
        # the client resolves — timers are no-ops or fast-fails by now
        # (_running is False), never new work
        while True:
            with self._timer_wake:
                if not self._timers:
                    break
                _, _, fn = heapq.heappop(self._timers)
            try:
                fn()
            except Exception:  # noqa: BLE001 — drain must complete
                pass
        for handle in self.handles.values():
            handle.service.close()
        self._emit("on_fleet_end", self.stats())

    def __enter__(self) -> "ServingFleet":
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.close()

    # -- client API ---------------------------------------------------------- #
    def submit(
        self,
        user_id: Hashable,
        history: Optional[Sequence[int]] = None,
        new_items: Sequence[int] = (),
        k: Optional[int] = None,
        candidates: Optional[Sequence[int]] = None,
        deadline_ms: Optional[float] = None,
    ) -> "Future":
        """Route one request to the user's replica; resolves to that
        replica's :class:`~replay_tpu_torch.serve.ScoreResponse` with ``.replica``
        stamped. Never blocks, never hangs: refusals fail the future with the
        serve taxonomy (:class:`NoHealthyReplica` when no replica can take
        the request at all)."""
        client: "Future" = Future()
        kwargs = {
            "history": history,
            "new_items": tuple(new_items),
            "k": k,
            "candidates": candidates,
            "deadline_ms": deadline_ms,
        }
        with self._lock:
            self._requests += 1
        # trace admission: mint the context BEFORE routing so the hash lookup
        # itself is a traced hop. Tracing off mints nothing — None everywhere
        trace: Optional[TraceContext] = None
        trace_t0 = 0.0
        if self.tracer.enabled:
            trace = TraceContext.mint()
            trace_t0 = self.tracer.now()
        order = self.ring.preference(user_id)
        flight = _Flight(
            user_id=user_id,
            kwargs=kwargs,
            client=client,
            idempotent=not new_items,
            home=order[0] if order else None,
            submitted_at=self._clock(),
            trace=trace,
            trace_t0=trace_t0,
        )
        target = self._pick_target(order, skip=())
        if trace is not None:
            # the replica-bound context rides in flight.kwargs, so EVERY
            # launch (primary, hedge, retry) forwards it — as pure JSON,
            # the same payload a future socket boundary would carry
            kwargs["_trace"] = trace.child("route").to_json()
            self.tracer.add_span(
                "route", trace_t0, self.tracer.now() - trace_t0,
                trace_id=trace.trace_id, user=str(user_id),
                home=flight.home, target=target,
            )
        if target is None:
            with self._lock:
                self._no_healthy_refusals += 1
                self._errors += 1
            self._safe_fail(client, NoHealthyReplica(list(self.handles)))
            return client
        if target != flight.home:
            with self._lock:
                self._reroutes += 1
            if trace is not None:
                self.tracer.add_span(
                    "failover_reroute", self.tracer.now(), 0.0,
                    trace_id=trace.trace_id, home=flight.home, target=target,
                )
        self._launch(flight, target, hedge_eligible=True)
        # a client-side give-up (score(timeout=...) cancels) propagates to
        # the in-flight replica requests, so the batch build skips them
        # before any device work — the single-service cancel path, one
        # level up
        client.add_done_callback(lambda f: self._propagate_cancel(flight, f))
        return client

    def _propagate_cancel(self, flight: _Flight, client: "Future") -> None:
        if not client.cancelled():
            return
        with flight.lock:
            pending = [inner for inner in flight.inflight if not inner.done()]
        for inner in pending:
            inner.cancel()

    def score(self, user_id: Hashable, timeout: Optional[float] = 60.0, **kwargs):
        """Synchronous :meth:`submit` (mirrors ``ScoringService.score``)."""
        if timeout is not None and "deadline_ms" not in kwargs:
            kwargs["deadline_ms"] = timeout * 1000.0
        future = self.submit(user_id, **kwargs)
        try:
            return future.result(timeout=timeout)
        except FutureTimeoutError:
            future.cancel()
            raise

    # -- routing ------------------------------------------------------------- #
    def _pick_target(
        self, order: Sequence[str], skip: Sequence[str]
    ) -> Optional[str]:
        """First usable replica in the user's ring order: the home replica if
        it takes traffic (healthy OR degraded — home traffic sticks to warm
        caches as long as the replica answers at all); otherwise the first
        HEALTHY replica downstream (failover never piles onto a degraded
        one), falling back to any traffic-taking replica when nothing is
        fully healthy."""
        with self._health_lock:
            usable = [
                rid for rid in order
                if rid not in skip and self.handles[rid].health.takes_traffic
            ]
            if not usable:
                return None
            if order and usable and usable[0] == order[0]:
                return usable[0]
            for rid in usable:
                if self.handles[rid].health.takes_failover:
                    return rid
            return usable[0]

    def _hedge_target(self, flight: _Flight, primary: str) -> Optional[str]:
        order = self.ring.preference(flight.user_id)
        with self._health_lock:
            for rid in order:
                if rid != primary and self.handles[rid].health.takes_failover:
                    return rid
        return None

    # -- dispatch ------------------------------------------------------------ #
    def _launch(self, flight: _Flight, replica_id: str, hedge_eligible: bool) -> None:
        handle = self.handles[replica_id]
        flight.tried.append(replica_id)
        with self._lock:
            handle.routed += 1
        try:
            inner = handle.service.submit(flight.user_id, **flight.kwargs)
        except Exception as exc:  # noqa: BLE001 — a dead replica object
            self._on_refusal(flight, replica_id, exc)
            return
        with flight.lock:
            flight.inflight[inner] = replica_id
        inner.add_done_callback(
            lambda f, rid=replica_id: self._on_inner_done(flight, rid, f)
        )
        # a racer (the primary answering, a client give-up) may have resolved
        # the flight between the pre-launch check and this registration — its
        # loser sweep ran before this inner existed, so cancel it here or the
        # duplicate runs full device work
        if flight.client.done():
            inner.cancel()
        if hedge_eligible and flight.idempotent:
            delay_ms = self._hedge_delay_ms()
            if delay_ms is not None:
                self._schedule_flight(
                    delay_ms / 1000.0, flight, lambda: self._fire_hedge(flight, replica_id)
                )

    def _hedge_delay_ms(self) -> Optional[float]:
        if self.hedge_ms is not None:
            return float(self.hedge_ms) if self.hedge_ms > 0 else None
        with self._lock:
            p99 = self._latency_ms.quantile(0.99)
        if p99 is None:
            return self.hedge_floor_ms
        return max(float(p99), self.hedge_floor_ms)

    def _fire_hedge(self, flight: _Flight, primary: str) -> None:
        if flight.client.done():
            self._maybe_finalize(flight)
            return
        with flight.lock:
            primary_pending = any(not f.done() for f in flight.inflight)
            already_hedged = flight.hedged
        if not primary_pending or already_hedged:
            self._maybe_finalize(flight)
            return
        target = self._hedge_target(flight, primary)
        if target is None:
            self._maybe_finalize(flight)
            return
        with flight.lock:
            flight.hedged = True
            flight.hedge_replica = target
        with self._lock:
            self._hedges += 1
            target_handle = self.handles.get(target)
            if target_handle is not None:
                target_handle.hedges += 1
        if flight.trace is not None:
            # the window the primary was given before the race began —
            # admission to hedge launch, on the router track
            now = self.tracer.now()
            self.tracer.add_span(
                "hedge_wait", flight.trace_t0, now - flight.trace_t0,
                trace_id=flight.trace.trace_id, primary=primary, hedge=target,
            )
        self._emit(
            "on_hedge",
            {"user_id": str(flight.user_id), "primary": primary, "hedge": target},
        )
        self._launch(flight, target, hedge_eligible=False)
        self._maybe_finalize(flight)

    def _on_inner_done(self, flight: _Flight, replica_id: str, inner: "Future") -> None:
        try:
            exc = inner.exception()
        except CancelledError:
            # the loser we cancelled (or a client-side give-up): accounted at
            # cancel time, nothing to resolve here
            with flight.lock:
                flight.inflight.pop(inner, None)
            self._maybe_finalize(flight)
            return
        with flight.lock:
            flight.inflight.pop(inner, None)
        if exc is None:
            self._on_answer(flight, replica_id, inner.result())
            return
        self._on_refusal(flight, replica_id, exc)

    def _on_answer(self, flight: _Flight, replica_id: str, response) -> None:
        response.replica = replica_id
        if flight.trace is not None:
            # stamp the winning answer with its trace id (like ``.replica``):
            # a chaos probe's slow failover answer links straight to its trace
            response.trace_id = flight.trace.trace_id
        if not self._safe_set_result(flight.client, response):
            return  # a racing hedge already won (or the client gave up)
        handle = self.handles.get(replica_id)
        now = self._clock()
        with self._lock:
            self._answered += 1
            if handle is not None:
                handle.answered += 1
            self._latency_ms.observe(
                (now - flight.submitted_at) * 1000.0,
                exemplar=flight.trace.trace_id if flight.trace is not None else None,
            )
            # a win is the HEDGE replica answering — not whoever happened to
            # be tried last (a post-hedge backoff retry answering is a retry
            # win, and the hedge itself lost)
            if flight.hedged and replica_id == flight.hedge_replica:
                self._hedge_wins += 1
                if handle is not None:
                    handle.hedge_wins += 1
        if flight.trace is not None:
            # the root span of the whole request: admission → winning answer.
            # Its duration is the denominator of the report's tail attribution
            # (every hop span sharing this trace_id is a numerator slice), and
            # ``served_by`` names the degradation-ladder rung that answered
            self.tracer.add_span(
                "request", flight.trace_t0, self.tracer.now() - flight.trace_t0,
                trace_id=flight.trace.trace_id, user=str(flight.user_id),
                replica=replica_id,
                served_by=getattr(response, "served_by", None),
                served_from=getattr(response, "served_from", None),
                hedged=flight.hedged, attempts=flight.attempt,
            )
        # cancel the losers through the existing future-cancel path: a still-
        # queued twin is skipped at batch build before any device work
        with flight.lock:
            losers = [
                (f, rid) for f, rid in flight.inflight.items() if not f.done()
            ]
        for loser, loser_rid in losers:
            if loser.cancel():
                with self._lock:
                    self._hedge_cancelled += 1
                    loser_handle = self.handles.get(loser_rid)
                    if loser_handle is not None:
                        loser_handle.hedge_cancelled += 1
                if flight.trace is not None:
                    self.tracer.add_span(
                        "hedge_cancel", self.tracer.now(), 0.0,
                        trace_id=flight.trace.trace_id, replica=loser_rid,
                    )

    def _on_refusal(self, flight: _Flight, replica_id: str, exc: BaseException) -> None:
        retryable = isinstance(exc, (RequestShed, CircuitOpen, ServiceClosed))
        schedule_retry = False
        delay = 0.0
        with flight.lock:
            # the retry decision is one atomic read-modify-write: a primary
            # and a hedge twin refusing concurrently must not both pass the
            # budget check at the same attempt value (doubled retries, lost
            # increments) — and a closing fleet must not schedule into a
            # scheduler that is shutting down (the timer would never fire
            # and the client would hang forever)
            if (
                retryable
                and flight.idempotent
                and self._running
                and not flight.retry_scheduled
                and not flight.client.done()
                and not self.backoff.exhausted(flight.attempt)
            ):
                retry_after = getattr(exc, "retry_after_s", None)
                delay = self.backoff.delay(flight.attempt, retry_after_s=retry_after)
                flight.attempt += 1
                flight.retry_scheduled = True
                schedule_retry = True
            else:
                flight.failure = exc
        if schedule_retry:
            with self._lock:
                self._retries += 1
                refusing = self.handles.get(replica_id)
                if refusing is not None:
                    refusing.retries += 1
            if flight.trace is not None:
                # the backoff window is known NOW (the scheduler fires exactly
                # ``delay`` later): record it as a span so the wait the
                # refusal bought is visible on the request's timeline
                self.tracer.add_span(
                    "backoff_wait", self.tracer.now(), delay,
                    trace_id=flight.trace.trace_id, replica=replica_id,
                    attempt=flight.attempt, error=type(exc).__name__,
                )
            self._schedule_flight(delay, flight, lambda: self._fire_retry(flight, exc))
            return
        self._maybe_finalize(flight)

    def _fire_retry(self, flight: _Flight, previous: BaseException) -> None:
        with flight.lock:
            flight.retry_scheduled = False
        if flight.client.done():
            self._maybe_finalize(flight)
            return
        # a replica that refused once is skipped — unless it is the only one
        # left, in which case honoring its retry_after_s and coming back IS
        # the plan (the single-replica degenerate fleet)
        order = self.ring.preference(flight.user_id)
        target = self._pick_target(order, skip=flight.tried)
        if target is None:
            target = self._pick_target(order, skip=())
        if target is None:
            with flight.lock:
                flight.failure = NoHealthyReplica(list(self.handles), cause=previous)
            self._maybe_finalize(flight)
            return
        if target != flight.home:
            with self._lock:
                self._reroutes += 1
            if flight.trace is not None:
                self.tracer.add_span(
                    "failover_reroute", self.tracer.now(), 0.0,
                    trace_id=flight.trace.trace_id, home=flight.home,
                    target=target, retry=True,
                )
        self._launch(flight, target, hedge_eligible=False)
        self._maybe_finalize(flight)

    def _maybe_finalize(self, flight: _Flight) -> None:
        """Fail the client once nothing can still answer it: no in-flight
        inner future, no scheduled hedge/retry, and a recorded failure."""
        with flight.lock:
            if flight.client.done():
                return
            if flight.inflight or flight.scheduled:
                return
            failure = flight.failure
        if failure is not None and self._safe_fail(flight.client, failure):
            with self._lock:
                self._errors += 1

    # -- scheduler ------------------------------------------------------------ #
    def _schedule_flight(self, delay_s: float, flight: _Flight, fn: Callable[[], None]) -> None:
        with flight.lock:
            flight.scheduled += 1

        def fire() -> None:
            with flight.lock:
                flight.scheduled -= 1
            fn()

        self._schedule(delay_s, fire)

    def _schedule(self, delay_s: float, fn: Callable[[], None]) -> None:
        due = self._clock() + max(float(delay_s), 0.0)
        with self._timer_wake:
            if self._running:
                heapq.heappush(self._timers, (due, next(self._timer_seq), fn))
                self._timer_wake.notify()
                return
        # closing: no scheduler will ever fire this — run it inline (by now
        # every path it takes is a fast fail/no-op), so its flight's
        # scheduled-count drops and the client can resolve
        try:
            fn()
        except Exception:  # noqa: BLE001 — resolution is best-effort here
            pass

    def _run_timers(self) -> None:
        while True:
            with self._timer_wake:
                if not self._running and not self._timers:
                    return
                now = self._clock()
                if self._timers and self._timers[0][0] <= now:
                    _, _, fn = heapq.heappop(self._timers)
                else:
                    timeout = (
                        self._timers[0][0] - now if self._timers
                        else (0.1 if not self._running else None)
                    )
                    self._timer_wake.wait(timeout=timeout)
                    continue
            try:
                fn()
            except Exception:  # noqa: BLE001 — a timer must not kill the loop
                pass

    # -- health monitor ------------------------------------------------------- #
    def _run_monitor(self) -> None:
        while self._running:
            try:
                self.poll()
            except Exception:  # noqa: BLE001 — a sweep must never kill the
                pass  # monitor; the next interval retries
            time.sleep(self.heartbeat_interval_s)

    def poll(self) -> None:
        """One health sweep over every replica (the monitor thread's body,
        public so tests and load generators can run health deterministically).

        Race-safe against concurrent :meth:`drain`/:meth:`rejoin`: every
        transition here is CONDITIONAL on the state the sweep observed
        (``expected=``) — if an operator moved the replica meanwhile (e.g.
        into ``draining`` mid-sweep), the gauge-driven transition is simply
        dropped rather than applied to the wrong state or raised on.
        """
        for handle in self.handles.values():
            heartbeat = None
            try:
                heartbeat = handle.service.heartbeat()
            except Exception:  # noqa: BLE001 — an unreachable replica
                heartbeat = None
            with self._health_lock:
                observed = handle.health.state
            alive = bool(heartbeat and heartbeat.get("live"))
            if not alive:
                handle.health.consecutive_heartbeat_misses += 1
                if (
                    handle.health.consecutive_heartbeat_misses >= self.heartbeat_misses
                    and observed != "dead"
                ):
                    self._transition(handle, "dead", "heartbeat", expected=observed)
                continue
            handle.health.consecutive_heartbeat_misses = 0
            if observed == "dead":
                # revival: the ring never dropped it, so its users (and their
                # still-cached states) come straight back. The error-window
                # counters re-anchor to the CURRENT totals — the dying burst
                # must not be judged as the freshly-healthy replica's first
                # window (it would re-degrade it on stale history)
                handle.last_requests = float(heartbeat.get("requests") or 0.0)
                handle.last_errors = float(heartbeat.get("errors") or 0.0)
                self._transition(handle, "healthy", "revived", expected=observed)
                continue
            reason = self._degrade_reason(handle, heartbeat)
            if observed == "draining":
                continue  # drain/rejoin are operator-driven, not gauge-driven
            if reason and observed == "healthy":
                self._transition(handle, "degraded", reason, expected=observed)
            elif not reason and observed == "degraded":
                self._transition(handle, "healthy", "recovered", expected=observed)

    def _degrade_reason(self, handle: ReplicaHandle, heartbeat: Mapping[str, Any]) -> Optional[str]:
        """The replica's own exporter gauges, folded into one verdict. The
        error-rate window counters advance on EVERY call — including ones
        that return a breaker/lane-depth verdict — so a later error-rate
        evaluation never judges a window stretching back through an entire
        breaker-open episode."""
        requests = float(heartbeat.get("requests") or 0.0)
        errors = float(heartbeat.get("errors") or 0.0)
        window_requests = requests - handle.last_requests
        window_errors = errors - handle.last_errors
        handle.last_requests = requests
        handle.last_errors = errors
        breaker = heartbeat.get("breaker_state")
        if breaker and breaker != "closed":
            return f"breaker_{breaker}"
        queued = heartbeat.get("queued")
        max_depth = heartbeat.get("max_depth")
        if queued is not None and max_depth:
            if float(queued) >= self.degrade_depth_fraction * float(max_depth):
                return "lane_depth"
        if window_requests >= 8 and window_errors / window_requests > self.degrade_error_rate:
            return "error_rate"
        return None

    def _transition(
        self,
        handle: ReplicaHandle,
        to: str,
        reason: str,
        expected: Optional[str] = None,
    ) -> None:
        """Apply one health transition under the health lock. ``expected``
        makes it conditional: when the replica's state is no longer what the
        caller decided on (a concurrent drain/rejoin won the race), the
        transition is dropped — gauge-driven sweeps must never override an
        operator's move or trip the legality table on a stale read."""
        with self._health_lock:
            if expected is not None and handle.health.state != expected:
                return
            changed = handle.health.transition(to, reason)
        if not changed:
            return
        record = handle.health.transitions[-1]
        self._emit(
            "on_replica_health",
            {
                "replica": handle.replica_id,
                "from": record["from"],
                "to": to,
                "reason": reason,
            },
        )
        if to == "dead":
            with self._lock:
                self._failovers += 1
            self._emit(
                "on_failover",
                {
                    "replica": handle.replica_id,
                    "reason": reason,
                    # ~the slice of users now served downstream (consistent
                    # hashing: one replica's arcs, not a full reshuffle)
                    "users_fraction": 1.0 / max(len(self.handles), 1),
                },
            )

    # -- drain / rollout ------------------------------------------------------ #
    def drain(self, replica_id: str, timeout_s: float = 30.0) -> bool:
        """Stop routing NEW traffic to ``replica_id`` and wait for its lanes
        to empty (queued AND in-flight). Returns whether it fully drained
        within ``timeout_s`` — either way no waiter is orphaned: undrained
        work still resolves through the replica's own dispatch/close path."""
        handle = self.handles[replica_id]
        self._transition(handle, "draining", "drain")
        deadline = self._clock() + float(timeout_s)
        while self._clock() < deadline:
            if self._replica_idle(handle):
                return True
            time.sleep(0.002)
        return self._replica_idle(handle)

    @staticmethod
    def _replica_idle(handle: ReplicaHandle) -> bool:
        batcher = getattr(handle.service, "batcher", None)
        if batcher is None:
            return True
        idle = getattr(batcher, "idle", None)
        if idle is not None:
            return bool(idle)
        return batcher.queued_depth() == 0

    def rejoin(self, replica_id: str) -> None:
        """Return a drained (or revived-from-drain) replica to service."""
        self._transition(self.handles[replica_id], "healthy", "rejoin")

    def drain_and_swap(
        self,
        replica_id: str,
        params,
        label: str = "",
        pipeline=None,
        timeout_s: float = 30.0,
    ) -> Dict[str, Any]:
        """The zero-downtime rollout step for ONE replica: drain → publish +
        promote (the hot-swap path: a pointer move for same-shape
        params) → rejoin. The rest of the fleet keeps serving throughout —
        the drained replica's users ride their failover order meanwhile."""
        handle = self.handles[replica_id]
        drained = self.drain(replica_id, timeout_s=timeout_s)
        try:
            generation = handle.service.publish_candidate(
                params, label=label or f"fleet-swap-{replica_id}", pipeline=pipeline
            )
            handle.service.promote(generation)
        except Exception:
            # a failed swap must not strand the replica out of rotation:
            # restore traffic on the OLD generation (zero downtime means the
            # rollout fails, not the replica) and surface the error
            self.rejoin(replica_id)
            raise
        self.rejoin(replica_id)
        return {
            "replica": replica_id,
            "drained": bool(drained),
            "generation": int(generation),
        }

    def rolling_swap(
        self,
        params,
        label: str = "",
        pipeline_factory: Optional[Callable[[str], Any]] = None,
        timeout_s: float = 30.0,
    ) -> List[Dict[str, Any]]:
        """Fleet-wide zero-downtime rollout: :meth:`drain_and_swap` each
        replica in turn (one out of rotation at a time — the fleet never
        loses more than one replica's capacity to the rollout). DEAD
        replicas are skipped, not drained (an illegal dead→draining
        transition would abort the rollout mid-fleet): a skipped replica
        revives on its OLD generation and the operator re-runs the swap for
        it once it is back."""
        results = []
        for replica_id in sorted(self.handles):
            with self._health_lock:
                state = self.handles[replica_id].health.state
            if state == "dead":
                results.append({"replica": replica_id, "skipped": "dead"})
                continue
            pipeline = pipeline_factory(replica_id) if pipeline_factory else None
            results.append(
                self.drain_and_swap(
                    replica_id, params, label=label, pipeline=pipeline,
                    timeout_s=timeout_s,
                )
            )
        return results

    # -- accounting ----------------------------------------------------------- #
    def health(self) -> Dict[str, str]:
        with self._health_lock:
            return {rid: handle.health.state for rid, handle in self.handles.items()}

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            p50 = self._latency_ms.quantile(0.5)
            p99 = self._latency_ms.quantile(0.99)
            out = {
                "replicas": len(self.handles),
                "requests": self._requests,
                "answered": self._answered,
                "errors": self._errors,
                "reroutes": self._reroutes,
                "retries": self._retries,
                "hedges": self._hedges,
                "hedge_wins": self._hedge_wins,
                "hedge_cancelled": self._hedge_cancelled,
                "failovers": self._failovers,
                "no_healthy_refusals": self._no_healthy_refusals,
                "reroute_rate": self._reroutes / self._requests if self._requests else 0.0,
                "error_rate": self._errors / self._requests if self._requests else 0.0,
                "p50_ms": p50,
                "p99_ms": p99,
                "per_replica": {
                    rid: {
                        "routed": handle.routed,
                        "answered": handle.answered,
                        "hedges": handle.hedges,
                        "hedge_wins": handle.hedge_wins,
                        "hedge_cancelled": handle.hedge_cancelled,
                        "retries": handle.retries,
                    }
                    for rid, handle in self.handles.items()
                },
                # slowest-N answered requests with their trace ids (the
                # exemplar store riding the latency histogram) — the
                # report's / bench record's link from "p99 is slow" to the
                # exact traces that made it slow
                "latency_exemplars": [
                    {"latency_ms": e["value"], "trace_id": e["trace_id"]}
                    for e in self._latency_ms.exemplars()
                ],
            }
        with self._health_lock:
            for rid, handle in self.handles.items():
                out["per_replica"][rid].update(
                    {
                        "health": handle.health.state,
                        "health_reason": handle.health.reason,
                        "health_transitions": handle.health.transition_count,
                    }
                )
        # the quality plane, one level up (obs.quality): replicas that carry a
        # QualityMonitor surface their pure-JSON snapshots, plus the fleet-
        # level join-weighted online hitrate and worst drift PSI — the fleet
        # analog of the single-service stats()["quality"] block. In-process
        # replicas only: a remote replica's quality rides its own /snapshot
        per_replica_quality: Dict[str, Any] = {}
        for rid, handle in self.handles.items():
            monitor = getattr(handle.service, "quality", None)
            if monitor is None:
                continue
            try:
                per_replica_quality[rid] = monitor.snapshot()
            except Exception:  # noqa: BLE001 — telemetry must not fail stats
                continue
        if per_replica_quality:
            joins = 0
            hits = 0.0
            psi_values = []
            for snap in per_replica_quality.values():
                stable = (snap.get("roles") or {}).get("stable") or {}
                replica_joins = int(stable.get("joins") or 0)
                hitrate = stable.get("online_hitrate_cum")
                if replica_joins and hitrate is not None:
                    joins += replica_joins
                    hits += float(hitrate) * replica_joins
                psi = (snap.get("drift") or {}).get("max")
                if psi is not None:
                    psi_values.append(float(psi))
            out["quality"] = {
                "per_replica": per_replica_quality,
                "joins": joins,
                "online_hitrate_cum": hits / joins if joins else None,
                "drift_psi_max": max(psi_values) if psi_values else None,
            }
        return out

    # -- helpers -------------------------------------------------------------- #
    def _emit(self, event: str, payload: Dict[str, Any]) -> None:
        if self.logger is not None:
            self.logger.log_event(TrainerEvent(event=event, payload=payload))

    # shared with ScoringService: serve.futures
    _safe_fail = staticmethod(safe_fail)
    _safe_set_result = staticmethod(safe_set_result)
