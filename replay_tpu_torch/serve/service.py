"""The scoring service: micro-batched, state-cached, rank-fused.

Counterpart of ``replay_tpu/serve/service.py::ScoringService``. Orchestrates
the serve subsystem end to end::

    client threads ──submit()──▶ MicroBatcher lanes ──▶ serve worker
                                                        ├─ encode lane: window
                                                        │  batch → CompiledInference
                                                        │  bucket (kernel K4 or K5)
                                                        ├─ hit lane: cached [E]
                                                        │  states → hidden scorer
                                                        └─ retrieval: MIPS top-C
                                                           → re-rank → top-k

Three serving modes, fixed at construction:

* **full** (default): responses carry full-catalog scores, an exact host
  top-k cut, or exact gathers for per-request candidate lists.
* **slate** (``candidates=...``): every response scores one fixed candidate
  slate.
* **retrieval** (``retrieval=CandidatePipeline(...)``): the fused
  candidate→rank path — full-catalog logits never materialize.

Parity contract (``tests/_torch/test_torch_service.py``; ``chip_smoke.py``'s
``service`` phase on the card): within one (length, batch) bucket, a
response's scores are bitwise independent of the fill level, the co-riding
requests' content and the row order, so micro-batching and caching never
change a score; an advance is bitwise equal to a full re-encode of the same
window, and the cache-only rung to the pure-hit path. Every response carries
its ``batch_bucket``. On the card this rests on kernel K4 handling each
(batch row, head) pair alone and on each padded bucket shape running one
fixed sequence of kernels.

Resilience: admission control bounds every lane's queue (``max_queue_depth``
— beyond it, futures fail fast with :class:`RequestShed`); per-request
``deadline_ms`` budgets are enforced at batch-build time so expired waiters
never reach the device; consecutive engine failures open a
:class:`CircuitBreaker` over the encode path; and under an open breaker or a
saturated lane, traffic walks the degradation ladder — cache-only scoring
(the hit lane, encode skipped), then the host-side :class:`FallbackScorer`
floor. Every response's ``served_by`` names its rung; ``served_by ==
"primary"`` responses keep the full parity contract. The ladder is the JAX
service's feature for a faulty engine or an overload, never a way round a
missing device: the service runs where its engine runs, ``"cuda"`` unless
the caller asks for the CPU.

Threads: client threads resolve requests (host numpy only); ONE serve worker
runs every device call, under ``torch.inference_mode()`` of its own (gradient
mode is per thread), on its one CUDA stream, and copies each batch's results
to the host once (never per row).

Observability: requests record ``queue_wait`` spans (cross-thread, via
``obs.trace.lifecycle_span``), batches record ``batch_build``/``score`` and
the pipeline's ``retrieve``/``rerank`` spans; ``on_serve_start`` /
``on_serve_batch`` / ``on_serve_end`` events flow through any
:class:`~replay_tpu_torch.obs.RunLogger` — joined by ``on_shed`` /
``on_breaker`` / ``on_degrade`` from the resilience layer — and
``on_serve_end`` carries the serve goodput breakdown (``SERVE_GOODPUT_SPANS``
fractions, summing to 1.0).

The same event fan-out feeds the service's four optional planes, as in the
JAX service: the live metrics registry and its ``/metrics`` endpoint
(``metrics_port``), SLO rules evaluated at batch cadence (``slo_rules``), the
model-quality monitor (``quality``) and the SIGKILL-proof flight ring
(``flight_path``). None of them touches the device.
"""

from __future__ import annotations

import contextlib
import copy
import logging
import os
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from typing import Any, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from replay_tpu_torch.device import DeviceLike
from replay_tpu_torch.nn.compiled import as_device_tensor, pad_rows, to_device_params
from replay_tpu_torch.nn.embedding import fit_tables
from replay_tpu_torch.obs import TrainerEvent, Tracer
from replay_tpu_torch.obs.trace import SERVE_GOODPUT_SPANS, goodput_breakdown, lifecycle_span

from .batcher import MicroBatcher
from .breaker import CircuitBreaker
from .cache import UserState, UserStateCache
from .degrade import FallbackScorer
from .engine import ScoringEngine
from .errors import CircuitOpen, DeadlineExceeded, RequestShed
from .futures import mark_running, safe_fail, safe_set_result
from .pipeline import CandidatePipeline
from .promote import ROLES, ParamStore, in_canary_slice
from .request import PendingRequest, ScoreRequest, ScoreResponse, make_window

logger = logging.getLogger("replay_tpu_torch")


class ScoringService:
    """Thread-safe online scoring over a trained sequential model.

    Resilience knobs (see docs/serving.md for tuning guidance):

    :param max_queue_depth: per-lane queued-request bound. ``None`` (default)
        sizes it automatically at ``16 x`` the largest batch bucket; ``0``
        disables the bound (the pre-resilience unbounded behavior).
    :param default_deadline_ms: end-to-end budget applied to requests that
        don't carry their own ``deadline_ms``. ``None`` = no default deadline.
    :param breaker: the engine :class:`CircuitBreaker`; ``None`` builds one
        with defaults. Its ``on_transition`` is wired to ``on_breaker`` events.
    :param fallback: optional :class:`FallbackScorer` — the degradation
        ladder's host-side floor. Without it, requests that can't be absorbed
        by cache-only scoring fail fast (:class:`CircuitOpen` under an open
        breaker, :class:`RequestShed` under overload).
    :param cold_miss: what a state-less request (unknown user, no
        ``history``) gets. ``"error"`` (default) keeps the original contract
        — the future fails with ``KeyError`` naming the cold path. With
        ``"fallback"`` (and a ``fallback`` scorer attached) it rides the
        degradation ladder's floor instead: the fleet-failover setting, where
        a rerouted user's cache is cold on the new replica by construction
        and a generic answer beats an error (``served_by == "fallback"``
        keeps the degradation visible). ``new_items`` requests error in BOTH
        modes — an interaction that cannot land must never be masked by a
        success response.
    :param metrics_port: serve a live Prometheus ``/metrics`` endpoint (+
        ``/snapshot`` JSON) for the service's lifetime — qps, batch fill,
        queue-wait histograms, shed/degrade/breaker counters bridged from the
        serve event stream. ``0`` binds an ephemeral port (read
        :attr:`metrics_exporter`); a busy port degrades to a logged no-op.
    :param slo_rules: :class:`~replay_tpu_torch.obs.SLORule` set evaluated
        after every dispatched batch; breaches emit ``on_slo_violation``
        through the attached ``logger`` and count in the registry.
    :param flight_path: record every serve event into a SIGKILL-proof mmap
        flight ring (:mod:`replay_tpu_torch.obs.blackbox`) at this path.
        Defaults to ``$REPLAY_TPU_FLIGHT_PATH`` when set. A SIGKILLed
        replica's last batches, sheds and breaker flips stay readable via
        ``read_flight`` — the evidence ``obs.report --postmortem``
        reconstructs.
    :param quality: a :class:`~replay_tpu_torch.obs.QualityMonitor` watching
        every resolved response (online prequential hitrate/NDCG, coverage,
        novelty, drift); its gauges ride the same registry and
        ``stats()["quality"]`` returns its snapshot. A monitor that raises
        is detached; the responses keep flowing.
    :param device: where the engine and its programs run; ``"cuda"`` unless
        the caller asks for the CPU (``device="cpu"``, as the tests do).
    """

    def __init__(
        self,
        model,
        params,
        length_buckets: Optional[Sequence[int]] = None,
        batch_buckets: Sequence[int] = (1, 8, 64),
        max_wait_ms: float = 2.0,
        cache_capacity: int = 10_000,
        candidates: Optional[Sequence[int]] = None,
        retrieval: Optional[CandidatePipeline] = None,
        feature_name: str = "item_id",
        pad_id: int = 0,
        tracer: Optional[Tracer] = None,
        logger=None,
        trace_path: Optional[str] = None,
        max_queue_depth: Optional[int] = None,
        default_deadline_ms: Optional[float] = None,
        breaker: Optional[CircuitBreaker] = None,
        fallback: Optional[FallbackScorer] = None,
        metrics_port: Optional[int] = None,
        slo_rules: Optional[Sequence[Any]] = None,
        param_store: Optional[ParamStore] = None,
        cold_miss: str = "error",
        flight_path: Optional[str] = None,
        quality: Optional[Any] = None,
        device: DeviceLike = "cuda",
    ) -> None:
        if retrieval is not None and candidates is not None:
            msg = "retrieval mode and a fixed candidate slate are mutually exclusive"
            raise ValueError(msg)
        if cold_miss not in ("error", "fallback"):
            msg = f"cold_miss must be 'error' or 'fallback', got {cold_miss!r}"
            raise ValueError(msg)
        self.cold_miss = cold_miss
        self.mode = (
            "retrieval" if retrieval is not None
            else "slate" if candidates is not None
            else "full"
        )
        self.retrieval = retrieval
        self.pad_id = int(pad_id)
        self._model = model
        self._feature_name = feature_name
        self.tracer = tracer if tracer is not None else Tracer(enabled=False)
        self.logger = logger
        self.trace_path = trace_path
        self.default_deadline_ms = default_deadline_ms
        self.engine = ScoringEngine(
            model,
            params,
            length_buckets=length_buckets,
            batch_buckets=batch_buckets,
            candidates=np.asarray(candidates, np.int32) if candidates is not None else None,
            feature_name=feature_name,
            outputs="hidden" if retrieval is not None else "both",
            device=device,
        )
        self.cache = UserStateCache(cache_capacity)
        # versioned parameter generations (serve.promote): generation 0 is the
        # construction params; candidates publish through publish_candidate
        # and swap in atomically via promote()/rollback()
        self.store = (
            param_store
            if param_store is not None
            else ParamStore(self.engine.params, pipeline=retrieval)
        )
        # active canary routing: (candidate generation, traffic fraction);
        # None = all traffic on the stable generation. The epoch counts
        # begin_canary calls so accounting can tell THIS canary's traffic
        # from a previous candidate's late-landing in-flight requests
        self._canary: Optional[Tuple[int, float]] = None
        self._canary_epoch = 0
        self.breaker = breaker if breaker is not None else CircuitBreaker()
        # chain, don't clobber: a caller-supplied on_transition (alerting
        # hooks etc.) keeps firing after the service's event forwarding
        self._chained_transition = self.breaker.on_transition
        self.breaker.on_transition = self._on_breaker_transition
        self.fallback = fallback
        if max_queue_depth is None:
            max_queue_depth = 16 * max(self.engine.batch_buckets)
        self.batcher = MicroBatcher(
            dispatch=self._dispatch,
            capacity=max(self.engine.batch_buckets),
            max_wait=max_wait_ms / 1000.0,
            on_error=self._on_dispatch_error,
            max_depth=max_queue_depth if max_queue_depth else None,
        )
        self._count_lock = threading.Lock()
        self._requests = 0
        self._errors = 0
        self._shed = 0
        self._deadline_misses = 0
        self._cancelled = 0
        self._circuit_refusals = 0
        self._served_from: Dict[str, int] = {
            "hit": 0, "advance": 0, "cold": 0, "fallback": 0
        }
        self._served_by: Dict[str, int] = {"primary": 0, "cache_only": 0, "fallback": 0}
        # per-traffic-role accounting (stable vs canary candidate): the raw
        # material PromotionController folds into replay_canary_* gauges
        self._role_stats: Dict[str, Dict[str, float]] = {
            role: self._fresh_role_stats() for role in ROLES
        }
        # hot-swap staleness accounting: submit-time embedding misses (cached
        # state encoded by an older generation) and dispatch-time re-routes
        # (the generation moved between submit and batch build)
        self._generation_misses = 0
        self._generation_reroutes = 0
        # key -> (last_emit_time, pending_count, event, payload); pending
        # counts are flushed by the key's next post-window emit or at close()
        self._throttle: Dict[str, Tuple[float, int, str, Dict[str, Any]]] = {}
        self._queue_wait_sum = 0.0
        self._queue_wait_max = 0.0
        self._goodput_t0: Dict[str, float] = {}
        self._wall_t0 = 0.0
        self._started = False
        # live metrics plane (obs.metrics / obs.exporter / obs.slo): the
        # service's own event stream bridged into a scrapeable registry —
        # no new instrumentation hooks, the _emit fan-out IS the bridge
        self.metrics_registry = None
        self.metrics_exporter = None
        self._metrics_logger = None
        if metrics_port is not None or slo_rules:
            from replay_tpu_torch.obs.exporter import MetricsExporter
            from replay_tpu_torch.obs.metrics import MetricsLogger
            from replay_tpu_torch.obs.slo import SLOWatchdog

            self._metrics_logger = MetricsLogger()
            self.metrics_registry = self._metrics_logger.registry
            if slo_rules:
                self._metrics_logger.watchdog = SLOWatchdog(
                    slo_rules, self.metrics_registry, emit=self._route_event
                )
            if metrics_port is not None:
                # the structured /healthz (format=json) serves the heartbeat
                # document, so a REMOTE fleet monitor can drive ReplicaHealth
                # from a pure scrape of this port (serve.remote)
                self.metrics_exporter = MetricsExporter(
                    self.metrics_registry,
                    port=metrics_port,
                    health_source=self.heartbeat,
                )
        # quality plane (obs.quality): same zero-new-hooks pattern — the
        # monitor watches resolved responses and emits on_quality_window /
        # on_drift_warning back through THIS service's _emit fan-out, so its
        # gauges ride the existing metrics bridge, exporter and SLO watchdog
        self.quality = quality
        if quality is not None:
            quality.bind(self._emit, self._emit_throttled)
        # flight recorder (obs.blackbox): same attach-the-sink pattern — the
        # _emit fan-out carries every serve event into the SIGKILL-proof ring
        self._blackbox = None
        flight_path = flight_path or os.environ.get("REPLAY_TPU_FLIGHT_PATH")
        if flight_path:
            from replay_tpu_torch.obs.blackbox import BlackboxLogger

            try:
                self._blackbox = BlackboxLogger(
                    flight_path,
                    meta={"role": "serve", "pid": os.getpid(), "mode": self.mode},
                )
            except OSError as exc:
                logger.warning(
                    "flight recorder: cannot open %s (%s); service runs unrecorded",
                    flight_path, exc,
                )

    # -- lifecycle ---------------------------------------------------------- #
    def start(self) -> "ScoringService":
        if self._started:
            return self
        self._started = True
        self._goodput_t0 = self.tracer.snapshot()
        self._wall_t0 = self.tracer.wall_seconds()
        if self.metrics_exporter is not None:
            self.metrics_exporter.start()
        self.batcher.start()
        self._emit(
            "on_serve_start",
            {
                "mode": self.mode,
                "length_buckets": list(self.engine.length_buckets),
                "batch_buckets": list(self.engine.batch_buckets),
                "max_wait_ms": self.batcher.max_wait * 1000.0,
                "cache_capacity": self.cache.capacity,
                "max_queue_depth": self.batcher.max_depth,
                "default_deadline_ms": self.default_deadline_ms,
                "fallback": self.fallback is not None,
            },
        )
        return self

    def close(self) -> None:
        """Stop the service. Every still-pending future is RESOLVED before
        this returns — flushed through the engine when the worker is healthy,
        failed with a real exception when it is not (never left to hang).
        Then the engines free their CUDA graphs and memory pools."""
        if not self._started:
            return
        self.batcher.stop()
        self._started = False
        if self.quality is not None:
            # partial windows land before the terminal event — the last
            # quality gauges are in the registry when on_serve_end snapshots
            try:
                self.quality.flush()
            except Exception:  # noqa: BLE001 — telemetry must not fail close
                pass
        self._flush_throttled()
        payload = dict(self.stats())
        snapshot = self.tracer.snapshot()
        diff = {
            name: snapshot.get(name, 0.0) - self._goodput_t0.get(name, 0.0)
            for name in set(snapshot) | set(self._goodput_t0)
        }
        payload["goodput"] = goodput_breakdown(
            diff,
            self.tracer.wall_seconds() - self._wall_t0,
            spans=SERVE_GOODPUT_SPANS,
        )
        self._emit("on_serve_end", payload)
        if self.trace_path and self.tracer.enabled:
            self.tracer.save(self.trace_path)
        if self._blackbox is not None:
            # one msync after the terminal event — durability against machine
            # loss; SIGKILL durability never depended on this close landing
            self._blackbox.close()
        if self.metrics_exporter is not None:
            # after the terminal event: the final gauges (hit rate, shed
            # rate) land in the registry before the endpoint disappears, and
            # registry/snapshot stay readable on metrics_registry afterwards
            self.metrics_exporter.close()
        # the engines' CUDA graphs and pools: a restarted service captures anew
        for engine in {id(e): e for e in (self.engine, *self.store.engines())}.values():
            engine.close()

    def __enter__(self) -> "ScoringService":
        return self.start()

    def __exit__(self, *exc_info) -> None:
        self.close()

    # -- client API --------------------------------------------------------- #
    def submit(
        self,
        user_id: Hashable,
        history: Optional[Sequence[int]] = None,
        new_items: Sequence[int] = (),
        k: Optional[int] = None,
        candidates: Optional[Sequence[int]] = None,
        deadline_ms: Optional[float] = None,
        _role: Optional[str] = None,
        _trace: Optional[dict] = None,
    ) -> "Future[ScoreResponse]":
        """Enqueue one scoring request; resolves to a :class:`ScoreResponse`.

        Never blocks and never hangs: admission refusals (a full lane, an open
        breaker with no degraded mode available) fail the returned future
        immediately with :class:`RequestShed` / :class:`CircuitOpen`, and a
        ``deadline_ms`` budget (default: the service's ``default_deadline_ms``)
        drops the request at batch-build time once expired.

        ``_role`` forces the traffic-slice routing ("stable"/"candidate") —
        the shadow-stage probe seam; normal traffic routes by the canary's
        deterministic hash slice.

        ``_trace`` is the fleet router's distributed-trace context (the
        pure-JSON ``TraceContext.to_json()`` payload): when present, this
        request's replica-side spans — ``queue_wait``, its batch's
        build/score window, a fallback answer — carry its trace_id, so the
        merged fleet trace shows the request's replica time on its own
        timeline. ``None`` (untraced/direct traffic) changes nothing.
        """
        future: "Future[ScoreResponse]" = Future()
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms
        request = ScoreRequest(
            user_id=user_id,
            history=history,
            new_items=tuple(new_items),
            k=k,
            candidates=candidates,
            deadline_ms=deadline_ms,
        )
        role = _role if _role is not None else self._role_for(user_id)
        with self._count_lock:
            self._requests += 1
            self._role_stats[role]["requests"] += 1
        expires_at = (
            time.perf_counter() + deadline_ms / 1000.0
            if deadline_ms is not None  # 0.0 = already expired, NOT no-deadline
            else None
        )
        try:
            resolved = self._resolve(request, future, role, trace=_trace)
            if resolved is None:  # answered inline by the fallback floor
                return future
            lane, pending = resolved
            pending.expires_at = expires_at
            self._submit_pending(lane, pending)
        except CircuitOpen as exc:
            with self._count_lock:
                self._circuit_refusals += 1
            self._safe_fail(future, exc)
        except Exception as exc:  # noqa: BLE001 — surface through the future
            with self._count_lock:
                self._errors += 1
                self._role_stats[role]["errors"] += 1
            self._safe_fail(future, exc)
        return future

    def _submit_pending(self, lane, pending: PendingRequest) -> None:
        """Enqueue a resolved pending on its lane, walking the overload
        absorption ladder on a shed (shared by submit and the dispatch-time
        generation re-route)."""
        pending.canary_epoch = self._canary_epoch
        try:
            self.batcher.submit(lane, pending)
            self._emit_degraded(pending)
        except RequestShed as shed:
            if not self._absorb_overload(lane, pending, shed):
                with self._count_lock:
                    self._shed += 1
                    self._role_stats[pending.role]["shed"] += 1
                self._emit_throttled(
                    f"shed:{self._lane_name(lane)}",
                    "on_shed",
                    {
                        "lane": self._lane_name(lane),
                        "depth": shed.depth,
                        "max_depth": shed.max_depth,
                        "retry_after_s": shed.retry_after_s,
                    },
                )
                self._safe_fail(pending.future, shed)

    def score(self, user_id, timeout: Optional[float] = 60.0, **kwargs) -> ScoreResponse:
        """Synchronous :meth:`submit`.

        ``timeout`` doubles as the request's ``deadline_ms`` (unless one was
        passed explicitly), and a timed-out wait CANCELS the request so the
        batch builder skips it — an abandoned waiter never costs a scoring
        slot (the serving analog of the cache's stale-refresh drop).
        """
        if timeout is not None and "deadline_ms" not in kwargs:
            kwargs["deadline_ms"] = timeout * 1000.0
        future = self.submit(user_id, **kwargs)
        try:
            return future.result(timeout=timeout)
        except FutureTimeoutError:
            future.cancel()
            raise

    # -- promotion / hot-swap API (serve.promote) ---------------------------- #
    @staticmethod
    def _fresh_role_stats() -> Dict[str, float]:
        return {
            "requests": 0.0,
            "answered": 0.0,
            "errors": 0.0,
            "shed": 0.0,
            "queue_wait_ms_sum": 0.0,
            "queue_wait_ms_max": 0.0,
        }

    def _role_for(self, user_id: Hashable) -> str:
        canary = self._canary
        if canary is None:
            return "stable"
        _, fraction = canary
        return "candidate" if in_canary_slice(user_id, fraction) else "stable"

    def _generation_for(self, role: str):
        """The generation serving ``role`` RIGHT NOW. Candidate traffic under
        an active canary resolves the canary's PINNED generation — a
        publish_candidate racing the canary must not silently redirect the
        slice to an unvetted generation; outside a canary, the candidate role
        is the shadow-probe seam and resolves the store's candidate (falling
        back to stable)."""
        if role == "candidate":
            canary = self._canary
            if canary is not None:
                try:
                    return self.store.generation(canary[0])
                except KeyError:  # canary generation evicted: serve stable
                    return self.store.resolve("stable")
        return self.store.resolve(role)

    def publish_candidate(
        self, params, label: str = "", pipeline: Optional[CandidatePipeline] = None
    ) -> int:
        """Register a candidate parameter generation (not yet serving).

        Same-shape params (the common continual-finetune case) share the
        running programs — no rebuild, the swap is a pointer move. A changed
        catalog shape (a grown item table) builds a dedicated engine HERE, on
        the caller's thread, while the serve worker keeps answering from the
        current generation. Retrieval-mode services
        must pass the candidate's own :class:`CandidatePipeline` (its MIPS
        index embeds the item table, so it is per-generation by construction).
        """
        if self.mode == "retrieval" and pipeline is None:
            msg = (
                "retrieval-mode candidates need their own CandidatePipeline "
                "(the MIPS index embeds the generation's item table)"
            )
            raise ValueError(msg)
        # land the candidate on the device ONCE at publish (dtypes preserved)
        # — every dispatch then passes resident tensors instead of paying a
        # host->device copy per batch
        params = to_device_params(params, self.engine.device)
        mismatch = self.engine.validate_params(params)
        if mismatch is None:
            generation = self.store.publish(
                params, label=label, pipeline=pipeline, recompiled=False
            )
            reason = None
        else:
            # shape change: a fresh engine, built off the serve worker, on a
            # copy of the model whose item tables take the candidate's size
            model = copy.deepcopy(self._model)
            fit_tables(model, params)
            engine = ScoringEngine(
                model,
                params,
                length_buckets=self.engine.length_buckets,
                batch_buckets=self.engine.batch_buckets,
                candidates=self.engine.candidates,
                feature_name=self._feature_name,
                outputs=self.engine.outputs,
                device=self.engine.device,
            )
            generation = self.store.publish(
                params, label=label, pipeline=pipeline, engine=engine,
                recompiled=True,
            )
            reason = mismatch
        self._emit(
            "on_publish",
            {
                "generation": generation,
                "label": label,
                "recompiled": reason is not None,
                "recompile_reason": reason,
            },
        )
        return generation

    def begin_canary(self, generation: int, fraction: float) -> None:
        """Route the deterministic ``fraction`` slice of users to
        ``generation`` (which must be resident in the store)."""
        self.store.generation(generation)  # raises when not resident
        with self._count_lock:
            # a canary window starts with clean candidate counters AND a new
            # epoch, so its evaluations never read a previous candidate's
            # traffic — including in-flight requests stamped before the reset
            self._role_stats["candidate"] = self._fresh_role_stats()
            self._canary = (int(generation), float(fraction))
            self._canary_epoch += 1
        self._emit(
            "on_canary_start", {"generation": generation, "fraction": fraction}
        )

    def end_canary(self) -> None:
        with self._count_lock:
            self._canary = None

    def promote(self, generation: Optional[int] = None) -> Dict[str, Any]:
        """Atomically swap ``generation`` (default: the candidate) in as the
        stable serving params; the outgoing generation stays pinned as the
        rollback target. In-flight batches finish on the generation they
        resolved — no torn reads."""
        info = self.store.promote(generation)
        self.end_canary()
        self._swap_event("promote", info)
        return info

    def rollback(self) -> Dict[str, Any]:
        """Atomically restore the pinned previous generation (bad swap /
        breached canary)."""
        info = self.store.rollback()
        self.end_canary()
        self._swap_event("rollback", info)
        return info

    def _swap_event(self, reason: str, info: Dict[str, Any]) -> None:
        try:
            recompiled = self.store.generation(info["to_generation"]).recompiled
        except KeyError:
            recompiled = None
        self._emit(
            "on_swap",
            {
                "reason": reason,
                "from_generation": info["from_generation"],
                "to_generation": info["to_generation"],
                "recompiled": recompiled,
            },
        )

    def canary_stats(self) -> Dict[str, Dict[str, float]]:
        """Cumulative per-role counters (stable vs candidate) with derived
        mean queue wait — the PromotionController's evaluation input."""
        with self._count_lock:
            out = {role: dict(stats) for role, stats in self._role_stats.items()}
        for stats in out.values():
            answered = stats["answered"]
            stats["queue_wait_ms_mean"] = (
                stats["queue_wait_ms_sum"] / answered if answered else 0.0
            )
        return out

    def generation_history(self) -> List[Dict[str, Any]]:
        """The store's publish/promote/rollback log (pure JSON artifact)."""
        return self.store.history()

    # -- request resolution (client thread) --------------------------------- #
    def _resolve(
        self,
        request: ScoreRequest,
        future: "Future[ScoreResponse]",
        role: str = "stable",
        trace: Optional[dict] = None,
    ) -> Optional[Tuple[Hashable, PendingRequest]]:
        """Route a request to a (lane, pending) — or answer it inline
        (fallback floor, returning None). ``trace`` (the fleet's JSON trace
        context) rides on whatever pending this resolves to."""
        if request.candidates is not None and self.mode != "full":
            msg = (
                f"per-request candidates need the full-scoring service "
                f"(this one runs in {self.mode!r} mode)"
            )
            raise ValueError(msg)
        if request.k is not None and self.retrieval is not None:
            if request.k > self.retrieval.top_k:
                msg = (
                    f"k={request.k} exceeds the pipeline's compiled "
                    f"top_k={self.retrieval.top_k}"
                )
                raise ValueError(msg)
        max_len = self.engine.max_sequence_length

        if request.history is not None:
            # the exact-parity fallback: an explicit history always wins and
            # re-anchors the cached state
            items = list(request.history) + list(request.new_items)
            if not items:
                msg = "empty history"
                raise ValueError(msg)
            window, mask, length = make_window(items, max_len, self.pad_id)
            previous = self.cache.peek(request.user_id)
            state = UserState(
                window=window,
                mask=mask,
                length=length,
                embedding=None,
                generation=previous.generation + 1 if previous else 0,
            )
            self.cache.store(request.user_id, state)
            return self._encode_or_degrade(
                request, future, state, "cold", previous, role, trace=trace
            )

        if request.new_items:
            # atomic lookup+advance+store: concurrent appends for one user
            # must both land (an unlocked read-modify-write would let the
            # last store erase the other's interaction). The pre-advance
            # embedding is peeked first: it is the cache_only rung's material
            # if the encode path is down (the interaction still lands either
            # way — degradation never loses the event)
            previous = self.cache.peek(request.user_id)
            advanced = self.cache.advance_user(
                request.user_id, request.new_items, self.pad_id
            )
            if advanced is None:
                return self._cold_miss(request, future, role, trace=trace)
            return self._encode_or_degrade(
                request, future, advanced, "advance", previous, role, trace=trace
            )
        state = self.cache.lookup(request.user_id)
        if state is None:
            return self._cold_miss(request, future, role, trace=trace)
        if state.embedding is not None:
            # hot-swap staleness guard (serve.promote): an embedding encoded
            # by an older parameter generation must never be scored through
            # the current generation's scorer — a generation mismatch is a
            # MISS and the cached window re-encodes instead
            current_generation = self._generation_for(role).number
            if state.param_generation != current_generation:
                with self._count_lock:
                    self._generation_misses += 1
            else:
                pending = PendingRequest(
                    request=request,
                    future=future,
                    served_from="hit",
                    embedding=state.embedding,
                    length=state.length,
                    enqueued_at=self.tracer.now(),
                    extra=(state,),
                    role=role,
                    embedding_generation=state.param_generation,
                    trace=trace,
                )
                return ("hit", role), pending
        # cached window whose embedding is still in flight (or was raced
        # away, or certifies an older param generation): re-encode the cached
        # window — still no history re-send
        return self._encode_or_degrade(
            request, future, state, "advance", state, role, trace=trace
        )

    def _cold_miss(
        self,
        request: ScoreRequest,
        future: "Future[ScoreResponse]",
        role: str,
        trace: Optional[dict] = None,
    ) -> Optional[Tuple[Hashable, PendingRequest]]:
        """A state-less request with no history: error (the original
        contract) or the ladder floor (``cold_miss="fallback"`` — the fleet
        failover setting, where the user's cache lives on a replica that just
        died and a popularity answer beats an exception). ``new_items``
        requests ALWAYS error here, even under ``cold_miss="fallback"``:
        without a cached window the interaction cannot land, and a success
        response over a silently dropped event is worse than an explicit
        "re-anchor with history=" refusal (degradation never loses an event
        — docs/robustness.md "Fleet failover semantics")."""
        if request.new_items:
            msg = (
                f"user {request.user_id!r} has no cached state to advance; "
                "re-anchor with history= (the new_items interaction cannot "
                "land without a window)"
            )
            raise KeyError(msg)
        if self.cold_miss == "fallback" and self.fallback is not None:
            self._finish_fallback(
                request, future, reason="cold_miss", role=role, trace=trace
            )
            return None
        msg = (
            f"user {request.user_id!r} has no cached state; "
            "provide history= for the cold path"
        )
        raise KeyError(msg)

    def _encode_or_degrade(
        self,
        request: ScoreRequest,
        future: "Future[ScoreResponse]",
        state: UserState,
        served_from: str,
        previous: Optional[UserState],
        role: str = "stable",
        trace: Optional[dict] = None,
    ) -> Optional[Tuple[Hashable, PendingRequest]]:
        """The primary encode route, gated by the breaker; refused traffic
        walks the degradation ladder instead."""
        stale_embedding = previous.embedding if previous is not None else None
        stale_length = previous.length if previous is not None else 0
        stale_generation = previous.param_generation if previous is not None else 0
        if self.breaker.allow():
            lane, pending = self._encode_pending(
                request, future, state, served_from, role, trace=trace
            )
            pending.stale_embedding = stale_embedding
            pending.stale_length = stale_length
            pending.embedding_generation = stale_generation
            return lane, pending
        return self._degrade(
            request, future, stale_embedding, stale_length, stale_generation,
            role, reason="breaker_open", trace=trace,
        )

    def _cache_only_pending(
        self,
        request: ScoreRequest,
        future: "Future[ScoreResponse]",
        embedding: np.ndarray,
        length: int,
        reason: str,
        expires_at: Optional[float] = None,
        role: str = "stable",
        embedding_generation: int = 0,
        trace: Optional[dict] = None,
    ) -> PendingRequest:
        """The cache_only rung's pending: the stale cached state routed to the
        hit lane. The on_degrade emit happens at enqueue success, not here."""
        return PendingRequest(
            request=request,
            future=future,
            served_from="hit",
            embedding=embedding,
            length=length,
            enqueued_at=self.tracer.now(),
            expires_at=expires_at,
            served_by="cache_only",
            degrade_reason=reason,
            role=role,
            embedding_generation=embedding_generation,
            trace=trace,
        )

    def _emit_degraded(self, pending: PendingRequest) -> None:
        """Called once the degraded pending is SAFELY enqueued: a cache_only
        attempt that gets shed and re-rides the fallback floor must log one
        degrade event — for the rung that actually took it."""
        if pending.served_by == "cache_only" and pending.degrade_reason:
            self._emit_throttled(
                f"degrade:cache_only:{pending.degrade_reason}",
                "on_degrade",
                {"to": "cache_only", "reason": pending.degrade_reason},
            )

    def _degrade(
        self,
        request: ScoreRequest,
        future: "Future[ScoreResponse]",
        stale_embedding: Optional[np.ndarray],
        stale_length: int,
        stale_generation: int,
        role: str,
        reason: str,
        trace: Optional[dict] = None,
    ) -> Optional[Tuple[Hashable, PendingRequest]]:
        """Walk the ladder below primary: cache_only (hit lane on the stale
        cached state), then the fallback floor, then an explicit refusal."""
        if stale_embedding is not None:
            pending = self._cache_only_pending(
                request, future, stale_embedding, stale_length, reason,
                role=role, embedding_generation=stale_generation, trace=trace,
            )
            return ("hit", role), pending
        if self.fallback is not None:
            self._finish_fallback(
                request, future, reason=reason, role=role, trace=trace
            )
            return None
        raise CircuitOpen(self.breaker.retry_after_s())

    def _absorb_overload(
        self, lane, pending: PendingRequest, shed: RequestShed
    ) -> bool:
        """A shed encode-lane request may still ride a cheaper rung: the hit
        lane on its stale cached state, else the fallback floor. Returns
        whether the request was absorbed."""
        request = pending.request
        role = pending.role
        if lane[0] != "hit" and pending.stale_embedding is not None:
            degraded = self._cache_only_pending(
                request,
                pending.future,
                pending.stale_embedding,
                pending.stale_length,
                reason="overload",
                expires_at=pending.expires_at,
                role=role,
                embedding_generation=pending.embedding_generation,
                trace=pending.trace,
            )
            degraded.canary_epoch = pending.canary_epoch
            try:
                self.batcher.submit(("hit", role), degraded)
            except RequestShed:
                pass  # hit lane saturated too — next rung
            else:
                self._emit_degraded(degraded)
                return True
        if self.fallback is not None:
            self._finish_fallback(
                request, pending.future, reason="overload", role=role,
                trace=pending.trace,
            )
            return True
        return False

    def _finish_fallback(
        self,
        request: ScoreRequest,
        future: "Future[ScoreResponse]",
        reason: str,
        role: str = "stable",
        trace: Optional[dict] = None,
    ) -> None:
        response = self._fallback_response(request)
        response.role = role
        self._observe_quality(response, request)
        if self._safe_set_result(future, response):
            with self._count_lock:
                # under _count_lock: += on the scorer attribute is a
                # read-modify-write racing client threads otherwise
                self.fallback.served += 1
                self._served_by["fallback"] += 1
                self._served_from["fallback"] += 1
                self._role_stats[role]["answered"] += 1
            if trace:
                # the degradation ladder's floor, as a timeline marker: a
                # traced request answered inline by the host-side scorer shows
                # WHERE on its timeline it left the primary path, and why
                self.tracer.add_span(
                    "fallback", self.tracer.now(), 0.0,
                    trace_id=trace.get("trace_id"), served_by="fallback",
                    reason=reason,
                )
            self._emit_throttled(
                f"degrade:fallback:{reason}",
                "on_degrade",
                {"to": "fallback", "reason": reason},
            )

    def _fallback_response(self, request: ScoreRequest) -> ScoreResponse:
        """Host-side popularity answer shaped like the mode's primary one."""
        if self.retrieval is not None:
            k = request.k if request.k is not None else self.retrieval.top_k
            scores, item_ids = self.fallback.score(k=k)
        elif self.mode == "slate":
            scores, item_ids = self.fallback.score(
                candidates=np.asarray(self.engine.candidates, np.int64)
            )
            if request.k is not None:
                order = np.argsort(-scores, kind="stable")[: request.k]
                scores, item_ids = scores[order], item_ids[order]
        elif request.candidates is not None:
            scores, item_ids = self.fallback.score(candidates=request.candidates)
        elif request.k is not None:
            scores, item_ids = self.fallback.score(k=request.k)
        else:
            scores, item_ids = self.fallback.score()
        return ScoreResponse(
            user_id=request.user_id,
            scores=np.asarray(scores),
            item_ids=np.asarray(item_ids) if item_ids is not None else None,
            served_from="fallback",
            lane="fallback",
            queue_wait_s=0.0,
            batch_bucket=0,
            served_by="fallback",
            generation=-1,  # host-side floor: no device generation scored this
        )

    def _encode_pending(
        self,
        request: ScoreRequest,
        future: "Future[ScoreResponse]",
        state: UserState,
        served_from: str,
        role: str = "stable",
        trace: Optional[dict] = None,
    ) -> Tuple[Hashable, PendingRequest]:
        length_bucket = self.engine.route_length(state.length)
        pending = PendingRequest(
            request=request,
            future=future,
            served_from=served_from,
            window=state.window,
            mask=state.mask,
            length=state.length,
            enqueued_at=self.tracer.now(),
            extra=(state,),
            role=role,
            trace=trace,
        )
        return ("encode", length_bucket, role), pending

    # -- dispatch (serve-worker thread) ------------------------------------- #
    def _on_dispatch_error(self, lane, items: List[PendingRequest], exc: BaseException) -> None:
        role = self._lane_role(lane)
        failed = counted = 0
        for item in items:
            if self._safe_fail(item.future, exc):
                failed += 1
                if self._counts_for_role(role, item):
                    counted += 1
        with self._count_lock:
            self._errors += failed
            self._role_stats[role]["errors"] += counted

    def _counts_for_role(self, role: str, item: PendingRequest) -> bool:
        """Whether this outcome belongs in the role's canary accounting: a
        previous candidate's late-landing in-flight request (older canary
        epoch) must not pollute the CURRENT canary's evaluation window."""
        return role != "candidate" or item.canary_epoch == self._canary_epoch

    @staticmethod
    def _lane_role(lane) -> str:
        # both lane kinds carry the routing role last: ("hit", role) and
        # ("encode", L, role)
        return lane[-1]

    def _lane_name(self, lane) -> str:
        base = "hit" if lane[0] == "hit" else f"encode:L={lane[1]}"
        role = self._lane_role(lane)
        # stable lanes keep the PR-6 names; canary traffic is visibly its own
        # lane family (own queues, own shed keys, single-generation batches)
        return base if role == "stable" else f"{base}#canary"

    def _admit(
        self, items: List[PendingRequest]
    ) -> Tuple[List[PendingRequest], int, int]:
        """Batch-build admission: drop expired-deadline and client-abandoned
        requests BEFORE any device work, committing the survivors (their
        futures move to RUNNING, so a late ``cancel()`` no longer bites)."""
        now = time.perf_counter()
        live: List[PendingRequest] = []
        expired = abandoned = 0
        for item in items:
            future = item.future
            if future.done():
                abandoned += 1  # failed at close/crash, or cancelled+finalized
                continue
            if item.expires_at is not None and now >= item.expires_at:
                deadline_s = (item.request.deadline_ms or 0.0) / 1000.0
                waited = now - (item.expires_at - deadline_s)
                self._safe_fail(future, DeadlineExceeded(waited, deadline_s))
                expired += 1
                continue
            if not self._mark_running(future):
                abandoned += 1  # score(timeout=...) gave up on this waiter
                continue
            live.append(item)
        if expired or abandoned:
            with self._count_lock:
                self._deadline_misses += expired
                self._cancelled += abandoned
        return live, expired, abandoned

    def _dispatch(self, lane, items: List[PendingRequest]) -> None:
        # gradient mode and the current CUDA device are per thread: the worker
        # sets its own
        device = self.engine.device
        with torch.inference_mode(), (
            torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
        ):
            self._dispatch_batch(lane, items)

    def _dispatch_batch(self, lane, items: List[PendingRequest]) -> None:
        role = self._lane_role(lane)
        # ONE generation resolution per dispatched batch: encoder, scorer and
        # retrieval pipeline below all use this immutable object — a
        # concurrent promote/rollback changes the NEXT batch, never tears
        # this one between its stages (canary batches resolve the canary's
        # PINNED generation, never a just-published unvetted candidate)
        gen = self._generation_for(role)
        if lane[0] == "hit":
            self._dispatch_hit(lane, role, gen, items)
        else:
            self._dispatch_encode(lane, role, gen, items)

    def _dispatch_hit(self, lane, role: str, gen, items: List[PendingRequest]) -> None:
        """The hit lane under hot swaps: an embedding is only ever scored by
        the generation that ENCODED it. Current-generation items ride the
        bulk path; items whose generation moved on mid-flight finish on the
        generation they started (still resident — the store pins it); items
        whose generation left the store re-encode (primary) or fall to the
        floor (cache_only has no encode to return to)."""
        current: List[PendingRequest] = []
        stale: Dict[int, List[PendingRequest]] = {}
        for item in items:
            if int(item.embedding_generation) == gen.number:
                current.append(item)
            else:
                stale.setdefault(int(item.embedding_generation), []).append(item)
        expired = abandoned = 0
        for number, group in sorted(stale.items()):
            try:
                stale_gen = self.store.generation(number)
            except KeyError:
                stale_gen = None
            if stale_gen is None:
                with self._count_lock:
                    self._generation_reroutes += len(group)
                for item in group:
                    if item.served_by == "primary":
                        self._requeue_encode(item, role)
                    elif self.fallback is not None:
                        self._finish_fallback(
                            item.request, item.future,
                            reason="generation_evicted", role=role,
                        )
                    else:
                        # same accounting as a submit-time CircuitOpen: this
                        # refusal must not vanish from stats()
                        with self._count_lock:
                            self._circuit_refusals += 1
                        self._safe_fail(
                            item.future, CircuitOpen(self.breaker.retry_after_s())
                        )
                continue
            group, group_expired, group_abandoned = self._admit(group)
            expired += group_expired
            abandoned += group_abandoned
            if group:
                self._score_hit_batch(lane, role, stale_gen, group, 0, 0)
        current, current_expired, current_abandoned = self._admit(current)
        expired += current_expired
        abandoned += current_abandoned
        if not current:
            if expired or abandoned:
                # a fully-dropped batch (deadline storm, mass abandonment) is
                # exactly the batch the drop accounting must not go dark on
                self._emit_batch(lane, 0, 0, [], expired, abandoned)
            return
        self._score_hit_batch(lane, role, gen, current, expired, abandoned)

    def _trace_args(self, item: PendingRequest) -> dict:
        """Span args keying a per-request span to its distributed trace.

        Empty (and allocation-free for the common case) when the request
        arrived untraced — the span renders as before; with a fleet-forwarded
        trace context the replica-side span joins the request's timeline."""
        if item.trace is None:
            return {}
        return {"trace_id": item.trace.get("trace_id"), "served_by": item.served_by}

    def _batch_trace_ids(self, items: List[PendingRequest]) -> dict:
        """Span args for a BATCH-scoped span (build/score/retrieve/rerank):
        every traced co-rider's trace_id, as one ``trace_ids`` list — the
        whole batch window is attributed to each traced request riding it."""
        traced = [
            item.trace["trace_id"]
            for item in items
            if item.trace is not None and "trace_id" in item.trace
        ]
        return {"trace_ids": traced} if traced else {}

    def _score_hit_batch(
        self,
        lane,
        role: str,
        gen,
        items: List[PendingRequest],
        expired: int,
        abandoned: int,
    ) -> None:
        waits = [
            lifecycle_span(
                self.tracer, "queue_wait", item.enqueued_at,
                lane=self._lane_name(lane), **self._trace_args(item),
            )
            for item in items
        ]
        rows = len(items)
        batch_trace = self._batch_trace_ids(items)
        engine = gen.engine if gen.engine is not None else self.engine
        bucket = engine.batch_bucket(rows)
        with self.tracer.span("batch_build", rows=rows, **batch_trace):
            hidden = np.stack([item.embedding for item in items]).astype(np.float32)
        if self.mode == "retrieval":
            engine.record_ranked_batch(rows, bucket)
            pipeline = gen.pipeline if gen.pipeline is not None else self.retrieval
            scores, ids = self._rank(pipeline, hidden, rows, bucket, batch_trace)
            logits = None
        else:
            with self.tracer.span("score", rows=rows, lane="hit", **batch_trace):
                logits = engine.score_hidden(hidden, params=gen.params).cpu().numpy()
            scores = ids = None
        self._resolve_batch_futures(
            items, waits, lane, bucket, gen.number, role, logits, scores, ids
        )
        self._emit_batch(lane, rows, bucket, waits, expired, abandoned)

    def _dispatch_encode(self, lane, role: str, gen, items: List[PendingRequest]) -> None:
        items, expired, abandoned = self._admit(items)
        if not items:
            if expired or abandoned:
                self._emit_batch(lane, 0, 0, [], expired, abandoned)
            return
        waits = [
            lifecycle_span(
                self.tracer, "queue_wait", item.enqueued_at,
                lane=self._lane_name(lane), **self._trace_args(item),
            )
            for item in items
        ]
        rows = len(items)
        batch_trace = self._batch_trace_ids(items)
        _, length_bucket, _ = lane
        engine = gen.engine if gen.engine is not None else self.engine
        bucket = engine.batch_bucket(rows)
        with self.tracer.span("batch_build", rows=rows, **batch_trace):
            ids_batch = np.stack([item.window[-length_bucket:] for item in items])
            mask_batch = np.stack([item.mask[-length_bucket:] for item in items])
        with self.tracer.span("score", rows=rows, lane=self._lane_name(lane), **batch_trace):
            # the breaker's raw material: one engine call = one outcome
            # (a batch-wide exception counts once, not once per rider)
            try:
                logits_dev, hidden_dev = engine.encode(
                    length_bucket, ids_batch, mask_batch, params=gen.params
                )
                # one copy of the batch's states (and logits) to the host
                hidden_np = hidden_dev.cpu().numpy()
                logits = logits_dev.cpu().numpy() if logits_dev is not None else None
            except Exception:
                self.breaker.record_failure()
                raise
            self.breaker.record_success()
        for item, embedding in zip(items, hidden_np):
            state = item.extra[0]
            self.cache.refresh_embedding(
                item.request.user_id, state, embedding, param_generation=gen.number
            )
        if self.mode == "retrieval":
            pipeline = gen.pipeline if gen.pipeline is not None else self.retrieval
            # the states the encode left on the device feed the retrieval
            scores, ids = self._rank(pipeline, hidden_dev, rows, bucket, batch_trace)
        else:
            scores = ids = None
        self._resolve_batch_futures(
            items, waits, lane, bucket, gen.number, role, logits, scores, ids
        )
        self._emit_batch(lane, rows, bucket, waits, expired, abandoned)

    def _requeue_encode(self, item: PendingRequest, role: str) -> None:
        """Dispatch-time generation re-route: the embedding's generation left
        the store between submit and batch build — re-encode the cached
        window rather than score old hidden states through new weights."""
        state = item.extra[0] if item.extra else None
        if state is None:
            self._safe_fail(
                item.future,
                RuntimeError("hit-lane pending carries no cached state to re-encode"),
            )
            return
        try:
            resolved = self._encode_or_degrade(
                item.request, item.future, state, "advance", state, role,
                trace=item.trace,
            )
        except CircuitOpen as exc:
            with self._count_lock:
                self._circuit_refusals += 1
            self._safe_fail(item.future, exc)
            return
        except Exception as exc:  # noqa: BLE001 — surface through the future
            with self._count_lock:
                self._errors += 1
                self._role_stats[role]["errors"] += 1
            self._safe_fail(item.future, exc)
            return
        if resolved is None:  # answered inline by the fallback floor
            return
        new_lane, pending = resolved
        pending.expires_at = item.expires_at
        self._submit_pending(new_lane, pending)

    def _resolve_batch_futures(
        self,
        items: List[PendingRequest],
        waits: List[float],
        lane,
        bucket: int,
        generation: int,
        role: str,
        logits: Optional[np.ndarray],
        scores: Optional[np.ndarray],
        ids: Optional[np.ndarray],
    ) -> None:
        lane_name = self._lane_name(lane)
        for row, (item, wait) in enumerate(zip(items, waits)):
            try:
                response = self._build_response(
                    item,
                    lane_name=lane_name,
                    batch_bucket=bucket,
                    queue_wait=wait,
                    logits_row=logits[row] if logits is not None else None,
                    ranked_scores=scores[row] if scores is not None else None,
                    ranked_ids=ids[row] if ids is not None else None,
                    generation=generation,
                    role=role,
                )
            except Exception as exc:  # noqa: BLE001
                if self._safe_fail(item.future, exc):
                    with self._count_lock:
                        self._errors += 1
                        if self._counts_for_role(role, item):
                            self._role_stats[role]["errors"] += 1
                continue
            # observe BEFORE resolving: a client that saw result() return is
            # guaranteed its response was already counted by the quality
            # monitor — the reconciliation contract the online/offline parity
            # test (and the fleet's join accounting) leans on
            self._observe_quality(response, item.request)
            if not self._safe_set_result(item.future, response):
                with self._count_lock:
                    self._cancelled += 1
                continue
            with self._count_lock:
                self._served_from[item.served_from] += 1
                self._served_by[item.served_by] += 1
                self._queue_wait_sum += wait
                self._queue_wait_max = max(self._queue_wait_max, wait)
                if self._counts_for_role(role, item):
                    stats = self._role_stats[role]
                    stats["answered"] += 1
                    stats["queue_wait_ms_sum"] += wait * 1000.0
                    stats["queue_wait_ms_max"] = max(
                        stats["queue_wait_ms_max"], wait * 1000.0
                    )

    def _emit_batch(
        self, lane, rows: int, bucket: int, waits: List[float], expired: int, abandoned: int
    ) -> None:
        self._emit(
            "on_serve_batch",
            {
                "lane": self._lane_name(lane),
                "rows": rows,
                "bucket": bucket,
                "fill": rows / bucket if bucket else 0.0,
                "queue_wait_ms_max": max(waits) * 1000.0 if waits else 0.0,
                "dropped_expired": expired,
                "dropped_cancelled": abandoned,
            },
        )

    def _rank(
        self,
        pipeline: CandidatePipeline,
        hidden,
        rows: int,
        bucket: int,
        span_args: Optional[dict] = None,
    ):
        """Run the fused retrieve→rerank path at the padded batch bucket (rows
        repeat row 0, as the engine pads), so the device only ever sees the
        bucket ladder's shapes and a row's scores never depend on the fill."""
        hidden = pad_rows(as_device_tensor(hidden, torch.float32, pipeline.index.device), bucket)
        scores, ids = pipeline.rank(hidden, tracer=self.tracer, span_args=span_args)
        return scores[:rows], ids[:rows]

    def _build_response(
        self,
        item: PendingRequest,
        lane_name: str,
        batch_bucket: int,
        queue_wait: float,
        logits_row: Optional[np.ndarray],
        ranked_scores: Optional[np.ndarray],
        ranked_ids: Optional[np.ndarray],
        generation: int = 0,
        role: str = "stable",
    ) -> ScoreResponse:
        request = item.request
        if self.retrieval is not None:
            k = request.k if request.k is not None else self.retrieval.top_k
            scores, item_ids = ranked_scores[:k], ranked_ids[:k]
        elif self.mode == "slate":
            scores, item_ids = logits_row, np.asarray(self.engine.candidates)
            if request.k is not None:
                order = np.argsort(-scores, kind="stable")[: request.k]
                scores, item_ids = scores[order], item_ids[order]
        else:
            if request.candidates is not None:
                gathered = np.asarray(request.candidates, np.int64)
                scores, item_ids = logits_row[gathered], gathered
            elif request.k is not None:
                order = np.argsort(-logits_row, kind="stable")[: request.k]
                scores, item_ids = logits_row[order], order
            else:
                scores, item_ids = logits_row, None
        return ScoreResponse(
            user_id=request.user_id,
            scores=np.asarray(scores),
            item_ids=np.asarray(item_ids) if item_ids is not None else None,
            served_from=item.served_from,
            lane=lane_name,
            queue_wait_s=queue_wait,
            batch_bucket=batch_bucket,
            served_by=item.served_by,
            generation=generation,
            role=role,
        )

    # -- future resolution helpers (shared with the fleet: serve.futures) --- #
    _mark_running = staticmethod(mark_running)
    _safe_fail = staticmethod(safe_fail)
    _safe_set_result = staticmethod(safe_set_result)

    def _observe_quality(self, response: ScoreResponse, request: ScoreRequest) -> None:
        """Feed one resolved response to the quality monitor. A broken monitor
        detaches itself rather than poison the serving path: quality telemetry
        is strictly best-effort."""
        monitor = self.quality
        if monitor is None:
            return
        try:
            monitor.observe(response, request)
        except Exception:  # noqa: BLE001
            self.quality = None
            logger.exception(
                "quality monitor raised; detached — responses keep flowing "
                "unobserved"
            )

    # -- accounting --------------------------------------------------------- #
    def _route_event(self, event: TrainerEvent) -> None:
        """Fan one event out to the metrics bridge, the flight ring and the
        user sink (the SLO watchdog's emit target too, so violations land in
        all of them)."""
        if self._metrics_logger is not None:
            self._metrics_logger.log_event(event)
        if self._blackbox is not None:
            self._blackbox.log_event(event)
        if self.logger is not None:
            self.logger.log_event(event)

    def _emit(self, event: str, payload: Dict[str, Any]) -> None:
        if (
            self._metrics_logger is None
            and self._blackbox is None
            and self.logger is None
        ):
            return
        self._route_event(TrainerEvent(event=event, payload=payload))

    def _emit_throttled(
        self, key: str, event: str, payload: Dict[str, Any], min_interval: float = 0.5
    ) -> None:
        """Per-key rate-limited emit: the first occurrence always lands, then
        at most one event per ``min_interval`` carrying the coalesced
        ``count`` — an overload storm must not flood events.jsonl."""
        now = time.perf_counter()
        with self._count_lock:
            entry = self._throttle.get(key)
            last, pending_count = (entry[0], entry[1]) if entry else (None, 0)
            pending_count += 1
            if last is None or now - last >= min_interval:
                self._throttle[key] = (now, 0, event, payload)
                emit_count = pending_count
            else:
                self._throttle[key] = (last, pending_count, event, payload)
                emit_count = 0
        if emit_count:
            payload = dict(payload)
            payload["count"] = emit_count
            self._emit(event, payload)

    def _flush_throttled(self) -> None:
        """Emit every key's still-pending coalesced count (at close): a burst
        that ends inside a throttle window must not silently lose its tail —
        summing ``count`` over events.jsonl has to reproduce the totals."""
        with self._count_lock:
            pending = [
                (event, dict(payload), count)
                for (_, count, event, payload) in self._throttle.values()
                if count
            ]
            self._throttle = {}
        for event, payload, count in pending:
            payload["count"] = count
            self._emit(event, payload)

    def _on_breaker_transition(self, old: str, new: str, info: Dict[str, Any]) -> None:
        self._emit("on_breaker", {"from": old, "to": new, **info})
        if self._chained_transition is not None:
            try:
                self._chained_transition(old, new, info)
            except Exception:  # noqa: BLE001 — an alerting hook raising must
                pass  # not poison the dispatch path that recorded the outcome

    def heartbeat(self) -> Dict[str, Any]:
        """Cheap host-side liveness + load snapshot — the fleet monitor's
        raw material (``serve.fleet``). No device work, no engine call: the
        liveness bit is the batcher's worker state, the load signals are the
        same gauges the exporter already serves (lane depth, breaker state,
        cumulative request/error counters the monitor windows itself)."""
        with self._count_lock:
            requests = self._requests
            errors = self._errors
        return {
            "live": self._started and self.batcher.live,
            "queued": self.batcher.queued_depth(),
            "max_depth": self.batcher.max_depth,
            "breaker_state": self.breaker.state,
            "requests": requests,
            "errors": errors,
            "error_rate": errors / requests if requests else 0.0,
        }

    def stats(self) -> Dict[str, Any]:
        engine = self.engine.stats()
        cache = self.cache.stats()
        batcher = self.batcher.stats()
        with self._count_lock:
            served = dict(self._served_from)
            served_by = dict(self._served_by)
            requests = self._requests
            errors = self._errors
            shed = self._shed
            deadline_misses = self._deadline_misses
            cancelled = self._cancelled
            circuit_refusals = self._circuit_refusals
            wait_sum = self._queue_wait_sum
            wait_max = self._queue_wait_max
            roles = {role: dict(stats) for role, stats in self._role_stats.items()}
            generation_misses = self._generation_misses
            generation_reroutes = self._generation_reroutes
            canary = self._canary
        answered = sum(served.values())
        reused = served["hit"] + served["advance"]
        return {
            "mode": self.mode,
            "requests": requests,
            "answered": answered,
            "errors": errors,
            "served_from": served,
            "served_by": served_by,
            "shed": shed,
            "deadline_misses": deadline_misses,
            "cancelled": cancelled,
            "circuit_refusals": circuit_refusals,
            "degraded": served_by["cache_only"] + served_by["fallback"],
            # the rates obs.report renders and --compare gates (lower-better)
            "shed_rate": shed / requests if requests else 0.0,
            "deadline_miss_rate": deadline_misses / requests if requests else 0.0,
            "error_rate": errors / requests if requests else 0.0,
            # state reuse: requests served from cached state (pure hits +
            # one-step advances) over answered requests
            "cache_hit_rate": reused / answered if answered else 0.0,
            "pure_hit_rate": served["hit"] / answered if answered else 0.0,
            "batch_fill_ratio": engine["batch_fill_ratio"],
            "queue_wait_ms_mean": wait_sum / answered * 1000.0 if answered else 0.0,
            "queue_wait_ms_max": wait_max * 1000.0,
            "breaker": self.breaker.stats(),
            "engine": engine,
            "cache": cache,
            "batcher": batcher,
            # hot-swap / canary visibility (serve.promote)
            "generations": self.store.stats(),
            "roles": roles,
            "generation_misses": generation_misses,
            "generation_reroutes": generation_reroutes,
            "canary": (
                {"generation": canary[0], "fraction": canary[1]}
                if canary is not None
                else None
            ),
            # the quality plane (obs.quality): pure-JSON monitor snapshot —
            # per-role windowed telemetry + online prequential cumulatives +
            # PSI drift state. None when no monitor is attached
            "quality": self.quality.snapshot() if self.quality is not None else None,
        }
