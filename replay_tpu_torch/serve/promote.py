"""Zero-downtime weight swaps and SLO-guarded canary promotion.

Copied from ``replay_tpu/serve/promote.py`` (host-only):

* :class:`ParamStore` — an atomic, versioned store of parameter
  **generations**. Params travel as program *arguments* (``nn/compiled.py``
  binds them per call), so installing a new generation into the running
  per-bucket ``CompiledInference`` programs is a pointer swap, not a rebuild:
  every dispatched micro-batch resolves ONE generation up front and runs
  encoder, scorer and retrieval pipeline against it — in-flight batches finish
  on the generation they started, and no response ever mixes an old encoder
  with a new scorer (no torn reads). Only a catalog-shape change (a grown
  item table) needs a new engine, built on the *publisher's* thread while
  serving continues on the old generation.
* :func:`in_canary_slice` — the deterministic hash-based traffic slice: a
  user is in the canary or not as a pure function of ``(user_id, fraction)``,
  so the slice is stable across requests, restarts and processes.
* :class:`PromotionController` — the guarded state machine::

      idle ──publish──▶ shadow ──begin_canary──▶ canary ──K clean evals──▶ promoted
                                                   │
                                                   └─SLO breach─▶ rolled_back

  Each :meth:`PromotionController.evaluate` folds the service's per-role
  counters into ``replay_canary_*`` gauges, runs its
  :class:`~replay_tpu_torch.obs.slo.SLOWatchdog` over them, and acts on the
  verdict: a breach rolls back to the pinned previous generation exactly
  once (the stage transition is the latch), ``promote_after`` consecutive
  clean evaluations — each carrying at least ``min_canary_requests`` of real
  canary traffic — promote. After a rollback the candidate is burned:
  re-entering canary requires publishing a NEW generation. The clock is
  injectable for deterministic tests.

Events (``on_publish`` / ``on_swap`` / ``on_canary_start`` /
``on_canary_eval`` / ``on_promotion`` / ``on_rollback``) ride the service's
normal sink fan-out, so ``events.jsonl``, the metrics registry and
``obs.report``'s "promotion" section all see the same record.

Quality-gated canaries (obs.quality): when the service carries a
:class:`~replay_tpu_torch.obs.QualityMonitor`, its candidate-slice gauges
(``replay_quality_*{role="candidate"}``) land in the SAME registry this
controller's watchdog reads — so passing
:func:`~replay_tpu_torch.obs.canary_quality_rules` (or hand-written
:class:`~replay_tpu_torch.obs.SLORule`\\ s over those labeled series) as ``rules=``
makes a canary that serves fast-but-WORSE recommendations roll back exactly
like an erroring one, with zero controller changes. The ``on_canary_eval``
record then also carries the candidate's online quality window (``quality``
key) as the decision's evidence trail.
"""

from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence

__all__ = [
    "PROMOTION_STAGES",
    "ROLES",
    "ParamGeneration",
    "ParamStore",
    "PromotionController",
    "in_canary_slice",
]

# traffic-routing roles: "stable" serves the promoted generation, "candidate"
# the canary one (falling back to stable when no candidate is published)
ROLES = ("stable", "candidate")

PROMOTION_STAGES = ("idle", "shadow", "canary", "promoted", "rolled_back")

# numeric encoding of the stage for the replay_canary_stage gauge
STAGE_GAUGE = {
    "idle": 0.0,
    "shadow": 1.0,
    "canary": 2.0,
    "promoted": 3.0,
    "rolled_back": -1.0,
}


def in_canary_slice(user_id: Hashable, fraction: float) -> bool:
    """Deterministic hash slice: is ``user_id`` in the canary ``fraction``?

    Pure function of the id and the fraction (CRC-32 over ``str(user_id)``,
    bucketed mod 10_000) — the same user always lands on the same side, on
    every process, with no session state. ``fraction`` is clamped to [0, 1].
    """
    if fraction <= 0.0:
        return False
    if fraction >= 1.0:
        return True
    bucket = zlib.crc32(str(user_id).encode()) % 10_000
    return bucket < int(fraction * 10_000)


@dataclass(frozen=True)
class ParamGeneration:
    """One immutable published parameter set.

    ``engine`` is ``None`` for same-shape generations — they run through the
    service's base executables with these params passed as the program
    argument (zero recompile). A generation whose catalog shape changed
    carries its own pre-compiled :class:`~replay_tpu_torch.serve.ScoringEngine`
    (``recompiled=True``). ``pipeline`` is the generation's retrieval
    :class:`~replay_tpu_torch.serve.CandidatePipeline` (its MIPS index embeds the
    item table, so it is per-generation by construction).
    """

    number: int
    params: Any
    label: str = ""
    engine: Optional[Any] = None
    pipeline: Optional[Any] = None
    recompiled: bool = False
    published_at: float = 0.0


class ParamStore:
    """Thread-safe versioned parameter store with atomic role resolution.

    One lock guards every pointer move; readers get the immutable
    :class:`ParamGeneration` object, so a swap can never be observed
    half-applied. The *previous* stable generation stays pinned after every
    promote — the rollback target — and old unpinned generations beyond
    ``keep_history`` are dropped (their metadata survives in :meth:`history`).
    """

    def __init__(
        self,
        params: Any,
        label: str = "initial",
        pipeline: Optional[Any] = None,
        keep_history: int = 3,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._lock = threading.Lock()
        self._clock = clock
        self.keep_history = int(keep_history)
        self._generations: Dict[int, ParamGeneration] = {}
        self._log: List[Dict[str, Any]] = []
        self._next = 0
        self._stable = self._publish_locked(params, label=label, pipeline=pipeline)
        self._candidate: Optional[int] = None
        self._previous: Optional[int] = None
        self.swaps = 0
        self.rollbacks = 0

    # -- publishing --------------------------------------------------------- #
    def _publish_locked(
        self,
        params: Any,
        label: str = "",
        pipeline: Optional[Any] = None,
        engine: Optional[Any] = None,
        recompiled: bool = False,
    ) -> int:
        number = self._next
        self._next += 1
        generation = ParamGeneration(
            number=number,
            params=params,
            label=label,
            engine=engine,
            pipeline=pipeline,
            recompiled=recompiled,
            published_at=self._clock(),
        )
        self._generations[number] = generation
        self._log.append(
            {
                "generation": number,
                "label": label,
                "recompiled": bool(recompiled),
                "published_at": generation.published_at,
                "event": "published",
            }
        )
        return number

    def publish(
        self,
        params: Any,
        label: str = "",
        pipeline: Optional[Any] = None,
        engine: Optional[Any] = None,
        recompiled: bool = False,
    ) -> int:
        """Register a new generation and make it the current candidate."""
        with self._lock:
            number = self._publish_locked(
                params, label=label, pipeline=pipeline, engine=engine,
                recompiled=recompiled,
            )
            self._candidate = number
            self._evict_locked()
            return number

    # -- resolution (hot path) ---------------------------------------------- #
    def resolve(self, role: str = "stable") -> ParamGeneration:
        """The generation currently serving ``role`` — atomically.

        ``"candidate"`` falls back to stable when no candidate is published
        (a canary request racing a just-finished promote must still be
        answered, by the generation that won)."""
        with self._lock:
            number = self._stable
            if role == "candidate" and self._candidate is not None:
                number = self._candidate
            return self._generations[number]

    def generation(self, number: int) -> ParamGeneration:
        with self._lock:
            if number not in self._generations:
                msg = f"generation {number} is no longer resident (evicted history)"
                raise KeyError(msg)
            return self._generations[number]

    # -- pointer moves ------------------------------------------------------ #
    def promote(self, number: Optional[int] = None) -> Dict[str, Any]:
        """Atomically make ``number`` (default: the candidate) the stable
        generation; the outgoing stable is pinned as the rollback target."""
        with self._lock:
            if number is None:
                number = self._candidate
            if number is None:
                msg = "no candidate generation to promote"
                raise ValueError(msg)
            if number not in self._generations:
                msg = f"generation {number} is not resident in the store"
                raise KeyError(msg)
            previous = self._stable
            self._previous = previous
            self._stable = number
            self._candidate = None
            self.swaps += 1
            self._log.append(
                {
                    "generation": number,
                    "from_generation": previous,
                    "at": self._clock(),
                    "event": "promoted",
                }
            )
            self._evict_locked()
            return {"from_generation": previous, "to_generation": number}

    def rollback(self) -> Dict[str, Any]:
        """Atomically undo the current candidate or the last promote.

        Mid-canary (a candidate is live but stable never moved) the rollback
        DROPS the candidate — the traffic slice snaps back to stable. After a
        promote, the pinned previous generation is restored. Raises when
        there is neither a candidate nor a pinned previous generation."""
        with self._lock:
            if self._candidate is not None:
                # canary rollback: stable never moved, burning the candidate
                # IS the restoration
                abandoned = self._candidate
                self._candidate = None
            elif self._previous is not None:
                abandoned = self._stable
                self._stable = self._previous
                self._previous = None
                self.swaps += 1
            else:
                msg = "no candidate or previous generation; nothing to roll back to"
                raise ValueError(msg)
            self.rollbacks += 1
            self._log.append(
                {
                    "generation": self._stable,
                    "from_generation": abandoned,
                    "at": self._clock(),
                    "event": "rolled_back",
                }
            )
            self._evict_locked()
            return {"from_generation": abandoned, "to_generation": self._stable}

    def clear_candidate(self) -> None:
        with self._lock:
            self._candidate = None
            self._evict_locked()

    def _evict_locked(self) -> None:
        pinned = {self._stable, self._candidate, self._previous} - {None}
        numbers = sorted(self._generations)
        # keep every pinned generation plus the most recent keep_history
        keep = pinned | set(numbers[-self.keep_history :])
        for number in numbers:
            if number not in keep:
                del self._generations[number]

    # -- introspection ------------------------------------------------------ #
    def engines(self) -> List[Any]:
        """The engines of the resident generations that brought their own."""
        with self._lock:
            return [g.engine for g in self._generations.values() if g.engine is not None]

    @property
    def stable_generation(self) -> int:
        with self._lock:
            return self._stable

    @property
    def candidate_generation(self) -> Optional[int]:
        with self._lock:
            return self._candidate

    @property
    def previous_generation(self) -> Optional[int]:
        with self._lock:
            return self._previous

    def history(self) -> List[Dict[str, Any]]:
        """The append-only publish/promote/rollback log (pure JSON — the
        generation-history artifact the canary_smoke CI job uploads)."""
        with self._lock:
            return [dict(entry) for entry in self._log]

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "stable_generation": self._stable,
                "candidate_generation": self._candidate,
                "previous_generation": self._previous,
                "resident_generations": sorted(self._generations),
                "published": self._next,
                "swaps": self.swaps,
                "rollbacks": self.rollbacks,
            }


class PromotionController:
    """The guarded promotion state machine over a live
    :class:`~replay_tpu_torch.serve.ScoringService`.

    :param service: the serving process; the controller publishes through
        ``service.publish_candidate`` and swaps through ``service.promote`` /
        ``service.rollback`` so every move is atomic w.r.t. dispatch.
    :param rules: :class:`~replay_tpu_torch.obs.SLORule` set over the
        ``replay_canary_*`` gauges this controller maintains — or over any
        other series in the service's registry, e.g. the candidate-labeled
        ``replay_quality_*`` gauges a :class:`~replay_tpu_torch.obs.QualityMonitor`
        maintains (:func:`~replay_tpu_torch.obs.canary_quality_rules` builds that
        set). Default: any canary error rolls back
        (``replay_canary_error_rate > 0``).
    :param promote_after: consecutive clean evaluations (each with enough
        traffic) before the candidate is promoted.
    :param min_canary_requests: canary responses an evaluation window must
        carry to count as evidence — a window the slice sent no traffic
        through is neither clean nor breaching.
    :param fraction: default deterministic traffic slice for
        :meth:`begin_canary`.
    :param clock: injectable time source (tests drive the state machine
        without sleeping).
    """

    def __init__(
        self,
        service: Any,
        rules: Optional[Sequence[Any]] = None,
        promote_after: int = 3,
        min_canary_requests: int = 1,
        fraction: float = 0.1,
        clock: Callable[[], float] = time.monotonic,
        registry: Optional[Any] = None,
    ) -> None:
        from replay_tpu_torch.obs.metrics import MetricsRegistry
        from replay_tpu_torch.obs.slo import SLORule

        if promote_after < 1:
            msg = "promote_after must be >= 1 (clean evaluations before promote)"
            raise ValueError(msg)
        self.service = service
        self.registry = (
            registry
            if registry is not None
            else (service.metrics_registry or MetricsRegistry())
        )
        self.rules = (
            tuple(rules)
            if rules is not None
            else (
                SLORule(
                    "replay_canary_error_rate", ">", 0.0, name="canary_error_rate"
                ),
            )
        )
        self.promote_after = int(promote_after)
        self.min_canary_requests = int(min_canary_requests)
        self.fraction = float(fraction)
        self.clock = clock
        self.stage = "idle"
        self.generation: Optional[int] = None
        self.clean_evals = 0
        self.evals = 0
        self.promotions = 0
        self.rollbacks = 0
        self.watchdog = self._fresh_watchdog()
        self._last_counts: Dict[str, float] = {}

    def _fresh_watchdog(self):
        from replay_tpu_torch.obs.slo import SLOWatchdog

        # per-canary watchdog: a previous canary's still-active breach must
        # not leak a rollback into the next candidate's first evaluation
        return SLOWatchdog(
            self.rules, self.registry, emit=self.service._route_event,
            clock=self.clock,
        )

    def _emit(self, event: str, payload: Dict[str, Any]) -> None:
        self.service._emit(event, payload)

    def _set_stage(self, stage: str) -> None:
        self.stage = stage
        self.registry.set("replay_canary_stage", STAGE_GAUGE[stage])

    # -- state machine ------------------------------------------------------ #
    def publish(
        self, params: Any, label: str = "", pipeline: Optional[Any] = None
    ) -> int:
        """Register a candidate → **shadow** stage: the generation is resident
        and addressable (``service.submit(..., _role="candidate")`` probes it)
        but serves no user traffic. Refused while a canary is LIVE — the
        running canary must be promoted or rolled back first (a silent
        candidate replacement would redirect its traffic slice to an
        unvetted generation)."""
        if self.stage == "canary":
            msg = (
                "publish during an active canary: promote or roll back the "
                "running candidate before publishing a new generation"
            )
            raise RuntimeError(msg)
        self.generation = self.service.publish_candidate(
            params, label=label, pipeline=pipeline
        )
        self.clean_evals = 0
        self.evals = 0
        self._set_stage("shadow")
        return self.generation

    def begin_canary(self, fraction: Optional[float] = None) -> None:
        """Shadow → **canary**: the deterministic slice starts serving from
        the candidate. Requires a freshly published (shadow) generation — in
        particular, re-entering canary after a rollback needs a NEW
        :meth:`publish` (the burned candidate stays burned)."""
        if self.stage != "shadow":
            msg = (
                f"begin_canary from stage {self.stage!r}: a canary needs a "
                "freshly published candidate (after a rollback, publish a new "
                "generation — the rolled-back one stays burned)"
            )
            raise RuntimeError(msg)
        fraction = self.fraction if fraction is None else float(fraction)
        self.watchdog = self._fresh_watchdog()
        self.clean_evals = 0
        self.evals = 0
        self._last_counts = {}
        self.service.begin_canary(self.generation, fraction)
        self._set_stage("canary")
        self.registry.set("replay_canary_generation", float(self.generation))

    def evaluate(self, step: Optional[int] = None) -> Dict[str, Any]:
        """One guard evaluation: fold canary counters into gauges, run the
        watchdog, act. Returns the decision record (also emitted as
        ``on_canary_eval``)."""
        if self.stage != "canary":
            return {"stage": self.stage, "action": None}
        stats = self.service.canary_stats()["candidate"]
        window = {
            key: stats.get(key, 0.0) - self._last_counts.get(key, 0.0)
            for key in ("requests", "answered", "errors", "shed")
        }
        self._last_counts = {
            key: stats.get(key, 0.0)
            for key in ("requests", "answered", "errors", "shed")
        }
        seen = window["answered"] + window["errors"]
        error_rate = window["errors"] / seen if seen else 0.0
        self.evals += 1
        self.registry.set("replay_canary_requests", float(window["requests"]))
        self.registry.set("replay_canary_error_rate", float(error_rate))
        self.registry.set(
            "replay_canary_queue_wait_ms_max", float(stats.get("queue_wait_ms_max", 0.0))
        )
        self.registry.set("replay_canary_generation", float(self.generation))
        self.watchdog.evaluate(step)
        action: Optional[str] = None
        breached = list(self.watchdog.active)
        if breached:
            action = "rollback"
        elif seen >= self.min_canary_requests:
            self.clean_evals += 1
            if self.clean_evals >= self.promote_after:
                action = "promote"
        self.registry.set("replay_canary_clean_evals", float(self.clean_evals))
        record = {
            "stage": self.stage,
            "generation": self.generation,
            "action": action,
            "window": window,
            "error_rate": error_rate,
            "clean_evals": self.clean_evals,
            "evals": self.evals,
            "breached_rules": breached,
        }
        monitor = getattr(self.service, "quality", None)
        if monitor is not None:
            # the decision's quality evidence: the candidate slice's online
            # window at evaluation time (what the quality rules just judged)
            candidate = (monitor.snapshot().get("roles") or {}).get("candidate")
            if candidate:
                record["quality"] = {
                    key: candidate.get(key)
                    for key in (
                        "joins", "online_hitrate_cum", "online_ndcg_cum",
                        "coverage", "novelty", "popularity",
                    )
                    if candidate.get(key) is not None
                }
        self._emit("on_canary_eval", dict(record))
        if action == "rollback":
            self._rollback(breached)
        elif action == "promote":
            self._promote()
        return record

    def _rollback(self, breached: List[str]) -> None:
        info = self.service.rollback()
        self.rollbacks += 1
        self._set_stage("rolled_back")
        self._emit(
            "on_rollback",
            {
                "generation": self.generation,
                "restored_generation": info["to_generation"],
                "rules": breached,
                "evals": self.evals,
            },
        )

    def _promote(self) -> None:
        info = self.service.promote(self.generation)
        self.promotions += 1
        self._set_stage("promoted")
        self._emit(
            "on_promotion",
            {
                "generation": self.generation,
                "from_generation": info["from_generation"],
                "clean_evals": self.clean_evals,
                "evals": self.evals,
            },
        )

    def stats(self) -> Dict[str, Any]:
        return {
            "stage": self.stage,
            "generation": self.generation,
            "clean_evals": self.clean_evals,
            "evals": self.evals,
            "promotions": self.promotions,
            "rollbacks": self.rollbacks,
            "rules": [getattr(rule, "label", str(rule)) for rule in self.rules],
        }
