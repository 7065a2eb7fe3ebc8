"""Zero-downtime weight swaps: versioned parameter generations.

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

The SLO-guarded ``PromotionController`` state machine is not copied yet: it
needs the metrics registry and SLO watchdog of ``replay_tpu/obs/`` (ROADMAP.md
queue 1, "The serving fleet and the observability plane").
"""

from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, Hashable, List, Optional

__all__ = [
    "ROLES",
    "ParamGeneration",
    "ParamStore",
    "in_canary_slice",
]

# traffic-routing roles: "stable" serves the promoted generation, "candidate"
# the canary one (falling back to stable when no candidate is published)
ROLES = ("stable", "candidate")


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
