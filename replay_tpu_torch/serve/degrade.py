"""Graceful degradation: the host-side fallback scorer at the ladder's floor.

Copied from ``replay_tpu/serve/degrade.py`` (host numpy).

Under an open breaker or sustained overload the service routes traffic down a
ladder of cheaper modes (``docs/serving.md`` "Overload and degradation"):

1. **primary** — the full path (encode → score / retrieve → rerank). The only
   rung with the bitwise parity contract.
2. **cache_only** — the encode step is skipped: the user's most recent CACHED
   embedding is scored through the existing hidden-scorer hit lane. Bitwise
   identical to a pure cache hit of that state — it *is* one — but the state
   may be stale relative to the request (a just-advanced window's new event is
   recorded in the cache yet unscored until the engine recovers).
3. **fallback** — this module: a pure-host popularity scorer. No device, no
   model, survives anything; answers are generic, not personalized.

Every response carries ``served_by`` naming its rung, so degraded traffic is
visible to clients, the event stream, and ``obs.report``.

The reference serves a dedicated popularity model (``PopRec``) for cold
traffic; here the same ranking doubles as the outage floor — built from
interaction counts (or any score-per-item array) once, then served as
O(k) host gathers per request.

The fleet (``serve/fleet.py``) leans on this rung one more way: with
``ScoringService(cold_miss="fallback")``, a state-less READ for an
UNKNOWN user (no history, no new_items) rides the floor instead of
erroring — the failover setting, where a dead replica's users arrive
downstream with cold caches by construction and a generic answer beats a
``KeyError`` (``served_by == "fallback"`` keeps the path visible).
Interaction-bearing ``new_items`` requests still error: an event that
cannot land is never masked by a success response.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["DEGRADATION_LADDER", "FallbackScorer"]

# served_by values, best to worst — the order the service walks under duress
DEGRADATION_LADDER = ("primary", "cache_only", "fallback")


class FallbackScorer:
    """Host-side popularity ranking: the degradation ladder's last rung.

    :param item_scores: ``[num_items]`` float scores (e.g. interaction
        counts); item id IS the index. The descending stable ranking is
        precomputed once so serving is a gather, and ties break toward the
        smaller id — deterministic across processes.
    """

    def __init__(self, item_scores: Sequence[float]) -> None:
        scores = np.asarray(item_scores, np.float32)
        if scores.ndim != 1 or scores.size == 0:
            msg = "item_scores must be a non-empty 1-D array"
            raise ValueError(msg)
        self.item_scores = scores
        self.ranking = np.argsort(-scores, kind="stable").astype(np.int64)
        self.served = 0  # bumped by the service per fallback response

    @classmethod
    def from_interactions(
        cls, item_ids: Sequence[int], num_items: int
    ) -> "FallbackScorer":
        """Popularity from raw interaction item ids (training-log counts)."""
        counts = np.bincount(
            np.asarray(item_ids, np.int64), minlength=int(num_items)
        ).astype(np.float32)
        return cls(counts)

    @property
    def num_items(self) -> int:
        return int(self.item_scores.shape[0])

    def score(
        self,
        k: Optional[int] = None,
        candidates: Optional[Sequence[int]] = None,
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """``(scores, item_ids)`` in the same shapes the primary path returns.

        ``candidates`` → exact popularity gathers for those ids;
        ``k`` → the top-k popular items; neither → the full popularity vector
        (``item_ids`` None, index IS the id — full-mode convention).
        """
        if candidates is not None:
            ids = np.asarray(candidates, np.int64)
            return self.item_scores[ids], ids
        if k is not None:
            top = self.ranking[: int(k)]
            return self.item_scores[top], top
        return self.item_scores.copy(), None

    def stats(self) -> Dict[str, float]:
        return {"num_items": self.num_items, "served": self.served}
