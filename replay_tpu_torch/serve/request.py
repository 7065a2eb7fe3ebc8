"""Host-side request helpers of the scoring service.

Copied from ``replay_tpu/serve/request.py`` (host numpy, no array framework):
``make_window`` builds the right-aligned serving window, ``ScoreResponse`` is
one request's scores, and ``top_k_cut`` ranks either response shape. The
request queueing types come with the service slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Hashable, Optional, Sequence, Tuple

import numpy as np

# how a response was produced, in decreasing order of cache leverage
# ("fallback" is the degradation ladder's host-side floor — no device state)
SERVED_FROM = ("hit", "advance", "cold", "fallback")


@dataclass
class ScoreResponse:
    """Scores for one request.

    ``item_ids`` is populated for ranked responses (retrieval mode and top-k
    cuts); for full-catalog scores it is ``None`` and ``scores[i]`` is item
    ``i``'s score. In BOTH representations :func:`top_k_cut` recovers the
    ranked top-k ``(item_ids, scores)`` pair.
    """

    user_id: Hashable
    scores: np.ndarray
    item_ids: Optional[np.ndarray]
    served_from: str  # one of SERVED_FROM
    lane: str
    queue_wait_s: float
    # the batch bucket this response's micro-batch ran at: scores are bitwise
    # independent of fill level / co-riders / row order WITHIN a bucket
    batch_bucket: int = 0
    served_by: str = "primary"
    generation: int = 0
    role: str = "stable"
    replica: Optional[str] = None
    trace_id: Optional[str] = None


def top_k_cut(response: "ScoreResponse", k: int) -> Tuple[np.ndarray, np.ndarray]:
    """The ranked top-k ``(item_ids, scores)`` of a response, score-descending.

    Works on BOTH response shapes: full-catalog (``item_ids is None`` —
    ``argpartition`` picks the k best of ``scores`` without sorting the whole
    catalog) and ranked/candidate responses (``item_ids`` present — re-ranked,
    because the candidate-gather path returns scores in REQUEST order). Ties
    break by original position (stable), and ``k`` is clamped to the available
    items.
    """
    scores = np.asarray(response.scores).reshape(-1)
    if response.item_ids is None:
        k = min(int(k), scores.shape[0])
        if k <= 0:
            return np.empty(0, np.int64), np.empty(0, scores.dtype)
        part = np.argpartition(scores, scores.shape[0] - k)[scores.shape[0] - k :]
        order = part[np.argsort(-scores[part], kind="stable")]
        return order.astype(np.int64), scores[order]
    item_ids = np.asarray(response.item_ids).reshape(-1)
    k = min(int(k), item_ids.shape[0])
    if k <= 0:
        return np.empty(0, item_ids.dtype), np.empty(0, scores.dtype)
    order = np.argsort(-scores[: item_ids.shape[0]], kind="stable")[:k]
    return item_ids[order], scores[order]


def make_window(
    items: Sequence[int], max_sequence_length: int, pad_id: int = 0
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Right-align ``items`` into a ``[L]`` window (the canonical serving
    layout, matching ``SequenceBatcher``'s left padding): returns
    ``(window, mask, length)`` keeping only the most recent ``L`` events.

    ``pad_id`` defaults to 0, a real item id, while ``SasRec``'s padding row is
    ``cardinality``; the mask hides padded keys with exact-zero attention
    weight, so the last-position scores are the same under either pad id."""
    length = min(len(items), max_sequence_length)
    window = np.full(max_sequence_length, pad_id, np.int32)
    mask = np.zeros(max_sequence_length, bool)
    if length:
        window[max_sequence_length - length :] = np.asarray(items, np.int32)[-length:]
        mask[max_sequence_length - length :] = True
    return window, mask, length
