"""Request/response types of the scoring service.

Copied from ``replay_tpu/serve/request.py`` (host numpy, no array framework).
The online analog of the reference's predict call: one request is ONE user's
"score my next item" query. Requests carry either a full interaction history
(cold start / exact-parity fallback) or just the incremental tail (``new_items``)
for users whose encoded state the service already caches — or nothing beyond
the user id, when a cached state should be scored as-is (the pure cache hit).
"""

from __future__ import annotations

from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Hashable, Optional, Sequence, Tuple

import numpy as np

# how a response was produced, in decreasing order of cache leverage
# ("fallback" is the degradation ladder's host-side floor — no device state)
SERVED_FROM = ("hit", "advance", "cold", "fallback")


@dataclass
class ScoreRequest:
    """One user's scoring query.

    :param user_id: cache key (any hashable).
    :param history: full item-id history, oldest → newest. Required for users
        the service has no cached state for; when given alongside a cached
        state it WINS and refreshes the cache (the exact-parity fallback).
    :param new_items: incremental interactions to append to the cached window
        (the one-step update path for returning users).
    :param k: top-k cut of the response. ``None`` returns full-catalog scores
        (or the compiled slate's scores); retrieval-mode services default to
        their pipeline's ``top_k``.
    :param candidates: per-request candidate item ids, scored by exact gather
        from the full-catalog scores (full mode only).
    :param deadline_ms: end-to-end latency budget. A request still queued when
        it expires is dropped at batch-build time (its future fails with
        :class:`~replay_tpu_torch.serve.errors.DeadlineExceeded`) and never reaches
        the device. ``None`` = no deadline.
    """

    user_id: Hashable
    history: Optional[Sequence[int]] = None
    new_items: Sequence[int] = ()
    k: Optional[int] = None
    candidates: Optional[Sequence[int]] = None
    deadline_ms: Optional[float] = None


@dataclass
class ScoreResponse:
    """Scores for one request.

    ``item_ids`` is populated for ranked responses (retrieval mode and top-k
    cuts); for full-catalog scores it is ``None`` and ``scores[i]`` is item
    ``i``'s score. In BOTH representations :func:`top_k_cut` recovers the
    ranked top-k ``(item_ids, scores)`` pair — the one contract every
    downstream consumer (quality telemetry, bench clients) relies on, so a
    response never needs to know which shape it was served in. ``item_ids``
    order is NOT guaranteed sorted by score (the candidate-gather path keeps
    request order); ``top_k_cut`` always re-ranks.
    """

    user_id: Hashable
    scores: np.ndarray
    item_ids: Optional[np.ndarray]
    served_from: str  # one of SERVED_FROM
    lane: str
    queue_wait_s: float
    # the compiled batch bucket this response's micro-batch ran at. Scores are
    # bitwise independent of fill level / co-riders / row order WITHIN a
    # bucket program, so (lane, batch_bucket) pins the exact program whose
    # direct forward_inference output this response reproduces bit-for-bit.
    batch_bucket: int = 0
    # which degradation-ladder rung produced this response (see serve.degrade):
    # "primary" keeps the full bitwise parity contract; "cache_only" scored a
    # possibly-stale cached state through the hit lane; "fallback" is the
    # host-side popularity floor. Degraded traffic is always visible here.
    served_by: str = "primary"
    # the parameter generation that produced every score in this response
    # (serve.promote): encoder, scorer and retrieval pipeline all resolved
    # from ONE generation per dispatched batch — a hot swap or rollback can
    # never tear a response across generations. ``role`` is the traffic slice
    # that routed it ("stable", or "candidate" during a canary).
    generation: int = 0
    role: str = "stable"
    # which fleet replica answered (serve.fleet): stamped by the router when
    # the request rode a ServingFleet — together with ``served_by`` this is
    # the failover proof trail (a rerouted user's degraded answer names both
    # the rung AND the replica that took it). None for direct single-service
    # scoring.
    replica: Optional[str] = None
    # the distributed-trace id of the request that produced this answer,
    # stamped by the fleet router when its tracer is on — the client-side
    # handle into the merged trace.json (chaos probes record it so a slow
    # failover links straight to its timeline). None when tracing is off.
    trace_id: Optional[str] = None


@dataclass
class PendingRequest:
    """Internal: a submitted request riding the micro-batcher queue.

    The window/mask/length snapshot is resolved on the CLIENT thread at submit
    time (cheap numpy bookkeeping) so the serve worker only stacks rows and
    runs device programs; ``enqueued_at`` is tracer-epoch-relative
    (``Tracer.now()``) for the cross-thread ``queue_wait`` span.
    """

    request: ScoreRequest
    future: "Future[ScoreResponse]"
    served_from: str
    window: Optional[np.ndarray] = None  # [L_max] int32, right-aligned
    mask: Optional[np.ndarray] = None  # [L_max] bool
    length: int = 0
    embedding: Optional[np.ndarray] = None  # [E] — pure-hit lane only
    enqueued_at: float = 0.0
    extra: Tuple[Any, ...] = field(default=())
    # resilience bookkeeping: expires_at is perf_counter-absolute (from the
    # request's deadline_ms); served_by tags the ladder rung this pending was
    # routed to; stale_embedding carries the PRE-mutation cached state so an
    # overload/breaker reroute can still serve cache_only after the window
    # already advanced (advance_user drops the embedding it certifies)
    expires_at: Optional[float] = None
    served_by: str = "primary"
    stale_embedding: Optional[np.ndarray] = None
    stale_length: int = 0
    # why this pending was degraded (breaker_open/overload); the on_degrade
    # event is emitted only AFTER its enqueue succeeds — a rerouted request
    # must produce one degrade event, for the rung that actually took it
    degrade_reason: Optional[str] = None
    # hot-swap bookkeeping (serve.promote): the traffic-slice role this
    # request routed to, and — for hit-lane pendings — the param generation
    # that encoded the cached embedding (the dispatch-time staleness guard
    # re-encodes on mismatch rather than score old states with new weights).
    # canary_epoch stamps WHICH begin_canary window admitted a candidate
    # request: a previous candidate's late-landing outcome must not count in
    # the current canary's evaluation window
    role: str = "stable"
    embedding_generation: int = 0
    canary_epoch: int = 0
    # distributed-trace context forwarded by the fleet router (the pure-JSON
    # ``TraceContext.to_json()`` payload: at least ``{"trace_id": ...}``).
    # Dispatch-side spans (queue_wait, the batch's build/score window) carry
    # its trace_id in their args so the request's replica-side time lands on
    # its timeline. None when the request arrived untraced — the default path
    # allocates nothing
    trace: Optional[dict] = None


def top_k_cut(response: "ScoreResponse", k: int) -> Tuple[np.ndarray, np.ndarray]:
    """The ranked top-k ``(item_ids, scores)`` of a response, score-descending.

    Works on BOTH response shapes: full-catalog (``item_ids is None`` —
    ``argpartition`` picks the k best of ``scores`` without sorting the whole
    catalog) and ranked/candidate responses (``item_ids`` present — re-ranked,
    because the candidate-gather path returns scores in REQUEST order). Ties
    break by original position (stable), and ``k`` is clamped to the available
    items. This is the one shared cut used by the quality monitor and the
    bench clients instead of private argsort copies.
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
