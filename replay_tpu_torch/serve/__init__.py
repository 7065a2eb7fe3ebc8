"""The scoring service: micro-batched, state-cached, candidate→rank fused.

Counterpart of ``replay_tpu/serve/`` with the JAX names:

* :class:`MicroBatcher` — fills fixed ``[B, L]`` slots from concurrent
  requests under a max-wait deadline, with bounded per-lane queues and a
  supervised worker (``batcher``).
* :class:`UserStateCache` — per-user encoded-state LRU with one-step
  incremental window advances (``cache``).
* :class:`ScoringEngine` — fixed-shape ``CompiledInference`` buckets per
  length bucket + cached-state scorers (``engine``).
* :class:`CandidatePipeline` — MIPS retrieval fused with the two-stage
  re-rank and top-k, all on the device, with an exact f32 rescore stage over
  an approximate index (``pipeline``).
* :func:`quantize_embeddings` / :class:`QuantizedTable` /
  :func:`quantization_error` — the int8 item table (``quant``).
* :class:`CircuitBreaker` — closed→open→half-open supervision of the encode
  path (``breaker``), and :class:`FallbackScorer` — the host-side popularity
  floor of the degradation ladder (``degrade``).
* :class:`ScoringService` — the end-to-end service (``service``), with
  admission control (:class:`RequestShed`), per-request deadlines
  (:class:`DeadlineExceeded`) and graceful degradation (``served_by`` tags).
* :class:`ParamStore` / :class:`PromotionController` — versioned parameter
  generations that hot-swap into the running programs without a rebuild,
  behind a shadow→canary→promoted|rolled_back state machine guarded by SLO
  rules (``promote``).
* :class:`ServingFleet` / :class:`HashRing` — N replicas behind a host-side
  consistent-hash router (``fleet``/``router``): per-replica health
  (:class:`ReplicaHealth`: healthy → degraded → draining → dead) from
  heartbeats and the replicas' own gauges, failover along the ring,
  p99-hedged requests, retry :class:`BackoffPolicy` honouring
  ``retry_after_s``, and drain-and-swap rollouts; :class:`NoHealthyReplica`
  is its refusal. Several in-process replicas may share one card.
* :class:`ReplicaServer` / :class:`RemoteReplica` /
  :class:`ReplicaServerProcess` — the same replica surface over HTTP, a
  server process each (``remote``), wire-compatible with the JAX package's.

Attach a :class:`~replay_tpu_torch.obs.QualityMonitor` with
``ScoringService(quality=...)`` to watch the model-quality plane of the same
traffic; :func:`top_k_cut` is the ranked-cut contract it relies on.
"""

from .batcher import MicroBatcher
from .breaker import CircuitBreaker
from .cache import UserState, UserStateCache
from .degrade import DEGRADATION_LADDER, FallbackScorer
from .engine import ScoringEngine
from .errors import (
    CircuitOpen,
    DeadlineExceeded,
    NoHealthyReplica,
    RequestShed,
    ServeError,
    ServiceClosed,
)
from .fleet import ReplicaHandle, ServingFleet
from .pipeline import CandidatePipeline
from .promote import (
    PROMOTION_STAGES,
    ParamGeneration,
    ParamStore,
    PromotionController,
    in_canary_slice,
)
from .quant import QuantizedTable, quantization_error, quantize_embeddings
from .remote import RemoteReplica, ReplicaServer, ReplicaServerProcess
from .request import SERVED_FROM, ScoreRequest, ScoreResponse, make_window, top_k_cut
from .router import REPLICA_HEALTH, BackoffPolicy, HashRing, ReplicaHealth
from .service import ScoringService

__all__ = [
    "DEGRADATION_LADDER",
    "PROMOTION_STAGES",
    "REPLICA_HEALTH",
    "SERVED_FROM",
    "BackoffPolicy",
    "CandidatePipeline",
    "CircuitBreaker",
    "CircuitOpen",
    "DeadlineExceeded",
    "FallbackScorer",
    "HashRing",
    "MicroBatcher",
    "NoHealthyReplica",
    "ParamGeneration",
    "ParamStore",
    "PromotionController",
    "QuantizedTable",
    "RemoteReplica",
    "ReplicaHandle",
    "ReplicaHealth",
    "ReplicaServer",
    "ReplicaServerProcess",
    "RequestShed",
    "ScoreRequest",
    "ScoreResponse",
    "ScoringEngine",
    "ScoringService",
    "ServeError",
    "ServiceClosed",
    "ServingFleet",
    "UserState",
    "UserStateCache",
    "in_canary_slice",
    "make_window",
    "quantization_error",
    "quantize_embeddings",
    "top_k_cut",
]
