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
* :class:`ParamStore` — versioned parameter generations that hot-swap into
  the running programs without a rebuild (``promote``).

Not ported yet (ROADMAP.md queue 1): the fleet and router, the remote
replicas and ``PromotionController``.
"""

from .batcher import MicroBatcher
from .breaker import CircuitBreaker
from .cache import UserState, UserStateCache
from .degrade import DEGRADATION_LADDER, FallbackScorer
from .engine import ScoringEngine
from .errors import CircuitOpen, DeadlineExceeded, RequestShed, ServeError, ServiceClosed
from .pipeline import CandidatePipeline
from .promote import ParamGeneration, ParamStore, in_canary_slice
from .quant import QuantizedTable, quantization_error, quantize_embeddings
from .request import SERVED_FROM, ScoreRequest, ScoreResponse, make_window, top_k_cut
from .service import ScoringService

__all__ = [
    "DEGRADATION_LADDER",
    "SERVED_FROM",
    "CandidatePipeline",
    "CircuitBreaker",
    "CircuitOpen",
    "DeadlineExceeded",
    "FallbackScorer",
    "MicroBatcher",
    "ParamGeneration",
    "ParamStore",
    "QuantizedTable",
    "RequestShed",
    "ScoreRequest",
    "ScoreResponse",
    "ScoringEngine",
    "ScoringService",
    "ServeError",
    "ServiceClosed",
    "UserState",
    "UserStateCache",
    "in_canary_slice",
    "make_window",
    "quantization_error",
    "quantize_embeddings",
    "top_k_cut",
]
