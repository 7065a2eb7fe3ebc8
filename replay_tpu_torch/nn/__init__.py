from . import loss
from .agg import ConcatAggregator, PositionAwareAggregator, SumAggregator
from .attention import MultiHeadAttention, MultiHeadDifferentialAttention, RMSNorm
from .compiled import CompiledInference, params_mismatch
from .embedding import (
    CategoricalEmbedding,
    CategoricalListEmbedding,
    IdentityEmbedding,
    NumericalEmbedding,
    SequenceEmbedding,
    xavier_normal_embed_init,
)
from .ffn import PointWiseFeedForward, SwiGLU, SwiGLUEncoder
from .mask import DefaultAttentionMask, bidirectional_attention_mask, causal_attention_mask, padding_mask_from_ids
from .postprocess import SeenItemsFilter
from .precision import PARITY_REL_TOL, Precision, fit_parity_record
from .train import LRSchedulerFactory, OptimizerFactory, PreemptionHandler, RecoveryPolicy, Trainer, TrainState

__all__ = [
    "CategoricalEmbedding",
    "CategoricalListEmbedding",
    "CompiledInference",
    "ConcatAggregator",
    "DefaultAttentionMask",
    "IdentityEmbedding",
    "MultiHeadAttention",
    "MultiHeadDifferentialAttention",
    "NumericalEmbedding",
    "PointWiseFeedForward",
    "PositionAwareAggregator",
    "RMSNorm",
    "SequenceEmbedding",
    "SumAggregator",
    "SwiGLU",
    "SwiGLUEncoder",
    "LRSchedulerFactory",
    "OptimizerFactory",
    "PARITY_REL_TOL",
    "Precision",
    "PreemptionHandler",
    "RecoveryPolicy",
    "SeenItemsFilter",
    "TrainState",
    "Trainer",
    "bidirectional_attention_mask",
    "causal_attention_mask",
    "fit_parity_record",
    "loss",
    "padding_mask_from_ids",
    "params_mismatch",
    "xavier_normal_embed_init",
]
