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
from .postprocess import SeenItemsFilter
from .precision import PARITY_REL_TOL, Precision, fit_parity_record
from .train import LRSchedulerFactory, OptimizerFactory, PreemptionHandler, RecoveryPolicy, Trainer, TrainState

__all__ = [
    "CategoricalEmbedding",
    "CategoricalListEmbedding",
    "CompiledInference",
    "ConcatAggregator",
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
    "fit_parity_record",
    "loss",
    "params_mismatch",
    "xavier_normal_embed_init",
]
