"""Batch transforms and the default per-split pipelines (counterpart of
``replay_tpu/nn/transform``)."""

from .transforms import (
    InBatchNegativeSamplingTransform,
    AdaptiveTrimTransform,
    Compose,
    CopyTransform,
    EqualityMaskTransform,
    GroupTransform,
    MultiClassNegativeSamplingTransform,
    NextTokenTransform,
    RenameTransform,
    SegmentBoundaryMaskTransform,
    SelectTransform,
    SequenceRollTransform,
    TokenMaskTransform,
    TrimTransform,
    UniformNegativeSamplingTransform,
    UnsqueezeTransform,
)
from .template import (
    make_default_bert4rec_transforms,
    make_default_sasrec_transforms,
    make_default_twotower_transforms,
    make_packed_sasrec_transforms,
)

__all__ = [
    "InBatchNegativeSamplingTransform",
    "AdaptiveTrimTransform",
    "Compose",
    "CopyTransform",
    "EqualityMaskTransform",
    "GroupTransform",
    "MultiClassNegativeSamplingTransform",
    "NextTokenTransform",
    "RenameTransform",
    "SegmentBoundaryMaskTransform",
    "SelectTransform",
    "SequenceRollTransform",
    "TokenMaskTransform",
    "TrimTransform",
    "UniformNegativeSamplingTransform",
    "UnsqueezeTransform",
    "make_default_bert4rec_transforms",
    "make_default_sasrec_transforms",
    "make_default_twotower_transforms",
    "make_packed_sasrec_transforms",
]
