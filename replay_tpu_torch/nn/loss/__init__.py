from .base import LossBase, broadcast_negatives, mask_negative_logits, masked_mean
from .ce import CE, CEFused, CESampled, CESampledWeighted, CEWeighted

# protocol name used by the reference's typing surface
LossProto = LossBase

__all__ = [
    "CE",
    "CEFused",
    "CESampled",
    "CESampledWeighted",
    "CEWeighted",
    "LossBase",
    "LossProto",
    "broadcast_negatives",
    "mask_negative_logits",
    "masked_mean",
]
