from .base import LossBase, broadcast_negatives, mask_negative_logits, masked_mean
from .ce import CE, CEFused

# protocol name used by the reference's typing surface
LossProto = LossBase

__all__ = [
    "CE",
    "CEFused",
    "LossBase",
    "LossProto",
    "broadcast_negatives",
    "mask_negative_logits",
    "masked_mean",
]
