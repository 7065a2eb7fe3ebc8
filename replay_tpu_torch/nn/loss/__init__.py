from .base import LossBase, broadcast_negatives, mask_negative_logits, masked_mean
from .bce import BCE, BCESampled, GBCE
from .ce import CE, CEFused, CESampled, CESampledWeighted, CEWeighted
from .login_ce import LogInCE, LogInCESampled
from .logout_ce import LogOutCE, LogOutCEWeighted
from .sce import SCE, ScalableCrossEntropyLoss, SCEParams

# with a sampled negative pool, masking the other positives out of the softmax
# reduces to plain sampled CE: the JAX package ships the same alias
LogOutCESampled = CESampled
# protocol name used by the reference's typing surface
LossProto = LossBase

__all__ = [
    "BCE",
    "BCESampled",
    "CE",
    "CEFused",
    "CESampled",
    "CESampledWeighted",
    "CEWeighted",
    "GBCE",
    "LogInCE",
    "LogInCESampled",
    "LogOutCE",
    "LogOutCESampled",
    "LogOutCEWeighted",
    "LossBase",
    "LossProto",
    "SCE",
    "SCEParams",
    "ScalableCrossEntropyLoss",
    "broadcast_negatives",
    "mask_negative_logits",
    "masked_mean",
]
