from . import loss
from .compiled import CompiledInference, params_mismatch
from .postprocess import SeenItemsFilter
from .precision import PARITY_REL_TOL, Precision, fit_parity_record
from .train import LRSchedulerFactory, OptimizerFactory, PreemptionHandler, RecoveryPolicy, Trainer, TrainState

__all__ = [
    "CompiledInference",
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
]
