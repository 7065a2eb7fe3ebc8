from . import loss
from .compiled import CompiledInference, params_mismatch
from .postprocess import SeenItemsFilter
from .train import LRSchedulerFactory, OptimizerFactory, Trainer, TrainState

__all__ = [
    "CompiledInference",
    "LRSchedulerFactory",
    "OptimizerFactory",
    "SeenItemsFilter",
    "TrainState",
    "Trainer",
    "loss",
    "params_mismatch",
]
