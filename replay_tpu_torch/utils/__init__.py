"""Training utilities: checkpoints and fault injection (counterpart of
``replay_tpu/utils``, so far :mod:`.checkpoint` and the training side of
:mod:`.faults`)."""

from .checkpoint import CheckpointManager, load_metadata, restore_pytree, save_pytree
from .faults import InjectedFault, KillAtStep, NaNInjector, SignalAtStep, inject_nan, truncate_file

__all__ = [
    "CheckpointManager",
    "InjectedFault",
    "KillAtStep",
    "NaNInjector",
    "SignalAtStep",
    "inject_nan",
    "load_metadata",
    "restore_pytree",
    "save_pytree",
    "truncate_file",
]
