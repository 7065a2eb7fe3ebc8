"""Training utilities (counterpart of ``replay_tpu/utils``): checkpoints
(:mod:`.checkpoint`), the fault injectors of :mod:`.faults`, the profiling hooks
(:mod:`.profiling`: :func:`trace`, :class:`StepTimer`), the JSON helpers
(:mod:`.serde`) and the pandas-free table (:mod:`.types`: ``ColumnTable``,
``df_backend``). The ``.replay`` model savers, the session and mesh helpers,
the time and distribution helpers and the optional-dependency flags wait with
the classical models (``ROADMAP.md`` queue 1, item 11b)."""

from .checkpoint import CheckpointManager, load_metadata, restore_pytree, save_pytree
from .faults import (
    EngineErrorAt,
    InjectedFault,
    KillAtStep,
    LatencySpike,
    NaNInjector,
    SignalAtStep,
    inject_nan,
    truncate_file,
    wrap_method,
)
from .profiling import StepTimer, trace
from .types import ColumnTable, df_backend

__all__ = [
    "CheckpointManager",
    "ColumnTable",
    "EngineErrorAt",
    "InjectedFault",
    "KillAtStep",
    "LatencySpike",
    "NaNInjector",
    "SignalAtStep",
    "StepTimer",
    "df_backend",
    "inject_nan",
    "load_metadata",
    "restore_pytree",
    "save_pytree",
    "trace",
    "truncate_file",
    "wrap_method",
]
