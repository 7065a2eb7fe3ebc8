"""Retrieval and (later) the classical models.

Counterpart of ``replay_tpu/models/``; so far :class:`MIPSIndex`, the
inner-product search the scoring service's retrieval mode runs: the brute
sweep over an f32 or int8 table, or the IVF index (``ivf``). The classical
models wait in ROADMAP.md queue 1.
"""

from .ann import MIPSIndex

__all__ = ["MIPSIndex"]
