"""Retrieval and (later) the classical models.

Counterpart of ``replay_tpu/models/``; so far :class:`MIPSIndex`, the exact
brute-force f32 inner-product search the scoring service's retrieval mode
runs. The classical models wait in ROADMAP.md queue 1.
"""

from .ann import MIPSIndex

__all__ = ["MIPSIndex"]
