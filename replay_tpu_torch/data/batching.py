"""Uniform batch-partition arithmetic.

Counterpart of ``replay_tpu/data/batching.py``: :func:`uniform_batch_count`
(ceil batch counting, which the sequence batcher uses) and
:class:`UniformBatching` (each batch's first row and row count).
"""

from __future__ import annotations

from dataclasses import dataclass


def uniform_batch_count(total: int, batch_size: int) -> int:
    """Number of batches covering ``total`` rows (ceil)."""
    if batch_size <= 0:
        msg = "batch_size must be positive"
        raise ValueError(msg)
    return -(-total // batch_size)


@dataclass(frozen=True)
class UniformBatching:
    """Row-range arithmetic for fixed-size batches over ``total`` rows."""

    total: int
    batch_size: int

    def __post_init__(self) -> None:
        if self.total < 0 or self.batch_size <= 0:
            msg = "total must be >= 0 and batch_size positive"
            raise ValueError(msg)

    def __len__(self) -> int:
        return uniform_batch_count(self.total, self.batch_size)

    def start(self, index: int) -> int:
        self._check(index)
        return index * self.batch_size

    def limit(self, index: int) -> int:
        """Rows in batch ``index`` (the last batch may be short)."""
        self._check(index)
        return min(self.batch_size, self.total - self.start(index))

    def _check(self, index: int) -> None:
        if not 0 <= index < len(self):
            msg = f"batch index {index} out of range [0, {len(self)})"
            raise IndexError(msg)
