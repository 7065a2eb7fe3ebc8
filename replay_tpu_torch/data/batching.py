"""Batch-count arithmetic (counterpart of ``replay_tpu/data/batching.py``;
only :func:`uniform_batch_count`, which the sequence batcher needs)."""

from __future__ import annotations


def uniform_batch_count(total: int, batch_size: int) -> int:
    """Number of batches covering ``total`` rows (ceil)."""
    if batch_size <= 0:
        msg = "batch_size must be positive"
        raise ValueError(msg)
    return -(-total // batch_size)
