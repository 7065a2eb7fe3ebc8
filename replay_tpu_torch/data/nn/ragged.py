"""Left-padded gathers of a ragged column, on the host.

Counterparts of ``replay_tpu/native/__init__.py``'s ``gather_pad_spans``
(the in-memory batcher's windows), ``gather_pad`` and ``gather_pad_2d`` (the
parquet batcher's list and list-of-list columns): the JAX package runs a
small C++ library (``native/ragged.cpp``) or, without it, a numpy loop over
the batch. The port keeps the numpy form only, vectorised over the batch; it
gives the same arrays as either, bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def gather_pad_spans(
    values: np.ndarray,
    offsets: np.ndarray,
    rows: np.ndarray,
    starts: np.ndarray,
    stops: np.ndarray,
    max_len: int,
    pad_value,
) -> Tuple[np.ndarray, np.ndarray]:
    """Gather (row, start, stop) spans of a ragged column, left-padded.

    ``values`` is the column's rows concatenated, row ``r`` at
    ``values[offsets[r]:offsets[r + 1]]``. Entry ``b`` of the result takes row
    ``rows[b]``'s values ``[starts[b]:stops[b]]`` (row-relative); a span longer
    than ``max_len`` keeps its last ``max_len`` values. Returns
    ``(out [B, max_len], mask [B, max_len])``: ``out`` in float64 for a
    floating column, else int64, ``pad_value`` where ``mask`` is False.
    Raises ``ValueError`` for a row or span out of range.
    """
    values = np.asarray(values)
    offsets = np.ascontiguousarray(offsets, np.int64)
    rows = np.ascontiguousarray(rows, np.int64)
    starts = np.ascontiguousarray(starts, np.int64)
    stops = np.ascontiguousarray(stops, np.int64)
    floating = np.issubdtype(values.dtype, np.floating)
    n_rows = len(offsets) - 1
    clipped = rows.clip(0, max(n_rows - 1, 0))
    row_lengths = offsets[clipped + 1] - offsets[clipped] if n_rows > 0 else np.zeros_like(rows)
    bad = (rows < 0) | (rows >= n_rows) | (starts < 0) | (stops < starts) | (stops > row_lengths)
    if bad.any():
        msg = "gather_pad_spans: index or span out of range"
        raise ValueError(msg)
    base = offsets[clipped]
    return _left_pad(values, base + starts, base + stops, max_len, pad_value, floating)


def _left_pad(values: np.ndarray, starts: np.ndarray, stops: np.ndarray, max_len: int, pad_value, floating: bool):
    """Rows ``values[starts[b]:stops[b]]`` (absolute positions, the last
    ``max_len`` of a longer range kept), right-aligned in ``[B, max_len]``
    (times the rows' trailing shape) and padded with ``pad_value``."""
    starts = np.maximum(starts, stops - max_len)
    first = max_len - (stops - starts)  # the first filled column of each entry
    columns = np.arange(max_len, dtype=np.int64)
    mask = columns[None, :] >= first[:, None]
    source = (starts - first)[:, None] + columns[None, :]
    out = np.full((len(starts), max_len, *values.shape[1:]), pad_value, np.float64 if floating else np.int64)
    out[mask] = values[source[mask]]
    return out, mask


def _row_ranges(values_len: int, offsets: np.ndarray, indices: np.ndarray, name: str):
    """The (start, stop) of each indexed row, with the C library's checks."""
    n_rows = len(offsets) - 1
    if ((indices < 0) | (indices >= n_rows)).any():
        msg = f"{name}: row index out of range"
        raise ValueError(msg)
    starts, stops = offsets[indices], offsets[indices + 1]
    if ((starts < 0) | (stops < starts) | (stops > values_len)).any():
        msg = f"{name}: offsets out of range"
        raise ValueError(msg)
    return starts, stops


def gather_pad(
    values: np.ndarray,
    offsets: np.ndarray,
    indices: np.ndarray,
    max_len: int,
    pad_value,
) -> Tuple[np.ndarray, np.ndarray]:
    """Gather ragged rows into a left-padded ``[B, max_len]`` array and mask.

    ``values`` is the column's rows concatenated, row ``r`` at
    ``values[offsets[r]:offsets[r + 1]]``; entry ``b`` takes row
    ``indices[b]``, keeping its last ``max_len`` values (the recency window).
    ``out`` is float64 for a floating column, else int64, ``pad_value`` where
    ``mask`` is False. Raises ``ValueError`` for a row or offsets out of range.
    """
    values = np.asarray(values)
    offsets = np.ascontiguousarray(offsets, np.int64)
    indices = np.ascontiguousarray(indices, np.int64)
    starts, stops = _row_ranges(len(values), offsets, indices, "gather_pad")
    return _left_pad(values, starts, stops, max_len, pad_value, np.issubdtype(values.dtype, np.floating))


def gather_pad_2d(
    values: np.ndarray,
    offsets: np.ndarray,
    indices: np.ndarray,
    max_len: int,
    width: int,
    pad_value,
) -> Tuple[np.ndarray, np.ndarray]:
    """Gather ragged rows of fixed-width vectors into ``[B, max_len, width]``.

    The list-of-list column's gather: ``values`` holds the inner vectors
    (``[total_steps, width]`` once reshaped) and ``offsets`` index steps per
    row. Left-padded along the step axis with ``pad_value``, the mask per
    step; the dtypes of :func:`gather_pad`.
    """
    values = np.asarray(values).reshape(-1, width)
    offsets = np.ascontiguousarray(offsets, np.int64)
    indices = np.ascontiguousarray(indices, np.int64)
    starts, stops = _row_ranges(len(values), offsets, indices, "gather_pad_2d")
    return _left_pad(values, starts, stops, max_len, pad_value, np.issubdtype(values.dtype, np.floating))
