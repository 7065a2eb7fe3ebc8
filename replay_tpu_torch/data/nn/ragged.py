"""Left-padded gather of spans of a ragged column, on the host.

Counterpart of ``replay_tpu/native/__init__.py::gather_pad_spans``: the JAX
package runs a small C++ library (``native/ragged.cpp``) or, without it, a
numpy loop over the batch. The port keeps the numpy form only, vectorised
over the batch; it gives the same arrays as either, bit for bit.
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
    starts = np.maximum(starts, stops - max_len)
    first = max_len - (stops - starts)  # the first filled column of each entry
    columns = np.arange(max_len, dtype=np.int64)
    mask = columns[None, :] >= first[:, None]
    source = (offsets[clipped] + starts - first)[:, None] + columns[None, :]
    out = np.full((len(rows), max_len), pad_value, np.float64 if floating else np.int64)
    out[mask] = values[source[mask]]
    return out, mask
