"""Post-training int8 quantization of the serving item table.

Counterpart of ``replay_tpu/serve/quant.py``, host numpy as there, so both
packages quantize a table to the same bytes:

* **per-row symmetric scales** — ``scale_i = absmax(row_i) / 127``,
  ``q_i = rint(row_i / scale_i)`` as int8, no zero point; a score is
  ``(queries @ q.T) * scale``. Rows that are entirely zero get scale 0 and
  quantize to exact zeros.
* the int8 rows and f32 scales are what ``MIPSIndex(precision="int8")`` and
  the IVF ``int8`` rung keep on the device; the f32 master stays on the host
  for ``MIPSIndex.exact_rescore``, the pipeline's full-precision stage.

Training never sees int8: quantization here is post-training and
serving-only.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np

__all__ = [
    "QuantizedTable",
    "quantization_error",
    "quantize_embeddings",
]


@dataclass(frozen=True)
class QuantizedTable:
    """Per-row symmetrically quantized embedding table.

    ``values`` is the int8 payload ``[I, E]``; ``scales`` the f32 per-row
    dequantization factors ``[I]`` (``row_i ≈ values_i * scales_i``).
    """

    values: np.ndarray  # int8 [I, E]
    scales: np.ndarray  # f32 [I]

    @property
    def num_items(self) -> int:
        return int(self.values.shape[0])

    @property
    def dim(self) -> int:
        return int(self.values.shape[1])

    @property
    def nbytes(self) -> int:
        """Total payload bytes (int8 values + f32 scales)."""
        return int(self.values.nbytes + self.scales.nbytes)

    def dequantize(self) -> np.ndarray:
        """The f32 approximation ``values * scales[:, None]`` (error at most
        scale/2 per element)."""
        return self.values.astype(np.float32) * self.scales[:, None]


def quantize_embeddings(table: np.ndarray, bits: int = 8) -> QuantizedTable:
    """Per-row symmetric quantization of an ``[I, E]`` f32 table:
    ``scale = absmax / 127``, values rounded to nearest (ties to even)."""
    if bits != 8:
        msg = f"only int8 is supported (bits=8), got bits={bits}"
        raise ValueError(msg)
    table = np.asarray(table, np.float32)
    if table.ndim != 2:
        msg = f"expected an [num_items, embed] table, got shape {table.shape}"
        raise ValueError(msg)
    qmax = float(2 ** (bits - 1) - 1)
    absmax = np.max(np.abs(table), axis=1)  # [I]
    scales = (absmax / qmax).astype(np.float32)
    # zero rows: scale 0 would divide by zero; quantize them to zeros exactly
    safe = np.where(scales > 0.0, scales, 1.0)
    values = np.clip(np.rint(table / safe[:, None]), -qmax, qmax).astype(np.int8)
    values[scales == 0.0] = 0
    return QuantizedTable(values=values, scales=scales)


def quantization_error(table: np.ndarray, quantized: QuantizedTable) -> Dict[str, Any]:
    """Round-trip error: the observed max absolute error against its bound
    (``scale/2`` per element), the relative Frobenius error, and the bytes."""
    table = np.asarray(table, np.float32)
    approx = quantized.dequantize()
    abs_err = np.abs(approx - table)
    bound = quantized.scales[:, None] / 2.0
    denom = float(np.linalg.norm(table)) or 1.0
    return {
        "max_abs_error": float(abs_err.max(initial=0.0)),
        "max_error_to_bound": float(np.max(abs_err / np.maximum(bound, 1e-12), initial=0.0)),
        "rel_frobenius_error": float(np.linalg.norm(approx - table)) / denom,
        "bytes_f32": int(table.nbytes),
        "bytes_int8": quantized.nbytes,
        "bytes_ratio": quantized.nbytes / max(int(table.nbytes), 1),
    }
