"""Model-FLOPs utilization: the card's peak table and a program's counted costs.

Counterpart of ``replay_tpu/obs/mfu.py``. The JAX module reads XLA's cost
analysis of a compiled program; the port has no compiler to ask, so
:func:`program_costs` runs the program once and counts:

* **FLOPs** with ``torch.utils.flop_counter.FlopCounterMode`` over every
  dispatched op, the backward included. The attention operators
  ``replay_tpu_torch::flash_attention_forward`` (K4) and
  ``replay_tpu_torch::flash_attention_tiled_forward`` (K5) get formulas of
  their own (:func:`attention_flops`: ``4·B·H·Lq·Lk·D``, every score, as
  torch's formula for ``scaled_dot_product_attention`` counts them); their
  gradients are torch ops and counted as such. A remat step's recompute
  (``nn/remat.py``) runs inside the counted backward, so its ops count
  again, K4's and K5's formulas included, and what a selective policy saves
  does not: the compiled cost of a ``jax.checkpoint`` program counts the
  same. K1–K3 (``CEFused``'s fused
  head) are ``ctypes`` calls, opaque to the counter on the card, and their
  plain versions run outside the counter on the CPU (``ops/counts.py::
  opaque``), so that one program counts the same on both: the head's work
  comes back through :func:`fused_ce_flops`, as the JAX package adds it.
* **Bytes accessed**, an eager, unfused count (not XLA's): the bytes of every
  tensor operand and result of each dispatched op that moves data (views and
  allocations excluded), K4 and K5 as one op each; K1–K3 report their
  operands and results themselves.
* **Memory** from the allocator around the call (on the card): the
  arguments' bytes, the outputs' bytes, and the temporaries above both at the
  peak.

The peak table is keyed by substrings of ``torch.cuda.get_device_name()``:
the H100 SXM's dense peaks from its data sheet, bf16 989, TF32 495 and f32
67 TFLOP/s (HBM in :mod:`.roofline`).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

__all__ = [
    "PEAK_BF16_TFLOPS",
    "PEAK_F32_TFLOPS",
    "PEAK_TF32_TFLOPS",
    "attention_flops",
    "flops_per_step",
    "fused_ce_flops",
    "mfu",
    "peak_tflops",
    "program_costs",
]

# dense peak TFLOP/s per card, keyed by a substring of torch.cuda.get_device_name()
# (lower case): the H100 SXM5 data sheet's figures
PEAK_BF16_TFLOPS = {"h100 80gb hbm3": 989.0, "h100 sxm": 989.0}
PEAK_TF32_TFLOPS = {"h100 80gb hbm3": 495.0, "h100 sxm": 495.0}
PEAK_F32_TFLOPS = {"h100 80gb hbm3": 67.0, "h100 sxm": 67.0}
_PEAKS = {"bf16": PEAK_BF16_TFLOPS, "tf32": PEAK_TF32_TFLOPS, "f32": PEAK_F32_TFLOPS}


def peak_tflops(device_kind: str, precision: str = "bf16") -> Optional[float]:
    """Peak dense TFLOP/s of ``precision`` (``"bf16"``, ``"tf32"``, ``"f32"``)
    for a device name, or None for names without a table entry (CPU hosts,
    other cards)."""
    kind = (device_kind or "").lower()
    for key, peak in _PEAKS[precision].items():
        if key in kind:
            return peak
    return None


def attention_flops(q_shape, k_shape) -> int:
    """FLOPs of one attention forward ``softmax(q kᵀ) v`` over ``[B, H, Lq, D]``
    queries and ``[B, H, Lk, D]`` keys: two products of ``2·Lq·Lk·D`` per head."""
    batch, heads, lq, dim = q_shape
    lk = k_shape[-2]
    return 4 * batch * heads * lq * lk * dim


def _register_attention_formulas() -> None:
    from torch.utils.flop_counter import register_flop_formula

    from replay_tpu_torch.ops import flash_attention, flash_tiled  # noqa: F401 (defines the operators)

    for op in (
        torch.ops.replay_tpu_torch.flash_attention_forward,
        torch.ops.replay_tpu_torch.flash_attention_tiled_forward,
    ):
        try:
            register_flop_formula(op)(lambda q_shape, k_shape, *args, out_shape=None, **kwargs: attention_flops(q_shape, k_shape))
        except RuntimeError:  # already registered in this process
            pass


_VIEWLIKE = {"empty", "empty_strided", "empty_like", "detach", "alias", "lift_fresh"}


def _tensor_bytes(values) -> int:
    total = 0
    for value in values:
        if isinstance(value, torch.Tensor):
            total += value.numel() * value.element_size()
        elif isinstance(value, (list, tuple)):
            total += _tensor_bytes(value)
    return total


def _byte_counter():
    from torch.utils._python_dispatch import TorchDispatchMode

    class _BytesMode(TorchDispatchMode):
        """Bytes of the tensor operands and results of every data-moving op."""

        def __init__(self) -> None:
            super().__init__()
            self.bytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not (getattr(func, "is_view", False) or func._schema.name.split("::")[-1] in _VIEWLIKE):
                self.bytes += _tensor_bytes(args) + _tensor_bytes((kwargs or {}).values()) + _tensor_bytes(
                    out if isinstance(out, (list, tuple)) else (out,)
                )
            return out

    return _BytesMode()


def _outputs_bytes(out: Any) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_outputs_bytes(o) for o in out)
    if isinstance(out, dict):
        return sum(_outputs_bytes(o) for o in out.values())
    return 0


def program_costs(fn: Any, *args, device: Optional[torch.device] = None, **kwargs) -> Optional[dict]:
    """Everything one run of ``fn(*args, **kwargs)`` shows about its costs:
    ``flops`` (the counter's, plus K1–K3's through :func:`fused_ce_flops`),
    ``bytes_accessed`` (the eager per-op count), ``by_op`` (FLOPs per op), and
    on the card ``memory``: ``argument_bytes``, ``output_bytes``,
    ``temp_bytes``. The call runs for real: pass a program that leaves the
    caller's state alone (the trainer passes a copy)."""
    from torch.utils.flop_counter import FlopCounterMode

    from replay_tpu_torch.ops import counts

    _register_attention_formulas()
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    argument_bytes = _outputs_bytes(list(args)) + _outputs_bytes(dict(kwargs))
    with counts.opaque_costs() as opaque:
        with FlopCounterMode(display=False) as flop_counter, _byte_counter() as byte_counter:
            out = fn(*args, **kwargs)
    if cuda:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) - base
    flops = float(flop_counter.get_total_flops())
    nbytes = float(byte_counter.bytes)
    for head in opaque:
        flops += head["flops"]
        nbytes += head["bytes"]
    by_op = {str(op): int(n) for op, n in flop_counter.get_flop_counts().get("Global", {}).items()}
    record: Dict[str, Any] = {"flops": flops or None, "bytes_accessed": nbytes or None, "by_op": by_op}
    if cuda:
        output_bytes = _outputs_bytes(out)
        record["memory"] = {
            "argument_bytes": int(argument_bytes),
            "output_bytes": int(output_bytes),
            "temp_bytes": int(max(peak - output_bytes, 0)),
        }
    return record


def flops_per_step(fn: Any, *args, extra_flops: float = 0.0, **kwargs) -> Optional[float]:
    """Per-call FLOPs of a program, counted over one run (:func:`program_costs`);
    ``extra_flops`` adds work the counter cannot see."""
    costs = program_costs(fn, *args, **kwargs)
    if not costs or not costs.get("flops"):
        return None
    return float(costs["flops"]) + float(extra_flops)


def fused_ce_flops(rows: int, embed: int, num_items: int) -> float:
    """Analytic FLOPs of one fused-CE head step (fwd + bwd) for ``rows``
    hidden vectors against a ``num_items`` catalog, the JAX package's count:
    forward ``2·N·E·I`` (the logits sweep), backward ``2 × 2·N·E·I`` (the dh
    and dW kernels each do one product against a recomputed logits block;
    the recomputation is not counted)."""
    return 6.0 * float(rows) * float(embed) * float(num_items)


def mfu(tflops_per_sec: float, device_kind: str, device_count: int = 1, precision: str = "bf16") -> Optional[float]:
    """Achieved ÷ peak TFLOP/s over ``device_count`` cards, or None when the
    card has no peak entry (an MFU against an unknown peak is noise)."""
    peak = peak_tflops(device_kind, precision)
    if not peak or device_count < 1:
        return None
    return float(tflops_per_sec) / (peak * device_count)
