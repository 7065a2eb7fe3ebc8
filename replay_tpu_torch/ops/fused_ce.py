"""Kernels K1, K2, K3: the fused full-catalog log-sum-exp and its gradients, on Hopper.

Replaces ``replay_tpu/ops/fused_ce.py`` (the Pallas kernels behind ``CEFused``):
``_lse_kernel`` (K1), ``_dh_kernel`` (K2) and ``_dw_kernel`` (K3).
:func:`fused_lse` computes ``lse_n = logsumexp_i(h_n · w_i)`` without building
the ``[N, I]`` logits; its gradient recomputes each logits tile from the saved
``lse`` (rematerialisation, as the JAX ``custom_vjp`` does):

* ``dh = (g · exp(hWᵀ − lse)) @ W``, cast to ``hidden.dtype``;
* ``dW = (g · exp(hWᵀ − lse))ᵀ @ h``, cast to ``table.dtype``.

Columns at or past ``num_valid`` get the finite mask ``_MASK = -1e30`` added, so
a table whose columns are all masked gives a finite lse near −1e30, not NaN;
``exp(_MASK − lse)`` is exactly 0 for any realistic lse. Products accumulate in
f32 whatever the input types (bf16 hidden states against an f32 table, the
precision ladder's rung, are converted to f32 before each product).

The kernels are ``replay_tpu_torch/csrc/fused_ce.cu`` (CUDA C++ for ``sm_90a``,
plain C interface, loaded with ctypes; built at first use by
:mod:`replay_tpu_torch.ops.build`). Their design, and what bounds them, is in
the source's header. Each kernel has two variants, and :func:`_variant` picks
one from E alone, the same for all three: ``"tf32"`` for E a multiple of 8 up
to 128, on the TF32 tensor cores (``mma.sync``, each f32 operand split into
TF32 hi + lo, so f32 accuracy is kept), a block holding one operand's 64-row
tile and streaming the other's, so that each logits tile is computed once
(K1 and K2 hold rows of h, K3 items of W); ``"simt"`` for any other E, on
64 × 64 logits tiles in f32 FMA with the embedding swept in chunks. Each
output element has one owner that sums in a fixed order (no atomics: the
result is the same from run to run), and K3's rows are split into a fixed
number of parts added in order by a second pass.

``tile`` and ``item_tile`` are the JAX signature's tile sizes. The port's
kernels choose their own tiles (64 rows × 64 items; 33 KB of shared memory for
any embedding width in the simt kernels, at most 133 KB at E=128 in the tf32
variants, so nothing has to shrink to fit), and the two arguments never change
a result: they are checked and otherwise unused.

On CPU tensors each wrapper runs its plain version; on CUDA tensors it launches
its kernel or raises. ``fused_lse_forward.launches``, ``fused_lse_dh.launches``
and ``fused_lse_dw.launches`` count kernel launches (K3's second pass, which
adds the row splits, is part of its launch); each wrapper's
``launches_by_variant`` splits them by variant.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from replay_tpu_torch.ops import build, counts

KERNEL = "fused_ce"
_MASK = -1e30  # finite catalog-padding mask, as the Pallas kernels'
_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL_TILE = 64  # rows and items of the kernels' logits tile (csrc/fused_ce.cu)
# K3 splits its rows until about this many blocks are launched, by variant:
# "simt" two per SM of an H100 (132 SMs); "tf32" eight per SM, since a block
# owns a whole item tile (fewer blocks) and 1 to 3 fit an SM, so that the last
# wave of blocks is a small share of the run. Constants, so the split, and with
# it the summation order, depends on the shapes only, never on the card.
_DW_TARGET_BLOCKS = {"simt": 264, "tf32": 1056}
VARIANTS = ("tf32", "simt")
DW_VARIANTS = VARIANTS
TF32_MAX_DIM = 128


def _num_valid(table: torch.Tensor, num_valid) -> int:
    return table.shape[0] if num_valid is None else int(num_valid)


def _masked_logits(hidden: torch.Tensor, table: torch.Tensor, num_valid) -> torch.Tensor:
    """``[N, I]`` f32 logits with columns at or past ``num_valid`` at +``_MASK``."""
    logits = hidden.to(torch.float32) @ table.to(torch.float32).T
    valid = _num_valid(table, num_valid)
    if valid < table.shape[0]:
        col = torch.arange(table.shape[0], device=logits.device)
        logits = logits + torch.where(col < valid, 0.0, _MASK).to(torch.float32)
    return logits


def _softmax_weights(hidden, table, grad, lse, num_valid) -> torch.Tensor:
    """``g · exp(logits − lse)``, the ``[N, I]`` weights both gradients contract."""
    logits = _masked_logits(hidden, table, num_valid)
    return torch.exp(logits - lse.to(torch.float32)[:, None]) * grad.to(torch.float32)[:, None]


def fused_lse_reference(hidden: torch.Tensor, table: torch.Tensor, num_valid=None) -> torch.Tensor:
    """The plain version of K1: ``[N]`` f32 log-sum-exp of the masked logits."""
    return torch.logsumexp(_masked_logits(hidden, table, num_valid), dim=-1)


def fused_lse_dh_reference(hidden, table, grad, lse, num_valid=None) -> torch.Tensor:
    """The plain version of K2: ``dh`` in ``hidden.dtype``."""
    weights = _softmax_weights(hidden, table, grad, lse, num_valid)
    return (weights @ table.to(torch.float32)).to(hidden.dtype)


def fused_lse_dw_reference(hidden, table, grad, lse, num_valid=None) -> torch.Tensor:
    """The plain version of K3: ``dW`` in ``table.dtype``."""
    weights = _softmax_weights(hidden, table, grad, lse, num_valid)
    return (weights.T @ hidden.to(torch.float32)).to(table.dtype)


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check(hidden: torch.Tensor, table: torch.Tensor, *row_vectors: torch.Tensor) -> None:
    """Raise on anything the kernels do not take."""
    tensors = (hidden, table, *row_vectors)
    devices = {t.device for t in tensors}
    if len(devices) != 1 or hidden.device.type != "cuda":
        msg = f"fused_ce kernels need hidden, table (and grad, lse) on one CUDA device, got {devices}"
        raise ValueError(msg)
    if hidden.dtype not in _DTYPES or table.dtype not in _DTYPES:
        msg = f"hidden and table must each be one of {_DTYPES}, got {hidden.dtype} and {table.dtype}"
        raise TypeError(msg)
    if hidden.dim() != 2 or table.dim() != 2 or hidden.shape[1] != table.shape[1]:
        msg = f"hidden must be [N, E] and table [I, E], got {tuple(hidden.shape)} and {tuple(table.shape)}"
        raise ValueError(msg)
    if table.shape[0] < 1 or hidden.shape[1] < 1:
        msg = f"the kernels need at least one item and one embedding column, got table {tuple(table.shape)}"
        raise ValueError(msg)
    for vector in row_vectors:
        if vector.shape != (hidden.shape[0],) or vector.dtype != torch.float32:
            msg = f"grad and lse must be f32 [{hidden.shape[0]}], got {vector.dtype} {tuple(vector.shape)}"
            raise ValueError(msg)


def _library(name: str):
    fn = getattr(build.load(KERNEL), name)
    fn.restype = ctypes.c_int
    return fn


def _raise_on(err: int, kernel: str, hidden: torch.Tensor, table: torch.Tensor) -> None:
    if err != 0:
        msg = (
            f"{kernel} kernel launch failed: CUDA error {err} at hidden {tuple(hidden.shape)} "
            f"{hidden.dtype}, table {tuple(table.shape)} {table.dtype}"
        )
        raise RuntimeError(msg)


def _types(hidden: torch.Tensor, table: torch.Tensor) -> Tuple[int, int]:
    return int(hidden.dtype == torch.bfloat16), int(table.dtype == torch.bfloat16)


def _clamp(num_valid: int) -> int:
    """``num_valid`` as a C int: values past the table mask nothing, negatives everything."""
    return max(-1, min(num_valid, 2**31 - 1))


def _variant(dim: int) -> str:
    """The variant of K1, K2 and K3 for embedding width ``dim``: ``"tf32"``
    (tensor cores) for ``dim`` a multiple of 8 up to 128, ``"simt"`` (CUDA
    cores) for every other ``dim``. Every pair of input types takes the same
    variant: in ``"tf32"`` each product takes the TF32 terms its operands need.
    A pure function of its argument: the choice never depends on a build or a
    launch."""
    return "tf32" if dim % 8 == 0 and 8 <= dim <= TF32_MAX_DIM else "simt"


_dw_variant = _variant  # K3's rule, under its earlier name


def _entry(kernel: str, variant: str) -> str:
    """The C entry point of ``kernel`` ("forward", "grad_hidden", "grad_table") in ``variant``."""
    return f"replay_fused_lse_{kernel}_tf32" if variant == "tf32" else f"replay_fused_lse_{kernel}"


def _report(hidden: torch.Tensor, table: torch.Tensor, *operands: torch.Tensor, out_bytes: int) -> None:
    """One K1/K2/K3 call's costs for the counters (``ops/counts.py::opaque``):
    a third of the fused head's ``6·N·E·I`` (``obs/mfu.py::fused_ce_flops``,
    the JAX package's count), and its operands' and result's bytes."""
    rows, embed = hidden.shape
    nbytes = sum(t.numel() * t.element_size() for t in (hidden, table, *operands)) + out_bytes
    counts.opaque(2.0 * rows * embed * table.shape[0], nbytes)


def fused_lse_forward(hidden: torch.Tensor, table: torch.Tensor, num_valid=None) -> torch.Tensor:
    """K1: ``[N]`` f32 catalog log-sum-exp. The plain version for CPU tensors;
    on CUDA tensors the kernel, or raise."""
    _report(hidden, table, out_bytes=4 * hidden.shape[0])
    if _on_cpu(hidden, table):
        with counts.outside_modes():
            return fused_lse_reference(hidden, table, num_valid)
    _check(hidden, table)
    valid = _num_valid(table, num_valid)
    variant = _variant(table.shape[1])
    hidden, table = hidden.contiguous(), table.contiguous()
    lse = torch.empty(hidden.shape[0], dtype=torch.float32, device=hidden.device)
    if hidden.shape[0] == 0:
        return lse
    if variant == "tf32":  # its 16-byte copies of W
        table = build.aligned(table)
    fn = _library(_entry("forward", variant))
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(hidden.device).cuda_stream
    with torch.cuda.device(hidden.device):
        err = fn(
            hidden.data_ptr(), table.data_ptr(), lse.data_ptr(), hidden.shape[0], table.shape[0],
            hidden.shape[1], _clamp(valid), *_types(hidden, table),
            stream,
        )
    _raise_on(err, f"fused_lse_forward (K1, {variant})", hidden, table)
    counts.launched(fused_lse_forward, stream, variant)
    return lse


def fused_lse_dh(hidden, table, grad, lse, num_valid=None) -> torch.Tensor:
    """K2: ``dh`` in ``hidden.dtype``. The plain version for CPU tensors; on
    CUDA tensors the kernel, or raise."""
    _report(hidden, table, grad, lse, out_bytes=hidden.numel() * hidden.element_size())
    if _on_cpu(hidden, table, grad, lse):
        with counts.outside_modes():
            return fused_lse_dh_reference(hidden, table, grad, lse, num_valid)
    _check(hidden, table, grad, lse)
    valid = _num_valid(table, num_valid)
    variant = _variant(table.shape[1])
    hidden, table, grad, lse = (t.contiguous() for t in (hidden, table, grad, lse))
    dh = torch.empty_like(hidden)
    if hidden.shape[0] == 0:
        return dh
    if variant == "tf32":  # its 16-byte copies of W
        table = build.aligned(table)
    fn = _library(_entry("grad_hidden", variant))
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(hidden.device).cuda_stream
    with torch.cuda.device(hidden.device):
        err = fn(
            hidden.data_ptr(), table.data_ptr(), grad.data_ptr(), lse.data_ptr(), dh.data_ptr(),
            hidden.shape[0], table.shape[0], hidden.shape[1], _clamp(valid), *_types(hidden, table),
            stream,
        )
    _raise_on(err, f"fused_lse_dh (K2, {variant})", hidden, table)
    counts.launched(fused_lse_dh, stream, variant)
    return dh


def dw_row_split(rows: int, items: int, dim: int, variant: str) -> Tuple[int, int]:
    """K3's ``(splits, rows_per_split)`` for ``variant``: the rows cut into
    parts, each a whole number of 64-row tiles, until about
    ``_DW_TARGET_BLOCKS[variant]`` blocks run (a "simt" block owns a 64-column
    slice of an item tile, a "tf32" block the whole item tile)."""
    row_tiles = max(1, math.ceil(rows / _KERNEL_TILE))
    blocks = math.ceil(items / _KERNEL_TILE)
    if variant == "simt":
        blocks *= math.ceil(dim / _KERNEL_TILE)
    wanted = min(row_tiles, max(1, math.ceil(_DW_TARGET_BLOCKS[variant] / blocks)))
    tiles_per_split = math.ceil(row_tiles / wanted)
    return math.ceil(row_tiles / tiles_per_split), tiles_per_split * _KERNEL_TILE


def fused_lse_dw(hidden, table, grad, lse, num_valid=None) -> torch.Tensor:
    """K3: ``dW`` in ``table.dtype``. The plain version for CPU tensors; on
    CUDA tensors the kernel, or raise."""
    _report(hidden, table, grad, lse, out_bytes=table.numel() * table.element_size())
    if _on_cpu(hidden, table, grad, lse):
        with counts.outside_modes():
            return fused_lse_dw_reference(hidden, table, grad, lse, num_valid)
    _check(hidden, table, grad, lse)
    valid = _num_valid(table, num_valid)
    variant = _variant(table.shape[1])
    hidden, table, grad, lse = (t.contiguous() for t in (hidden, table, grad, lse))
    if hidden.shape[0] == 0:
        return torch.zeros_like(table)
    if variant == "tf32":  # its 16-byte copies of h
        hidden = build.aligned(hidden)
    dw = torch.empty_like(table)
    splits, rows_per_split = dw_row_split(hidden.shape[0], table.shape[0], table.shape[1], variant)
    partial = (
        torch.empty((splits, *table.shape), dtype=torch.float32, device=table.device)
        if splits > 1
        else None
    )
    fn = _library(_entry("grad_table", variant))
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    stream = torch.cuda.current_stream(hidden.device).cuda_stream
    with torch.cuda.device(hidden.device):
        err = fn(
            hidden.data_ptr(), table.data_ptr(), grad.data_ptr(), lse.data_ptr(), dw.data_ptr(),
            partial.data_ptr() if partial is not None else None,
            hidden.shape[0], table.shape[0], hidden.shape[1], _clamp(valid), splits, rows_per_split,
            *_types(hidden, table), stream,
        )
    _raise_on(err, f"fused_lse_dw (K3, {variant})", hidden, table)
    counts.launched(fused_lse_dw, stream, variant)
    return dw


for _wrapper in (fused_lse_forward, fused_lse_dh, fused_lse_dw):
    _wrapper.launches = 0
    _wrapper.launches_by_variant = dict.fromkeys(VARIANTS, 0)


class _FusedLSE(torch.autograd.Function):
    """K1 forward; K2 and K3 backward. Saves ``hidden``, ``table`` and ``lse``."""

    @staticmethod
    def forward(ctx, hidden, table, num_valid):
        lse = fused_lse_forward(hidden, table, num_valid)
        ctx.save_for_backward(hidden, table, lse)
        ctx.num_valid = num_valid
        return lse

    @staticmethod
    def backward(ctx, grad_lse):
        hidden, table, lse = ctx.saved_tensors
        grad = grad_lse.to(torch.float32)
        dh = fused_lse_dh(hidden, table, grad, lse, ctx.num_valid) if ctx.needs_input_grad[0] else None
        dw = fused_lse_dw(hidden, table, grad, lse, ctx.num_valid) if ctx.needs_input_grad[1] else None
        return dh, dw, None


def fused_lse(
    hidden: torch.Tensor,
    table: torch.Tensor,
    tile: int = 256,
    item_tile: Optional[int] = None,
    num_valid=None,
) -> torch.Tensor:
    """``logsumexp(hidden @ table.T, dim=-1)`` without materialising the logits.

    :param hidden: ``[N, E]`` row vectors (f32 or bf16; f32 accumulation).
    :param table: ``[num_items, E]`` item embeddings (f32 or bf16).
    :param tile: the JAX signature's rows per program; checked, never changes a result.
    :param item_tile: the JAX signature's catalog tile; checked, never changes a result.
    :param num_valid: valid leading rows of ``table``; the rest are masked out
        of the softmax (an int, or a 0-d integer tensor). Default: all rows.
    :return: ``[N]`` float32 log-sum-exp values, differentiable w.r.t. both inputs.
    """
    for name, value in (("tile", tile), ("item_tile", item_tile)):
        if value is not None and (not isinstance(value, int) or value < 1):
            msg = f"{name} must be a positive int or None, got {value!r}"
            raise ValueError(msg)
    if isinstance(num_valid, torch.Tensor):
        num_valid = int(num_valid)
    return _FusedLSE.apply(hidden, table, num_valid)
