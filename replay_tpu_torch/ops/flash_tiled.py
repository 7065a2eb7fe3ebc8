"""Kernel K5: length-tiled flash attention, forward, on Hopper.

Replaces ``replay_tpu/ops/flash_tiled.py::_kernel`` (the Pallas kernel behind
``SasRec(use_flash="tiled")``, the long-sequence route): softmax attention with
a causal mask built from indices and a per-key additive bias row ``[B, L]``
(0 / ``NEG_INF`` from a padding mask) instead of a ``[B, 1, L, L]`` mask, in
f32 whatever the input type, output in ``q.dtype``, plus the row log-sum-exp
the backward needs. A row with no valid key gives 0 and lse ``NEG_INF``.
Nothing O(L²) exists on the kernel's route, forward or backward.

The kernel is ``replay_tpu_torch/csrc/flash_tiled.cu`` (CUDA C++ for
``sm_90a``, plain C interface, loaded with ctypes; built at first use by
:mod:`replay_tpu_torch.ops.build`), in three variants that :func:`_variant`
picks from the dtype and head dim alone: ``"mma"`` for bf16 with D a multiple
of 8 up to 128 (tensor cores: ``mma.sync`` bf16 → f32, K/V tiles
double-buffered with ``cp.async``, P kept at f32 precision as a bf16 hi + lo
pair), ``"tf32x3"`` for f32 at the same D (the same design on the TF32 tensor
cores, each f32 operand split into TF32 hi + lo and each product taken as three
TF32 products, which keeps f32 accuracy), ``"simt"`` for every other D up to
256 (f32 FMAs on the CUDA cores). All are one block per (64-row query tile,
head, batch) walking the 64-key tiles up to the diagonal with an online
softmax in f32; their designs, and what bounds them, are in the source's
header. The kernel picks its own tiles: ``block_q`` and ``block_k`` are the
JAX signature's, and ``block_k`` sets the backward's loop.

Training goes through ``_FlashAttentionTiled``, a ``torch.autograd.Function``
that mirrors the JAX ``jax.custom_vjp``: the forward is the kernel (the plain
version on the CPU) and saves ``q, k, v, kv_bias, out, lse``; the backward is
:func:`flash_attention_tiled_backward`, the JAX ``_bwd`` as torch ops — a loop
over key blocks of ``block_k`` that recomputes each block's probabilities from
the saved lse, so its memory is O(L·block_k), never O(L²). It returns
gradients for ``q``, ``k``, ``v`` and ``kv_bias``. A backward kernel is later
work (``ROADMAP.md`` queue 2).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np
import torch

from replay_tpu_torch.ops import build, counts

KERNEL = "flash_tiled"
NEG_INF = -1e30
MAX_HEAD_DIM = 256
MMA_MAX_HEAD_DIM = 128
_DTYPES = (torch.float32, torch.bfloat16)
VARIANTS = ("mma", "tf32x3", "simt")
# each variant's C entry point in the kernel's library
_ENTRY_POINTS = {
    "mma": "replay_flash_tiled_forward_mma",
    "tf32x3": "replay_flash_tiled_forward_tf32x3",
    "simt": "replay_flash_tiled_forward",
}


def _variant(dtype: torch.dtype, dim: int) -> str:
    """The kernel variant for inputs of ``dtype`` and head dim ``dim``: on the
    tensor cores where ``dim`` is a multiple of 8 up to 128 — ``"mma"`` for
    bf16, ``"tf32x3"`` for f32 — and ``"simt"`` (CUDA cores) for every other
    ``dim``. A pure function of its arguments: the choice never depends on a
    build or a launch."""
    if dim % 8 == 0 and 8 <= dim <= MMA_MAX_HEAD_DIM:
        return "mma" if dtype == torch.bfloat16 else "tf32x3"
    return "simt"


def padding_mask_bias(padding_mask: torch.Tensor) -> torch.Tensor:
    """[B, L] bool (True = real token) → the additive per-key bias row, f32."""
    zeros = torch.zeros(padding_mask.shape, dtype=torch.float32, device=padding_mask.device)
    return zeros.masked_fill_(~padding_mask.bool(), NEG_INF)


def _scale(dim: int) -> float:
    """``1/√D`` computed in f32 (IEEE square root and division), as the Pallas
    kernel and the CUDA kernel compute it; a host number, so that nothing is
    copied to the device (CUDA graphs capture these functions)."""
    return float(np.float32(1.0) / np.sqrt(np.float32(dim)))


def _scores(q: torch.Tensor, k: torch.Tensor, kv_bias: torch.Tensor, causal: bool, rows, cols) -> torch.Tensor:
    """f32 scores of query ``rows`` against key ``cols`` (index tensors of the
    slices given), per-key bias added, causal entries replaced by ``NEG_INF``;
    in place on the product, which is a fresh tensor."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).mul_(_scale(q.shape[-1])).add_(kv_bias[:, None, None, :])
    if causal:
        s.masked_fill_(cols[None, :] > rows[:, None], NEG_INF)
    return s


def flash_attention_tiled_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_bias: torch.Tensor, causal: bool = True
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel: ``(out, lse)``, with the whole
    ``[B, H, L, L]`` score tensor in f32 (the JAX test's ``reference``).

    Scores at or below ``NEG_INF / 2`` get probability exactly 0, so a row with
    no valid key gives out 0 and lse ``NEG_INF``, as the kernel's."""
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    positions = torch.arange(q.shape[2], device=q.device)
    s = _scores(qf, kf, kv_bias.to(torch.float32), causal, positions, positions)
    row_max = s.amax(dim=-1, keepdim=True)
    probs = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - row_max))
    denom = probs.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vf) / denom
    lse = torch.where(row_max <= NEG_INF / 2, NEG_INF, row_max + torch.log(denom))[..., 0]
    return out.to(q.dtype), lse


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_bias: torch.Tensor) -> None:
    """Raise on anything neither variant of the kernel takes: types and shapes
    first, then the device."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        msg = f"q, k, v must share one dtype of {_DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}"
        raise TypeError(msg)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        msg = f"q, k, v must be [B, H, L, D] of one shape, got {q.shape}, {k.shape}, {v.shape}"
        raise ValueError(msg)
    batch, _, length, dim = q.shape
    if not 1 <= dim <= MAX_HEAD_DIM:
        msg = f"head dim {dim} outside the kernel's 1..{MAX_HEAD_DIM}"
        raise ValueError(msg)
    if tuple(kv_bias.shape) != (batch, length) or not kv_bias.is_floating_point():
        msg = f"kv_bias must be a float [B, L] = [{batch}, {length}], got {kv_bias.dtype} {tuple(kv_bias.shape)}"
        raise ValueError(msg)
    devices = {t.device for t in (q, k, v, kv_bias)}
    if len(devices) != 1 or q.device.type != "cuda":
        msg = f"flash_attention_tiled kernel needs q, k, v and kv_bias on one CUDA device, got {devices}"
        raise ValueError(msg)


def _launch(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_bias: torch.Tensor, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel's variant for these inputs on the current stream;
    raises if the launch is refused."""
    _check(q, k, v, kv_bias)
    variant = _variant(q.dtype, q.shape[-1])
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if variant != "simt":  # the tensor-core variants' 16-byte copies
        q, k, v = build.aligned(q), build.aligned(k), build.aligned(v)
    kv_bias = kv_bias.to(torch.float32).contiguous()
    batch, heads, length, dim = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((batch, heads, length), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    fn = getattr(build.load(KERNEL), _ENTRY_POINTS[variant])
    pointers = (q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_bias.data_ptr(), out.data_ptr(), lse.data_ptr())
    sizes = (batch, heads, length, dim, int(causal))
    if variant == "simt":
        sizes += (int(q.dtype == torch.bfloat16),)
    fn.argtypes = [ctypes.c_void_p] * len(pointers) + [ctypes.c_int] * len(sizes) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(*pointers, *sizes, stream)
    if err != 0:
        msg = f"flash_attention_tiled kernel ({variant}) launch failed: CUDA error {err} at q{tuple(q.shape)} {q.dtype}"
        raise RuntimeError(msg)
    counts.launched(flash_attention_tiled, stream, variant)
    return out, lse


@torch.library.custom_op("replay_tpu_torch::flash_attention_tiled_forward", mutates_args=())
def _forward_op(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_bias: torch.Tensor, causal: bool
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward as a registered operator, so that ``torch.export`` keeps it
    as one node of a serialized program (``nn/compiled.py``) and a loaded
    program runs the kernel: ``(out, lse)`` from the plain version for tensors
    all on the CPU, otherwise from the kernel, or raise."""
    if all(t.device.type == "cpu" for t in (q, k, v, kv_bias)):
        return flash_attention_tiled_reference(q, k, v, kv_bias, causal)
    return _launch(q, k, v, kv_bias, causal)


@_forward_op.register_fake
def _(q, k, v, kv_bias, causal):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


def _forward(q, k, v, kv_bias, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version for tensors all on the CPU; otherwise the kernel, or
    raise. CPU and CUDA tensors go through the operator; the checks run first,
    and a tensor on any other device goes straight to the launch, never to the
    operator's shape-only fake."""
    tensors = (q, k, v, kv_bias)
    if not all(t.device.type == "cpu" for t in tensors):
        _check(q, k, v, kv_bias)
        if not all(t.device.type == "cuda" for t in tensors):
            return _launch(q, k, v, kv_bias, causal)
    return _forward_op(q, k, v, kv_bias, causal)


def _backward_block(q_rows, kj, vj, g_rows, bias_j, lse_rows, delta_rows, causal: bool, rows, cols, bias_grad: bool):
    """One key block of the backward: ``(dq part, dk, dv, dbias)`` of its keys
    (dbias ``None`` unless ``bias_grad``)."""
    scale = _scale(q_rows.shape[-1])
    s = _scores(q_rows, kj, bias_j, causal, rows, cols)
    masked = s <= NEG_INF / 2
    p = s.sub_(lse_rows[..., None]).exp_().masked_fill_(masked, 0.0)  # exp(s - lse), 0 where masked
    dv_j = torch.einsum("bhqk,bhqd->bhkd", p, g_rows)
    ds = torch.einsum("bhqd,bhkd->bhqk", g_rows, vj).sub_(delta_rows[..., None]).mul_(p)  # P·(dP − delta)
    dk_j = torch.einsum("bhqk,bhqd->bhkd", ds, q_rows) * scale
    dq_part = torch.einsum("bhqk,bhkd->bhqd", ds, kj) * scale
    return dq_part, dk_j, dv_j, torch.sum(ds, dim=(1, 2)) if bias_grad else None


def flash_attention_tiled_backward(
    q, k, v, kv_bias, out, lse, grad_out, causal: bool = True, block_k: int = 256, bias_grad: bool = True
):
    """Gradients of ``flash_attention_tiled`` w.r.t. ``q, k, v, kv_bias``, the
    JAX ``_bwd`` as torch ops: ``delta = Σ g·out``, then per key block of
    ``block_k`` the probabilities ``exp(s − lse)`` (0 at masked scores), ``dv``,
    ``dS = P·(dP − delta)``, ``dk`` and ``dq`` scaled by ``1/√D``, and ``dbias``
    summed over heads and queries (``None`` when ``bias_grad`` is false, as on
    the training path, where the padding bias is a constant). In f32; each
    gradient is cast back to its input's dtype. Causal: a block's rows above its first key see none of its
    keys (their dS is exactly 0) and are skipped, as the forward skips the key
    tiles above the diagonal. A block's temporaries are updated in place and
    die with it: about two ``[B, H, L, block_k]`` f32 tensors at a time."""
    batch, heads, length, dim = q.shape
    qf, kf, vf, gf = (t.to(torch.float32) for t in (q, k, v, grad_out))
    bias = kv_bias.to(torch.float32)
    scale = _scale(dim)
    delta = torch.sum(gf * out.to(torch.float32), dim=-1)  # [B, H, L]
    positions = torch.arange(length, device=q.device)
    block = min(block_k, max(length, 1))
    dq = torch.zeros_like(qf)
    dk, dv = torch.empty_like(kf), torch.empty_like(vf)
    dbias = torch.empty((batch, length), dtype=torch.float32, device=q.device) if bias_grad else None
    for start in range(0, length, block):
        keys = slice(start, min(start + block, length))
        rows = slice(start if causal else 0, length)
        dq_part, dk[:, :, keys], dv[:, :, keys], dbias_j = _backward_block(
            qf[:, :, rows], kf[:, :, keys], vf[:, :, keys], gf[:, :, rows], bias[:, keys],
            lse[:, :, rows], delta[:, :, rows], causal, positions[rows], positions[keys], bias_grad,
        )
        dq[:, :, rows] += dq_part
        if bias_grad:
            dbias[:, keys] = dbias_j
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias.to(kv_bias.dtype) if bias_grad else None


class _FlashAttentionTiled(torch.autograd.Function):
    """The kernel's forward with :func:`flash_attention_tiled_backward` as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, kv_bias, causal, block_k):
        out, lse = _forward(q, k, v, kv_bias, causal)
        ctx.save_for_backward(q, k, v, kv_bias, out, lse)
        ctx.causal, ctx.block_k = causal, block_k
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, kv_bias, out, lse = ctx.saved_tensors
        dq, dk, dv, dbias = flash_attention_tiled_backward(
            q, k, v, kv_bias, out, lse, grad_out, ctx.causal, ctx.block_k, bias_grad=ctx.needs_input_grad[3]
        )
        return dq, dk, dv, dbias, None, None


def flash_attention_tiled(
    q: torch.Tensor,  # [B, H, L, D]
    k: torch.Tensor,
    v: torch.Tensor,
    kv_bias: torch.Tensor,  # [B, L] additive per-key bias (0 valid / NEG_INF pad)
    causal: bool = True,
    block_q: int = 256,
    block_k: int = 256,
) -> torch.Tensor:
    """Length-tiled fused attention, differentiable; ``[B, H, L, D]`` in ``q.dtype``.

    On CPU tensors the forward is the plain version; on CUDA tensors it
    launches the kernel or raises. ``block_q`` is the JAX signature's (the
    kernel picks its own tiles); ``block_k`` sets the backward's key blocks.
    Where no gradient is needed the operator is called without the Function
    around it. ``flash_attention_tiled.launches`` counts kernel launches, and
    ``flash_attention_tiled.launches_by_variant`` splits them by variant
    (:mod:`replay_tpu_torch.ops.counts`)."""
    if block_q < 1 or block_k < 1:
        msg = f"block_q and block_k must be positive, got {block_q}, {block_k}"
        raise ValueError(msg)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, kv_bias)):
        return _FlashAttentionTiled.apply(q, k, v, kv_bias, bool(causal), int(block_k))
    return _forward(q, k, v, kv_bias, bool(causal))[0]


flash_attention_tiled.launches = 0
flash_attention_tiled.launches_by_variant = dict.fromkeys(VARIANTS, 0)
