"""Kernel K4: fused masked softmax attention, forward, on Hopper.

Replaces ``replay_tpu/ops/flash_attention.py::_attention_kernel`` (the Pallas
kernel behind ``SasRec(use_flash=True)``): for each (batch, head),
``softmax(Q·Kᵀ/√D + bias)·V`` in f32 whatever the input type, denominator
clamped at 1e-30, output in ``q.dtype``. ``bias`` is ``[B, 1 or H, L, L]``; one
with a single head is read per head, never broadcast in memory.

The kernel is ``replay_tpu_torch/csrc/flash_attention.cu`` (CUDA C++ for
``sm_90a``, plain C interface, loaded with ctypes; built at first use by
:mod:`replay_tpu_torch.ops.build`). Its design: one block per (16 or 4 query
rows, head, batch). When K and V of the whole key range fit in shared memory
(L ≤ 192 at D = 64: SASRec's serving and training windows) the block stages
them once with 16-byte loads and runs one exact softmax pass, as the Pallas
kernel does; beyond that it walks 64-key tiles with an online softmax. A warp
owns its rows, a lane several keys with independent accumulators for the
scores and D/32 columns for ``P·V``, so no serial chain is longer than D or L.

What bounds it at the serving shape: B=64, H=1, L=50, D=64 in f32 moves 3.3 MB
of q/k/v/out and 0.64 MB of bias, about 1.2 µs at the H100's 3.35 TB/s, and
does 4·B·H·L²·D = 41 MFLOP, 0.6 µs at 67 TFLOP/s of f32 outside the tensor
cores. So it is bound by memory and, below a few µs, by latency: one round of
loads and the longest dependent chain in a block, which the design shortens.
It uses no tensor cores. Its time on the card is in ``PERF.md``, measured by
``chip_smoke.py``.

Training goes through ``_FlashAttention``, a ``torch.autograd.Function`` that
mirrors the JAX ``jax.custom_vjp`` (``flash_attention`` with ``_flash_fwd`` /
``_flash_bwd``): the forward is the kernel (the plain version on the CPU) and
saves only ``q, k, v, bias``; the backward recomputes the probabilities in f32
and applies the softmax-attention gradients as torch ops, as the JAX backward
is plain jnp. A backward kernel is later speed work (``ROADMAP.md`` queue 2).
"""

from __future__ import annotations

import ctypes
import math

import torch

from replay_tpu_torch.ops import build, counts

KERNEL = "flash_attention"
MAX_HEAD_DIM = 256
_DTYPES = (torch.float32, torch.bfloat16)


def flash_attention_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """The plain PyTorch version of the kernel: the Pallas kernel's arithmetic,
    step for step, in f32."""
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf) / math.sqrt(q.shape[-1])
    scores = scores + bias.to(torch.float32)
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    denom = probs.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bhkd->bhqd", probs / denom, vf).to(q.dtype)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor) -> None:
    """Raise on anything the kernel does not take."""
    devices = {t.device for t in (q, k, v, bias)}
    if len(devices) != 1 or q.device.type != "cuda":
        msg = f"flash_attention kernel needs q, k, v and bias on one CUDA device, got {devices}"
        raise ValueError(msg)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        msg = f"q, k, v must share one dtype of {_DTYPES}, got {q.dtype}, {k.dtype}, {v.dtype}"
        raise TypeError(msg)
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        msg = f"q, k, v must be [B, H, L, D] of one shape, got {q.shape}, {k.shape}, {v.shape}"
        raise ValueError(msg)
    batch, heads, length, dim = q.shape
    if not 1 <= dim <= MAX_HEAD_DIM:
        msg = f"head dim {dim} outside the kernel's 1..{MAX_HEAD_DIM}"
        raise ValueError(msg)
    if bias.dim() != 4 or bias.shape[1] not in (1, heads) or bias.shape != (batch, bias.shape[1], length, length):
        msg = f"bias must be [B, 1 or H, L, L] = [{batch}, 1|{heads}, {length}, {length}], got {tuple(bias.shape)}"
        raise ValueError(msg)
    if not bias.is_floating_point():
        msg = f"bias must be a float tensor, got {bias.dtype}"
        raise TypeError(msg)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; raises if the launch is refused."""
    _check(q, k, v, bias)
    q, k, v = (build.aligned(t.contiguous()) for t in (q, k, v))
    bias = bias.to(torch.float32).contiguous()
    out = torch.empty_like(q)
    batch, heads, length, dim = q.shape
    if out.numel() == 0:
        return out
    lib = build.load(KERNEL)
    fn = lib.replay_flash_attention_forward
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), out.data_ptr(),
            batch, heads, length, dim, bias.shape[1], int(q.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        msg = f"flash_attention kernel launch failed: CUDA error {err} at q{tuple(q.shape)} {q.dtype}"
        raise RuntimeError(msg)
    counts.launched(flash_attention, stream)
    return out


@torch.library.custom_op("replay_tpu_torch::flash_attention_forward", mutates_args=())
def _forward_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The forward as a registered operator, so that ``torch.export`` keeps it
    as one node of a serialized program (``nn/compiled.py``) and a loaded
    program runs the kernel: the plain version for tensors all on the CPU,
    otherwise the kernel, or raise."""
    if all(t.device.type == "cpu" for t in (q, k, v, bias)):
        return flash_attention_reference(q, k, v, bias)
    return _launch(q, k, v, bias)


@_forward_op.register_fake
def _(q, k, v, bias):
    return torch.empty_like(q)


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The plain version for tensors all on the CPU; otherwise the kernel, or
    raise. CPU and CUDA tensors go through the operator; the checks run first,
    and a tensor on any other device goes straight to the launch, never to the
    operator's shape-only fake."""
    tensors = (q, k, v, bias)
    if not all(t.device.type == "cpu" for t in tensors):
        _check(q, k, v, bias)
        if not all(t.device.type == "cuda" for t in tensors):
            return _launch(q, k, v, bias)
    return _forward_op(q, k, v, bias)


def flash_attention_backward(q, k, v, bias, grad_out):
    """Gradients of ``flash_attention`` w.r.t. ``q, k, v, bias``, line for line
    the JAX ``_flash_bwd``: the probabilities recomputed in f32, the softmax
    backward ``dS = P·(dP − Σ dP·P)``, the scale on ``dq`` and ``dk``, and a
    head-invariant ``[B, 1, L, L]`` bias gets ``dS`` summed over heads. Each
    gradient is cast back to its input's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf, g = (t.to(torch.float32) for t in (q, k, v, grad_out))
    # rematerialize the attention weights
    scores = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale + bias.to(torch.float32)
    probs = torch.softmax(scores, dim=-1)
    grad_v = torch.einsum("bhqk,bhqd->bhkd", probs, g)
    grad_probs = torch.einsum("bhqd,bhkd->bhqk", g, vf)
    # softmax backward: dS = P * (dP - sum_k dP * P)
    grad_scores = probs * (grad_probs - torch.sum(grad_probs * probs, dim=-1, keepdim=True))
    grad_q = torch.einsum("bhqk,bhkd->bhqd", grad_scores, kf) * scale
    grad_k = torch.einsum("bhqk,bhqd->bhkd", grad_scores, qf) * scale
    grad_bias = grad_scores
    if bias.shape[1] == 1:  # head-invariant mask: sum the broadcast axis
        grad_bias = torch.sum(grad_bias, dim=1, keepdim=True)
    return grad_q.to(q.dtype), grad_k.to(k.dtype), grad_v.to(v.dtype), grad_bias.to(bias.dtype)


class _FlashAttention(torch.autograd.Function):
    """The kernel's forward with :func:`flash_attention_backward` as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        return _forward(q, k, v, bias)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, bias = ctx.saved_tensors
        grad_q, grad_k, grad_v, grad_bias = flash_attention_backward(q, k, v, bias, grad_out)
        return grad_q, grad_k, grad_v, grad_bias if ctx.needs_input_grad[3] else None


def flash_attention(
    q: torch.Tensor,  # [B, H, L, D]
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,  # [B, 1 or H, L, L] additive mask
) -> torch.Tensor:
    """Fused softmax attention, differentiable.

    On CPU tensors the forward is the plain version; on CUDA tensors it
    launches the kernel or raises. The gradient is
    :func:`flash_attention_backward` on either device; where no gradient is
    needed the operator is called without the Function around it.
    ``flash_attention.launches`` counts kernel launches
    (:mod:`replay_tpu_torch.ops.counts`)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
        return _FlashAttention.apply(q, k, v, bias)
    return _forward(q, k, v, bias)


flash_attention.launches = 0
