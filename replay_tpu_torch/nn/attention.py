"""Attention modules.

Counterpart of ``replay_tpu/nn/attention.py``: ``dot_product_attention`` on the
unfused route (scale and scores in ``q.dtype``), on the ``use_flash=True``
route (kernel K4, f32 inside, cast back to ``q.dtype``) and on the
``use_flash="tiled"`` route (kernel K5, the long-sequence route: causal and
key-padding structure rebuilt from the ``[B, L]`` padding mask, no
``[B, 1, L, L]`` mask), and the standard ``MultiHeadAttention``. The
projections are four ``Dense`` layers with bias named ``query``/``key``/
``value``/``out``, as the flax module's four ``Dense`` — not
``nn.MultiheadAttention``'s fused ``in_proj`` — so weights map one to one; they
compute in the module's ``dtype``.

Also ``RMSNorm`` and ``MultiHeadDifferentialAttention`` (Differential
Transformer attention, arXiv 2410.05258: two softmax maps per head, the second
subtracted with a learned λ, a per-head ``RMSNorm`` and the ``1 − λ_init``
output scale). Its query and key projections split into ``2H`` maps that
alternate between a head's first and second map (``w1 = maps[:, 0::2]``,
``w2 = maps[:, 1::2]``), and its values into ``H`` maps of width
``2·head_dim``, as the JAX module splits them. It runs on the unfused route
only, with the ``[B, 1, L, L]`` mask, whatever route the model names: the JAX
module has no kernel route either.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from replay_tpu_torch.nn.layers import Dense
from replay_tpu_torch.nn.mask import require_ported_route
from replay_tpu_torch.nn.utils import init_dense
from replay_tpu_torch.obs import health
from replay_tpu_torch.ops.flash_attention import flash_attention
from replay_tpu_torch.ops.flash_tiled import flash_attention_tiled, padding_mask_bias


def dot_product_attention(
    q: torch.Tensor,  # [B, H, L, D]
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor],  # additive [B, 1 or H, L, L]; None on the "tiled" route
    use_flash=False,  # False | True (kernel K4) | "tiled" (kernel K5)
    padding_mask: Optional[torch.Tensor] = None,  # [B, L] bool, required for "tiled"
    causal: bool = True,
    return_weights: bool = False,  # the unfused route only: also the [B, H, L, L] weights
):
    require_ported_route(use_flash)
    if return_weights and use_flash:
        msg = "return_weights needs the unfused route: kernels K4 and K5 never build the weights"
        raise ValueError(msg)
    if use_flash == "tiled":
        if padding_mask is None:
            msg = "use_flash='tiled' needs the [B, L] padding_mask"
            raise ValueError(msg)
        if mask is not None:
            # the tiled kernel rebuilds attention structure from (causal,
            # padding) alone; a custom additive mask would be silently dropped
            msg = "use_flash='tiled' cannot honor an additive mask; pass mask=None"
            raise ValueError(msg)
        return flash_attention_tiled(q, k, v, padding_mask_bias(padding_mask), causal).to(q.dtype)
    if use_flash:
        return flash_attention(q, k, v, mask).to(q.dtype)
    # a fill on the device, not a host copy: CUDA graphs capture this route too
    scale = 1.0 / torch.sqrt(torch.full((), q.shape[-1], dtype=q.dtype, device=q.device))
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale + mask.to(q.dtype)
    weights = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", weights, v)
    return (out, weights) if return_weights else out


class MultiHeadAttention(nn.Module):
    """Standard multi-head self-attention.

    ``use_flash=True`` routes through kernel K4
    (:mod:`replay_tpu_torch.ops.flash_attention`) with the additive mask;
    ``use_flash="tiled"`` through kernel K5 (:mod:`replay_tpu_torch.ops.flash_tiled`),
    which takes the raw ``padding_mask`` and ``causal`` flag instead."""

    def __init__(
        self,
        embedding_dim: int,
        num_heads: int,
        dropout_rate: float = 0.0,
        use_flash=False,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        if embedding_dim % num_heads:
            msg = f"embedding dim {embedding_dim} not divisible by {num_heads} heads"
            raise ValueError(msg)
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.use_flash = use_flash
        self.query = Dense(embedding_dim, embedding_dim, dtype)
        self.key = Dense(embedding_dim, embedding_dim, dtype)
        self.value = Dense(embedding_dim, embedding_dim, dtype)
        self.out = Dense(embedding_dim, embedding_dim, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for dense in (self.query, self.key, self.value, self.out):
            init_dense(dense, generator)

    def forward(
        self,
        x: torch.Tensor,
        mask: Optional[torch.Tensor],
        deterministic: bool = True,
        padding_mask: Optional[torch.Tensor] = None,
        causal: bool = True,
    ) -> torch.Tensor:
        *lead, dim = x.shape
        head_dim = dim // self.num_heads

        def split(proj: Dense) -> torch.Tensor:
            return proj(x).reshape(*lead, self.num_heads, head_dim).transpose(-3, -2)

        q, k, v = split(self.query), split(self.key), split(self.value)
        if not self.use_flash and health.capturing():
            # a health step on the unfused route: the same ops, and the
            # per-head entropy of the weights they built (the kernel routes
            # never build them, as in JAX)
            out, weights = dot_product_attention(q, k, v, mask, causal=causal, return_weights=True)
            health.sow("attention_entropy", health.attention_entropy(weights, padding_mask))
        else:
            out = dot_product_attention(
                q, k, v, mask, use_flash=self.use_flash, padding_mask=padding_mask, causal=causal,
            )
        out = self.out(out.transpose(-3, -2).reshape(*lead, dim))
        return F.dropout(out, self.dropout_rate, training=not deterministic)


class RMSNorm(nn.Module):
    """RMS normalization over the last axis (no mean subtraction), in the
    input's dtype; the flax ``scale`` is ``weight`` here."""

    def __init__(self, dim: int, epsilon: float = 1e-6, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.epsilon = epsilon
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(dim))

    @torch.no_grad()
    def reset_parameters(self) -> None:
        nn.init.ones_(self.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        norm = torch.sqrt(torch.mean(torch.square(x), dim=-1, keepdim=True) + self.epsilon)
        return x / norm * self.weight.to(x.dtype)


class MultiHeadDifferentialAttention(nn.Module):
    """Differential attention: softmax(Q1K1) - lambda * softmax(Q2K2) per head.

    lambda = exp(lq1 . lk1) - exp(lq2 . lk2) + lambda_init, with per-head RMSNorm and
    the (1 - lambda_init) output scaling from the paper. The four projections
    have no bias."""

    def __init__(
        self,
        embedding_dim: int,
        num_heads: int,
        lambda_init: float = 0.8,
        dropout_rate: float = 0.0,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        if embedding_dim % (2 * num_heads):
            msg = f"embedding dim {embedding_dim} must be divisible by 2*num_heads ({2 * num_heads})"
            raise ValueError(msg)
        self.num_heads = num_heads
        self.lambda_init = lambda_init
        self.dropout_rate = dropout_rate
        head_dim = embedding_dim // (2 * num_heads)
        self.query = Dense(embedding_dim, embedding_dim, dtype, bias=False)
        self.key = Dense(embedding_dim, embedding_dim, dtype, bias=False)
        self.value = Dense(embedding_dim, embedding_dim, dtype, bias=False)
        self.lambda_q1 = nn.Parameter(torch.zeros(head_dim))
        self.lambda_k1 = nn.Parameter(torch.zeros(head_dim))
        self.lambda_q2 = nn.Parameter(torch.zeros(head_dim))
        self.lambda_k2 = nn.Parameter(torch.zeros(head_dim))
        self.head_norm = RMSNorm(2 * head_dim, dtype=dtype)
        self.out = Dense(embedding_dim, embedding_dim, dtype, bias=False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for dense in (self.query, self.key, self.value):
            init_dense(dense, generator)
        for lam in (self.lambda_q1, self.lambda_k1, self.lambda_q2, self.lambda_k2):
            nn.init.normal_(lam, std=0.1, generator=generator)
        self.head_norm.reset_parameters()
        init_dense(self.out, generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        *lead, dim = x.shape
        maps = 2 * self.num_heads
        head_dim = dim // maps
        # two attention maps per head, interleaved: [B, 2H, L, D/2H]
        q = self.query(x).reshape(*lead, maps, head_dim).transpose(-3, -2)
        k = self.key(x).reshape(*lead, maps, head_dim).transpose(-3, -2)
        v = self.value(x).reshape(*lead, self.num_heads, 2 * head_dim).transpose(-3, -2)
        # a fill on the device, not a host copy: CUDA graphs capture this too
        scale = 1.0 / torch.sqrt(torch.full((), head_dim, dtype=x.dtype, device=x.device))
        scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale + mask.to(x.dtype)
        weights = torch.softmax(scores, dim=-1)
        w1, w2 = weights[:, 0::2], weights[:, 1::2]  # [B, H, L, L]
        lam = (
            torch.exp(torch.dot(self.lambda_q1, self.lambda_k1))
            - torch.exp(torch.dot(self.lambda_q2, self.lambda_k2))
            + self.lambda_init
        ).to(x.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", w1 - lam * w2, v)  # [B, H, L, 2*head_dim]
        out = self.head_norm(out) * (1.0 - self.lambda_init)
        out = self.out(out.transpose(-3, -2).reshape(*lead, dim))
        return F.dropout(out, self.dropout_rate, training=not deterministic)
