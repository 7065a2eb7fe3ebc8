"""Attention modules.

Counterpart of ``replay_tpu/nn/attention.py``: ``dot_product_attention`` on the
unfused route (scale and scores in ``q.dtype``) and on the ``use_flash=True``
route (kernel K4, f32 inside, cast back to ``q.dtype``), and the standard
``MultiHeadAttention`` with an additive [B, 1, L, L] mask. The projections are
four ``Linear`` layers with bias named ``query``/``key``/``value``/``out``, as
the flax module's four ``Dense`` — not ``nn.MultiheadAttention``'s fused
``in_proj`` — so weights map one to one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from replay_tpu_torch.nn.mask import require_ported_route
from replay_tpu_torch.nn.utils import init_dense
from replay_tpu_torch.ops.flash_attention import flash_attention


def dot_product_attention(
    q: torch.Tensor,  # [B, H, L, D]
    k: torch.Tensor,
    v: torch.Tensor,
    mask: torch.Tensor,  # additive [B, 1 or H, L, L]
    use_flash=False,  # False | True (kernel K4)
) -> torch.Tensor:
    require_ported_route(use_flash)
    if use_flash:
        return flash_attention(q, k, v, mask).to(q.dtype)
    scale = 1.0 / torch.sqrt(torch.tensor(q.shape[-1], dtype=q.dtype, device=q.device))
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale + mask.to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), v)


class MultiHeadAttention(nn.Module):
    """Standard multi-head self-attention with an additive mask.

    ``use_flash=True`` routes through kernel K4
    (:mod:`replay_tpu_torch.ops.flash_attention`)."""

    def __init__(
        self,
        embedding_dim: int,
        num_heads: int,
        dropout_rate: float = 0.0,
        use_flash=False,
    ) -> None:
        super().__init__()
        if embedding_dim % num_heads:
            msg = f"embedding dim {embedding_dim} not divisible by {num_heads} heads"
            raise ValueError(msg)
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.use_flash = use_flash
        self.query = nn.Linear(embedding_dim, embedding_dim)
        self.key = nn.Linear(embedding_dim, embedding_dim)
        self.value = nn.Linear(embedding_dim, embedding_dim)
        self.out = nn.Linear(embedding_dim, embedding_dim)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for dense in (self.query, self.key, self.value, self.out):
            init_dense(dense, generator)

    def forward(self, x: torch.Tensor, mask: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        *lead, dim = x.shape
        head_dim = dim // self.num_heads

        def split(proj: nn.Linear) -> torch.Tensor:
            return proj(x).reshape(*lead, self.num_heads, head_dim).transpose(-3, -2)

        out = dot_product_attention(
            split(self.query), split(self.key), split(self.value), mask, use_flash=self.use_flash
        )
        out = self.out(out.transpose(-3, -2).reshape(*lead, dim))
        return F.dropout(out, self.dropout_rate, training=not deterministic)
