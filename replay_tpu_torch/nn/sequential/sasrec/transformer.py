"""SASRec encoder stack.

Counterpart of ``replay_tpu/nn/sequential/sasrec/transformer.py``: ``_SasRecBlock``
(pre-LN multi-head attention + point-wise FFN) and ``SasRecTransformerLayer`` (N
such blocks, each output multiplied by the padding ``keep`` mask). LayerNorm
epsilon is flax's 1e-6, not torch's default 1e-5. Every block computes in the
stack's ``dtype`` and receives the ``[B, L]`` padding mask and the causal flag
on every route: the ``"tiled"`` route builds its mask from them. ``remat``,
``scan_blocks`` and the differential-transformer encoder are later slices.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from replay_tpu_torch.nn.attention import MultiHeadAttention
from replay_tpu_torch.nn.ffn import PointWiseFeedForward
from replay_tpu_torch.nn.layers import LayerNorm
from replay_tpu_torch.obs.health import sow_scope, sow_stage_stats


class _SasRecBlock(nn.Module):
    """One pre-LN block: LayerNorm → MHA → residual → LayerNorm → FFN."""

    def __init__(
        self,
        embedding_dim: int,
        num_heads: int,
        hidden_dim: int,
        dropout_rate: float = 0.0,
        activation: str = "gelu",
        use_flash=False,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.attn_norm = LayerNorm(embedding_dim, dtype)
        self.attention = MultiHeadAttention(
            embedding_dim, num_heads, dropout_rate=dropout_rate, use_flash=use_flash, dtype=dtype
        )
        self.ffn_norm = LayerNorm(embedding_dim, dtype)
        self.ffn = PointWiseFeedForward(
            embedding_dim, hidden_dim, dropout_rate=dropout_rate, activation=activation, dtype=dtype
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn_norm.reset_parameters()
        self.attention.reset_parameters(generator)
        self.ffn_norm.reset_parameters()
        self.ffn.reset_parameters(generator)

    def forward(self, x, attention_mask, keep, deterministic: bool = True, padding_mask=None, causal: bool = True):
        x = x + self.attention(
            self.attn_norm(x), attention_mask, deterministic=deterministic,
            padding_mask=padding_mask, causal=causal,
        )
        x = self.ffn(self.ffn_norm(x), deterministic=deterministic)
        return x * keep


class SasRecTransformerLayer(nn.Module):
    """N pre-LN blocks: LayerNorm → MHA → residual → LayerNorm → point-wise FFN."""

    def __init__(
        self,
        embedding_dim: int,
        num_blocks: int,
        num_heads: int,
        hidden_dim: int,
        dropout_rate: float = 0.0,
        activation: str = "gelu",
        use_flash=False,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(
                f"block_{i}",
                _SasRecBlock(
                    embedding_dim, num_heads, hidden_dim, dropout_rate=dropout_rate,
                    activation=activation, use_flash=use_flash, dtype=dtype,
                ),
            )

    def blocks(self):
        return [getattr(self, f"block_{i}") for i in range(self.num_blocks)]

    def reset_parameters(self, generator: torch.Generator) -> None:
        for block in self.blocks():
            block.reset_parameters(generator)

    def forward(
        self,
        x: torch.Tensor,
        attention_mask: Optional[torch.Tensor],  # None on the "tiled" route
        padding_mask: torch.Tensor,
        deterministic: bool = True,
        causal: bool = True,
    ) -> torch.Tensor:
        keep = padding_mask[..., None].to(x.dtype)
        for i, block in enumerate(self.blocks()):
            with sow_scope(f"block_{i}"):
                x = block(x, attention_mask, keep, deterministic, padding_mask, causal)
            # model-health stage stats (a no-op outside a health capture)
            sow_stage_stats(self, f"block_{i}", x)
        return x
