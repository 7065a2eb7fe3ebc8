"""SASRec encoder stack.

Counterpart of ``replay_tpu/nn/sequential/sasrec/transformer.py``: ``_SasRecBlock``
(pre-LN multi-head attention + point-wise FFN) and ``SasRecTransformerLayer`` (N
such blocks, each output multiplied by the padding ``keep`` mask). LayerNorm
epsilon is flax's 1e-6, not torch's default 1e-5. ``remat`` and ``scan_blocks``
come with the training slice; the differential-transformer encoder later still.
"""

from __future__ import annotations

import torch
from torch import nn

from replay_tpu_torch.nn.attention import MultiHeadAttention
from replay_tpu_torch.nn.ffn import PointWiseFeedForward

LAYER_NORM_EPS = 1e-6  # flax nn.LayerNorm's default


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
    ) -> None:
        super().__init__()
        self.attn_norm = nn.LayerNorm(embedding_dim, eps=LAYER_NORM_EPS)
        self.attention = MultiHeadAttention(
            embedding_dim, num_heads, dropout_rate=dropout_rate, use_flash=use_flash
        )
        self.ffn_norm = nn.LayerNorm(embedding_dim, eps=LAYER_NORM_EPS)
        self.ffn = PointWiseFeedForward(
            embedding_dim, hidden_dim, dropout_rate=dropout_rate, activation=activation
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn_norm.reset_parameters()
        self.attention.reset_parameters(generator)
        self.ffn_norm.reset_parameters()
        self.ffn.reset_parameters(generator)

    def forward(self, x, attention_mask, keep, deterministic: bool = True):
        x = x + self.attention(self.attn_norm(x), attention_mask, deterministic=deterministic)
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
    ) -> None:
        super().__init__()
        self.num_blocks = num_blocks
        for i in range(num_blocks):
            self.add_module(
                f"block_{i}",
                _SasRecBlock(
                    embedding_dim, num_heads, hidden_dim, dropout_rate=dropout_rate,
                    activation=activation, use_flash=use_flash,
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
        attention_mask: torch.Tensor,
        padding_mask: torch.Tensor,
        deterministic: bool = True,
    ) -> torch.Tensor:
        keep = padding_mask[..., None].to(x.dtype)
        for block in self.blocks():
            x = block(x, attention_mask, keep, deterministic)
        return x
