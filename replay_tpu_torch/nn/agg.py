"""Aggregators: merge the per-feature embedding dict into one [B, L, E] tensor.

Counterpart of ``replay_tpu/nn/agg.py``: ``SumAggregator`` and
``PositionAwareAggregator`` (scale by √d, add a learned positional table,
dropout — the SASRec input block), in the embeddings' dtype: the √d factor and
the positional rows are cast to it first, as the JAX module casts them; and
``ConcatAggregator`` (the features concatenated in sorted-key order, then a
``Dense`` named ``proj``). flax's ``Dense`` learns its input width at the first
call; here it is the ``input_dim`` argument, the sum of the features' widths.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from replay_tpu_torch.nn.layers import Dense
from replay_tpu_torch.nn.utils import init_dense


class SumAggregator(nn.Module):
    """Elementwise sum of all feature embeddings (they must share a dim)."""

    def forward(self, embeddings: Dict[str, torch.Tensor]) -> torch.Tensor:
        arrays = [embeddings[name] for name in sorted(embeddings)]
        dims = {a.shape[-1] for a in arrays}
        if len(dims) != 1:
            msg = f"SumAggregator requires equal embedding dims, got {sorted(dims)}"
            raise ValueError(msg)
        total = arrays[0]
        for a in arrays[1:]:
            total = total + a
        return total


class ConcatAggregator(nn.Module):
    """Concatenate embeddings in sorted-key order and project to ``output_dim``."""

    def __init__(self, input_dim: int, output_dim: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.proj = Dense(input_dim, output_dim, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_dense(self.proj, generator)

    def forward(self, embeddings: Dict[str, torch.Tensor]) -> torch.Tensor:
        stacked = torch.cat([embeddings[name] for name in sorted(embeddings)], dim=-1)
        return self.proj(stacked)


class PositionAwareAggregator(nn.Module):
    """Sum features, scale by sqrt(d), add learned positional embeddings, dropout.

    ``max_sequence_length`` bounds the positional table; shorter inputs take its tail
    so the most-recent position always maps to the last table row.
    """

    def __init__(self, embedding_dim: int, max_sequence_length: int, dropout_rate: float = 0.0) -> None:
        super().__init__()
        self.embedding_dim = embedding_dim
        self.max_sequence_length = max_sequence_length
        self.dropout_rate = dropout_rate
        self.sum = SumAggregator()
        self.positional_embedding = nn.Parameter(torch.zeros(max_sequence_length, embedding_dim))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.normal_(self.positional_embedding, std=0.02, generator=generator)

    def forward(self, embeddings: Dict[str, torch.Tensor], deterministic: bool = True) -> torch.Tensor:
        total = self.sum(embeddings)
        seq_len = total.shape[-2]
        if seq_len > self.max_sequence_length:
            msg = (
                f"Sequence length {seq_len} exceeds positional table size "
                f"{self.max_sequence_length}"
            )
            raise ValueError(msg)
        # a 0-dim CPU tensor, which a CUDA op reads as a scalar
        factor = torch.tensor(math.sqrt(float(self.embedding_dim)), dtype=torch.float32).to(total.dtype)
        scaled = total * factor
        out = scaled + self.positional_embedding[self.max_sequence_length - seq_len :].to(total.dtype)
        return F.dropout(out, self.dropout_rate, training=not deterministic)
