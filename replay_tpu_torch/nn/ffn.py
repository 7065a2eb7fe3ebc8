"""Feed-forward blocks.

Counterpart of ``replay_tpu/nn/ffn.py``: ``PointWiseFeedForward``, the SASRec
position-wise block (dense → activation → dropout → dense → dropout →
residual; the order is part of the parity contract: relu commutes with
dropout's scaling, gelu does not), ``SwiGLU`` and ``SwiGLUEncoder`` (the
TwoTower item tower). Every dense layer computes in ``dtype`` (flax's compute
dtype; parameters stay f32). The submodules carry the flax names (``gate``,
``value``, ``out``; ``norm_{i}``, ``swiglu_{i}``, ``final_norm``,
``final_proj``), so :mod:`replay_tpu_torch.convert` maps their weights. flax
modules learn their input width at the first call; here it is the
``input_dim`` argument.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from replay_tpu_torch.nn.layers import Dense, LayerNorm
from replay_tpu_torch.nn.utils import create_activation, init_dense


class PointWiseFeedForward(nn.Module):
    """MLP applied per position with residual connection."""

    def __init__(
        self,
        embedding_dim: int,
        hidden_dim: int,
        dropout_rate: float = 0.0,
        activation: str = "gelu",
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.dropout_rate = dropout_rate
        self.activation = create_activation(activation)
        self.inner = Dense(embedding_dim, hidden_dim, dtype)
        self.outer = Dense(hidden_dim, embedding_dim, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_dense(self.inner, generator)
        init_dense(self.outer, generator)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        h = self.activation(self.inner(x))
        h = F.dropout(h, self.dropout_rate, training=not deterministic)
        h = F.dropout(self.outer(h), self.dropout_rate, training=not deterministic)
        return x + h


class SwiGLU(nn.Module):
    """SwiGLU gated unit: (silu(xW1) * xW3) W2, three bias-free dense layers."""

    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.gate = Dense(input_dim, hidden_dim, dtype, bias=False)
        self.value = Dense(input_dim, hidden_dim, dtype, bias=False)
        self.out = Dense(hidden_dim, output_dim, dtype, bias=False)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for dense in (self.gate, self.value, self.out):
            init_dense(dense, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(F.silu(self.gate(x)) * self.value(x))


class SwiGLUEncoder(nn.Module):
    """Stack of pre-norm SwiGLU blocks with residuals, then a final norm + projection."""

    def __init__(
        self,
        input_dim: int,
        num_blocks: int,
        hidden_dim: int,
        output_dim: int,
        dropout_rate: float = 0.0,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.num_blocks = num_blocks
        self.dropout_rate = dropout_rate
        for i in range(num_blocks):
            self.add_module(f"norm_{i}", LayerNorm(input_dim, dtype))
            self.add_module(f"swiglu_{i}", SwiGLU(input_dim, hidden_dim, input_dim, dtype))
        self.final_norm = LayerNorm(input_dim, dtype)
        self.final_proj = Dense(input_dim, output_dim, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(self.num_blocks):
            getattr(self, f"norm_{i}").reset_parameters()
            getattr(self, f"swiglu_{i}").reset_parameters(generator)
        self.final_norm.reset_parameters()
        init_dense(self.final_proj, generator)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        for i in range(self.num_blocks):
            h = getattr(self, f"swiglu_{i}")(getattr(self, f"norm_{i}")(x))
            x = x + F.dropout(h, self.dropout_rate, training=not deterministic)
        return self.final_proj(self.final_norm(x))
