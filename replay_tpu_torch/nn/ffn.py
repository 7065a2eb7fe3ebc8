"""Feed-forward block.

Counterpart of ``replay_tpu/nn/ffn.py::PointWiseFeedForward``, the SASRec
position-wise block: dense → activation → dropout → dense → dropout → residual.
The order is part of the parity contract: relu commutes with dropout's scaling,
gelu does not. Both dense layers compute in ``dtype`` (flax's compute dtype;
parameters stay f32). ``SwiGLU`` comes with the encoders that use it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from replay_tpu_torch.nn.layers import Dense
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
