"""flax's ``Dense``, ``LayerNorm`` and ``Embed`` with a compute dtype.

The JAX modules compute in a ``dtype`` (bf16 on the precision ladder's bf16
rung) while their parameters stay f32. Each layer here casts explicitly, as
its flax counterpart does, so that the port rounds where the reference rounds
(``torch.autocast`` would not: it runs ``layer_norm`` in f32 and returns f32):

* ``Dense``: input, weight and bias cast to ``dtype``; the result is ``dtype``.
* ``LayerNorm``: statistics and the affine map in f32 whatever the input, the
  result cast to ``dtype``; epsilon is flax's 1e-6, not torch's 1e-5.
* ``Embed``: the table cast to ``dtype`` before the gather, so its gradient
  is accumulated in ``dtype`` too, as flax's.

Parameter names stay torch's (``weight``, ``bias``), so ``state_dict`` keys
are the same at every dtype and :mod:`replay_tpu_torch.convert` maps them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

LAYER_NORM_EPS = 1e-6  # flax nn.LayerNorm's default


class Dense(nn.Linear):
    """``nn.Linear`` computing in ``dtype`` (f32 parameters); ``bias=False`` is
    flax's ``use_bias=False``."""

    def __init__(
        self, in_features: int, out_features: int, dtype: torch.dtype = torch.float32, bias: bool = True
    ) -> None:
        super().__init__(in_features, out_features, bias=bias)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.bias.to(self.dtype) if self.bias is not None else None
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with flax's epsilon, computed in f32 and returned in ``dtype``."""

    def __init__(self, normalized_shape: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__(normalized_shape, eps=LAYER_NORM_EPS)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.to(torch.float32), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.dtype)


class Embed(nn.Embedding):
    """``nn.Embedding`` whose table is cast to ``dtype`` before the gather."""

    def __init__(self, num_embeddings: int, embedding_dim: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__(num_embeddings, embedding_dim)
        self.dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight.to(self.dtype))
