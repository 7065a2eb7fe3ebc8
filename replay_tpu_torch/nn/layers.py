"""flax's ``Dense``, ``LayerNorm`` and ``Embed`` with a compute dtype.

The JAX modules compute in a ``dtype`` (bf16 on the precision ladder's bf16
rung) while their parameters stay f32. Each layer here casts explicitly, as
its flax counterpart does, so that the port rounds where the reference rounds
(``torch.autocast`` would not: it runs ``layer_norm`` in f32 and returns f32):

* ``Dense``: input, weight and bias cast to ``dtype``; the result is ``dtype``.
* ``LayerNorm``: statistics and the affine map in f32 whatever the input, the
  result cast to ``dtype``; epsilon is flax's 1e-6, not torch's 1e-5.
* ``Embed``: the table cast to ``dtype`` before the gather, so its gradient
  is accumulated in ``dtype`` too, as flax's. On the card, a table whose rows
  take at least ``DETERMINISTIC_LOOKUPS_PER_ROW`` lookups on average (a list
  feature's small vocabulary, TiSasRec's interval table) gets its gradient
  from :func:`table_gradient`, summed in a fixed order: torch's CUDA
  embedding backward does not repeat bit for bit there (``chip_smoke.py``'s
  family phase reads both), and a step must (a captured chunk is held to its
  eager steps bitwise).

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


# lookups a row, on average, from which a table's gradient is summed in a
# fixed order on the card (table_gradient) rather than by torch's kernel
DETERMINISTIC_LOOKUPS_PER_ROW = 64


def table_gradient(ids: torch.Tensor, grad: torch.Tensor, rows: int) -> torch.Tensor:
    """The gradient of a ``[rows, D]`` table looked up at ``ids``: each row's
    lookups' gradients summed in f32 in a fixed order (the lookups sorted by
    row, stably; each row's run summed one after another by
    ``segment_reduce``), cast to ``grad``'s dtype. No host sync, so a CUDA
    graph captures it."""
    flat = ids.reshape(-1).long()
    values = grad.reshape(flat.numel(), -1).float()
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(rows, dtype=torch.long, device=flat.device).scatter_add_(0, flat, torch.ones_like(flat))
    return torch.segment_reduce(values[order], "sum", lengths=counts, axis=0, unsafe=True).to(grad.dtype)


def _repeatable_gradient(ids: torch.Tensor, table: torch.Tensor) -> bool:
    """Whether this lookup takes :func:`table_gradient`: on the card, a table
    that needs a gradient, its rows looked up ``DETERMINISTIC_LOOKUPS_PER_ROW``
    times or more on average (shapes only: a captured graph decides alike)."""
    return (
        ids.is_cuda and table.requires_grad and torch.is_grad_enabled()
        and ids.numel() >= DETERMINISTIC_LOOKUPS_PER_ROW * table.shape[0]
    )


class _RepeatableEmbedding(torch.autograd.Function):
    """``F.embedding`` with :func:`table_gradient` as the table's gradient."""

    @staticmethod
    def forward(ctx, ids, table):
        ctx.save_for_backward(ids)
        ctx.rows = table.shape[0]
        return F.embedding(ids, table)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        return None, table_gradient(ids, grad, ctx.rows)


class Embed(nn.Embedding):
    """``nn.Embedding`` whose table is cast to ``dtype`` before the gather."""

    def __init__(self, num_embeddings: int, embedding_dim: int, dtype: torch.dtype = torch.float32) -> None:
        super().__init__(num_embeddings, embedding_dim)
        self.dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        table = self.weight.to(self.dtype)
        if _repeatable_gradient(ids, table):
            return _RepeatableEmbedding.apply(ids, table)
        return F.embedding(ids, table)
