"""Loss-function protocol and shared sampled-logit plumbing.

Counterpart of ``replay_tpu/nn/loss/base.py``. Every loss is a callable with the
signature ``loss(model_embeddings, feature_tensors, positive_labels,
negative_labels, padding_mask, target_padding_mask)`` and a ``logits_callback``
that the trainer binds to the model's ``get_logits``. Losses keep static shapes
and weight per-position terms by the mask instead of gathering the valid
positions, as the JAX losses do.

Shapes:
  model_embeddings     [B, L, E]
  positive_labels      [B, L, P]      (P = 1 unless multi-positive)
  negative_labels      [N] | [B, N] | [B, L, N]
  padding_mask         [B, L]   bool
  target_padding_mask  [B, L, P] bool
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

LogitsCallback = Callable[..., torch.Tensor]


class LossBase:
    """Shared logits-callback handling."""

    def __init__(self) -> None:
        self._logits_callback: Optional[LogitsCallback] = None

    @property
    def logits_callback(self) -> LogitsCallback:
        if self._logits_callback is None:
            msg = "The callback for getting logits is not defined"
            raise AttributeError(msg)
        return self._logits_callback

    @logits_callback.setter
    def logits_callback(self, func: Optional[LogitsCallback]) -> None:
        self._logits_callback = func

    def __call__(
        self,
        model_embeddings,
        feature_tensors,
        positive_labels,
        negative_labels,
        padding_mask,
        target_padding_mask,
    ) -> torch.Tensor:
        raise NotImplementedError


def broadcast_negatives(negative_labels: torch.Tensor, batch: int, length: int) -> torch.Tensor:
    """Normalize negative label shapes to [B, L, N]."""
    if negative_labels.dim() == 1:
        return negative_labels[None, None, :].expand(batch, length, negative_labels.shape[0])
    if negative_labels.dim() == 2:
        return negative_labels[:, None, :].expand(batch, length, negative_labels.shape[1])
    if negative_labels.dim() == 3:
        return negative_labels
    msg = f"Unsupported negative_labels rank: {negative_labels.dim()}"
    raise ValueError(msg)


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``values`` over the True entries of ``mask`` (0 if empty)."""
    mask = mask.to(values.dtype)
    total = torch.sum(values * mask)
    count = torch.sum(mask)
    return total / torch.clamp(count, min=1.0)


def mask_negative_logits(
    negative_logits: torch.Tensor,
    negative_labels: torch.Tensor,
    ignore_index: int,
) -> torch.Tensor:
    """Push padded negatives to the dtype's minimum so they vanish from the softmax."""
    neg_inf = torch.finfo(negative_logits.dtype).min
    return torch.where(negative_labels == ignore_index, neg_inf, negative_logits)
