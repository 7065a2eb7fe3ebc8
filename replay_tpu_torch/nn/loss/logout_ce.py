"""Cross-entropy with the other positives excluded from the denominator ("log-out" family).

Counterpart of ``replay_tpu/nn/loss/logout_ce.py``: for each positive p,
``-log( exp(pos_p) / (exp(pos_p) + sum over the catalog excluding ALL positives) )``,
so that positives of one position do not compete with each other.
``LogOutCEWeighted`` scales each positive's term by a per-item weight, a
tensor kept on the device the loss runs on.
"""

from __future__ import annotations

import torch

from .base import LossBase
from .ce import _PerItemWeights


class LogOutCE(LossBase):
    """Full-catalog CE that masks the OTHER positives out of each positive's softmax."""

    def __init__(self, cardinality: int) -> None:
        super().__init__()
        self.cardinality = cardinality

    def __call__(
        self,
        model_embeddings,
        feature_tensors,
        positive_labels,
        negative_labels,
        padding_mask,
        target_padding_mask,
    ) -> torch.Tensor:
        logits = self.logits_callback(model_embeddings)  # [B, L, I]
        num_items = logits.shape[-1]
        labels = torch.clamp(positive_labels.long(), 0, num_items - 1)
        valid = target_padding_mask

        # positives-as-negatives mask: True at any valid positive of the position
        hits = torch.zeros_like(logits).scatter_reduce(-1, labels, valid.to(logits.dtype), "amax", include_self=True)
        negatives_only = torch.where(hits > 0, torch.finfo(logits.dtype).min, logits)
        neg_lse = torch.logsumexp(negatives_only, dim=-1, keepdim=True)  # [B, L, 1]

        pos_logits = torch.gather(logits, -1, labels)  # [B, L, P]
        denom = torch.logaddexp(pos_logits, neg_lse)
        nll = denom - pos_logits
        weights = self._label_weights(labels, nll.dtype) * valid.to(nll.dtype)
        return torch.sum(nll * weights) / torch.clamp(torch.sum(weights), min=1.0)

    def _label_weights(self, labels: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return torch.ones_like(labels, dtype=dtype)


class LogOutCEWeighted(LogOutCE):
    """LogOutCE with per-item weights on the positive terms."""

    def __init__(self, cardinality: int, weight) -> None:
        super().__init__(cardinality)
        self._weights = _PerItemWeights(weight)
        self.weight = self._weights.weight

    def _label_weights(self, labels: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        weight = self._weights.on(labels.device)
        return weight[torch.clamp(labels, 0, weight.shape[0] - 1)].to(dtype)
