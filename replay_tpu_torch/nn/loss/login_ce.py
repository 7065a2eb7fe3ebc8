"""InfoNCE-style losses with the log outside the positive sum ("log-in" family).

Counterpart of ``replay_tpu/nn/loss/login_ce.py``:
``L = -log( sum_p exp(pos) / (sum_p exp(pos) + sum_n exp(neg)) )`` per
position. ``LogInCE`` uses the full catalog as negatives, ``LogInCESampled``
the sampled ones.
"""

from __future__ import annotations

import torch

from .base import LossBase, broadcast_negatives, mask_negative_logits


class LogInCE(LossBase):
    """InfoNCE with the whole catalog as the negative pool."""

    def __init__(self, cardinality: int, log_epsilon: float = 1e-6) -> None:
        super().__init__()
        self.cardinality = cardinality
        self.log_epsilon = log_epsilon

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
        labels = torch.clamp(positive_labels.long(), 0, logits.shape[-1] - 1)
        pos_logits = torch.gather(logits, -1, labels)  # [B, L, P]
        pos_logits = torch.where(target_padding_mask, pos_logits, torch.finfo(logits.dtype).min)

        pos_lse = torch.logsumexp(pos_logits, dim=-1)  # [B, L]
        all_lse = torch.logsumexp(logits, dim=-1)  # [B, L] (includes positives)
        nll = all_lse - pos_lse
        position_valid = target_padding_mask.any(dim=-1)
        return torch.sum(nll * position_valid) / torch.clamp(torch.sum(position_valid), min=1.0)


class LogInCESampled(LossBase):
    """InfoNCE over positive logits vs sampled negative logits."""

    def __init__(self, log_epsilon: float = 1e-6, negative_labels_ignore_index: int = -100) -> None:
        super().__init__()
        self.log_epsilon = log_epsilon
        self.negative_labels_ignore_index = negative_labels_ignore_index

    def __call__(
        self,
        model_embeddings,
        feature_tensors,
        positive_labels,
        negative_labels,
        padding_mask,
        target_padding_mask,
    ) -> torch.Tensor:
        batch, length, _ = positive_labels.shape
        negatives = broadcast_negatives(negative_labels, batch, length)
        safe_neg = torch.where(negatives == self.negative_labels_ignore_index, 0, negatives)

        pos_logits = self.logits_callback(model_embeddings, positive_labels)  # [B, L, P]
        neg_logits = self.logits_callback(model_embeddings, safe_neg)  # [B, L, N]
        neg_logits = mask_negative_logits(neg_logits, negatives, self.negative_labels_ignore_index)

        pos_logits = torch.where(target_padding_mask, pos_logits, torch.finfo(pos_logits.dtype).min)
        pos_lse = torch.logsumexp(pos_logits, dim=-1)
        total_lse = torch.logaddexp(pos_lse, torch.logsumexp(neg_logits, dim=-1))
        nll = total_lse - pos_lse
        position_valid = target_padding_mask.any(dim=-1)
        return torch.sum(nll * position_valid) / torch.clamp(torch.sum(position_valid), min=1.0)
