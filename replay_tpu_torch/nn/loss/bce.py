"""Binary cross-entropy losses.

Counterpart of ``replay_tpu/nn/loss/bce.py``: ``BCE`` over the whole catalog
with multi-hot positive targets, ``BCESampled`` over the positive and the
sampled negative logits (log-epsilon and clamping), and ``GBCE``, the
calibrated sampled BCE of gSASRec. The multi-hot targets are a
``scatter_reduce(..., "amax")`` on the catalog axis, the JAX loss's vmapped
``.at[label].max(valid)``: a label repeated at one position counts once, and
an invalid positive adds nothing.
"""

from __future__ import annotations

import torch

from .base import LossBase, broadcast_negatives


class BCE(LossBase):
    """Pointwise BCE-with-logits over the whole catalog (positives are multi-hot)."""

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
        valid = target_padding_mask.to(logits.dtype)
        targets = torch.zeros_like(logits).scatter_reduce(-1, labels, valid, "amax", include_self=True)
        per_elem = torch.clamp(logits, min=0) - logits * targets + torch.log1p(torch.exp(-torch.abs(logits)))
        position_valid = target_padding_mask.any(dim=-1)  # [B, L]
        per_position = per_elem.sum(dim=-1)
        return torch.sum(per_position * position_valid) / torch.clamp(torch.sum(position_valid), min=1.0)


class BCESampled(LossBase):
    """BCE over positive (label 1) and sampled negative (label 0) logits."""

    def __init__(
        self,
        log_epsilon: float = 1e-6,
        clamp_border: float = 100.0,
        negative_labels_ignore_index: int = -100,
    ) -> None:
        super().__init__()
        self.log_epsilon = log_epsilon
        self.clamp_border = clamp_border
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

        positive_logits = self.logits_callback(model_embeddings, positive_labels)
        negative_logits = self.logits_callback(model_embeddings, safe_neg)

        # gBCE seam: the positive term scales by beta BEFORE the clamp; plain
        # BCE keeps beta = 1, the IEEE identity (bitwise-unchanged values)
        beta = self._positive_scale(negatives.shape[-1])
        pos_loss = self._clamp(beta * -torch.log(torch.sigmoid(positive_logits) + self.log_epsilon))  # [B, L, P]
        neg_loss = self._clamp(-torch.log1p(-torch.sigmoid(negative_logits) + self.log_epsilon))  # [B, L, N]
        neg_valid = (negatives != self.negative_labels_ignore_index) & padding_mask[..., None]

        total = torch.sum(pos_loss * target_padding_mask) + torch.sum(neg_loss * neg_valid)
        count = torch.sum(target_padding_mask) + torch.sum(neg_valid)
        return total / torch.clamp(count, min=1.0)

    def _clamp(self, value: torch.Tensor) -> torch.Tensor:
        return torch.clamp(value, -self.clamp_border, self.clamp_border)

    def _positive_scale(self, num_negatives: int) -> float:
        return 1.0


class GBCE(BCESampled):
    """gBCE: generalized BCE with a calibrated positive-term power beta.

    Training on K sampled negatives out of ``catalog_size`` items
    overestimates positive probabilities; raising the positive probability to
    the power ``beta = alpha * (t * (1 - 1/alpha) + 1/alpha)`` with
    ``alpha = K / (catalog_size - 1)`` calibrates them back. ``t=0`` gives
    beta = 1, exactly :class:`BCESampled`; ``t=1`` gives beta = alpha. The
    positive term is ``-beta * log sigmoid(s+)``, the negatives' plain
    ``-log(1 - sigmoid(s-))``: no item-table sweep and no ``[B, L, I]``
    logits. Pass ``catalog_size`` (beta resolved from the negative count) or
    a literal ``beta``; exactly one of the two.
    """

    # no [B, L, I] logits exist on this path: health's logits stats stream
    # over the item table or record themselves skipped (obs/health.py)
    avoid_full_logits = True

    def __init__(
        self,
        catalog_size: int = None,
        t: float = 0.75,
        beta: float = None,
        log_epsilon: float = 1e-6,
        clamp_border: float = 100.0,
        negative_labels_ignore_index: int = -100,
    ) -> None:
        super().__init__(log_epsilon, clamp_border, negative_labels_ignore_index)
        if (catalog_size is None) == (beta is None):
            msg = "GBCE takes exactly one of catalog_size= (β from t) or beta="
            raise ValueError(msg)
        if not 0.0 <= t <= 1.0:
            msg = f"t must be in [0, 1], got {t}"
            raise ValueError(msg)
        if catalog_size is not None and catalog_size < 2:
            msg = f"catalog_size must be >= 2, got {catalog_size}"
            raise ValueError(msg)
        self.catalog_size = catalog_size
        self.t = t
        self.beta = beta

    def resolved_beta(self, num_negatives: int) -> float:
        """beta for ``num_negatives`` sampled negatives: a Python float (the
        negative count is a static shape), so a captured step holds it as a
        constant."""
        if self.beta is not None:
            return float(self.beta)
        alpha = num_negatives / (self.catalog_size - 1)
        return alpha * (self.t * (1.0 - 1.0 / alpha) + 1.0 / alpha)

    def _positive_scale(self, num_negatives: int) -> float:
        return self.resolved_beta(num_negatives)
