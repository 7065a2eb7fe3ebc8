"""Full-catalog cross-entropy: the plain head and the fused one.

Counterpart of ``replay_tpu/nn/loss/ce.py``: ``CE``, ``CEFused`` (kernels
K1–K3, :mod:`replay_tpu_torch.ops.fused_ce`), ``CEWeighted``, and the sampled
losses ``CESampled`` and ``CESampledWeighted``, which score each positive
against a pool of negatives (``[N]``, ``[B, N]`` or ``[B, L, N]``) instead of
the catalog. ``CEFusedTP`` comes with distributed training (``ROADMAP.md``
queue 1, 'Distributed training').
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .base import LossBase, broadcast_negatives, mask_negative_logits


class CE(LossBase):
    """Full-softmax cross-entropy over the whole item catalog."""

    def __call__(
        self,
        model_embeddings,
        feature_tensors,
        positive_labels,
        negative_labels,
        padding_mask,
        target_padding_mask,
    ) -> torch.Tensor:
        if positive_labels.shape[-1] != 1:
            msg = "Multi-positive labels are not supported by the CE loss"
            raise NotImplementedError(msg)
        logits = self.logits_callback(model_embeddings)  # [B, L, I]
        log_probs = torch.log_softmax(logits, dim=-1)
        labels = torch.clamp(positive_labels[..., 0].long(), 0, logits.shape[-1] - 1)
        nll = -torch.gather(log_probs, -1, labels[..., None])[..., 0]
        weights = self._label_weights(labels, nll.dtype)
        mask = target_padding_mask[..., 0].to(nll.dtype) * weights
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)

    def _label_weights(self, labels: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return torch.ones_like(labels, dtype=dtype)


class CEFused(CE):
    """CE on the fused log-sum-exp head (kernels K1–K3).

    The same loss as :class:`CE` up to f32 summation order, but the ``[B, L, I]``
    logits tensor never reaches device memory: K1 computes the catalog
    log-sum-exp tile by tile, K2 and K3 its gradients. Prefer it via
    ``Trainer(loss=CEFused())``.

    Contract: the loss rebuilds logits as ``hidden · get_item_weights()ᵀ``, so
    it matches :class:`CE` only for models whose ``get_logits`` is a bias-free
    tying head over that same table (SasRec). Such models declare
    ``logits_via_item_weights = True``; the trainer refuses to bind CEFused to a
    model without that declaration.

    :param tile: the JAX signature's rows per program; the kernels choose their
        own tiles and results never depend on it.
    :param item_tile: the JAX signature's catalog tile; likewise.
    """

    needs_item_embeddings = True
    requires_tying_head = True
    # the full [B, L, I] logits never exist on this path
    avoid_full_logits = True

    def __init__(self, tile: int = 256, item_tile: Optional[int] = None) -> None:
        super().__init__()
        self.tile = tile
        self.item_tile = item_tile
        self.item_embeddings_callback = None

    def _item_table(self) -> torch.Tensor:
        if self.item_embeddings_callback is None:
            msg = (
                f"{type(self).__name__} reconstructs logits from the raw item "
                "table, but no item_embeddings_callback is bound. Train through "
                "replay_tpu_torch.nn.Trainer, which binds the model's "
                "get_item_weights() automatically — a model that defines no "
                "get_item_weights cannot drive this loss at all — or, for "
                "direct use, set loss.item_embeddings_callback to a zero-arg "
                "callable returning the [num_items, embed] table."
            )
            raise AttributeError(msg)
        return self.item_embeddings_callback()

    def _check_dtypes(self, hidden: torch.Tensor, table: torch.Tensor) -> None:
        """Reject dtype mismatches the kernels would silently paper over.

        Sanctioned: identical dtypes, and the compute-dtype split where one side
        is float32 and the other a narrower float — the kernels accumulate in
        f32, exactly what ``get_logits``' type promotion does (bf16 hidden
        states against the f32 master table). Anything else (an integer or
        quantized table, two different narrow floats) is a bug at the call
        site, named here instead of surfacing as a wrong-loss training run.
        """
        h_dt, t_dt = hidden.dtype, table.dtype
        floats = h_dt.is_floating_point and t_dt.is_floating_point
        sanctioned = h_dt == t_dt or (floats and torch.float32 in (h_dt, t_dt))
        if not sanctioned:
            msg = (
                f"{type(self).__name__}: hidden states are {h_dt} but the item "
                f"table is {t_dt}. Only matching dtypes, or the sanctioned "
                "mixed-precision split — narrow-float compute (e.g. bfloat16 "
                "hidden states) against the float32 master/param table, "
                "accumulated in f32 inside the kernels — are supported; cast "
                "the model or the table explicitly."
            )
            raise ValueError(msg)

    def _lse(self, hidden2d: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        """``[N]`` catalog log-sum-exp on kernel K1 (K2 and K3 for its gradient)."""
        from replay_tpu_torch.ops.fused_ce import fused_lse

        return fused_lse(hidden2d, table, self.tile, self.item_tile)

    def __call__(
        self,
        model_embeddings,
        feature_tensors,
        positive_labels,
        negative_labels,
        padding_mask,
        target_padding_mask,
    ) -> torch.Tensor:
        if positive_labels.shape[-1] != 1:
            msg = "Multi-positive labels are not supported by the CE loss"
            raise NotImplementedError(msg)
        table = self._item_table()  # [I, E]
        self._check_dtypes(model_embeddings, table)
        num_items = table.shape[0]
        hidden = model_embeddings.reshape(-1, model_embeddings.shape[-1])
        labels = torch.clamp(positive_labels[..., 0].long(), 0, num_items - 1)
        lse = self._lse(hidden, table).reshape(labels.shape)
        # the labels' rows of the (tied) table: autograd adds this gather's
        # gradient to K3's dW and to the input embedding's
        label_logit = torch.sum(
            model_embeddings.to(torch.float32) * F.embedding(labels, table).to(torch.float32),
            dim=-1,
        )
        nll = lse - label_logit
        weights = self._label_weights(labels, nll.dtype)
        mask = target_padding_mask[..., 0].to(nll.dtype) * weights
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


class _PerItemWeights:
    """A ``[num_items]`` weight vector, kept on each device it is read on
    (copied there at the first call, so a CUDA graph of a later step reads
    the device copy and makes no host copy)."""

    def __init__(self, weight) -> None:
        if isinstance(weight, torch.Tensor):
            weight = weight.detach().cpu()
        else:
            weight = torch.as_tensor(np.asarray(weight))
        self.weight = weight
        self._by_device: Dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        if device not in self._by_device:
            self._by_device[device] = self.weight.to(device)
        return self._by_device[device]


class CEWeighted(CE):
    """CE with per-class weights (reference: torch CrossEntropyLoss(weight=...))."""

    def __init__(self, weight) -> None:
        super().__init__()
        self._weights = _PerItemWeights(weight)
        self.weight = self._weights.weight

    def _label_weights(self, labels: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return self._weights.on(labels.device)[labels].to(dtype)


class CESampled(LossBase):
    """Softmax CE between each positive and K sampled negatives.

    Supports multi-positive labels and all three negative shapes; negatives equal to
    ``negative_labels_ignore_index`` are excluded from the softmax.
    """

    def __init__(self, negative_labels_ignore_index: int = -100) -> None:
        super().__init__()
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
        negatives = broadcast_negatives(negative_labels, batch, length)  # [B, L, N]
        # the ignored ids replaced before the broadcast: the same values, and
        # a broadcast view, whose pool a model may score once (TwoTower)
        ignored = negative_labels == self.negative_labels_ignore_index
        safe_neg = broadcast_negatives(torch.where(ignored, 0, negative_labels), batch, length)
        negative_logits = self.logits_callback(model_embeddings, safe_neg)  # [B, L, N]
        negative_logits = mask_negative_logits(negative_logits, negatives, self.negative_labels_ignore_index)
        positive_logits = self.logits_callback(model_embeddings, positive_labels)  # [B, L, P]

        # per-positive softmax over [positive, negatives]
        neg_lse = torch.logsumexp(negative_logits, dim=-1, keepdim=True)  # [B, L, 1]
        denom = torch.logaddexp(positive_logits, neg_lse)  # [B, L, P]
        nll = denom - positive_logits
        weights = self._label_weights(positive_labels, nll.dtype)
        mask = target_padding_mask.to(nll.dtype) * weights
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)

    def _label_weights(self, labels: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return torch.ones_like(labels, dtype=dtype)


class CESampledWeighted(CESampled):
    """CESampled with per-item weights applied to the positive terms."""

    def __init__(self, weight, negative_labels_ignore_index: int = -100) -> None:
        super().__init__(negative_labels_ignore_index)
        self._weights = _PerItemWeights(weight)
        self.weight = self._weights.weight

    def _label_weights(self, labels: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        weight = self._weights.on(labels.device)
        return weight[torch.clamp(labels.long(), 0, weight.shape[0] - 1)].to(dtype)
