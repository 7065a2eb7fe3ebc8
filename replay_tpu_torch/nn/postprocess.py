"""Logit postprocessors applied between model scoring and top-k selection.

Counterpart of ``replay_tpu/nn/postprocess.py``: a postprocessor is a callable
``(logits, batch) -> logits`` run before top-k in validation and prediction.
``SeenItemsFilter`` pushes the logits of items the query has already
interacted with to the dtype minimum so they cannot be recommended again.
"""

from __future__ import annotations

from typing import Optional

import torch

from replay_tpu_torch.device import to_device


class SeenItemsFilter:
    """Mask logits of already-seen items.

    Seen ids are taken from ``batch[seen_field]`` — by default the input item-id
    sequence itself (shape [B, L]); out-of-range ids (e.g. the padding id
    ``cardinality``) are redirected to a scratch column appended to the logits and
    dropped afterwards, so padding never masks a real item.

    :param seen_field: batch key holding the seen item ids per query.
    :param candidates_field: batch key with candidate ids [K] or [B, K]; when the
        key is present in the batch, logits are treated as candidate-indexed and
        seen ids are matched against the candidates instead of used as direct
        columns. The Trainer puts ``candidates_to_score`` into every batch it
        scores with candidates, so the default composes with
        ``predict_top_k(..., candidates=...)``.
    """

    def __init__(
        self, seen_field: str = "item_id", candidates_field: Optional[str] = "candidates_to_score"
    ) -> None:
        self.seen_field = seen_field
        self.candidates_field = candidates_field

    def __call__(self, logits: torch.Tensor, batch: dict) -> torch.Tensor:
        if self.seen_field in batch:
            seen = batch[self.seen_field]
        elif self.seen_field in batch.get("feature_tensors", {}):
            # grouped batches keep the model inputs under feature_tensors
            seen = batch["feature_tensors"][self.seen_field]
        else:
            msg = f"Seen-items field '{self.seen_field}' not found in the batch."
            raise KeyError(msg)
        seen = to_device(seen, logits.device)
        if seen.dim() == 1:
            seen = seen[:, None]
        neg_inf = torch.finfo(logits.dtype).min
        if self.candidates_field is not None and self.candidates_field in batch:
            candidates = to_device(batch[self.candidates_field], logits.device)
            if candidates.dim() == 1:
                candidates = candidates[None, :]
            # mask candidate k where candidates[b, k] appears in seen[b, :]
            is_seen = (candidates[:, :, None] == seen[:, None, :]).any(dim=2)
            return torch.where(is_seen, neg_inf, logits)
        num_items = logits.shape[-1]
        # scratch column absorbs padding / out-of-range ids
        padded = torch.cat([logits, logits.new_zeros((*logits.shape[:-1], 1))], dim=-1)
        safe = torch.where((seen >= 0) & (seen < num_items), seen, num_items).long()
        rows = torch.arange(logits.shape[0], device=logits.device)[:, None]
        padded[rows, safe] = neg_inf
        return padded[..., :num_items]
