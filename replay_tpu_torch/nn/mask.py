"""Attention-mask construction.

Counterpart of ``replay_tpu/nn/mask.py``: merge a causal (lower-triangular)
constraint with the key-padding mask and a diagonal rescue (a fully-masked row
attends to itself instead of producing NaNs). The additive mask uses ``-inf``
during training and ``finfo(dtype).min`` at evaluation, so fully-masked softmax
rows stay finite in eval.

Masks are additive float tensors of shape [B, 1, L, L], broadcast over heads;
the long-sequence route (``use_flash="tiled"``) builds none. Packed rows
(``segment_ids``, :class:`~replay_tpu_torch.data.nn.PackedSequenceBatcher`)
add a same-segment constraint, on the unfused route only.
"""

from __future__ import annotations

from typing import Optional

import torch


def padding_mask_from_ids(ids: torch.Tensor, padding_value: int = 0) -> torch.Tensor:
    """Boolean [B, L] mask, True where the position holds a real token."""
    return ids != padding_value


def _additive(allowed: torch.Tensor, deterministic: bool, dtype: torch.dtype) -> torch.Tensor:
    """[B, L, L] bool → additive [B, 1, L, L] with the diagonal rescue applied."""
    eye = torch.eye(allowed.shape[-1], dtype=torch.bool, device=allowed.device)
    neg = torch.finfo(dtype).min if deterministic else float("-inf")
    mask = torch.zeros(allowed.shape, dtype=dtype, device=allowed.device)
    return mask.masked_fill_(~(allowed | eye), neg)[:, None, :, :]


def causal_attention_mask(
    padding_mask: torch.Tensor,
    deterministic: bool = False,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Additive causal+padding mask [B, 1, L, L].

    :param padding_mask: boolean [B, L], True at real tokens.
    :param deterministic: eval mode — use ``finfo.min`` instead of ``-inf`` so rows
        that are fully masked (cold queries) don't produce NaN softmax outputs.
    """
    length = padding_mask.shape[1]
    causal = torch.ones((length, length), dtype=torch.bool, device=padding_mask.device).tril()
    return _additive(causal[None] & padding_mask[:, None, :], deterministic, dtype)


def bidirectional_attention_mask(
    padding_mask: torch.Tensor,
    deterministic: bool = False,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Additive padding-only mask [B, 1, L, L] (BERT4Rec-style full attention)."""
    batch, length = padding_mask.shape
    return _additive(padding_mask[:, None, :].expand(batch, length, length), deterministic, dtype)


class DefaultAttentionMask:
    """Build the causal mask from a reference feature's padding (config-friendly shim)."""

    def __init__(self, reference_feature: str, padding_value: int = 0) -> None:
        self.reference_feature = reference_feature
        self.padding_value = padding_value

    def __call__(self, feature_tensors, deterministic: bool = False, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        ids = feature_tensors[self.reference_feature]
        return causal_attention_mask(
            padding_mask_from_ids(ids, self.padding_value), deterministic=deterministic, dtype=dtype
        )


def segment_attention_mask(
    padding_mask: torch.Tensor,
    segment_ids: torch.Tensor,
    causal: bool = True,
    deterministic: bool = False,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Additive mask [B, 1, L, L] for packed rows: (causal and) key padding and
    same segment.

    ``segment_ids`` is 0 on padding and 1..k per packed sequence. Attention
    keeps to keys of the same segment, so co-packed sequences cannot see one
    another: block-diagonal within the causal triangle. Padded positions
    carry segment 0 and attend only to themselves (the diagonal rescue).
    """
    length = padding_mask.shape[1]
    same = segment_ids[:, :, None] == segment_ids[:, None, :]  # [B, Lq, Lk]
    allowed = same & padding_mask[:, None, :] & (segment_ids != 0)[:, :, None]
    if causal:
        allowed = allowed & torch.ones((length, length), dtype=torch.bool, device=padding_mask.device).tril()[None]
    return _additive(allowed, deterministic, dtype)


def require_ported_route(use_flash) -> None:
    """Raise for the attention route the port does not have yet."""
    if use_flash == "ring":
        msg = "use_flash='ring' is not ported yet: ROADMAP.md queue 1, distributed training"
        raise NotImplementedError(msg)


def attention_mask_for_route(
    use_flash,
    padding_mask: torch.Tensor,
    causal: bool = True,
    deterministic: bool = False,
    dtype: torch.dtype = torch.float32,
    segment_ids: Optional[torch.Tensor] = None,
) -> Optional[torch.Tensor]:
    """The additive mask a model body hands its encoder, route-aware.

    The unfused route (``use_flash=False``) and the single-block kernel route
    (``use_flash=True``) take the [B, 1, L, L] mask. On the ``"tiled"`` route
    kernel K5 rebuilds causal and key-padding structure from indices and the
    [B, L] padding mask, so the [B, 1, L, L] tensor is not built: None. The
    ``"ring"`` route is a later slice of the port and raises here.

    ``segment_ids`` (packed batches) adds the same-segment constraint through
    :func:`segment_attention_mask`. The kernels K4 and K5 (and the ring route)
    rebuild their masks from causality and padding alone and would attend
    across packed segments, so every route but the unfused one refuses them.
    """
    if segment_ids is not None:
        if use_flash:
            route = "the ring SP route" if use_flash == "ring" else "the flash kernels"
            msg = (
                "packed batches (segment_ids) need the additive segment mask, "
                f"which {route} cannot honor — run packing with "
                "use_flash=False, or drop the packing for the "
                f"use_flash={use_flash!r} route"
            )
            raise ValueError(msg)
        return segment_attention_mask(padding_mask, segment_ids, causal=causal, deterministic=deterministic, dtype=dtype)
    require_ported_route(use_flash)
    if use_flash == "tiled":
        return None
    make_mask = causal_attention_mask if causal else bidirectional_attention_mask
    return make_mask(padding_mask, deterministic=deterministic, dtype=dtype)
