"""Scoring heads.

Counterpart of ``replay_tpu/nn/head.py::EmbeddingTyingHead``: dot-product scoring
between hidden states and item embeddings with three shape dispatches,
[B, *, E] x [I, E], [B, E] x [B, I, E] and [B, *, E] x [B, *, E]. Operands of
two float types are promoted first, as ``jnp.einsum`` promotes them: bf16
hidden states against the f32 item table give f32 scores.
"""

from __future__ import annotations

import torch


class EmbeddingTyingHead:
    """Score hidden states against item embeddings by dot product."""

    def __call__(self, hidden: torch.Tensor, item_embeddings: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(hidden.dtype, item_embeddings.dtype)
        hidden, item_embeddings = hidden.to(dtype), item_embeddings.to(dtype)
        if item_embeddings.dim() == 2:
            # [B, *, E] x [I, E] -> [B, *, I] — full-catalog scoring
            return torch.einsum("...e,ie->...i", hidden, item_embeddings)
        if hidden.dim() == 2 and item_embeddings.dim() == 3:
            # [B, E] x [B, I, E] -> [B, I] — per-query candidate scoring
            return torch.einsum("be,bie->bi", hidden, item_embeddings)
        if hidden.dim() == item_embeddings.dim():
            # [B, *, E] x [B, *, E] -> [B, *] — paired scoring
            return torch.sum(hidden * item_embeddings, dim=-1)
        msg = f"Unsupported head shapes: {tuple(hidden.shape)} x {tuple(item_embeddings.shape)}"
        raise ValueError(msg)
