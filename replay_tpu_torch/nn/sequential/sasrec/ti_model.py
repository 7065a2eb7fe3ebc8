"""TiSASRec: time-interval-aware SASRec.

Counterpart of ``replay_tpu/nn/sequential/sasrec/ti_model.py``. Pairwise time
intervals index a learned ``[time_span + 1, H]`` relative-attention-bias table
(``interval_bias``) added to the attention logits, the T5-style form of the
reference's per-pair interval embeddings: the ``[B, 1, L, L]`` causal mask
plus the bias, transposed to ``[B, H, L, L]``, is the additive mask of every
block's unfused ``MultiHeadAttention`` (the JAX model has no kernel route, so
neither has this one).

The intervals follow the JAX code, step for step:

* the timestamps are cast as ``jnp.asarray`` casts them with 64-bit types off
  (float64 → float32, int64 → int32) *before* the differences are taken, so
  the ids at the clip boundary are the JAX ones;
* each row's scale is the smallest positive gap over all of the row's valid
  pairs (not each query's), 1 where there is none;
* the scaled gaps are clipped to ``[0, time_span]`` and truncated to int32.

The timestamp feature (``timestamps_name``) is excluded from the embedder and
read from ``feature_tensors``. Module names are the flax ones
(``embedder``, ``aggregator``, ``interval_bias``, ``attention_<i>``,
``attn_norm_<i>``, ``ffn_norm_<i>``, ``ffn_<i>``, ``final_norm``), so
:mod:`replay_tpu_torch.convert` carries the weights across.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from replay_tpu_torch.data.nn.schema import TensorMap, TensorSchema
from replay_tpu_torch.device import DeviceLike, resolve_device
from replay_tpu_torch.nn.agg import PositionAwareAggregator
from replay_tpu_torch.nn.attention import MultiHeadAttention
from replay_tpu_torch.nn.embedding import SequenceEmbedding
from replay_tpu_torch.nn.ffn import PointWiseFeedForward
from replay_tpu_torch.nn.head import EmbeddingTyingHead
from replay_tpu_torch.nn.layers import Embed, LayerNorm
from replay_tpu_torch.nn.mask import causal_attention_mask

# the dtypes jnp.asarray gives 64-bit inputs while 64-bit types are off
_NARROWED = {torch.float64: torch.float32, torch.int64: torch.int32}


class TiSasRec(nn.Module):
    """SASRec whose attention sees clipped pairwise time intervals.

    The forward reads a ``timestamps_name`` tensor [B, L] (seconds or any
    monotone unit) from ``feature_tensors``; pairwise intervals are scaled by
    the row's minimum non-zero gap and clipped to ``time_span``.
    """

    # bias-free head contract: get_logits(h) == h . get_item_weights()^T
    logits_via_item_weights = True

    def __init__(
        self,
        schema: TensorSchema,
        embedding_dim: int = 64,
        num_blocks: int = 2,
        num_heads: int = 1,
        max_sequence_length: int = 50,
        time_span: int = 256,
        hidden_dim: Optional[int] = None,
        dropout_rate: float = 0.0,
        activation: str = "relu",
        excluded_features: tuple = (),
        timestamps_name: str = "timestamp",
        dtype: torch.dtype = torch.float32,  # compute dtype; parameters stay f32
        device: DeviceLike = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.embedding_dim = embedding_dim
        self.num_blocks = num_blocks
        self.max_sequence_length = max_sequence_length
        self.time_span = time_span
        self.timestamps_name = timestamps_name
        self.dtype = dtype
        # what clone() rebuilds the model from
        self._config = dict(
            schema=schema, embedding_dim=embedding_dim, num_blocks=num_blocks, num_heads=num_heads,
            max_sequence_length=max_sequence_length, time_span=time_span, hidden_dim=hidden_dim,
            dropout_rate=dropout_rate, activation=activation, excluded_features=excluded_features,
            timestamps_name=timestamps_name, dtype=dtype, device=device,
        )
        self.embedder = SequenceEmbedding(
            schema, excluded_features=tuple(excluded_features) + (timestamps_name,), dtype=dtype
        )
        self.aggregator = PositionAwareAggregator(embedding_dim, max_sequence_length, dropout_rate)
        self.interval_bias = Embed(time_span + 1, num_heads, dtype)
        for i in range(num_blocks):
            self.add_module(
                f"attention_{i}", MultiHeadAttention(embedding_dim, num_heads, dropout_rate=dropout_rate, dtype=dtype)
            )
            self.add_module(f"attn_norm_{i}", LayerNorm(embedding_dim, dtype))
            self.add_module(f"ffn_norm_{i}", LayerNorm(embedding_dim, dtype))
            self.add_module(
                f"ffn_{i}",
                PointWiseFeedForward(
                    embedding_dim, hidden_dim or embedding_dim * 4, dropout_rate=dropout_rate,
                    activation=activation, dtype=dtype,
                ),
            )
        self.final_norm = LayerNorm(embedding_dim, dtype)
        self.head = EmbeddingTyingHead()
        self.reset_parameters(generator if generator is not None else torch.Generator().manual_seed(0))
        self.to(device)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embedder.reset_parameters(generator)
        self.aggregator.reset_parameters(generator)
        # flax Embed's default: variance scaling over fan-in, std = 1/sqrt(H)
        nn.init.normal_(self.interval_bias.weight, std=1.0 / math.sqrt(self.interval_bias.embedding_dim),
                        generator=generator)
        for i in range(self.num_blocks):
            getattr(self, f"attention_{i}").reset_parameters(generator)
            getattr(self, f"attn_norm_{i}").reset_parameters()
            getattr(self, f"ffn_norm_{i}").reset_parameters()
            getattr(self, f"ffn_{i}").reset_parameters(generator)
        self.final_norm.reset_parameters()

    @property
    def schema(self) -> TensorSchema:
        return self._config["schema"]

    def clone(self, **changes) -> "TiSasRec":
        """A copy with some constructor arguments changed (flax's ``Module.clone``)
        and this model's current weights."""
        twin = TiSasRec(**{**self._config, **changes})
        twin.load_state_dict(self.state_dict())
        return twin

    def _intervals(self, timestamps: torch.Tensor, padding_mask: torch.Tensor) -> torch.Tensor:
        """Clipped personalized intervals [B, L, L] (int ids into the bias table)."""
        timestamps = timestamps.to(_NARROWED.get(timestamps.dtype, timestamps.dtype))
        diffs = torch.abs(timestamps[:, :, None] - timestamps[:, None, :]).to(torch.float32)
        pair_valid = padding_mask[:, :, None] & padding_mask[:, None, :]
        # personalized scale: the row's smallest positive gap
        masked = torch.where(pair_valid & (diffs > 0), diffs, math.inf)
        min_gap = torch.amin(masked.reshape(diffs.shape[0], -1), dim=1)
        min_gap = torch.where(torch.isfinite(min_gap), torch.clamp(min_gap, min=1e-9), 1.0)
        scaled = diffs / min_gap[:, None, None]
        return torch.clamp(scaled, 0, self.time_span).to(torch.int32)

    def forward(
        self,
        feature_tensors: TensorMap,
        padding_mask: torch.Tensor,
        deterministic: bool = True,
    ) -> torch.Tensor:
        """Hidden states [B, L, E], in the compute ``dtype``."""
        embeddings = self.embedder({k: v for k, v in feature_tensors.items() if k != self.timestamps_name})
        x = self.aggregator(embeddings, deterministic=deterministic)
        attention_mask = causal_attention_mask(padding_mask, deterministic=deterministic, dtype=self.dtype)
        timestamps = feature_tensors.get(self.timestamps_name)
        if timestamps is not None:
            bias = self.interval_bias(self._intervals(timestamps, padding_mask))  # [B, L, L, H]
            attention_mask = attention_mask + bias.permute(0, 3, 1, 2)  # [B, H, L, L]
        keep = padding_mask[..., None].to(x.dtype)
        for i in range(self.num_blocks):
            h = getattr(self, f"attention_{i}")(
                getattr(self, f"attn_norm_{i}")(x), attention_mask, deterministic=deterministic
            )
            x = x + h
            x = getattr(self, f"ffn_{i}")(getattr(self, f"ffn_norm_{i}")(x), deterministic=deterministic) * keep
        return self.final_norm(x)

    def get_logits(self, hidden: torch.Tensor, candidates_to_score: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Score hidden states against the catalog (or given candidate ids)."""
        if candidates_to_score is None:
            return self.head(hidden, self.embedder.get_item_weights())
        embedded = self.embedder.get_item_weights(candidates_to_score)
        if candidates_to_score.dim() == 1:
            return self.head(hidden, embedded)
        return torch.einsum("...e,...ke->...k", hidden, embedded)

    def get_item_weights(self) -> torch.Tensor:
        """Item-embedding table [num_items, E], f32 whatever the compute dtype."""
        return self.embedder.get_item_weights()

    def forward_inference(
        self,
        feature_tensors: TensorMap,
        padding_mask: torch.Tensor,
        candidates_to_score: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Scores of the NEXT item after each sequence: [B, num_items] or [B, K]."""
        hidden = self(feature_tensors, padding_mask, deterministic=True)
        return self.get_logits(hidden[:, -1, :], candidates_to_score)
