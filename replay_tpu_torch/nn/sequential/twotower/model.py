"""TwoTower retrieval model: transformer query tower × feature-fused item tower.

Counterpart of ``replay_tpu/nn/sequential/twotower/model.py``. The query tower
embeds the interaction sequence, adds positions (``PositionAwareAggregator``),
runs the causal SASRec encoder and a final LayerNorm, then an optional context
merger. The item tower encodes item ids, plus the catalog's item features when
the model has an ``item_schema``, through a SwiGLU encoder. Both towers share
one item-id embedding table.

Catalog features are call inputs (``item_feature_tensors``: a dict of
``[num_items, ...]`` arrays, :class:`~replay_tpu_torch.nn.sequential.twotower.
reader.FeaturesReader`), not module state, so an evaluation pass encodes the
catalog once with the current weights (``Trainer.validate`` /
``predict_top_k``) and nothing is cached across training steps.

Shared negative pools: the sampled losses broadcast an in-batch pool of N ids
to ``[B, L, N]`` candidates. The literal form encodes every one of those
``B·L·N`` rows through the item tower, whose ``[B, L, N, hidden]``
intermediates do not fit a card at ``bench_suite.py``'s twotower width. The item
tower is row-wise and runs without dropout (``encode_items`` never passes
``deterministic=False``, as in the JAX model), so encoding each distinct row
once and scoring it against every query that shares it is the same function:
when the candidates are a broadcast view (stride 0 along trailing leading
dims), ``get_logits`` encodes the pool once and scores it with one batched
product. ``dedup_candidates = False`` on an instance keeps the literal form.
"""

from __future__ import annotations

import copy
import math
from typing import Optional

import torch
from torch import nn

from replay_tpu_torch.data.nn.schema import TensorMap, TensorSchema
from replay_tpu_torch.device import DeviceLike, resolve_device
from replay_tpu_torch.nn.agg import PositionAwareAggregator
from replay_tpu_torch.nn.embedding import SequenceEmbedding
from replay_tpu_torch.nn.ffn import SwiGLUEncoder
from replay_tpu_torch.nn.head import EmbeddingTyingHead
from replay_tpu_torch.nn.layers import LayerNorm
from replay_tpu_torch.nn.mask import attention_mask_for_route

from ..sasrec.transformer import SasRecTransformerLayer


def _kept_prefix(candidates: torch.Tensor) -> Optional[int]:
    """For candidates ``[D1, ..., Dn, N]`` that repeat one pool along their
    trailing leading dims (stride 0 from some dim on, as ``expand`` makes
    them): how many leading dims are not repeated. ``None`` when no dim is."""
    lead = candidates.dim() - 1
    sizes, strides = candidates.shape[:lead], candidates.stride()[:lead]
    repeated = [size == 1 or stride == 0 for size, stride in zip(sizes, strides)]
    for kept in range(lead):
        if all(repeated[kept:]) and any(size > 1 for size in sizes[kept:]):
            return kept
    return None


class TwoTower(nn.Module):
    """Query tower (sequence transformer) scored against the item tower.

    :param schema: query-side sequential features (must contain ITEM_ID).
    :param item_schema: optional non-sequential item-side features fused into the
        item tower; their tensors arrive at call time as ``item_feature_tensors``.
    :param context_merger: optional module fusing the query tower's hidden
        states with the raw input features, called as
        ``merger(hidden [B, L, E], feature_tensors) -> [B, L, E]`` after the
        final norm, in training and inference alike; registered as
        ``context_merger``, so its weights convert under that scope.
    """

    # get_logits over a broadcast candidate pool encodes the pool once (see
    # the module docstring); False keeps the literal [B, L, N] encode
    dedup_candidates = True

    def __init__(
        self,
        schema: TensorSchema,
        item_schema: Optional[TensorSchema] = None,
        context_merger: Optional[nn.Module] = None,
        embedding_dim: int = 64,
        num_blocks: int = 2,
        num_heads: int = 1,
        max_sequence_length: int = 50,
        hidden_dim: Optional[int] = None,
        dropout_rate: float = 0.0,
        item_encoder_blocks: int = 1,
        excluded_features: tuple = (),
        use_flash=False,  # False | True (kernel K4) | "tiled" (kernel K5, long L)
        dtype: torch.dtype = torch.float32,  # compute dtype; parameters stay f32
        device: DeviceLike = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.embedding_dim = embedding_dim
        self.num_blocks = num_blocks
        self.max_sequence_length = max_sequence_length
        self.use_flash = use_flash
        self.dtype = dtype
        self.item_schema = item_schema
        self._config = dict(
            schema=schema, item_schema=item_schema, context_merger=context_merger, embedding_dim=embedding_dim,
            num_blocks=num_blocks, num_heads=num_heads, max_sequence_length=max_sequence_length,
            hidden_dim=hidden_dim, dropout_rate=dropout_rate, item_encoder_blocks=item_encoder_blocks,
            excluded_features=excluded_features, use_flash=use_flash, dtype=dtype, device=device,
        )
        self.embedder = SequenceEmbedding(schema, excluded_features=excluded_features, dtype=dtype)
        self.aggregator = PositionAwareAggregator(embedding_dim, max_sequence_length, dropout_rate)
        self.encoder = SasRecTransformerLayer(
            embedding_dim,
            num_blocks=num_blocks,
            num_heads=num_heads,
            hidden_dim=hidden_dim or embedding_dim * 4,
            dropout_rate=dropout_rate,
            use_flash=use_flash,
            dtype=dtype,
        )
        self.final_norm = LayerNorm(embedding_dim, dtype)
        self.context_merger = context_merger
        if item_schema is not None:
            self.item_feature_embedder = SequenceEmbedding(item_schema, dtype=dtype)
        self.item_encoder = SwiGLUEncoder(
            embedding_dim,
            num_blocks=item_encoder_blocks,
            hidden_dim=hidden_dim or embedding_dim * 4,
            output_dim=embedding_dim,
            dropout_rate=dropout_rate,
            dtype=dtype,
        )
        self.head = EmbeddingTyingHead()
        generator = generator if generator is not None else torch.Generator().manual_seed(0)
        self.embedder.reset_parameters(generator)
        self.aggregator.reset_parameters(generator)
        self.encoder.reset_parameters(generator)
        self.final_norm.reset_parameters()
        if item_schema is not None:
            self.item_feature_embedder.reset_parameters(generator)
        self.item_encoder.reset_parameters(generator)
        self.to(device)

    @classmethod
    def from_params(
        cls,
        schema: TensorSchema,
        item_schema: Optional[TensorSchema] = None,
        embedding_dim: int = 192,
        num_heads: int = 4,
        num_blocks: int = 2,
        max_sequence_length: int = 50,
        dropout: float = 0.3,
        excluded_features=None,
        **kwargs,
    ) -> "TwoTower":
        """Keyword-compatible constructor; the query id and timestamp features
        are excluded from the embedder."""
        excluded = {
            name for name in (schema.query_id_feature_name, schema.timestamp_feature_name) if name is not None
        } | set(excluded_features or [])
        return cls(
            schema=schema,
            item_schema=item_schema,
            embedding_dim=embedding_dim,
            num_heads=num_heads,
            num_blocks=num_blocks,
            max_sequence_length=max_sequence_length,
            dropout_rate=dropout,
            excluded_features=tuple(sorted(excluded)),
            **kwargs,
        )

    @property
    def schema(self) -> TensorSchema:
        """The tensor schema the model was built from (vocabulary surgery
        updates it in place)."""
        return self._config["schema"]

    def clone(self, **changes) -> "TwoTower":
        """A copy with some constructor arguments changed and this model's
        current weights (the context merger copied, not shared)."""
        config = {**self._config, **changes}
        if config["context_merger"] is not None:
            config["context_merger"] = copy.deepcopy(config["context_merger"])
        twin = TwoTower(**config)
        twin.load_state_dict(self.state_dict())
        return twin

    # -- query tower -------------------------------------------------------- #
    def forward(
        self,
        feature_tensors: TensorMap,
        padding_mask: torch.Tensor,
        deterministic: bool = True,
    ) -> torch.Tensor:
        """Query hidden states [B, L, E]."""
        x = self.aggregator(self.embedder(feature_tensors), deterministic=deterministic)
        attention_mask = attention_mask_for_route(
            self.use_flash, padding_mask, causal=True, deterministic=deterministic, dtype=self.dtype,
        )
        x = self.encoder(x, attention_mask, padding_mask, deterministic=deterministic)
        x = self.final_norm(x)
        if self.context_merger is not None:
            x = self.context_merger(x, feature_tensors)
        return x

    # -- item tower --------------------------------------------------------- #
    def encode_items(
        self,
        candidates: Optional[torch.Tensor] = None,
        item_feature_tensors: Optional[TensorMap] = None,
    ) -> torch.Tensor:
        """Item-tower embeddings: [num_items, E] for the catalog, or the rows of
        ``candidates`` ([..., E]): id embedding + fused item features through
        the SwiGLU encoder."""
        base = self.embedder.get_item_weights(candidates)
        if self.item_schema is not None and item_feature_tensors is not None:
            features = {name: torch.as_tensor(value, device=base.device) for name, value in item_feature_tensors.items()}
            if candidates is not None:
                # jnp indexing clamps out-of-range ids (the padding id): so here
                features = {
                    name: value[torch.clamp(candidates.long(), -value.shape[0], value.shape[0] - 1)]
                    for name, value in features.items()
                }
            fused = self.item_feature_embedder(features)
            for name in sorted(fused):
                base = base + fused[name]
        return self.item_encoder(base)

    # -- scoring ------------------------------------------------------------ #
    def get_logits(
        self,
        hidden: torch.Tensor,
        candidates_to_score: Optional[torch.Tensor] = None,
        item_feature_tensors: Optional[TensorMap] = None,
    ) -> torch.Tensor:
        if candidates_to_score is not None and candidates_to_score.dim() >= 2 and self.dedup_candidates:
            kept = _kept_prefix(candidates_to_score)
            if kept is not None:
                return self._pool_logits(hidden, candidates_to_score, kept, item_feature_tensors)
        items = self.encode_items(candidates_to_score, item_feature_tensors)
        if candidates_to_score is None or candidates_to_score.dim() == 1:
            return self.head(hidden, items)
        return torch.einsum("...e,...ke->...k", hidden, items)

    def _pool_logits(self, hidden, candidates, kept: int, item_feature_tensors) -> torch.Tensor:
        """``get_logits`` for candidates that repeat one pool along all but
        their first ``kept`` leading dims: the pool's rows encoded once, each
        scored against every query position that shares it."""
        lead = candidates.dim() - 1
        pool = candidates[(slice(None),) * kept + (0,) * (lead - kept)]  # [D1..Dkept, N]
        items = self.encode_items(pool, item_feature_tensors)  # [D1..Dkept, N, E]
        dtype = torch.promote_types(hidden.dtype, items.dtype)
        groups = math.prod(candidates.shape[:kept])
        queries = hidden.to(dtype).reshape(groups, -1, hidden.shape[-1])  # [P, S, E]
        scores = torch.bmm(queries, items.to(dtype).reshape(groups, -1, items.shape[-1]).transpose(1, 2))
        return scores.reshape(candidates.shape)

    def forward_inference(
        self,
        feature_tensors: TensorMap,
        padding_mask: torch.Tensor,
        candidates_to_score: Optional[torch.Tensor] = None,
        item_feature_tensors: Optional[TensorMap] = None,
    ) -> torch.Tensor:
        """Retrieval scores of the next item: [B, num_items] or [B, K]."""
        hidden = self(feature_tensors, padding_mask, deterministic=True)
        return self.get_logits(hidden[:, -1, :], candidates_to_score, item_feature_tensors)

    def get_query_embeddings(self, feature_tensors: TensorMap, padding_mask: torch.Tensor) -> torch.Tensor:
        """Last-position query hidden state [B, E]."""
        return self(feature_tensors, padding_mask, deterministic=True)[:, -1, :]
