"""BERT4Rec: bidirectional masked-LM next-item model.

Counterpart of ``replay_tpu/nn/sequential/bert4rec/model.py``: ``Bert4RecBody``
(embed → mask-substitute → +position → LayerNorm → dropout → bidirectional
encoder, ``num_passes_over_block`` times → final LayerNorm) and ``Bert4Rec``
with a weight-tying head.

* The ``<MASK>`` token is a learned vector substituted into the summed feature
  embedding before positions are added, so the item table keeps its
  ``cardinality + 1`` rows and weight tying stays aligned.
* The positional rows are the last ``L`` rows of the table: the most recent
  position maps to the last row.
* Inference appends the mask token by shifting the left-padded window one slot
  left and masking the last position (``forward_inference``,
  ``get_query_embeddings``): static shapes, so it runs inside a CUDA graph.
* Attention is the padding-only bidirectional mask on every route:
  ``use_flash=False`` (unfused), ``True`` (kernel K4) or ``"tiled"`` (kernel
  K5, non-causal).
* The encoder is SASRec's, with its ``remat``, ``remat_policy`` and
  ``scan_blocks`` (:mod:`replay_tpu_torch.nn.sequential.sasrec.transformer`).

Training batches carry ``token_mask`` (True = visible) from
``TokenMaskTransform``; the targets are the original ids at the masked
positions (:func:`~replay_tpu_torch.nn.transform.make_default_bert4rec_transforms`).
Module and parameter names follow the flax tree (``body.mask_embedding``,
``body.positional_embedding``, ``body.input_norm``, ...), so
:mod:`replay_tpu_torch.convert` carries the weights across.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from replay_tpu_torch.data.nn.schema import TensorMap, TensorSchema
from replay_tpu_torch.device import DeviceLike, resolve_device
from replay_tpu_torch.nn.embedding import SequenceEmbedding
from replay_tpu_torch.nn.head import EmbeddingTyingHead
from replay_tpu_torch.nn.layers import LayerNorm
from replay_tpu_torch.nn.mask import attention_mask_for_route
from replay_tpu_torch.obs.health import sow_stage_stats

from ..sasrec.transformer import SasRecTransformerLayer


def shift_for_inference(feature_tensors: TensorMap, padding_mask: torch.Tensor):
    """The window shifted one slot left with a masked slot appended: the
    features, the padding mask (the new slot counts as real) and the token mask
    (only the new slot is masked)."""
    shifted = {
        name: torch.cat([value[:, 1:], value[:, -1:]], dim=1) if value.dim() >= 2 else value
        for name, value in feature_tensors.items()
    }
    shifted_padding = torch.cat([padding_mask[:, 1:], torch.ones_like(padding_mask[:, -1:])], dim=1)
    token_mask = torch.cat(
        [torch.ones_like(shifted_padding[:, :-1]), torch.zeros_like(shifted_padding[:, -1:])], dim=1
    )
    return shifted, shifted_padding, token_mask


class Bert4RecBody(nn.Module):
    """Embed → mask-substitute → +position → LN/dropout → bidirectional encoder."""

    def __init__(
        self,
        schema: TensorSchema,
        embedding_dim: int = 64,
        num_blocks: int = 2,
        num_heads: int = 4,
        max_sequence_length: int = 50,
        hidden_dim: Optional[int] = None,
        dropout_rate: float = 0.0,
        activation: str = "gelu",
        num_passes_over_block: int = 1,
        remat: bool = False,
        remat_policy=None,  # a selective-checkpoint policy (Trainer(remat_policy=...))
        scan_blocks: bool = False,  # one block over stacked [layers, ...] params
        use_flash=False,  # False | True (kernel K4) | "tiled" (kernel K5, long L)
        excluded_features: tuple = (),
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.max_sequence_length = max_sequence_length
        self.dropout_rate = dropout_rate
        self.num_passes_over_block = num_passes_over_block
        self.use_flash = use_flash
        self.dtype = dtype
        self.embedder = SequenceEmbedding(schema, excluded_features=excluded_features, dtype=dtype)
        self.mask_embedding = nn.Parameter(torch.zeros(embedding_dim))
        self.positional_embedding = nn.Parameter(torch.zeros(max_sequence_length, embedding_dim))
        self.input_norm = LayerNorm(embedding_dim, dtype)
        self.encoder = SasRecTransformerLayer(
            embedding_dim,
            num_blocks=num_blocks,
            num_heads=num_heads,
            hidden_dim=hidden_dim or embedding_dim * 4,
            dropout_rate=dropout_rate,
            activation=activation,
            remat=remat,
            remat_policy=remat_policy,
            scan_blocks=scan_blocks,
            use_flash=use_flash,
            dtype=dtype,
        )
        self.final_norm = LayerNorm(embedding_dim, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embedder.reset_parameters(generator)
        nn.init.normal_(self.mask_embedding, std=0.02, generator=generator)
        nn.init.normal_(self.positional_embedding, std=0.02, generator=generator)
        self.input_norm.reset_parameters()
        self.encoder.reset_parameters(generator)
        self.final_norm.reset_parameters()

    def forward(
        self,
        feature_tensors: TensorMap,
        padding_mask: torch.Tensor,  # [B, L] bool
        token_mask: Optional[torch.Tensor] = None,  # [B, L] (or [B, L, 1]) bool, True = visible
        deterministic: bool = True,
        segment_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        embeddings = self.embedder(feature_tensors)
        names = sorted(embeddings)
        total = embeddings[names[0]]
        for name in names[1:]:
            total = total + embeddings[name]
        if token_mask is not None:
            visible = token_mask.reshape(token_mask.shape[0], token_mask.shape[1])
            total = torch.where(visible[..., None], total, self.mask_embedding.to(total.dtype))
        seq_len = total.shape[1]
        if seq_len > self.max_sequence_length:
            msg = f"Sequence length {seq_len} exceeds positional table size {self.max_sequence_length}"
            raise ValueError(msg)
        # left-padded inputs: the most recent position maps to the last table row
        x = total + self.positional_embedding[self.max_sequence_length - seq_len :].to(total.dtype)
        x = F.dropout(self.input_norm(x), self.dropout_rate, training=not deterministic)
        # model-health stage stats (a no-op outside a health capture)
        sow_stage_stats(self, "embed", x)
        attention_mask = attention_mask_for_route(
            self.use_flash, padding_mask, causal=False, deterministic=deterministic,
            dtype=self.dtype, segment_ids=segment_ids,
        )
        for _ in range(self.num_passes_over_block):
            x = self.encoder(x, attention_mask, padding_mask, deterministic=deterministic, causal=False)
        out = self.final_norm(x)
        sow_stage_stats(self, "final_norm", out)
        return out


class Bert4Rec(nn.Module):
    """BERT4Rec with an embedding-tying head."""

    # bias-free head contract: get_logits(h) == h . get_item_weights()^T
    logits_via_item_weights = True

    def __init__(
        self,
        schema: TensorSchema,
        embedding_dim: int = 64,
        num_blocks: int = 2,
        num_heads: int = 4,
        max_sequence_length: int = 50,
        hidden_dim: Optional[int] = None,
        dropout_rate: float = 0.0,
        activation: str = "gelu",
        num_passes_over_block: int = 1,
        remat: bool = False,
        remat_policy=None,
        scan_blocks: bool = False,
        use_flash=False,  # False | True (kernel K4) | "tiled" (kernel K5, long L)
        excluded_features: tuple = (),
        dtype: torch.dtype = torch.float32,  # compute dtype; parameters stay f32
        device: DeviceLike = "cuda",
        generator: Optional[torch.Generator] = None,
    ) -> None:
        super().__init__()
        device = resolve_device(device)
        self.embedding_dim = embedding_dim
        self.num_blocks = num_blocks
        self.max_sequence_length = max_sequence_length
        self.remat = remat
        self.use_flash = use_flash
        self.dtype = dtype
        config = dict(
            embedding_dim=embedding_dim,
            num_blocks=num_blocks,
            num_heads=num_heads,
            max_sequence_length=max_sequence_length,
            hidden_dim=hidden_dim,
            dropout_rate=dropout_rate,
            activation=activation,
            num_passes_over_block=num_passes_over_block,
            remat=remat,
            remat_policy=remat_policy,
            scan_blocks=scan_blocks,
            use_flash=use_flash,
            excluded_features=excluded_features,
            dtype=dtype,
        )
        # what clone() rebuilds the model from
        self._config = dict(schema=schema, device=device, **config)
        self.body = Bert4RecBody(schema, **config)
        self.head = EmbeddingTyingHead()
        self.body.reset_parameters(generator if generator is not None else torch.Generator().manual_seed(0))
        self.to(device)

    @classmethod
    def from_params(
        cls,
        schema: TensorSchema,
        embedding_dim: int = 192,
        num_heads: int = 4,
        num_blocks: int = 2,
        max_sequence_length: int = 50,
        dropout: float = 0.3,
        excluded_features=None,
        **kwargs,
    ) -> "Bert4Rec":
        """Keyword-compatible constructor matching the SasRec/TwoTower shape;
        the query id and timestamp features are excluded from the embedder."""
        excluded = {
            name for name in (schema.query_id_feature_name, schema.timestamp_feature_name) if name is not None
        } | set(excluded_features or [])
        return cls(
            schema=schema,
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

    def clone(self, **changes) -> "Bert4Rec":
        """A copy with some constructor arguments changed (flax's ``Module.clone``)
        and this model's current weights, e.g. ``clone(dtype=torch.bfloat16)``."""
        twin = Bert4Rec(**{**self._config, **changes})
        twin.load_state_dict(self.state_dict())
        return twin

    def forward(
        self,
        feature_tensors: TensorMap,
        padding_mask: torch.Tensor,
        token_mask: Optional[torch.Tensor] = None,
        deterministic: bool = True,
        segment_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Hidden states [B, L, E]; masked positions are the MLM prediction sites."""
        return self.body(
            feature_tensors, padding_mask, token_mask=token_mask, deterministic=deterministic,
            segment_ids=segment_ids,
        )

    def get_logits(self, hidden: torch.Tensor, candidates_to_score: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Score hidden states against the catalog (or candidate ids)."""
        if candidates_to_score is None:
            return self.head(hidden, self.body.embedder.get_item_weights())
        embedded = self.body.embedder.get_item_weights(candidates_to_score)
        if candidates_to_score.dim() == 1:
            return self.head(hidden, embedded)
        return torch.einsum("...e,...ke->...k", hidden, embedded)

    def forward_inference(
        self,
        feature_tensors: TensorMap,
        padding_mask: torch.Tensor,
        candidates_to_score: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Next-item scores: ``<MASK>`` appended after the last event (a
        static-shape left shift), its logits read: [B, num_items] or [B, K]."""
        shifted, shifted_padding, token_mask = shift_for_inference(feature_tensors, padding_mask)
        hidden = self.body(shifted, shifted_padding, token_mask=token_mask, deterministic=True)
        return self.get_logits(hidden[:, -1, :], candidates_to_score)

    def get_item_weights(self) -> torch.Tensor:
        """Item-embedding table [num_items, E], f32 whatever the compute dtype."""
        return self.body.embedder.get_item_weights()

    def get_query_embeddings(self, feature_tensors: TensorMap, padding_mask: torch.Tensor) -> torch.Tensor:
        """Mask-position hidden state per query [B, E]."""
        shifted, shifted_padding, token_mask = shift_for_inference(feature_tensors, padding_mask)
        return self.body(shifted, shifted_padding, token_mask=token_mask, deterministic=True)[:, -1, :]
