"""SASRec: causal-attention next-item model.

Counterpart of ``replay_tpu/nn/sequential/sasrec/model.py``: ``SasRecBody``
(embedder → position-aware aggregator → causal mask → transformer encoder →
final norm) and ``SasRec`` with a weight-tying dot-product head. ``forward``
returns hidden states; ``get_logits`` scores them against the catalog or given
candidates; ``forward_inference`` scores the LAST position.

Module names follow the flax param tree (``body.embedder.embedding_item_id.
table``, ``body.aggregator.positional_embedding``, ``body.encoder.block_<i>``,
``body.final_norm``; ``body.encoder.blocks.block`` with ``[N, ...]`` leaves
under ``scan_blocks``), so :mod:`replay_tpu_torch.convert` maps weights one to
one. Weights are drawn from an explicit ``torch.Generator`` on the CPU and then
moved to ``device``, so one seed gives the same model on every device.

``dtype`` is the compute dtype, as the flax modules' ``dtype`` field: with
``torch.bfloat16`` the embeddings, projections, attention and LayerNorm outputs
are bf16 while every parameter stays f32 (the precision ladder's bf16 rung,
:mod:`replay_tpu_torch.nn.precision`). ``use_flash`` picks the attention route:
``False`` (unfused, a ``[B, 1, L, L]`` mask), ``True`` (kernel K4, the same
mask) or ``"tiled"`` (kernel K5, the long-sequence route: no ``[B, 1, L, L]``
tensor at all).

``encoder_type="diff"`` swaps the encoder for the Differential Transformer
(``DiffTransformerLayer``); as in JAX it ignores ``remat``, ``remat_policy``,
``scan_blocks`` and ``use_flash`` (with ``use_flash=True`` it takes the
``[B, 1, L, L]`` mask and launches no kernel), and the ``"tiled"`` route
refuses it. ``remat`` / ``remat_policy`` / ``scan_blocks`` are the SASRec
encoder's (:mod:`.transformer`); ``embedding_init`` (e.g.
``nn.embedding.xavier_normal_embed_init()``) draws every feature table.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from replay_tpu_torch.data.nn.schema import TensorMap, TensorSchema
from replay_tpu_torch.device import DeviceLike, resolve_device
from replay_tpu_torch.nn.agg import PositionAwareAggregator
from replay_tpu_torch.nn.embedding import SequenceEmbedding
from replay_tpu_torch.nn.head import EmbeddingTyingHead
from replay_tpu_torch.nn.layers import LayerNorm
from replay_tpu_torch.nn.mask import attention_mask_for_route
from replay_tpu_torch.obs.health import sow_stage_stats
from replay_tpu_torch.obs.profile import scope

from .transformer import DiffTransformerLayer, SasRecTransformerLayer

ENCODER_TYPES = ("sasrec", "diff")


class SasRecBody(nn.Module):
    """Embed → aggregate(+position) → causally-masked encoder → final LayerNorm."""

    def __init__(
        self,
        schema: TensorSchema,
        embedding_dim: int = 64,
        num_blocks: int = 2,
        num_heads: int = 1,
        max_sequence_length: int = 50,
        hidden_dim: Optional[int] = None,
        dropout_rate: float = 0.0,
        activation: str = "relu",  # the reference SASRec construction pins relu
        encoder_type: str = "sasrec",
        remat: bool = False,
        remat_policy=None,  # a selective-checkpoint policy (Trainer(remat_policy=...))
        scan_blocks: bool = False,  # one block over stacked [layers, ...] params
        use_flash=False,  # False | True (kernel K4) | "tiled" (kernel K5, long L)
        excluded_features: tuple = (),
        dtype: torch.dtype = torch.float32,
        embedding_init=None,  # e.g. nn.embedding.xavier_normal_embed_init()
    ) -> None:
        super().__init__()
        if encoder_type not in ENCODER_TYPES:
            msg = f"Unknown encoder_type: {encoder_type}"
            raise ValueError(msg)
        if use_flash in ("tiled", "ring") and encoder_type != "sasrec":
            # silently running full attention here would defeat the exact
            # long-L regime those routes exist for
            msg = (
                f"use_flash={use_flash!r} supports encoder_type='sasrec' "
                f"only; '{encoder_type}' would fall back to O(L^2) attention"
            )
            raise ValueError(msg)
        self.use_flash = use_flash
        self.embedder = SequenceEmbedding(
            schema, excluded_features=excluded_features, dtype=dtype, embedding_init=embedding_init
        )
        self.aggregator = PositionAwareAggregator(embedding_dim, max_sequence_length, dropout_rate)
        common = dict(
            num_blocks=num_blocks,
            num_heads=num_heads,
            hidden_dim=hidden_dim or embedding_dim * 4,
            dropout_rate=dropout_rate,
            dtype=dtype,
        )
        if encoder_type == "sasrec":
            self.encoder = SasRecTransformerLayer(
                embedding_dim, remat=remat, remat_policy=remat_policy, scan_blocks=scan_blocks,
                use_flash=use_flash, activation=activation, **common,
            )
        else:
            self.encoder = DiffTransformerLayer(embedding_dim, **common)
        self.final_norm = LayerNorm(embedding_dim, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embedder.reset_parameters(generator)
        self.aggregator.reset_parameters(generator)
        self.encoder.reset_parameters(generator)
        self.final_norm.reset_parameters()

    def forward(
        self,
        feature_tensors: TensorMap,
        padding_mask: torch.Tensor,  # [B, L] bool
        deterministic: bool = True,
        segment_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        # the named scopes exist only inside a profile window, and the stage
        # stats only inside a health step's capture (obs/profile.py,
        # obs/health.py): otherwise both are no-ops
        with scope("embed"):
            x = self.aggregator(self.embedder(feature_tensors), deterministic=deterministic)
            sow_stage_stats(self, "embed", x)
        with scope("encoder"):
            attention_mask = attention_mask_for_route(
                self.use_flash, padding_mask, causal=True, deterministic=deterministic,
                dtype=x.dtype, segment_ids=segment_ids,
            )
            x = self.encoder(x, attention_mask, padding_mask, deterministic=deterministic)
        with scope("final_norm"):
            out = self.final_norm(x)
            sow_stage_stats(self, "final_norm", out)
            return out


class SasRec(nn.Module):
    """SASRec with an embedding-tying head."""

    # get_logits is a bias-free tying head over get_item_weights(): the
    # contract CEFused's fused log-sum-exp rebuilds the logits from
    logits_via_item_weights = True

    def __init__(
        self,
        schema: TensorSchema,
        embedding_dim: int = 64,
        num_blocks: int = 2,
        num_heads: int = 1,
        max_sequence_length: int = 50,
        hidden_dim: Optional[int] = None,
        dropout_rate: float = 0.0,
        activation: str = "relu",
        encoder_type: str = "sasrec",
        remat: bool = False,
        remat_policy=None,  # a selective-checkpoint policy (Trainer(remat_policy=...))
        scan_blocks: bool = False,  # one block over stacked [layers, ...] params
        use_flash=False,  # False | True (kernel K4) | "tiled" (kernel K5, long L)
        excluded_features: tuple = (),
        dtype: torch.dtype = torch.float32,  # compute dtype; parameters stay f32
        embedding_init=None,  # e.g. nn.embedding.xavier_normal_embed_init()
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
            encoder_type=encoder_type,
            remat=remat,
            remat_policy=remat_policy,
            scan_blocks=scan_blocks,
            use_flash=use_flash,
            excluded_features=excluded_features,
            dtype=dtype,
            embedding_init=embedding_init,
        )
        # what clone() rebuilds the model from
        self._config = dict(schema=schema, device=device, **config)
        self.body = SasRecBody(schema, **config)
        self.head = EmbeddingTyingHead()
        self.body.reset_parameters(generator if generator is not None else torch.Generator().manual_seed(0))
        self.to(device)

    @property
    def schema(self) -> TensorSchema:
        """The tensor schema the model was built from (vocabulary surgery
        updates it in place)."""
        return self._config["schema"]

    def clone(self, **changes) -> "SasRec":
        """A copy with some constructor arguments changed (flax's ``Module.clone``)
        and this model's current weights, e.g. ``clone(dtype=torch.bfloat16)``."""
        twin = SasRec(**{**self._config, **changes})
        twin.load_state_dict(self.state_dict())
        return twin

    def forward(
        self,
        feature_tensors: TensorMap,
        padding_mask: torch.Tensor,
        deterministic: bool = True,
        segment_ids: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Hidden states [B, L, E], in the compute ``dtype``."""
        return self.body(
            feature_tensors, padding_mask, deterministic=deterministic, segment_ids=segment_ids
        )

    def get_logits(
        self, hidden: torch.Tensor, candidates_to_score: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """Score hidden states against the catalog (or given candidate ids).

        Candidate shapes follow the loss protocol: None → [..., num_items];
        [K] → [..., K]; [B, ..., K] → per-position candidate scores.
        """
        if candidates_to_score is None:
            return self.head(hidden, self.body.embedder.get_item_weights())
        embedded = self.body.embedder.get_item_weights(candidates_to_score)
        if candidates_to_score.dim() == 1:
            return self.head(hidden, embedded)
        # [B, ..., K, E] x hidden [B, ..., E] -> [B, ..., K]
        return torch.einsum("...e,...ke->...k", hidden, embedded)

    def forward_inference(
        self,
        feature_tensors: TensorMap,
        padding_mask: torch.Tensor,
        candidates_to_score: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Scores of the NEXT item after each sequence: [B, num_items] or [B, K]."""
        hidden = self.body(feature_tensors, padding_mask, deterministic=True)
        return self.get_logits(hidden[:, -1, :], candidates_to_score)

    def get_query_embeddings(self, feature_tensors: TensorMap, padding_mask: torch.Tensor) -> torch.Tensor:
        """Last-position hidden state per query [B, E]."""
        return self.body(feature_tensors, padding_mask, deterministic=True)[:, -1, :]

    def get_item_weights(self) -> torch.Tensor:
        """Item-embedding table [num_items, E], f32 whatever the compute dtype."""
        return self.body.embedder.get_item_weights()
