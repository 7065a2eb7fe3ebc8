"""Per-feature sequence embeddings.

Counterpart of ``replay_tpu/nn/embedding.py``: ``CategoricalEmbedding`` (a
table of cardinality + 1 rows, the last one reserved for padding),
``CategoricalListEmbedding`` (a list feature pooled over its list axis by
``sum``, ``mean`` or ``max``, padding entries masked out: the EmbeddingBag
equivalent), ``NumericalEmbedding`` (a ``Dense`` named ``proj`` from the
feature's ``tensor_dim`` to its embedding width), ``IdentityEmbedding`` (a
pre-embedded list feature as it is), and ``SequenceEmbedding``, which picks one
of them for each feature of a tensor schema by the JAX rules and exposes the
item table without its padding row for weight-tying heads. Each embedder is
registered as ``embedding_<feature>`` with its table as ``table``, the flax
module's names, so ``state_dict`` keys map one to one onto the flax param tree.
Lookups compute in ``dtype`` (the table is cast before the gather, as flax's
``Embed`` does); ``get_item_weights()`` returns the f32 table itself, so
full-catalog logits promote to f32.

flax modules learn a ``Dense``'s input width at the first call; here
``NumericalEmbedding`` takes it from the schema (``tensor_dim``, 1 for a
scalar ``[B, L]`` feature).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch import nn

from replay_tpu_torch.data.nn.schema import TensorFeatureInfo, TensorMap, TensorSchema
from replay_tpu_torch.nn.layers import Dense, Embed
from replay_tpu_torch.nn.utils import TRUNCATED_STD, init_dense

EmbeddingInit = Callable[[torch.Tensor, torch.Generator], None]
POOLINGS = ("sum", "mean", "max")


def xavier_normal_embed_init() -> EmbeddingInit:
    """Xavier init of a [V, D] table: std = sqrt(2 / (V + D)), the reference
    embedders' scale. flax's default (variance-scaling fan-in) gives std =
    1/sqrt(D) instead; pass this to ``embedding_init``. The distribution is
    the JAX package's ``glorot_normal(in_axis=1, out_axis=0)``: a normal
    truncated at ±2σ whose σ is widened so that the std is the one above.
    The returned function fills a table in place from an explicit generator."""

    @torch.no_grad()
    def init(table: torch.Tensor, generator: torch.Generator) -> None:
        rows, dim = table.shape
        std = math.sqrt(2.0 / (rows + dim)) / TRUNCATED_STD
        nn.init.trunc_normal_(table, std=std, a=-2 * std, b=2 * std, generator=generator)

    return init


@torch.no_grad()
def _init_table(table: Embed, embedding_init: Optional[EmbeddingInit], generator: torch.Generator) -> None:
    if embedding_init is not None:
        embedding_init(table.weight, generator)
    else:
        # flax Embed's default: variance scaling over fan-in, std = 1/sqrt(E)
        nn.init.normal_(table.weight, std=table.embedding_dim**-0.5, generator=generator)


class CategoricalEmbedding(nn.Module):
    """Embedding table with one extra row reserved for the padding id."""

    def __init__(
        self,
        cardinality: int,
        embedding_dim: int,
        padding_value: int = 0,
        dtype: torch.dtype = torch.float32,
        embedding_init: Optional[EmbeddingInit] = None,  # None: flax's default
    ) -> None:
        super().__init__()
        self.cardinality = cardinality
        self.padding_value = padding_value
        self.embedding_init = embedding_init
        self.table = Embed(cardinality + 1, embedding_dim, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _init_table(self.table, self.embedding_init, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.table(ids)

    def item_weights(self) -> torch.Tensor:
        """All non-padding rows of the table, aligned with item ids [0, cardinality),
        in the parameters' dtype (f32) whatever the compute dtype.

        Requires ``padding_value == cardinality`` (the LAST table row is the
        padding row): any other padding value would make full-catalog logit
        column ``i`` correspond to a different table row than item id ``i``.
        The rows are all of the table's but its last, whatever table the module
        is called with: a grown generation's table served through a module
        built at the old size (``torch.func.functional_call``) scores its whole
        catalog.
        """
        if self.padding_value != self.cardinality:
            msg = (
                f"Weight tying requires padding_value == cardinality "
                f"({self.cardinality}), got {self.padding_value}: with any other "
                "padding row, logit columns would misalign with item ids. Set "
                f"padding_value={self.cardinality} on the ITEM_ID tensor feature "
                "(the sequence tokenizer does this by default)."
            )
            raise ValueError(msg)
        return self.table.weight[:-1]


class CategoricalListEmbedding(nn.Module):
    """Embed a list feature and pool over the list axis (sum / mean / max).

    Entries equal to ``padding_value`` are masked out; ``mean`` divides by
    the valid count (at least 1); ``max`` fills masked entries with the
    dtype's most negative finite value, and a list with no valid entry
    pools to 0."""

    def __init__(
        self,
        cardinality: int,
        embedding_dim: int,
        padding_value: int = 0,
        pooling: str = "sum",
        dtype: torch.dtype = torch.float32,
        embedding_init: Optional[EmbeddingInit] = None,
    ) -> None:
        super().__init__()
        if pooling not in POOLINGS:
            msg = f"Unknown pooling: {pooling}"
            raise ValueError(msg)
        self.cardinality = cardinality
        self.padding_value = padding_value
        self.pooling = pooling
        self.embedding_init = embedding_init
        self.table = Embed(cardinality + 1, embedding_dim, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        _init_table(self.table, self.embedding_init, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        # ids: [..., list_len] -> [..., emb]
        vectors = self.table(ids)
        valid = (ids != self.padding_value)[..., None].to(vectors.dtype)
        if self.pooling == "sum":
            return torch.sum(vectors * valid, dim=-2)
        if self.pooling == "mean":
            total = torch.sum(vectors * valid, dim=-2)
            return total / torch.clamp(torch.sum(valid, dim=-2), min=1.0)
        masked = torch.where(valid > 0, vectors, torch.finfo(vectors.dtype).min)
        # amax splits the gradient among tied maxima, as jnp.max does
        pooled = torch.amax(masked, dim=-2)
        return torch.where(torch.sum(valid, dim=-2) > 0, pooled, 0.0)


class NumericalEmbedding(nn.Module):
    """Linear projection tensor_dim → embedding_dim (a ``Dense`` named ``proj``)."""

    def __init__(self, embedding_dim: int, tensor_dim: int = 1, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.dtype = dtype
        self.proj = Dense(tensor_dim, embedding_dim, dtype)

    def reset_parameters(self, generator: torch.Generator) -> None:
        init_dense(self.proj, generator)

    def forward(self, values: torch.Tensor) -> torch.Tensor:
        if values.dim() == 2:  # [B, L] scalar feature -> add a feature axis
            values = values[..., None]
        return self.proj(values.to(self.dtype))


class IdentityEmbedding(nn.Module):
    """Pass a pre-embedded numerical tensor through unchanged."""

    def reset_parameters(self, generator: torch.Generator) -> None:
        pass

    def forward(self, values: torch.Tensor) -> torch.Tensor:
        return values


def fit_tables(model: nn.Module, params) -> None:
    """Rebuild, in place, each :class:`CategoricalEmbedding` of ``model``
    whose table has another shape than ``params``' entry of the same name (a
    grown or shrunk catalog): a table of the params' size in the old one's
    compute dtype and on its device, the cardinality and padding row
    following it (the padding row is the last). The new table's values are
    placeholders, for ``params`` to supply."""
    for name, module in list(model.named_modules()):
        key = f"{name}.table.weight"
        if not isinstance(module, CategoricalEmbedding) or key not in params:
            continue
        shape = tuple(params[key].shape)
        old = module.table
        if tuple(old.weight.shape) != shape:
            module.table = Embed(shape[0], shape[1], old.dtype).to(old.weight.device)
            module.cardinality = shape[0] - 1
            module.padding_value = module.cardinality


class SequenceEmbedding(nn.Module):
    """Embed every feature of a tensor schema into a dict of [B, L, E] tensors.

    The feature hinted ITEM_ID provides the weight-tying table via
    :meth:`get_item_weights`.
    """

    def __init__(
        self,
        schema: TensorSchema,
        categorical_list_pooling: str = "sum",
        excluded_features: tuple = (),
        dtype: torch.dtype = torch.float32,
        embedding_init: Optional[EmbeddingInit] = None,
    ) -> None:
        super().__init__()
        self.schema = schema
        self.categorical_list_pooling = categorical_list_pooling
        self.dtype = dtype
        self.embedding_init = embedding_init
        self.feature_names = []
        for feature in schema.all_features:
            if feature.name in excluded_features:
                continue
            self.add_module(f"embedding_{feature.name}", self._make_embedder(feature))
            self.feature_names.append(feature.name)

    def _make_embedder(self, feature: TensorFeatureInfo) -> nn.Module:
        if feature.is_cat:
            if feature.cardinality is None:
                msg = f"Feature '{feature.name}' has no cardinality set."
                raise ValueError(msg)
            common = dict(
                cardinality=feature.cardinality,
                embedding_dim=feature.embedding_dim,
                padding_value=feature.padding_value,
                dtype=self.dtype,
                embedding_init=self.embedding_init,
            )
            if feature.is_list:
                return CategoricalListEmbedding(pooling=self.categorical_list_pooling, **common)
            return CategoricalEmbedding(**common)
        if feature.is_list and feature.tensor_dim is not None and feature.tensor_dim == feature.embedding_dim:
            return IdentityEmbedding()
        return NumericalEmbedding(
            embedding_dim=feature.embedding_dim or TensorFeatureInfo.DEFAULT_EMBEDDING_DIM,
            tensor_dim=feature.tensor_dim or 1,
            dtype=self.dtype,
        )

    def embedder(self, name: str) -> nn.Module:
        return getattr(self, f"embedding_{name}")

    def reset_parameters(self, generator: torch.Generator) -> None:
        for name in self.feature_names:
            self.embedder(name).reset_parameters(generator)

    def forward(self, feature_tensors: TensorMap) -> Dict[str, torch.Tensor]:
        return {
            name: self.embedder(name)(feature_tensors[name])
            for name in self.feature_names
            if name in feature_tensors
        }

    def get_item_weights(self, item_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Item-embedding matrix [num_items, E] (or the rows of ``item_ids``)."""
        item_feature_name = self.schema.item_id_feature_name
        if item_feature_name is None:
            msg = "Schema has no ITEM_ID feature; cannot produce item weights."
            raise RuntimeError(msg)
        embedder = self.embedder(item_feature_name)
        if item_ids is not None:
            return embedder(item_ids)
        return embedder.item_weights()
