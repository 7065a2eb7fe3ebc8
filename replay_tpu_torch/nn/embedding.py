"""Per-feature sequence embeddings.

Counterpart of ``replay_tpu/nn/embedding.py``: ``CategoricalEmbedding`` (a
table of cardinality + 1 rows, the last one reserved for padding) and
``SequenceEmbedding``, which embeds each feature of a tensor schema and exposes
the item table without its padding row for weight-tying heads. Each embedder is
registered as ``embedding_<feature>`` with its table as ``table``, the flax
module's names, so ``state_dict`` keys map one to one onto the flax param tree.
Lookups compute in ``dtype`` (the table is cast before the gather, as flax's
``Embed`` does); ``get_item_weights()`` returns the f32 table itself, so
full-catalog logits promote to f32.

List, numerical and identity embedders are later slices and raise here.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from replay_tpu_torch.data.nn.schema import TensorFeatureInfo, TensorMap, TensorSchema
from replay_tpu_torch.nn.layers import Embed


class CategoricalEmbedding(nn.Module):
    """Embedding table with one extra row reserved for the padding id."""

    def __init__(
        self, cardinality: int, embedding_dim: int, padding_value: int = 0, dtype: torch.dtype = torch.float32
    ) -> None:
        super().__init__()
        self.cardinality = cardinality
        self.padding_value = padding_value
        self.table = Embed(cardinality + 1, embedding_dim, dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        # flax Embed's default: variance scaling over fan-in, std = 1/sqrt(E)
        nn.init.normal_(self.table.weight, std=self.table.embedding_dim**-0.5, generator=generator)

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
        self, schema: TensorSchema, excluded_features: tuple = (), dtype: torch.dtype = torch.float32
    ) -> None:
        super().__init__()
        self.schema = schema
        self.feature_names = []
        for feature in schema.all_features:
            if feature.name in excluded_features:
                continue
            self.add_module(f"embedding_{feature.name}", self._make_embedder(feature, dtype))
            self.feature_names.append(feature.name)

    @staticmethod
    def _make_embedder(feature: TensorFeatureInfo, dtype: torch.dtype) -> nn.Module:
        if not feature.is_cat or feature.is_list:
            msg = (
                f"Feature '{feature.name}': only categorical (non-list) features are "
                "ported yet; list and numerical embedders come with a later slice"
            )
            raise NotImplementedError(msg)
        if feature.cardinality is None:
            msg = f"Feature '{feature.name}' has no cardinality set."
            raise ValueError(msg)
        return CategoricalEmbedding(
            cardinality=feature.cardinality,
            embedding_dim=feature.embedding_dim,
            padding_value=feature.padding_value,
            dtype=dtype,
        )

    def embedder(self, name: str) -> CategoricalEmbedding:
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
