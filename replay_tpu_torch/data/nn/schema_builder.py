"""Fluent builder for :class:`~replay_tpu_torch.data.nn.schema.TensorSchema`.

Counterpart of ``replay_tpu/data/nn/schema_builder.py``: chainable
``categorical``/``numerical`` (and ``_list``) calls that accumulate
:class:`TensorFeatureInfo` entries, and ``build()`` into a schema. A later
call with the same name replaces the earlier one (dict semantics, insertion
order kept).
"""

from __future__ import annotations

from typing import Dict, List, Optional

from replay_tpu_torch.data.schema import FeatureHint, FeatureType

from .schema import TensorFeatureInfo, TensorFeatureSource, TensorSchema


class TensorSchemaBuilder:
    """Accumulate feature declarations, then ``build()`` a ``TensorSchema``."""

    def __init__(self) -> None:
        self._features: Dict[str, TensorFeatureInfo] = {}

    def _add_categorical(
        self,
        name: str,
        feature_type: FeatureType,
        cardinality: int,
        is_seq: bool,
        feature_source: Optional[TensorFeatureSource],
        feature_hint: Optional[FeatureHint],
        embedding_dim: Optional[int],
        padding_value: Optional[int],
    ) -> "TensorSchemaBuilder":
        self._features[name] = TensorFeatureInfo(
            name=name,
            feature_type=feature_type,
            is_seq=is_seq,
            feature_sources=[feature_source] if feature_source else None,
            feature_hint=feature_hint,
            cardinality=cardinality,
            padding_value=padding_value,
            embedding_dim=embedding_dim,
        )
        return self

    def _add_numerical(
        self,
        name: str,
        feature_type: FeatureType,
        tensor_dim: int,
        is_seq: bool,
        feature_sources: Optional[List[TensorFeatureSource]],
        feature_hint: Optional[FeatureHint],
        padding_value: Optional[int],
    ) -> "TensorSchemaBuilder":
        self._features[name] = TensorFeatureInfo(
            name=name,
            feature_type=feature_type,
            is_seq=is_seq,
            feature_sources=feature_sources,
            feature_hint=feature_hint,
            tensor_dim=tensor_dim,
            padding_value=padding_value,
        )
        return self

    def categorical(
        self,
        name: str,
        cardinality: int,
        is_seq: bool = False,
        feature_source: Optional[TensorFeatureSource] = None,
        feature_hint: Optional[FeatureHint] = None,
        embedding_dim: Optional[int] = None,
        padding_value: Optional[int] = None,
    ) -> "TensorSchemaBuilder":
        return self._add_categorical(
            name, FeatureType.CATEGORICAL, cardinality, is_seq,
            feature_source, feature_hint, embedding_dim, padding_value,
        )

    def categorical_list(
        self,
        name: str,
        cardinality: int,
        is_seq: bool = False,
        feature_source: Optional[TensorFeatureSource] = None,
        feature_hint: Optional[FeatureHint] = None,
        embedding_dim: Optional[int] = None,
        padding_value: Optional[int] = None,
    ) -> "TensorSchemaBuilder":
        return self._add_categorical(
            name, FeatureType.CATEGORICAL_LIST, cardinality, is_seq,
            feature_source, feature_hint, embedding_dim, padding_value,
        )

    def numerical(
        self,
        name: str,
        tensor_dim: int,
        is_seq: bool = False,
        feature_sources: Optional[List[TensorFeatureSource]] = None,
        feature_hint: Optional[FeatureHint] = None,
        padding_value: Optional[int] = None,
    ) -> "TensorSchemaBuilder":
        return self._add_numerical(
            name, FeatureType.NUMERICAL, tensor_dim, is_seq,
            feature_sources, feature_hint, padding_value,
        )

    def numerical_list(
        self,
        name: str,
        tensor_dim: int,
        is_seq: bool = False,
        feature_sources: Optional[List[TensorFeatureSource]] = None,
        feature_hint: Optional[FeatureHint] = None,
        padding_value: Optional[int] = None,
    ) -> "TensorSchemaBuilder":
        return self._add_numerical(
            name, FeatureType.NUMERICAL_LIST, tensor_dim, is_seq,
            feature_sources, feature_hint, padding_value,
        )

    def build(self) -> TensorSchema:
        return TensorSchema(list(self._features.values()))
