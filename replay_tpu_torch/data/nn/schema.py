"""Tensor-level feature metadata for neural models.

A copy of ``replay_tpu/data/nn/schema.py`` (host-only, no array code), kept in
the port so that it imports nothing of the JAX package: ``TensorFeatureSource``
(which frame/column a tensor comes from), ``TensorFeatureInfo`` (type, sequential
flag, hint, cardinality excluding padding, padding value, embedding/tensor dims),
and ``TensorSchema`` — an ordered mapping with filter/subset algebra and JSON
(de)serialization. The JSON form is the same, so a schema written by one package
loads in the other.
"""

from __future__ import annotations

import json
from collections.abc import Iterator, Mapping, Sequence
from typing import Dict, List, Optional, Union

from replay_tpu_torch.data.schema import FeatureHint, FeatureSource, FeatureType

# Batches are plain dicts name -> array; models consume TensorMap.
TensorMap = Dict[str, "object"]


class TensorFeatureSource:
    """Provenance of a tensor feature: source frame + column (+ optional index)."""

    def __init__(self, source: FeatureSource, column: str, index: Optional[int] = None) -> None:
        self._source = source
        self._column = column
        self._index = index

    source = property(lambda self: self._source)
    column = property(lambda self: self._column)
    index = property(lambda self: self._index)

    def __eq__(self, other) -> bool:
        if not isinstance(other, TensorFeatureSource):
            return NotImplemented
        return (self._source, self._column, self._index) == (other._source, other._column, other._index)

    def __repr__(self) -> str:  # pragma: no cover
        return f"TensorFeatureSource({self._source}, {self._column!r}, {self._index})"


class TensorFeatureInfo:
    """Metadata of one tensor feature fed to a neural model."""

    DEFAULT_EMBEDDING_DIM = 64

    def __init__(
        self,
        name: str,
        feature_type: FeatureType,
        is_seq: bool = False,
        feature_hint: Optional[FeatureHint] = None,
        feature_sources: Optional[List[TensorFeatureSource]] = None,
        cardinality: Optional[int] = None,
        padding_value: Optional[int] = None,
        embedding_dim: Optional[int] = None,
        tensor_dim: Optional[int] = None,
    ) -> None:
        if not isinstance(feature_type, FeatureType):
            msg = "feature_type must be a FeatureType"
            raise ValueError(msg)
        if not feature_type.is_categorical and cardinality is not None:
            msg = f"Cardinality is only valid for categorical features ('{name}')."
            raise ValueError(msg)
        if feature_type.is_categorical and tensor_dim is not None:
            msg = f"tensor_dim is only valid for numerical features ('{name}')."
            raise ValueError(msg)
        self._name = name
        self._feature_type = feature_type
        self._is_seq = is_seq
        self._feature_hint = feature_hint
        self._feature_sources = feature_sources
        self._cardinality = cardinality
        self._padding_value = padding_value
        self._embedding_dim = embedding_dim if embedding_dim is not None else self.DEFAULT_EMBEDDING_DIM
        self._tensor_dim = tensor_dim if not feature_type.is_categorical else None

    name = property(lambda self: self._name)
    feature_type = property(lambda self: self._feature_type)
    is_seq = property(lambda self: self._is_seq)
    feature_hint = property(lambda self: self._feature_hint)

    @property
    def padding_value(self) -> int:
        """Padding id of this feature.

        Defaults to ``cardinality`` for categorical features (the embedding layer
        reserves the LAST table row for padding so item ids align with logit
        columns — see replay_tpu_torch/nn/embedding.py) and to 0 otherwise.
        """
        if self._padding_value is not None:
            return self._padding_value
        if self.is_cat and self.cardinality is not None:
            return self.cardinality
        return 0

    @property
    def feature_sources(self) -> Optional[List[TensorFeatureSource]]:
        return self._feature_sources

    @property
    def feature_source(self) -> Optional[TensorFeatureSource]:
        """The single source of this feature (None if absent)."""
        if not self._feature_sources:
            return None
        return self._feature_sources[0]

    @property
    def is_cat(self) -> bool:
        return self._feature_type.is_categorical

    @property
    def is_num(self) -> bool:
        return not self._feature_type.is_categorical

    @property
    def is_list(self) -> bool:
        return self._feature_type.is_list

    @property
    def cardinality(self) -> Optional[int]:
        if not self.is_cat:
            msg = f"Feature '{self._name}' is not categorical; cardinality is undefined."
            raise RuntimeError(msg)
        return self._cardinality

    def _set_cardinality(self, cardinality: int) -> None:
        self._cardinality = cardinality

    @property
    def embedding_dim(self) -> Optional[int]:
        return self._embedding_dim

    @property
    def tensor_dim(self) -> Optional[int]:
        if self.is_cat:
            msg = f"Feature '{self._name}' is categorical; tensor_dim is undefined."
            raise RuntimeError(msg)
        return self._tensor_dim

    def _set_tensor_dim(self, dim: int) -> None:
        self._tensor_dim = dim

    def __eq__(self, other) -> bool:
        if not isinstance(other, TensorFeatureInfo):
            return NotImplemented
        return self._as_dict() == other._as_dict()

    def __repr__(self) -> str:  # pragma: no cover
        return f"TensorFeatureInfo({self._name!r}, {self._feature_type}, seq={self._is_seq})"

    # -- serialization ----------------------------------------------------
    def _as_dict(self) -> dict:
        return {
            "name": self._name,
            "feature_type": self._feature_type.name,
            "is_seq": self._is_seq,
            "feature_hint": self._feature_hint.name if self._feature_hint else None,
            "feature_sources": [
                {"source": s.source.name, "column": s.column, "index": s.index}
                for s in self._feature_sources
            ]
            if self._feature_sources
            else None,
            "cardinality": self._cardinality,
            "padding_value": self._padding_value,
            "embedding_dim": self._embedding_dim,
            "tensor_dim": self._tensor_dim,
        }

    @classmethod
    def _from_dict(cls, data: dict) -> "TensorFeatureInfo":
        sources = data.get("feature_sources")
        feature_type = FeatureType[data["feature_type"]]
        return cls(
            name=data["name"],
            feature_type=feature_type,
            is_seq=data.get("is_seq", False),
            feature_hint=FeatureHint[data["feature_hint"]] if data.get("feature_hint") else None,
            feature_sources=[
                TensorFeatureSource(FeatureSource[s["source"]], s["column"], s.get("index"))
                for s in sources
            ]
            if sources
            else None,
            cardinality=data.get("cardinality") if feature_type.is_categorical else None,
            padding_value=data.get("padding_value"),
            embedding_dim=data.get("embedding_dim") if feature_type.is_categorical else None,
            tensor_dim=data.get("tensor_dim") if not feature_type.is_categorical else None,
        )


class TensorSchema(Mapping[str, TensorFeatureInfo]):
    """Ordered mapping feature-name → :class:`TensorFeatureInfo` with selection algebra."""

    def __init__(self, features: Union[Sequence[TensorFeatureInfo], TensorFeatureInfo]) -> None:
        if isinstance(features, TensorFeatureInfo):
            features = [features]
        self._features: dict[str, TensorFeatureInfo] = {f.name: f for f in features}

    # -- Mapping protocol -------------------------------------------------
    def __getitem__(self, name: str) -> TensorFeatureInfo:
        return self._features[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._features)

    def __len__(self) -> int:
        return len(self._features)

    def __add__(self, other: "TensorSchema") -> "TensorSchema":
        return TensorSchema(list(self._features.values()) + list(other._features.values()))

    def item(self) -> TensorFeatureInfo:
        if len(self._features) != 1:
            msg = f"Expected exactly one feature, got {len(self._features)}."
            raise ValueError(msg)
        return next(iter(self._features.values()))

    def subset(self, names) -> "TensorSchema":
        keep = set(names)
        return TensorSchema([f for f in self._features.values() if f.name in keep])

    def filter(
        self,
        name: Optional[str] = None,
        feature_hint: Optional[FeatureHint] = None,
        is_seq: Optional[bool] = None,
        feature_type: Optional[FeatureType] = None,
    ) -> "TensorSchema":
        def pred(f: TensorFeatureInfo) -> bool:
            return (
                (name is None or f.name == name)
                and (feature_hint is None or f.feature_hint == feature_hint)
                and (is_seq is None or f.is_seq == is_seq)
                and (feature_type is None or f.feature_type == feature_type)
            )

        return TensorSchema([f for f in self._features.values() if pred(f)])

    # -- views ------------------------------------------------------------
    @property
    def all_features(self) -> Sequence[TensorFeatureInfo]:
        return list(self._features.values())

    @property
    def names(self) -> Sequence[str]:
        return list(self._features)

    @property
    def categorical_features(self) -> "TensorSchema":
        return TensorSchema([f for f in self._features.values() if f.is_cat])

    @property
    def numerical_features(self) -> "TensorSchema":
        return TensorSchema([f for f in self._features.values() if f.is_num])

    @property
    def sequential_features(self) -> "TensorSchema":
        return TensorSchema([f for f in self._features.values() if f.is_seq])

    @property
    def item_id_features(self) -> "TensorSchema":
        return self.filter(feature_hint=FeatureHint.ITEM_ID)

    @property
    def timestamp_features(self) -> "TensorSchema":
        return self.filter(feature_hint=FeatureHint.TIMESTAMP)

    @property
    def rating_features(self) -> "TensorSchema":
        return self.filter(feature_hint=FeatureHint.RATING)

    @property
    def query_id_features(self) -> "TensorSchema":
        return self.filter(feature_hint=FeatureHint.QUERY_ID)

    @property
    def item_id_feature_name(self) -> Optional[str]:
        features = self.item_id_features
        return features.item().name if len(features) == 1 else None

    @property
    def query_id_feature_name(self) -> Optional[str]:
        features = self.query_id_features
        return features.item().name if len(features) == 1 else None

    @property
    def timestamp_feature_name(self) -> Optional[str]:
        features = self.filter(feature_hint=FeatureHint.TIMESTAMP)
        return features.item().name if len(features) == 1 else None

    @property
    def rating_feature_name(self) -> Optional[str]:
        features = self.filter(feature_hint=FeatureHint.RATING)
        return features.item().name if len(features) == 1 else None

    # -- serialization ----------------------------------------------------
    def to_dict(self) -> list:
        return [f._as_dict() for f in self._features.values()]

    @classmethod
    def from_dict(cls, data: list) -> "TensorSchema":
        return cls([TensorFeatureInfo._from_dict(d) for d in data])

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_json(cls, payload: str) -> "TensorSchema":
        return cls.from_dict(json.loads(payload))
