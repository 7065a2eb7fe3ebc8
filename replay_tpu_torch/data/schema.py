"""Typed feature metadata for datasets.

A copy of ``replay_tpu/data/schema.py`` (host-only, no frame code), kept in the
port so that it imports nothing of the JAX package: the feature enums
(``FeatureType``, ``FeatureSource``, ``FeatureHint``), ``FeatureInfo`` with its
lazy cardinality, ``FeatureSchema``'s selection algebra and
``interaction_schema``.
"""

from __future__ import annotations

from collections.abc import Callable, Iterable, Iterator, Mapping, Sequence
from enum import Enum
from typing import Optional


class FeatureType(Enum):
    """Value type of a feature column."""

    CATEGORICAL = "categorical"
    CATEGORICAL_LIST = "categorical_list"
    NUMERICAL = "numerical"
    NUMERICAL_LIST = "numerical_list"

    @property
    def is_categorical(self) -> bool:
        return self in (FeatureType.CATEGORICAL, FeatureType.CATEGORICAL_LIST)

    @property
    def is_list(self) -> bool:
        return self in (FeatureType.CATEGORICAL_LIST, FeatureType.NUMERICAL_LIST)


class FeatureSource(Enum):
    """Which dataframe a feature column comes from."""

    ITEM_FEATURES = "item_features"
    QUERY_FEATURES = "query_features"
    INTERACTIONS = "interactions"


class FeatureHint(Enum):
    """Semantic role of a column, consumed by models."""

    ITEM_ID = "item_id"
    QUERY_ID = "query_id"
    RATING = "rating"
    TIMESTAMP = "timestamp"


class FeatureInfo:
    """Metadata for one feature column.

    Cardinality for categorical features may be resolved lazily through a
    callback installed by :class:`~replay_tpu_torch.data.dataset.Dataset`.
    """

    def __init__(
        self,
        column: str,
        feature_type: FeatureType,
        feature_hint: Optional[FeatureHint] = None,
        feature_source: Optional[FeatureSource] = None,
        cardinality: Optional[int] = None,
    ) -> None:
        if not feature_type.is_categorical and cardinality is not None:
            msg = f"Cardinality is only valid for categorical features, got {feature_type} for '{column}'."
            raise ValueError(msg)
        self._column = column
        self._feature_type = feature_type
        self._feature_hint = feature_hint
        self._feature_source = feature_source
        self._cardinality = cardinality
        self._cardinality_callback: Optional[Callable[[str], int]] = None

    column = property(lambda self: self._column)
    feature_type = property(lambda self: self._feature_type)
    feature_hint = property(lambda self: self._feature_hint)
    feature_source = property(lambda self: self._feature_source)

    @property
    def cardinality(self) -> Optional[int]:
        if not self._feature_type.is_categorical:
            msg = f"Feature '{self._column}' is not categorical; cardinality is undefined."
            raise RuntimeError(msg)
        if self._cardinality is None and self._cardinality_callback is not None:
            self._cardinality = self._cardinality_callback(self._column)
        return self._cardinality

    def reset_cardinality(self) -> None:
        """Forget the cached cardinality (e.g. after the data changed)."""
        self._cardinality = None

    def _set_cardinality_callback(self, callback: Callable[[str], int]) -> None:
        self._cardinality_callback = callback

    def _set_feature_source(self, source: FeatureSource) -> None:
        self._feature_source = source

    def copy(self) -> "FeatureInfo":
        return FeatureInfo(
            column=self._column,
            feature_type=self._feature_type,
            feature_hint=self._feature_hint,
            feature_source=self._feature_source,
            cardinality=None,
        )

    def __repr__(self) -> str:  # pragma: no cover - debug helper
        return (
            f"FeatureInfo({self._column!r}, {self._feature_type}, hint={self._feature_hint}, "
            f"source={self._feature_source})"
        )

    def __eq__(self, other: object) -> bool:
        if not isinstance(other, FeatureInfo):
            return NotImplemented
        return (
            self._column == other._column
            and self._feature_type == other._feature_type
            and self._feature_hint == other._feature_hint
            and self._feature_source == other._feature_source
        )

    def __hash__(self) -> int:
        return hash((self._column, self._feature_type, self._feature_hint, self._feature_source))


Predicate = Callable[[FeatureInfo], bool]


def _matches(
    column: Optional[str],
    feature_hint: Optional[FeatureHint],
    feature_source: Optional[FeatureSource],
    feature_type: Optional[FeatureType],
) -> Predicate:
    def pred(info: FeatureInfo) -> bool:
        return (
            (column is None or info.column == column)
            and (feature_hint is None or info.feature_hint == feature_hint)
            and (feature_source is None or info.feature_source == feature_source)
            and (feature_type is None or info.feature_type == feature_type)
        )

    return pred


class FeatureSchema(Mapping[str, FeatureInfo]):
    """Ordered mapping column-name → :class:`FeatureInfo` with selection algebra."""

    def __init__(self, features: Sequence[FeatureInfo] | FeatureInfo) -> None:
        if isinstance(features, FeatureInfo):
            features = [features]
        self._validate_naming(features)
        self._features: dict[str, FeatureInfo] = {f.column: f for f in features}

    # -- Mapping protocol -------------------------------------------------
    def __getitem__(self, column: str) -> FeatureInfo:
        return self._features[column]

    def __iter__(self) -> Iterator[str]:
        return iter(self._features)

    def __len__(self) -> int:
        return len(self._features)

    def __bool__(self) -> bool:
        return bool(self._features)

    def __add__(self, other: "FeatureSchema") -> "FeatureSchema":
        return FeatureSchema(list(self._features.values()) + list(other._features.values()))

    def item(self) -> FeatureInfo:
        """Return the single feature of a one-element schema."""
        if len(self._features) != 1:
            msg = f"Expected exactly one feature, got {len(self._features)}."
            raise ValueError(msg)
        return next(iter(self._features.values()))

    def copy(self) -> "FeatureSchema":
        """Deep-copy the schema; cardinalities are reset on the copies."""
        return FeatureSchema([f.copy() for f in self._features.values()])

    def subset(self, columns_to_keep: Iterable[str]) -> "FeatureSchema":
        """Keep only the named columns (missing names are silently skipped)."""
        keep = set(columns_to_keep)
        return FeatureSchema([f for f in self._features.values() if f.column in keep])

    def select(self, predicate: Predicate) -> "FeatureSchema":
        """Return a new schema of the features satisfying ``predicate``."""
        return FeatureSchema([f for f in self._features.values() if predicate(f)])

    def filter(
        self,
        column: Optional[str] = None,
        feature_hint: Optional[FeatureHint] = None,
        feature_source: Optional[FeatureSource] = None,
        feature_type: Optional[FeatureType] = None,
    ) -> "FeatureSchema":
        """Keep features matching every given criterion."""
        return self.select(_matches(column, feature_hint, feature_source, feature_type))

    def drop(
        self,
        column: Optional[str] = None,
        feature_hint: Optional[FeatureHint] = None,
        feature_source: Optional[FeatureSource] = None,
        feature_type: Optional[FeatureType] = None,
    ) -> "FeatureSchema":
        """Remove features matching any given criterion (per-criterion, like the reference)."""
        result = self
        if column is not None:
            result = result.select(lambda f: f.column != column)
        if feature_hint is not None:
            result = result.select(lambda f: f.feature_hint != feature_hint)
        if feature_source is not None:
            result = result.select(lambda f: f.feature_source != feature_source)
        if feature_type is not None:
            result = result.select(lambda f: f.feature_type != feature_type)
        return result

    # -- convenience views ------------------------------------------------
    @property
    def all_features(self) -> Sequence[FeatureInfo]:
        return list(self._features.values())

    @property
    def columns(self) -> Sequence[str]:
        return list(self._features)

    @property
    def categorical_features(self) -> "FeatureSchema":
        return self.select(lambda f: f.feature_type.is_categorical)

    @property
    def numerical_features(self) -> "FeatureSchema":
        return self.select(lambda f: not f.feature_type.is_categorical)

    @property
    def list_features(self) -> "FeatureSchema":
        return self.select(lambda f: f.feature_type.is_list)

    @property
    def interaction_features(self) -> "FeatureSchema":
        return self.select(
            lambda f: f.feature_source == FeatureSource.INTERACTIONS
            and f.feature_hint not in (FeatureHint.ITEM_ID, FeatureHint.QUERY_ID)
        )

    @property
    def query_features(self) -> "FeatureSchema":
        return self.filter(feature_source=FeatureSource.QUERY_FEATURES)

    @property
    def item_features(self) -> "FeatureSchema":
        return self.filter(feature_source=FeatureSource.ITEM_FEATURES)

    @property
    def interactions_rating_features(self) -> "FeatureSchema":
        return self.filter(feature_source=FeatureSource.INTERACTIONS, feature_hint=FeatureHint.RATING)

    @property
    def interactions_timestamp_features(self) -> "FeatureSchema":
        return self.filter(feature_source=FeatureSource.INTERACTIONS, feature_hint=FeatureHint.TIMESTAMP)

    @property
    def query_id_feature(self) -> FeatureInfo:
        return self.filter(feature_hint=FeatureHint.QUERY_ID).item()

    @property
    def item_id_feature(self) -> FeatureInfo:
        return self.filter(feature_hint=FeatureHint.ITEM_ID).item()

    @property
    def query_id_column(self) -> str:
        return self.query_id_feature.column

    @property
    def item_id_column(self) -> str:
        return self.item_id_feature.column

    @property
    def interactions_rating_column(self) -> Optional[str]:
        rating = self.interactions_rating_features
        return rating.item().column if rating else None

    @property
    def interactions_timestamp_column(self) -> Optional[str]:
        ts = self.interactions_timestamp_features
        return ts.item().column if ts else None

    # -- validation -------------------------------------------------------
    @staticmethod
    def _validate_naming(features: Sequence[FeatureInfo]) -> None:
        seen: set[str] = set()
        dup: set[str] = set()
        id_hints: dict[FeatureHint, list[str]] = {FeatureHint.ITEM_ID: [], FeatureHint.QUERY_ID: []}
        for f in features:
            if f.feature_hint in id_hints:
                id_hints[f.feature_hint].append(f.column)
            if f.column in seen:
                dup.add(f.column)
            else:
                seen.add(f.column)
        if dup:
            msg = f"Duplicate feature column names: {sorted(dup)}"
            raise ValueError(msg)
        for hint, cols in id_hints.items():
            if len(cols) > 1:
                msg = f"{hint.name} hint assigned to multiple columns: {cols}"
                raise ValueError(msg)


def interaction_schema(
    query_column: str = "query_id",
    item_column: str = "item_id",
    timestamp_column: str = "timestamp",
    rating_column: str = "rating",
    has_timestamp: bool = True,
    has_rating: bool = True,
) -> FeatureSchema:
    """The canonical interaction-log :class:`FeatureSchema` in one call.

    The four canonical columns as the schema every Dataset, splitter and
    tokenizer consumes.

    >>> [f.column for f in interaction_schema(has_rating=False).all_features]
    ['query_id', 'item_id', 'timestamp']
    """
    features = [
        FeatureInfo(query_column, FeatureType.CATEGORICAL, FeatureHint.QUERY_ID),
        FeatureInfo(item_column, FeatureType.CATEGORICAL, FeatureHint.ITEM_ID),
    ]
    if has_timestamp:
        features.append(
            FeatureInfo(timestamp_column, FeatureType.NUMERICAL, FeatureHint.TIMESTAMP)
        )
    if has_rating:
        features.append(
            FeatureInfo(rating_column, FeatureType.NUMERICAL, FeatureHint.RATING)
        )
    return FeatureSchema(features)
