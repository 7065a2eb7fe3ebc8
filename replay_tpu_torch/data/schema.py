"""Feature enums of the dataset schema.

Counterpart of ``replay_tpu/data/schema.py``: the three enums a tensor schema
refers to (``FeatureType``, ``FeatureSource``, ``FeatureHint``), copied so the
port imports nothing of the JAX package. The dataframe-level ``FeatureInfo`` /
``FeatureSchema`` come with the data-pipeline slice.
"""

from __future__ import annotations

from enum import Enum


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
