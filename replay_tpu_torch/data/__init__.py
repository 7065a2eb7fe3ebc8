"""Host-side data (counterpart of ``replay_tpu/data``): the feature schema,
``Dataset`` and ``DatasetLabelEncoder`` on numpy columns, without pandas, and
the uniform batch arithmetic."""

from .batching import UniformBatching, uniform_batch_count
from .dataset import Dataset, nunique, select
from .dataset_label_encoder import DatasetLabelEncoder
from .schema import FeatureHint, FeatureInfo, FeatureSchema, FeatureSource, FeatureType, interaction_schema

__all__ = [
    "Dataset",
    "DatasetLabelEncoder",
    "FeatureHint",
    "FeatureInfo",
    "FeatureSchema",
    "FeatureSource",
    "FeatureType",
    "UniformBatching",
    "interaction_schema",
    "nunique",
    "select",
    "uniform_batch_count",
]
