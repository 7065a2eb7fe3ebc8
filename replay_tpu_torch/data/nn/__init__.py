"""Host-side data for the neural stack: the tensor schema, the sequence
tokenizer, container and batcher, and the prefetch stages (counterpart of
``replay_tpu/data/nn``). Still to come (``ROADMAP.md`` queue 1, item 6):
``ParquetBatcher``, ``DataModule`` and the packed batcher."""

from .iterator import (
    DEFAULT_GROUND_TRUTH_PADDING_VALUE,
    DEFAULT_TRAIN_PADDING_VALUE,
    SequenceBatcher,
    TransformedBatches,
    validation_batches,
)
from .partitioning import Partitioning, ReplicasInfo
from .prefetch import DevicePrefetcher, prefetch
from .schema import TensorFeatureInfo, TensorFeatureSource, TensorMap, TensorSchema
from .sequence_tokenizer import SequenceTokenizer
from .sequential_dataset import SequentialDataset

__all__ = [
    "DEFAULT_GROUND_TRUTH_PADDING_VALUE",
    "DEFAULT_TRAIN_PADDING_VALUE",
    "DevicePrefetcher",
    "Partitioning",
    "ReplicasInfo",
    "SequenceBatcher",
    "SequenceTokenizer",
    "SequentialDataset",
    "TensorFeatureInfo",
    "TensorFeatureSource",
    "TensorMap",
    "TensorSchema",
    "TransformedBatches",
    "prefetch",
    "validation_batches",
]
