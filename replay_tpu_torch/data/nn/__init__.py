"""Host-side data for the neural stack (counterpart of ``replay_tpu/data/nn``):
the tensor schema and its builder, the sequence tokenizer, container and
batchers (in-memory, packed, parquet stream with its resumable cursor), the
per-split ``DataModule`` and the prefetch stages. ``ensure_pandas`` and
``groupby_sequences`` stay in the JAX package: they are pandas."""

from .iterator import (
    DEFAULT_GROUND_TRUTH_PADDING_VALUE,
    DEFAULT_TRAIN_PADDING_VALUE,
    SequenceBatcher,
    TransformedBatches,
    validation_batches,
)
from .module import DataModule
from .packing import PackedSequenceBatcher, first_fit_pack
from .parquet import ParquetBatcher, StreamCursor, write_sequence_parquet
from .partitioning import Partitioning, ReplicasInfo
from .prefetch import DevicePrefetcher, prefetch
from .schema import TensorFeatureInfo, TensorFeatureSource, TensorMap, TensorSchema
from .schema_builder import TensorSchemaBuilder
from .sequence_tokenizer import SequenceTokenizer
from .sequential_dataset import SequentialDataset

__all__ = [
    "DEFAULT_GROUND_TRUTH_PADDING_VALUE",
    "DEFAULT_TRAIN_PADDING_VALUE",
    "DataModule",
    "DevicePrefetcher",
    "PackedSequenceBatcher",
    "ParquetBatcher",
    "Partitioning",
    "ReplicasInfo",
    "SequenceBatcher",
    "SequenceTokenizer",
    "SequentialDataset",
    "StreamCursor",
    "TensorFeatureInfo",
    "TensorFeatureSource",
    "TensorMap",
    "TensorSchema",
    "TensorSchemaBuilder",
    "TransformedBatches",
    "first_fit_pack",
    "prefetch",
    "validation_batches",
    "write_sequence_parquet",
]
