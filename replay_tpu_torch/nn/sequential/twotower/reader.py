"""Catalog feature tensors for the item tower.

Counterpart of ``replay_tpu/nn/sequential/twotower/reader.py::FeaturesReader``:
item-feature columns whose item-id column holds encoded ids in
``[0, num_items)`` → ``{feature_name: np.ndarray[num_items, ...]}`` ordered by
item id, aligned with the shared embedding table, with the same validation.

The source is a mapping of column name to a numpy array (or anything numpy
takes). A pandas frame works too, read through its ``columns`` and
``to_numpy()`` without importing pandas; a parquet path is read with pandas,
imported only when such a path is given (a machine without pandas reads
mappings and frames alike).
"""

from __future__ import annotations

import importlib
from typing import Any, Dict, Mapping, Optional

import numpy as np

from replay_tpu_torch.data.nn.schema import TensorSchema


def _columns(source: Any) -> Dict[str, np.ndarray]:
    """Column name → numpy array, from a mapping, a data frame or a parquet path."""
    if isinstance(source, str):
        source = importlib.import_module("pandas").read_parquet(source)
    if isinstance(source, Mapping):
        return {name: np.asarray(values) for name, values in source.items()}
    return {name: source[name].to_numpy() for name in source.columns}


class FeaturesReader:
    """Materialize item-tower feature tensors ordered by encoded item id."""

    def __init__(self, item_schema: TensorSchema, item_id_column: str = "item_id", num_items: Optional[int] = None) -> None:
        self.item_schema = item_schema
        self.item_id_column = item_id_column
        self.num_items = num_items

    def read(self, source) -> Dict[str, np.ndarray]:
        columns = _columns(source)
        if self.item_id_column not in columns:
            msg = f"Item id column '{self.item_id_column}' not found."
            raise ValueError(msg)
        ids = columns[self.item_id_column]
        num_items = self.num_items or int(ids.max()) + 1
        if (ids < 0).any() or (ids >= num_items).any():
            msg = "Item ids must be encoded into [0, num_items) before reading."
            raise ValueError(msg)
        order = np.argsort(ids)
        if len(np.unique(ids)) != len(ids):
            msg = "Duplicate item ids in the features frame."
            raise ValueError(msg)
        tensors: Dict[str, np.ndarray] = {}
        for feature in self.item_schema.all_features:
            source_column = feature.feature_source.column if feature.feature_source else feature.name
            if source_column not in columns:
                msg = f"Feature column '{source_column}' not found in item features."
                raise ValueError(msg)
            values = np.asarray(columns[source_column])[order]
            dtype = np.int32 if feature.is_cat else np.float32
            dense = np.zeros((num_items,) + values.shape[1:], dtype=dtype)
            # rows may be a subset: missing items keep zeros (cold-item default)
            dense[ids[order]] = values.astype(dtype)
            tensors[feature.name] = dense
        return tensors
