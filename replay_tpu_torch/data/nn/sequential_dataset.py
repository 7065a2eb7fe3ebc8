"""Per-query sequence container, without pandas.

Counterpart of ``replay_tpu/data/nn/sequential_dataset.py``: one row per
query with array-valued feature columns (a sequence tokenizer's output),
lookup by position or query id, query filtering and the alignment of two
splits to their common queries. The JAX class holds a pandas ``DataFrame``;
the card machine has no pandas, so the port holds one numpy array per column:
an object array of per-row arrays for a sequence column, a plain array for a
scalar one (the query ids). It takes the columns as a mapping of name to
per-row values (lists or numpy arrays), or a ``DataFrame`` by duck type
(``.columns`` and ``[name].to_numpy()``), never importing pandas.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from replay_tpu_torch.data.nn.schema import TensorSchema


def _column(values: Any) -> np.ndarray:
    """A column's rows as one array: an object array of per-row arrays when
    the rows are sequences, the values themselves when they are scalars."""
    if hasattr(values, "to_numpy"):
        values = values.to_numpy()
    if isinstance(values, np.ndarray) and values.dtype != object:
        if values.ndim == 1:
            return values
        rows = list(values)  # a 2-D array: one sequence per row
    else:
        rows = list(values)
    if not any(isinstance(row, (list, tuple, np.ndarray)) for row in rows):
        return np.asarray(rows)
    column = np.empty(len(rows), dtype=object)
    for index, row in enumerate(rows):
        column[index] = np.asarray(row)
    return column


class SequentialDataset:
    """Sequences of every tensor-schema feature, one row per query."""

    def __init__(
        self,
        tensor_schema: TensorSchema,
        query_id_column: str,
        item_id_column: str,
        sequences: Any,
    ) -> None:
        names = list(sequences.columns) if hasattr(sequences, "columns") else list(sequences)
        if query_id_column not in names:
            msg = f"Query id column '{query_id_column}' missing from sequences."
            raise ValueError(msg)
        for name in tensor_schema:
            if name not in names:
                msg = f"Tensor feature '{name}' missing from sequences."
                raise ValueError(msg)
        self._schema = tensor_schema
        self._query_id_column = query_id_column
        self._item_id_column = item_id_column
        self._columns: Dict[str, np.ndarray] = {name: _column(sequences[name]) for name in names}
        lengths = {len(column) for column in self._columns.values()}
        if len(lengths) > 1:
            msg = f"columns differ in their number of rows: {sorted(lengths)}"
            raise ValueError(msg)
        self._query_index = {query_id: position for position, query_id in enumerate(self.query_ids.tolist())}

    schema = property(lambda self: self._schema)
    query_id_column = property(lambda self: self._query_id_column)
    item_id_column = property(lambda self: self._item_id_column)

    def __len__(self) -> int:
        return len(self._columns[self._query_id_column])

    @property
    def query_ids(self) -> np.ndarray:
        return self._columns[self._query_id_column]

    def get_all_query_ids(self) -> np.ndarray:
        return self.query_ids

    def get_query_id(self, index: int):
        return self._columns[self._query_id_column][index]

    def get_sequence(self, index: int, feature_name: str) -> np.ndarray:
        return np.asarray(self._columns[feature_name][index])

    def get_sequence_by_query_id(self, query_id, feature_name: str) -> np.ndarray:
        return np.asarray(self._columns[feature_name][self._query_index[query_id]])

    def get_sequence_length(self, index: int) -> int:
        return len(self.get_sequence(index, self._item_id_column))

    def get_max_sequence_length(self) -> int:
        if not len(self):
            return 0
        return max(len(row) for row in self._columns[self._item_id_column])

    def filter_by_query_id(self, query_ids) -> "SequentialDataset":
        """The rows whose query id is in ``query_ids``, in this dataset's order."""
        keep = np.isin(self.query_ids, np.asarray(query_ids))
        return SequentialDataset(
            self._schema, self._query_id_column, self._item_id_column,
            {name: column[keep] for name, column in self._columns.items()},
        )

    @staticmethod
    def keep_common_query_ids(
        left: "SequentialDataset", right: "SequentialDataset"
    ) -> Tuple["SequentialDataset", "SequentialDataset"]:
        """Align two splits (train histories and validation targets) to the
        queries present in both."""
        common = np.intersect1d(left.query_ids, right.query_ids)
        return left.filter_by_query_id(common), right.filter_by_query_id(common)

    def save(self, path: str) -> None:
        """Not ported: the JAX package writes parquet through pandas."""
        msg = (
            "SequentialDataset.save is not ported yet: ROADMAP.md queue 1, item 11, "
            "'Classical and experimental models' (parquet through pandas, which the card machine lacks)"
        )
        raise NotImplementedError(msg)

    @classmethod
    def load(cls, path: str) -> "SequentialDataset":
        """Not ported: the JAX package reads parquet through pandas."""
        msg = (
            "SequentialDataset.load is not ported yet: ROADMAP.md queue 1, item 11, "
            "'Classical and experimental models' (parquet through pandas, which the card machine lacks)"
        )
        raise NotImplementedError(msg)

