"""The front end's column table, without pandas.

Counterpart of ``replay_tpu/utils/types.py``. The JAX package dispatches on a
dataframe backend (``DataFrameLike``, ``df_backend``): pandas first, polars and
Spark where installed. The card machine has none of them, so the port keeps
one table type of its own, :class:`ColumnTable` (an ordered set of named
numpy columns of one length), and one reader, :func:`as_table`, that takes a
frame by duck type (``.columns`` and ``frame[name].to_numpy()``) or a mapping
of name to values. The port never imports pandas. :func:`df_backend` names a
frame's engine from its class's module, without importing the engine.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, Iterator, List, Mapping, Union

import numpy as np


def as_column(values: Any) -> np.ndarray:
    """One column as a 1-D numpy array: a frame's column through its
    ``to_numpy()``, a list of sequences as an object array of them."""
    if hasattr(values, "to_numpy"):
        values = values.to_numpy()
    if isinstance(values, np.ndarray) and values.ndim == 1:
        return values
    rows = list(values)
    if any(isinstance(row, (list, tuple, np.ndarray)) for row in rows):
        column = np.empty(len(rows), dtype=object)
        for index, row in enumerate(rows):
            column[index] = row
        return column
    return np.asarray(rows)


class ColumnTable:
    """Named numpy columns of one length, in order: what the port's front end
    takes and returns where the JAX package uses a pandas ``DataFrame``.

    As with a frame, ``len`` counts rows, iteration yields the column names,
    ``table[name]`` is a column and ``table[[names]]`` a projection;
    :meth:`take` selects rows by a boolean mask or an index array.
    """

    def __init__(self, columns: Mapping[str, Any]) -> None:
        self._columns: Dict[str, np.ndarray] = {name: as_column(values) for name, values in columns.items()}
        lengths = {len(column) for column in self._columns.values()}
        if len(lengths) > 1:
            msg = f"columns differ in their number of rows: {sorted(lengths)}"
            raise ValueError(msg)
        self._rows = lengths.pop() if lengths else 0

    @property
    def columns(self) -> List[str]:
        return list(self._columns)

    @property
    def empty(self) -> bool:
        return self._rows == 0

    def __len__(self) -> int:
        return self._rows

    def __iter__(self) -> Iterator[str]:
        return iter(self._columns)

    def __contains__(self, name: object) -> bool:
        return name in self._columns

    def __getitem__(self, key: Union[str, Iterable[str]]) -> Union[np.ndarray, "ColumnTable"]:
        if isinstance(key, str):
            return self._columns[key]
        return ColumnTable({name: self._columns[name] for name in key})

    def take(self, rows: Any) -> "ColumnTable":
        """The rows a boolean mask marks, or those an index array names, in
        that order."""
        rows = np.asarray(rows)
        if rows.dtype == bool and len(rows) != self._rows:
            msg = f"a mask of {len(rows)} rows for a table of {self._rows}"
            raise ValueError(msg)
        return ColumnTable({name: column[rows] for name, column in self._columns.items()})

    def assign(self, **columns: Any) -> "ColumnTable":
        """A copy with ``columns`` added or replaced (the table's length)."""
        return ColumnTable({**self._columns, **columns})

    def to_numpy(self) -> Dict[str, np.ndarray]:
        """The columns as a dict of numpy arrays (e.g. to build a frame)."""
        return dict(self._columns)

    def __repr__(self) -> str:  # pragma: no cover - debug helper
        return f"ColumnTable({self._rows} rows, columns={self.columns})"


def is_frame(value: Any) -> bool:
    """A dataframe by duck type: it has ``.columns`` and is neither a mapping
    nor the port's own table."""
    return hasattr(value, "columns") and not isinstance(value, (Mapping, ColumnTable))


def as_table(data: Any) -> ColumnTable:
    """A :class:`ColumnTable` of ``data``: the table itself, a frame read by
    duck type (``frame[name].to_numpy()`` for each of ``frame.columns``), or
    a mapping of name to values."""
    if isinstance(data, ColumnTable):
        return data
    if is_frame(data):
        return ColumnTable({name: data[name].to_numpy() for name in data.columns})
    if isinstance(data, Mapping):
        return ColumnTable(data)
    msg = f"expected a frame, a ColumnTable or a mapping of columns, got {type(data).__name__}"
    raise TypeError(msg)


def df_backend(df) -> str:
    """The backend name of a dataframe: ``"pandas"``, ``"polars"`` or
    ``"spark"`` by its class's module (no engine is imported), or
    ``"column_table"`` for the port's own table."""
    if isinstance(df, ColumnTable):
        return "column_table"
    for klass in type(df).__mro__:
        root = klass.__module__.split(".")[0]
        if root == "pandas" and klass.__name__ == "DataFrame":
            return "pandas"
        if root == "polars" and klass.__name__ == "DataFrame":
            return "polars"
        if root == "pyspark" and klass.__name__ == "DataFrame":
            return "spark"
    msg = f"Unsupported dataframe type: {type(df)}"
    raise TypeError(msg)
