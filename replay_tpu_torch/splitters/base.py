"""Splitter base class: cold-entity dropping and session-boundary handling,
without pandas.

Counterpart of ``replay_tpu/splitters/base.py``: ``split()`` → (train, test),
optional dropping of cold users and items from test, optional session
integrity (a session crossing the split boundary moves wholly to train or to
test), and ``save``/``load`` of the init arguments into a ``.replay``
directory. A strategy marks the test rows with a boolean mask over the
interactions, and the base class builds the two tables. Interactions come in
as a frame (by duck type), a ``ColumnTable`` or a mapping of numpy columns;
both splits go out as ``ColumnTable`` s, rows in the input's order.
"""

from __future__ import annotations

import inspect
import json
from abc import ABC, abstractmethod
from pathlib import Path
from typing import Any, Optional

import numpy as np

from replay_tpu_torch.utils.types import ColumnTable, as_table

SplitterReturnType = tuple[ColumnTable, ColumnTable]


def group_codes(*columns: np.ndarray) -> np.ndarray:
    """One int64 code per row, equal for rows equal in every column (the
    groups of ``groupby(columns)``), numbered in sorted key order."""
    codes = np.zeros(len(columns[0]), dtype=np.int64)
    for column in columns:
        _, inverse = np.unique(np.asarray(column), return_inverse=True)
        _, codes = np.unique(np.stack([codes, inverse.reshape(-1)], 1), axis=0, return_inverse=True)
        codes = codes.reshape(-1)
    return codes


class Splitter(ABC):
    """Base class of train/test splitting strategies."""

    _init_arg_names: list[str] = [
        "drop_cold_users",
        "drop_cold_items",
        "query_column",
        "item_column",
        "timestamp_column",
        "session_id_column",
        "session_id_processing_strategy",
    ]

    def __init__(
        self,
        drop_cold_items: bool = False,
        drop_cold_users: bool = False,
        query_column: str = "query_id",
        item_column: Optional[str] = "item_id",
        timestamp_column: Optional[str] = "timestamp",
        session_id_column: Optional[str] = None,
        session_id_processing_strategy: str = "test",
    ) -> None:
        if session_id_processing_strategy not in ("train", "test"):
            msg = "session_id_processing_strategy must be 'train' or 'test'"
            raise ValueError(msg)
        self.drop_cold_items = drop_cold_items
        self.drop_cold_users = drop_cold_users
        self.query_column = query_column
        self.item_column = item_column
        self.timestamp_column = timestamp_column
        self.session_id_column = session_id_column
        self.session_id_processing_strategy = session_id_processing_strategy

    # -- public API -------------------------------------------------------
    def split(self, interactions: Any) -> SplitterReturnType:
        """Split interactions into (train, test)."""
        table = as_table(interactions)
        test_mask = np.asarray(self._test_mask(table), dtype=bool)
        if self.session_id_column is not None:
            test_mask = self._recover_sessions(table, test_mask)
        return self._drop_cold(table.take(~test_mask), table.take(test_mask))

    @abstractmethod
    def _test_mask(self, interactions: ColumnTable) -> np.ndarray:
        """Return a boolean mask marking the test rows."""

    # -- shared mechanics -------------------------------------------------
    def _recover_sessions(self, interactions: ColumnTable, test_mask: np.ndarray) -> np.ndarray:
        """Move sessions straddling the boundary wholly to train or test."""
        codes = group_codes(interactions[self.query_column], interactions[self.session_id_column])
        tested = np.bincount(codes, weights=test_mask.astype(np.float64))
        sizes = np.bincount(codes)
        straddling = ((tested > 0) & (tested < sizes))[codes]
        mask = test_mask.copy()
        mask[straddling] = self.session_id_processing_strategy == "test"
        return mask

    def _drop_cold(self, train: ColumnTable, test: ColumnTable) -> SplitterReturnType:
        if self.drop_cold_users:
            test = test.take(np.isin(test[self.query_column], train[self.query_column]))
        if self.drop_cold_items and self.item_column is not None:
            test = test.take(np.isin(test[self.item_column], train[self.item_column]))
        return train, test

    # -- persistence ------------------------------------------------------
    @property
    def _init_args(self) -> dict:
        return {name: getattr(self, name) for name in self._init_arg_names}

    def save(self, path: str) -> None:
        base = Path(path).with_suffix(".replay").resolve()
        base.mkdir(parents=True, exist_ok=True)
        payload = {"_class_name": str(self), "init_args": self._init_args}
        (base / "init_args.json").write_text(json.dumps(payload, default=str))

    @classmethod
    def load(cls, path: str, **kwargs) -> "Splitter":
        base = Path(path).with_suffix(".replay").resolve()
        payload = json.loads((base / "init_args.json").read_text())
        accepted = set(inspect.signature(cls.__init__).parameters)
        args = {k: v for k, v in payload["init_args"].items() if k in accepted}
        return cls(**{**args, **kwargs})

    def __str__(self) -> str:
        return type(self).__name__
