"""Train/test splitting strategies, without pandas.

Counterpart of ``replay_tpu/splitters/strategies.py``. So far
:class:`LastNSplitter`, which notebook 09 splits with; the other strategies
(Ratio, Time, RandomNextN, Random, ColdUserRandom, NewUsers, TwoStage,
KFolds) come with ROADMAP.md queue 1, item 11.
"""

from __future__ import annotations

from typing import Literal, Optional

import numpy as np

from replay_tpu_torch.splitters.base import Splitter
from replay_tpu_torch.utils.types import ColumnTable


def _row_num(table: ColumnTable, group_col: str, ts_col: str) -> np.ndarray:
    """1-based rank of each row inside its group, ordered by timestamp
    (stable: equal timestamps keep the table's order)."""
    _, codes = np.unique(table[group_col], return_inverse=True)
    codes = codes.reshape(-1)
    by_time = np.argsort(table[ts_col], kind="stable")
    order = by_time[np.argsort(codes[by_time], kind="stable")]
    starts = np.concatenate([[0], np.cumsum(np.bincount(codes))[:-1]])
    ranks = np.empty(len(codes), dtype=np.int64)
    ranks[order] = np.arange(len(codes)) - starts[codes[order]] + 1
    return ranks


def _seconds(ts: np.ndarray) -> np.ndarray:
    """Timestamps as numbers: numeric ones as they are, ``datetime64`` and
    ISO 8601 strings as whole seconds since the epoch. Any other string
    format raises: there is no ``pd.to_datetime`` here to parse it."""
    if np.issubdtype(ts.dtype, np.number):
        return ts
    if not np.issubdtype(ts.dtype, np.datetime64):
        try:
            ts = np.asarray(ts, dtype="datetime64[s]")
        except ValueError as exc:
            msg = (
                "LastNSplitter(strategy='timedelta') takes numeric timestamps, numpy datetime64 or "
                f"ISO 8601 strings; could not parse the timestamp column: {exc}"
            )
            raise ValueError(msg) from exc
    return ts.astype("datetime64[s]").astype(np.int64)


class LastNSplitter(Splitter):
    """Last N interactions (or last N seconds of history) per group go to test."""

    _init_arg_names = [*Splitter._init_arg_names, "N", "divide_column", "strategy"]

    def __init__(
        self,
        N: int,  # noqa: N803 - the JAX package's name
        divide_column: str = "query_id",
        time_column_format: str = "%Y-%m-%d %H:%M:%S",
        strategy: Literal["interactions", "timedelta"] = "interactions",
        drop_cold_users: bool = False,
        drop_cold_items: bool = False,
        query_column: str = "query_id",
        item_column: str = "item_id",
        timestamp_column: str = "timestamp",
        session_id_column: Optional[str] = None,
        session_id_processing_strategy: str = "test",
    ) -> None:
        super().__init__(
            drop_cold_items=drop_cold_items,
            drop_cold_users=drop_cold_users,
            query_column=query_column,
            item_column=item_column,
            timestamp_column=timestamp_column,
            session_id_column=session_id_column,
            session_id_processing_strategy=session_id_processing_strategy,
        )
        if strategy not in ("interactions", "timedelta"):
            msg = "strategy must be 'interactions' or 'timedelta'"
            raise ValueError(msg)
        self.N = N
        self.divide_column = divide_column
        self.strategy = strategy
        self.time_column_format = time_column_format

    def _test_mask(self, interactions: ColumnTable) -> np.ndarray:
        _, codes = np.unique(interactions[self.divide_column], return_inverse=True)
        codes = codes.reshape(-1)
        if self.strategy == "interactions":
            row_num = _row_num(interactions, self.divide_column, self.timestamp_column)
            count = np.bincount(codes)[codes]
            return row_num > count - float(self.N)
        ts = _seconds(np.asarray(interactions[self.timestamp_column]))
        order = np.lexsort((ts, codes))
        last = np.concatenate([np.flatnonzero(np.diff(codes[order])), [len(order) - 1]]) if len(order) else order
        group_max = ts[order[last]]
        return (group_max[codes] - ts) < self.N
