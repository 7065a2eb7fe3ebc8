"""Metric base class: input normalisation + per-user evaluation + aggregation.

Counterpart of ``replay_tpu/metrics/base.py``. A metric takes dicts
(``{query: [item, ...]}`` or ``{query: [(item, score), ...]}``), the port's
:class:`~replay_tpu_torch.utils.types.ColumnTable`, or a frame read by duck
type (:func:`~replay_tpu_torch.utils.types.as_table`: pandas, polars), warns
on duplicate (query, item) recommendation pairs, evaluates a per-user vector
over the sorted top-k list and reduces it with a
:class:`~.descriptors.CalculationDescriptor`. Results are keyed
``"<Name>@<k>"`` (the descriptor's suffix where it is not Mean).

The JAX package orders a table with pandas (``sort_values`` by rating then
item, both descending, stable; ``groupby`` of the query). Here numpy gives the
same order (:func:`ordered_groups`): each key as dense codes, descending keys
reversed and missing values last either way, one stable ``np.lexsort``; the
queries in ascending order, each one's rows in the sorted order.
"""

from __future__ import annotations

import warnings
from abc import ABC
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np

from replay_tpu_torch.utils.types import ColumnTable, as_table, is_frame

from .descriptors import CalculationDescriptor, Mean

MetricsDataFrameLike = Union[ColumnTable, dict, Any]
MetricsReturnType = Dict[str, float]


class MetricDuplicatesWarning(Warning):
    """The recommendations contain duplicate (query, item) pairs."""


def _normalize(value):
    if isinstance(value, np.generic):
        return value.item()
    return value


def null_mask(values: np.ndarray) -> np.ndarray:
    """True where a value is missing: NaN in a float column, ``None`` or a
    float NaN in an object column (what pandas counts as null)."""
    values = np.asarray(values)
    if values.dtype.kind == "f":
        return np.isnan(values)
    if values.dtype == object:
        return np.fromiter((v is None or (isinstance(v, float) and v != v) for v in values), bool, len(values))
    return np.zeros(len(values), bool)


def sort_codes(values: np.ndarray) -> Tuple[np.ndarray, int]:
    """Dense codes of ``values`` in ascending value order (missing values -1)
    and the number of distinct present values: a column's categorical
    codes, as pandas' sort takes them."""
    values = np.asarray(values)
    missing = null_mask(values)
    codes = np.full(len(values), -1, np.int64)
    present = values[~missing]
    if len(present):
        distinct, inverse = np.unique(present, return_inverse=True)
        codes[~missing] = inverse
        return codes, len(distinct)
    return codes, 0


def sorted_order(keys: List[np.ndarray], descending: bool = True) -> np.ndarray:
    """The stable row order that sorting by ``keys`` (the first the primary)
    gives in pandas (``sort_values(by=..., ascending=not descending)``):
    missing values last in each key, ties in their original order."""
    labels = []
    for key in keys:
        codes, count = sort_codes(key)
        missing = codes < 0
        codes = np.where(missing, count, codes)
        if descending:
            codes = np.where(missing, codes, count - codes - 1)
        labels.append(codes)
    if not labels or not len(labels[0]):
        return np.zeros(0, np.int64)
    return np.lexsort(labels[::-1])


def ordered_groups(queries: np.ndarray, order: Optional[np.ndarray] = None) -> List[Tuple[Any, np.ndarray]]:
    """``(query, row indices)`` per query in ascending query order, each
    query's rows in ``order`` (the table's order where None): pandas'
    ``groupby`` of the rows taken in ``order``; missing queries dropped."""
    queries = np.asarray(queries)
    order = np.arange(len(queries)) if order is None else np.asarray(order)
    codes, count = sort_codes(queries[order])
    keep = codes >= 0
    order, codes = order[keep], codes[keep]
    grouped = np.argsort(codes, kind="stable")
    rows = order[grouped]
    bounds = np.searchsorted(codes[grouped], np.arange(count + 1))
    keys = queries[rows[bounds[:-1]]].tolist()
    return [(key, rows[bounds[g]:bounds[g + 1]]) for g, key in enumerate(keys)]


class Metric(ABC):
    """Base class of offline recommendation metrics."""

    def __init__(
        self,
        topk: Union[List[int], int],
        query_column: str = "query_id",
        item_column: str = "item_id",
        rating_column: str = "rating",
        mode: CalculationDescriptor = None,
    ) -> None:
        if isinstance(topk, int):
            topk = [topk]
        if not isinstance(topk, list) or not all(isinstance(k, int) for k in topk):
            msg = "topk must be an int or a list of ints"
            raise ValueError(msg)
        self.topk = sorted(topk)
        self.query_column = query_column
        self.item_column = item_column
        self.rating_column = rating_column
        self._mode = mode if mode is not None else Mean()

    @property
    def __name__(self) -> str:
        suffix = self._mode.__name__
        return type(self).__name__ + (f"-{suffix}" if suffix != "Mean" else "")

    # -- input normalisation ----------------------------------------------
    def _to_frame(self, data):
        """A dict as it is; a table, a frame by duck type or a Spark frame
        (through ``toPandas``) as a :class:`ColumnTable`."""
        if isinstance(data, (ColumnTable, Mapping)):
            return data
        if hasattr(data, "toPandas"):  # pragma: no cover - spark
            return as_table(data.toPandas())
        if is_frame(data):
            return as_table(data)
        msg = f"Unsupported metric input type: {type(data)}"
        raise TypeError(msg)

    def _recs_to_dict(self, recommendations) -> dict:
        """Per-query item lists sorted by score descending."""
        recommendations = self._to_frame(recommendations)
        if isinstance(recommendations, Mapping):
            out = {}
            for query, items in recommendations.items():
                if items and isinstance(items[0], tuple):
                    items = [item for item, _score in sorted(items, key=lambda x: x[1], reverse=True)]
                out[query] = list(items)
            return out
        order = sorted_order([recommendations[self.rating_column], recommendations[self.item_column]])
        items = recommendations[self.item_column]
        return {
            query: items[rows].tolist()
            for query, rows in ordered_groups(recommendations[self.query_column], order)
        }

    def _gt_to_dict(self, ground_truth) -> dict:
        ground_truth = self._to_frame(ground_truth)
        if isinstance(ground_truth, Mapping):
            return {q: list(items) for q, items in ground_truth.items()}
        items = ground_truth[self.item_column]
        return {query: items[rows].tolist() for query, rows in ordered_groups(ground_truth[self.query_column])}

    def _warn_duplicates(self, recommendations: dict) -> None:
        for items in recommendations.values():
            if len(items) != len(set(items)):
                warnings.warn(
                    "The recommendations contain duplicated items per query; "
                    "metric values may be inflated.",
                    MetricDuplicatesWarning,
                    stacklevel=3,
                )
                return

    # -- evaluation --------------------------------------------------------
    def __call__(self, recommendations, ground_truth) -> MetricsReturnType:
        recs = self._recs_to_dict(recommendations)
        self._warn_duplicates(recs)
        gt = self._gt_to_dict(ground_truth)
        return self._evaluate(gt, recs)

    def _evaluate(self, keyed_by: dict, recs: dict, *extra_dicts: dict) -> MetricsReturnType:
        """Evaluate per user over ``keyed_by``'s keys and aggregate."""
        per_user: dict = {}
        for user in keyed_by:
            args = [d.get(user) for d in (keyed_by, recs, *extra_dicts)]
            per_user[user] = self._user_metric(self.topk, *args)
        if self._mode.__name__ == "PerUser":
            return {
                f"{self.__name__}@{k}": {u: vals[i] for u, vals in per_user.items()}
                for i, k in enumerate(self.topk)
            }
        distribution = np.array(list(per_user.values()), dtype=np.float64).reshape(-1, len(self.topk))
        return {
            f"{self.__name__}@{k}": _normalize(self._mode.cpu(distribution[:, i]))
            for i, k in enumerate(self.topk)
        }

    @staticmethod
    def _user_metric(ks: List[int], *args) -> List[float]:
        """Per-user metric values, one per k (loop path; vectorised metrics
        override :meth:`_evaluate` instead)."""
        raise NotImplementedError
