"""Batch computation of a metric battery + model-comparison Experiment.

Counterpart of ``replay_tpu/metrics/offline_metrics.py``: ``OfflineMetrics``
dispatches each metric to the arguments it needs (ground_truth / train /
base_recommendations, with named multi-baseline support for Unexpectedness);
``Experiment`` accumulates per-model result rows into a comparison table. The
JAX package returns pandas frames indexed by model name; the port returns a
:class:`~replay_tpu_torch.utils.types.ColumnTable` whose leading ``name``
column holds that index, with the same rows in the same order.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import numpy as np

from replay_tpu_torch.utils.types import ColumnTable

from .base import Metric, MetricsDataFrameLike
from .beyond_accuracy import CategoricalDiversity, Coverage, Novelty, Surprisal, Unexpectedness


class OfflineMetrics:
    """Compute several metrics over one set of recommendations efficiently."""

    def __init__(
        self,
        metrics: List[Metric],
        query_column: str = "query_id",
        item_column: str = "item_id",
        rating_column: str = "rating",
        category_column: str = "category_id",
    ) -> None:
        self.metrics = metrics
        self.query_column = query_column
        self.item_column = item_column
        self.rating_column = rating_column
        self.category_column = category_column

    def __call__(
        self,
        recommendations: MetricsDataFrameLike,
        ground_truth: MetricsDataFrameLike,
        train: Optional[MetricsDataFrameLike] = None,
        base_recommendations: Union[MetricsDataFrameLike, Dict[str, MetricsDataFrameLike], None] = None,
    ) -> Dict[str, float]:
        results: Dict[str, float] = {}
        named_bases: Optional[Dict[str, MetricsDataFrameLike]] = None
        if base_recommendations is not None:
            if not isinstance(base_recommendations, dict) or (
                base_recommendations and isinstance(next(iter(base_recommendations.values())), list)
            ):
                named_bases = {"base_recommendations": base_recommendations}
            else:
                named_bases = dict(base_recommendations)

        for metric in self.metrics:
            if isinstance(metric, (Novelty, Surprisal, Coverage)):
                if train is None:
                    msg = f"{metric.__name__} requires `train`."
                    raise ValueError(msg)
                results.update(metric(recommendations, train))
            elif isinstance(metric, Unexpectedness):
                if named_bases is None:
                    msg = "Unexpectedness requires `base_recommendations`."
                    raise ValueError(msg)
                for name, base in named_bases.items():
                    values = metric(recommendations, base)
                    if len(named_bases) == 1 and name == "base_recommendations":
                        results.update(values)
                    else:
                        # reference naming: "Unexpectedness_<model>@k"
                        results.update(
                            {key.replace("@", f"_{name}@", 1): value for key, value in values.items()}
                        )
            elif isinstance(metric, CategoricalDiversity):
                results.update(metric(recommendations))
            else:
                results.update(metric(recommendations, ground_truth))
        return results


class Experiment:
    """Accumulate metric rows from several models into one comparison table."""

    def __init__(
        self,
        metrics: List[Metric],
        ground_truth: MetricsDataFrameLike,
        train: Optional[MetricsDataFrameLike] = None,
        base_recommendations: Union[MetricsDataFrameLike, Dict[str, MetricsDataFrameLike], None] = None,
        query_column: str = "query_id",
        item_column: str = "item_id",
        rating_column: str = "rating",
        category_column: str = "category_id",
    ) -> None:
        self.ground_truth = ground_truth
        self.train = train
        self.base_recommendations = base_recommendations
        self._offline = OfflineMetrics(
            metrics,
            query_column=query_column,
            item_column=item_column,
            rating_column=rating_column,
            category_column=category_column,
        )
        self._rows: Dict[str, Dict[str, float]] = {}

    def add_result(self, name: str, recommendations: MetricsDataFrameLike) -> None:
        """Evaluate ``recommendations`` and store the row under ``name`` (a
        stored name's row is replaced and moves to the end)."""
        values = self._offline(
            recommendations,
            self.ground_truth,
            train=self.train,
            base_recommendations=self.base_recommendations,
        )
        self._rows.pop(name, None)
        self._rows[name] = dict(values)

    def _columns(self) -> List[str]:
        """Every metric any row holds, in order of first appearance."""
        return list(dict.fromkeys(key for row in self._rows.values() for key in row))

    @property
    def results(self) -> ColumnTable:
        """One row per model: ``name``, then each metric (NaN where a row
        lacks it)."""
        names = np.empty(len(self._rows), dtype=object)
        names[:] = list(self._rows)
        columns = {
            column: np.array([row.get(column, np.nan) for row in self._rows.values()], dtype=np.float64)
            for column in self._columns()
        }
        return ColumnTable({"name": names, **columns})

    def compare(self, baseline: str) -> ColumnTable:
        """Relative change of every row against the named baseline row."""
        if baseline not in self._rows:
            msg = f"No results stored for baseline '{baseline}'."
            raise KeyError(msg)
        table, base = self.results, self._rows[baseline]
        with np.errstate(divide="ignore", invalid="ignore"):
            changes = {
                column: (table[column] - base.get(column, np.nan)) / base.get(column, np.nan)
                for column in self._columns()
            }
        return table.assign(**changes)
