"""Normalized Capped Importance Sampling (NCIS) metrics.

Counterpart of ``replay_tpu/metrics/ncis.py`` (``NCISMetric``,
``NCISPrecision``), on numpy. Counterfactual evaluation
(arxiv.org/abs/1801.07030): each recommended item's reward is weighted by the
ratio of the current policy score to the logged (previous) policy score,
optionally passed through an activation, clipped to ``[1/threshold,
threshold]``, and normalised per user by the sum of weights in the top-k list.
The scored recommendations are a table (a :class:`ColumnTable` or a frame
read by duck type), ordered as :mod:`.base` orders them.
"""

from __future__ import annotations

from typing import List, Mapping, Optional, Union

import numpy as np

from .base import Metric, MetricsReturnType, ordered_groups, sorted_order
from .descriptors import CalculationDescriptor


def _softmax_per_user(scores: np.ndarray) -> np.ndarray:
    """Shift-invariant softmax over one user's score vector."""
    shifted = np.exp(scores - scores.max())
    return shifted / shifted.sum()


class NCISMetric(Metric):
    """Base for NCIS-weighted metrics.

    Subclasses implement :meth:`_user_ncis_metric` over the per-user top-k
    hit mask and weight vector.

    :param prev_policy_weights: logged policy scores — a table with
        ``[query_column, item_column, rating_column]``; pairs recommended now
        but absent from the log get weight ``threshold`` (maximum surprise).
    :param threshold: weights are clipped into ``[1/threshold, threshold]``.
    :param activation: ``None``, ``"sigmoid"``/``"logit"``, or ``"softmax"``
        applied per user to both score vectors before the ratio.
    """

    def __init__(
        self,
        topk: Union[List[int], int],
        prev_policy_weights,
        threshold: float = 10.0,
        activation: Optional[str] = None,
        query_column: str = "query_id",
        item_column: str = "item_id",
        rating_column: str = "rating",
        mode: CalculationDescriptor = None,
    ) -> None:
        super().__init__(
            topk,
            query_column=query_column,
            item_column=item_column,
            rating_column=rating_column,
            mode=mode,
        )
        if threshold <= 0:
            msg = "threshold must be a positive real number"
            raise ValueError(msg)
        if activation not in (None, "logit", "sigmoid", "softmax"):
            msg = f"Unexpected activation - {activation}"
            raise ValueError(msg)
        self.threshold = float(threshold)
        self.activation = activation
        prev = self._to_frame(prev_policy_weights)
        if isinstance(prev, Mapping):
            msg = "NCIS metrics need the logged policy scores as a DataFrame"
            raise TypeError(msg)
        self._prev_scores = {
            (q, i): float(r) for q, i, r in zip(prev[query_column], prev[item_column], prev[rating_column])
        }

    def _activate(self, scores: np.ndarray) -> np.ndarray:
        if self.activation == "softmax":
            return _softmax_per_user(scores)
        if self.activation in ("logit", "sigmoid"):
            return 1.0 / (1.0 + np.exp(-scores))
        return scores

    def _weights_for(self, query, items: np.ndarray, cur_scores: np.ndarray) -> np.ndarray:
        """Clipped per-item NCIS weights for one user's ordered rec list."""
        prev = np.array(
            [self._prev_scores.get((query, item), np.nan) for item in items], dtype=np.float64
        )
        missing = np.isnan(prev)
        cur = self._activate(cur_scores.astype(np.float64))
        if self.activation == "softmax":
            # normalize over the LOGGED entries only — filling missing pairs
            # with logit 0 would deflate every real propensity by the number
            # of unlogged items in the list
            activated = np.zeros_like(prev)
            known = ~missing
            if known.any():
                activated[known] = _softmax_per_user(prev[known])
            prev = activated
        elif self.activation is not None:
            prev = self._activate(np.where(missing, 0.0, prev))
        # zero (or missing) logged propensity -> maximum-surprise weight
        degenerate = missing | (prev == 0.0)
        upper, lower = self.threshold, 1.0 / self.threshold
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(degenerate, upper, cur / np.where(degenerate, 1.0, prev))
        return np.clip(ratio, lower, upper)

    def __call__(self, recommendations, ground_truth) -> MetricsReturnType:
        recs = self._to_frame(recommendations)
        if isinstance(recs, Mapping):
            msg = "NCIS metrics need scored recommendations as a DataFrame"
            raise TypeError(msg)
        items_column, scores_column = recs[self.item_column], recs[self.rating_column]
        order = sorted_order([scores_column, items_column])
        groups = ordered_groups(recs[self.query_column], order)
        rec_items = {query: items_column[rows] for query, rows in groups}
        rec_scores = {query: scores_column[rows] for query, rows in groups}
        gt = self._gt_to_dict(ground_truth)
        per_user = {}
        for user in gt:
            items = rec_items.get(user)
            if items is None or len(items) == 0 or len(gt[user]) == 0:
                per_user[user] = [0.0] * len(self.topk)
                continue
            weights = self._weights_for(user, items, rec_scores[user])
            hits = np.isin(items, np.asarray(list(gt[user]))).astype(np.float64)
            per_user[user] = [
                self._user_ncis_metric(hits[:k], weights[:k]) for k in self.topk
            ]
        if self._mode.__name__ == "PerUser":
            return {
                f"{self.__name__}@{k}": {u: vals[i] for u, vals in per_user.items()}
                for i, k in enumerate(self.topk)
            }
        distribution = np.array(list(per_user.values()), dtype=np.float64).reshape(
            -1, len(self.topk)
        )
        return {
            f"{self.__name__}@{k}": float(self._mode.cpu(distribution[:, i]))
            for i, k in enumerate(self.topk)
        }

    @staticmethod
    def _user_ncis_metric(hits: np.ndarray, weights: np.ndarray) -> float:
        raise NotImplementedError


class NCISPrecision(NCISMetric):
    """Share of relevant items among top-k, NCIS-weighted:
    ``sum(w * hit) / sum(w)`` over the truncated list."""

    @staticmethod
    def _user_ncis_metric(hits: np.ndarray, weights: np.ndarray) -> float:
        denom = weights.sum()
        if denom == 0.0:
            return 0.0
        return float((weights * hits).sum() / denom)
