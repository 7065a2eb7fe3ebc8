"""Beyond-accuracy metrics: Coverage, Novelty, Surprisal, Unexpectedness, CategoricalDiversity.

Counterpart of ``replay_tpu/metrics/beyond_accuracy.py``, the same math on the
dict representation. The per-list math lives in the pure functions
:func:`novelty_of_slate`, :func:`surprisal_weights` / :func:`surprisal_of_slate`
and :func:`coverage_of`, so that one served slate can be scored with exactly
the offline formulas; the classes are thin wrappers over them.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Sequence

import numpy as np

from .base import Metric, MetricsReturnType, _normalize


def novelty_of_slate(slate: Sequence, seen: Iterable, k: int) -> float:
    """Fraction of ``slate[:k]`` the user has NOT interacted with (``seen``).

    An empty slate head is maximally novel (1.0) — the reference's empty-train/
    empty-pred convention (replay/metrics/novelty.py).
    """
    head = list(slate[:k])
    if not head:
        return 1.0
    return 1.0 - len(set(head) & set(seen)) / len(head)


def surprisal_weights(train_dict: Mapping) -> Dict:
    """Per-item normalized self-information from a ``{user: [item, ...]}`` log.

    weight(item) = log2(n_users / n_consumers(item)) / log2(n_users); with a
    single (or zero) user the normalizer is 1.0 (reference:
    replay/metrics/surprisal.py:84-100). Items absent from the log weigh 1.0
    at lookup time (:func:`surprisal_of_slate`).
    """
    n_users = len(train_dict)
    consumers: dict = {}
    for user, items in train_dict.items():
        for item in items:
            consumers.setdefault(item, set()).add(user)
    log_n = np.log2(n_users) if n_users > 1 else 1.0
    return {item: np.log2(n_users / len(users)) / log_n for item, users in consumers.items()}


def weighted_surprisal(pred_weights: Sequence[float], k: int) -> float:
    """Mean of the first-k per-item information weights, divided by k."""
    return sum(pred_weights[:k]) / k


def surprisal_of_slate(slate: Sequence, weights: Mapping, k: int) -> float:
    """Surprisal of one slate against precomputed :func:`surprisal_weights`
    (unseen items weigh 1.0; an empty slate scores 0.0)."""
    if not slate:
        return 0.0
    return weighted_surprisal([weights.get(item, 1.0) for item in slate], k)


def coverage_of(recommended: Iterable, train_items: Iterable) -> float:
    """Fraction of the train catalog present in ``recommended`` (0.0 for an
    empty catalog — the online monitor's safe degenerate)."""
    catalog = set(train_items)
    if not catalog:
        return 0.0
    return len(set(recommended) & catalog) / len(catalog)


class Novelty(Metric):
    """Fraction of the top-k recommendations the user has NOT interacted with in train."""

    def __call__(self, recommendations, train) -> MetricsReturnType:
        recs = self._recs_to_dict(recommendations)
        self._warn_duplicates(recs)
        train_dict = self._gt_to_dict(train)
        return self._evaluate(recs, train_dict)

    @staticmethod
    def _user_metric(ks: List[int], pred, train) -> List[float]:
        if not train or not pred:
            return [1.0] * len(ks)
        seen = set(train)
        return [novelty_of_slate(pred, seen, k) for k in ks]


class Surprisal(Metric):
    """Mean self-information of the top-k items, normalized to [0, 1].

    weight(item) = log2(n_users / n_users_who_consumed_item) / log2(n_users); unseen
    items get weight 1 (reference: replay/metrics/surprisal.py:84-100).
    """

    def __call__(self, recommendations, train) -> MetricsReturnType:
        recs = self._recs_to_dict(recommendations)
        self._warn_duplicates(recs)
        train_dict = self._gt_to_dict(train)
        weights = surprisal_weights(train_dict)
        rec_weights = {user: [weights.get(i, 1.0) for i in items] for user, items in recs.items()}
        return self._evaluate(recs, rec_weights)

    @staticmethod
    def _user_metric(ks: List[int], pred, pred_weights) -> List[float]:
        if not pred:
            return [0.0] * len(ks)
        return [weighted_surprisal(pred_weights, k) for k in ks]


class Coverage(Metric):
    """Fraction of the train catalog that appears in anyone's top-k recommendations.

    >>> recs = {1: [10, 11], 2: [10, 12]}
    >>> train = {1: [10, 11, 13], 2: [12, 14]}     # 5-item catalog
    >>> Coverage(2)(recs, train)
    {'Coverage@2': 0.6}
    """

    def __init__(
        self,
        topk,
        query_column: str = "query_id",
        item_column: str = "item_id",
        rating_column: str = "rating",
        allow_caching: bool = True,
    ) -> None:
        super().__init__(topk=topk, query_column=query_column, item_column=item_column, rating_column=rating_column)
        self._allow_caching = allow_caching

    def __call__(self, recommendations, train) -> MetricsReturnType:
        recs = self._recs_to_dict(recommendations)
        train_dict = self._gt_to_dict(train)
        train_items = set()
        for items in train_dict.values():
            train_items.update(items)
        out = {}
        for k in self.topk:
            recommended = set()
            for items in recs.values():
                recommended.update(items[:k])
            out[f"{self.__name__}@{k}"] = _normalize(coverage_of(recommended, train_items))
        return out

    @staticmethod
    def _user_metric(ks: List[int], *args) -> List[float]:  # pragma: no cover - global metric
        raise NotImplementedError


class Unexpectedness(Metric):
    """Fraction of the top-k that a base recommender would NOT have recommended."""

    def __call__(self, recommendations, base_recommendations) -> MetricsReturnType:
        recs = self._recs_to_dict(recommendations)
        self._warn_duplicates(recs)
        base = self._recs_to_dict(base_recommendations)
        return self._evaluate(recs, base)

    @staticmethod
    def _user_metric(ks: List[int], recs, base_recs) -> List[float]:
        if not base_recs or not recs:
            return [0.0] * len(ks)
        return [1.0 - len(set(recs[:k]) & set(base_recs[:k])) / k for k in ks]


class CategoricalDiversity(Metric):
    """Number of distinct categories among the top-k recommendations, divided by k."""

    def __init__(
        self,
        topk,
        query_column: str = "query_id",
        category_column: str = "category_id",
        rating_column: str = "rating",
        mode=None,
    ) -> None:
        super().__init__(
            topk=topk,
            query_column=query_column,
            item_column=category_column,
            rating_column=rating_column,
            mode=mode,
        )
        self.category_column = category_column

    def __call__(self, recommendations) -> MetricsReturnType:
        recs = self._recs_to_dict(recommendations)
        return self._evaluate(recs, recs)

    @staticmethod
    def _user_metric(ks: List[int], categories, _same) -> List[float]:
        if not categories:
            return [0.0] * len(ks)
        return [len(set(categories[:k])) / k for k in ks]
