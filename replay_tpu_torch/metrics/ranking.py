"""Ranking accuracy metrics, vectorised over users.

Counterpart of ``replay_tpu/metrics/ranking.py``: HitRate, Precision, Recall,
MAP, MRR, NDCG, RocAuc, each derived from two ``[users, max_k]`` hit
matrices. The JAX package builds them with pandas (explode, merge); here they
come from numpy (:func:`_hit_matrix`) with the same semantics:

- ``hits_occ`` marks every occurrence of a relevant item in the top-k list
  (NDCG / MAP / RocAuc score each one), ``hits_first`` only its first
  (Precision / Recall / HitRate count distinct relevant items);
- a missing item (``None`` or NaN) keeps its rank, and matches a missing
  ground-truth item as pandas' merge matches null keys;
- an empty list adds no row; ``gt_set`` is the distinct ground-truth count
  (Recall's denominator), ``gt_raw`` the raw count (NDCG's IDCG and MAP's
  normaliser take ``min(k, gt_raw)``).

On duplicate-free inputs (what every top-k producer of the package gives) the
two matrices coincide.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from .base import Metric, MetricsReturnType, null_mask


class _HitData(NamedTuple):
    """Per-user hit matrices and list-length vectors (all truncated to max_k)."""

    hits_occ: np.ndarray  # [U, max_k] bool: pred[i] in gt_set (every occurrence)
    hits_first: np.ndarray  # [U, max_k] bool: hit AND first occurrence of the item
    gt_set: np.ndarray  # [U] distinct ground-truth items
    gt_raw: np.ndarray  # [U] raw ground-truth list length (reference NDCG/MAP denominators)
    pred_len: np.ndarray  # [U] raw recommendation length, capped at max_k


class RankingMetric(Metric):
    """Shared vectorized evaluation: subclasses map the hit matrices to values."""

    def _evaluate(self, ground_truth: dict, recs: dict, *extra) -> MetricsReturnType:
        users = list(ground_truth.keys())
        max_k = max(self.topk)
        data = _hit_matrix(users, ground_truth, recs, max_k)
        per_k = {k: self._from_hits(k, _truncate(data, k)) for k in self.topk}
        if self._mode.__name__ == "PerUser":
            return {
                f"{self.__name__}@{k}": dict(zip(users, per_k[k])) for k in self.topk
            }
        return {
            f"{self.__name__}@{k}": float(self._mode.cpu(per_k[k])) for k in self.topk
        }

    def _from_hits(self, k: int, data: _HitData) -> np.ndarray:
        """[U] metric values from the hit matrices restricted to top-k."""
        raise NotImplementedError


def _truncate(data: _HitData, k: int) -> _HitData:
    return _HitData(
        hits_occ=data.hits_occ[:, :k],
        hits_first=data.hits_first[:, :k],
        gt_set=data.gt_set,
        gt_raw=data.gt_raw,
        pred_len=np.minimum(data.pred_len, k),
    )


def _flat(lists) -> np.ndarray:
    """The lists' items in order as one array: numeric where they all are,
    else an object array (no value is converted to another type)."""
    values = [item for items in lists for item in items]
    flat = np.asarray(values)
    if flat.dtype.kind not in "iufb" or flat.ndim != 1:
        flat = np.empty(len(values), dtype=object)
        flat[:] = values
    return flat


def _match_codes(values: np.ndarray) -> np.ndarray:
    """Codes under which equal items are equal, and every missing item shares
    the code -1: the keys pandas' merge joins on."""
    missing = null_mask(values)
    codes = np.full(len(values), -1, np.int64)
    present = values[~missing]
    if values.dtype == object:
        index: dict = {}
        codes[~missing] = [index.setdefault(item, len(index)) for item in present.tolist()]
    elif len(present):
        codes[~missing] = np.unique(present, return_inverse=True)[1]
    return codes


def _hit_matrix(users, ground_truth: dict, recs: dict, max_k: int) -> _HitData:
    """Both hit matrices from flat (user, rank, item) arrays, no per-user loop
    over the matching: an item hits where its (user, item) key is among the
    user's ground-truth keys, and counts first where that key first appears
    in the user's list."""
    n = len(users)
    hits_occ = np.zeros((n, max_k), dtype=bool)
    hits_first = np.zeros((n, max_k), dtype=bool)
    rec_lists = [list(recs.get(u) or [])[:max_k] for u in users]
    gt_lists = [list(ground_truth.get(u) or []) for u in users]
    gt_raw = np.array([len(items) for items in gt_lists], dtype=np.int64)
    gt_set = np.array([len(set(items)) for items in gt_lists], dtype=np.int64)
    pred_len = np.array([len(items) for items in rec_lists], dtype=np.int64)
    total = int(pred_len.sum())
    if not total:
        return _HitData(hits_occ, hits_first, gt_set, gt_raw, pred_len)
    rec_rows = np.repeat(np.arange(n), pred_len)
    ranks = np.arange(total) - np.repeat(np.cumsum(pred_len) - pred_len, pred_len)
    gt_rows = np.repeat(np.arange(n), gt_raw)
    codes = _match_codes(_flat(rec_lists + gt_lists))
    width = int(codes.max()) + 2  # the missing items' -1 becomes 0
    rec_keys = rec_rows * width + codes[:total] + 1
    gt_keys = gt_rows * width + codes[total:] + 1
    hit = np.isin(rec_keys, gt_keys)
    first_occ = np.zeros(total, dtype=bool)
    first_occ[np.unique(rec_keys, return_index=True)[1]] = True
    hits_occ[rec_rows[hit], ranks[hit]] = True
    first_hit = hit & first_occ
    hits_first[rec_rows[first_hit], ranks[first_hit]] = True
    return _HitData(hits_occ, hits_first, gt_set, gt_raw, pred_len)


def _safe_div(numerator: np.ndarray, denominator: np.ndarray) -> np.ndarray:
    return np.where(denominator > 0, numerator / np.maximum(denominator, 1), 0.0)


class HitRate(RankingMetric):
    """1 if any of the top-k recommendations is relevant.

    >>> HitRate(2)({1: [10, 11], 2: [12, 13]}, {1: [11], 2: [99]})
    {'HitRate@2': 0.5}
    """

    def _from_hits(self, k, data):
        return data.hits_occ.any(axis=1).astype(np.float64)


class Precision(RankingMetric):
    """Fraction of the top-k recommendations that are relevant.

    Distinct relevant items in the window over k — ``len(set(pred[:k]) & gt) / k``
    as in the reference (replay/metrics/precision.py:62-69).
    """

    def _from_hits(self, k, data):
        present = (data.gt_set > 0) & (data.pred_len > 0)
        return np.where(present, data.hits_first.sum(axis=1) / k, 0.0)


class Recall(RankingMetric):
    """Fraction of the relevant items captured in the top-k recommendations.

    >>> Recall(2)({1: [10, 11]}, {1: [11, 40]})
    {'Recall@2': 0.5}
    """

    def _from_hits(self, k, data):
        return _safe_div(data.hits_first.sum(axis=1), data.gt_set)


class MAP(RankingMetric):
    """Mean average precision at k.

    Occurrence semantics: the true-positive counter advances at EVERY position
    whose item is relevant, and the normalizer is ``min(k, len(ground_truth))``
    over the raw list (replay/metrics/map.py:64-78).
    """

    def _from_hits(self, k, data):
        h = data.hits_occ.astype(np.float64)
        precision_at_rank = np.cumsum(h, axis=1) / (np.arange(k) + 1.0)[None, :]
        ap = (h * precision_at_rank).sum(axis=1)
        return _safe_div(ap, np.minimum(data.gt_raw, k))


class MRR(RankingMetric):
    """Reciprocal rank of the first relevant recommendation.

    >>> MRR(3)({1: [10, 11, 12]}, {1: [11]})
    {'MRR@3': 0.5}
    """

    def _from_hits(self, k, data):
        first = data.hits_occ.argmax(axis=1)
        return np.where(data.hits_occ.any(axis=1), 1.0 / (first + 1.0), 0.0)


class NDCG(RankingMetric):
    """Normalized discounted cumulative gain at k.

    DCG sums the discount at every relevant position (occurrences included);
    IDCG truncates the RAW ground-truth length at k (replay/metrics/ndcg.py:82-93).

    >>> recs = {1: [10, 11, 12]}          # ranked recommendations per query
    >>> ground_truth = {1: [11, 40]}      # relevant items per query
    >>> round(NDCG(2)(recs, ground_truth)["NDCG@2"], 4)
    0.3869
    """

    def _from_hits(self, k, data):
        discounts = 1.0 / np.log2(np.arange(k) + 2.0)
        dcg = (data.hits_occ * discounts[None, :]).sum(axis=1)
        ideal_table = np.concatenate([[0.0], np.cumsum(discounts)])
        idcg = ideal_table[np.clip(data.gt_raw, 0, k)]
        return _safe_div(dcg, idcg)


class RocAuc(RankingMetric):
    """AUC of relevant-vs-irrelevant ordering within the top-k list.

    Concordance formulation: every (relevant, irrelevant) pair where the relevant
    item ranks higher counts as concordant; AUC = concordant / (pos × neg), with
    positions (not distinct items) as the pair universe — algebraically identical
    to the reference's ``1 - fp_cum / (fp_cur * (length - fp_cur))``
    (replay/metrics/rocauc.py:75-95). A list with no irrelevant items scores 1,
    with no relevant items 0 — the same boundary convention as the reference.
    """

    def _from_hits(self, k, data):
        hits = data.hits_occ
        in_list = np.arange(k)[None, :] < data.pred_len[:, None]
        negatives = in_list & ~hits
        # negatives ranked strictly above each position
        neg_above = np.cumsum(negatives, axis=1) - negatives
        pos_total = hits.sum(axis=1).astype(np.float64)
        neg_total = negatives.sum(axis=1).astype(np.float64)
        concordant = (hits * (neg_total[:, None] - neg_above)).sum(axis=1)
        auc = _safe_div(concordant, pos_total * neg_total)
        auc = np.where((pos_total > 0) & (neg_total == 0), 1.0, auc)
        return np.where(data.pred_len == 0, 0.0, auc)
