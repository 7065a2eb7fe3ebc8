"""Batched validation metrics on the batch's device.

Counterpart of ``replay_tpu/metrics/builder.py``: accumulate per-batch top-k
predictions against padded ground-truth/train id sets and report recall /
precision / ndcg / map / mrr / hitrate / novelty / coverage. Hits come from a
broadcast compare (no per-user Python loop), and the accumulated state is a
dict of sums, so a distributed trainer can all-reduce it before
``get_metrics`` divides.

The JAX package jits the two per-batch programs, ``_batch_metric_sums`` and
``_coverage_bitmap``, keyed by their static arguments. Here they run through
a runner of :func:`metric_program` (``nn/graphs.py::runner``): on the card
one CUDA graph per static arguments and input shapes, which a trainer keeps
across its evaluation passes; elsewhere, and for a builder given none,
eagerly.
Adding each batch's sums to the running totals stays outside them, as in JAX.
:meth:`MetricsBuilder.load_state` takes a state back (the port's, or the JAX
builder's as numpy), and :func:`metrics_to_df` arranges a flat ``name@k``
mapping as a table.
"""

from __future__ import annotations

from typing import Dict, Hashable, Mapping, Optional, Sequence

import numpy as np
import torch

from replay_tpu_torch.device import to_device

DEFAULT_METRICS = ["map", "ndcg", "recall"]
DEFAULT_KS = [1, 5, 10, 20]
PER_USER_METRICS = ("recall", "precision", "ndcg", "map", "mrr", "hitrate", "novelty")


def _batch_metric_sums(
    predictions: torch.Tensor,  # [B, max_k] int item ids, ranked
    ground_truth: torch.Tensor,  # [B, G] int item ids, padded with negative values
    train: Optional[torch.Tensor],  # [B, T] or None
    valid: Optional[torch.Tensor],  # [B] bool — False rows (batch padding) contribute 0
    ks: tuple,
    metrics: tuple,
) -> Dict[str, torch.Tensor]:
    """Sum of each per-user metric over the batch, for every k."""
    device = predictions.device
    f32 = torch.float32
    row_weight = (
        torch.ones(predictions.shape[0], dtype=f32, device=device) if valid is None else valid.to(f32)
    )
    valid_gt = ground_truth >= 0
    gt_count = valid_gt.sum(dim=1)  # [B]
    # hits[b, i] — is predictions[b, i] a ground-truth item of user b
    hits = ((predictions[:, :, None] == ground_truth[:, None, :]) & valid_gt[:, None, :]).any(dim=2)
    hits = hits.to(f32)  # [B, max_k]
    if train is not None:
        valid_train = train >= 0
        train_hits = (
            ((predictions[:, :, None] == train[:, None, :]) & valid_train[:, None, :]).any(dim=2)
        ).to(f32)
    else:
        train_hits = None

    max_k = predictions.shape[1]
    positions = torch.arange(max_k, dtype=f32, device=device)
    inv_log = 1.0 / torch.log2(positions + 2.0)  # ndcg discounts
    inv_rank = 1.0 / (positions + 1.0)  # map / mrr weights
    cum_hits = torch.cumsum(hits, dim=1)

    def gated_sum(per_user: torch.Tensor) -> torch.Tensor:
        return torch.sum(per_user * row_weight)

    out: Dict[str, torch.Tensor] = {}
    for k in ks:
        h = hits[:, :k]
        hit_count = cum_hits[:, k - 1]
        gt_at_k = torch.clamp(gt_count, max=k).to(f32)
        safe_gt = torch.clamp(gt_at_k, min=1.0)
        users_with_gt = (gt_count > 0).to(f32)
        if "recall" in metrics:
            out[f"recall@{k}"] = gated_sum(hit_count / torch.clamp(gt_count, min=1) * users_with_gt)
        if "precision" in metrics:
            out[f"precision@{k}"] = gated_sum(hit_count / k * users_with_gt)
        if "hitrate" in metrics:
            out[f"hitrate@{k}"] = gated_sum((hit_count > 0).to(f32))
        if "ndcg" in metrics:
            dcg = torch.sum(h * inv_log[:k], dim=1)
            # idcg = sum of the first min(gt, k) discounts
            idcg_table = torch.cat([torch.zeros(1, dtype=f32, device=device), torch.cumsum(inv_log[:k], 0)])
            idcg = idcg_table[torch.clamp(gt_count, max=k)]
            out[f"ndcg@{k}"] = gated_sum(dcg / torch.clamp(idcg, min=1e-9) * users_with_gt)
        if "map" in metrics:
            ap = torch.sum(h * cum_hits[:, :k] * inv_rank[:k], dim=1) / safe_gt
            out[f"map@{k}"] = gated_sum(ap * users_with_gt)
        if "mrr" in metrics:
            first_hit = torch.argmax(h, dim=1)
            any_hit = hit_count > 0
            out[f"mrr@{k}"] = gated_sum(torch.where(any_hit, 1.0 / (first_hit + 1.0), 0.0))
        if "novelty" in metrics and train_hits is not None:
            out[f"novelty@{k}"] = gated_sum(1.0 - torch.sum(train_hits[:, :k], dim=1) / k)
    return out


def _coverage_bitmap(
    predictions: torch.Tensor, k: int, item_count: int, valid: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Boolean item-presence map of the batch's top-k recommendations."""
    top = predictions[:, :k]
    if valid is not None:
        # batch-padding rows must not mark items; redirect them out of range
        top = torch.where(valid[:, None], top, -1)
    flat = top.reshape(-1).long()
    bitmap = torch.zeros(item_count + 1, dtype=torch.bool, device=predictions.device)
    # -1 (and anything below) lands on the scratch slot item_count, as JAX's
    # negative index does; index_fill_ takes its value as a scalar argument
    # (no host tensor to copy, so the program can be captured)
    slots = torch.remainder(torch.clamp(flat, -1, item_count - 1), item_count + 1)
    bitmap.index_fill_(0, slots, True)
    return bitmap[:item_count]


def metric_program(key: Hashable):
    """The program of a metric key: ``("sums", ks, metrics, ...)`` runs
    :func:`_batch_metric_sums`, ``("coverage", k, item_count, ...)``
    :func:`_coverage_bitmap`; each takes ``(params, *inputs)`` (no params)."""
    kind, first, second = key[:3]
    if kind == "sums":
        return lambda params, predictions, truth, train, valid: _batch_metric_sums(
            predictions, truth, train, valid, first, second
        )
    return lambda params, predictions, valid: _coverage_bitmap(predictions, first, second, valid)


class MetricsBuilder:
    """Accumulates validation metrics over batches, on the batches' device.

    :param programs: the runner of the per-batch programs (a runner of
        :func:`metric_program`); without one they run eagerly.
    """

    def __init__(
        self,
        metrics: Sequence[str] = tuple(DEFAULT_METRICS),
        top_k: Optional[Sequence[int]] = None,
        item_count: Optional[int] = None,
        programs=None,
    ) -> None:
        self._metrics = tuple(sorted(set(metrics)))
        unknown = set(self._metrics) - set(PER_USER_METRICS) - {"coverage"}
        if unknown:
            msg = f"Unknown metrics: {sorted(unknown)}"
            raise ValueError(msg)
        self._ks = tuple(sorted(set(top_k or DEFAULT_KS)))
        self._item_count = item_count
        self._need_coverage = "coverage" in self._metrics
        if self._need_coverage and item_count is None:
            msg = "item_count is required to compute coverage."
            raise ValueError(msg)
        self._programs = programs
        self.reset()

    @property
    def max_k(self) -> int:
        return max(self._ks)

    def reset(self) -> None:
        self._sums: Dict[str, torch.Tensor] = {}
        self._count = torch.zeros((), dtype=torch.int32)
        self._coverage: Dict[str, torch.Tensor] = {}

    def _run(self, key: tuple, inputs: tuple):
        """One per-batch program on ``inputs``: through the runner, keyed by
        the static arguments and the inputs' shapes, or called directly."""
        if self._programs is None:
            return metric_program(key)({}, *inputs)
        from replay_tpu_torch.nn.graphs import signature

        return self._programs((*key, signature(inputs)), {}, inputs)

    def add_prediction(self, predictions, ground_truth, train=None, valid=None) -> None:
        """Accumulate one batch.

        :param predictions: [B, >=max_k] ranked item ids (tensor or array).
        :param ground_truth: [B, G] item ids padded with a negative value.
        :param train: [B, T] seen item ids padded with a negative value
            (required for novelty).
        :param valid: [B] bool — False marks batch-padding rows (fixed-shape final
            batches); they contribute nothing to sums, count, or coverage.
        """
        predictions = to_device(predictions)[:, : self.max_k]
        device = predictions.device
        ground_truth = to_device(ground_truth, device)
        train = None if train is None else to_device(train, device)
        valid = None if valid is None else to_device(valid, device)
        per_user = tuple(m for m in self._metrics if m in PER_USER_METRICS)
        if per_user:
            sums = self._run(("sums", self._ks, per_user), (predictions, ground_truth, train, valid))
            for name, value in sums.items():
                previous = self._sums.get(name)
                self._sums[name] = value if previous is None else previous.to(device) + value
        if self._need_coverage:
            for k in self._ks:
                bitmap = self._run(("coverage", k, self._item_count), (predictions, valid))
                key = f"coverage@{k}"
                previous = self._coverage.get(key)
                self._coverage[key] = bitmap if previous is None else (previous.to(device) | bitmap)
        rows = predictions.shape[0] if valid is None else valid.sum(dtype=torch.int32)
        self._count = self._count.to(device) + rows

    def state(self) -> dict:
        """Accumulated state as a dict of tensors: the additive ``sums`` and
        ``count``, and ``coverage``'s boolean item-presence bitmaps. Summed
        across builders (an all-reduce), a bitmap becomes per-item
        multiplicities, which :meth:`load_state` collapses back."""
        return {"sums": dict(self._sums), "count": self._count, "coverage": dict(self._coverage)}

    def load_state(self, state: dict) -> None:
        """Take ``state`` (this builder's :meth:`state`, a sum of several, or
        the JAX builder's as numpy) as the accumulated state; coverage
        entries collapse to ``!= 0``, so an item seen by several builders
        counts once."""
        def tensor(value):  # a copy of an array (JAX's are read-only)
            return value if isinstance(value, torch.Tensor) else torch.tensor(np.asarray(value))

        self._sums = {name: tensor(value) for name, value in state["sums"].items()}
        self._count = tensor(state["count"]).to(torch.int32)
        self._coverage = {key: tensor(value) != 0 for key, value in state.get("coverage", {}).items()}

    def get_metrics(self) -> Mapping[str, float]:
        """Mean per-user metrics (+ coverage fraction) accumulated so far."""
        out: Dict[str, float] = {}
        for name, value in self._sums.items():
            out[name] = float(value) / max(float(self._count), 1.0)
        for name, bitmap in self._coverage.items():
            out[name] = float(torch.sum(bitmap != 0)) / float(self._item_count)
        return dict(sorted(out.items()))


def metrics_to_df(metrics: Mapping[str, float]):
    """Arrange a flat ``name@k`` mapping as a (metric × k) table: a ``metric``
    column (names in sorted order), then one ``@k`` column per k in
    ascending order, NaN where a metric lacks that k."""
    from replay_tpu_torch.utils.types import ColumnTable

    rows: Dict[str, Dict[int, float]] = {}
    for key, value in metrics.items():
        name, k = key.split("@")
        rows.setdefault(name, {})[int(k)] = value
    names = sorted(rows)
    ks = sorted({k for row in rows.values() for k in row})
    table = {"metric": np.array(names, dtype=object)}
    for k in ks:
        table[f"@{k}"] = np.array([rows[name].get(k, np.nan) for name in names], dtype=np.float64)
    return ColumnTable(table)
