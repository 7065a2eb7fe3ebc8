"""Metrics of the port (counterpart of ``replay_tpu/metrics``): the batched
validation builder the trainer runs on the card (:class:`MetricsBuilder`,
with ``load_state`` and :func:`metrics_to_df`), and the offline metric
classes on the host, on numpy without pandas: the ranking metrics, the
beyond-accuracy metrics and their pure per-slate functions, NCIS, the
aggregation descriptors, :class:`OfflineMetrics` and :class:`Experiment`.
Tables come back as :class:`~replay_tpu_torch.utils.types.ColumnTable`."""

from .ncis import NCISMetric, NCISPrecision
from .base import Metric, MetricDuplicatesWarning
from .beyond_accuracy import (
    CategoricalDiversity,
    Coverage,
    Novelty,
    Surprisal,
    Unexpectedness,
    coverage_of,
    novelty_of_slate,
    surprisal_of_slate,
    surprisal_weights,
    weighted_surprisal,
)
from .builder import MetricsBuilder, metrics_to_df
from .descriptors import CalculationDescriptor, ConfidenceInterval, Mean, Median, PerUser
from .offline_metrics import Experiment, OfflineMetrics
from .ranking import MAP, MRR, NDCG, HitRate, Precision, Recall, RocAuc

__all__ = [
    "NCISPrecision",
    "NCISMetric",
    "MAP",
    "MRR",
    "NDCG",
    "CalculationDescriptor",
    "CategoricalDiversity",
    "ConfidenceInterval",
    "Coverage",
    "Experiment",
    "HitRate",
    "Mean",
    "Median",
    "Metric",
    "MetricDuplicatesWarning",
    "MetricsBuilder",
    "Novelty",
    "OfflineMetrics",
    "PerUser",
    "Precision",
    "Recall",
    "RocAuc",
    "Surprisal",
    "Unexpectedness",
    "coverage_of",
    "metrics_to_df",
    "novelty_of_slate",
    "surprisal_of_slate",
    "surprisal_weights",
    "weighted_surprisal",
]
