"""Aggregation descriptors over the per-user metric distribution.

Counterpart of ``replay_tpu/metrics/descriptors.py`` (Mean, PerUser, Median,
ConfidenceInterval), on numpy; scipy is imported only inside
:meth:`ConfidenceInterval.cpu`.
"""

from __future__ import annotations

import numpy as np


class CalculationDescriptor:
    """How to reduce the per-user metric distribution to a reported value."""

    @property
    def __name__(self) -> str:
        return type(self).__name__

    def cpu(self, distribution: np.ndarray):  # pragma: no cover - abstract
        raise NotImplementedError


class Mean(CalculationDescriptor):
    def cpu(self, distribution: np.ndarray):
        return float(np.mean(distribution))


class PerUser(CalculationDescriptor):
    def cpu(self, distribution: np.ndarray):
        return distribution


class Median(CalculationDescriptor):
    def cpu(self, distribution: np.ndarray):
        return float(np.median(distribution))


class ConfidenceInterval(CalculationDescriptor):
    """Half-width of the normal-approximation confidence interval of the mean."""

    def __init__(self, alpha: float) -> None:
        self.alpha = alpha

    def cpu(self, distribution: np.ndarray):
        from scipy.stats import norm

        n = len(distribution)
        if n <= 1:
            return 0.0
        quantile = norm.ppf((1 + self.alpha) / 2)
        std = np.std(distribution, ddof=1)
        if np.isnan(std):
            return 0.0
        return float(quantile * std / np.sqrt(n))
