"""Metrics of the port. So far the batched validation builder the trainer uses;
the offline metric classes of ``replay_tpu.metrics`` are a later slice."""

from .builder import MetricsBuilder

__all__ = ["MetricsBuilder"]
