"""Run telemetry: event sinks and host-side span tracing.

Counterpart of ``replay_tpu/obs/``, so far the parts the scoring service
uses: :class:`TrainerEvent` records through :class:`RunLogger` sinks
(:class:`JsonlLogger`), and :class:`Tracer` spans with the serve goodput
breakdown (:func:`goodput_breakdown` over :data:`SERVE_GOODPUT_SPANS`). The
rest of the JAX package's ``obs/`` (metrics, exporter, SLOs, quality, flight
recorder, report) waits in ROADMAP.md queue 1.
"""

from .events import JsonlLogger, RunLogger, TrainerEvent
from .trace import GOODPUT_SPANS, SERVE_GOODPUT_SPANS, TraceContext, Tracer, goodput_breakdown, lifecycle_span

__all__ = [
    "GOODPUT_SPANS",
    "SERVE_GOODPUT_SPANS",
    "JsonlLogger",
    "RunLogger",
    "TraceContext",
    "Tracer",
    "TrainerEvent",
    "goodput_breakdown",
    "lifecycle_span",
]
