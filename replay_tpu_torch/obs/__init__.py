"""Run telemetry: event sinks and host-side span tracing.

Counterpart of ``replay_tpu/obs/``, so far the parts the scoring service and
``Trainer.fit`` use: :class:`TrainerEvent` records through :class:`RunLogger`
sinks (:class:`JsonlLogger`, :class:`MultiLogger`, :class:`ConsoleLogger`),
:class:`StepTelemetry`, and :class:`Tracer` spans with the serve goodput
breakdown (:func:`goodput_breakdown` over :data:`SERVE_GOODPUT_SPANS`). The
rest of the JAX package's ``obs/`` (health, metrics, exporter, SLOs, quality,
flight recorder, report, the TensorBoard sink) waits in ROADMAP.md queue 1.
"""

from .collectors import StepTelemetry
from .events import ConsoleLogger, JsonlLogger, MultiLogger, RunLogger, TensorBoardLogger, TrainerEvent
from .trace import GOODPUT_SPANS, SERVE_GOODPUT_SPANS, TraceContext, Tracer, goodput_breakdown, lifecycle_span

__all__ = [
    "GOODPUT_SPANS",
    "SERVE_GOODPUT_SPANS",
    "ConsoleLogger",
    "JsonlLogger",
    "MultiLogger",
    "RunLogger",
    "StepTelemetry",
    "TensorBoardLogger",
    "TraceContext",
    "Tracer",
    "TrainerEvent",
    "goodput_breakdown",
    "lifecycle_span",
]
