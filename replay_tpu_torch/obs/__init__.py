"""Run telemetry: events, step timing, health, tracing, profiling, the live
metrics plane and the flight recorder.

Counterpart of ``replay_tpu/obs/``: :class:`TrainerEvent` records through
:class:`RunLogger` sinks (:class:`JsonlLogger`, :class:`MultiLogger`,
:class:`ConsoleLogger`); :class:`StepTelemetry`, :class:`CompileTracker`
(graph captures, first calls, kernel builds) and :class:`MemoryMonitor`
(``torch.cuda`` allocator stats); :class:`Tracer` spans with the training
and serving goodput breakdowns and :func:`traced_iterator`;
:mod:`.health` (in-step model health and :class:`HealthWatcher`);
:mod:`.profile` (per-scope device time of a ``torch.profiler`` capture);
:mod:`.mfu` and :mod:`.roofline` (counted FLOPs and bytes against the card's
peak table); :mod:`.metrics`, :mod:`.exporter` and :mod:`.slo` (the live
registry, its ``/metrics`` endpoint and SLO watchdogs); :mod:`.blackbox`
(the SIGKILL-proof flight ring, byte-compatible with the JAX package's).
The run report, the fleet federation, quality monitoring and post-mortems
wait in ROADMAP.md queue 1 (item 10).
"""

from .blackbox import BlackboxLogger, FlightLog, FlightRecorder, read_flight
from .collectors import CompileTracker, MemoryMonitor, StepTelemetry
from .events import ConsoleLogger, JsonlLogger, MultiLogger, RunLogger, TensorBoardLogger, TrainerEvent
from .exporter import MetricsExporter
from .health import HealthConfig, HealthWatcher, flatten_health, health_metrics
from .metrics import MetricsLogger, MetricsRegistry
from .mfu import PEAK_BF16_TFLOPS, flops_per_step, fused_ce_flops, mfu, peak_tflops, program_costs
from .profile import NAMED_SCOPES, attribute_capture, latest_capture, scope_of
from .roofline import PEAK_HBM_GBPS, analyze_program, classify, of_ceiling, peak_bandwidth
from .slo import SLORule, SLOWatchdog
from .trace import (
    GOODPUT_SPANS,
    SERVE_GOODPUT_SPANS,
    TraceContext,
    Tracer,
    goodput_breakdown,
    lifecycle_span,
    traced_iterator,
)

__all__ = [
    "BlackboxLogger",
    "CompileTracker",
    "ConsoleLogger",
    "FlightLog",
    "FlightRecorder",
    "GOODPUT_SPANS",
    "HealthConfig",
    "HealthWatcher",
    "JsonlLogger",
    "MemoryMonitor",
    "MetricsExporter",
    "MetricsLogger",
    "MetricsRegistry",
    "MultiLogger",
    "NAMED_SCOPES",
    "PEAK_BF16_TFLOPS",
    "PEAK_HBM_GBPS",
    "RunLogger",
    "SERVE_GOODPUT_SPANS",
    "SLORule",
    "SLOWatchdog",
    "StepTelemetry",
    "TensorBoardLogger",
    "TraceContext",
    "Tracer",
    "TrainerEvent",
    "analyze_program",
    "attribute_capture",
    "classify",
    "flatten_health",
    "flops_per_step",
    "fused_ce_flops",
    "goodput_breakdown",
    "health_metrics",
    "latest_capture",
    "lifecycle_span",
    "mfu",
    "of_ceiling",
    "peak_bandwidth",
    "peak_tflops",
    "program_costs",
    "read_flight",
    "scope_of",
    "traced_iterator",
]
