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
(the SIGKILL-proof flight ring, byte-compatible with the JAX package's);
:mod:`.quality` (the model-quality plane: online prequential scores,
beyond-accuracy gauges, PSI drift and the quality SLO cookbook);
:mod:`.federate` (N per-process ``/snapshot`` exporters merged into one
fleet-level ``/metrics``); the fleet's :func:`merge_traces` and
:func:`tail_attribution`; :mod:`.report`, the run-report CLI
(``python -m replay_tpu_torch.obs.report <run_dir>``, ``--compare``,
``--postmortem``), and :mod:`.postmortem`, which it renders. Every one of
them is host code and reads and writes the JAX package's formats.
``cost_analysis`` has no counterpart: it reads an XLA program's cost model.
"""

from .blackbox import BlackboxLogger, FlightLog, FlightRecorder, read_flight
from .collectors import CompileTracker, MemoryMonitor, StepTelemetry
from .events import ConsoleLogger, JsonlLogger, MultiLogger, RunLogger, TensorBoardLogger, TrainerEvent
from .exporter import MetricsExporter
from .federate import FleetFederator, federate_snapshots, scrape_snapshot
from .health import HealthConfig, HealthWatcher, flatten_health, health_metrics
from .metrics import MetricsLogger, MetricsRegistry
from .mfu import PEAK_BF16_TFLOPS, flops_per_step, fused_ce_flops, mfu, peak_tflops, program_costs
from .profile import NAMED_SCOPES, attribute_capture, latest_capture, scope_of
from .quality import (
    QUALITY_SLOS,
    DriftDetector,
    PopularityDescriptor,
    QualityMonitor,
    canary_quality_rules,
    population_stability_index,
    prequential_scores,
)
from .roofline import PEAK_HBM_GBPS, analyze_program, classify, of_ceiling, peak_bandwidth
from .slo import SLORule, SLOWatchdog
from .trace import (
    GOODPUT_SPANS,
    REQUEST_HOP_SPANS,
    SERVE_GOODPUT_SPANS,
    TraceContext,
    Tracer,
    goodput_breakdown,
    lifecycle_span,
    merge_traces,
    tail_attribution,
    traced_iterator,
)

__all__ = [
    "analyze_program",
    "attribute_capture",
    "BlackboxLogger",
    "canary_quality_rules",
    "classify",
    "CompileTracker",
    "ConsoleLogger",
    "DriftDetector",
    "federate_snapshots",
    "flatten_health",
    "FleetFederator",
    "FlightLog",
    "FlightRecorder",
    "flops_per_step",
    "fused_ce_flops",
    "goodput_breakdown",
    "GOODPUT_SPANS",
    "health_metrics",
    "HealthConfig",
    "HealthWatcher",
    "JsonlLogger",
    "latest_capture",
    "lifecycle_span",
    "MemoryMonitor",
    "merge_traces",
    "MetricsExporter",
    "MetricsLogger",
    "MetricsRegistry",
    "mfu",
    "MultiLogger",
    "NAMED_SCOPES",
    "of_ceiling",
    "peak_bandwidth",
    "PEAK_BF16_TFLOPS",
    "PEAK_HBM_GBPS",
    "peak_tflops",
    "PopularityDescriptor",
    "population_stability_index",
    "prequential_scores",
    "program_costs",
    "QUALITY_SLOS",
    "QualityMonitor",
    "read_flight",
    "REQUEST_HOP_SPANS",
    "RunLogger",
    "scope_of",
    "scrape_snapshot",
    "SERVE_GOODPUT_SPANS",
    "SLORule",
    "SLOWatchdog",
    "StepTelemetry",
    "tail_attribution",
    "TensorBoardLogger",
    "TraceContext",
    "traced_iterator",
    "Tracer",
    "TrainerEvent",
]
