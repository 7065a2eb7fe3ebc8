"""Live metrics plane: a thread-safe registry bridged from the event stream.

Copied from ``replay_tpu/obs/metrics.py`` (host-only, stdlib only), so that a
scrape of the port renders the JAX package's text for the same events:

* :class:`MetricsRegistry` — counters (monotone), gauges (last value) and
  fixed-bucket histograms (counts + sum + min/max, with Prometheus-style
  interpolated quantile estimates). Every mutation and every read is taken
  under one registry lock, so a scrape observes a consistent snapshot while
  client/worker threads keep writing.
* :class:`MetricsLogger` — a :class:`~replay_tpu_torch.obs.events.RunLogger`
  sink that derives the registry from the event families (``on_train_step``
  / ``on_epoch_end`` / ``on_anomaly`` / health payloads, and the serve family
  ``on_serve_batch`` / ``on_shed`` / ``on_breaker`` / ``on_degrade`` /
  ``on_serve_end``): attaching this sink is the instrumentation. An optional
  :class:`~replay_tpu_torch.obs.slo.SLOWatchdog` is evaluated at step/batch
  cadence right after the bridge updates, so SLO rules see the freshest values.

The exporter half (``/metrics`` Prometheus text + ``/snapshot`` JSON over a
stdlib HTTP server) lives in :mod:`replay_tpu_torch.obs.exporter`; the
declarative threshold rules in :mod:`replay_tpu_torch.obs.slo`.
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Any, Callable, Deque, Dict, List, Mapping, Optional, Sequence, Tuple

from .events import RunLogger, TrainerEvent

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsLogger",
    "MetricsRegistry",
    "render_prometheus",
]

# Prometheus' default histogram ladder, in seconds — right-sized for step
# times and queue waits in ms-to-minutes territory.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

LabelValue = Tuple[Tuple[str, str], ...]


def _labels_key(labels: Optional[Mapping[str, str]]) -> LabelValue:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _format_value(value: float) -> str:
    """Prometheus text-format number: integers without the trailing ``.0``."""
    if isinstance(value, float) and (math.isinf(value) or math.isnan(value)):
        return "+Inf" if value == math.inf else ("-Inf" if value == -math.inf else "NaN")
    as_float = float(value)
    if as_float == int(as_float) and abs(as_float) < 1e15:
        return str(int(as_float))
    return repr(as_float)


class Counter:
    """Monotone accumulator. Mutate only through the owning registry's lock
    (i.e. via :meth:`MetricsRegistry.inc` or while holding the metric handle
    returned by the registry, which routes through that lock)."""

    kind = "counter"

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            msg = f"counters are monotone; cannot add {amount}"
            raise ValueError(msg)
        self.value += float(amount)

    def sample(self) -> Dict[str, Any]:
        return {"type": self.kind, "value": self.value}


class Gauge:
    """Last-write-wins scalar."""

    kind = "gauge"

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def sample(self) -> Dict[str, Any]:
        return {"type": self.kind, "value": self.value}


class Histogram:
    """Fixed upper-bound buckets with Prometheus-style quantile estimates.

    ``buckets`` are the finite upper bounds (``le``); an implicit ``+Inf``
    bucket catches the tail. :meth:`quantile` linearly interpolates inside the
    bucket where the target rank falls (the ``histogram_quantile`` recipe),
    clamped to the observed ``[min, max]`` so small samples on known
    distributions stay honest (tested against numpy percentiles).
    """

    kind = "histogram"

    # slowest-N exemplars kept per histogram: enough to name the offending
    # traces without growing per-request state
    EXEMPLAR_CAPACITY = 8

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            msg = "a histogram needs at least one finite bucket bound"
            raise ValueError(msg)
        if any(math.isinf(b) or math.isnan(b) for b in bounds):
            msg = f"bucket bounds must be finite (got {bounds}); +Inf is implicit"
            raise ValueError(msg)
        self.bounds: Tuple[float, ...] = tuple(bounds)
        self.counts: List[int] = [0] * (len(bounds) + 1)  # + the +Inf bucket
        self.total = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        # bounded slowest-N (value, exemplar) pairs, only populated when a
        # caller passes ``exemplar=`` — a plain histogram pays nothing
        self._exemplars: List[Tuple[float, str]] = []

    def observe(self, value: float, exemplar: Optional[str] = None) -> None:
        value = float(value)
        if math.isnan(value):
            return  # a NaN observation poisons sum and ranks nothing
        index = len(self.bounds)
        for i, bound in enumerate(self.bounds):
            if value <= bound:
                index = i
                break
        self.counts[index] += 1
        self.total += 1
        self.sum += value
        self.min = value if self.min is None else min(self.min, value)
        self.max = value if self.max is None else max(self.max, value)
        if exemplar is not None:
            self._offer_exemplar(value, str(exemplar))

    def _offer_exemplar(self, value: float, exemplar: str) -> None:
        """Keep the slowest :data:`EXEMPLAR_CAPACITY` (value, exemplar) pairs:
        the tail's trace ids, attached to the distribution that says the tail
        is slow. Mutate under the same lock as :meth:`observe` (the registry's
        or the owning object's)."""
        store = self._exemplars
        if len(store) < self.EXEMPLAR_CAPACITY:
            store.append((value, exemplar))
            store.sort(key=lambda pair: pair[0])
            return
        if value <= store[0][0]:
            return  # faster than the fastest kept exemplar: not tail material
        store[0] = (value, exemplar)
        store.sort(key=lambda pair: pair[0])

    def exemplars(self) -> List[Dict[str, Any]]:
        """Slowest-first ``{value, trace_id}`` records (empty when no
        observation carried an exemplar)."""
        return [
            {"value": value, "trace_id": exemplar}
            for value, exemplar in sorted(self._exemplars, key=lambda p: -p[0])
        ]

    def quantile(self, q: float) -> Optional[float]:
        if not 0.0 <= q <= 1.0:
            msg = f"quantile must be in [0, 1], got {q}"
            raise ValueError(msg)
        if self.total == 0:
            return None
        rank = q * self.total
        cumulative = 0
        for i, bound in enumerate(self.bounds):
            previous = cumulative
            cumulative += self.counts[i]
            if cumulative >= rank:
                lower = self.bounds[i - 1] if i > 0 else min(0.0, bound)
                if self.counts[i]:
                    fraction = (rank - previous) / self.counts[i]
                else:
                    fraction = 0.0
                estimate = lower + (bound - lower) * fraction
                return self._clamp(estimate)
        # the rank lands in the +Inf bucket: the best finite statement is the
        # largest observation
        return self.max

    def _clamp(self, estimate: float) -> float:
        if self.min is not None:
            estimate = max(estimate, self.min)
        if self.max is not None:
            estimate = min(estimate, self.max)
        return estimate

    def mean(self) -> Optional[float]:
        return self.sum / self.total if self.total else None

    def sample(self) -> Dict[str, Any]:
        out = {
            "type": self.kind,
            "count": self.total,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "buckets": {_format_value(b): c for b, c in zip(self.bounds, self.counts)},
            "overflow": self.counts[-1],
            "quantiles": {
                f"p{int(q * 100)}": self.quantile(q) for q in (0.5, 0.9, 0.99)
            },
        }
        if self._exemplars:
            out["exemplars"] = self.exemplars()
        return out


class MetricsRegistry:
    """Named metric instances behind ONE lock.

    A metric is identified by ``(name, labels)``; the first registration fixes
    its type and a later lookup with a different type raises (the one-name-
    one-meaning rule Prometheus enforces at scrape time, enforced here at
    write time instead). All mutators and all readers serialize on the
    registry lock, so a concurrent ``/metrics`` scrape can never observe a
    half-updated histogram or a counter that went backwards.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        # name -> (kind, {labels_key: metric})
        self._metrics: Dict[str, Tuple[str, Dict[LabelValue, Any]]] = {}

    def _get(self, name: str, kind: str, labels: Optional[Mapping[str, str]], factory):
        entry = self._metrics.get(name)
        if entry is None:
            entry = (kind, {})
            self._metrics[name] = entry
        elif entry[0] != kind:
            msg = f"metric {name!r} is a {entry[0]}, not a {kind}"
            raise ValueError(msg)
        series = entry[1]
        key = _labels_key(labels)
        metric = series.get(key)
        if metric is None:
            metric = factory()
            series[key] = metric
        return metric

    # -- mutators ----------------------------------------------------------- #
    def inc(self, name: str, amount: float = 1.0, labels: Optional[Mapping[str, str]] = None) -> None:
        with self._lock:
            self._get(name, "counter", labels, Counter).inc(amount)

    def set(self, name: str, value: float, labels: Optional[Mapping[str, str]] = None) -> None:
        with self._lock:
            self._get(name, "gauge", labels, Gauge).set(value)

    def observe(
        self,
        name: str,
        value: float,
        labels: Optional[Mapping[str, str]] = None,
        buckets: Sequence[float] = DEFAULT_BUCKETS,
        exemplar: Optional[str] = None,
    ) -> None:
        with self._lock:
            self._get(name, "histogram", labels, lambda: Histogram(buckets)).observe(
                value, exemplar=exemplar
            )

    # -- readers ------------------------------------------------------------ #
    def value(self, ref: str, labels: Optional[Mapping[str, str]] = None) -> Optional[float]:
        """Scalar read for SLO rules: a counter's total, a gauge's value, or a
        histogram statistic via a ``name:stat`` suffix (``:p50``/``:p99``/...,
        ``:mean``, ``:count``, ``:sum``, ``:max``, ``:min``). ``None`` when the
        metric (or the labeled series) does not exist yet."""
        name, _, stat = ref.partition(":")
        with self._lock:
            entry = self._metrics.get(name)
            if entry is None:
                return None
            metric = entry[1].get(_labels_key(labels))
            if metric is None:
                return None
            if isinstance(metric, Histogram):
                if not stat or stat == "mean":
                    return metric.mean()
                if stat == "count":
                    return float(metric.total)
                if stat == "sum":
                    return metric.sum
                if stat == "max":
                    return metric.max
                if stat == "min":
                    return metric.min
                if stat.startswith("p"):
                    try:
                        q = float(stat[1:]) / 100.0
                    except ValueError:
                        msg = f"unknown histogram stat {stat!r} in {ref!r}"
                        raise ValueError(msg) from None
                    return metric.quantile(q)
                msg = f"unknown histogram stat {stat!r} in {ref!r}"
                raise ValueError(msg)
            if stat:
                msg = f"{name!r} is a {metric.kind}; the :{stat} suffix is for histograms"
                raise ValueError(msg)
            return float(metric.value)

    def snapshot(self) -> Dict[str, Any]:
        """One consistent JSON-able view of every metric (the ``/snapshot``
        endpoint's body)."""
        with self._lock:
            out: Dict[str, Any] = {}
            for name, (_, series) in sorted(self._metrics.items()):
                for key, metric in sorted(series.items()):
                    label_str = (
                        "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}" if key else ""
                    )
                    out[name + label_str] = metric.sample()
            return out

    def render_prometheus(self) -> str:
        """The registry in Prometheus text exposition format (one consistent
        pass under the lock — concurrent writers never tear a line)."""
        with self._lock:
            lines: List[str] = []
            for name, (kind, series) in sorted(self._metrics.items()):
                lines.append(f"# TYPE {name} {kind}")
                for key, metric in sorted(series.items()):
                    label_str = (
                        "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}" if key else ""
                    )
                    if isinstance(metric, Histogram):
                        cumulative = 0
                        for bound, count in zip(metric.bounds, metric.counts):
                            cumulative += count
                            bucket_labels = list(key) + [("le", _format_value(bound))]
                            rendered = ",".join(f'{k}="{v}"' for k, v in bucket_labels)
                            lines.append(f"{name}_bucket{{{rendered}}} {cumulative}")
                        bucket_labels = list(key) + [("le", "+Inf")]
                        rendered = ",".join(f'{k}="{v}"' for k, v in bucket_labels)
                        lines.append(f"{name}_bucket{{{rendered}}} {metric.total}")
                        lines.append(f"{name}_sum{label_str} {_format_value(metric.sum)}")
                        lines.append(f"{name}_count{label_str} {metric.total}")
                    else:
                        lines.append(f"{name}{label_str} {_format_value(metric.value)}")
            return "\n".join(lines) + "\n"


def render_prometheus(registry: MetricsRegistry) -> str:
    """Module-level alias of :meth:`MetricsRegistry.render_prometheus`."""
    return registry.render_prometheus()


# --------------------------------------------------------------------------- #
# the event -> registry bridge
# --------------------------------------------------------------------------- #
_BREAKER_STATES = {"closed": 0.0, "half_open": 1.0, "open": 2.0}
# fleet replica health as a scrapeable ordinal (serve.router.REPLICA_HEALTH)
_REPLICA_HEALTH_STATES = {
    "healthy": 0.0, "degraded": 1.0, "draining": 2.0, "dead": 3.0,
}

# step-time buckets in seconds: sub-ms CPU microbenches up to multi-second
# accelerator steps
STEP_SECONDS_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
QUEUE_WAIT_MS_BUCKETS: Tuple[float, ...] = (
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0, 1000.0,
)
FILL_BUCKETS: Tuple[float, ...] = (0.1, 0.25, 0.5, 0.75, 0.9, 1.0)


def _finite(value: Any) -> Optional[float]:
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return None
    value = float(value)
    return value if math.isfinite(value) else None


class MetricsLogger(RunLogger):
    """Bridge the existing event stream into a :class:`MetricsRegistry`.

    Attach it like any other sink (``Trainer.fit(loggers=[...])`` appends it
    automatically when ``metrics_port``/``slo_rules`` are requested; the
    JAX package's ScoringService routes its ``_emit`` through it): every known event family
    updates the registry, unknown events pass through untouched. After each
    ``on_train_step`` / ``on_serve_batch`` bridge the optional ``watchdog``
    (:class:`~replay_tpu_torch.obs.slo.SLOWatchdog`) is evaluated, so threshold
    rules run at step/batch cadence and never on their own thread.

    Serve QPS is a sliding-window rate (default 10 s) over the rows each
    dispatched batch answered — the live analog of ``bench_serve``'s
    whole-run ``qps``.
    """

    def __init__(
        self,
        registry: Optional[MetricsRegistry] = None,
        watchdog: Optional[Any] = None,
        qps_window_seconds: float = 10.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self.registry = registry if registry is not None else MetricsRegistry()
        self.watchdog = watchdog
        self._clock = clock
        self._qps_window = float(qps_window_seconds)
        self._qps_events: Deque[Tuple[float, float]] = collections.deque()
        self._qps_lock = threading.Lock()

    # -- helpers ------------------------------------------------------------ #
    def _gauge(self, name: str, value: Any, labels: Optional[Mapping[str, str]] = None) -> None:
        finite = _finite(value)
        if finite is not None:
            self.registry.set(name, finite, labels=labels)

    def _count(self, name: str, value: Any, labels: Optional[Mapping[str, str]] = None) -> None:
        finite = _finite(value)
        if finite is not None and finite > 0:
            self.registry.inc(name, finite, labels=labels)

    def _serve_qps(self, rows: float) -> None:
        now = self._clock()
        with self._qps_lock:
            self._qps_events.append((now, rows))
            horizon = now - self._qps_window
            while self._qps_events and self._qps_events[0][0] < horizon:
                self._qps_events.popleft()
            window_rows = sum(r for _, r in self._qps_events)
            span = now - self._qps_events[0][0] if len(self._qps_events) > 1 else 0.0
        # a window shorter than one second reads as the window itself, so a
        # burst at startup does not print an absurd rate
        self.registry.set("replay_serve_qps", window_rows / max(span, 1.0))

    def _bridge_goodput(self, goodput: Mapping[str, Any]) -> None:
        fractions = goodput.get("fractions")
        if isinstance(fractions, Mapping):
            for phase, fraction in fractions.items():
                self._gauge(
                    "replay_goodput_fraction", fraction, labels={"phase": str(phase)}
                )
        self._gauge("replay_input_starvation", goodput.get("input_starvation"))

    def _bridge_health(self, health: Mapping[str, Any]) -> None:
        self._gauge("replay_health_grad_norm", health.get("grad_norm_global"))
        ratios = health.get("update_ratio")
        if isinstance(ratios, Mapping):
            finite = [v for v in (_finite(r) for r in ratios.values()) if v is not None]
            if finite:
                self.registry.set("replay_health_max_update_ratio", max(finite))

    # -- the bridge --------------------------------------------------------- #
    def log_event(self, event: TrainerEvent) -> None:  # noqa: C901 — one table
        name, payload = event.event, event.payload
        evaluate = False
        if name == "on_train_step":
            self.registry.inc("replay_train_steps_total")
            self._gauge("replay_train_loss", payload.get("loss"))
            self._gauge("replay_train_lr", payload.get("lr"))
            self._gauge("replay_train_samples_per_sec", payload.get("samples_per_sec"))
            self._gauge("replay_train_steps_per_sec", payload.get("steps_per_sec"))
            # feed efficiency (sequence packing / padding waste): the SLO-able
            # companions to replay_input_starvation
            self._gauge(
                "replay_effective_tokens_per_sec", payload.get("effective_tokens_per_sec")
            )
            self._gauge("replay_padding_fraction", payload.get("padding_fraction"))
            step_seconds = _finite(payload.get("step_seconds"))
            if step_seconds is not None:
                self.registry.observe(
                    "replay_train_step_seconds", step_seconds, buckets=STEP_SECONDS_BUCKETS
                )
            if event.step is not None:
                self._gauge("replay_train_step", event.step)
            health = payload.get("health")
            if isinstance(health, Mapping):
                self._bridge_health(health)
            evaluate = True
        elif name == "on_anomaly":
            self.registry.inc("replay_train_anomalies_total")
            self._gauge("replay_train_bad_steps", payload.get("bad_steps_total"))
            evaluate = True
        elif name == "on_health_warning":
            self.registry.inc("replay_health_warnings_total")
        elif name == "on_recovery":
            self.registry.inc("replay_train_recoveries_total")
        elif name == "on_epoch_end":
            if event.epoch is not None:
                self._gauge("replay_train_epoch", event.epoch)
            record = payload.get("record")
            if isinstance(record, Mapping):
                self._gauge("replay_train_loss_epoch", record.get("train_loss"))
            self._gauge("replay_train_bad_steps", payload.get("bad_steps"))
            goodput = payload.get("goodput")
            if isinstance(goodput, Mapping):
                self._bridge_goodput(goodput)
            health = payload.get("health")
            if isinstance(health, Mapping):
                self._bridge_health(health)
            input_record = payload.get("input")
            if isinstance(input_record, Mapping):
                self._gauge(
                    "replay_effective_tokens_per_sec",
                    input_record.get("effective_tokens_per_sec"),
                )
                self._gauge(
                    "replay_padding_fraction", input_record.get("padding_fraction")
                )
        elif name == "on_fit_start":
            self.registry.set("replay_train_up", 1.0)
        elif name == "on_fit_end":
            self._gauge("replay_train_bad_steps", payload.get("bad_steps"))
            goodput = payload.get("goodput")
            if isinstance(goodput, Mapping):
                self._bridge_goodput(goodput)
            telemetry = payload.get("telemetry")
            if isinstance(telemetry, Mapping):
                self._gauge(
                    "replay_train_samples_per_sec_steady",
                    telemetry.get("samples_per_sec"),
                )
            input_record = payload.get("input")
            if isinstance(input_record, Mapping):
                self._gauge(
                    "replay_effective_tokens_per_sec",
                    input_record.get("effective_tokens_per_sec"),
                )
                self._gauge(
                    "replay_padding_fraction", input_record.get("padding_fraction")
                )
            self.registry.set("replay_train_up", 0.0)
        elif name == "on_serve_start":
            self.registry.set("replay_serve_up", 1.0)
        elif name == "on_serve_batch":
            rows = _finite(payload.get("rows")) or 0.0
            self.registry.inc("replay_serve_batches_total")
            self._count("replay_serve_rows_total", rows)
            self._count("replay_serve_expired_total", payload.get("dropped_expired"))
            self._count("replay_serve_cancelled_total", payload.get("dropped_cancelled"))
            if rows > 0:
                fill = _finite(payload.get("fill"))
                if fill is not None:
                    self.registry.observe(
                        "replay_serve_batch_fill", fill, buckets=FILL_BUCKETS
                    )
                wait_ms = _finite(payload.get("queue_wait_ms_max"))
                if wait_ms is not None:
                    self.registry.observe(
                        "replay_serve_queue_wait_ms", wait_ms, buckets=QUEUE_WAIT_MS_BUCKETS
                    )
            self._serve_qps(rows)
            evaluate = True
        elif name == "on_shed":
            self.registry.inc(
                "replay_serve_shed_total", _finite(payload.get("count")) or 1.0
            )
            lane = payload.get("lane")
            if lane is not None:
                self._gauge(
                    "replay_serve_lane_depth", payload.get("depth"),
                    labels={"lane": str(lane)},
                )
            evaluate = True
        elif name == "on_breaker":
            self.registry.inc("replay_serve_breaker_transitions_total")
            state = _BREAKER_STATES.get(str(payload.get("to")))
            if state is not None:
                self.registry.set("replay_serve_breaker_state", state)
        elif name == "on_degrade":
            self.registry.inc(
                "replay_serve_degraded_total",
                _finite(payload.get("count")) or 1.0,
                labels={"to": str(payload.get("to"))},
            )
        elif name == "on_serve_end":
            for key, metric in (
                ("cache_hit_rate", "replay_serve_cache_hit_rate"),
                ("batch_fill_ratio", "replay_serve_batch_fill_ratio"),
                ("shed_rate", "replay_serve_shed_rate"),
                ("deadline_miss_rate", "replay_serve_deadline_miss_rate"),
                ("error_rate", "replay_serve_error_rate"),
                ("requests", "replay_serve_requests"),
                ("answered", "replay_serve_answered"),
            ):
                self._gauge(metric, payload.get(key))
            self.registry.set("replay_serve_up", 0.0)
        # the fleet family (serve.fleet): per-replica health as a labeled
        # ordinal gauge plus failover/hedge counters — the replay_fleet_*
        # rows docs/observability.md documents
        elif name == "on_fleet_start":
            self.registry.set("replay_fleet_up", 1.0)
            replicas = payload.get("replicas")
            if isinstance(replicas, (list, tuple)):
                self.registry.set("replay_fleet_replicas", float(len(replicas)))
        elif name == "on_replica_health":
            self.registry.inc("replay_fleet_health_transitions_total")
            state = _REPLICA_HEALTH_STATES.get(str(payload.get("to")))
            if state is not None:
                self.registry.set(
                    "replay_fleet_replica_health", state,
                    labels={"replica": str(payload.get("replica"))},
                )
        elif name == "on_failover":
            self.registry.inc("replay_fleet_failovers_total")
        elif name == "on_hedge":
            self.registry.inc("replay_fleet_hedges_total")
        elif name == "on_fleet_end":
            for key, metric in (
                ("requests", "replay_fleet_requests"),
                ("answered", "replay_fleet_answered"),
                ("reroutes", "replay_fleet_reroutes"),
                ("retries", "replay_fleet_retries"),
                ("hedge_wins", "replay_fleet_hedge_wins"),
                ("reroute_rate", "replay_fleet_reroute_rate"),
                ("error_rate", "replay_fleet_error_rate"),
                ("p99_ms", "replay_fleet_p99_ms"),
            ):
                self._gauge(metric, payload.get(key))
            # the fleet's slowest-N latency exemplars, re-observed into a
            # registry histogram so ``/snapshot`` names the offending traces
            exemplars = payload.get("latency_exemplars")
            if isinstance(exemplars, (list, tuple)):
                for record in exemplars:
                    if not isinstance(record, Mapping):
                        continue
                    latency = _finite(record.get("latency_ms"))
                    trace_id = record.get("trace_id")
                    if latency is not None and trace_id:
                        self.registry.observe(
                            "replay_fleet_latency_exemplar_ms",
                            latency,
                            buckets=QUEUE_WAIT_MS_BUCKETS,
                            exemplar=str(trace_id),
                        )
            self.registry.set("replay_fleet_up", 0.0)
        elif name == "on_slo_violation":
            self.registry.inc(
                "replay_slo_violations_total",
                labels={"rule": str(payload.get("rule"))},
            )
        elif name == "on_slo_recovery":
            self.registry.inc(
                "replay_slo_recoveries_total",
                labels={"rule": str(payload.get("rule"))},
            )
        # the promotion family (serve.promote): hot swaps, canary evaluation
        # gauges and the promote/rollback verdicts — replayable from
        # events.jsonl into the same replay_canary_* series the live
        # controller maintains
        elif name == "on_publish":
            self.registry.inc("replay_publish_total")
            if payload.get("recompiled"):
                self.registry.inc("replay_publish_recompiled_total")
        elif name == "on_swap":
            self.registry.inc("replay_swap_total")
            self._gauge("replay_param_generation", payload.get("to_generation"))
        elif name == "on_canary_start":
            self.registry.set("replay_canary_stage", 2.0)
            self._gauge("replay_canary_generation", payload.get("generation"))
        elif name == "on_canary_eval":
            self._gauge("replay_canary_generation", payload.get("generation"))
            self._gauge("replay_canary_error_rate", payload.get("error_rate"))
            self._gauge("replay_canary_clean_evals", payload.get("clean_evals"))
            window = payload.get("window")
            if isinstance(window, Mapping):
                self._gauge("replay_canary_requests", window.get("requests"))
        elif name == "on_promotion":
            self.registry.inc("replay_promotions_total")
            self.registry.set("replay_canary_stage", 3.0)
        elif name == "on_rollback":
            self.registry.inc("replay_rollbacks_total")
            self.registry.set("replay_canary_stage", -1.0)
            self._gauge(
                "replay_param_generation", payload.get("restored_generation")
            )
        # the quality family (obs.quality): per-role windowed model-quality
        # gauges, the online prequential counters and the PSI drift series —
        # evaluate=True arms the drift/canary-quality SLO rules at window
        # cadence, so the drift alarm fires through the normal watchdog
        elif name == "on_quality_window":
            labels = {"role": str(payload.get("role") or "stable")}
            for key, metric in (
                ("coverage", "replay_quality_coverage"),
                ("novelty", "replay_quality_novelty"),
                ("surprisal", "replay_quality_surprisal"),
                ("popularity", "replay_quality_popularity"),
                ("ild", "replay_quality_ild"),
                ("score_entropy", "replay_quality_score_entropy"),
                ("top1_margin", "replay_quality_top1_margin"),
                ("online_hitrate", "replay_quality_online_hitrate"),
                ("online_mrr", "replay_quality_online_mrr"),
                ("online_ndcg", "replay_quality_online_ndcg"),
                ("online_hitrate_cum", "replay_quality_online_hitrate_cum"),
                ("online_mrr_cum", "replay_quality_online_mrr_cum"),
                ("online_ndcg_cum", "replay_quality_online_ndcg_cum"),
                ("joins", "replay_quality_joins"),
                ("requests", "replay_quality_requests"),
            ):
                self._gauge(metric, payload.get(key), labels)
            self.registry.inc("replay_quality_windows_total", labels=labels)
            drift = payload.get("drift")
            if isinstance(drift, Mapping):
                for series, psi in drift.items():
                    if series == "max":
                        self._gauge("replay_drift_psi", psi)
                    else:
                        self._gauge(
                            "replay_drift_psi_series", psi, {"series": str(series)}
                        )
            evaluate = True
        elif name == "on_drift_warning":
            self._count("replay_drift_warnings_total", payload.get("count") or 1.0)
            self._gauge("replay_drift_psi", payload.get("psi_max"))
            evaluate = True
        if evaluate and self.watchdog is not None:
            self.watchdog.evaluate(step=event.step)
