"""Event sinks: one JSON-able record per observation.

Copied from ``replay_tpu/obs/events.py``: :class:`TrainerEvent`, the
:class:`RunLogger` protocol, :class:`JsonlLogger`, :class:`MultiLogger` and
:class:`ConsoleLogger`. ``Trainer.fit`` emits its event family through them::

    on_fit_start              (epochs, model, loss, optimizer, learning rate,
                               resumed)
      on_train_step*          (loss, lr, samples/s, steps/s, step seconds,
                               effective tokens/s, padding fraction)
      on_anomaly*             (a sentinel-skipped step: loss, grad norm,
                               consecutive and total bad steps)
      on_recovery*            (a rollback: reason, restarts, restored step,
                               lr scale; or exhausted)
      on_checkpoint*          (mid_epoch, step_in_epoch or best)
      on_preemption           (the signal's name; on_fit_end follows)
      on_validation_end*      (the epoch's record)
      on_epoch_end*           (record, bad steps, grad norm, input summary)
    on_fit_end                (telemetry, peak memory, history length, bad
                               steps, input summary; stopped_early, preempted)

The scoring service emits its own family::

    on_serve_start            (mode, bucket ladders, max_wait, cache capacity,
                               queue-depth bound, default deadline)
      on_serve_batch*         (one per dispatched micro-batch: lane, rows,
                               bucket, fill, max queue wait, dropped
                               expired/cancelled counts)
      on_shed*                (admission control refused work: lane, depth,
                               retry-after hint; throttled, carries the
                               coalesced `count` per emit)
      on_breaker*             (circuit-breaker transition: from/to state,
                               consecutive failures — one per transition)
      on_degrade*             (traffic rerouted down the degradation ladder:
                               to cache_only/fallback, reason; throttled)
      on_quality_window*      (obs.quality: one per role per closed window —
                               coverage, novelty, surprisal, popularity,
                               intra-list diversity, score entropy/margin,
                               online prequential hitrate/MRR/NDCG and the
                               PSI drift state)
      on_drift_warning*       (PSI crossed the drift threshold on some series;
                               latched — one warning per excursion, throttled)
    on_serve_end              (request totals, cache hit rate, batch fill
                               ratio, queue-wait stats, shed/deadline-miss/
                               degradation totals, breaker stats, serve
                               goodput)

and the fleet router (``serve/fleet.py``) one level above that::

    on_fleet_start            (replica ids, vnodes, hedge/backoff config)
      on_replica_health*      (one per health transition: replica, from, to,
                               reason — heartbeat/gauge driven)
      on_failover*            (a replica declared dead: replica, reason,
                               ~fraction of users rerouted)
      on_hedge*               (a slow request raced on a second replica:
                               user, primary, hedge target)
    on_fleet_end              (request/reroute/retry/hedge totals, per-replica
                               routing counts, router-observed p50/p99)

Every event flattens to one JSON-able dict (``event`` + ``time`` + optional
``step``/``epoch`` + the payload), so a run directory's ``events.jsonl`` is a
self-describing artifact. :class:`TensorBoardLogger` writes scalars and
histograms through tensorboardX or ``torch.utils.tensorboard`` where either is
installed; with neither it warns once and drops every event, as the JAX
sink does.
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Mapping, Optional, Sequence

logger = logging.getLogger("replay_tpu_torch")


def _jsonable(value: Any) -> Any:
    """Coerce numpy / torch scalars and containers into plain, STRICT JSON
    types. Non-finite floats become null: shape-stable keys survive, and the
    emitted lines stay valid RFC-8259 JSON (the bare ``NaN`` token is not)."""
    if isinstance(value, Mapping):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, float):
        return value if math.isfinite(value) else None
    if isinstance(value, (str, bool, int)) or value is None:
        return value
    # numpy / torch scalars and 0-d arrays expose item(); arrays expose tolist()
    if hasattr(value, "item") and getattr(value, "ndim", None) in (0, None):
        try:
            return _jsonable(value.item())
        except (TypeError, ValueError):
            pass
    if hasattr(value, "tolist"):
        try:
            return _jsonable(value.tolist())
        except (TypeError, ValueError):
            pass
    return str(value)


@dataclass
class TrainerEvent:
    """One observation from a training run.

    ``payload`` keys flatten into the record next to ``event``/``time``/
    ``step``/``epoch``, so consumers index events.jsonl lines by plain keys.
    """

    event: str
    step: Optional[int] = None
    epoch: Optional[int] = None
    time: float = field(default_factory=time.time)
    payload: Dict[str, Any] = field(default_factory=dict)

    def to_record(self) -> Dict[str, Any]:
        record: Dict[str, Any] = {"event": self.event, "time": self.time}
        if self.step is not None:
            record["step"] = int(self.step)
        if self.epoch is not None:
            record["epoch"] = int(self.epoch)
        for key, value in self.payload.items():
            record[str(key)] = _jsonable(value)
        return record


class RunLogger:
    """Protocol for event sinks. Subclasses implement :meth:`log_event`;
    :meth:`close` is optional (flush/teardown). Usable as a context manager."""

    def log_event(self, event: TrainerEvent) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self) -> "RunLogger":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()


class JsonlLogger(RunLogger):
    """One JSON line per event, appended to ``run_dir/filename``.

    Lines are flushed as written so a crashed run keeps its telemetry. The
    same sink doubles as a raw-record writer (:meth:`log_record`) for
    artifacts that are single records rather than event streams
    (``mode="w"``).

    Thread-safe: the serve stack emits from client threads (``on_shed``/
    ``on_breaker``) concurrently with the worker's ``on_serve_batch``, so each
    line is serialized first and written in one locked call — concurrent
    emits can interleave lines, never tear one.

    Bounded growth (week-long runs, the serving service): ``max_bytes``
    enables size-based rotation — when appending a line would push the file
    past the bound, ``events.jsonl`` rotates to ``events.jsonl.1`` (existing
    backups shift up, the oldest beyond ``rotate`` is dropped) and a fresh
    file continues the stream. ``obs.report`` reads the rotated shards oldest-
    first, so a rotated run still summarizes as one stream (minus whatever the
    bound evicted). A single record is never split across shards.

    Multi-host runs: pass this process's ``process_index`` and non-zero
    processes write ``events.p<i>.jsonl`` next to process 0's ``events.jsonl``
    — the shard layout ``obs.report`` merges into one cross-host report (each
    record additionally carries its ``process_index`` stamp).
    """

    def __init__(
        self,
        run_dir: str,
        filename: str = "events.jsonl",
        mode: str = "a",
        max_bytes: Optional[int] = None,
        rotate: int = 3,
        process_index: Optional[int] = None,
    ) -> None:
        self.run_dir = str(run_dir)
        os.makedirs(self.run_dir, exist_ok=True)
        if process_index:
            root, ext = os.path.splitext(filename)
            filename = f"{root}.p{int(process_index)}{ext}"
        self.path = os.path.join(self.run_dir, filename)
        if max_bytes is not None and max_bytes < 1:
            msg = "max_bytes must be a positive byte bound (or None)"
            raise ValueError(msg)
        if rotate < 1:
            msg = "rotate must keep at least one backup shard"
            raise ValueError(msg)
        self.max_bytes = max_bytes
        self.rotate = int(rotate)
        self._fh = open(self.path, mode)
        self._lock = threading.Lock()

    def _rotate_locked(self) -> None:
        """Shift ``path.(i)`` → ``path.(i+1)`` (oldest dropped) and reopen a
        fresh base file. Caller holds the lock."""
        self._fh.close()
        for index in range(self.rotate - 1, 0, -1):
            source = f"{self.path}.{index}"
            if os.path.exists(source):
                os.replace(source, f"{self.path}.{index + 1}")
        os.replace(self.path, f"{self.path}.1")
        self._fh = open(self.path, "a")

    def log_record(self, record: Mapping[str, Any]) -> None:
        line = json.dumps(_jsonable(record), allow_nan=False) + "\n"
        with self._lock:
            if (
                self.max_bytes is not None
                and self._fh.tell() > 0
                and self._fh.tell() + len(line) > self.max_bytes
            ):
                self._rotate_locked()
            self._fh.write(line)
            self._fh.flush()

    def log_event(self, event: TrainerEvent) -> None:
        self.log_record(event.to_record())

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()


def _load_summary_writer():
    """Resolve a TensorBoard SummaryWriter class, or None when no backend is
    installed (tensorboardX, then torch's bundled writer)."""
    try:
        from tensorboardX import SummaryWriter

        return SummaryWriter
    except ImportError:
        pass
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter
    except ImportError:
        return None


class TensorBoardLogger(RunLogger):
    """Scalar + histogram writer over an optional TensorBoard backend.

    Missing backend → a warning once, then every call is a no-op: attaching
    this logger can never break a training run. ``health`` payloads
    (:mod:`.health`) are routed specially: scalar leaves become ``health/...``
    scalars, vector leaves (per-head attention entropies) become histograms
    via :meth:`log_histogram`.
    """

    def __init__(self, log_dir: str) -> None:
        self.log_dir = str(log_dir)
        writer_cls = _load_summary_writer()
        if writer_cls is None:
            logger.warning(
                "TensorBoardLogger: no tensorboard backend installed "
                "(tensorboardX or torch); events will be dropped"
            )
            self._writer = None
        else:
            self._writer = writer_cls(self.log_dir)

    @staticmethod
    def _scalars(payload: Mapping[str, Any]):
        """Numeric payload entries, flattening one dict level — the trainer
        nests epoch/validation metrics under a ``record`` key."""
        for key, value in payload.items():
            if isinstance(value, Mapping):
                for sub_key, sub_value in value.items():
                    if not isinstance(sub_value, bool) and isinstance(sub_value, (int, float)):
                        yield f"{key}/{sub_key}", sub_value
            elif not isinstance(value, bool) and isinstance(value, (int, float)):
                yield key, value

    def log_histogram(self, tag: str, values: Any, step: int = 0) -> None:
        """Write one histogram; a no-op when no backend (or a writer without
        ``add_histogram``) is installed — the scalar path's contract."""
        if self._writer is None or not hasattr(self._writer, "add_histogram"):
            return
        import numpy as np

        array = np.asarray(values, dtype=np.float64).reshape(-1)
        array = array[np.isfinite(array)]
        if array.size:
            self._writer.add_histogram(tag, array, global_step=int(step))

    def _log_health(self, health: Mapping[str, Any], step: int) -> None:
        from .health import flatten_health

        for tag, value in flatten_health(health).items():
            if isinstance(value, (list, tuple)):
                self.log_histogram(tag, value, step)
            elif not isinstance(value, bool) and isinstance(value, (int, float)):
                self._writer.add_scalar(tag, float(value), global_step=step)

    def log_event(self, event: TrainerEvent) -> None:
        if self._writer is None:
            return
        step = int(event.step) if event.step is not None else 0
        # `health` is routed whole through _log_health (scalars + histograms);
        # letting _scalars flatten it too would double-log its top level
        payload = {k: v for k, v in event.payload.items() if k != "health"}
        for key, value in self._scalars(payload):
            tag = key if event.event == "on_train_step" else f"{event.event}/{key}"
            self._writer.add_scalar(tag, float(value), global_step=step)
        health = event.payload.get("health")
        if isinstance(health, Mapping) and event.event == "on_train_step":
            # epoch-end events repeat the last fetched record: logging it again
            # would double-count the histogram timeline
            self._log_health(health, step)

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()


class MultiLogger(RunLogger):
    """Fan one event stream out to several sinks."""

    def __init__(self, loggers: Iterable[RunLogger]) -> None:
        self.loggers: Sequence[RunLogger] = tuple(loggers)

    def log_event(self, event: TrainerEvent) -> None:
        for sink in self.loggers:
            sink.log_event(event)

    def close(self) -> None:
        for sink in self.loggers:
            sink.close()


class ConsoleLogger(RunLogger):
    """``fit``'s ``log_every`` print path on the event stream: every
    ``every``-th received train-step event and every resilience event go to
    the python logger (``fit`` filters the stream to the requested cadence
    when the console is the only sink, so counting received events is exact)."""

    def __init__(self, every: int = 100) -> None:
        self.every = max(int(every), 1)
        self._seen = 0

    def log_event(self, event: TrainerEvent) -> None:
        if event.event == "on_train_step":
            self._seen += 1
            if self._seen % self.every == 0:
                logger.info(
                    "epoch %s step %s loss %.4f", event.epoch, event.step, event.payload.get("loss", float("nan"))
                )
        elif event.event == "on_health_warning":
            logger.warning(
                "health warning at step %s: %s blew up to %.3g (%.1fx its EWMA %.3g)",
                event.step,
                event.payload.get("signal"),
                event.payload.get("value", float("nan")),
                event.payload.get("factor", float("nan")),
                event.payload.get("ewma", float("nan")),
            )
        elif event.event == "on_slo_violation":
            logger.warning(
                "SLO violation [%s] at step %s: %s = %.4g (breached %s %.4g, %s consecutive)",
                event.payload.get("rule"),
                event.step,
                event.payload.get("metric"),
                event.payload.get("value", float("nan")),
                event.payload.get("op"),
                event.payload.get("threshold", float("nan")),
                event.payload.get("consecutive"),
            )
        elif event.event == "on_slo_recovery":
            logger.info(
                "SLO recovered [%s] at step %s: %s = %.4g after %.2fs in breach (%s evaluation(s))",
                event.payload.get("rule"),
                event.step,
                event.payload.get("metric"),
                event.payload.get("value", float("nan")),
                event.payload.get("breach_seconds", float("nan")),
                event.payload.get("breached_evaluations"),
            )
        elif event.event == "on_anomaly":
            logger.warning(
                "anomaly at step %s: non-finite loss/grads, update skipped (%s consecutive)",
                event.step,
                event.payload.get("consecutive_bad"),
            )
        elif event.event == "on_recovery":
            logger.warning(
                "recovery (%s): rolled back to step %s, lr scale %s, restart %s",
                event.payload.get("reason"),
                event.payload.get("restored_step"),
                event.payload.get("lr_scale"),
                event.payload.get("restarts"),
            )
        elif event.event == "on_preemption":
            logger.warning(
                "preemption (%s) at step %s: checkpoint saved, exiting", event.payload.get("signal"), event.step
            )
        elif event.event == "on_shed":
            logger.warning(
                "overload: %s request(s) shed on lane %s (depth %s/%s)",
                event.payload.get("count", 1),
                event.payload.get("lane"),
                event.payload.get("depth"),
                event.payload.get("max_depth"),
            )
        elif event.event == "on_breaker":
            logger.warning(
                "circuit breaker %s -> %s (%s consecutive failure(s))",
                event.payload.get("from"),
                event.payload.get("to"),
                event.payload.get("consecutive_failures"),
            )
        elif event.event == "on_degrade":
            logger.warning(
                "degraded: %s request(s) rerouted to %s (%s)",
                event.payload.get("count", 1),
                event.payload.get("to"),
                event.payload.get("reason"),
            )
        elif event.event == "on_replica_health":
            to_state = event.payload.get("to")
            emit = logger.warning if to_state in ("degraded", "dead") else logger.info
            emit(
                "fleet replica %s: %s -> %s (%s)",
                event.payload.get("replica"),
                event.payload.get("from"),
                to_state,
                event.payload.get("reason"),
            )
        elif event.event == "on_failover":
            logger.warning(
                "fleet failover: replica %s dead (%s) — ~%.0f%% of users "
                "rerouted along the ring",
                event.payload.get("replica"),
                event.payload.get("reason"),
                100.0 * (event.payload.get("users_fraction") or 0.0),
            )
        elif event.event == "on_hedge":
            logger.warning(
                "fleet hedge: user %s slow on %s — racing %s",
                event.payload.get("user_id"),
                event.payload.get("primary"),
                event.payload.get("hedge"),
            )
        elif event.event == "on_fleet_start":
            logger.info(
                "fleet up: %s replica(s) %s (vnodes=%s, hedge_ms=%s, "
                "max_retries=%s)",
                len(event.payload.get("replicas") or ()),
                event.payload.get("replicas"),
                event.payload.get("vnodes"),
                event.payload.get("hedge_ms"),
                event.payload.get("max_retries"),
            )
        elif event.event == "on_fleet_end":
            logger.info(
                "fleet down: %s request(s) on %s replica(s) — %s rerouted, "
                "%s retried, %s hedged (%s won), p99 %.1f ms",
                event.payload.get("requests"),
                event.payload.get("replicas"),
                event.payload.get("reroutes"),
                event.payload.get("retries"),
                event.payload.get("hedges"),
                event.payload.get("hedge_wins"),
                event.payload.get("p99_ms") or 0.0,
            )
        elif event.event == "on_swap":
            logger.info(
                "weight swap (%s): generation %s -> %s%s",
                event.payload.get("reason"),
                event.payload.get("from_generation"),
                event.payload.get("to_generation"),
                " [recompiled]" if event.payload.get("recompiled") else "",
            )
        elif event.event == "on_promotion":
            logger.info(
                "canary PROMOTED: generation %s (from %s) after %s clean "
                "evaluation(s)",
                event.payload.get("generation"),
                event.payload.get("from_generation"),
                event.payload.get("clean_evals"),
            )
        elif event.event == "on_rollback":
            logger.warning(
                "canary ROLLED BACK: generation %s -> %s (rules: %s)",
                event.payload.get("generation"),
                event.payload.get("restored_generation"),
                ", ".join(event.payload.get("rules") or []) or "<manual>",
            )
        elif event.event == "on_quality_window":
            drift = event.payload.get("drift") or {}
            logger.info(
                "quality[%s] @%s req: hitrate@%s %.4f (cum %.4f, %s joins), "
                "coverage %.3f, novelty %.3f, surprisal %.3f, ild %.3f, "
                "drift psi %.3f",
                event.payload.get("role"),
                event.payload.get("requests"),
                event.payload.get("k"),
                event.payload.get("online_hitrate") or 0.0,
                event.payload.get("online_hitrate_cum") or 0.0,
                event.payload.get("joins"),
                event.payload.get("coverage") or 0.0,
                event.payload.get("novelty") or 0.0,
                event.payload.get("surprisal") or 0.0,
                event.payload.get("ild") or 0.0,
                (drift.get("max") if isinstance(drift, Mapping) else None) or 0.0,
            )
        elif event.event == "on_drift_warning":
            logger.warning(
                "DRIFT: psi %.3f on %s series crossed %.2f (max %.3f) — "
                "serving distribution shifted",
                event.payload.get("psi") or 0.0,
                event.payload.get("series"),
                event.payload.get("threshold") or 0.0,
                event.payload.get("psi_max") or 0.0,
            )
        elif event.event == "on_epoch_end":
            logger.info("epoch %s: %s", event.epoch, event.payload.get("record"))
        elif event.event == "on_serve_end":
            logger.info(
                "serve complete: %s request(s), cache hit rate %.1f%%, "
                "batch fill %.1f%%, mean queue wait %.2f ms",
                event.payload.get("requests"),
                100.0 * (event.payload.get("cache_hit_rate") or 0.0),
                100.0 * (event.payload.get("batch_fill_ratio") or 0.0),
                event.payload.get("queue_wait_ms_mean") or 0.0,
            )
        elif event.event == "on_fit_end":
            summary = {k: event.payload.get(k) for k in ("telemetry", "peak_memory_bytes") if k in event.payload}
            logger.info("fit complete: %s", summary)
