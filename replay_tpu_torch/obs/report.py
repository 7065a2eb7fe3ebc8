"""Run-report CLI: summarize a run's ``events.jsonl`` (+ ``trace.json``).

Copied from ``replay_tpu/obs/report.py`` (stdlib only): the port's runs write
the JAX package's event records, so either package's report reads either
package's run directory and renders the same bytes.

::

    python -m replay_tpu_torch.obs.report <run_dir | events.jsonl | BENCH.json>
    python -m replay_tpu_torch.obs.report runs/exp2 --compare runs/exp1 --threshold 0.1

Turns the telemetry artifacts every trainer/bench/dry run leaves behind into
the one-page answer "Demystifying BERT" (PAPERS.md) says a profile must
become: throughput, MFU, the goodput breakdown (where wall-clock went between
steps), the DEVICE-time attribution (obs.profile: per-``named_scope`` on-chip
time from a profiled fit) and per-program roofline records (obs.roofline:
memory- vs compute-bound, predicted ceiling, HBM footprint, collective
bytes), retraces, bad/recovered steps, the model-health record
(obs.health: per-group norms/update ratios, activation stats, attention
entropy, early warnings), and the serving summary (replay_tpu_torch.serve /
bench_serve.py: QPS, latency percentiles, batch fill, cache hit rate, plus
the resilience rates — shed / deadline-miss / error — with degraded-traffic
counts by ladder rung and breaker state; gated on QPS drops, p99 growth, and
lower-better ``serve_error_rate`` / ``serve_deadline_miss_rate`` rises —
``serve_shed_rate`` gates only when BOTH runs ran the overload phase).
A run directory is read as ONE merged stream: size-rotation backups
(``events.jsonl.N``, oldest first) and multi-host per-process shards
(``events.p<i>.jsonl``) fold together, each record keeping (or inheriting
from its filename) a ``process_index`` stamp — from which the report computes
per-host step time, the cross-host skew and the straggler index
(max/median per-host step time). ``on_slo_violation`` events (obs.slo) are
counted and gated lower-better. ``--compare`` diffs two runs —
either run may be a run directory, a raw ``events.jsonl``, or a single-record
bench JSON (``BENCH_*.json`` / ``BENCH_TPU_SIDECAR.json``) — and exits
non-zero when the candidate regresses beyond ``--threshold`` (relative):
throughput/MFU drops, new retraces, ``peak_memory_bytes`` growth beyond
``--memory-threshold``, ``compile_seconds`` growth beyond
``--compile-threshold``, and per-bench-row throughput (rows with an ``error``
field — by-design OOM evidence — are skipped, not tripped on), so CI can
gate on it. A fleet run's merged ``trace.json`` (serve.fleet distributed
tracing) additionally yields the "tail attribution" section — p50/p99 of
traced requests decomposed into per-hop fractions summing to 1.0 — plus the
slowest-request exemplar trace ids; ``--compare`` gates a hop's p99 SHARE
growing by more than 10 points even when p99 itself is flat.

Import-light by design (stdlib only): the CLI must run in seconds with no
torch or device involvement, and a malformed artifact must fail loudly (non-zero
exit) rather than render a partial report — CI uses that as the "our own
artifacts still parse" check.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from .trace import GOODPUT_SPANS, SERVE_GOODPUT_SPANS, tail_attribution

__all__ = [
    "compare_runs",
    "load_events",
    "load_trace_events",
    "main",
    "render",
    "straggler_summary",
    "summarize_run",
]


def _finite(value: Any) -> Optional[float]:
    """``value`` as a finite float, else None (events.jsonl writes NaN as null)."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return None
    value = float(value)
    return value if math.isfinite(value) else None


# --------------------------------------------------------------------------- #
# loading
# --------------------------------------------------------------------------- #
def _with_rotations(path: str) -> List[str]:
    """``path`` preceded by its size-rotation backups, oldest first
    (``events.jsonl.3``, ``.2``, ``.1``, then ``events.jsonl`` — the order
    :class:`~replay_tpu_torch.obs.events.JsonlLogger(max_bytes=...)` wrote them)."""
    import glob

    rotated = []
    for backup in glob.glob(glob.escape(path) + ".*"):
        suffix = backup[len(path) + 1 :]
        if suffix.isdigit():
            rotated.append((int(suffix), backup))
    ordered = [backup for _, backup in sorted(rotated, reverse=True)]
    if os.path.exists(path):
        ordered.append(path)
    return ordered


def _collect_event_files(run_dir: str) -> List[Tuple[str, int]]:
    """Every events shard of a run directory as ``(path, process_index)``,
    in merge order: process 0's rotation chain (``events.jsonl``), then each
    non-zero process's ``events.p<i>.jsonl`` chain — the multi-host layout
    where every process writes its own shard."""
    import glob
    import re

    files: List[Tuple[str, int]] = [
        (path, 0) for path in _with_rotations(os.path.join(run_dir, "events.jsonl"))
    ]
    shard_name = re.compile(r"events\.p(\d+)\.jsonl$")
    shards = []
    for path in glob.glob(os.path.join(glob.escape(run_dir), "events.p*.jsonl")):
        match = shard_name.search(os.path.basename(path))
        if match:
            shards.append((int(match.group(1)), path))
    for index, path in sorted(shards):
        files.extend((chained, index) for chained in _with_rotations(path))
    return files


def _resolve(path: str) -> Tuple[List[Tuple[str, int]], Optional[str]]:
    """([(events path, process index), ...], trace path or None) for a run
    directory or a bare file."""
    if os.path.isdir(path):
        files = _collect_event_files(path)
        if not files:
            msg = f"{path}: no events.jsonl in run directory"
            raise FileNotFoundError(msg)
        trace = os.path.join(path, "trace.json")
        return files, trace if os.path.exists(trace) else None
    return [(path, 0)], None


def load_events(path: str) -> List[Dict[str, Any]]:
    """Records from an ``events.jsonl`` stream or a single-record JSON file."""
    with open(path) as fh:
        text = fh.read()
    records: List[Any]
    try:
        payload = json.loads(text)
        records = [payload] if isinstance(payload, Mapping) else list(payload)
    except ValueError:
        records = []
        for lineno, line in enumerate(text.splitlines(), 1):
            if not line.strip():
                continue
            try:
                records.append(json.loads(line))
            except ValueError as exc:
                msg = f"{path}:{lineno}: invalid JSON ({exc})"
                raise ValueError(msg) from exc
    if not records:
        msg = f"{path}: no records"
        raise ValueError(msg)
    for i, record in enumerate(records):
        if not isinstance(record, Mapping):
            msg = f"{path}: record {i} is not a JSON object"
            raise ValueError(msg)
    return [dict(r) for r in records]


def load_trace_events(path: str) -> List[Dict[str, Any]]:
    """The validated raw ``traceEvents`` list of a Chrome trace-event JSON.

    The validation IS the contract check CI leans on: every event must carry
    ``name``/``ph``/``ts`` and a non-negative duration. Tail attribution needs
    the per-event ``trace_id`` args the name-level aggregation of
    :func:`load_trace` folds away, so the raw list is its own loader.
    """
    with open(path) as fh:
        payload = json.load(fh)
    events = payload.get("traceEvents") if isinstance(payload, Mapping) else payload
    if not isinstance(events, list):
        msg = f"{path}: no traceEvents list"
        raise ValueError(msg)
    for i, event in enumerate(events):
        if not isinstance(event, Mapping) or not all(
            key in event for key in ("name", "ph", "ts")
        ):
            msg = f"{path}: traceEvents[{i}] missing name/ph/ts"
            raise ValueError(msg)
        duration = event.get("dur", 0)
        if not isinstance(duration, (int, float)) or duration < 0:
            msg = f"{path}: traceEvents[{i}] has a negative or non-numeric dur"
            raise ValueError(msg)
    return [dict(e) for e in events]


def _aggregate_trace(events: Sequence[Mapping[str, Any]]) -> Dict[str, Dict[str, float]]:
    spans: Dict[str, Dict[str, float]] = {}
    for event in events:
        if event.get("ph") == "M":
            # metadata (the merged fleet trace's process_name track labels):
            # not a timed span, excluded from the name-level aggregation
            continue
        entry = spans.setdefault(str(event["name"]), {"count": 0, "seconds": 0.0})
        entry["count"] += 1
        entry["seconds"] += float(event.get("dur", 0)) / 1e6
    return spans


def load_trace(path: str) -> Dict[str, Dict[str, float]]:
    """Validate Chrome trace-event JSON and aggregate ``{name: {count, seconds}}``."""
    return _aggregate_trace(load_trace_events(path))


# --------------------------------------------------------------------------- #
# summarizing
# --------------------------------------------------------------------------- #
def straggler_summary(per_process: Mapping[Any, float]) -> Dict[str, Any]:
    """Cross-host step-time spread from per-process mean step seconds.

    ``straggler_index`` is max/median (1.0 = perfectly balanced; 2.0 = the
    slowest host takes twice the typical step), ``skew`` is the relative
    spread ``(max - min) / median``; ``straggler`` names the slowest process.
    Pure host math — also used by ``dryrun_multichip`` to stamp its record.
    """
    if not per_process:
        msg = "straggler_summary needs at least one process"
        raise ValueError(msg)
    values = sorted(float(v) for v in per_process.values())
    n = len(values)
    median = values[n // 2] if n % 2 else 0.5 * (values[n // 2 - 1] + values[n // 2])
    worst = max(per_process, key=lambda key: float(per_process[key]))
    return {
        "max_step_seconds": values[-1],
        "median_step_seconds": median,
        "straggler": str(worst),
        "straggler_index": values[-1] / median if median > 0 else None,
        "skew": (values[-1] - values[0]) / median if median > 0 else None,
    }


def summarize_run(path: str) -> Dict[str, Any]:
    event_files, trace_path = _resolve(path)
    events: List[Dict[str, Any]] = []
    for events_path, process_index in event_files:
        for record in load_events(events_path):
            if process_index and "process_index" not in record:
                # a shard written before per-record stamping existed: the
                # filename still carries the process identity
                record["process_index"] = process_index
            events.append(record)
    raw_trace = load_trace_events(trace_path) if trace_path else None
    summary = summarize_events(events, source=path)
    if raw_trace is not None:
        trace = _aggregate_trace(raw_trace)
        summary["trace"] = trace
        # total h2d time ACROSS threads: in a chunked run the device feed
        # places chunks on a feeder thread, so most of this never shows up in
        # the fit thread's goodput fractions — the delta IS the overlap win
        if "h2d" in trace:
            summary["h2d_seconds"] = float(trace["h2d"]["seconds"])
        # tail attribution (fleet traces): decompose the slow tail of traced
        # requests into per-hop fractions — None for training traces, whose
        # spans carry no request roots
        attribution = tail_attribution(raw_trace)
        if attribution is not None:
            summary["tail_attribution"] = attribution
    return summary


def summarize_events(
    events: Sequence[Mapping[str, Any]], source: str = ""
) -> Dict[str, Any]:
    """Fold an event stream into one flat summary record (pure host math)."""
    steps = [e for e in events if e.get("event") == "on_train_step"]
    epoch_ends = [e for e in events if e.get("event") == "on_epoch_end"]
    fit_ends = [e for e in events if e.get("event") == "on_fit_end"]
    # bench sidecars are RAW records (log_record, no "event" key); the guard
    # keeps on_slo_violation — whose payload also carries metric+value — out
    bench = [e for e in events if "metric" in e and "value" in e and "event" not in e]
    bench_rows = [e for e in events if e.get("event") == "bench_row"]
    dryruns = [e for e in events if e.get("event") == "dryrun_multichip"]
    serve_ends = [e for e in events if e.get("event") == "on_serve_end"]
    serve_batches = [e for e in events if e.get("event") == "on_serve_batch"]

    summary: Dict[str, Any] = {
        "source": source,
        "events": len(events),
        "kind": (
            "fit"
            if fit_ends or steps
            else (
                "bench"
                if bench or bench_rows
                else (
                    "serve"
                    if serve_ends or serve_batches
                    else ("dryrun" if dryruns else "events")
                )
            )
        ),
        "train_steps": len(steps),
        "epochs": len(epoch_ends),
        "anomalies": sum(1 for e in events if e.get("event") == "on_anomaly"),
        "recoveries": sum(1 for e in events if e.get("event") == "on_recovery"),
        "preemptions": sum(1 for e in events if e.get("event") == "on_preemption"),
        "health_warnings": sum(
            1 for e in events if e.get("event") == "on_health_warning"
        ),
        # the SLO watchdog's transition events (obs.slo): violations are the
        # lower-better --compare gate; recoveries separate transient spikes
        # from breaches that were still open when the run ended
        "slo_violations": sum(
            1 for e in events if e.get("event") == "on_slo_violation"
        ),
        "slo_recoveries": sum(
            1 for e in events if e.get("event") == "on_slo_recovery"
        ),
        # the promotion loop (serve.promote): swaps are routine, rollbacks are
        # the lower-better --compare gate (a healthy continual run rolls
        # nothing back, so ANY candidate rollback against a clean baseline
        # fires — same zero-baseline rule as slo_violations)
        "swaps": sum(1 for e in events if e.get("event") == "on_swap"),
        "promotions": sum(1 for e in events if e.get("event") == "on_promotion"),
        "rollbacks": sum(1 for e in events if e.get("event") == "on_rollback"),
    }
    summary["slo_rules_fired"] = sorted(
        {
            str(e.get("rule"))
            for e in events
            if e.get("event") == "on_slo_violation" and e.get("rule") is not None
        }
    )
    summary["backend"] = next(
        (e["backend"] for e in events if isinstance(e.get("backend"), str)), None
    )

    # the promotion record (canary lifecycle): publishes, the canary verdict
    # trail and the last generation each pointer landed on
    promotion_events = [
        e for e in events
        if e.get("event") in (
            "on_publish", "on_swap", "on_canary_start", "on_canary_eval",
            "on_promotion", "on_rollback",
        )
    ]
    if promotion_events:
        swaps = [e for e in promotion_events if e.get("event") == "on_swap"]
        evals = [e for e in promotion_events if e.get("event") == "on_canary_eval"]
        promotion: Dict[str, Any] = {
            "publishes": sum(
                1 for e in promotion_events if e.get("event") == "on_publish"
            ),
            "recompiled_publishes": sum(
                1 for e in promotion_events
                if e.get("event") == "on_publish" and e.get("recompiled")
            ),
            "canaries": sum(
                1 for e in promotion_events if e.get("event") == "on_canary_start"
            ),
            "canary_evals": len(evals),
            "swaps": summary["swaps"],
            "promotions": summary["promotions"],
            "rollbacks": summary["rollbacks"],
        }
        if swaps:
            promotion["last_generation"] = swaps[-1].get("to_generation")
        if evals:
            last_eval = evals[-1]
            promotion["last_canary_error_rate"] = _finite(
                last_eval.get("error_rate")
            )
            promotion["last_clean_evals"] = last_eval.get("clean_evals")
        rollbacks = [
            e for e in promotion_events if e.get("event") == "on_rollback"
        ]
        if rollbacks:
            promotion["rollback_rules"] = sorted(
                {
                    str(rule)
                    for e in rollbacks
                    for rule in (e.get("rules") or [])
                }
            )
        summary["promotion"] = promotion
    else:
        summary["promotion"] = None

    fit_end = fit_ends[-1] if fit_ends else {}
    telemetry = fit_end.get("telemetry") or {}
    # on-chip observability (obs.profile / obs.roofline): the per-named-scope
    # device-time attribution and per-program roofline records a profiled fit
    # attaches to its terminal event
    summary["device_time"] = (
        dict(fit_end["device_time"]) if isinstance(fit_end.get("device_time"), Mapping) else None
    )
    summary["roofline"] = (
        dict(fit_end["roofline"]) if isinstance(fit_end.get("roofline"), Mapping) else None
    )
    summary["bad_steps"] = fit_end.get("bad_steps")
    if summary["bad_steps"] is None:
        # crashed/killed runs have no on_fit_end: the epoch-end rollup is the
        # next best sentinel evidence
        summary["bad_steps"] = next(
            (e["bad_steps"] for e in reversed(epoch_ends) if "bad_steps" in e), None
        )
    summary["last_grad_norm"] = next(
        (
            value
            for e in reversed(epoch_ends)
            for value in [_finite(e.get("grad_norm"))]
            if value is not None
        ),
        None,
    )

    # the latest model-health record (obs.health): rides on_train_step /
    # on_epoch_end events from health-enabled fits, and dryrun_multichip records
    summary["health"] = next(
        (dict(e["health"]) for e in reversed(list(events)) if isinstance(e.get("health"), Mapping)),
        None,
    )

    # throughput: steady-state fit telemetry > bench headline > step-event mean
    throughput = _finite(telemetry.get("samples_per_sec"))
    steps_per_sec = _finite(telemetry.get("steps_per_sec"))
    throughput_source = "telemetry" if throughput is not None else None
    if throughput is None and bench:
        record = bench[-1]
        if "samples_per_sec" in str(record.get("metric", "")):
            throughput = _finite(record.get("value"))
            throughput_source = "bench"
    if throughput is None and steps:
        rates = [r for r in (_finite(e.get("samples_per_sec")) for e in steps) if r]
        if rates:
            throughput = sum(rates) / len(rates)
            throughput_source = "steps"
    if steps_per_sec is None and steps:
        rates = [r for r in (_finite(e.get("steps_per_sec")) for e in steps) if r]
        if rates:
            steps_per_sec = sum(rates) / len(rates)
    summary["samples_per_sec"] = throughput
    summary["steps_per_sec"] = steps_per_sec
    summary["throughput_source"] = throughput_source

    # multi-host view: per-process mean step time from the merged shards'
    # stamped step events, folded into the skew/straggler record. Only
    # rendered when any step event carries a process stamp — single-process
    # runs stay byte-identical.
    by_process: Dict[int, List[float]] = {}
    stamped = False
    for e in steps:
        if "process_index" in e:
            stamped = True
        step_seconds = _finite(e.get("step_seconds"))
        if step_seconds is not None:
            by_process.setdefault(int(e.get("process_index") or 0), []).append(
                step_seconds
            )
    if stamped and by_process:
        per_process = {
            pid: sum(values) / len(values) for pid, values in by_process.items()
        }
        summary["processes"] = {
            "count": len(per_process),
            "step_seconds": {
                str(pid): value for pid, value in sorted(per_process.items())
            },
            **straggler_summary(per_process),
        }
    else:
        summary["processes"] = None

    losses = [
        value
        for e in epoch_ends
        for value in [_finite((e.get("record") or {}).get("train_loss"))]
        if value is not None
    ]
    summary["final_train_loss"] = losses[-1] if losses else None

    # compile report: {fn: {traces, compile_seconds}} — retraces beyond the
    # one sanctioned trace per jitted fn are the static-shapes leak signal
    compile_report: Mapping[str, Any] = fit_end.get("compile") or {}
    if not compile_report and dryruns:
        compile_report = dryruns[-1].get("compile") or {}
    if compile_report:
        summary["compile"] = dict(compile_report)
        summary["retraces"] = sum(
            max(int(entry.get("traces", 0)) - 1, 0)
            for entry in compile_report.values()
            if isinstance(entry, Mapping)
        )
        summary["compile_seconds"] = sum(
            float(entry.get("compile_seconds", 0.0))
            for entry in compile_report.values()
            if isinstance(entry, Mapping)
        )
    elif bench and _finite(bench[-1].get("compile_seconds")) is not None:
        summary["compile_seconds"] = float(bench[-1]["compile_seconds"])

    # the latest goodput breakdown (epoch-end beats fit-end: fit-end wall
    # includes startup/compile, epoch windows are the steady state)
    goodput = None
    for event in reversed(list(events)):
        if event.get("event") == "on_epoch_end" and isinstance(event.get("goodput"), Mapping):
            goodput = dict(event["goodput"])
            break
    if goodput is None:
        for event in reversed(list(events)):
            if isinstance(event.get("goodput"), Mapping):
                goodput = dict(event["goodput"])
                break
    summary["goodput"] = goodput

    # feed efficiency (docs/performance.md "Feeding the beast"): real vs grid
    # tokens + effective-tokens/s, attached by fit to epoch/fit-end events
    summary["input"] = next(
        (
            dict(e["input"])
            for e in reversed(list(events))
            if isinstance(e.get("input"), Mapping)
        ),
        None,
    )

    if bench:
        record = bench[-1]
        summary["bench"] = {
            key: record.get(key)
            for key in (
                "metric", "value", "unit", "vs_baseline", "backend", "mfu",
                "tflops_per_sec", "step_ms", "dispatch_step_ms", "scan_k",
                "compile_seconds", "device_kind", "source", "stale",
                # the end-to-end Trainer.fit(scan_chunk=...) loop and its
                # variant flags (a fit measured with a different chunk size or
                # the feed disabled must not read as the baseline)
                "fit_samples_per_sec", "fit_step_ms", "fit_scan_chunk",
                "fit_device_feed", "dispatch_gap_closed",
            )
            if key in record
        }
        summary["mfu"] = _finite(record.get("mfu"))
        # first-class so --compare can gate on the PRODUCTION loop's
        # throughput, not only the hand-rolled microbench number
        summary["fit_samples_per_sec"] = _finite(record.get("fit_samples_per_sec"))
    else:
        summary["mfu"] = _finite(fit_end.get("mfu"))
        summary["fit_samples_per_sec"] = None

    # bench_suite.py rows (one bench_row event each): the full measurement
    # batch — surfaced per row so the catalog-scaling family reads as a table
    summary["bench_rows"] = [
        {
            key: record.get(key)
            for key in (
                "row", "samples_per_sec", "step_ms", "scan_k", "mfu",
                "mfu_peak_assumed", "tflops_per_sec", "num_items", "d", "B",
                "L", "loss", "precision", "model_parallel", "backend", "error",
                # streaming-input rows (stream_{inmem,parquet,packed}): the
                # padding-waste and feed-efficiency measurements
                "effective_tokens_per_sec", "padding_fraction",
                "segments_per_row", "rows_on_disk", "shard",
                # the DP×TP×SP long-context rows: attention route, mesh grid
                # and the remat A/B flag the pair gate keys on
                "attention", "mesh", "remat", "ring_max_err",
                # static program analyses (obs.roofline / parallel.introspect)
                "roofline_bound", "roofline_ceiling_tflops",
                "of_roofline_ceiling", "arithmetic_intensity",
                "hbm_peak_bytes", "collective_bytes", "peak_memory_bytes",
            )
            if key in record
        }
        for record in bench_rows
    ] or None

    # the precision ladder's pair view (prec_{f32,bf16}_<head> bench rows):
    # HBM/step deltas per head, the "each rung must move bytes" evidence.
    # Rendered informationally; the CI gate is --compare's per-row lower-
    # better hbm_peak_bytes on prec_* rows. NOTE the strictly-lower-HBM claim
    # is an accelerator claim: a CPU backend materializes f32 converts for bf16
    # programs, so CPU smoke pairs legitimately show no byte win.
    rows_by_name = {
        record.get("row"): record for record in bench_rows if record.get("row")
    }
    pairs: Dict[str, Any] = {}
    for name, row in rows_by_name.items():
        if not name.startswith("prec_bf16_") or row.get("error"):
            continue
        head = name[len("prec_bf16_"):]
        base = rows_by_name.get(f"prec_f32_{head}")
        if not base or base.get("error"):
            continue
        pair: Dict[str, Any] = {
            "f32_hbm_peak_bytes": _finite(base.get("hbm_peak_bytes")),
            "bf16_hbm_peak_bytes": _finite(row.get("hbm_peak_bytes")),
            "f32_step_ms": _finite(base.get("step_ms")),
            "bf16_step_ms": _finite(row.get("step_ms")),
            "backend": row.get("backend"),
        }
        if pair["f32_hbm_peak_bytes"] and pair["bf16_hbm_peak_bytes"] is not None:
            pair["hbm_saved_fraction"] = (
                1.0 - pair["bf16_hbm_peak_bytes"] / pair["f32_hbm_peak_bytes"]
            )
        pairs[head] = pair
    summary["precision_pairs"] = pairs or None

    # the remat pair view (<base>_remat_{off,on} bench rows): activation
    # checkpointing exists to MOVE bytes — the pair is the evidence, and
    # --compare gates remat-on's hbm_peak_bytes below remat-off's (the static
    # memory_analysis holds on CPU too, unlike the bf16 byte claim)
    remat_pairs: Dict[str, Any] = {}
    for name, row in rows_by_name.items():
        if not name.endswith("_remat_on") or row.get("error"):
            continue
        base_name = name[: -len("_remat_on")]
        base = rows_by_name.get(f"{base_name}_remat_off")
        if not base or base.get("error"):
            continue
        pair = {
            "off_hbm_peak_bytes": _finite(base.get("hbm_peak_bytes")),
            "on_hbm_peak_bytes": _finite(row.get("hbm_peak_bytes")),
            "off_step_ms": _finite(base.get("step_ms")),
            "on_step_ms": _finite(row.get("step_ms")),
            "backend": row.get("backend"),
        }
        if pair["off_hbm_peak_bytes"] and pair["on_hbm_peak_bytes"] is not None:
            pair["hbm_saved_fraction"] = (
                1.0 - pair["on_hbm_peak_bytes"] / pair["off_hbm_peak_bytes"]
            )
        remat_pairs[base_name] = pair
    summary["remat_pairs"] = remat_pairs or None

    # peak device memory: fit telemetry first, then the bench record, then the
    # largest non-error suite row — the --compare lower-better gate's input
    peak_memory = _finite(fit_end.get("peak_memory_bytes"))
    if peak_memory is None and bench:
        peak_memory = _finite(bench[-1].get("peak_memory_bytes"))
    if peak_memory is None and bench_rows:
        row_peaks = [
            value
            for row in bench_rows
            if not row.get("error")
            for value in [_finite(row.get("peak_memory_bytes"))]
            if value is not None
        ]
        peak_memory = max(row_peaks) if row_peaks else None
    summary["peak_memory_bytes"] = peak_memory

    if dryruns:
        record = dryruns[-1]
        summary["dryrun"] = {
            key: record.get(key)
            for key in (
                "mesh", "losses", "psum", "sp_ring_err", "spans", "backend",
                "collectives", "sharding", "processes", "mesh3",
            )
            if key in record
        }
        if summary["processes"] is None and isinstance(
            record.get("processes"), Mapping
        ):
            # the dry run measures its per-process timing directly (it emits
            # no per-step events): surface its skew record at the top level
            # so the straggler gate reads dry runs and real fits identically
            summary["processes"] = dict(record["processes"])

    # the serving summary (replay_tpu_torch.serve): service-side totals from the
    # on_serve_end event, load-side qps/latency percentiles from the
    # bench_serve.py record — either alone still renders a section
    serve: Dict[str, Any] = {}
    if serve_ends:
        record = serve_ends[-1]
        serve.update(
            {
                key: record.get(key)
                for key in (
                    "mode", "requests", "answered", "errors", "cache_hit_rate",
                    "pure_hit_rate", "batch_fill_ratio", "queue_wait_ms_mean",
                    "queue_wait_ms_max",
                    # resilience totals (overload/chaos accounting)
                    "shed", "deadline_misses", "cancelled", "circuit_refusals",
                    "degraded", "shed_rate", "deadline_miss_rate", "error_rate",
                )
                if key in record
            }
        )
        if isinstance(record.get("served_by"), Mapping):
            serve["served_by"] = dict(record["served_by"])
        if isinstance(record.get("breaker"), Mapping):
            serve["breaker"] = dict(record["breaker"])
        serve["batches"] = len(serve_batches)
        resilience_counts = {"on_shed": 0, "on_breaker": 0, "on_degrade": 0}
        for e in events:
            name = e.get("event")
            if name in resilience_counts:
                resilience_counts[name] += 1
        serve["shed_events"] = resilience_counts["on_shed"]
        serve["breaker_events"] = resilience_counts["on_breaker"]
        serve["degrade_events"] = resilience_counts["on_degrade"]
    if bench and "serve" in str(bench[-1].get("metric", "")):
        record = bench[-1]
        serve.update(
            {
                key: record.get(key)
                for key in (
                    "qps", "p50_ms", "p95_ms", "p99_ms", "batch_fill_ratio",
                    "cache_hit_rate", "closed_loop_qps", "requests", "mode",
                    "hung_requests",
                )
                if key in record
            }
        )
        # the run-wide rates the --compare lower-better gates consume; the
        # bench record's numbers win over on_serve_end (same totals, rounded)
        for bench_key, serve_key in (
            ("serve_shed_rate", "shed_rate"),
            ("serve_deadline_miss_rate", "deadline_miss_rate"),
            ("serve_error_rate", "error_rate"),
        ):
            if _finite(record.get(bench_key)) is not None:
                serve[serve_key] = float(record[bench_key])
        if isinstance(record.get("served_by"), Mapping):
            serve["served_by"] = dict(record["served_by"])
        if isinstance(record.get("breaker"), Mapping):
            serve["breaker"] = dict(record["breaker"])
        overload = record.get("overload")
        if isinstance(overload, Mapping):
            # the overload flag gates shed-rate comparability: shed rates only
            # mean the same thing between two runs that both ran overload
            serve["overload"] = True
            serve["overload_p99_ms"] = _finite(overload.get("p99_ms"))
            serve["overload_shed_rate"] = _finite(overload.get("shed_rate"))
            serve["overload_deadline_miss_rate"] = _finite(
                overload.get("deadline_miss_rate")
            )
        quant = record.get("quant")
        if isinstance(quant, Mapping):
            # the int8-vs-f32 retrieval A/B (precision ladder's serving
            # rung): recall/topk-match are --compare higher-better gates
            serve["quant"] = {
                key: quant.get(key)
                for key in (
                    "candidates", "top_k", "recall_at_candidates",
                    "topk_match_rate", "f32_rank_ms", "int8_rank_ms",
                    "int8_table_bytes", "f32_table_bytes", "bytes_ratio",
                )
                if key in quant
            }
        ann = record.get("ann")
        if isinstance(ann, Mapping):
            # the IVF sub-linear retrieval phase: recall@100 / topk agreement
            # are --compare higher-better gates (0.005 abs floor, the quant
            # convention); ann_qps is higher-better; the speedup line renders
            # brute-vs-IVF throughput on the same catalog
            serve["ann"] = {
                key: ann.get(key)
                for key in (
                    "items", "dim", "nlist", "nprobe", "cmax",
                    "scanned_fraction", "recall_at_100", "topk_agreement",
                    "ivf_qps", "brute_qps", "speedup", "build_s",
                    "recall_at_100_int8", "recall_at_100_pq",
                    "index_total_bytes", "projection_100m",
                )
                if key in ann
            }
        chaos = record.get("chaos")
        if isinstance(chaos, Mapping):
            serve["chaos"] = {
                key: chaos.get(key)
                for key in (
                    "injected_engine_errors", "breaker_opens",
                    "breaker_state_final", "recovered", "hung_requests",
                    "storm_deadline_missed",
                )
                if key in chaos
            }
        swap = record.get("swap")
        if isinstance(swap, Mapping):
            # the swap-under-load phase (serve.promote): the swap flag gates
            # swap_p99_ms comparability exactly like overload gates shed rate
            serve["swap"] = True
            serve["swap_count"] = swap.get("swaps")
            serve["swap_p99_ms"] = _finite(swap.get("p99_ms"))
            serve["swap_errors"] = swap.get("errors")
            serve["swap_generations"] = swap.get("generations_seen")
            serve["swap_recompiled"] = swap.get("recompiled_swaps")
    summary["serve"] = serve or None

    # the quality plane (obs.quality): the last on_quality_window per role is
    # the run's final windowed telemetry; drift warnings sum their coalesced
    # counts; the bench drift-phase record (bench_serve.py) carries the
    # injected-shift evidence the drift_psi --compare gate is phase-matched on
    quality_windows = [e for e in events if e.get("event") == "on_quality_window"]
    drift_warning_events = [
        e for e in events if e.get("event") == "on_drift_warning"
    ]
    quality: Dict[str, Any] = {}
    if quality_windows or drift_warning_events:
        quality["windows"] = len(quality_windows)
        quality["drift_warnings"] = sum(
            int(e.get("count") or 1) for e in drift_warning_events
        )
        roles: Dict[str, Any] = {}
        for e in quality_windows:
            roles[str(e.get("role") or "stable")] = {
                key: e.get(key)
                for key in (
                    "requests", "k", "joins", "coverage", "novelty",
                    "surprisal", "popularity", "ild", "score_entropy",
                    "top1_margin", "online_hitrate", "online_mrr",
                    "online_ndcg", "online_hitrate_cum", "online_mrr_cum",
                    "online_ndcg_cum",
                )
                if key in e
            }
        quality["roles"] = roles
        # the stable slice's cumulative prequential metrics at the top level:
        # what the higher-better online_hitrate gate reads
        stable = roles.get("stable") or next(iter(roles.values()), {})
        for key in (
            "k", "joins", "online_hitrate_cum", "online_mrr_cum",
            "online_ndcg_cum",
        ):
            if stable.get(key) is not None:
                quality[key] = stable.get(key)
        psi_values = [
            value
            for e in quality_windows
            if isinstance(e.get("drift"), Mapping)
            for value in (_finite(e["drift"].get("max")),)
            if value is not None
        ]
        if psi_values:
            quality["drift_psi"] = psi_values[-1]
            quality["drift_psi_peak"] = max(psi_values)
        if drift_warning_events:
            quality["drift_series"] = sorted(
                {
                    str(e.get("series"))
                    for e in drift_warning_events
                    if e.get("series") is not None
                }
            )
    if bench and "serve" in str(bench[-1].get("metric", "")):
        drift_record = bench[-1].get("drift")
        if isinstance(drift_record, Mapping):
            # the injected preference-shift phase ran: psi/violations are
            # meaningful and the lower-better drift_psi gate may apply
            quality["drift_phase"] = True
            for src, dst in (
                ("slo_violations", "drift_slo_violations"),
                ("warnings", "drift_phase_warnings"),
                ("psi_peak", "drift_psi_peak"),
                ("shift_fraction", "drift_shift_fraction"),
            ):
                if drift_record.get(src) is not None:
                    quality[dst] = drift_record.get(src)
    summary["quality"] = quality or None

    # the fleet summary (serve.fleet): router-level health/failover/hedge
    # events plus the bench_fleet.py record — per-replica serve totals come
    # from the merged per-replica event shards (each replica logs through
    # JsonlLogger(process_index=i), the multi-host shard machinery reused
    # one level up)
    health_events = [e for e in events if e.get("event") == "on_replica_health"]
    failover_events = [e for e in events if e.get("event") == "on_failover"]
    hedge_events = [e for e in events if e.get("event") == "on_hedge"]
    fleet_ends = [e for e in events if e.get("event") == "on_fleet_end"]
    fleet_bench = bench[-1] if bench and "fleet" in str(bench[-1].get("metric", "")) else None
    fleet: Dict[str, Any] = {}
    if health_events or failover_events or fleet_ends or fleet_bench is not None:
        fleet["health_transitions"] = len(health_events)
        fleet["failover_events"] = len(failover_events)
        fleet["hedge_events"] = len(hedge_events)
        by_replica: Dict[str, List[str]] = {}
        for e in health_events:
            replica = str(e.get("replica"))
            by_replica.setdefault(replica, []).append(
                f"{e.get('from')}->{e.get('to')}"
                + (f"({e.get('reason')})" if e.get("reason") else "")
            )
        if by_replica:
            fleet["replica_transitions"] = {
                replica: moves for replica, moves in sorted(by_replica.items())
            }
        if fleet_ends:
            record = fleet_ends[-1]
            for key in (
                "replicas", "requests", "answered", "errors", "reroutes",
                "retries", "hedges", "hedge_wins", "hedge_cancelled",
                "failovers", "reroute_rate", "error_rate", "p50_ms", "p99_ms",
            ):
                if _finite(record.get(key)) is not None:
                    fleet[key] = record.get(key)
        # per-replica serve totals from the merged shards: each replica's own
        # on_serve_end, keyed by its shard's process_index — renamed to the
        # replica id when the bench record carries the shard map
        shard_names: Dict[str, str] = {}
        if fleet_bench is not None and isinstance(
            fleet_bench.get("replica_shards"), Mapping
        ):
            shard_names = {
                str(k): str(v) for k, v in fleet_bench["replica_shards"].items()
            }
        per_replica: Dict[str, Any] = {}
        for e in serve_ends:
            pid = e.get("process_index")
            if pid is None:
                continue
            per_replica[shard_names.get(str(pid), str(pid))] = {
                key: e.get(key)
                for key in (
                    "requests", "answered", "cache_hit_rate", "error_rate",
                    "shed", "degraded",
                )
                if key in e
            }
        if fleet_ends:
            # per-replica ROUTER counters from the final fleet stats: hedges
            # LANDED on each replica as the racing twin, hedge wins/cancels,
            # and retries each replica's refusals caused — merged into the
            # same per-replica map the serve-side shards fill ("answered"
            # stays serve-side: the router's count excludes lost hedge twins)
            router_stats = fleet_ends[-1].get("per_replica")
            if isinstance(router_stats, Mapping):
                for replica, stats in router_stats.items():
                    if not isinstance(stats, Mapping):
                        continue
                    dest = per_replica.setdefault(str(replica), {})
                    for key in (
                        "routed", "hedges", "hedge_wins", "hedge_cancelled",
                        "retries",
                    ):
                        if _finite(stats.get(key)) is not None:
                            dest[key] = stats.get(key)
            # the exemplar store: the slowest answered requests with their
            # trace ids — the report's link from "p99 is slow" to the exact
            # timelines in the merged trace.json
            exemplars = fleet_ends[-1].get("latency_exemplars")
            if isinstance(exemplars, (list, tuple)) and exemplars:
                fleet["latency_exemplars"] = [
                    {
                        "latency_ms": e.get("latency_ms"),
                        "trace_id": e.get("trace_id"),
                    }
                    for e in exemplars
                    if isinstance(e, Mapping)
                ]
        if per_replica:
            fleet["per_replica"] = per_replica
        if fleet_bench is not None:
            for key in (
                "qps", "p50_ms", "p99_ms", "replicas", "requests",
                "reroutes", "reroute_rate", "cache_hit_locality",
                "failover_gap_ms", "hung_requests", "fleet_error_rate",
                "single_replica_qps", "single_replica_hit_rate",
            ):
                if fleet_bench.get(key) is not None:
                    fleet[key] = fleet_bench.get(key)
            chaos = fleet_bench.get("chaos")
            if isinstance(chaos, Mapping):
                fleet["chaos"] = {
                    key: chaos.get(key)
                    for key in (
                        "killed", "revived", "failover_gap_ms", "reroutes",
                        "hung_requests", "error_rate", "failover_answers",
                        "failover_served_by", "exemplar_trace_ids",
                    )
                    if key in chaos
                }
            drain_swap = fleet_bench.get("drain_swap")
            if isinstance(drain_swap, Mapping):
                fleet["drain_swap"] = {
                    key: drain_swap.get(key)
                    for key in (
                        "replicas_swapped", "drained", "errors", "generations",
                        "p99_ms",
                    )
                    if key in drain_swap
                }
            per_replica_bench = fleet_bench.get("per_replica")
            if isinstance(per_replica_bench, Mapping):
                for replica, stats in per_replica_bench.items():
                    if isinstance(stats, Mapping):
                        fleet.setdefault("per_replica", {}).setdefault(
                            str(replica), {}
                        ).update(stats)
    summary["fleet"] = fleet or None
    return summary


# --------------------------------------------------------------------------- #
# rendering
# --------------------------------------------------------------------------- #
def _fmt(value: Optional[float], pattern: str = "{:.1f}", missing: str = "–") -> str:
    return pattern.format(value) if value is not None else missing


def render(summary: Mapping[str, Any]) -> str:
    lines = [f"Run report — {summary.get('source') or '<events>'}"]
    backend = f" · backend={summary['backend']}" if summary.get("backend") else ""
    lines.append(
        f"  kind: {summary.get('kind')} · events: {summary.get('events')}{backend}"
    )
    throughput = summary.get("samples_per_sec")
    if throughput is not None or summary.get("steps_per_sec") is not None:
        source = summary.get("throughput_source")
        lines.append(
            "  throughput: "
            f"{_fmt(throughput)} samples/sec"
            f" ({_fmt(summary.get('steps_per_sec'), '{:.2f}')} steps/sec)"
            + (f" [{source}]" if source else "")
            + (f" · MFU {_fmt(summary.get('mfu'), '{:.3f}')}" if summary.get("mfu") is not None else "")
        )
    if summary.get("train_steps") or summary.get("epochs"):
        lines.append(
            f"  training: {summary.get('epochs', 0)} epoch(s) · "
            f"{summary.get('train_steps', 0)} step event(s) · "
            f"final train_loss { _fmt(summary.get('final_train_loss'), '{:.4f}') }"
        )
    if "retraces" in summary:
        per_fn = " · ".join(
            f"{name}:{entry.get('traces')}x/{entry.get('compile_seconds', 0):.2f}s"
            for name, entry in sorted(summary.get("compile", {}).items())
            if isinstance(entry, Mapping)
        )
        lines.append(
            f"  compile: {summary['retraces']} retrace(s), "
            f"{summary.get('compile_seconds', 0.0):.2f}s total ({per_fn})"
        )
    reliability = [
        f"bad_steps={summary['bad_steps']}" if summary.get("bad_steps") is not None else None,
        f"anomalies={summary.get('anomalies', 0)}",
        f"recoveries={summary.get('recoveries', 0)}",
        f"preemptions={summary.get('preemptions', 0)}",
        (
            f"last_grad_norm={summary['last_grad_norm']:.3g}"
            if summary.get("last_grad_norm") is not None
            else None
        ),
    ]
    lines.append("  reliability: " + " ".join(part for part in reliability if part))
    if summary.get("slo_violations") or summary.get("slo_recoveries"):
        fired = summary.get("slo_rules_fired") or []
        lines.append(
            f"  SLO: {summary.get('slo_violations', 0)} violation(s), "
            f"{summary.get('slo_recoveries', 0)} recovered"
            + (f" — rules: {', '.join(fired)}" if fired else "")
        )
    promotion = summary.get("promotion")
    if promotion:
        parts = [
            f"{promotion.get('publishes', 0)} publish(es)"
            + (
                f" ({promotion['recompiled_publishes']} recompiled)"
                if promotion.get("recompiled_publishes")
                else ""
            ),
            f"{promotion.get('canaries', 0)} canary(ies)",
            f"{promotion.get('canary_evals', 0)} eval(s)",
            f"{promotion.get('promotions', 0)} promoted",
            f"{promotion.get('rollbacks', 0)} rolled back",
        ]
        if promotion.get("last_generation") is not None:
            parts.append(f"serving generation {promotion['last_generation']}")
        lines.append("  promotion: " + " · ".join(parts))
        if promotion.get("rollback_rules"):
            lines.append(
                "    rollback rule(s): " + ", ".join(promotion["rollback_rules"])
            )
    processes = summary.get("processes")
    if processes:
        per_host = processes.get("step_seconds") or {}
        shown = " · ".join(
            f"p{pid} {1000.0 * float(value):.2f}ms" for pid, value in per_host.items()
        )
        index = _finite(processes.get("straggler_index"))
        skew = _finite(processes.get("skew"))
        lines.append(
            f"  processes: {processes.get('count')} host(s)"
            + (f" · straggler index {index:.3f} (p{processes.get('straggler')})" if index is not None else "")
            + (f" · skew {skew:.3f}" if skew is not None else "")
            + (f" · step time {shown}" if shown else "")
        )
    health = summary.get("health")
    if health:
        parts = []
        value = _finite(health.get("grad_norm_global"))
        if value is not None:
            parts.append(f"grad_norm {value:.3g}")
        ratios = health.get("update_ratio")
        if isinstance(ratios, Mapping):
            finite = {
                name: v for name, v in ((n, _finite(r)) for n, r in ratios.items()) if v is not None
            }
            if finite:
                worst = max(finite, key=finite.get)
                parts.append(f"max update_ratio {finite[worst]:.3g} ({worst})")
        value = _finite(health.get("attention_entropy_mean"))
        if value is not None:
            parts.append(f"attn entropy {value:.3f} nats")
        value = _finite(health.get("embedding_coverage"))
        if value is not None:
            parts.append(f"emb coverage {100.0 * value:.0f}%")
        logits = health.get("logits")
        if isinstance(logits, Mapping) and _finite(logits.get("absmax")) is not None:
            parts.append(f"logits absmax {_finite(logits.get('absmax')):.3g}")
        parts.append(f"warnings {summary.get('health_warnings', 0)}")
        lines.append("  model health: " + " · ".join(parts))
        norms = health.get("grad_norm")
        if isinstance(norms, Mapping) and norms:
            shown = " · ".join(
                f"{name} {_fmt(_finite(v), '{:.3g}')}" for name, v in sorted(norms.items())
            )
            lines.append(f"    group grad norms: {shown}")
        activations = health.get("activations")
        if isinstance(activations, Mapping) and activations:
            shown = " · ".join(
                f"{stage} rms {_fmt(_finite(stats.get('rms')), '{:.3g}')}"
                f"/max {_fmt(_finite(stats.get('absmax')), '{:.3g}')}"
                for stage, stats in sorted(activations.items())
                if isinstance(stats, Mapping)
            )
            lines.append(f"    activations: {shown}")
    elif summary.get("health_warnings"):
        lines.append(f"  model health: warnings {summary['health_warnings']}")
    goodput = summary.get("goodput")
    if goodput:
        fractions = goodput.get("fractions") or {}
        # training and serving breakdowns carry different span sets; show
        # whichever phases this run recorded, in canonical order
        phase_order = (
            *GOODPUT_SPANS,
            *(n for n in SERVE_GOODPUT_SPANS if n not in GOODPUT_SPANS),
            "other",
        )
        shown = " · ".join(
            f"{name} {100.0 * float(fractions.get(name, 0.0)):.1f}%"
            for name in phase_order
            if name in fractions
        )
        lines.append(
            f"  goodput (wall {_fmt(_finite(goodput.get('wall_seconds')), '{:.2f}')}s): {shown}"
        )
        starvation = _finite(goodput.get("input_starvation"))
        if starvation is not None:
            lines.append(
                f"  input starvation: {100.0 * starvation:.1f}% of the stepping pipeline"
            )
        h2d_seconds = _finite(summary.get("h2d_seconds"))
        wall = _finite(goodput.get("wall_seconds"))
        if h2d_seconds is not None and wall:
            # chunked runs place chunks on the device-feed thread: the share
            # of h2d NOT in the fit loop's fractions overlapped compute
            in_loop = float(fractions.get("h2d", 0.0)) * wall
            overlapped = max(h2d_seconds - in_loop, 0.0)
            lines.append(
                f"  h2d: {h2d_seconds:.2f}s across threads — "
                f"{overlapped:.2f}s overlapped on the device feed, "
                f"{in_loop:.2f}s in the fit loop"
            )
    input_record = summary.get("input")
    if input_record:
        parts = []
        padding = _finite(input_record.get("padding_fraction"))
        if padding is not None:
            parts.append(f"padding {100.0 * padding:.1f}%")
        effective = _finite(input_record.get("effective_tokens_per_sec"))
        if effective is not None:
            parts.append(f"effective tokens/s {effective:,.0f}")
        tokens_real = _finite(input_record.get("tokens_real"))
        tokens_grid = _finite(input_record.get("tokens_grid"))
        if tokens_real is not None and tokens_grid is not None:
            parts.append(f"tokens {tokens_real:,.0f}/{tokens_grid:,.0f}")
        if parts:
            lines.append("  input feed: " + " · ".join(parts))
    trace = summary.get("trace")
    if trace:
        top = sorted(trace.items(), key=lambda kv: -kv[1]["seconds"])[:8]
        shown = " · ".join(
            f"{name} {entry['seconds']:.2f}s x{entry['count']}" for name, entry in top
        )
        lines.append(f"  trace.json: {sum(e['count'] for e in trace.values())} span(s): {shown}")
    device_time = summary.get("device_time")
    if device_time:
        total = _finite(device_time.get("total_device_seconds")) or 0.0
        scopes = device_time.get("scopes") or {}
        parts = [
            f"{scope} {100.0 * float((entry or {}).get('fraction', 0.0)):.1f}%"
            for scope, entry in scopes.items()
            if isinstance(entry, Mapping)
        ]
        unattributed = _finite(device_time.get("unattributed_seconds"))
        if unattributed is not None and total > 0:
            parts.append(f"unattributed {100.0 * unattributed / total:.1f}%")
        lines.append(
            f"  device attribution ({1000.0 * total:.1f} ms device time in the "
            "profiled window): " + (" · ".join(parts) if parts else "no scopes resolved")
        )
    roofline = summary.get("roofline")
    if roofline:
        lines.append("  roofline:")
        for program, record in sorted(roofline.items()):
            if not isinstance(record, Mapping):
                continue
            classification = record.get("roofline") or {}
            parts = []
            if classification.get("bound"):
                assumed = classification.get("peak_assumed")
                parts.append(
                    f"{classification['bound']}-bound"
                    + (f" (assumed {assumed} peaks)" if assumed else "")
                )
                intensity = _finite(classification.get("arithmetic_intensity"))
                critical = _finite(classification.get("critical_intensity"))
                if intensity is not None and critical is not None:
                    parts.append(
                        f"intensity {intensity:.1f} flops/B (critical {critical:.1f})"
                    )
                ceiling = _finite(classification.get("ceiling_tflops"))
                if ceiling is not None:
                    parts.append(f"ceiling {ceiling:.3g} TFLOP/s")
            else:
                parts.append("unclassified (no chip peaks)")
            peak = _finite(record.get("hbm_peak_bytes"))
            if peak is not None:
                parts.append(f"peak HBM {peak / 1e6:.1f} MB")
            collective = _finite(record.get("collective_bytes"))
            if collective is not None:
                parts.append(f"collectives {collective / 1e6:.2f} MB")
            lines.append(f"    {program}: " + " · ".join(parts))
    dryrun = summary.get("dryrun")
    if dryrun:
        lines.append(
            f"  dryrun_multichip: mesh={dryrun.get('mesh')} losses={dryrun.get('losses')} "
            f"psum={dryrun.get('psum')} sp_ring_err={dryrun.get('sp_ring_err')}"
        )
        if dryrun.get("spans"):
            shown = " · ".join(
                f"{name} {entry.get('seconds', 0.0):.2f}s"
                for name, entry in sorted(dryrun["spans"].items())
            )
            lines.append(f"  dryrun spans: {shown}")
        collectives = dryrun.get("collectives")
        if isinstance(collectives, Mapping):
            for program, entry in sorted(collectives.items()):
                if not isinstance(entry, Mapping):
                    continue
                by_op = entry.get("by_op") or {}
                shown = " · ".join(
                    f"{op} x{stats.get('count')} ({(stats.get('bytes') or 0) / 1e3:.1f} kB)"
                    for op, stats in sorted(by_op.items())
                    if isinstance(stats, Mapping)
                )
                lines.append(
                    f"  collectives[{program}]: {entry.get('count')} op(s), "
                    f"{(entry.get('bytes') or 0) / 1e3:.1f} kB: {shown}"
                )
        sharding = dryrun.get("sharding")
        if isinstance(sharding, Mapping):
            flags = sharding.get("flags") or []
            lines.append(
                f"  sharding: {(sharding.get('sharded_bytes') or 0) / 1e3:.1f} kB "
                f"sharded · {(sharding.get('replicated_bytes') or 0) / 1e3:.1f} kB "
                f"replicated · {len(flags)} flag(s)"
            )
            for flag in flags:
                lines.append(f"    FLAG: {flag}")
    bench = summary.get("bench")
    if bench:
        lines.append(
            f"  bench: {bench.get('metric')} = {bench.get('value')} {bench.get('unit', '')}"
            + (f" (vs_baseline {bench.get('vs_baseline')})" if "vs_baseline" in bench else "")
            + (" [stale sidecar]" if bench.get("stale") else "")
        )
        if bench.get("fit_samples_per_sec") is not None:
            gap = bench.get("dispatch_gap_closed")
            lines.append(
                f"  fit loop: {bench['fit_samples_per_sec']} samples/sec "
                f"({bench.get('fit_step_ms')} ms/step, "
                f"scan_chunk={bench.get('fit_scan_chunk')}, "
                f"device_feed={bench.get('fit_device_feed')})"
                + (
                    f" · dispatch gap closed {100.0 * float(gap):.0f}%"
                    if isinstance(gap, (int, float)) and not isinstance(gap, bool)
                    else ""
                )
            )
    bench_rows = summary.get("bench_rows")
    if bench_rows:
        lines.append(f"  bench suite: {len(bench_rows)} row(s)")
        for row in bench_rows:
            if row.get("error"):
                lines.append(f"    {row.get('row')}: ERROR {row['error']}")
                continue
            parts = [
                f"{_fmt(_finite(row.get('step_ms')), '{:.3f}')} ms/step",
                f"{_fmt(_finite(row.get('samples_per_sec')))} samples/sec",
            ]
            utilization = _finite(row.get("mfu"))
            if utilization is not None:
                assumed = row.get("mfu_peak_assumed")
                parts.append(
                    f"MFU {utilization:.4g}"
                    + (f" (assumed {assumed} peak)" if assumed else "")
                )
            if row.get("num_items") is not None:
                parts.append(f"items {row['num_items']}")
            if row.get("loss"):
                parts.append(str(row["loss"]))
            if row.get("precision"):
                parts.append(f"prec {row['precision']}")
            if row.get("roofline_bound"):
                bound = f"{row['roofline_bound']}-bound"
                of_ceiling = _finite(row.get("of_roofline_ceiling"))
                if of_ceiling is not None:
                    bound += f" ({100.0 * of_ceiling:.0f}% of ceiling)"
                parts.append(bound)
            hbm = _finite(row.get("hbm_peak_bytes"))
            if hbm is not None:
                parts.append(f"HBM {hbm / 1e6:.1f} MB")
            collective = _finite(row.get("collective_bytes"))
            if collective:
                parts.append(f"coll {collective / 1e6:.2f} MB")
            effective = _finite(row.get("effective_tokens_per_sec"))
            if effective is not None:
                parts.append(f"eff tokens/s {effective:,.0f}")
            padding = _finite(row.get("padding_fraction"))
            if padding is not None:
                parts.append(f"padding {100.0 * padding:.1f}%")
            segments = _finite(row.get("segments_per_row"))
            if segments is not None:
                parts.append(f"{segments:.2f} seg/row")
            lines.append(f"    {row.get('row')}: " + " · ".join(parts))
    precision_pairs = summary.get("precision_pairs")
    if precision_pairs:
        for head, pair in sorted(precision_pairs.items()):
            if not isinstance(pair, Mapping):
                continue
            parts = []
            f32_hbm, bf16_hbm = pair.get("f32_hbm_peak_bytes"), pair.get("bf16_hbm_peak_bytes")
            if f32_hbm is not None and bf16_hbm is not None:
                parts.append(f"HBM {f32_hbm / 1e6:.1f}→{bf16_hbm / 1e6:.1f} MB")
                saved = pair.get("hbm_saved_fraction")
                if saved is not None:
                    parts.append(f"({saved:+.1%} saved)")
            f32_ms, bf16_ms = pair.get("f32_step_ms"), pair.get("bf16_step_ms")
            if f32_ms is not None and bf16_ms is not None:
                parts.append(f"step {f32_ms:.3f}→{bf16_ms:.3f} ms")
            if pair.get("backend") == "cpu":
                # the byte win is an accelerator claim: CPU materializes f32 converts
                parts.append("[cpu smoke: byte win not expected]")
            lines.append(f"  precision ladder [{head}]: " + " · ".join(parts))
    remat_pairs = summary.get("remat_pairs")
    if remat_pairs:
        for base_name, pair in sorted(remat_pairs.items()):
            if not isinstance(pair, Mapping):
                continue
            parts = []
            off_hbm, on_hbm = pair.get("off_hbm_peak_bytes"), pair.get("on_hbm_peak_bytes")
            if off_hbm is not None and on_hbm is not None:
                parts.append(f"HBM {off_hbm / 1e6:.1f}→{on_hbm / 1e6:.1f} MB")
                saved = pair.get("hbm_saved_fraction")
                if saved is not None:
                    parts.append(f"({saved:+.1%} saved)")
            off_ms, on_ms = pair.get("off_step_ms"), pair.get("on_step_ms")
            if off_ms is not None and on_ms is not None:
                parts.append(f"step {off_ms:.3f}→{on_ms:.3f} ms")
            lines.append(f"  remat [{base_name}]: " + " · ".join(parts))
    serve = summary.get("serve")
    if serve:
        parts = []
        if _finite(serve.get("qps")) is not None:
            parts.append(f"{serve['qps']:.1f} qps")
        if _finite(serve.get("p50_ms")) is not None:
            parts.append(
                f"latency p50/p95/p99 {_fmt(_finite(serve.get('p50_ms')), '{:.2f}')}"
                f"/{_fmt(_finite(serve.get('p95_ms')), '{:.2f}')}"
                f"/{_fmt(_finite(serve.get('p99_ms')), '{:.2f}')} ms"
            )
        if serve.get("requests") is not None:
            answered = serve.get("answered")
            parts.append(
                f"requests {serve['requests']}"
                + (f" ({answered} answered)" if answered is not None else "")
            )
        if _finite(serve.get("batch_fill_ratio")) is not None:
            parts.append(f"batch fill {100.0 * serve['batch_fill_ratio']:.0f}%")
        if _finite(serve.get("cache_hit_rate")) is not None:
            parts.append(f"cache hits {100.0 * serve['cache_hit_rate']:.0f}%")
        if _finite(serve.get("queue_wait_ms_mean")) is not None:
            parts.append(f"queue wait {serve['queue_wait_ms_mean']:.2f} ms mean")
        mode = f" [{serve['mode']}]" if serve.get("mode") else ""
        lines.append(f"  serving{mode}: " + " · ".join(parts))
        # the resilience line: shed / deadline-miss / error rates, degraded
        # traffic by ladder rung, breaker state — overload/chaos evidence
        rates = [
            (label, _finite(serve.get(key)))
            for label, key in (
                ("shed", "shed_rate"),
                ("deadline-miss", "deadline_miss_rate"),
                ("error", "error_rate"),
            )
        ]
        if any(value is not None for _, value in rates):
            parts = [
                f"{label} rate {value:.2%}" for label, value in rates if value is not None
            ]
            served_by = serve.get("served_by")
            if isinstance(served_by, Mapping):
                degraded = sum(
                    int(count) for rung, count in served_by.items() if rung != "primary"
                )
                shown = "/".join(
                    f"{rung}:{served_by[rung]}" for rung in ("cache_only", "fallback")
                    if rung in served_by
                )
                parts.append(f"degraded {degraded}" + (f" ({shown})" if shown else ""))
            breaker = serve.get("breaker")
            if isinstance(breaker, Mapping):
                parts.append(
                    f"breaker {breaker.get('state')} "
                    f"({breaker.get('opens', 0)} open(s))"
                )
            if serve.get("hung_requests") is not None:
                parts.append(f"hung {serve['hung_requests']}")
            lines.append("  serving resilience: " + " · ".join(parts))
        if serve.get("overload"):
            parts = []
            if serve.get("overload_p99_ms") is not None:
                parts.append(f"p99 {serve['overload_p99_ms']:.2f} ms")
            if serve.get("overload_shed_rate") is not None:
                parts.append(f"shed {serve['overload_shed_rate']:.2%}")
            if serve.get("overload_deadline_miss_rate") is not None:
                parts.append(f"deadline-miss {serve['overload_deadline_miss_rate']:.2%}")
            lines.append("  serving overload: " + " · ".join(parts))
        quant = serve.get("quant")
        if isinstance(quant, Mapping):
            parts = []
            recall = _finite(quant.get("recall_at_candidates"))
            if recall is not None:
                parts.append(
                    f"int8 recall@{quant.get('candidates')} {recall:.4f}"
                )
            match = _finite(quant.get("topk_match_rate"))
            if match is not None:
                parts.append(f"top-{quant.get('top_k')} match {match:.4f}")
            if _finite(quant.get("int8_rank_ms")) is not None:
                parts.append(
                    f"rank {quant['int8_rank_ms']:.2f} ms int8 vs "
                    f"{_fmt(_finite(quant.get('f32_rank_ms')), '{:.2f}')} ms f32"
                )
            ratio = _finite(quant.get("bytes_ratio"))
            if ratio is not None:
                parts.append(f"table bytes ×{ratio:.3f}")
            lines.append("  serving quant (int8 retrieval): " + " · ".join(parts))
        ann = serve.get("ann")
        if isinstance(ann, Mapping):
            parts = []
            if ann.get("items") is not None:
                parts.append(
                    f"{ann['items'] / 1e6:.0f}M items · nlist {ann.get('nlist')} "
                    f"· nprobe {ann.get('nprobe')}"
                )
            recall = _finite(ann.get("recall_at_100"))
            if recall is not None:
                parts.append(f"recall@100 {recall:.4f}")
            agreement = _finite(ann.get("topk_agreement"))
            if agreement is not None:
                parts.append(f"top-k agreement {agreement:.4f}")
            speedup = _finite(ann.get("speedup"))
            if speedup is not None:
                parts.append(
                    f"brute {_fmt(_finite(ann.get('brute_qps')), '{:.0f}')} qps "
                    f"vs IVF {_fmt(_finite(ann.get('ivf_qps')), '{:.0f}')} qps "
                    f"(×{speedup:.1f})"
                )
            frac = _finite(ann.get("scanned_fraction"))
            if frac is not None:
                parts.append(f"scans {frac:.2%}/query")
            lines.append("  serving ann (ivf retrieval): " + " · ".join(parts))
        chaos = serve.get("chaos")
        if isinstance(chaos, Mapping):
            lines.append(
                "  serving chaos: "
                f"{chaos.get('injected_engine_errors', 0)} injected error(s) · "
                f"breaker opened {chaos.get('breaker_opens', 0)}x, "
                f"final {chaos.get('breaker_state_final')} · "
                f"storm missed {chaos.get('storm_deadline_missed', 0)} · "
                f"hung {chaos.get('hung_requests', 0)}"
            )
        if serve.get("swap"):
            parts = [f"{serve.get('swap_count', 0)} hot swap(s) under load"]
            if serve.get("swap_recompiled"):
                parts.append(f"{serve['swap_recompiled']} recompiled")
            if serve.get("swap_p99_ms") is not None:
                parts.append(f"p99 {serve['swap_p99_ms']:.2f} ms")
            parts.append(f"errors {serve.get('swap_errors', 0)}")
            if serve.get("swap_generations") is not None:
                parts.append(f"{serve['swap_generations']} generation(s) observed")
            lines.append("  serving swap: " + " · ".join(parts))
    quality = summary.get("quality")
    if quality:
        roles = quality.get("roles") or {}
        for role in sorted(roles):
            stats = roles[role]
            parts = []
            hitrate = _finite(stats.get("online_hitrate_cum"))
            if hitrate is not None:
                parts.append(
                    f"online hitrate@{stats.get('k')} {hitrate:.4f}"
                    + (
                        f" ({stats['joins']} joins)"
                        if stats.get("joins") is not None
                        else ""
                    )
                )
            ndcg = _finite(stats.get("online_ndcg_cum"))
            if ndcg is not None:
                parts.append(f"ndcg {ndcg:.4f}")
            for label, key in (
                ("coverage", "coverage"),
                ("novelty", "novelty"),
                ("surprisal", "surprisal"),
                ("ild", "ild"),
            ):
                value = _finite(stats.get(key))
                if value is not None:
                    parts.append(f"{label} {value:.3f}")
            lines.append(
                f"  quality[{role}]: " + (" · ".join(parts) if parts else "no windows")
            )
        drift_parts = []
        psi = _finite(quality.get("drift_psi"))
        if psi is not None:
            drift_parts.append(f"psi {psi:.3f}")
        peak = _finite(quality.get("drift_psi_peak"))
        if peak is not None:
            drift_parts.append(f"peak {peak:.3f}")
        drift_parts.append(f"{quality.get('drift_warnings', 0)} warning(s)")
        if quality.get("drift_series"):
            drift_parts.append("series " + ",".join(quality["drift_series"]))
        if quality.get("drift_phase"):
            drift_parts.append(
                f"injected-shift phase: {quality.get('drift_slo_violations', 0)} "
                "SLO violation(s)"
            )
        lines.append("  quality drift: " + " · ".join(drift_parts))
    fleet = summary.get("fleet")
    if fleet:
        parts = []
        if fleet.get("replicas") is not None:
            parts.append(f"{fleet['replicas']} replica(s)")
        if _finite(fleet.get("qps")) is not None:
            parts.append(f"{fleet['qps']:.1f} qps aggregate")
        if _finite(fleet.get("p50_ms")) is not None or _finite(fleet.get("p99_ms")) is not None:
            parts.append(
                f"latency p50/p99 {_fmt(_finite(fleet.get('p50_ms')), '{:.2f}')}"
                f"/{_fmt(_finite(fleet.get('p99_ms')), '{:.2f}')} ms"
            )
        if _finite(fleet.get("reroute_rate")) is not None:
            parts.append(f"reroute rate {fleet['reroute_rate']:.2%}")
        locality = _finite(fleet.get("cache_hit_locality"))
        if locality is not None:
            parts.append(f"cache-hit locality {locality:.3f}x single replica")
        lines.append("  fleet: " + (" · ".join(parts) if parts else "events only"))
        health_parts = [
            f"{fleet.get('health_transitions', 0)} health transition(s)",
            f"{fleet.get('failover_events', 0)} failover event(s)",
        ]
        if fleet.get("hedges") is not None or fleet.get("hedge_events"):
            hedges = fleet.get("hedges", fleet.get("hedge_events", 0))
            health_parts.append(
                f"hedges {hedges}"
                + (
                    f" ({fleet['hedge_wins']} won)"
                    if fleet.get("hedge_wins") is not None
                    else ""
                )
            )
        if fleet.get("retries") is not None:
            health_parts.append(f"retries {fleet['retries']}")
        lines.append("  fleet health: " + " · ".join(health_parts))
        transitions = fleet.get("replica_transitions")
        if isinstance(transitions, Mapping):
            for replica, moves in transitions.items():
                lines.append(f"    {replica}: " + " · ".join(moves))
        per_replica = fleet.get("per_replica")
        if isinstance(per_replica, Mapping) and per_replica:
            shown = " · ".join(
                f"{replica} "
                + "/".join(
                    part
                    for part in (
                        f"{stats['qps']:.0f}qps" if _finite(stats.get("qps")) is not None else None,
                        f"p99 {stats['p99_ms']:.1f}ms" if _finite(stats.get("p99_ms")) is not None else None,
                        f"{stats['answered']}ans" if stats.get("answered") is not None else None,
                        f"hits {stats['cache_hit_rate']:.0%}" if _finite(stats.get("cache_hit_rate")) is not None else None,
                        (
                            f"hedges {stats['hedges']}"
                            + (
                                f"({stats['hedge_wins']}w/{stats['hedge_cancelled']}c)"
                                if stats.get("hedge_wins") is not None
                                or stats.get("hedge_cancelled") is not None
                                else ""
                            )
                        )
                        if stats.get("hedges") is not None
                        else None,
                        f"retries {stats['retries']}" if stats.get("retries") is not None else None,
                    )
                    if part
                )
                for replica, stats in sorted(per_replica.items())
                if isinstance(stats, Mapping)
            )
            lines.append(f"  fleet replicas: {shown}")
        exemplars = fleet.get("latency_exemplars")
        if isinstance(exemplars, (list, tuple)) and exemplars:
            lines.append(
                "  fleet exemplars (slowest): "
                + " · ".join(
                    f"{_fmt(_finite(e.get('latency_ms')), '{:.1f}')}ms {e.get('trace_id')}"
                    for e in exemplars[:4]
                    if isinstance(e, Mapping)
                )
            )
        chaos = fleet.get("chaos")
        if isinstance(chaos, Mapping):
            parts = []
            if chaos.get("killed") is not None:
                parts.append(f"killed {chaos['killed']}")
            gap = _finite(chaos.get("failover_gap_ms"))
            if gap is not None:
                parts.append(f"failover gap {gap:.1f} ms")
            if chaos.get("reroutes") is not None:
                parts.append(f"reroutes {chaos['reroutes']}")
            if chaos.get("revived") is not None:
                parts.append(f"revived {chaos['revived']}")
            parts.append(f"hung {chaos.get('hung_requests', 0)}")
            trace_ids = chaos.get("exemplar_trace_ids")
            if isinstance(trace_ids, (list, tuple)) and trace_ids:
                parts.append("traces " + ",".join(str(t) for t in trace_ids[:3]))
            lines.append("  fleet chaos: " + " · ".join(parts))
        drain_swap = fleet.get("drain_swap")
        if isinstance(drain_swap, Mapping):
            lines.append(
                "  fleet rollout: "
                f"{drain_swap.get('replicas_swapped', 0)} replica(s) drained+swapped · "
                f"errors {drain_swap.get('errors', 0)}"
                + (
                    f" · p99 {drain_swap['p99_ms']:.2f} ms"
                    if _finite(drain_swap.get("p99_ms")) is not None
                    else ""
                )
            )
    attribution = summary.get("tail_attribution")
    if isinstance(attribution, Mapping) and isinstance(
        attribution.get("quantiles"), Mapping
    ):
        lines.append(
            f"  tail attribution ({attribution.get('requests', 0)} traced "
            "request(s)):"
        )
        for label, entry in attribution["quantiles"].items():
            if not isinstance(entry, Mapping):
                continue
            fractions = entry.get("fractions")
            if not isinstance(fractions, Mapping):
                continue
            shown = " · ".join(
                f"{hop} {float(frac):.0%}"
                for hop, frac in sorted(
                    fractions.items(), key=lambda kv: -float(kv[1])
                )
                if _finite(frac) is not None and float(frac) >= 0.005
            )
            lines.append(
                f"    {label} {_fmt(_finite(entry.get('latency_ms')), '{:.1f}')} ms: "
                f"{shown} (n={entry.get('n')})"
            )
    return "\n".join(lines)


# --------------------------------------------------------------------------- #
# comparing
# --------------------------------------------------------------------------- #
def compare_runs(
    candidate: Mapping[str, Any],
    baseline: Mapping[str, Any],
    threshold: float = 0.1,
    memory_threshold: Optional[float] = None,
    compile_threshold: Optional[float] = None,
) -> Tuple[List[str], List[str]]:
    """(report lines, regression lines) for candidate vs baseline.

    A regression is a relative drop beyond ``threshold`` in throughput or MFU,
    new retraces, or a LOWER-better metric growing past its own threshold:
    ``peak_memory_bytes`` beyond ``memory_threshold`` (default: ``threshold``)
    and ``compile_seconds`` beyond ``compile_threshold`` (default:
    ``max(threshold, 0.5)`` — compile wall-time is machine-noisy, so the gate
    only catches step-function growth like a new compiled variant). Bench-suite
    rows compare per row name; rows carrying an ``error`` field on either side
    are skipped (the by-design 1M plain-CE OOM row must not trip the gate),
    but a row that errors ONLY in the candidate is a regression. ``prec_*``
    and ``*_remat_*`` rows (the precision-ladder and remat families)
    additionally gate their per-row ``hbm_peak_bytes`` lower-better on
    ``memory_threshold`` — a regression that only moves bytes still fails —
    and a candidate carrying a ``<base>_remat_{off,on}`` pair must show
    remat-on strictly below remat-off on ``hbm_peak_bytes`` (the
    candidate-alone invariant, like the packing gate). Serving ``quant`` blocks
    gate ``recall_at_candidates`` / ``topk_match_rate`` higher-better with an
    absolute 0.005 floor; serving ``ann`` blocks (the IVF rung) gate
    ``recall_at_100`` / ``topk_agreement`` the same way plus ``ann_qps``
    higher-better on the relative threshold. Fleet runs (``bench_fleet.py``)
    gate ``fleet_qps``
    higher-better always, and ``fleet_p99_ms`` / ``fleet_reroute_rate``
    lower-better only when the chaos phase matches on both sides (a kill's
    failover gap and reroutes must not fail against a no-chaos baseline).
    Quality runs (obs.quality) gate ``quality_online_hitrate`` higher-better
    with the same absolute 0.005 floor, and ``quality_drift_psi`` lower-better
    only when the injected-shift phase matches on both sides.
    """
    if memory_threshold is None:
        memory_threshold = threshold
    if compile_threshold is None:
        compile_threshold = max(threshold, 0.5)
    lines: List[str] = [
        f"Compare — candidate {candidate.get('source')} vs baseline {baseline.get('source')}"
    ]
    regressions: List[str] = []

    def check(name: str, cand: Optional[float], base: Optional[float], unit: str = "") -> None:
        if cand is None or base is None:
            lines.append(f"  {name}: candidate={_fmt(cand, '{:.3f}')} baseline={_fmt(base, '{:.3f}')} (not comparable)")
            return
        delta = (cand - base) / base if base else 0.0
        lines.append(
            f"  {name}: {cand:.3f}{unit} vs {base:.3f}{unit} ({delta:+.1%})"
        )
        if base > 0 and cand < base * (1.0 - threshold):
            regressions.append(f"{name} regressed {-delta:.1%} (> {threshold:.0%} threshold)")

    def check_lower_better(
        name: str, cand: Optional[float], base: Optional[float], limit: float, unit: str = ""
    ) -> None:
        if cand is None or base is None:
            lines.append(
                f"  {name}: candidate={_fmt(cand, '{:.3f}')} "
                f"baseline={_fmt(base, '{:.3f}')} (not comparable)"
            )
            return
        delta = (cand - base) / base if base else 0.0
        lines.append(f"  {name}: {cand:.3f}{unit} vs {base:.3f}{unit} ({delta:+.1%})")
        if base > 0 and cand > base * (1.0 + limit):
            regressions.append(
                f"{name} regressed {delta:+.1%} (> {limit:.0%} threshold, lower is better)"
            )

    check("samples_per_sec", candidate.get("samples_per_sec"), baseline.get("samples_per_sec"))
    check("steps_per_sec", candidate.get("steps_per_sec"), baseline.get("steps_per_sec"))
    # end-to-end fit-loop throughput (bench records): the production
    # Trainer.fit(scan_chunk=...) number gates alongside the microbench —
    # but only between runs measured with the SAME chunk/feed variant
    cand_fit = candidate.get("fit_samples_per_sec")
    base_fit = baseline.get("fit_samples_per_sec")
    if cand_fit is not None or base_fit is not None:
        cand_bench = candidate.get("bench") or {}
        base_bench = baseline.get("bench") or {}
        variant_keys = ("fit_scan_chunk", "fit_device_feed")
        if any(cand_bench.get(key) != base_bench.get(key) for key in variant_keys):
            lines.append(
                "  fit_samples_per_sec: variant flags differ "
                f"(candidate {[cand_bench.get(k) for k in variant_keys]} vs "
                f"baseline {[base_bench.get(k) for k in variant_keys]}) — not compared"
            )
        else:
            check("fit_samples_per_sec", cand_fit, base_fit)
    if candidate.get("mfu") is not None and baseline.get("mfu") is not None:
        check("mfu", candidate.get("mfu"), baseline.get("mfu"))
    cand_retraces, base_retraces = candidate.get("retraces"), baseline.get("retraces")
    if cand_retraces is not None and base_retraces is not None:
        lines.append(f"  retraces: {cand_retraces} vs {base_retraces}")
        if cand_retraces > base_retraces:
            regressions.append(
                f"retraces increased {base_retraces} -> {cand_retraces} (shape leak?)"
            )
    # lower-better resource gates: device-memory growth is a capacity
    # regression even at held throughput; compile-time growth is the "one
    # more compiled variant slipped in" signal
    if candidate.get("peak_memory_bytes") is not None or baseline.get("peak_memory_bytes") is not None:
        check_lower_better(
            "peak_memory_bytes",
            _finite(candidate.get("peak_memory_bytes")),
            _finite(baseline.get("peak_memory_bytes")),
            memory_threshold,
        )
    if candidate.get("compile_seconds") is not None or baseline.get("compile_seconds") is not None:
        check_lower_better(
            "compile_seconds",
            _finite(candidate.get("compile_seconds")),
            _finite(baseline.get("compile_seconds")),
            compile_threshold,
            unit="s",
        )
    # bench-suite rows: per-row throughput gates keyed by row name; error
    # rows (the by-design OOM evidence) are reported but never gated — except
    # a NEW error where the baseline measured, which IS the regression
    cand_rows = {
        row.get("row"): row for row in (candidate.get("bench_rows") or []) if row.get("row")
    }
    base_rows = {
        row.get("row"): row for row in (baseline.get("bench_rows") or []) if row.get("row")
    }
    for name in sorted(set(cand_rows) & set(base_rows)):
        cand_row, base_row = cand_rows[name], base_rows[name]
        if base_row.get("error"):
            lines.append(f"  bench_row[{name}]: skipped (baseline error row)")
            continue
        if cand_row.get("error"):
            lines.append(
                f"  bench_row[{name}]: candidate ERROR {cand_row['error']} "
                "(baseline measured)"
            )
            regressions.append(
                f"bench_row[{name}] errored in the candidate but measured in the baseline"
            )
            continue
        check(
            f"bench_row[{name}].samples_per_sec",
            _finite(cand_row.get("samples_per_sec")),
            _finite(base_row.get("samples_per_sec")),
        )
        if (
            _finite(cand_row.get("effective_tokens_per_sec")) is not None
            and _finite(base_row.get("effective_tokens_per_sec")) is not None
        ):
            # the streaming-input rows' REAL-token rate: padding-waste
            # regressions (a packing change that re-inflates the grid) fail
            # here even when samples/sec holds
            check(
                f"bench_row[{name}].effective_tokens_per_sec",
                _finite(cand_row.get("effective_tokens_per_sec")),
                _finite(base_row.get("effective_tokens_per_sec")),
            )
        if name.startswith("prec_") or "_remat_" in name:
            # the precision-ladder and remat rows exist to MOVE bytes: a
            # regression that only grows hbm_peak_bytes (throughput held)
            # must still fail — per-row lower-better on --memory-threshold
            check_lower_better(
                f"bench_row[{name}].hbm_peak_bytes",
                _finite(cand_row.get("hbm_peak_bytes")),
                _finite(base_row.get("hbm_peak_bytes")),
                memory_threshold,
            )
    # sequence-packing invariant, gated on the CANDIDATE alone: when a run
    # carries both the packed and unpacked streaming rows, packed must beat
    # unpacked on effective tokens/s — packing that stops paying for itself
    # is a regression regardless of what the baseline run measured
    unpacked_row = cand_rows.get("stream_parquet") or cand_rows.get("stream_inmem")
    packed_row = cand_rows.get("stream_packed")
    if (
        packed_row is not None
        and unpacked_row is not None
        and not packed_row.get("error")
        and not unpacked_row.get("error")
    ):
        packed_rate = _finite(packed_row.get("effective_tokens_per_sec"))
        unpacked_rate = _finite(unpacked_row.get("effective_tokens_per_sec"))
        if packed_rate is not None and unpacked_rate is not None:
            lines.append(
                "  packing: stream_packed effective tokens/s "
                f"{packed_rate:.0f} vs {unpacked_row.get('row')} {unpacked_rate:.0f}"
            )
            if packed_rate < unpacked_rate:
                regressions.append(
                    "stream_packed effective_tokens_per_sec "
                    f"({packed_rate:.0f}) fell below the unpacked "
                    f"{unpacked_row.get('row')} baseline ({unpacked_rate:.0f})"
                )
    # remat-pair invariant, gated on the CANDIDATE alone: when a run carries
    # a <base>_remat_{off,on} pair, remat-on must carry LOWER hbm_peak_bytes
    # — activation checkpointing that stops moving bytes is a regression
    # regardless of the baseline run (the static memory_analysis claim holds
    # on CPU too, unlike the bf16 byte win)
    for pair_name, pair in (candidate.get("remat_pairs") or {}).items():
        if not isinstance(pair, Mapping):
            continue
        off_hbm = _finite(pair.get("off_hbm_peak_bytes"))
        on_hbm = _finite(pair.get("on_hbm_peak_bytes"))
        if off_hbm is None or on_hbm is None:
            continue
        lines.append(
            f"  remat[{pair_name}]: hbm_peak_bytes on={on_hbm:.0f} "
            f"vs off={off_hbm:.0f}"
        )
        if on_hbm >= off_hbm:
            regressions.append(
                f"remat[{pair_name}] hbm_peak_bytes did not drop "
                f"(on={on_hbm:.0f} >= off={off_hbm:.0f})"
            )
    # anomaly-count gates: a run that skips more steps (or warns more) than
    # its baseline regressed in stability even when throughput held
    for name, label in (
        ("bad_steps", "bad_steps"),
        ("anomalies", "anomalies"),
        ("health_warnings", "health warnings"),
        # lower-better with a zero baseline by design: a healthy run fires no
        # SLO rules, so ANY candidate violation against a clean baseline gates
        ("slo_violations", "SLO violations"),
    ):
        cand_count, base_count = candidate.get(name), baseline.get(name)
        if (
            isinstance(cand_count, int)
            and isinstance(base_count, int)
            and not isinstance(cand_count, bool)
            and not isinstance(base_count, bool)
        ):
            lines.append(f"  {label}: {cand_count} vs {base_count}")
            if cand_count > base_count:
                regressions.append(
                    f"{label} increased {base_count} -> {cand_count} (model-health regression)"
                )
    # promotion rollbacks: lower-better with a zero baseline by design — a
    # healthy continual run rolls nothing back, so ANY candidate rollback
    # against a clean baseline gates (the serve.promote analog of
    # slo_violations)
    cand_rollbacks, base_rollbacks = candidate.get("rollbacks"), baseline.get("rollbacks")
    if (
        isinstance(cand_rollbacks, int)
        and isinstance(base_rollbacks, int)
        and not isinstance(cand_rollbacks, bool)
        and not isinstance(base_rollbacks, bool)
    ):
        lines.append(f"  rollbacks: {cand_rollbacks} vs {base_rollbacks}")
        if cand_rollbacks > base_rollbacks:
            regressions.append(
                f"rollbacks increased {base_rollbacks} -> {cand_rollbacks} "
                "(a candidate generation was auto-rolled back)"
            )
    # serving gates: QPS is higher-better (reuses check); tail latency is
    # LOWER-better — a p99 that grew beyond threshold is a regression even
    # when throughput held (the micro-batcher trading latency for fill is
    # exactly the failure mode this catches)
    # resilience-rate gates, LOWER-better with an absolute floor: rates
    # start at 0.0 in healthy runs, so the relative rule alone (cand >
    # base * (1+t)) would never fire on a 0 -> 0.05 regression — a
    # half-percent absolute rise gates regardless of the baseline
    def check_rate(name: str, cand: Optional[float], base: Optional[float]) -> None:
        if cand is None or base is None:
            lines.append(
                f"  {name}: candidate={_fmt(cand, '{:.4f}')} "
                f"baseline={_fmt(base, '{:.4f}')} (not comparable)"
            )
            return
        lines.append(f"  {name}: {cand:.4f} vs {base:.4f}")
        if cand > base + max(threshold * base, 0.005):
            regressions.append(
                f"{name} regressed {base:.4f} -> {cand:.4f} (lower is better)"
            )

    def surface_rate(name: str, cand: Optional[float], base: Optional[float], why: str) -> None:
        if cand is not None or base is not None:
            lines.append(
                f"  {name}: candidate={_fmt(cand, '{:.4f}')} "
                f"baseline={_fmt(base, '{:.4f}')} (not gated: {why})"
            )

    cand_serve, base_serve = candidate.get("serve") or {}, baseline.get("serve") or {}
    if cand_serve or base_serve:
        check("serve_qps", _finite(cand_serve.get("qps")), _finite(base_serve.get("qps")))
        cand_p99, base_p99 = _finite(cand_serve.get("p99_ms")), _finite(base_serve.get("p99_ms"))
        if cand_p99 is None or base_p99 is None:
            lines.append(
                f"  serve_p99_ms: candidate={_fmt(cand_p99, '{:.3f}')} "
                f"baseline={_fmt(base_p99, '{:.3f}')} (not comparable)"
            )
        else:
            delta = (cand_p99 - base_p99) / base_p99 if base_p99 else 0.0
            lines.append(f"  serve_p99_ms: {cand_p99:.3f} vs {base_p99:.3f} ({delta:+.1%})")
            if base_p99 > 0 and cand_p99 > base_p99 * (1.0 + threshold):
                regressions.append(
                    f"serve_p99_ms regressed {delta:+.1%} (> {threshold:.0%} threshold)"
                )

        # the run-wide rates are dominated by the OPT-IN phases — deadline
        # misses by overload (4x-capacity arrivals against tight deadlines by
        # design), errors by chaos (injected engine faults) — so each gate
        # applies only when the relevant phases match on both sides; a
        # mismatched comparison is surfaced, never gated
        overload_match = bool(cand_serve.get("overload")) == bool(base_serve.get("overload"))
        chaos_match = bool(cand_serve.get("chaos")) == bool(base_serve.get("chaos"))
        cand_err = _finite(cand_serve.get("error_rate"))
        base_err = _finite(base_serve.get("error_rate"))
        if chaos_match:
            check_rate("serve_error_rate", cand_err, base_err)
        else:
            surface_rate(
                "serve_error_rate", cand_err, base_err,
                "chaos phase ran on one side only",
            )
        cand_dm = _finite(cand_serve.get("deadline_miss_rate"))
        base_dm = _finite(base_serve.get("deadline_miss_rate"))
        if overload_match:
            check_rate("serve_deadline_miss_rate", cand_dm, base_dm)
        else:
            surface_rate(
                "serve_deadline_miss_rate", cand_dm, base_dm,
                "overload phase ran on one side only",
            )
        # shed rate only means the same thing between two runs that BOTH ran
        # the overload phase (a no-overload run sheds ~nothing by design) —
        # surfaced always, gated only when comparable
        cand_shed = _finite(cand_serve.get("shed_rate"))
        base_shed = _finite(base_serve.get("shed_rate"))
        if cand_serve.get("overload") and base_serve.get("overload"):
            check_rate("serve_shed_rate", cand_shed, base_shed)
        else:
            surface_rate(
                "serve_shed_rate", cand_shed, base_shed,
                "both sides must run overload mode",
            )
        # swap-under-load tail latency: a hot swap that stalls the worker is
        # exactly what this gate catches — gated lower-better only when BOTH
        # runs ran the swap phase (the phase-matching rule), surfaced
        # unGated otherwise
        cand_swap = _finite(cand_serve.get("swap_p99_ms"))
        base_swap = _finite(base_serve.get("swap_p99_ms"))
        if cand_serve.get("swap") and base_serve.get("swap"):
            check_lower_better("swap_p99_ms", cand_swap, base_swap, threshold, unit="ms")
        else:
            surface_rate(
                "swap_p99_ms", cand_swap, base_swap,
                "swap phase ran on one side only",
            )
        for name in ("batch_fill_ratio", "cache_hit_rate"):
            cand_value, base_value = _finite(cand_serve.get(name)), _finite(base_serve.get(name))
            if cand_value is not None and base_value is not None:
                lines.append(f"  serve_{name}: {cand_value:.3f} vs {base_value:.3f}")
        # int8 retrieval quality gates (precision ladder's serving rung):
        # recall@C and the re-ranked top-k agreement are higher-better with an
        # ABSOLUTE floor — retrieval quality sliding within a loose relative
        # threshold is exactly the regression the gate exists to catch, so
        # any drop beyond 0.005 absolute fails
        cand_quant = cand_serve.get("quant") or {}
        base_quant = base_serve.get("quant") or {}
        if cand_quant or base_quant:
            for name in ("recall_at_candidates", "topk_match_rate"):
                cand_value = _finite(cand_quant.get(name))
                base_value = _finite(base_quant.get(name))
                if cand_value is None or base_value is None:
                    lines.append(
                        f"  serve_quant_{name}: candidate={_fmt(cand_value, '{:.4f}')} "
                        f"baseline={_fmt(base_value, '{:.4f}')} (not comparable)"
                    )
                    continue
                lines.append(
                    f"  serve_quant_{name}: {cand_value:.4f} vs {base_value:.4f}"
                )
                if cand_value < base_value - 0.005:
                    regressions.append(
                        f"serve_quant_{name} regressed "
                        f"{base_value:.4f} -> {cand_value:.4f} (higher is better)"
                    )
        # IVF retrieval quality gates (sub-linear serving): same absolute
        # 0.005 floor as the quant rung — approximation quality must not
        # slide; ann_qps gates higher-better on the relative threshold
        cand_ann = cand_serve.get("ann") or {}
        base_ann = base_serve.get("ann") or {}
        if cand_ann or base_ann:
            for name in ("recall_at_100", "topk_agreement"):
                cand_value = _finite(cand_ann.get(name))
                base_value = _finite(base_ann.get(name))
                if cand_value is None or base_value is None:
                    lines.append(
                        f"  serve_ann_{name}: candidate={_fmt(cand_value, '{:.4f}')} "
                        f"baseline={_fmt(base_value, '{:.4f}')} (not comparable)"
                    )
                    continue
                lines.append(
                    f"  serve_ann_{name}: {cand_value:.4f} vs {base_value:.4f}"
                )
                if cand_value < base_value - 0.005:
                    regressions.append(
                        f"serve_ann_{name} regressed "
                        f"{base_value:.4f} -> {cand_value:.4f} (higher is better)"
                    )
            check(
                "serve_ann_qps",
                _finite(cand_ann.get("ivf_qps")),
                _finite(base_ann.get("ivf_qps")),
            )
    # fleet gates (serve.fleet / bench_fleet.py): aggregate QPS is higher-
    # better; tail latency and the reroute rate are LOWER-better — but a
    # chaos run's p99 includes the failover gap and its reroutes are the
    # injected kill's whole point, so both gate only when the chaos phase
    # matches on both sides (the phase-matching rule). Cache-hit
    # locality is surfaced — its gate is the candidate-alone acceptance
    # check bench_fleet/CI applies, not a cross-run comparison.
    cand_fleet, base_fleet = candidate.get("fleet") or {}, baseline.get("fleet") or {}
    if cand_fleet or base_fleet:
        check(
            "fleet_qps", _finite(cand_fleet.get("qps")), _finite(base_fleet.get("qps"))
        )
        fleet_chaos_match = bool(cand_fleet.get("chaos")) == bool(base_fleet.get("chaos"))
        cand_p99 = _finite(cand_fleet.get("p99_ms"))
        base_p99 = _finite(base_fleet.get("p99_ms"))
        if fleet_chaos_match:
            check_lower_better("fleet_p99_ms", cand_p99, base_p99, threshold, unit="ms")
        else:
            surface_rate(
                "fleet_p99_ms", cand_p99, base_p99,
                "chaos phase ran on one side only",
            )
        cand_reroute = _finite(cand_fleet.get("reroute_rate"))
        base_reroute = _finite(base_fleet.get("reroute_rate"))
        if fleet_chaos_match:
            check_rate("fleet_reroute_rate", cand_reroute, base_reroute)
        else:
            surface_rate(
                "fleet_reroute_rate", cand_reroute, base_reroute,
                "chaos phase ran on one side only",
            )
        cand_loc = _finite(cand_fleet.get("cache_hit_locality"))
        base_loc = _finite(base_fleet.get("cache_hit_locality"))
        if cand_loc is not None and base_loc is not None:
            lines.append(f"  fleet_cache_hit_locality: {cand_loc:.3f} vs {base_loc:.3f}")
    # quality gates (obs.quality): the ONLINE prequential hitrate is higher-
    # better with an ABSOLUTE floor (same rule as the quant recall gates —
    # online ranking quality sliding within a loose relative threshold is
    # exactly what this gate exists to catch); drift PSI is lower-better but
    # only between two runs that BOTH ran the injected-shift phase (the
    # phase-matching rule: a drift run's psi peak is the injection's whole
    # point and must not fail against a steady-traffic baseline)
    cand_quality = candidate.get("quality") or {}
    base_quality = baseline.get("quality") or {}
    if cand_quality or base_quality:
        cand_hr = _finite(cand_quality.get("online_hitrate_cum"))
        base_hr = _finite(base_quality.get("online_hitrate_cum"))
        if cand_hr is None or base_hr is None:
            lines.append(
                f"  quality_online_hitrate: candidate={_fmt(cand_hr, '{:.4f}')} "
                f"baseline={_fmt(base_hr, '{:.4f}')} (not comparable)"
            )
        else:
            lines.append(
                f"  quality_online_hitrate: {cand_hr:.4f} vs {base_hr:.4f}"
            )
            if cand_hr < base_hr - 0.005:
                regressions.append(
                    f"quality_online_hitrate regressed "
                    f"{base_hr:.4f} -> {cand_hr:.4f} (higher is better)"
                )
        cand_ndcg = _finite(cand_quality.get("online_ndcg_cum"))
        base_ndcg = _finite(base_quality.get("online_ndcg_cum"))
        if cand_ndcg is not None and base_ndcg is not None:
            lines.append(
                f"  quality_online_ndcg: {cand_ndcg:.4f} vs {base_ndcg:.4f}"
            )
        cand_psi = _finite(cand_quality.get("drift_psi_peak"))
        base_psi = _finite(base_quality.get("drift_psi_peak"))
        if cand_quality.get("drift_phase") and base_quality.get("drift_phase"):
            check_lower_better("quality_drift_psi", cand_psi, base_psi, threshold)
        else:
            surface_rate(
                "quality_drift_psi", cand_psi, base_psi,
                "drift phase ran on one side only",
            )
    # tail-attribution gate: a hop's SHARE of the p99 mix growing by more
    # than 10 points is a regression even when p99 itself is flat — where
    # the tail's time goes is its own contract (e.g. queue_wait swallowing
    # the mix says batching went wrong before latency SLOs notice). Absolute
    # point shift, not relative: a 2%→4% hop doubling is noise, 30%→42%
    # is not. Chaos-phase-matched like the fleet latency gates; smaller
    # shifts (≥ 2 points) are surfaced without gating.
    cand_attr = candidate.get("tail_attribution") or {}
    base_attr = baseline.get("tail_attribution") or {}
    cand_p99_mix = ((cand_attr.get("quantiles") or {}).get("p99") or {}).get("fractions")
    base_p99_mix = ((base_attr.get("quantiles") or {}).get("p99") or {}).get("fractions")
    if isinstance(cand_p99_mix, Mapping) and isinstance(base_p99_mix, Mapping):
        attr_chaos_match = bool((candidate.get("fleet") or {}).get("chaos")) == bool(
            (baseline.get("fleet") or {}).get("chaos")
        )
        for name in sorted(set(cand_p99_mix) | set(base_p99_mix)):
            cand_frac = _finite(cand_p99_mix.get(name))
            base_frac = _finite(base_p99_mix.get(name))
            if cand_frac is None or base_frac is None:
                continue
            shift = cand_frac - base_frac
            if abs(shift) >= 0.02:
                lines.append(
                    f"  tail_p99_share/{name}: {cand_frac:.1%} vs {base_frac:.1%}"
                )
            if shift > 0.10:
                if attr_chaos_match:
                    regressions.append(
                        f"tail_p99_share/{name} grew {base_frac:.1%} -> "
                        f"{cand_frac:.1%} (> 10-point shift in the p99 hop mix)"
                    )
                else:
                    lines.append(
                        f"  tail_p99_share/{name}: not gated "
                        "(chaos phase ran on one side only)"
                    )
    # cross-host balance: the straggler index (max/median per-host step time)
    # gates lower-better, but ONLY between two genuinely multi-process runs —
    # a single-process run's index is 1.0 by construction and comparing it
    # against a real fleet would read as a free pass (or a fake regression)
    cand_procs = candidate.get("processes") or {}
    base_procs = baseline.get("processes") or {}
    cand_multi = (cand_procs.get("count") or 0) > 1
    base_multi = (base_procs.get("count") or 0) > 1
    cand_straggler = _finite(cand_procs.get("straggler_index"))
    base_straggler = _finite(base_procs.get("straggler_index"))
    if cand_multi and base_multi:
        check_lower_better(
            "straggler_index", cand_straggler, base_straggler, threshold
        )
    elif cand_straggler is not None or base_straggler is not None:
        lines.append(
            f"  straggler_index: candidate={_fmt(cand_straggler, '{:.3f}')} "
            f"baseline={_fmt(base_straggler, '{:.3f}')} "
            "(not gated: both runs must be multi-process)"
        )
    cand_gp, base_gp = candidate.get("goodput"), baseline.get("goodput")
    if cand_gp and base_gp:
        for name in (
            *GOODPUT_SPANS,
            *(n for n in SERVE_GOODPUT_SPANS if n not in GOODPUT_SPANS),
            "other",
        ):
            cand_frac = float((cand_gp.get("fractions") or {}).get(name, 0.0))
            base_frac = float((base_gp.get("fractions") or {}).get(name, 0.0))
            if abs(cand_frac - base_frac) >= 0.01:
                lines.append(
                    f"  goodput/{name}: {cand_frac:.1%} vs {base_frac:.1%}"
                )
    return lines, regressions


# --------------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------------- #
def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m replay_tpu_torch.obs.report",
        description="Summarize a run's events.jsonl (+ trace.json) into a run report.",
    )
    parser.add_argument(
        "run", help="run directory, events.jsonl path, or single-record bench JSON"
    )
    parser.add_argument(
        "--compare",
        metavar="RUN",
        help="baseline run (same formats); exits non-zero on regression",
    )
    parser.add_argument(
        "--threshold",
        type=float,
        default=0.1,
        help="relative regression threshold for --compare (default 0.1 = 10%%)",
    )
    parser.add_argument(
        "--memory-threshold",
        type=float,
        default=None,
        help="relative growth threshold for peak_memory_bytes (lower-better "
        "gate; default: --threshold)",
    )
    parser.add_argument(
        "--compile-threshold",
        type=float,
        default=None,
        help="relative growth threshold for compile_seconds (lower-better "
        "gate; default: max(--threshold, 0.5) — compile time is machine-noisy)",
    )
    parser.add_argument(
        "--json", action="store_true", help="emit the summary as JSON instead of text"
    )
    parser.add_argument(
        "--postmortem",
        action="store_true",
        help="reconstruct per-process last-known-activity timelines from "
        "flight rings + event shards + worker meta + checkpoint sidecars "
        "(obs.postmortem); writes <run_dir>/postmortem.json. Torn rings and "
        "damaged shards are reported, never fatal.",
    )
    args = parser.parse_args(argv)

    if args.postmortem:
        from .postmortem import build_postmortem, render_postmortem

        try:
            post = build_postmortem(args.run)
        except (OSError, ValueError) as exc:
            print(f"report: cannot post-mortem {args.run}: {exc}", file=sys.stderr)
            return 1
        out_path = os.path.join(args.run, "postmortem.json")
        with open(out_path, "w") as fh:
            json.dump(post, fh, indent=2, default=str)
            fh.write("\n")
        if args.json:
            print(json.dumps(post, indent=2, default=str))
        else:
            print(render_postmortem(post))
            print(f"  written: {out_path}")
        return 0

    try:
        summary = summarize_run(args.run)
    except (OSError, ValueError) as exc:
        print(f"report: cannot parse {args.run}: {exc}", file=sys.stderr)
        return 1

    if args.json:
        print(json.dumps(summary, indent=2, allow_nan=False, default=str))
    else:
        print(render(summary))

    if args.compare:
        try:
            baseline = summarize_run(args.compare)
        except (OSError, ValueError) as exc:
            print(f"report: cannot parse {args.compare}: {exc}", file=sys.stderr)
            return 1
        lines, regressions = compare_runs(
            summary,
            baseline,
            threshold=args.threshold,
            memory_threshold=args.memory_threshold,
            compile_threshold=args.compile_threshold,
        )
        print()
        print("\n".join(lines))
        if regressions:
            for regression in regressions:
                print(f"REGRESSION: {regression}", file=sys.stderr)
            return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
