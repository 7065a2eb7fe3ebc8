"""The port's fleet tracing, federation and run report against the JAX
package's, on the CPU.

* ``merge_traces`` and ``tail_attribution`` on the same trace files (seeded
  router and replica shards, and shards recorded by the port's ``Tracer``):
  the same merged trace and the same per-hop tail mix.
* ``federate_snapshots`` over the same ``/snapshot`` documents (each served
  by an exporter of either package): the same federated registry, the same
  refusal of mismatched histogram bounds, and ``FleetFederator`` scraping live
  members of both packages.
* One run directory written by a port fleet of two demo-size replicas: the
  router's ``events.jsonl``, each replica's ``events.p<i>.jsonl`` shard and
  flight ring, the merged ``trace.json`` and a fleet record. Both packages'
  ``python -m ...obs.report`` render it byte for byte alike, in every mode,
  with the same exit codes under ``--compare``; ``--postmortem`` and
  ``build_postmortem`` give the same result.
* ``ConsoleLogger`` renders the serving, fleet, promotion and quality events
  as the JAX package's does, line for line.
"""

import contextlib
import io
import json
import logging
import shutil
import urllib.request

import numpy as np
import pytest
import torch

from replay_tpu.obs import events as jax_events
from replay_tpu.obs import exporter as jax_exporter
from replay_tpu.obs import federate as jax_federate
from replay_tpu.obs import metrics as jax_metrics
from replay_tpu.obs import postmortem as jax_postmortem
from replay_tpu.obs import report as jax_report
from replay_tpu.obs import trace as jax_trace
from replay_tpu_torch.data import FeatureHint, FeatureType
from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu_torch.nn.sequential.sasrec import SasRec
from replay_tpu_torch.obs import JsonlLogger, PopularityDescriptor, QualityMonitor, Tracer
from replay_tpu_torch.obs import events as port_events
from replay_tpu_torch.obs import exporter as port_exporter
from replay_tpu_torch.obs import federate as port_federate
from replay_tpu_torch.obs import metrics as port_metrics
from replay_tpu_torch.obs import postmortem as port_postmortem
from replay_tpu_torch.obs import report as port_report
from replay_tpu_torch.obs import trace as port_trace
from replay_tpu_torch.serve import FallbackScorer, ScoringService, ServingFleet

NUM_ITEMS, DIM, SEQ_LEN = 64, 8, 12
WAIT_S = 10.0


# --------------------------------------------------------------------------- #
# merged traces and the tail attribution
# --------------------------------------------------------------------------- #
HOPS = ("route", "queue_wait", "batch_build", "score", "backoff_wait", "hedge_wait")


def _shards(seed, requests=120):
    """A router shard and two replica shards, each on its own epoch: every
    request a root span on the router and hop spans on its replica, some
    batch spans shared by several requests (``trace_ids``)."""
    rng = np.random.default_rng(seed)
    shards = {label: {"traceEvents": [{"name": "process_name", "ph": "M", "pid": 9, "tid": 0, "args": {"name": "x"}}],
                      "displayTimeUnit": "ms",
                      "otherData": {"trace_epoch_unix": 1_700_000_000.0 + offset}}
              for label, offset in (("router", 0.25), ("r0", 0.0), ("r1", 1.5))}
    for request in range(requests):
        trace_id = f"{request:032x}"
        start = float(rng.uniform(0, 5e6))
        total = float(rng.gamma(2.0, 2000.0))
        shards["router"]["traceEvents"].append(
            {"name": "request", "ph": "X", "ts": start, "dur": total, "pid": 1, "tid": 1, "args": {"trace_id": trace_id}}
        )
        replica = shards[f"r{request % 2}"]["traceEvents"]
        for hop in rng.choice(HOPS, size=int(rng.integers(1, 5)), replace=True):
            replica.append({"name": str(hop), "ph": "X", "ts": start + float(rng.uniform(0, total)),
                            "dur": float(rng.uniform(0, total * 0.7)), "pid": 2, "tid": 3, "args": {"trace_id": trace_id}})
        if request % 4 == 0:
            ids = [f"{request - i:032x}" for i in range(min(request, 3) + 1)]
            replica.append({"name": "score", "ph": "X", "ts": start, "dur": total * 0.2, "pid": 2, "tid": 4,
                            "args": {"trace_ids": ids}})
    return shards


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("quantiles", [(0.5, 0.99), (0.0, 0.9, 0.999)], ids=["p50_p99", "p0_p90_p999"])
def test_merge_traces_and_tail_attribution_equal(seed, quantiles, tmp_path):
    shards = _shards(seed)
    files = {}
    for label, shard in shards.items():
        files[label] = tmp_path / f"{label}.json"
        files[label].write_text(json.dumps(shard))
    loaded = {label: json.loads(path.read_text()) for label, path in files.items()}
    port = port_trace.merge_traces(loaded, str(tmp_path / "port" / "trace.json"))
    jax = jax_trace.merge_traces(loaded, str(tmp_path / "jax" / "trace.json"))
    assert port == jax
    assert (tmp_path / "port" / "trace.json").read_bytes() == (tmp_path / "jax" / "trace.json").read_bytes()
    events = port["traceEvents"]
    attribution = port_trace.tail_attribution(events, quantiles=quantiles)
    assert attribution == jax_trace.tail_attribution(events, quantiles=quantiles)
    assert attribution["requests"] == 120
    for mix in attribution["quantiles"].values():
        assert abs(sum(mix["fractions"].values()) - 1.0) < 1e-9
    assert port_trace.tail_attribution([]) is None and jax_trace.tail_attribution([]) is None


def test_the_port_tracer_writes_what_merge_traces_reads():
    router, replica = Tracer(), Tracer()
    router.add_span("request", 0.0, 0.01, trace_id="t1")
    with replica.span("score", trace_ids=["t1"]):
        pass
    for shard in (router, replica):
        assert shard.to_chrome_trace()["otherData"]["trace_epoch_unix"] > 0
    traces = {"router": router.to_chrome_trace(), "r0": replica.to_chrome_trace()}
    merged = port_trace.merge_traces(traces)
    assert merged == jax_trace.merge_traces(traces)
    assert merged["otherData"]["tracks"] == {"router": 1, "r0": 2}
    assert [e["args"]["name"] for e in merged["traceEvents"] if e["ph"] == "M"] == ["router", "r0"]
    assert port_trace.REQUEST_HOP_SPANS == jax_trace.REQUEST_HOP_SPANS


# --------------------------------------------------------------------------- #
# federation
# --------------------------------------------------------------------------- #
def _registry(metrics, seed, bounds=(1.0, 5.0, 25.0)):
    rng = np.random.default_rng(seed)
    registry = metrics.MetricsRegistry()
    registry.inc("replay_serve_rows_total", float(rng.integers(1, 500)))
    registry.inc("replay_serve_degraded_total", float(rng.integers(0, 9)), labels={"to": "fallback"})
    registry.set("replay_serve_cache_hit_rate", float(rng.random()))
    registry.set("replay_serve_lane_depth", float(rng.integers(0, 16)), labels={"lane": "encode:50"})
    for value in rng.gamma(2.0, 4.0, size=int(rng.integers(5, 50))):
        registry.observe("replay_serve_queue_wait_ms", float(value), buckets=bounds)
    return registry


def _snapshot(exporter_module, registry, process_index):
    exporter = exporter_module.MetricsExporter(registry, port=0, identity={"process_index": process_index})
    exporter.start()
    try:
        return json.loads(_get(f"{exporter.url}/snapshot"))
    finally:
        exporter.close()


def _get(url):
    with urllib.request.urlopen(url, timeout=WAIT_S) as reply:
        return reply.read().decode()


@pytest.mark.parametrize("members", [1, 3, 5])
def test_federate_snapshots_equal(members):
    snapshots = [
        _snapshot(port_exporter if i % 2 else jax_exporter, _registry(port_metrics if i % 2 else jax_metrics, i), i)
        for i in range(members)
    ]
    port = port_federate.federate_snapshots(snapshots)
    jax = jax_federate.federate_snapshots(snapshots)
    assert port.render_prometheus() == jax.render_prometheus()
    assert port.value("replay_serve_rows_total") == sum(s["replay_serve_rows_total"]["value"] for s in snapshots)
    labels = [f"m{i}" for i in range(members)]
    assert (port_federate.federate_snapshots(snapshots, labels).render_prometheus()
            == jax_federate.federate_snapshots(snapshots, labels).render_prometheus())


def test_federation_refuses_mismatched_bounds_and_scrapes_live_members():
    snapshots = [_snapshot(port_exporter, _registry(port_metrics, 0), 0),
                 _snapshot(jax_exporter, _registry(jax_metrics, 1, bounds=(2.0, 10.0)), 1)]
    for federate in (port_federate, jax_federate):
        with pytest.raises(federate.FederationError, match="replay_serve_queue_wait_ms"):
            federate.federate_snapshots(snapshots)
    exporters = [port_exporter.MetricsExporter(_registry(port_metrics, 2), port=0, identity={"process_index": 0}),
                 jax_exporter.MetricsExporter(_registry(jax_metrics, 3), port=0, identity={"process_index": 1})]
    for exporter in exporters:
        exporter.start()
    try:
        targets = [exporter.url for exporter in exporters]
        scraped = [port_federate.scrape_snapshot(target) for target in targets]
        assert scraped == [jax_federate.scrape_snapshot(target) for target in targets]
        expected = jax_federate.federate_snapshots(scraped).render_prometheus()
        with port_federate.FleetFederator(targets, port=0, interval_s=60.0) as federator:
            merged = federator.scrape()
            served = _get(f"{federator.exporter.url}/metrics")
        assert merged.errors == {} and len(merged.members) == 2

        def members(text):
            return [line for line in text.splitlines() if "replay_federation" not in line]

        assert members(merged.registry.render_prometheus()) == members(expected) == members(served)
        assert merged.registry.value("replay_federation_reachable") == 2.0
    finally:
        for exporter in exporters:
            exporter.close()


# --------------------------------------------------------------------------- #
# a port fleet's run directory through both reports
# --------------------------------------------------------------------------- #
def _service(model, popularity, run_dir, index, tracer, descriptor):
    return ScoringService(
        model, model.state_dict(), device="cpu", batch_buckets=(1, 8), max_wait_ms=1.0, cache_capacity=64,
        cold_miss="fallback", fallback=FallbackScorer.from_interactions(popularity, NUM_ITEMS),
        logger=JsonlLogger(str(run_dir), mode="w", process_index=index + 1), tracer=tracer,
        quality=QualityMonitor(descriptor, emit_every=8), flight_path=str(run_dir / f"flight.s{index}.ring"),
    )


@pytest.fixture(scope="module")
def fleet_run(tmp_path_factory):
    """A port fleet's run directory: two replicas, traffic, a replica closed
    and revived, the merged trace and the fleet record, as a fleet benchmark
    leaves them."""
    run_dir = tmp_path_factory.mktemp("port_fleet_run")
    schema = TensorSchema(
        TensorFeatureInfo("item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
                          cardinality=NUM_ITEMS, embedding_dim=DIM)
    )
    model = SasRec(schema, embedding_dim=DIM, num_blocks=1, num_heads=1, max_sequence_length=SEQ_LEN,
                   dropout_rate=0.0, use_flash=True, device="cpu", generator=torch.Generator().manual_seed(2))
    rng = np.random.default_rng(4)
    popularity = rng.integers(0, NUM_ITEMS, size=2048)
    descriptor = PopularityDescriptor.from_train({0: popularity.tolist()}, num_items=NUM_ITEMS)
    tracers = {f"r{i}": Tracer() for i in range(2)}
    services = {rid: _service(model, popularity, run_dir, i, tracers[rid], descriptor) for i, rid in enumerate(tracers)}
    router = Tracer()
    fleet_logger = JsonlLogger(str(run_dir), mode="w")
    fleet = ServingFleet(services, heartbeat_interval_s=None, hedge_ms=0, logger=fleet_logger, tracer=router)
    histories = {u: rng.integers(0, NUM_ITEMS, size=int(rng.integers(1, 2 * SEQ_LEN))).tolist() for u in range(16)}
    with fleet:
        for user, history in histories.items():
            fleet.score(user, history=history, timeout=WAIT_S)
        for user in rng.integers(0, 16, 24):
            fleet.score(int(user), new_items=[int(rng.integers(0, NUM_ITEMS))], timeout=WAIT_S)
        services["r1"].close()
        for _ in range(3):
            fleet.poll()
        victims = [u for u in histories if fleet.ring.route(u) == "r1"]
        failover = [fleet.score(u, timeout=WAIT_S) for u in victims]
        services["r1"].start()
        fleet.poll()
        stats = fleet.stats()
    port_trace.merge_traces({"router": router, **tracers}, str(run_dir / "trace.json"))
    record = {
        "metric": "fleet_qps", "value": 123.4, "unit": "req/s", "qps": 123.4, "p50_ms": stats["p50_ms"],
        "p99_ms": stats["p99_ms"], "replicas": 2, "requests": stats["requests"], "reroutes": stats["reroutes"],
        "reroute_rate": stats["reroute_rate"], "cache_hit_locality": 0.97, "hung_requests": 0,
        "fleet_error_rate": stats["error_rate"], "single_replica_qps": 80.0, "single_replica_hit_rate": 0.5,
        "replica_shards": {"1": "r0", "2": "r1"}, "quality": stats.get("quality"),
        "chaos": {"killed": "r1", "revived": True, "failover_gap_ms": 12.5, "reroutes": len(victims),
                  "hung_requests": 0, "error_rate": 0.0, "failover_served_by": failover[0].served_by},
        "drain_swap": {"replicas_swapped": 2, "drained": 2, "errors": 0, "generations": [1], "p99_ms": 9.0},
    }
    fleet_logger.log_record(record)
    fleet_logger.close()
    for service in services.values():
        service.logger.close()
    return run_dir, record, failover


def _cli(module, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        code = module.main(argv)
    return code, out.getvalue(), err.getvalue()


def _baseline(fleet_run, tmp_path, qps):
    run_dir, record, _ = fleet_run
    baseline = tmp_path / "baseline"
    shutil.copytree(run_dir, baseline)
    lines = (baseline / "events.jsonl").read_text().splitlines()
    lines[-1] = json.dumps({**json.loads(lines[-1]), "qps": qps, "value": qps})
    (baseline / "events.jsonl").write_text("\n".join(lines) + "\n")
    return str(baseline)


MODES = {
    "render": lambda run, tmp: [run],
    "json": lambda run, tmp: [run, "--json"],
    "events_file": lambda run, tmp: [f"{run}/events.jsonl"],
    "compare_same": lambda run, tmp: [run, "--compare", run],
    "compare_faster_baseline": lambda run, tmp: [run, "--compare", tmp["fast"]],
    "compare_within_threshold": lambda run, tmp: [run, "--compare", tmp["fast"], "--threshold", "0.9"],
    "compare_slower_baseline": lambda run, tmp: [run, "--compare", tmp["slow"]],
    "missing": lambda run, tmp: [f"{run}/nothing_here"],
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_both_reports_read_a_port_fleet_run_alike(fleet_run, tmp_path, mode):
    run_dir, record, _ = fleet_run
    extra = {"fast": _baseline(fleet_run, tmp_path / "f", 400.0), "slow": _baseline(fleet_run, tmp_path / "s", 60.0)}
    argv = MODES[mode](str(run_dir), extra)
    port = _cli(port_report, argv)
    jax = _cli(jax_report, argv)
    assert port == jax
    code, out, _ = port
    assert code == {"compare_faster_baseline": 2, "missing": 1}.get(mode, 0)
    if mode == "render":
        assert "fleet" in out and "tail attribution" in out
    if mode == "json":
        summary = json.loads(out)
        assert set(summary["fleet"]["per_replica"]) >= {"r0", "r1"}
        assert summary["fleet"]["qps"] == record["qps"] and summary["fleet"]["failover_events"] == 1


def test_postmortem_of_a_port_fleet_run_equal(fleet_run):
    run_dir, _, failover = fleet_run
    port = port_postmortem.build_postmortem(str(run_dir))
    assert port == jax_postmortem.build_postmortem(str(run_dir))
    assert set(port["processes"]) >= {"s0", "s1", "rank1", "rank2"} and port["unreadable_rings"] == 0
    code, out, _ = _cli(port_report, [str(run_dir), "--postmortem"])
    assert code == 0 and (run_dir / "postmortem.json").is_file()
    assert (code, out) == _cli(jax_report, [str(run_dir), "--postmortem"])[:2]
    assert {r.served_by for r in failover} == {"fallback"}


CONSOLE_EVENTS = {
    "on_shed": {"count": 3, "lane": "encode:50", "depth": 16, "max_depth": 16},
    "on_breaker": {"from": "closed", "to": "open", "consecutive_failures": 5},
    "on_degrade": {"count": 2, "to": "fallback", "reason": "breaker_open"},
    "on_replica_health": {"replica": "r1", "from": "healthy", "to": "dead", "reason": "heartbeat"},
    "on_failover": {"replica": "r1", "reason": "heartbeat", "users_fraction": 1 / 3},
    "on_hedge": {"user_id": "7", "primary": "r0", "hedge": "r2"},
    "on_fleet_start": {"replicas": ["r0", "r1"], "vnodes": 64, "hedge_ms": None, "max_retries": 2},
    "on_fleet_end": {"requests": 10, "replicas": 2, "reroutes": 1, "retries": 0, "hedges": 1, "hedge_wins": 1, "p99_ms": 4.5},
    "on_swap": {"label": "v2", "from_generation": 0, "to_generation": 1, "recompiled": False},
    "on_promotion": {"generation": 2, "from_generation": 1, "clean_evals": 3},
    "on_rollback": {"generation": 2, "restored_generation": 1, "rules": ["canary_error_rate"]},
    "on_quality_window": {"role": "stable", "requests": 64, "k": 10, "online_hitrate": 0.1, "online_hitrate_cum": 0.2,
                          "joins": 5, "coverage": 0.3, "novelty": 0.4, "surprisal": 0.5, "ild": 0.6,
                          "drift": {"max": 0.07}},
    "on_drift_warning": {"psi": 0.3, "series": "score", "threshold": 0.25, "psi_max": 0.3},
    "on_serve_end": {"requests": 9, "cache_hit_rate": 0.5, "batch_fill_ratio": 0.25, "queue_wait_ms_mean": 1.5},
}


@pytest.mark.parametrize("name", sorted(CONSOLE_EVENTS))
def test_console_renders_the_serving_events_as_jax(name, caplog):
    lines = {}
    for package, module in (("jax", jax_events), ("port", port_events)):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            module.ConsoleLogger().log_event(module.TrainerEvent(event=name, payload=dict(CONSOLE_EVENTS[name])))
        lines[package] = [(r.levelname, r.getMessage()) for r in caplog.records]
    assert lines["port"] == lines["jax"] and len(lines["port"]) == 1
