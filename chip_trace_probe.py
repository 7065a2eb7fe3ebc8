#!/usr/bin/env python3
"""Do warm profiler traces of CUDA-graph encodes lose kernel events when the
profiler's window closes right after the work?

    python3 chip_trace_probe.py [--traces 24] [--margin-ms 50]

On one NVIDIA GPU: builds K4 and ``chip_smoke.py``'s serving model
(``bench_serve.py``'s width: 3,706 items, E=64, 2 blocks, L=50) behind
``ScoringEngine``, then takes ``--traces`` warm traces of 20 encodes at each
(length, batch) bucket through ``chip_smoke.profiled_window``, alternating
its margin between 0 and ``--margin-ms`` from trace to trace. A trace is
sound where the K4 kernels in it equal the K4 launches counted through the
replays (20 encodes × 2 blocks). Prints one JSON line per margin (traces,
unsound traces, their (counted, traced) readings), then the card's name and
power limit. Imports nothing of JAX.

    python3 chip_trace_probe.py --fleet-windows 12 [--filler-sessions 40] [--groups 2]

The fleet's question instead: does a warm trace of one second of the fleet
phase's traffic (three ``ScoringService`` replicas of the same model behind
``ServingFleet``, three serve workers replaying their graphs at once) hold
every K4 kernel that the counts saw? Takes ``--fleet-windows`` such traces,
then, ``--groups`` times in all, ``--filler-sessions`` profiler sessions of
20 encodes each (as the script's earlier phases open many) before as many
fleet traces again. Each
trace is read three ways: ``key_averages()``, ``events()`` and the exported
Chrome trace, where every ``cudaGraphLaunch`` is matched to the kernels of
its correlation id. Prints one JSON line per trace and a summary line.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys
import tempfile
import time

import numpy as np
import torch

import chip_smoke as smoke


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--traces", type=int, default=24)
    parser.add_argument("--margin-ms", type=float, default=50.0)
    parser.add_argument("--fleet-windows", type=int, default=0)
    parser.add_argument("--filler-sessions", type=int, default=40)
    parser.add_argument("--groups", type=int, default=2)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_trace_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
    if args.fleet_windows:
        return fleet_probe(args.fleet_windows, args.filler_sessions, args.groups)
    from torch.autograd import DeviceType

    from replay_tpu_torch.data import FeatureHint, FeatureType
    from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema
    from replay_tpu_torch.nn.sequential.sasrec import SasRec
    from replay_tpu_torch.ops import build
    from replay_tpu_torch.ops.flash_attention import flash_attention
    from replay_tpu_torch.serve import ScoringEngine, make_window

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(["flash_attention"])
    device = torch.device("cuda", 0)
    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
            cardinality=smoke.NUM_ITEMS, embedding_dim=smoke.EMBEDDING_DIM,
        )
    )
    model = SasRec(
        schema, use_flash=True, generator=torch.Generator().manual_seed(smoke.SEED), embedding_dim=smoke.EMBEDDING_DIM,
        num_blocks=smoke.NUM_BLOCKS, num_heads=smoke.NUM_HEADS, max_sequence_length=smoke.SEQ_LEN, device=device,
    )
    engine = ScoringEngine(
        model, model.state_dict(), length_buckets=smoke.LENGTH_BUCKETS, batch_buckets=smoke.BATCH_BUCKETS, device=device
    )
    requests = smoke.histories(np.random.default_rng(smoke.SEED), 48)
    calls, margins = 20, (0.0, args.margin_ms / 1e3)
    readings = {m: [] for m in margins}
    for trace in range(args.traces):
        for lb in smoke.LENGTH_BUCKETS:
            for bucket in smoke.BATCH_BUCKETS:
                windows = [make_window(requests[i % len(requests)], lb) for i in range(bucket)]
                ids, mask = np.stack([w[0] for w in windows]), np.stack([w[1] for w in windows])
                margin = margins[trace % 2]
                with smoke.profiled_window(lambda: engine.encode(lb, ids, mask), margin=margin) as prof:
                    before = flash_attention.launches
                    for _ in range(calls):
                        engine.encode(lb, ids, mask)
                events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
                counted = flash_attention.launches - before
                traced = smoke.traced_kernels(events, [flash_attention])["flash_attention"]
                readings[margin].append({"L": lb, "B": bucket, "counted": counted, "traced": traced})
    for margin, rows in readings.items():
        unsound = [r for r in rows if r["traced"] != r["counted"]]
        print(json.dumps({
            "probe": "encode_traces", "margin_ms": margin * 1e3, "traces": len(rows), "unsound": len(unsound),
            "unsound_readings": unsound, "kernels_lost": sum(r["counted"] - r["traced"] for r in unsound),
        }), flush=True)
    engine.close()
    print(smoke.nvidia_smi_line(), flush=True)
    return 0


def chrome_reading(path: str, blocks: int) -> dict:
    """K4 in an exported Chrome trace: its kernels, the graph launches, the
    launches that hold some but not all ``blocks`` K4 kernels of a replay,
    K4 kernels of no graph launch, K4 by stream, the first and last K4
    against the trace's own ends (µs), each kernel's start less its launch
    call's start (µs: below 0, the device's clock reads early against the
    host's), and kineto's record counts where its log lines are in the trace."""
    with open(path) as fh:
        payload = json.load(fh)
    events = [e for e in payload["traceEvents"] if isinstance(e, dict)]
    k4_name = re.compile(smoke.TRACE_NAMES["flash_attention"])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k4 = [e for e in kernels if k4_name.search(e.get("name", ""))]
    calls = {
        e["args"]["correlation"]: e for e in events
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})
    }
    launches = {c: e for c, e in calls.items() if "GraphLaunch" in e.get("name", "")}
    found = collections.Counter(e.get("args", {}).get("correlation") for e in k4)
    partial = [c for c in launches if 0 < found.get(c, 0) < blocks]
    lead = sorted(
        float(e["ts"]) - float(calls[e["args"]["correlation"]]["ts"])
        for e in kernels if e.get("args", {}).get("correlation") in calls
    )
    stamps = [float(e["ts"]) for e in events if "ts" in e and e.get("ph") == "X"]
    k4_stamps = [float(e["ts"]) for e in k4]
    logged = [
        str(line)[:300] for level in ("INFO", "WARNING", "ERROR") for line in payload.get(level) or ()
        if re.search(r"Record counts|ropped|[Oo]ut-of-range", str(line))
    ]
    return {
        "k4": len(k4), "graph_launches": len(launches), "partial_launches": len(partial),
        "k4_outside_graphs": sum(1 for e in k4 if e.get("args", {}).get("correlation") not in launches),
        "k4_by_stream": dict(collections.Counter(str(e.get("args", {}).get("stream")) for e in k4)),
        "first_k4_after_start_us": min(k4_stamps) - min(stamps) if k4_stamps else None,
        "last_k4_before_end_us": max(stamps) - max(k4_stamps) if k4_stamps else None,
        "kernel_after_launch_us": {
            "min": lead[0] if lead else None, "median": lead[len(lead) // 2] if lead else None,
            "negative": sum(1 for d in lead if d < 0), "of": len(lead),
        },
        "kineto_log": logged,
        "log_levels": {level: len(payload.get(level) or ()) for level in ("INFO", "WARNING", "ERROR")},
    }


def fleet_probe(windows: int, fillers: int, groups: int) -> int:
    """The ``--fleet-windows`` probe (see the module's docstring)."""
    from torch.autograd import DeviceType

    from replay_tpu_torch.obs import QualityMonitor, Tracer
    from replay_tpu_torch.ops import build
    from replay_tpu_torch.ops.flash_attention import flash_attention
    from replay_tpu_torch.serve import ScoringEngine, ServingFleet, make_window

    torch.backends.cuda.matmul.allow_tf32 = False
    build.build_all(["flash_attention"])
    device = torch.device("cuda", 0)
    model, _, params, fallback, descriptor = smoke.fleet_models(device)
    services = {
        f"r{i}": smoke.fleet_service(
            model, params, fallback, device, tracer=Tracer(enabled=True), quality=QualityMonitor(descriptor)
        )
        for i in range(smoke.FLEET_REPLICAS)
    }
    filler = ScoringEngine(model, params, batch_buckets=smoke.BATCH_BUCKETS, device=device)
    requests = smoke.histories(np.random.default_rng(smoke.SEED), 64)
    windows_ids = [make_window(requests[i], smoke.SEQ_LEN) for i in range(64)]
    ids, mask = np.stack([w[0] for w in windows_ids]), np.stack([w[1] for w in windows_ids])
    k4_name = re.compile(smoke.TRACE_NAMES["flash_attention"])
    traffic = smoke.FleetTraffic(smoke.FLEET_USERS, smoke.NUM_ITEMS, smoke.SEQ_LEN)
    rows, scratch, started = [], tempfile.mkdtemp(prefix="fleet_probe_"), time.perf_counter()
    with ServingFleet(services, hedge_ms=None, heartbeat_interval_s=smoke.FLEET_HEARTBEAT_S) as fleet:
        smoke.fleet_closed_loop(fleet, traffic, seed=200)  # histories, every bucket's graph, the hedge delay
        for group in range(groups):
            if group:
                for _ in range(fillers):
                    with smoke.profiled_window(lambda: filler.encode(smoke.SEQ_LEN, ids, mask)):
                        for _ in range(20):
                            filler.encode(smoke.SEQ_LEN, ids, mask)
            for index in range(windows):
                replays = {rid: h.service.engine.encode_calls for rid, h in fleet.handles.items()}
                with smoke.profiled_window(lambda: torch.ones(1, device="cuda").add_(1)) as prof:
                    smoke.fleet_quiet(fleet)
                    before = flash_attention.launches
                    loop = smoke.open_loop(
                        lambda rng: traffic.submit(fleet, rng), 1.0, np.random.default_rng(1000 + len(rows)),
                        smoke.FLEET_RATE, smoke.FLEET_WAIT_S, smoke.fleet_classify,
                    )
                    smoke.fleet_quiet(fleet)
                    counted_inside = flash_attention.launches - before
                counted = flash_attention.launches - before
                path = os.path.join(scratch, f"w{len(rows)}.json")
                prof.export_chrome_trace(path)
                row = {
                    "probe": "fleet_window", "group": group, "index": index, "process_s": time.perf_counter() - started,
                    "requests": len(loop["records"]),
                    "hedges": fleet.stats()["hedges"], "counted": counted, "counted_inside": counted_inside,
                    "replays": {rid: h.service.engine.encode_calls - replays[rid] for rid, h in fleet.handles.items()},
                    "key_averages": smoke.traced_kernels(smoke.device_events(prof.key_averages()), [flash_attention])[
                        "flash_attention"
                    ],
                    "events": sum(
                        1 for e in prof.events() if e.device_type == DeviceType.CUDA and k4_name.search(e.name)
                    ),
                    **chrome_reading(path, smoke.NUM_BLOCKS),
                }
                os.remove(path)
                rows.append(row)
                print(json.dumps(row), flush=True)
    filler.close()
    lossy = [r for r in rows if r["key_averages"] != r["counted"] or r["k4"] != r["counted"]]
    print(json.dumps({
        "probe": "fleet_summary", "windows": len(rows), "lossy": len(lossy),
        "lossy_by_group": dict(collections.Counter(r["group"] for r in lossy)),
        "key_averages_lost": sum(r["counted"] - r["key_averages"] for r in rows),
        "events_lost": sum(r["counted"] - r["events"] for r in rows),
        "chrome_lost": sum(r["counted"] - r["k4"] for r in rows),
        "partial_launches": sum(r["partial_launches"] for r in rows),
    }), flush=True)
    print(smoke.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
