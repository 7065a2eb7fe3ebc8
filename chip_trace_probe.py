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
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

import chip_smoke as smoke


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--traces", type=int, default=24)
    parser.add_argument("--margin-ms", type=float, default=50.0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_trace_probe: torch sees no CUDA device", file=sys.stderr)
        return 2
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


if __name__ == "__main__":
    sys.exit(main())
