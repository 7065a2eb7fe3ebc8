#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``replay_tpu_torch``, never the JAX package) through its
serving path at the ``bench_serve.py`` width and holds every kernel of that
path against its plain PyTorch version. Phases, one JSON line each:

1. ``env``     — the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. ``build``   — compile the kernels from ``replay_tpu_torch/csrc/`` with nvcc for sm_90a;
3. ``kernel``  — K4 against ``flash_attention_reference`` at three shapes, f32 and bf16,
                 with the kernel's, the plain version's and ``scaled_dot_product_attention``'s
                 times and the card's bound for the same work;
4. ``serve``   — ``SasRec(use_flash=True)`` behind ``ScoringEngine`` answering requests,
                 checked against an engine on the same weights with ``use_flash=False``;
5. ``kernels`` — every ported kernel with its launches on the serving path.

Then the card's name and power limit on a line of their own, one JSON object
listing the kernels, and, as the last line, ``{"ok": true, "device": ...}``.
Any failed check raises: the script exits non-zero and never falls back to
the CPU. It needs one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# bench_serve.py's model: MovieLens-1M catalog, E=64, 2 blocks, 1 head, L=50
NUM_ITEMS, EMBEDDING_DIM, NUM_BLOCKS, NUM_HEADS, SEQ_LEN = 3706, 64, 2, 1, 50
LENGTH_BUCKETS, BATCH_BUCKETS = (16, 50), (1, 8, 64)
SEED = 0

# H100 SXM data sheet: HBM rate and dense peaks (f32 without tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

# kernel vs plain version, max abs error: f32 differs only in summation order
# (online softmax over 32-key tiles vs one pass); bf16 adds the output's own
# rounding, half an ulp, 1.6e-2 for outputs below 8
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# serving logits, kernel route vs unfused route on the same weights: two encoder
# blocks, each with f32 rounding differences of ~1e-6, amplified by the head
SERVE_TOL = 1e-4

# (name, B, H, L, D, bias heads, mask): the serving width (bench_serve.py), the
# SasRec.from_params width (E=192, 4 heads), and a long row over 32 key tiles
KERNEL_SHAPES = (
    ("serve", 64, 1, 50, 64, 1, "eval"),
    ("from_params", 8, 4, 200, 48, 4, "per_head"),
    ("long", 2, 2, 1024, 64, 1, "train"),
)


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def graph_ms(fn, launches: int = 20, reps: int = 7) -> float:
    """Median device time of one ``fn()`` call: ``launches`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events (so host overhead
    is not in the number). Inputs stay in L2 between calls, as the encoder's
    projections leave them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream, as torch.cuda.graphs asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def eager_ms(fn, launches: int = 50, reps: int = 7) -> float:
    """Median wall time of one eager ``fn()`` call, launch overhead included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


def attention_case(batch, heads, length, dim, bias_heads, mask, dtype, device, seed):
    """q, k, v from a seeded normal; bias as the serving path builds it."""
    from replay_tpu_torch.nn.mask import causal_attention_mask

    rng = np.random.default_rng(seed)
    q, k, v = (
        torch.tensor(rng.standard_normal((batch, heads, length, dim), dtype=np.float32))
        .to(device=device, dtype=dtype)
        for _ in range(3)
    )
    lengths = rng.integers(1, length + 1, batch)
    lengths[-1] = 0  # one all-padding row
    padding = torch.tensor(np.arange(length)[None, :] >= length - lengths[:, None], device=device)
    bias = causal_attention_mask(padding, deterministic=mask != "train")
    if mask == "per_head":
        noise = rng.standard_normal((batch, bias_heads, length, length), dtype=np.float32)
        bias = bias + torch.tensor(noise, device=device)
    return q, k, v, bias


def bound(q: torch.Tensor, bias: torch.Tensor):
    """Least time the card could take for one attention call: each input read
    once, the output written once, over HBM rate; 4·B·H·L²·D FLOP over the
    peak for the inputs' type. Returns (ms, "bytes" | "operations", bytes, flop)."""
    batch, heads, length, dim = q.shape
    moved = 4 * q.numel() * q.element_size() + bias.numel() * 4  # q, k, v, out; f32 bias
    flop = 4 * batch * heads * length * length * dim
    byte_ms = moved / HBM_BYTES_PER_S * 1e3
    flop_ms = flop / PEAK_FLOPS[q.dtype] * 1e3
    return max(byte_ms, flop_ms), ("bytes" if byte_ms >= flop_ms else "operations"), moved, flop


def kernel_phase(device) -> dict:
    """K4 vs its plain version at every shape; returns the serving-shape f32 record."""
    import torch.nn.functional as F

    from replay_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference

    serve_record = None
    for index, (name, batch, heads, length, dim, bias_heads, mask) in enumerate(KERNEL_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, bias = attention_case(batch, heads, length, dim, bias_heads, mask, dtype, device, index)
            got = flash_attention(q, k, v, bias)
            # the plain version on the same input values, its f32 result not
            # rounded: for bf16 the error is then the output's own rounding
            want = flash_attention_reference(q.float(), k.float(), v.float(), bias)
            torch.cuda.synchronize()
            if got.dtype != dtype or got.shape != q.shape:
                raise AssertionError(f"K4 {name} {dtype}: got {got.dtype} {tuple(got.shape)}")
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"K4 {name} {dtype}: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            sdpa_mask = bias.to(dtype)
            bound_ms, bound_by, moved, flop = bound(q, bias)
            record = {
                "shape": name, "B": batch, "H": heads, "L": length, "D": dim,
                "bias_heads": bias_heads, "mask": mask, "dtype": str(dtype).removeprefix("torch."),
                "max_abs_err": err, "tol": KERNEL_TOL[dtype],
                "ms": graph_ms(lambda: flash_attention(q, k, v, bias)),
                "eager_ms": eager_ms(lambda: flash_attention(q, k, v, bias)),
                "plain_ms": graph_ms(lambda: flash_attention_reference(q, k, v, bias)),
                "library_ms": graph_ms(
                    lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=sdpa_mask)
                ),
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved, "flop": flop,
            }
            emit("kernel", **record)
            if err > KERNEL_TOL[dtype]:
                raise AssertionError(f"K4 {name} {dtype}: max abs err {err} > {KERNEL_TOL[dtype]}")
            if name == "serve" and dtype == torch.float32:
                serve_record = record
    return serve_record


def device_time_per_encode(engine, length_bucket, ids, mask, calls: int = 20) -> dict:
    """Device time of one encode from a profiler trace: kernel time summed over
    ``calls`` encodes, per call, and the kernels that take most of it. The
    profiler's own cost inflates the wall time, so the busy share divides by
    the unprofiled p50 instead."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            engine.encode(length_bucket, ids, mask)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {
        "device_ms": sum(e.self_device_time_total for e in kernels) / calls / 1e3,
        "device_kernels": sum(e.count for e in kernels) / calls,
        "top_kernels_ms": {e.key[:60]: e.self_device_time_total / calls / 1e3 for e in kernels[:4]},
    }


def histories(rng, count: int):
    return [list(rng.integers(0, NUM_ITEMS, int(rng.integers(1, 101)))) for _ in range(count)]


def serve_phase(device) -> dict:
    """SasRec(use_flash=True) behind ScoringEngine, checked against use_flash=False."""
    from replay_tpu_torch.data import FeatureHint, FeatureType
    from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema
    from replay_tpu_torch.nn.sequential.sasrec import SasRec
    from replay_tpu_torch.ops.flash_attention import flash_attention
    from replay_tpu_torch.serve import ScoreResponse, ScoringEngine, make_window, top_k_cut

    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
            cardinality=NUM_ITEMS, embedding_dim=EMBEDDING_DIM,
        )
    )
    width = dict(
        embedding_dim=EMBEDDING_DIM, num_blocks=NUM_BLOCKS, num_heads=NUM_HEADS,
        max_sequence_length=SEQ_LEN, device=device,
    )
    model = SasRec(schema, use_flash=True, generator=torch.Generator().manual_seed(SEED), **width)
    plain_model = SasRec(schema, use_flash=False, **width)
    params = model.state_dict()
    buckets = dict(length_buckets=LENGTH_BUCKETS, batch_buckets=BATCH_BUCKETS, device=device)
    engine = ScoringEngine(model, params, **buckets)
    plain = ScoringEngine(plain_model, params, **buckets)
    rng = np.random.default_rng(SEED)
    slate = np.sort(rng.choice(NUM_ITEMS, 100, replace=False)).astype(np.int32)
    slate_engine = ScoringEngine(model, params, candidates=slate, **buckets)
    hidden_engine = ScoringEngine(model, params, outputs="hidden", **buckets)
    flash_engines = (engine, slate_engine, hidden_engine)

    requests = histories(rng, 48)
    by_length = {}
    for history in requests:
        window, mask, length = make_window(history, SEQ_LEN)
        lb = engine.route_length(length)
        by_length.setdefault(lb, []).append((window[SEQ_LEN - lb :], mask[SEQ_LEN - lb :]))

    # the main path: counts start at 0 here and are read at the end of the phase
    flash_attention.launches = 0
    max_err, top_checked = 0.0, 0
    fills = (1, 3, 8, 5, 64, 20)
    for lb, rows in sorted(by_length.items()):
        start = 0
        for fill in fills:
            batch = rows[start : start + fill]
            start += len(batch)
            if not batch:
                break
            ids = np.stack([r[0] for r in batch])
            mask = np.stack([r[1] for r in batch])
            logits, hidden = engine.encode(lb, ids, mask)
            want, _ = plain.encode(lb, ids, mask)
            if logits.shape != (len(batch), NUM_ITEMS) or hidden.shape != (len(batch), EMBEDDING_DIM):
                raise AssertionError(f"encode L={lb}: shapes {tuple(logits.shape)} {tuple(hidden.shape)}")
            if not (torch.isfinite(logits).all() and torch.isfinite(hidden).all()):
                raise AssertionError(f"encode L={lb}: non-finite output")
            max_err = max(max_err, (logits - want).abs().max().item())
            # (c) the pure-hit lane on the returned states reproduces the encode logits
            rescored = engine.score_hidden(hidden)
            hit_err = (rescored - logits).abs().max().item()
            if hit_err > 1e-5:
                raise AssertionError(f"score_hidden differs from encode logits by {hit_err}")
            got_np, want_np = logits.cpu().numpy(), want.cpu().numpy()
            for row in range(len(batch)):
                ids_got, _ = top_k_cut(
                    ScoreResponse(row, got_np[row], None, "cold", f"encode:L={lb}", 0.0,
                                  batch_bucket=engine.batch_bucket(len(batch))), 10
                )
                ids_want, s_want = top_k_cut(
                    ScoreResponse(row, want_np[row], None, "cold", f"encode:L={lb}", 0.0), 11
                )
                for rank in range(10):
                    # a rank is pinned where its score is clear of both neighbours
                    gap_prev = math.inf if rank == 0 else s_want[rank - 1] - s_want[rank]
                    gap_next = s_want[rank] - s_want[rank + 1]
                    if min(gap_prev, gap_next) > SERVE_TOL:
                        top_checked += 1
                        if ids_got[rank] != ids_want[rank]:
                            raise AssertionError(f"top-10 differs at rank {rank}: {ids_got} vs {ids_want[:10]}")
    if max_err > SERVE_TOL:
        raise AssertionError(f"kernel-route logits differ from the unfused route by {max_err}")

    # the slate and retrieval-mode engines on a few requests each
    lb, rows = max(by_length.items())
    ids = np.stack([r[0] for r in rows[:8]])
    mask = np.stack([r[1] for r in rows[:8]])
    full_logits, full_hidden = engine.encode(lb, ids, mask)
    slate_logits, _ = slate_engine.encode(lb, ids, mask)
    slate_err = (slate_logits - full_logits[:, torch.as_tensor(slate, device=device).long()]).abs().max().item()
    no_logits, retrieval_hidden = hidden_engine.encode(lb, ids, mask)
    hidden_err = (retrieval_hidden - full_hidden).abs().max().item()
    if no_logits is not None or slate_err > 1e-5 or hidden_err > 1e-5:
        raise AssertionError(f"slate err {slate_err}, retrieval hidden err {hidden_err}")

    # latency per (length, batch) bucket: host clock around encode, which
    # synchronises with the device before it returns
    latency = {}
    for lb in LENGTH_BUCKETS:
        for bucket in BATCH_BUCKETS:
            windows = [make_window(requests[i % len(requests)], lb) for i in range(bucket)]
            ids = np.stack([w[0] for w in windows])
            mask = np.stack([w[1] for w in windows])
            times = []
            for _ in range(110):
                t0 = time.perf_counter()
                engine.encode(lb, ids, mask)
                times.append((time.perf_counter() - t0) * 1e3)
            times = sorted(times[10:])
            record = {
                "p50_ms": times[len(times) // 2],
                "p99_ms": times[min(len(times) - 1, math.ceil(0.99 * len(times)) - 1)],
                **device_time_per_encode(engine, lb, ids, mask),
            }
            record["device_busy_share"] = record["device_ms"] / record["p50_ms"]
            latency[f"L={lb},B={bucket}"] = record

    launches = flash_attention.launches
    encode_calls = sum(e.stats()["encode_calls"] for e in flash_engines)
    # (a) every encode ran K4 once per block, and nothing else launched it
    if launches != model.num_blocks * encode_calls:
        raise AssertionError(f"K4 launches {launches} != {model.num_blocks} x {encode_calls} encode calls")
    emit(
        "serve", requests=len(requests), encode_calls=encode_calls, k4_launches=launches,
        max_abs_err_vs_unfused=max_err, tol=SERVE_TOL, top10_ranks_checked=top_checked,
        slate_err=slate_err, retrieval_hidden_err=hidden_err, stats=engine.stats(),
        latency_ms=latency,
    )
    return {"launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    from replay_tpu_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = nvidia_smi_line()
    emit(
        "env", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
    )

    start = time.perf_counter()
    report = build.build("flash_attention")
    emit("build", kernel="flash_attention", seconds=time.perf_counter() - start, ptxas=report.strip().splitlines())

    k4 = kernel_phase(device)
    served = serve_phase(device)

    kernels = [
        {
            "name": "flash_attention",
            "route": "cuda",
            "source": "replay_tpu_torch/csrc/flash_attention.cu",
            "replaces": "replay_tpu/ops/flash_attention.py:32",
            "launches": served["launches"],
            "max_abs_err": k4["max_abs_err"],
            "ms": k4["ms"],
            "plain_ms": k4["plain_ms"],
            "bound_ms": k4["bound_ms"],
            "bound_by": k4["bound_by"],
            "library_ms": k4["library_ms"],
            "passed": True,
            "shape": f"B={k4['B']} H={k4['H']} L={k4['L']} D={k4['D']} {k4['dtype']}",
        }
    ]
    emit("kernels", kernels=[{k: r[k] for k in ("name", "launches", "passed")} for r in kernels])
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    device_record = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device_record}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
