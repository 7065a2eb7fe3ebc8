#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port (``replay_tpu_torch``, never the JAX package) through its
serving path and its scoring service at the ``bench_serve.py`` width and
traffic, its retrieval (int8 table, IVF index, exact rescore) at
``bench_serve.py``'s quant and ann settings, its serialized inference form, its training path at the
``bench.py`` width, its long-sequence path (training and serving) at the
``bench_suite.py`` ``sasrec_l1024_tiled`` width, BERT4Rec and TwoTower
(training and serving) at ``bench_suite.py``'s ``bert4rec`` and ``twotower``
widths, notebook 09's training lifecycle (checkpoints, preemption and
resume, recovery, dropout in captured chunks), bench_fleet.py's serving fleet (three replicas on
one card behind the router, socket replicas in processes of their own, the observability plane),
bench_suite.py's stream rows (packed rows, the
parquet stream) and catalog-scaling rows (SCE, gBCE at 1M items, CEFused at 100k),
bench_continual.py's growing-catalog loop (vocabulary surgery, finetune, a grown
generation served), the rest of the SASRec family (remat and scan_blocks over K5 and
K4, the differential-attention encoder, TiSasRec, the list and numerical embedders), and
holds every kernel of those paths against its plain PyTorch version. Serving runs on CUDA graphs (one
captured graph per bucket, replayed by every encode) and is held bit for bit
to the eager bound program; training runs per step and, through
``Trainer.train_steps`` / ``fit(scan_chunk=K)``, as one graph of K steps held
bit for bit to the per-step path. Kernel launches are counted through graph
replays. Phases, one JSON line each:

1. ``env``     — the card's name and power limit (``nvidia-smi``), torch and CUDA versions;
2. ``build``   — compile the kernels from ``replay_tpu_torch/csrc/`` with nvcc for sm_90a,
                 one nvcc per source, all at once; each build's time and ``-Xptxas -v`` report;
3. ``kernel``  — K4 against ``flash_attention_reference`` at six shapes (among them
                 BERT4Rec's D=75 bidirectional and TwoTower's D=32 causal), f32 and bf16,
                 with the kernel's, the plain version's and ``scaled_dot_product_attention``'s
                 times and the card's bound for the same work; K1, K2, K3 against their
                 plain versions at the training width (f32, and bf16 hidden states), a
                 ragged case, the long-sequence width (E=128; bf16 and f32 hidden states)
                 and E=100, each on its ``tf32`` variant (tensor cores) where E is a
                 multiple of 8 up to 128 and on its ``simt`` variant at E=100; K4's
                 gradient at the training shape against autograd through the plain
                 version; K5 through its wrapper against
                 ``flash_attention_tiled_reference`` at the long-sequence shape
                 (causal, f32 and bf16, full windows; bf16 with the serving windows'
                 padding; non-causal; bf16 at D=128 and D=32), the ``attention_long``
                 shape, a ragged case with a fully padded row, f32 at D=256 and
                 BERT4Rec's tiled route (L=100, non-causal, bf16 and f32), each
                 bf16 row on K5's ``mma`` variant, each f32 row up to D=128 on its
                 ``tf32x3`` variant and D=256 on its ``simt`` variant, and its
                 gradient at the long-sequence shape;
4. ``serve``   — ``SasRec(use_flash=True)`` behind ``ScoringEngine`` answering requests,
                 checked against an engine on the same weights with ``use_flash=False``;
                 every bucket's replay bitwise equal to the eager bound program, across a
                 ``swap_params``, under per-call params and for held outputs; graph and
                 eager encode latency, device busy, K4 in the trace = K4 counted;
   ``service`` — the same model behind ``ScoringService`` in retrieval mode (MIPS top-100,
                 logistic re-rank, top-10) under ``bench_serve.py``'s traffic: 512 users
                 seeded cold, a closed loop of 8 threads × 64 requests, Poisson arrivals
                 at 500/s for 8 s, then one more profiled second; every response primary,
                 checked against a direct path on the unfused model; the bitwise contract
                 (fill, row position, advance = re-encode); a stale-cache control the
                 check must catch; qps, p50/p99, fill per lane, goodput, device busy share;
   ``retrieval`` — bench_serve.py's quant and ann phases on the port: an f32 and an int8
                 ``CandidatePipeline`` over the service model's table (64 query states on K4;
                 recall, top-10 after the exact rescore, rank() ms, bytes; the int8 search held
                 to the CPU's); brute force against IVF (f32) over a clustered 10,000,000-item
                 catalog (recall@100 gated at 0.99, the speedup beside the x10 target, each
                 build stage's seconds, brute force's product and top-k apart, peak memory);
                 the int8 and int8+pq rungs at 100,000 items (recall gated, two builds bitwise
                 equal, the card's searches held to the CPU's); the 100M-item projection;
                 ``ScoringService`` over the int8 pipeline and the f32 one (8 threads × 16
                 requests; every int8 response equal to ``pipeline.rank`` on the unfused model,
                 the ``rescore`` span traced);
   ``serialize`` — ``CompiledInference.serialize`` → ``deserialize`` in each output mode and
                 ``export_inference`` → ``import_inference``: bitwise equal to the live
                 instance, K4 in the loaded program's trace;
5. ``train``   — ``Trainer(CEFused(), SasRec(use_flash=True))`` against
                 ``Trainer(CE(), SasRec(use_flash=False))`` from the same weights: 20
                 steps with matching losses and kernel launch counts, validation and
                 top-k on held-out windows, then step times, device time and memory;
                 ``train_steps`` at K=32 and ``fit(scan_chunk=32)`` over 70 batches
                 (``device_feed`` on and off) bitwise against the per-step path, with
                 their step time, device busy, launches and memory;
   ``observe`` — the ``train`` trainer's ``fit(scan_chunk=32)`` over 99 batches with
                 every observability argument on (health at cadence 33, ``tracer=True``,
                 a profile window over a health step and a chunk, ``metrics_port=0``
                 scraped from a thread, a planted SLO rule, a flight ring), beside the
                 same fit plain, with health alone and with tracing alone: losses and
                 weights bitwise the plain fit's, the window's traced K4 and K1–K3 equal
                 to their counted launches and in the ``encoder`` / ``loss`` scopes (graph
                 replays through the traced warm-up), goodput sums, one SLO violation,
                 the scrapes, the ring; the step's MFU, the rooflines of ``train_step``,
                 ``train_scan`` and each serving bucket, per-scope device time, overheads;
6. ``longseq`` — ``Trainer(CEFused(), SasRec(use_flash="tiled"), precision="bf16")`` on
                 bench_suite.py's full windows: 20 steps with K5 launched twice a step;
                 the same from the same weights on ``use_flash=False``, and on the tiled
                 route with K5's forward swapped for its plain version, with matching
                 losses, and two faulty K5s as controls the limits must catch; the
                 tiled model's f32-compute hidden states under the same comparisons
                 and a third control, one TF32 product per f32 product (K5's
                 ``tf32x3`` variant; the bf16 paths run its ``mma`` variant only);
                 ``Trainer(CEFused(), ..., precision="f32")`` on the tiled route (K5
                 ``tf32x3``, K1–K3 ``tf32``) against ``Trainer(CE(), ...)`` on the unfused
                 route, 20 steps from the same weights; step times, device time and
                 memory of the four trainers.
                 ``train_steps`` / ``fit(scan_chunk=8)`` on the bf16 tiled trainer as in
                 ``train``; ``ScoringEngine`` on the tiled bf16 model, held to the same
                 comparisons and controls (the K5 swaps reach the eager program) and to
                 the graph checks of ``serve``, then encode latency per bucket;
7. ``bert4rec`` — ``Bert4Rec(use_flash=True)`` at bench_suite.py's width (27,278 items,
                 E=300, 4 heads, 2 blocks, L=100, batch 512) on masked-LM batches from
                 the port's transforms: ``Trainer(CE())`` in f32 (against the unfused
                 route from the same weights) and in bf16 compute, step times, device
                 time and memory, ``train_steps`` at K=16 and ``fit(scan_chunk=16)``
                 bitwise against the per-step path; ``CompiledInference`` in the
                 ``"logits"`` mode on graphs (the left shift inside the graph), buckets
                 1/8/64, bitwise against the eager program, against the unfused
                 route, serialized, and ``ScoringEngine`` under ``graph_contract``; the
                 tiled route (K5, non-causal) at a smaller depth;
   ``twotower`` — ``TwoTower(use_flash=True)`` at bench_suite.py's width (E=64, 2 heads,
                 2 blocks, L=50, batch 512) with ``CESampled`` over the in-batch pool:
                 the same trainer checks, one step with the pool's literal form (its
                 memory, or the OOM that is the finding), ``predict_top_k`` through the
                 catalog cache against ``forward_inference``'s top-k, the same serving
                 checks;
8. ``lifecycle`` — notebook 09's training run at ``examples/ml1m_parity.py``'s settings
                 (SASRec E=64, 2 heads, 2 blocks, dropout 0.3, L=50, batch 32, CE, 5
                 epochs, monitor recall@10) on a synthetic MovieLens-1M-shaped raw log
                 (6,040 users, 3,706 items, 1,000,209 events, sparse raw ids) through the
                 port's front end (``LastNSplitter`` twice, ``Dataset``,
                 ``SequenceTokenizer``; the tokenized splits decoded back to hand-built
                 ones), ``SequenceBatcher``, ``TransformedBatches`` and
                 ``validation_batches``, on K4 (D=32), evaluation on CUDA graphs (every
                 graph bitwise the eager program, graph and eager ``validate`` timed
                 side by side, ``top_k``'s time at two widths):
                 the dropout chunk contract (a K=32 graph bitwise K ``train_step``s,
                 replays drawing new masks, a fixed-mask control caught); one eager
                 epoch; the notebook run ``fit(scan_chunk=32, prefetch, device_feed,
                 checkpoints, monitor, JsonlLogger)``; the same run preempted by SIGTERM
                 mid-epoch 2 and resumed, bitwise the uninterrupted one; a recovery run
                 (NaN batches, rollback, LR backoff); one line each;
9. ``stream`` — bench_suite.py's ``stream_inmem``, ``stream_parquet`` and ``stream_packed`` rows
                 (the bench.py SASRec in bf16 on the unfused route, 24,576 sequences of 2–24
                 items, batch 512, K=8 graphs through ``TransformedBatches`` and ``prefetch``)
                 and the packed row with ``CEFused`` (K1–K3 on bf16 hidden states): sequences/s,
                 step ms, effective tokens/s, padding fraction, segments per row, host ms per
                 batch, busy share; the packed K=8 graphs bitwise the per-step path, no leakage
                 across packed segments (a plain causal mask as the control), ``CEFused``
                 against ``CE`` over 20 packed steps, and a SIGTERM in the parquet
                 ``fit(scan_chunk=8)`` resumed bitwise through the stream cursor without
                 rereading a slab (the parquet parts where pyarrow imports; a line says so
                 where it does not);
10. ``scale`` — bench_suite.py's catalog-scaling rows (SASRec E=128, 2 blocks, 2 heads, L=50,
                 batch 512, bf16, K4): ``sasrec_100k_sce`` (SCE, 160 buckets of 256),
                 ``scale_1m_gbce`` (1,000,000 items, GBCE t=0.75 over 256 negatives, one
                 health step streamed over the table) and ``sasrec_100k_fused`` (CEFused,
                 K1–K3 at 100,000 items): eager step p50, step on K=8 graphs, device ms a
                 step from two agreeing traces, kernels and copies a step, peak memory;
                 the graphs bitwise the per-step path; SCE's losses repeat from the seed,
                 and its preempted fit resumes bitwise;
11. ``continual`` — bench_continual.py's loop at MovieLens-1M's scale (6,040 users, a
                 catalog growing from 3,000 by 353 items every 2 days; SASRec E=64, 2
                 heads, K4 at D=32): each day ``Trainer.finetune`` on the tail against a
                 fresh fit on the whole history, NDCG@10 / recall@10 on the next day; each
                 resize bitwise the CPU's, moments carried, programs captured anew, a K=32
                 graph bitwise 32 eager steps; the grown generation through
                 ``ScoringService.publish_candidate``'s shape-change path, its top-10 that of
                 ``predict_top_k``;
12. ``family`` — the rest of the SASRec family (``FAMILY_*``): remat on K5 at the long-sequence
                 width (bf16, ``CEFused``) with ``remat_policy`` None, ``"full"``, ``"dots"`` and
                 ``scan_blocks`` with ``"dots"``: K5 launches a step (2 → 4), one step and its
                 gradient bitwise the plain step's, eager p50, device ms, peak memory, a K=8 graph
                 bitwise its eager steps and a trace of its replays whose kernels equal the
                 launches counted; the dropout contract at 0.3 (a remat step bitwise the plain one,
                 a remat graph bitwise its eager steps); remat ``"dots"`` on K4 at the ``bench.py``
                 width (K=32 graph) and at BERT4Rec's (three steps, peak memory); the diff encoder
                 (2 heads, f32 and bf16, ``CE``): no K4 launch, a K=32 graph, ``ScoringEngine`` under
                 ``graph_contract``, logits held to the CPU port; TiSasRec (``time_span`` 256, float
                 timestamps from ``notebook_raw_log``): a K=8 graph, ``predict_logits`` held to the
                 CPU port, ``validate`` on the evaluation graphs; a SASRec over a genre list (sum,
                 mean, max) and a numerical feature, tables from ``xavier_normal_embed_init``: a K=8
                 graph, losses and logits held to the CPU port;
13. ``distributed`` — distributed training (``DIST_*``): ranks started by the port's
                 ``launch_workers`` (``chip_smoke.py --distributed-worker``), gloo on cuda:0 (its
                 collectives through host copies, counted). ``dp``: bench.py's SASRec on a 2×1×1
                 mesh, 3 SGD steps against the single process on the global batch, a control
                 without the gradient all-reduce that must fail the limits, replicated weights
                 bitwise across ranks, ``validate`` over 8 batches, Adam step ms; ``sp_tp``:
                 bench_suite.py's ``sasrec_l1024_sp`` on a 1×2×2 mesh (ring attention over seq,
                 ``CEFusedTP`` on K1–K3 per catalog shard), f32 parity against the single
                 process on the unfused route, a control whose ring never hops, the collective
                 log's guard (no table-shard gather, ring traffic on seq only), a checkpoint
                 saved at step 3 restored by fresh ranks bitwise, bf16 step ms and peak memory
                 (with its ``remat_policy="dots"`` twin); each rank's launches against its trace
                 of one step. ``python3 chip_smoke.py --nccl-probe`` shows NCCL refusing two
                 ranks on one card;
14. ``fleet`` — bench_fleet.py at its defaults (``FLEET_*``): three ``ScoringService`` replicas of
                 the ``service`` model in full mode, on K4's graphs, behind ``ServingFleet``'s
                 consistent-hash router, each with a ``QualityMonitor``, a live ``Tracer`` and an
                 events shard; a Zipf population of 1,000,000 users; the single-replica baseline, a
                 closed loop of 8 × 48 requests, Poisson arrivals at 300/s for 6 s, a profiled second
                 (busy share, K4 in the trace = K4 counted), the drain-and-swap rollout to new
                 weights (no error), a replica closed and started again mid-traffic, the router over
                 one bare replica; socket chaos with three ``python -m replay_tpu_torch.serve.remote``
                 processes on the card, one SIGKILLed (its device memory freed, its flight ring read)
                 and respawned on a fresh port; every primary response to a history-carrying request
                 held to the unfused model with its generation's weights; the merged trace, the
                 port's ``obs.report`` over the run directory and ``build_postmortem``; fleet qps,
                 p50/p99 beside the baseline, the arrival rate reached, locality, reroutes, hedges,
                 retries, failover gaps, startup times, the quality block, K4 launches;
15. ``kernels`` — every ported kernel with its launches on the paths driven.

Every trainer's device time per step comes from a profiler trace that agrees
with a second trace of the same steps (``device_time_per_step``). Then the
card's name and power limit on a line of their own, one JSON object listing
the kernels, and, as the last line, ``{"ok": true, "device": ...}``.
Any failed check raises: the script exits non-zero and never falls back to
the CPU. It needs one CUDA device and ``nvcc``.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time

# kineto reports the device records it drops (out of a profiler window's
# range) only when it logs at INFO: lost_records reports that count.
# Set before torch loads kineto.
os.environ.setdefault("KINETO_LOG_LEVEL", "1")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from replay_tpu_torch.obs.mfu import PEAK_BF16_TFLOPS, PEAK_F32_TFLOPS, PEAK_TF32_TFLOPS  # noqa: E402
from replay_tpu_torch.obs.profile import TRACE_MARGIN_S, TRACE_NAMES, device_events, profiled_window  # noqa: E402, F401
from replay_tpu_torch.obs.roofline import PEAK_HBM_GBPS  # noqa: E402

# bench_serve.py's model: MovieLens-1M catalog, E=64, 2 blocks, 1 head, L=50
NUM_ITEMS, EMBEDDING_DIM, NUM_BLOCKS, NUM_HEADS, SEQ_LEN = 3706, 64, 2, 1, 50
LENGTH_BUCKETS, BATCH_BUCKETS = (16, 50), (1, 8, 64)
SEED = 0

# H100 SXM data sheet, from the package's peak tables (obs/mfu.py,
# obs/roofline.py): HBM rate; dense peaks of the bf16 and TF32 tensor cores and
# of f32 FMA on the CUDA cores
H100 = "h100 80gb hbm3"
HBM_BYTES_PER_S = PEAK_HBM_GBPS[H100] * 1e9
BF16_FLOPS, TF32_FLOPS, F32_FMA_FLOPS = (table[H100] * 1e12 for table in (PEAK_BF16_TFLOPS, PEAK_TF32_TFLOPS, PEAK_F32_TFLOPS))

# kernel vs plain version, max abs error: f32 differs only in summation order
# (online softmax over 32-key tiles vs one pass); bf16 adds the output's own
# rounding, half an ulp, 1.6e-2 for outputs below 8
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# serving logits, kernel route vs unfused route on the same weights: two encoder
# blocks, each with f32 rounding differences of ~1e-6, amplified by the head
SERVE_TOL = 1e-4

# bench_serve.py's service run (its defaults, bench_serve.py:100-140; traffic
# :1056-1212): 512 users with histories of 1–99 items, every user seeded cold,
# a closed loop of 8 client threads × 64 requests, then Poisson arrivals at
# 500/s for 8 s; a request is a pure hit (70%), an advance by one new item
# (20%) or a full history resend (10%). Retrieval mode: MIPS top-100, the
# logistic re-rank, top-10; one length bucket (50), batch buckets (1, 8, 64),
# max wait 2 ms, a cache of 1,024 users, a breaker of 5 failures / 0.3 s.
SERVICE_USERS, SERVICE_CLIENTS, SERVICE_CLOSED_REQUESTS = 512, 8, 64
SERVICE_RATE, SERVICE_SECONDS, SERVICE_CANDIDATES, SERVICE_TOPK = 500, 8, 100, 10
SERVICE_MAX_WAIT_MS, SERVICE_CACHE, SERVICE_WAIT_S = 2.0, 1024, 120.0
# the bitwise contract: one request among co-riders at these fills and at the
# first and last row
SERVICE_FILLS = (3, 8, 64)

# bench_serve.py's retrieval phases at its defaults. quant (:344-425): 64
# query states of the service model, MIPS top-100, the re-rank, top-10, five
# timed rank() calls. ann (:429-620): a clustered 10,000,000-item catalog,
# E=64, seed 7, 1,024 modes, auto nlist (4,096), nprobe 16, 64 queries,
# k-means on 131,072 sampled rows, recall@100 gated at 0.99, brute force
# timed over 3 searches and IVF over 10, the x10 speedup target; the rung
# catalog (100,000 rows, seed 11, nlist 512, nprobe 48; int8+pq with M=16,
# 3x overfetch, exact rescore) gated at recall@100 0.99; the 100M-item
# projection against a 16 GiB budget. The int8 service: 8 client threads x 16
# requests, as the brute service's closed loop draws them.
QUANT_QUERIES, QUANT_REPS = 64, 5
ANN_ITEMS, ANN_DIM, ANN_SEED, ANN_NPROBE, ANN_QUERIES, ANN_BUILD_SAMPLE = 10_000_000, 64, 7, 16, 64, 131072
ANN_K, ANN_TOPK, ANN_BRUTE_REPS, ANN_IVF_REPS, ANN_SPEEDUP_TARGET = 100, 10, 3, 10, 10.0
RUNG_ROWS, RUNG_SEED, RUNG_NLIST, RUNG_NPROBE, RUNG_PQ_M, RUNG_OVERFETCH = 100_000, 11, 512, 48, 16, 3
RECALL_GATE = 0.99
PROJECTION_BUDGET_BYTES = 16 * 1024**3
RETRIEVAL_CLIENTS, RETRIEVAL_REQUESTS = 8, 16
# the card's search against the CPU's on one index state: scores within this
# (f32 products summed in another order, scores of magnitude up to ~10), ids
# equal at every rank whose score is clear of its neighbours by more than it
RETRIEVAL_TOL = 1e-4

# bench.py's training width: batch 512 windows of L=50, the same model
TRAIN_BATCH = 512
TRAIN_STEPS, WARMUP_STEPS, TIMED_STEPS, PROFILED_STEPS = 20, 5, 50, 10
# K steps a dispatch: bench.py's REPLAY_TPU_BENCH_SCAN_K default, and a fit
# over two chunks and a tail of 6
SCAN_K, SCAN_BATCHES = 32, 70
# K1–K3 vs their plain versions, max abs error over max |plain|: f32 products
# summed in another order, over E = 64 per logit and up to 25,600 rows per dW
# entry; K1's lse (about 9 at this width) against an absolute 1e-4. A bf16 dh
# adds its own rounding, half an ulp: 2**-9 relative.
FUSED_TOL = {"K1": 1e-4, "K2": 1e-4, "K3": 1e-4}
FUSED_TOL_BF16_DH = 4e-3
# K4's gradient vs autograd through the plain version: the same f32 recompute
# by other formulas (softmax vs exp/sum/clamp), through four contractions
FLASH_GRAD_TOL = 1e-4
# train losses, fused vs plain trainer, per step: rtol 1e-4, the JAX package's
# own CEFused-vs-CE tolerance; f32 throughout, summation orders differ
TRAIN_LOSS_RTOL = 1e-4
# the loss's gradient w.r.t. all weights at the same weights, relative L2
# error, two comparisons:
# - CEFused (K1–K3) vs CE on the unfused attention route: f32 sums in other
#   orders, incoherent from token to token;
# - the K4 route vs the unfused attention route, both with CE: the two routes'
#   rounding differs the same way at every token, while on random labels the
#   true gradient is a sum of N = 25,600 random-sign token terms, about sqrt(N)
#   smaller than their absolute sum; the relative error is then about
#   sqrt(N) · 1e-6 ≈ 1.6e-4
TRAIN_GRAD_RTOL = {"cefused_vs_ce": 1e-5, "k4_route_vs_unfused": 1e-3}
# (name, N rows, I items, num_valid, hidden dtype, E): the bench.py width
# (B·L = 25,600 rows, the MovieLens-1M catalog, E=64), the same with bf16
# hidden states against the f32 table, a ragged case with masked columns, the
# long-sequence widths (B·L = 32,768 rows, E=128) with the bf16 hidden states
# of the bf16 trainer and the f32 ones of the f32 trainer, and E=100, which K3
# runs on its simt variant (E not a multiple of 8)
FUSED_CASES = (
    ("train_f32", TRAIN_BATCH * SEQ_LEN, NUM_ITEMS, None, torch.float32, EMBEDDING_DIM),
    ("train_bf16_hidden", TRAIN_BATCH * SEQ_LEN, NUM_ITEMS, None, torch.bfloat16, EMBEDDING_DIM),
    ("ragged", 1000, 1000, 900, torch.float32, EMBEDDING_DIM),
    ("longseq_bf16_hidden", 32 * 1024, NUM_ITEMS, None, torch.bfloat16, 128),
    ("longseq_f32", 32 * 1024, NUM_ITEMS, None, torch.float32, 128),
    ("dim_100", TRAIN_BATCH * SEQ_LEN, NUM_ITEMS, None, torch.float32, 100),
    # notebook 09's batch (32 windows of L=50) over the same catalog, E=64:
    # the lifecycle phase's CEFused epoch
    ("notebook", 32 * SEQ_LEN, NUM_ITEMS, None, torch.float32, EMBEDDING_DIM),
    # bench_suite.py's sasrec_100k_fused: 25,600 rows, 100,000 items, E=128,
    # the bf16 trainer's hidden states (the scale phase's CEFused row)
    ("scale_100k", TRAIN_BATCH * SEQ_LEN, 100_000, None, torch.bfloat16, 128),
    # the distributed sp_tp row's second catalog shard: 32 windows of 512
    # positions (its seq block), 1,853 rows of 3,706 of which 1,852 are items,
    # E=128; bf16 hidden states (the timed run) and f32 (the parity run)
    ("sp_tp_shard", 32 * 512, 1853, 1852, torch.bfloat16, 128),
    ("sp_tp_shard_f32", 32 * 512, 1853, 1852, torch.float32, 128),
)

# bench_suite.py's sasrec_l1024_tiled: the same catalog, E=128, 2 blocks, 2
# heads, L=1024, batch 32, CEFused, bf16 compute; served with length buckets
# (256, 1024) and batch buckets (1, 8, 32)
LONG_DIM, LONG_BLOCKS, LONG_HEADS, LONG_LEN, LONG_BATCH = 128, 2, 2, 1024, 32
LONG_LENGTH_BUCKETS, LONG_BATCH_BUCKETS = (256, 1024), (1, 8, 32)
LONG_STEPS, LONG_WARMUP_STEPS, LONG_TIMED_STEPS, LONG_PROFILED_STEPS = 20, 5, 30, 10
# K steps a dispatch at the long-sequence width: two chunks and a tail of 3
LONG_SCAN_K, LONG_SCAN_BATCHES = 8, 19
# The long-sequence path is checked end to end against the unfused attention
# route (other formulas: bf16 scores and softmax) and against the same model
# with K5's forward swapped for its plain version (the same formulas; only
# summation order differs inside K5). Two faulty K5s run as controls, to show
# what each check can catch: the softmax scale off by 2**-7 (about what
# 1/sqrt(65) for 1/sqrt(64) gives), and scores rounded to bf16 before the
# softmax. Every limit lies between the sound comparisons' readings and those
# of the controls it catches, read by this script on an NVIDIA H100 80GB HBM3
# at 700 W:
# - training losses, bf16 compute, largest relative difference over the 20
#   steps: sound 8.8e-6 (unfused) and 9.9e-6 (plain); controls 9.3e-5 (scale)
#   and 1.2e-5 (bf16 scores, inside bf16 compute's own noise): catches the scale;
LONGSEQ_LOSS_RTOL = 3e-5
# - hidden states of the tiled model in f32 compute on the training batch,
#   largest absolute difference: sound 2.1e-6 and 2.0e-6; controls 2.2e-2 and
#   7.5e-3: catches both;
LONGSEQ_F32_TOL = 1e-4
# - serving logits, bf16 compute, mean absolute difference over every logit
#   of every encode, from K5's plain version: sound 9.1e-4; controls 4.3e-3 and
#   3.8e-3: catches both (the unfused route's own formulas read 3.8e-3 here,
#   so it is held to the next limit only);
LONGSEQ_SERVE_MEAN_TOL = 2e-3
# - their largest absolute difference from the unfused route: sound 0.029,
#   controls 0.031 and 0.027, so this one catches neither; also the gap that
#   pins a top-10 rank.
LONGSEQ_SERVE_MAX_TOL = 2**-4
SCALE_FAULT = 1 + 2**-7
# K5's lse against the plain version's, f32 both: max abs error over
# max(1, |lse|) (lse is about log L plus the row max)
TILED_LSE_TOL = 1e-5
# K5's gradient (torch ops) against autograd through the plain version, max
# abs error over max(1, largest magnitude): dbias sums over 1024 queries and 2 heads
TILED_GRAD_TOL = 1e-4
# (name, B, H, L, D, causal, dtype, padding): the long-sequence shape at
# bench_suite.py's full windows in bf16 (the path's type) and f32, the same
# with the serving windows' padding, bench_suite.py's attention_long shape, the
# non-causal case, the long-sequence width split into one head of D=128 and
# four of D=32 (bf16: K5's mma variant at its widest and narrowest D), a
# ragged length with one fully padded row (padding kinds: see padding_mask),
# and f32 at D=256, which K5 runs on its simt variant (D above 128)
TILED_SHAPES = (
    ("longseq", LONG_BATCH, LONG_HEADS, LONG_LEN, LONG_DIM // LONG_HEADS, True, torch.bfloat16, "none"),
    ("longseq", LONG_BATCH, LONG_HEADS, LONG_LEN, LONG_DIM // LONG_HEADS, True, torch.float32, "none"),
    ("longseq_served", LONG_BATCH, LONG_HEADS, LONG_LEN, LONG_DIM // LONG_HEADS, True, torch.bfloat16, "served"),
    ("attention_long", 4, 4, 4096, 64, True, torch.float32, "none"),
    ("longseq_noncausal", LONG_BATCH, LONG_HEADS, LONG_LEN, LONG_DIM // LONG_HEADS, False, torch.bfloat16, "none"),
    ("longseq_d128", LONG_BATCH, 1, LONG_LEN, LONG_DIM, True, torch.bfloat16, "none"),
    ("longseq_d32", LONG_BATCH, 4, LONG_LEN, LONG_DIM // 4, True, torch.bfloat16, "none"),
    ("ragged", 8, 2, 1000, 64, True, torch.float32, "dead"),
    ("simt_d256", 8, 2, 1000, 256, True, torch.float32, "none"),
    # BERT4Rec's tiled route (bf16 training: mma; f32 forward: tf32x3), non-causal
    ("bert4rec_tiled", 512, 2, 100, 64, False, torch.bfloat16, "none"),
    ("bert4rec_tiled", 512, 2, 100, 64, False, torch.float32, "none"),
)

# (name, B, H, L, D, bias heads, mask): the serving width (bench_serve.py), the
# SasRec.from_params width (E=192, 4 heads), a long row over 16 key tiles, and
# the serving width at the smallest batch bucket
KERNEL_SHAPES = (
    ("serve", 64, 1, 50, 64, 1, "eval"),
    ("from_params", 8, 4, 200, 48, 4, "per_head"),
    ("long", 2, 2, 1024, 64, 1, "train"),
    ("serve_b1", 1, 1, 50, 64, 1, "eval"),
    # bench_suite.py's bert4rec (E=300, 4 heads: D=75, no multiple of 4, so
    # Q, K and V stage through the kernel's scalar loads; L=100, one bias head
    # for four) with its bidirectional training mask, and its twotower (E=64,
    # 2 heads: D=32) with the causal one
    ("bert4rec", 512, 4, 100, 75, 1, "bidirectional_train"),
    ("twotower", 512, 2, 50, 32, 1, "train"),
    # notebook 09's SASRec (examples/ml1m_parity.py): batch 32, 2 heads of
    # E=64 (D=32), L=50, causal
    ("notebook", 32, 2, 50, 32, 1, "train"),
    # bench_suite.py's catalog-scaling rows: batch 512, 2 heads of E=128
    # (D=64), L=50, causal
    ("scale", 512, 2, 50, 64, 1, "train"),
    # the demo SASRec that remote.py's server processes run (64 items, E=8,
    # 1 head, L=12: D=8, one partial chunk of keys) at its batch buckets
    ("demo", 8, 1, 12, 8, 1, "eval"),
    ("demo_b1", 1, 1, 12, 8, 1, "eval"),
)

# bench_suite.py's bert4rec and twotower rows (:333-379, :828-829): the
# MovieLens-20M catalog of 27,278 items, batch 512, dropout 0, Adam at 1e-3;
# BERT4Rec: E=300, 4 heads, 2 blocks, L=100, masked-LM batches (mask_prob
# 0.2), CE; TwoTower: E=64, 2 heads, 2 blocks, L=50, in-batch negatives
# (a pool of 512), CESampled
MODEL_ITEMS, MODEL_BATCH = 27278, 512
B4R_DIM, B4R_HEADS, B4R_BLOCKS, B4R_LEN, B4R_MASK_PROB = 300, 4, 2, 100, 0.2
TT_DIM, TT_HEADS, TT_BLOCKS, TT_LEN = 64, 2, 2, 50
# bench_suite.py::measure's scan_k (:90); a fit over one chunk and a tail of 3
MODEL_SCAN_K, MODEL_SCAN_BATCHES = 16, 19
MODEL_STEPS, MODEL_WARMUP_STEPS, MODEL_TIMED_STEPS, MODEL_PROFILED_STEPS = 5, 3, 20, 5
# BERT4Rec on the tiled route (K5, non-causal) at a smaller depth: one block,
# E=128 and 2 heads (D=64, a multiple of 8, so bf16 runs K5's mma variant)
B4R_TILED_DIM, B4R_TILED_HEADS, B4R_TILED_BLOCKS = 128, 2, 1


# examples/ml1m_parity.py's notebook-09 run (:47-53, :120-148): SASRec with
# E=64, 2 blocks, 2 heads, dropout 0.3, L=50, CE, Adam 1e-3; train batches of
# 32 windows of 51 (shuffled, seed 0), 5 epochs, validation top-k (1, 5, 10,
# 20), monitor recall@10. Its data is MovieLens-1M: 6,040 users with at least
# 20 ratings each, 3,706 items, 1,000,209 ratings; here a synthetic log of
# that shape (Zipf-skewed item popularity and a sequential signal,
# ``notebook_log``), made from the seed. K steps a
# chunk (bench.py's REPLAY_TPU_BENCH_SCAN_K default), a mid-epoch checkpoint
# every 256 steps; the recovery run poisons 10 steps in a row from step 300
# and rolls back after 8
NB_USERS, NB_ITEMS, NB_EVENTS, NB_MIN_EVENTS = 6040, 3706, 1_000_209, 20
NB_DIM, NB_BLOCKS, NB_HEADS, NB_DROPOUT, NB_LEN, NB_BATCH, NB_EPOCHS = 64, 2, 2, 0.3, 50, 32, 5
NB_TOP_K = (1, 5, 10, 20)
NB_SCAN_K, NB_CHECKPOINT_EVERY, NB_PROFILED_STEPS = 32, 256, 10
NB_BAD_FROM, NB_BAD_STEPS, NB_MAX_BAD = 300, 10, 8
# the synthetic log's sequential signal: the share of events that follow
# their predecessor's successor item
NB_FOLLOW = 0.5

# bench_suite.py's stream rows (run_stream, :641-795; rows :834-836): the
# bench.py SASRec (the catalog above, E=64, 2 blocks, 1 head, L=50, dropout 0,
# Adam 1e-3, CE) in bf16 compute (bench_suite.py's dtype on an accelerator,
# :816) on the unfused route; 512 x 48 = 24,576 synthetic sequences of 2–24
# items (np.random.default_rng(0)); batches of 512 at batcher length 51,
# shuffled with seed 0; K=8 train_steps graphs fed through
# TransformedBatches and prefetch(depth=2), full chunks only; the parquet
# row written in row groups of 512 rows, read with shard="row_groups",
# read_ahead=2 and an 8 MiB memory budget. Each row is timed over whole
# epochs until at least STREAM_MIN_STEPS steps (a packed epoch holds one
# full chunk).
STREAM_SEQUENCES, STREAM_SCAN_K, STREAM_MIN_STEPS = TRAIN_BATCH * 48, 8, 48
# CEFused against CE on packed batches from the same weights, 20 eager steps:
# the first step's losses come from the same bf16 hidden states, so they
# differ by the two f32 reductions' order only (K1 against the plain
# logsumexp): rtol 1e-5; every step's within 1e-3: the two gradients differ
# by f32 rounding, which flips bf16 roundings of the activations in the
# steps after (a 5.7e-5 reading after 8 steps at a small width on the CPU,
# test_torch_kernels_cuda.py's packed case run on the plain versions)
STREAM_LOSS_STEPS, STREAM_FUSED_FIRST_RTOL, STREAM_FUSED_RTOL = 20, 1e-5, 1e-3
# hidden states of packed segments against their neighbours' rewrite and
# their solo row, bf16 compute: equal bit for bit where every product keeps
# its own rows (expected), else within a few bf16 ulps of O(1) values; a
# plain causal mask (the control) moves later segments by far more
STREAM_LEAK_TOL = 1e-2
# the parquet fit's SIGTERM: while batch 20 of epoch 0 is fetched, in its
# third chunk
STREAM_PREEMPT_AT = 20

# bench_suite.py's catalog-scaling rows (run_sasrec / run_sasrec_sce,
# :245-330; rows :827, :857-862): SASRec E=128, 2 blocks, 2 heads, L=50,
# batch 512, dropout 0, Adam 1e-3, bf16 compute (:816 on an accelerator),
# batches as sasrec_batch (:211-226) builds them. sasrec_100k_sce: 100,000
# items, SCE with 160 buckets (:313's formula at 25,600 tokens) of 256
# positions and 256 items; scale_1m_gbce: 1,000,000 items, GBCE t=0.75 over a
# shared pool of 256 negatives; sasrec_100k_fused: the exact head SCE
# approximates, CEFused (K1-K3) at 100,000 items. use_flash=True (K4) where
# bench_suite.py runs unfused. K=8 graphs over 11 batches (a chunk and a
# tail of 3); the eager steps timed over 10 after 2, traced over 3.
SCALE_DIM, SCALE_BLOCKS, SCALE_HEADS, SCALE_BATCH = 128, 2, 2, 512
SCALE_ROWS = (
    ("sasrec_100k_sce", 100_000, "sce", 0),
    ("scale_1m_gbce", 1_000_000, "gbce", 256),
    ("sasrec_100k_fused", 100_000, "fused", 0),
)
SCALE_SCE = dict(n_buckets=160, bucket_size_x=256, bucket_size_y=256)
SCALE_STEPS, SCALE_SCAN_K, SCALE_BATCHES = 5, 8, 11
SCALE_TIMED_STEPS, SCALE_WARMUP_STEPS, SCALE_PROFILED_STEPS = 10, 2, 3
# the SCE fit's SIGTERM: while batch 13 of its 2 epochs of 11 is fetched
SCALE_PREEMPT_AT = 13

# bench_continual.py's loop (simulate_stream :111-140, the loop :220-300) at
# MovieLens-1M's scale: 6,040 users, 6 events a user a day over 5 days, a
# catalog growing by 353 items every 2 days from 3,000 (3,706 at day 4);
# SASRec E=64, 2 blocks, 2 heads (K4 at D=32), L=50, CE, batch 32, dropout 0,
# Adam 1e-2 (:241-255), 2 epochs over the day's tail (continual, through
# Trainer.finetune with xavier cold rows) and over the whole history (a
# fresh model each day), K=32 graphs, NDCG@10 / recall@10 on the next day.
CONT_DAYS, CONT_USERS, CONT_EVENTS_PER_DAY, CONT_ITEMS, CONT_GROW_ITEMS, CONT_GROW_EVERY = 5, 6040, 6, 3000, 353, 2
CONT_DIM, CONT_BLOCKS, CONT_HEADS, CONT_LEN, CONT_BATCH, CONT_LR = 64, 2, 2, 50, 32, 1e-2
CONT_TAIL_EPOCHS, CONT_RETRAIN_EPOCHS, CONT_TOPK, CONT_SCAN_K = 2, 2, 10, 32
# users whose top-10 from the served grown generation is held to
# predict_top_k's: ids equal at every rank clear of its neighbours by more
# than SERVE_TOL (two programs' f32 sums in other orders)
CONT_SERVE_USERS = 32

# The rest of the SASRec family (the family phase). Remat on K5 at the
# long-sequence width (LONG_*: bench_suite.py's sasrec_l1024_tiled, bf16,
# CEFused) with remat_policy None, "full", "dots" and scan_blocks + "dots";
# remat "dots" on K4 at the bench.py width (f32, CEFused, K=32 graphs) and at
# BERT4Rec's (MODEL_*/B4R_*: f32, CE, three eager steps); the diff encoder at
# the bench.py width with 2 heads (E must divide by 2H), f32 and bf16, CE; TiSasRec
# at the bench.py width, time_span 256, timestamps from notebook_raw_log; a SASRec
# over item ids, a genre list (18 genres, up to 6 an item) in each pooling and a
# numerical feature, tables drawn by xavier_normal_embed_init. Random weights
# from SEED; dropout 0 but in the dropout contract (FAMILY_DROPOUT).
FAMILY_REMAT = (("none", None, False), ("full", "full", False), ("dots", "dots", False), ("scan_dots", "dots", True))
FAMILY_K5_SCAN_K, FAMILY_K4_SCAN_K, FAMILY_SCAN_K = 8, 32, 8
FAMILY_STEPS, FAMILY_WARMUP_STEPS, FAMILY_PROFILED_STEPS, FAMILY_B4R_STEPS = 10, 3, 5, 3
FAMILY_DROPOUT, FAMILY_DIFF_HEADS, TI_SPAN = 0.3, 2, 256
GENRES, GENRE_SLOTS, FAMILY_POOLINGS = 18, 6, ("sum", "mean", "max")
# the card's logits against the CPU port's on the same weights, largest
# absolute difference: f32 sums in other orders (SERVE_TOL, the serve phase's
# limit); bf16 compute, LONGSEQ_SERVE_MAX_TOL's bound for bf16 logits
FAMILY_CPU_TOL = {torch.float32: SERVE_TOL, torch.bfloat16: LONGSEQ_SERVE_MAX_TOL}
# losses of the card's eager steps against the CPU port's from the same weights
FAMILY_CPU_STEPS = 2
# the family phase's embedding tables whose gradient is read both ways (torch's
# CUDA kernel, nn/layers.py::table_gradient): (name, rows, width, lookups' shape)
FAMILY_EMBED_CASES = (
    ("genres", GENRES + 1, EMBEDDING_DIM, (TRAIN_BATCH, SEQ_LEN, GENRE_SLOTS)),
    ("interval_bias", TI_SPAN + 1, NUM_HEADS, (TRAIN_BATCH, SEQ_LEN, SEQ_LEN)),
    ("item_table", NUM_ITEMS + 1, EMBEDDING_DIM, (TRAIN_BATCH, SEQ_LEN)),
)


# bench_fleet.py's defaults (:91-110, :135-144): FLEET_REPLICAS replicas of
# the bench_serve.py SASRec in full mode (every item scored), batch buckets
# (1, 8, 64), max wait 2 ms, a cache of 4,096 users each, cold misses on the
# fallback floor, heartbeats every 0.1 s, hedges at the fleet's own p99; a
# Zipf (a=1.3) population of 1,000,000 users whose histories (1–99 items)
# are drawn from the user's id on first touch; a closed loop of 8 clients x
# 48 requests, then Poisson arrivals at 300/s for 6 s (3 s for the
# single-replica baseline); the drain-and-swap rollout to the weights x1.001;
# a replica closed for the middle third of 6 s of traffic; socket chaos with
# 3 server processes of the demo SASRec (64 items, L=12, D=8, 1 block) at
# 100/s, one SIGKILLed and respawned. Waits: a request, FLEET_WAIT_S; a
# server's start (torch, the CUDA context, the graph captures), FLEET_STARTUP_S.
FLEET_REPLICAS, FLEET_USERS, FLEET_CLIENTS, FLEET_CLOSED_REQUESTS = 3, 1_000_000, 8, 48
FLEET_RATE, FLEET_SECONDS, FLEET_CHAOS_SECONDS, FLEET_ZIPF_A = 300, 6, 6, 1.3
FLEET_CACHE, FLEET_MAX_WAIT_MS, FLEET_HEARTBEAT_S, FLEET_SWAP_SCALE = 4096, 2.0, 0.1, 1.001
FLEET_SOCKET_REPLICAS, FLEET_SOCKET_RATE, FLEET_SOCKET_ITEMS, FLEET_SOCKET_LEN = 3, 100, 64, 12
FLEET_SOCKET_DIM, FLEET_SOCKET_BLOCKS = 8, 1
FLEET_SOCKET_ARGS = (
    "--num-items", str(FLEET_SOCKET_ITEMS), "--seq-len", str(FLEET_SOCKET_LEN),
    "--embedding-dim", str(FLEET_SOCKET_DIM), "--num-blocks", str(FLEET_SOCKET_BLOCKS),
)
FLEET_WAIT_S, FLEET_STARTUP_S = 120.0, 120.0
# users of the cache probe (fleet_cache_probe), a burst each step
FLEET_PROBE_USERS = 48

def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def warmup_stream() -> torch.cuda.Stream:
    """The one side stream every warm-up runs on: cuBLAS keeps a workspace for
    each stream it has run on, so a new stream per timing would leave tens of
    MB allocated each time and inflate the memory the phases after it read."""
    return torch.cuda.Stream()


def graph_ms(fn, launches: int = 20, reps: int = 7) -> float:
    """Median device time of one ``fn()`` call: ``launches`` calls captured in a
    CUDA graph, replayed ``reps`` times between CUDA events (so host overhead
    is not in the number). Inputs stay in L2 between calls, as the encoder's
    projections leave them."""
    side = warmup_stream()
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
    """q, k, v from a seeded normal; bias as the serving (or, for the
    ``*train`` masks, the training) path builds it; ``bidirectional_*``: the
    padding-only mask of BERT4Rec."""
    from replay_tpu_torch.nn.mask import bidirectional_attention_mask, causal_attention_mask

    rng = np.random.default_rng(seed)
    q, k, v = (
        torch.tensor(rng.standard_normal((batch, heads, length, dim), dtype=np.float32))
        .to(device=device, dtype=dtype)
        for _ in range(3)
    )
    lengths = rng.integers(1, length + 1, batch)
    if batch > 1:
        lengths[-1] = 0  # one all-padding row
    padding = torch.tensor(np.arange(length)[None, :] >= length - lengths[:, None], device=device)
    make_mask = bidirectional_attention_mask if mask.startswith("bidirectional") else causal_attention_mask
    bias = make_mask(padding, deterministic=not mask.endswith("train"))
    if mask == "per_head":
        noise = rng.standard_normal((batch, bias_heads, length, length), dtype=np.float32)
        bias = bias + torch.tensor(noise, device=device)
    return q, k, v, bias


def product_rate(a: torch.dtype, b: torch.dtype, f32_parts: int = 3) -> float:
    """The fastest rate, FLOP/s, at which the card multiplies operands of types
    ``a`` and ``b`` to the accuracy the kernel keeps, never below f32 FMA on the
    CUDA cores:
    - bf16 × bf16: one product on the bf16 tensor cores;
    - bf16 × f32: one bf16 product per bf16 part of the f32 operand against the
      bf16 one, which is exact: three parts carry all of f32's 24 bits,
      ``f32_parts`` = 2 where the kernel keeps that operand as a bf16 hi + lo
      pair (K5's ``mma`` keeps P so); faster than split TF32's two products;
    - f32 × f32: split TF32, three products on the TF32 tensor cores (as fast
      as the six that bf16 parts would take)."""
    f32_operands = (a == torch.float32) + (b == torch.float32)
    rate = {0: BF16_FLOPS, 1: max(BF16_FLOPS / f32_parts, TF32_FLOPS / 2), 2: TF32_FLOPS / 3}[f32_operands]
    return max(rate, F32_FMA_FLOPS)


def least_ms(moved: int, products):
    """The larger of ``moved`` bytes over HBM rate and the ``products`` — (name,
    FLOP, rate in FLOP/s) — each at its rate. Returns (ms, "bytes" |
    "operations", FLOP, the rate of each product in TFLOP/s)."""
    byte_ms = moved / HBM_BYTES_PER_S * 1e3
    flop_ms = sum(flop / rate for _, flop, rate in products) * 1e3
    rates = {name: rate / 1e12 for name, _, rate in products}
    return max(byte_ms, flop_ms), ("bytes" if byte_ms >= flop_ms else "operations"), sum(p[1] for p in products), rates


def bound(q: torch.Tensor, bias: torch.Tensor):
    """Least time the card could take for one attention call: each input read
    once, the output written once, over HBM rate; 2·B·H·L²·D FLOP for QKᵀ in
    the inputs' type and as many for P·V, P in f32 (the kernel's), each at its
    ``product_rate``. Returns (ms, "bytes" | "operations", bytes, FLOP, rates)."""
    batch, heads, length, dim = q.shape
    moved = 4 * q.numel() * q.element_size() + bias.numel() * 4  # q, k, v, out; f32 bias
    half = 2 * batch * heads * length * length * dim
    products = (("QK", half, product_rate(q.dtype, q.dtype)), ("PV", half, product_rate(torch.float32, q.dtype)))
    ms, by, flop, rates = least_ms(moved, products)
    return ms, by, moved, flop, rates


def kernel_phase(device) -> dict:
    """K4 vs its plain version at every shape; returns the records by (shape, dtype)."""
    import torch.nn.functional as F

    from replay_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference

    records = {}
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
            bound_ms, bound_by, moved, flop, rates = bound(q, bias)
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
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved, "flop": flop, "rates_tflops": rates,
            }
            emit("kernel", **record)
            if err > KERNEL_TOL[dtype]:
                raise AssertionError(f"K4 {name} {dtype}: max abs err {err} > {KERNEL_TOL[dtype]}")
            records[(name, dtype)] = record
    return records


def history_lengths(rng, count: int, length: int) -> np.ndarray:
    """History lengths as bench_serve.py:1057 draws its users' (1 .. 2L-1 for
    a window of L), cut to the window."""
    return np.minimum(rng.integers(1, 2 * length, count), length)


def padding_mask(rng, batch: int, length: int, padding: str) -> np.ndarray:
    """[B, L] bool, True at real tokens, left-padded: "none" — every row full
    (bench_suite.py's windows); "served" — history lengths as served
    (``history_lengths``); "dead" — "served" with the last row all padding."""
    lengths = np.full(batch, length) if padding == "none" else history_lengths(rng, batch, length)
    if padding == "dead":
        lengths[-1] = 0
    return np.arange(length)[None, :] >= length - lengths[:, None]


def tiled_bound(q: torch.Tensor, padding: torch.Tensor, causal: bool, variant: str):
    """Least time the card could take for one K5 call on these inputs, the
    larger of two: the bytes it must move over HBM rate — k and v of the real
    keys, q of the rows that see a real key, all of out and lse written once,
    the f32 bias row read once — and 2·H·D FLOP per (query, real key) pair
    (causal: key ≤ row) for QKᵀ in the inputs' type and as many for P·V, P in
    f32, each at its ``product_rate`` (P in two bf16 parts on ``variant``
    "mma", which keeps it so). Returns (ms, bound_by, bytes, FLOP, rates)."""
    batch, heads, length, dim = q.shape
    valid = padding.to(torch.float64)
    if causal:  # key k is seen by rows k .. L-1; row r sees a real key once one lies at or before it
        pairs = (valid * (length - torch.arange(length, device=padding.device))).sum().item()
        seeing = (valid.cumsum(dim=1) > 0).sum().item()
    else:
        pairs = valid.sum().item() * length
        seeing = (valid.sum(dim=1, keepdim=True) > 0).expand(-1, length).sum().item()
    row_bytes = heads * dim * q.element_size()
    moved = (2 * valid.sum().item() + seeing) * row_bytes + q.numel() * q.element_size()  # k, v; q; out
    moved += batch * length * 4 + batch * heads * length * 4  # bias; lse
    half = 2 * heads * dim * pairs
    p_parts = 2 if variant == "mma" else 3
    products = (
        ("QK", half, product_rate(q.dtype, q.dtype)),
        ("PV", half, product_rate(torch.float32, q.dtype, f32_parts=p_parts)),
    )
    ms, by, flop, rates = least_ms(moved, products)
    return ms, by, int(moved), flop, rates


def reset_counts(*wrappers) -> None:
    """Each wrapper's launch count set to 0, and its launches by variant where
    it counts them (in place: the wrapper adds to that dict)."""
    for fn in wrappers:
        fn.launches = 0
        for variant in getattr(fn, "launches_by_variant", ()):
            fn.launches_by_variant[variant] = 0


def variant_counts(fn) -> dict:
    """The wrapper's launches by variant."""
    return dict(fn.launches_by_variant)


def fused_variant_counts(fc) -> dict:
    """K1's, K2's and K3's launches by variant, by wrapper."""
    return {fn.__name__: variant_counts(fn) for fn in (fc.fused_lse_forward, fc.fused_lse_dh, fc.fused_lse_dw)}


def check_fused_variants(path: str, counts: dict, steps: int) -> None:
    """Each of K1, K2 and K3 ran its tf32 variant once a step, and nothing else."""
    if any(by_variant != {"tf32": steps, "simt": 0} for by_variant in counts.values()):
        raise AssertionError(f"{path} ran K1-K3's variants {counts}, not tf32 only")


def tiled_kernel_phase(device) -> dict:
    """K5 vs its plain version at every shape, each on the variant its dtype and
    D call for; returns the records by (shape, dtype)."""
    import torch.nn.functional as F

    from replay_tpu_torch.ops.flash_tiled import (
        NEG_INF,
        flash_attention_tiled,
        flash_attention_tiled_reference,
        padding_mask_bias,
    )
    from replay_tpu_torch.ops import flash_tiled

    records = {}
    for index, (name, batch, heads, length, dim, causal, dtype, padding) in enumerate(TILED_SHAPES):
        rng = np.random.default_rng(200 + index)
        q, k, v = (
            torch.tensor(rng.standard_normal((batch, heads, length, dim), dtype=np.float32)).to(device, dtype)
            for _ in range(3)
        )
        mask = torch.tensor(padding_mask(rng, batch, length, padding), device=device)
        bias = padding_mask_bias(mask)
        variant = flash_tiled._variant(dtype, dim)
        reset_counts(flash_attention_tiled)
        got = flash_attention_tiled(q, k, v, bias, causal)  # the wrapper the model calls
        _, lse = flash_tiled._launch(q, k, v, bias, causal)  # the wrapper returns no lse
        ran = variant_counts(flash_attention_tiled)
        # the plain version on the same input values, its f32 result not
        # rounded: for bf16 the error is then the output's own rounding
        want, want_lse = flash_attention_tiled_reference(q.float(), k.float(), v.float(), bias, causal)
        torch.cuda.synchronize()
        label = f"K5 {name} {dtype} causal={causal}"
        expected_variant = "simt" if dim % 8 or dim > 128 else ("mma" if dtype == torch.bfloat16 else "tf32x3")
        if variant != expected_variant or ran != {key: 2 if key == variant else 0 for key in ran}:
            raise AssertionError(f"{label}: variant {variant} (expected {expected_variant}), launches {ran}")
        if got.dtype != dtype or got.shape != q.shape or lse.shape != q.shape[:3]:
            raise AssertionError(f"{label}: got {got.dtype} {tuple(got.shape)} lse {tuple(lse.shape)}")
        if not (torch.isfinite(got.float()).all() and torch.isfinite(lse).all()):
            raise AssertionError(f"{label}: non-finite output")
        diff = (got.float() - want).abs()
        err, mean_err = diff.max().item(), diff.mean().item()
        # the plain version's own output rounded to the inputs' type, for comparison, and
        # the share of outputs whose rounding differs from it
        rounded = want.to(dtype)
        rounding_mean_err = (rounded.float() - want).abs().mean().item()
        flip_share = (got != rounded).float().mean().item() if dtype != torch.float32 else None
        lse_err = ((lse - want_lse).abs() / want_lse.abs().clamp_min(1.0)).max().item()
        dead_exact = None
        if padding == "dead":  # the fully padded row: exactly 0, lse at the mask
            dead_exact = bool(torch.equal(got[-1].float(), torch.zeros_like(got[-1].float()))) and bool(
                torch.equal(lse[-1], torch.full_like(lse[-1], NEG_INF))
            )
        if causal:
            library = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)  # noqa: E731
        else:
            key_mask = mask[:, None, None, :]
            library = lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=key_mask)  # noqa: E731
        big = length >= 4096
        bound_ms, bound_by, moved, flop, rates = tiled_bound(q, mask, causal, variant)
        record = {
            "kernel": "K5", "variant": variant, "shape": name, "B": batch, "H": heads, "L": length, "D": dim,
            "causal": causal, "padding": padding, "real_tokens": int(mask.sum().item()),
            "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err, "tol": KERNEL_TOL[dtype],
            "mean_abs_err": mean_err, "plain_rounded_mean_abs_err": rounding_mean_err,
            "rounded_unlike_plain_share": flip_share,
            "lse_rel_err": lse_err, "lse_tol": TILED_LSE_TOL,
            "dead_row_exact": dead_exact,
            "ms": graph_ms(lambda: flash_attention_tiled(q, k, v, bias, causal), launches=10),
            "eager_ms": eager_ms(lambda: flash_attention_tiled(q, k, v, bias, causal), launches=10),
            "plain_ms": graph_ms(
                lambda: flash_attention_tiled_reference(q, k, v, bias, causal), launches=3 if big else 5, reps=5
            ),
            "library_ms": graph_ms(library, launches=10),
            "library_call": "scaled_dot_product_attention(is_causal=True)" if causal
            else "scaled_dot_product_attention(attn_mask=key padding)",
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved, "flop": flop, "rates_tflops": rates,
        }
        emit("kernel", **record)
        if err > KERNEL_TOL[dtype] or lse_err > TILED_LSE_TOL or dead_exact is False:
            raise AssertionError(f"{label}: max abs err {err}, lse {lse_err}, dead row exact {dead_exact}")
        records[(name, dtype)] = record
    return records


def tiled_backward_check(device) -> dict:
    """K5's gradient (the Function's backward, torch ops mirroring the JAX _bwd)
    at the long-sequence shape, f32, the serving windows' padding (so that
    dbias is not trivially 0), against autograd through
    the plain version; dq, dk, dv and dbias."""
    from replay_tpu_torch.ops.flash_tiled import (
        flash_attention_tiled,
        flash_attention_tiled_backward,
        flash_attention_tiled_reference,
        padding_mask_bias,
    )

    rng = np.random.default_rng(300)
    shape = (LONG_BATCH, LONG_HEADS, LONG_LEN, LONG_DIM // LONG_HEADS)
    q, k, v, g = (torch.tensor(rng.standard_normal(shape, dtype=np.float32), device=device) for _ in range(4))
    bias = padding_mask_bias(torch.tensor(padding_mask(rng, LONG_BATCH, LONG_LEN, "served"), device=device))
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    torch.sum(flash_attention_tiled(*leaves) * g).backward()
    plain = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    torch.sum(flash_attention_tiled_reference(*plain)[0] * g).backward()
    torch.cuda.synchronize()
    errors = {
        name: ((a.grad - b.grad).abs().max() / b.grad.abs().max().clamp_min(1.0)).item()
        for name, a, b in zip(("q", "k", "v", "kv_bias"), leaves, plain)
    }
    finite = all(torch.isfinite(t.grad).all() for t in leaves)
    out, lse = flash_attention_tiled_reference(q, k, v, bias)
    record = {
        "kernel": "K5_backward", "B": shape[0], "H": shape[1], "L": shape[2], "D": shape[3], "causal": True,
        "rel_err": errors, "tol": TILED_GRAD_TOL,
        "backward_ms": graph_ms(
            lambda: flash_attention_tiled_backward(q, k, v, bias, out, lse, g), launches=3, reps=5
        ),
    }
    emit("kernel", **record)
    if not finite or max(errors.values()) > TILED_GRAD_TOL:
        raise AssertionError(f"K5 gradient: finite={finite}, errors {errors} > {TILED_GRAD_TOL}")
    return record


def device_time_per_encode(engine, length_bucket, ids, mask, wrapper, blocks: int, calls: int = 20) -> dict:
    """Device time of one encode from a profiler trace: kernel time summed over
    ``calls`` encodes (graph replays), per call, and the kernels that take most
    of it; the attention kernel's launches counted through the replays must
    equal its kernels in the trace, which is retaken (``TRACES_AT_MOST``) when
    it lost kernel events. The profiler's own cost inflates the wall time, so
    the busy share divides by the unprofiled p50 instead."""
    from torch.autograd import DeviceType

    readings = []
    for _ in range(TRACES_AT_MOST):
        with profiled_window(lambda: engine.encode(length_bucket, ids, mask)) as prof:
            before = wrapper.launches
            for _ in range(calls):
                engine.encode(length_bucket, ids, mask)
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        launched, traced = wrapper.launches - before, traced_kernels(kernels, [wrapper])[wrapper.__name__]
        readings.append((launched, traced))
        if launched == traced == calls * blocks:
            break
    else:
        raise AssertionError(f"{calls} encodes: {wrapper.__name__} (counted, traced) launches in each trace: {readings}")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    return {
        "device_ms": sum(e.self_device_time_total for e in kernels) / calls / 1e3,
        "device_kernels": sum(e.count for e in kernels) / calls,
        "traced_attention_kernels": traced, "traces": len(readings),
        "top_kernels_ms": {e.key[:60]: e.self_device_time_total / calls / 1e3 for e in kernels[:4]},
    }


def traced_kernels(events, wrappers) -> dict:
    """Each wrapper's kernels in a profiler trace's device events."""
    return {
        fn.__name__: sum(e.count for e in events if re.search(TRACE_NAMES[fn.__name__], e.key)) for fn in wrappers
    }


def eager_encode(engine, length_bucket, ids, mask, params=None):
    """``engine.encode`` through the eager bound program (``nn/compiled.py::bind``),
    no graph: the reference a replay is held to, and the program that the K5
    swaps of the long-sequence comparisons reach. Pads as the engine does."""
    from replay_tpu_torch.nn.compiled import as_device_tensor, pad_rows

    compiled = engine._encoders[length_bucket]
    rows, bucket = len(ids), engine.batch_bucket(len(ids))
    device = engine.device
    out = compiled._compiled[bucket](
        engine.params if params is None else params,
        pad_rows(as_device_tensor(ids, torch.int32, device), bucket),
        pad_rows(as_device_tensor(mask, torch.bool, device), bucket),
        engine._candidates_on_device,
    )
    if engine.outputs == "both":
        return out[0][:rows], out[1][:rows]
    return None, out[:rows]


def eager_score_hidden(engine, hidden, params=None):
    """``engine.score_hidden`` through the eager bound program, no graph."""
    from replay_tpu_torch.nn.compiled import pad_rows

    rows = hidden.shape[0]
    padded = pad_rows(hidden, engine.batch_bucket(rows))
    return engine._hidden_scorer(engine.params if params is None else params, padded, engine._candidates_on_device)[:rows]


def bitwise_equal(got, want) -> bool:
    """Outputs (tensors, or tuples of tensors and ``None``) equal bit for bit."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return len(got) == len(want) and all(
        (a is None and b is None) or (a is not None and b is not None and a.dtype == b.dtype and torch.equal(a, b))
        for a, b in zip(got, want)
    )


def graph_contract(engine, other_params, requests, seq_len) -> dict:
    """Every bucket of ``engine`` (each length bucket × batch bucket, at a full
    and a partial fill): the replay bitwise equal to the eager bound program on
    the same inputs; so too under a per-call ``params=`` (``other_params``),
    after it with the installed set, after a ``swap_params`` to the other set
    and after swapping back, and for two calls whose outputs are both held
    until the end; the hit lane's graphs on the returned states likewise.
    Raises on the first mismatch; returns the comparisons made."""
    from replay_tpu_torch.serve import make_window

    installed, checked = engine.params, 0

    def check(label, got, want):
        nonlocal checked
        checked += 1
        if not bitwise_equal(got, want):
            raise AssertionError(f"graph replay differs from the eager program: {label}")

    held = []
    for lb in engine.length_buckets:
        for bucket in engine.batch_buckets:
            for fill in sorted({bucket, max(1, bucket - 3)}):
                windows = [make_window(requests[(bucket + i) % len(requests)], lb) for i in range(fill)]
                ids, mask = np.stack([w[0] for w in windows]), np.stack([w[1] for w in windows])
                label = f"L={lb} B={bucket} fill={fill}"
                got = engine.encode(lb, ids, mask)
                check(label, got, eager_encode(engine, lb, ids, mask))
                held.append((label, got, ids, mask))
                check(label + " params=", engine.encode(lb, ids, mask, params=other_params),
                      eager_encode(engine, lb, ids, mask, params=other_params))
                check(label + " after params=", engine.encode(lb, ids, mask), got)
                if engine.outputs == "both":
                    hidden = got[1]
                    check(label + " hit lane", engine.score_hidden(hidden), eager_score_hidden(engine, hidden))
                    check(label + " hit lane params=", engine.score_hidden(hidden, params=other_params),
                          eager_score_hidden(engine, hidden, params=other_params))
    engine.swap_params(other_params)
    for label, _, ids, mask in held[:: max(1, len(held) // 4)]:
        lb = ids.shape[1]
        check(label + " swapped", engine.encode(lb, ids, mask), eager_encode(engine, lb, ids, mask))
    engine.swap_params(installed)
    for label, got, ids, mask in held:  # every output held since its call, checked again now
        lb = ids.shape[1]
        check(label + " held", got, eager_encode(engine, lb, ids, mask))
        check(label + " swapped back", engine.encode(lb, ids, mask), got)
    return {"comparisons": checked, "buckets": len(engine.length_buckets) * len(engine.batch_buckets)}


def encode_latency(call, calls: int, skip: int) -> dict:
    """Host-clock p50/p99 of ``call()``, which synchronises, after ``skip`` warm calls."""
    times = []
    for _ in range(calls + skip):
        t0 = time.perf_counter()
        call()
        times.append((time.perf_counter() - t0) * 1e3)
    times = sorted(times[skip:])
    return {"p50_ms": times[len(times) // 2], "p99_ms": times[min(len(times) - 1, math.ceil(0.99 * len(times)) - 1)]}


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
    # a second parameter set of the same shapes: the swaps and per-call params
    other = SasRec(schema, use_flash=True, generator=torch.Generator().manual_seed(SEED + 1), **width).state_dict()
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

    # latency per (length, batch) bucket: host clock around encode (a graph
    # replay), which synchronises with the device before it returns
    latency, inputs = {}, {}
    for lb in LENGTH_BUCKETS:
        for bucket in BATCH_BUCKETS:
            windows = [make_window(requests[i % len(requests)], lb) for i in range(bucket)]
            ids = np.stack([w[0] for w in windows])
            mask = np.stack([w[1] for w in windows])
            inputs[lb, bucket] = ids, mask
            record = {
                **encode_latency(lambda: engine.encode(lb, ids, mask), 100, 10),
                **device_time_per_encode(engine, lb, ids, mask, flash_attention, model.num_blocks),
            }
            record["device_busy_share"] = record["device_ms"] / record["p50_ms"]
            latency[f"L={lb},B={bucket}"] = record

    launches = flash_attention.launches
    encode_calls = sum(e.stats()["encode_calls"] for e in flash_engines)
    replays = sum(e.graph_counts()["encode"]["replays"] for e in flash_engines)
    # (a) every encode was one replay, which ran K4 once per block, and
    # nothing else launched it
    if launches != model.num_blocks * encode_calls or replays != encode_calls:
        raise AssertionError(
            f"K4 launches {launches} != {model.num_blocks} x {encode_calls} encode calls, or {replays} replays"
        )

    # the graphs against the eager bound program, every bucket and output mode
    # (these and the eager timings below are comparisons, after the count)
    contract = {
        name: graph_contract(e, other, requests, SEQ_LEN)
        for name, e in (("both", engine), ("slate", slate_engine), ("hidden", hidden_engine))
    }
    for lb, bucket in inputs:
        ids, mask = inputs[lb, bucket]

        def eager():
            eager_encode(engine, lb, ids, mask)
            torch.cuda.synchronize()

        latency[f"L={lb},B={bucket}"]["eager"] = encode_latency(eager, 100, 10)
    emit(
        "serve", requests=len(requests), encode_calls=encode_calls, k4_launches=launches, replays=replays,
        graphs={name: e.graph_counts() for name, e in (("both", engine), ("slate", slate_engine), ("hidden", hidden_engine))},
        graph_contract=contract,
        max_abs_err_vs_unfused=max_err, tol=SERVE_TOL, top10_ranks_checked=top_checked,
        slate_err=slate_err, retrieval_hidden_err=hidden_err, stats=engine.stats(),
        latency_ms=latency,
    )
    for e in (engine, plain, slate_engine, hidden_engine):
        e.close()
    return {"launches": launches}


class EventRecorder:
    """A ``RunLogger`` that keeps the service's events in memory."""

    def __init__(self) -> None:
        self.events = []
        self._lock = threading.Lock()

    def log_event(self, event) -> None:
        with self._lock:
            self.events.append((event.event, dict(event.payload)))

    def close(self) -> None:
        pass

    def named(self, name: str) -> list:
        with self._lock:
            return [payload for event, payload in self.events if event == name]


class ServiceClient:
    """bench_serve.py's request mix (``one_request``, :1128-1137) against a
    service. Each request is returned with the history it must be answered
    from: the user's items after the request, as the client holds them. A
    lock per user keeps a history's update and its submit in one order."""

    def __init__(self, service, histories: dict) -> None:
        self.service = service
        self.histories = {user: list(items) for user, items in histories.items()}
        self.locks = {user: threading.Lock() for user in histories}

    def seed(self, user):
        with self.locks[user]:
            items = list(self.histories[user])
            return self.service.submit(user, history=items), items

    def request(self, rng, user: int):
        draw = rng.random()
        with self.locks[user]:
            history = self.histories[user]
            if draw < 0.7:
                future = self.service.submit(user)
            elif draw < 0.9:
                new_item = int(rng.integers(0, NUM_ITEMS))
                history.append(new_item)
                future = self.service.submit(user, new_items=[new_item])
            else:
                future = self.service.submit(user, history=history)
            return future, list(history)


def stale_cache(capacity: int):
    """The control's fault: a user state cache that keeps the pre-advance
    state. An advance is encoded and answered from the advanced window, but
    the cache goes on holding the old window and its embedding, so the next
    hit is answered from a stale state."""
    from replay_tpu_torch.serve import UserStateCache

    class StaleCache(UserStateCache):
        def advance_user(self, user_id, new_items, pad_id=0):
            state = self.peek(user_id)
            if state is None:
                return super().advance_user(user_id, new_items, pad_id)
            return self.advance(state, new_items, pad_id)  # never stored

        def refresh_embedding(self, user_id, state, embedding, param_generation=0):
            current = self.peek(user_id)
            if current is not None and state.generation > current.generation:
                return  # the advanced state never lands
            super().refresh_embedding(user_id, state, embedding, param_generation)

    return StaleCache(capacity)


def service_setup(device):
    """The model (K4 route), the same weights on the unfused route, the item
    table, the re-rank's two weights and the users' histories, all from SEED;
    histories drawn as bench_serve.py:1056-1059 draws them."""
    from replay_tpu_torch.data import FeatureHint, FeatureType
    from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema
    from replay_tpu_torch.nn.sequential.sasrec import SasRec

    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
            cardinality=NUM_ITEMS, embedding_dim=EMBEDDING_DIM,
        )
    )
    width = dict(
        embedding_dim=EMBEDDING_DIM, num_blocks=NUM_BLOCKS, num_heads=NUM_HEADS,
        max_sequence_length=SEQ_LEN, dropout_rate=0.0, device=device,
    )
    model = SasRec(schema, use_flash=True, generator=torch.Generator().manual_seed(SEED), **width)
    plain_model = SasRec(schema, use_flash=False, **width)
    rng = np.random.default_rng(SEED)
    rerank = np.array([1.0 + rng.random(), rng.normal(scale=0.5)], np.float32)  # weight > 0, bias
    histories = {
        user: rng.integers(0, NUM_ITEMS, size=int(rng.integers(1, 2 * SEQ_LEN))).tolist()
        for user in range(SERVICE_USERS)
    }
    return model, plain_model, model.state_dict(), model.get_item_weights().detach(), rerank, histories


def build_service(model, params, item_weights, rerank, histories, device, precision="f32", **overrides):
    """ScoringService as bench_serve.py:1098-1120 builds it, retrieval mode,
    over a brute index at ``precision``."""
    from replay_tpu_torch.models import MIPSIndex
    from replay_tpu_torch.obs import Tracer
    from replay_tpu_torch.serve import CandidatePipeline, CircuitBreaker, FallbackScorer, ScoringService

    pipeline = CandidatePipeline(
        MIPSIndex(item_weights, precision=precision, device=device), num_candidates=SERVICE_CANDIDATES, top_k=SERVICE_TOPK,
        reranker_weights=rerank,
    )
    kwargs = dict(
        batch_buckets=BATCH_BUCKETS, max_wait_ms=SERVICE_MAX_WAIT_MS, cache_capacity=SERVICE_CACHE,
        retrieval=pipeline, tracer=Tracer(),
        breaker=CircuitBreaker(failure_threshold=5, reset_timeout_s=0.3),
        fallback=FallbackScorer.from_interactions([i for h in histories.values() for i in h], NUM_ITEMS),
        device=device,
    )
    kwargs.update(overrides)
    return ScoringService(model, params, **kwargs)


def plain_hidden(plain, windows: list, bucket: int) -> torch.Tensor:
    """``encode`` on the unfused model's engine for ``windows`` at batch
    ``bucket`` (rows past them repeat the first, as the engine pads)."""
    from replay_tpu_torch.serve import make_window

    rows = [make_window(items, SEQ_LEN) for items in windows]
    rows += rows[:1] * (bucket - len(rows))
    _, hidden = plain.encode(SEQ_LEN, np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]))
    return hidden


def direct_top10(plain, item_table: np.ndarray, rerank: np.ndarray, windows: list, bucket: int):
    """The direct path for ``windows`` at batch ``bucket``: ``encode`` on the
    unfused model, a float64 host MIPS over the item table (top-100, the lower
    id first among equal scores), the re-rank in float64, then the top-11
    (the 11th pins the 10th rank's gap). Returns (ids [n, 11], scores [n, 11])."""
    hidden = plain_hidden(plain, windows, bucket)
    scores = hidden[: len(windows)].double().cpu().numpy() @ item_table.T
    candidates = np.argsort(-scores, axis=1, kind="stable")[:, :SERVICE_CANDIDATES]
    values = np.take_along_axis(scores, candidates, axis=1)
    weight, bias = (float(x) for x in rerank)
    ranking = 1.0 / (1.0 + np.exp(-(values * weight + bias)))
    order = np.argsort(-ranking, axis=1, kind="stable")[:, : SERVICE_TOPK + 1]
    return np.take_along_axis(candidates, order, axis=1), np.take_along_axis(ranking, order, axis=1)


def check_responses(direct, records) -> dict:
    """Holds each (history, response) of ``records`` to ``direct(windows,
    bucket)`` (the direct path's ids and scores ``[n, 11]``, run at the
    response's batch bucket): top-10 ids wherever a rank is clear of its
    neighbours by more than SERVE_TOL, scores within SERVE_TOL. Returns the
    reading and the failures (the caller decides whether they fail the run)."""
    by_bucket = {}
    for items, response in records:
        by_bucket.setdefault(response.batch_bucket, []).append((items, response))
    failures, pinned, max_err, differing = [], 0, 0.0, 0
    for bucket, group in sorted(by_bucket.items()):
        for start in range(0, len(group), bucket):
            chunk = group[start : start + bucket]
            want_ids, want_scores = direct([c[0] for c in chunk], bucket)
            for (items, response), ids, scores in zip(chunk, want_ids, want_scores):
                got_ids, got_scores = np.asarray(response.item_ids), np.asarray(response.scores)
                if got_ids.shape != (SERVICE_TOPK,) or not np.isfinite(got_scores).all():
                    failures.append(f"user {response.user_id}: ids {got_ids.shape}, scores {got_scores}")
                    continue
                err = float(np.abs(got_scores.astype(np.float64) - scores[:SERVICE_TOPK]).max())
                max_err = max(max_err, err)
                differing += int((got_ids != ids[:SERVICE_TOPK]).sum())
                bad = err > SERVE_TOL
                for rank in range(SERVICE_TOPK):
                    gap_prev = math.inf if rank == 0 else scores[rank - 1] - scores[rank]
                    if min(gap_prev, scores[rank] - scores[rank + 1]) > SERVE_TOL:
                        pinned += 1
                        bad = bad or got_ids[rank] != ids[rank]
                if bad:
                    failures.append(
                        f"user {response.user_id} ({response.served_from}, bucket {bucket}): ids "
                        f"{got_ids.tolist()} vs {ids[:SERVICE_TOPK].tolist()}, max score err {err}"
                    )
    return {
        "checked": len(records), "pinned_ranks": pinned, "ids_differing": differing,
        "max_score_err": max_err, "failures": failures,
    }


def percentile_ms(latencies: list, q: float) -> float:
    ordered = sorted(latencies)
    return ordered[min(len(ordered) - 1, max(math.ceil(q * len(ordered)) - 1, 0))] * 1e3


def open_loop(submit, seconds: float, rng, rate: float = SERVICE_RATE, wait_s: float = SERVICE_WAIT_S, classify=repr) -> dict:
    """Poisson arrivals at ``rate`` for ``seconds`` (bench_serve.py's open
    loop, :1168-1194; bench_fleet.py's ``_run_open_loop``, :309-369):
    ``submit(rng)`` sends one request and returns (future, items); latency is
    read on completion callbacks. Every request is then waited for, ``wait_s``
    at most: the rest are hung, and the caller fails on them. Returns the
    records (items, future), the latencies, ``classify(exception)`` of each
    failed request, the cancelled and hung counts, the arrival rate the
    submitting thread reached and the elapsed time."""
    latencies, errors, lock = [], [], threading.Lock()
    records, done, cancelled = [], [0], [0]

    def on_done(submitted_at):
        def callback(future):
            latency = time.perf_counter() - submitted_at
            with lock:
                done[0] += 1
                if future.cancelled():
                    cancelled[0] += 1
                elif future.exception() is None:
                    latencies.append(latency)
                else:
                    errors.append(classify(future.exception()))

        return callback

    start = time.perf_counter()
    while time.perf_counter() < start + seconds:
        submitted_at = time.perf_counter()
        future, items = submit(rng)
        future.add_done_callback(on_done(submitted_at))
        records.append((items, future))
        gap = float(rng.exponential(1.0 / rate))
        if gap > 0.0005:
            time.sleep(min(gap, 1.0))
    arrival_s = time.perf_counter() - start
    deadline = time.perf_counter() + wait_s
    while True:
        with lock:
            if done[0] >= len(records) or time.perf_counter() > deadline:
                break
        time.sleep(0.002)
    elapsed = time.perf_counter() - start
    with lock:
        return {
            "records": records, "latencies": list(latencies), "errors": list(errors), "cancelled": cancelled[0],
            "hung": sum(not future.done() for _, future in records), "arrival_rate": len(records) / arrival_s,
            "elapsed": elapsed,
        }


def lost_records(prof, launched: int, per_replay: int) -> dict:
    """Where a window traced fewer K4 kernels than were counted, its Chrome
    trace read by launch call (``obs/profile.py::kernels_by_launch``). A
    graph runs all its nodes or none, so a ``cudaGraphLaunch`` that shows
    some but not all of its replay's ``per_replay`` K4 records ran them all:
    what it lacks is a record the profiler lost. ``profilers`` is True where
    that accounts for every counted launch: the trace's K4 kernels plus
    those missing from such launches equal the count, and no K4 kernel lacks
    its launch call. Also kineto's count of records it dropped as out of its
    window (None where it logged none)."""
    import tempfile

    from replay_tpu_torch.obs.profile import kernels_by_launch, out_of_range_records

    with tempfile.TemporaryDirectory() as scratch:
        path = os.path.join(scratch, "window.json")
        prof.export_chrome_trace(path)
        reading = kernels_by_launch(path, TRACE_NAMES["flash_attention"])
        out_of_range = out_of_range_records(path)
    partial = [n for n in reading["graph_launches"] if n < per_replay]
    missing = sum(per_replay - n for n in partial)
    return {
        "launched": launched, "traced": reading["kernels"], "graph_launches": len(reading["graph_launches"]),
        "partial_graph_launches": partial, "missing_from_partial": missing, "eager": reading["eager"],
        "orphans": reading["orphans"], "out_of_range": out_of_range,
        "profilers": reading["orphans"] == 0 and reading["kernels"] + missing == launched,
    }


def profiled_open_second(
    submit, rng, rate: float = SERVICE_RATE, classify=repr, quiet=torch.cuda.synchronize, per_replay: int = NUM_BLOCKS
) -> dict:
    """One more second of ``open_loop`` arrivals under ``torch.profiler``,
    between two ``quiet()`` calls (no work left queued or running on the
    card): device time (kernels and copies, summed) per second of wall clock,
    and K4's kernels in the trace, which must equal its launches in the same
    window. Late in a long process the profiler can lose a single kernel
    record of a graph replay (one K4 of 2, in about one window of two, on an
    H100): a window that traced fewer is read by launch call
    (:func:`lost_records`), and passes only where every counted launch is in
    the trace and each missing record belongs to a replay that the trace
    shows ran (``per_replay`` K4 kernels a graph). Any other loss fails the
    run."""
    from torch.autograd import DeviceType

    from replay_tpu_torch.ops.flash_attention import flash_attention

    def primer():  # one small kernel of its own: a request would add to the counts checked
        torch.ones(1, device="cuda").add_(1)

    with profiled_window(primer) as prof:
        quiet()
        before = flash_attention.launches
        t0 = time.perf_counter()
        loop = open_loop(submit, 1.0, rng, rate, classify=classify)
        quiet()
        wall = time.perf_counter() - t0
    launched = flash_attention.launches - before
    device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    traced_k4 = sum(e.count for e in device if "attention_forward" in e.key)
    lost = None
    if traced_k4 != launched:
        lost = lost_records(prof, launched, per_replay)
        if lost["traced"] != traced_k4 or not lost["profilers"]:
            raise AssertionError(f"the profiled second traced {traced_k4} K4 kernels of {launched} launched: {lost}")
    device_ms = sum(e.self_device_time_total for e in device) / 1e3
    device.sort(key=lambda e: -e.self_device_time_total)
    return {
        **loop,
        "device_ms_per_s": device_ms / wall,
        "device_busy_share": device_ms / (wall * 1e3),
        "traced_k4_kernels": traced_k4,
        "k4_launched_in_window": launched,
        "lost_records": lost,
        "top_device_ms": {e.key[:60]: e.self_device_time_total / 1e3 for e in device[:5]},
    }


def bitwise_contract(service, histories) -> dict:
    """One user's request among co-riders at each fill of SERVICE_FILLS, first
    and last in its batch: its scores and ids bitwise equal within a batch
    bucket; an advance bitwise equal to a full re-encode of the same window.
    Equality across buckets is reported, not required."""
    target, others = histories[0], [histories[user] for user in range(1, max(SERVICE_FILLS))]
    by_bucket = {}
    for fill in SERVICE_FILLS:
        for position in (0, fill - 1):
            rows = others[: fill - 1]
            rows.insert(position, target)
            calls = service.engine.encode_calls
            futures = [service.submit(f"fill{fill}-{position}-{i}", history=items) for i, items in enumerate(rows)]
            response = [f.result(timeout=SERVICE_WAIT_S) for f in futures][position]
            if service.engine.encode_calls != calls + 1 or response.served_from != "cold":
                raise AssertionError(f"fill {fill}: {service.engine.encode_calls - calls} encode batches, not one")
            by_bucket.setdefault(response.batch_bucket, []).append(response)
    within = all(
        np.array_equal(r.scores, group[0].scores) and np.array_equal(r.item_ids, group[0].item_ids)
        for group in by_bucket.values() for r in group
    )
    alone = service.score("alone", history=target, timeout=SERVICE_WAIT_S)
    firsts = [alone] + [group[0] for _, group in sorted(by_bucket.items())]
    across = all(np.array_equal(r.scores, alone.scores) for r in firsts)
    service.score("advance", history=target, timeout=SERVICE_WAIT_S)
    advanced = service.score("advance", new_items=[7], timeout=SERVICE_WAIT_S)
    reencoded = service.score("reencode", history=list(target) + [7], timeout=SERVICE_WAIT_S)
    advance_equal = (
        advanced.served_from == "advance" and advanced.batch_bucket == reencoded.batch_bucket
        and np.array_equal(advanced.scores, reencoded.scores) and np.array_equal(advanced.item_ids, reencoded.item_ids)
    )
    record = {
        "buckets": {str(b): len(g) for b, g in sorted(by_bucket.items())},
        "within_bucket_bitwise": within, "advance_equals_reencode_bitwise": advance_equal,
        "across_buckets_bitwise": across,
    }
    if not (within and advance_equal):
        raise AssertionError(f"the bitwise contract failed: {record}")
    return record


def stale_cache_control(service, histories, plain, item_table, rerank, users: int = 64) -> dict:
    """The control: a service whose cache keeps the pre-advance state. Seed
    ``users`` users, advance each by one item, then ask each for a pure hit;
    the response check must fail for it."""
    rng = np.random.default_rng(50)
    control = {user: list(histories[user]) for user in range(users)}
    records = []
    for step in ("seed", "advance", "hit"):
        batch = []
        for user, items in control.items():
            if step == "seed":
                future = service.submit(user, history=items)
            elif step == "advance":
                items.append(int(rng.integers(0, NUM_ITEMS)))
                future = service.submit(user, new_items=items[-1:])
            else:
                future = service.submit(user)
            batch.append((list(items), future))
        records += [(items, f.result(timeout=SERVICE_WAIT_S)) for items, f in batch]
    reading = check_responses(functools.partial(direct_top10, plain, item_table, rerank), records)
    if not reading["failures"]:
        raise AssertionError("the stale-cache control passed the response check: the check catches nothing")
    return {"checked": reading["checked"], "caught": len(reading["failures"]), "max_score_err": reading["max_score_err"]}


def service_phase(device) -> dict:
    """ScoringService in retrieval mode at bench_serve.py's width and traffic
    (module constants SERVICE_*), on K4; returns K4's launches on it."""
    from replay_tpu_torch.ops.flash_attention import flash_attention
    from replay_tpu_torch.serve import ScoringEngine

    model, plain_model, params, item_weights, rerank, histories = service_setup(device)
    plain = ScoringEngine(plain_model, params, batch_buckets=BATCH_BUCKETS, outputs="hidden", device=device)
    item_table = item_weights.double().cpu().numpy()
    events = EventRecorder()
    service = build_service(model, params, item_weights, rerank, histories, device, logger=events)
    client = ServiceClient(service, histories)
    errors, closed_records = [], []

    allocated_before = torch.cuda.memory_allocated(device)
    # the main path: counts start at 0 here and are read once the loops end
    flash_attention.launches = 0
    service.start()
    try:
        seeded = [client.seed(user) for user in range(SERVICE_USERS)]
        seed_records = [(items, f.result(timeout=SERVICE_WAIT_S)) for f, items in seeded]
        seed_batches = len(events.named("on_serve_batch"))

        def closed_client(index: int) -> None:
            rng = np.random.default_rng(1000 + index)
            for _ in range(SERVICE_CLOSED_REQUESTS):
                future, items = client.request(rng, int(rng.integers(0, SERVICE_USERS)))
                try:
                    closed_records.append((items, future.result(timeout=SERVICE_WAIT_S)))
                except Exception as exc:  # noqa: BLE001 — recorded, fails the phase below
                    errors.append(repr(exc))

        threads = [threading.Thread(target=closed_client, args=(i,), daemon=True) for i in range(SERVICE_CLIENTS)]
        closed_start = time.perf_counter()
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=SERVICE_WAIT_S * SERVICE_CLOSED_REQUESTS)
        closed_elapsed = time.perf_counter() - closed_start
        if any(thread.is_alive() for thread in threads):
            raise AssertionError("a closed-loop client never finished")
        closed_batches = events.named("on_serve_batch")[seed_batches:]

        open_rng = np.random.default_rng(7)

        def submit(rng):
            return client.request(rng, int(rng.integers(0, SERVICE_USERS)))

        opened = open_loop(submit, SERVICE_SECONDS, open_rng)
        profiled = profiled_open_second(submit, open_rng)
    finally:
        service.close()
    launches = flash_attention.launches
    encode_calls = service.engine.stats()["encode_calls"]

    # checks: no errors, every response primary, K4 once per block per encode
    # batch and nothing else, every closed-loop and every 8th open-loop
    # response against the direct path
    if opened["hung"] or profiled["hung"]:
        raise AssertionError(f"service: {opened['hung'] + profiled['hung']} open-loop requests unanswered after {SERVICE_WAIT_S} s")
    open_records = [
        (items, f.result(timeout=0)) for items, f in opened["records"] + profiled["records"]
        if f.exception(timeout=0) is None
    ]
    errors += opened["errors"] + profiled["errors"]
    responses = [r for _, r in seed_records + closed_records + open_records]
    not_primary = sorted({r.served_by for r in responses} - {"primary"})
    if errors or not_primary or len(closed_records) != SERVICE_CLIENTS * SERVICE_CLOSED_REQUESTS:
        raise AssertionError(f"service: errors {errors[:5]} ({len(errors)}), served_by {not_primary}")
    if launches < 1 or launches != model.num_blocks * encode_calls:
        raise AssertionError(f"service: K4 launches {launches} != {model.num_blocks} x {encode_calls} encode batches")
    checked = closed_records + open_records[::8]
    reading = check_responses(functools.partial(direct_top10, plain, item_table, rerank), checked)
    if reading["failures"]:
        raise AssertionError(f"service responses differ from the direct path: {reading['failures'][:5]}")

    # the bitwise contract and the control, each on a service of its own
    bitwise_service = build_service(model, params, item_weights, rerank, histories, device, max_wait_ms=100.0)
    with bitwise_service:
        bitwise = bitwise_contract(bitwise_service, histories)
    control_service = build_service(model, params, item_weights, rerank, histories, device)
    control_service.cache = stale_cache(SERVICE_CACHE)
    with control_service:
        control = stale_cache_control(control_service, histories, plain, item_table, rerank)
    phase_calls = encode_calls + bitwise_service.engine.encode_calls + control_service.engine.encode_calls
    # the two later services were built inside the window: their captures'
    # warm-up runs launched K4 too, once per block each
    warmups = sum(svc.engine.graph_counts()["encode"]["warmups"] for svc in (bitwise_service, control_service))
    if flash_attention.launches != model.num_blocks * (phase_calls + warmups):
        raise AssertionError(
            f"K4 ran {flash_attention.launches} times in the phase, not {model.num_blocks} x ({phase_calls} + {warmups})"
        )
    graphs = service.engine.graph_counts()
    if graphs["encode"]["replays"] != encode_calls:
        raise AssertionError(f"service: {graphs['encode']['replays']} replays for {encode_calls} encode batches")
    # the serve worker's thread had a cuBLAS handle of its own, and cuBLAS
    # keeps a workspace (32 MiB on the H100) per handle and stream: free it,
    # so that the memory the later phases read is theirs
    torch.cuda.synchronize()
    left_allocated = torch.cuda.memory_allocated(device) - allocated_before
    torch._C._cuda_clearCublasWorkspaces()

    fills = {}
    for batch in closed_batches + events.named("on_serve_batch")[seed_batches + len(closed_batches):]:
        fills.setdefault(batch["lane"], []).append(batch["fill"])
    stats = service.stats()
    (end,) = events.named("on_serve_end")
    open_latencies = opened["latencies"]
    emit(
        "service", users=SERVICE_USERS, requests=stats["requests"], errors=len(errors), served_by=stats["served_by"],
        served_from=stats["served_from"], hit_share=stats["served_from"]["hit"] / max(stats["answered"], 1),
        closed_requests=len(closed_records), closed_qps=len(closed_records) / closed_elapsed,
        open_requests=len(opened["records"]), open_qps=len(opened["records"]) / opened["elapsed"],
        open_p50_ms=percentile_ms(open_latencies, 0.5), open_p99_ms=percentile_ms(open_latencies, 0.99),
        mean_fill_by_lane={lane: statistics.fmean(f) for lane, f in sorted(fills.items())},
        batches_by_lane={lane: len(f) for lane, f in sorted(fills.items())},
        k4_launches=launches, encode_batches=encode_calls, num_blocks=model.num_blocks,
        checked=reading["checked"], pinned_ranks=reading["pinned_ranks"], max_score_err=reading["max_score_err"],
        tol=SERVE_TOL, bitwise=bitwise, stale_cache_control=control,
        goodput_fractions=end["goodput"]["fractions"], goodput_wall_s=end["goodput"]["wall_seconds"],
        profiled_second={
            k: profiled[k]
            for k in ("device_ms_per_s", "device_busy_share", "traced_k4_kernels", "lost_records", "top_device_ms")
        }
        | {"requests": len(profiled["records"])},
        rerank_weights=rerank.tolist(), allocated_left_by_the_phase_bytes=left_allocated, stats=stats,
        graphs=graphs,
    )
    return {"launches": launches}


def event_ms(fn, calls: int = 3) -> float:
    """Median device time of one eager ``fn()`` (CUDA events around each call,
    after one warm call): for calls too long to repeat 50 times."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def wall_ms(fn, reps: int) -> float:
    """Mean host time of ``fn()``, whose result reaches the host (a sync)."""
    start = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - start) / reps * 1e3


def recall(reference_ids, found_ids) -> float:
    """bench_serve.py's recall: the mean share of each row's reference ids found."""
    k = np.shape(reference_ids)[1]
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / k for a, b in zip(reference_ids, found_ids)]))


def clustered_catalog(seed: int, items: int, modes: int, dim: int = ANN_DIM, queries: int = ANN_QUERIES):
    """bench_serve.py's synthetic clustered catalog and queries (:472-478,
    :551-558): unit-norm modes plus 0.1 Gaussian noise, f32."""
    gen = np.random.default_rng(seed)
    centers = gen.standard_normal((modes, dim), dtype=np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True) + 1e-9
    catalog = centers[gen.integers(0, modes, size=items)]
    catalog += 0.1 * gen.standard_normal((items, dim), dtype=np.float32)
    query = centers[gen.integers(0, modes, size=queries)]
    query += 0.1 * gen.standard_normal((queries, dim), dtype=np.float32)
    return catalog, query


def held_to_cpu(label: str, got, want, tol: float = RETRIEVAL_TOL) -> dict:
    """The card's ``search`` (scores, ids ``[Q, k]``) against the CPU's search
    of the same state at ``k + 1``: scores within ``tol`` rank by rank, ids
    equal at every rank clear of both neighbours by more than ``tol``."""
    got_values, got_ids = got
    want_values, want_ids = (np.asarray(a) for a in want)
    k = got_ids.shape[1]
    gaps = want_values[:, :-1] - want_values[:, 1:]
    previous = np.concatenate([np.full_like(gaps[:, :1], np.inf), gaps[:, : k - 1]], axis=1)
    pinned = np.minimum(previous, gaps[:, :k]) > tol
    err = float(np.abs(got_values - want_values[:, :k]).max())
    record = {
        "label": label, "k": k, "max_abs_err": err, "tol": tol, "pinned_ranks": int(pinned.sum()),
        "ranks": int(pinned.size), "ids_equal": bool(np.array_equal(got_ids, want_ids[:, :k])),
        "ids_differing": int((got_ids != want_ids[:, :k]).sum()),
    }
    if err > tol or not np.array_equal(got_ids[pinned], want_ids[:, :k][pinned]):
        raise AssertionError(f"the card's {label} search differs from the CPU's on the same state: {record}")
    return record


def quant_checks(model, item_weights, rerank, device) -> dict:
    """bench_serve.py's quant phase (:344-425) on the port: 64 query states
    from ``SasRec.get_query_embeddings`` (K4), an f32 and an int8
    ``CandidatePipeline`` over the service model's item table; recall@C of the
    int8 sweep, top-10 agreement after the rescore, rank() ms, table bytes; the
    int8 search held to the same table searched on the CPU; the f32 up-cast
    the int8 product writes, timed."""
    from replay_tpu_torch.models import MIPSIndex
    from replay_tpu_torch.serve import CandidatePipeline

    rng = np.random.default_rng(SEED)
    ids = torch.as_tensor(rng.integers(0, NUM_ITEMS, size=(QUANT_QUERIES, SEQ_LEN)), device=device)
    mask = torch.ones(QUANT_QUERIES, SEQ_LEN, dtype=torch.bool, device=device)
    with torch.inference_mode():
        queries = model.get_query_embeddings({"item_id": ids}, mask).float()
    indexes = {
        "f32": MIPSIndex(item_weights, device=device),
        "int8": MIPSIndex(item_weights, precision="int8", device=device),
    }
    pipelines = {
        name: CandidatePipeline(index, num_candidates=SERVICE_CANDIDATES, top_k=SERVICE_TOPK, reranker_weights=rerank)
        for name, index in indexes.items()
    }
    found = {name: index.search(queries, SERVICE_CANDIDATES)[1] for name, index in indexes.items()}
    rank_ms, top10 = {}, {}
    for name, pipeline in pipelines.items():
        pipeline.rank(queries)  # warm
        rank_ms[name] = wall_ms(lambda p=pipeline: p.rank(queries), QUANT_REPS)
        top10[name] = pipeline.rank(queries)[1]
    on_cpu = MIPSIndex(item_weights, precision="int8", device="cpu")
    held = held_to_cpu(
        "int8 brute", indexes["int8"].search(queries, SERVICE_CANDIDATES),
        on_cpu.search(queries.cpu(), SERVICE_CANDIDATES + 1),
    )
    int8 = indexes["int8"]
    upcast_ms = event_ms(lambda: int8.item_vectors.T.to(torch.float32), calls=20)
    bytes_record = int8.table_bytes()
    return {
        "queries": QUANT_QUERIES, "candidates": SERVICE_CANDIDATES, "top_k": SERVICE_TOPK,
        "recall_at_candidates": recall(found["f32"], found["int8"]),
        "topk_match_rate": recall(top10["f32"], top10["int8"]),
        "f32_rank_ms": rank_ms["f32"], "int8_rank_ms": rank_ms["int8"],
        "int8_table_bytes": bytes_record["payload_bytes"], "f32_table_bytes": bytes_record["f32_bytes"],
        "bytes_ratio": bytes_record["bytes_ratio"],
        "int8_upcast_bytes": NUM_ITEMS * EMBEDDING_DIM * 4, "int8_upcast_ms": upcast_ms,
        "card_vs_cpu": held,
    }


def ivf_stage_ms(state, q, nprobe: int) -> dict:
    """Device ms of an IVF search's three stages apart (CUDA events): the
    centroid scan with its top-nprobe, the probe loop (gathers, scores,
    masks), the final top-k."""
    from replay_tpu_torch.models.ann import top_k
    from replay_tpu_torch.models.ivf import _probe_scores

    cscores = q @ state.centroids.T
    _, probes = top_k(cscores, nprobe)
    scores, _ = _probe_scores(state, q, cscores, probes, None)
    return {
        "centroid_scan": event_ms(lambda: top_k(q @ state.centroids.T, nprobe), calls=10),
        "probes": event_ms(lambda: _probe_scores(state, q, cscores, probes, None), calls=10),
        "final_top_k": event_ms(lambda: top_k(scores, ANN_K), calls=10),
    }


def ann_headline(device) -> dict:
    """bench_serve.py's ann phase headline (:454-537) on the port: f32 brute
    force against f32 IVF over the clustered 10M-item catalog; recall@100
    hard-gated, the speedup recorded beside bench_serve.py's x10 target;
    brute force's product and top-k timed apart (CUDA events), the int8 brute
    sweep on the same catalog, each build stage's seconds, peak memory."""
    from replay_tpu_torch.models import MIPSIndex
    from replay_tpu_torch.models.ann import top_k
    from replay_tpu_torch.models.ivf import default_nlist
    from replay_tpu_torch.serve import CandidatePipeline

    items = ANN_ITEMS
    modes = max(8, min(items // 1400, 1024))
    frag_cap = 1 << int(np.log2(max(8, modes * ANN_NPROBE // 2)))
    nlist = min(4096, default_nlist(items), frag_cap)
    nprobe = min(ANN_NPROBE, nlist)
    t0 = time.perf_counter()
    catalog, queries = clustered_catalog(ANN_SEED, items, modes)
    catalog_s = time.perf_counter() - t0

    release()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    brute = MIPSIndex(catalog, device=device)
    torch.cuda.synchronize()
    brute_upload_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ivf = MIPSIndex(catalog, index="ivf", nlist=nlist, nprobe=nprobe, build_sample=ANN_BUILD_SAMPLE, device=device)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    stats = ivf.index_stats()

    brute.search(queries, ANN_K)
    ivf.search(queries, ANN_K)
    found, timings = {}, {}
    for name, index, reps in (("brute", brute, ANN_BRUTE_REPS), ("ivf", ivf, ANN_IVF_REPS)):
        t0 = time.perf_counter()
        for _ in range(reps):
            _, found[name] = index.search(queries, ANN_K)  # host arrays: each search ends synchronised
        timings[name] = (time.perf_counter() - t0) / reps * 1e3
    hit = recall(found["brute"], found["ivf"])
    speedup = timings["brute"] / timings["ivf"]
    peak = torch.cuda.max_memory_allocated(device)

    # brute force's two device stages apart, and IVF's search on device time
    q = torch.as_tensor(queries, device=device)
    scores = q @ brute.item_vectors.T
    product_ms = event_ms(lambda: q @ brute.item_vectors.T)
    top_k_ms = event_ms(lambda: top_k(scores, ANN_K))
    torch_topk_ms = event_ms(lambda: torch.topk(scores, ANN_K, dim=-1))
    del scores
    ivf_device_ms = event_ms(lambda: ivf.search_jax(q, ANN_K), calls=10)
    ivf_split = ivf_stage_ms(ivf.ivf_state, q, nprobe)

    topk = {}
    for name, index in (("brute", brute), ("ivf", ivf)):
        topk[name] = CandidatePipeline(index, num_candidates=ANN_K, top_k=ANN_TOPK).rank(queries)[1]
    agreement = recall(topk["brute"], topk["ivf"])
    record = {
        "items": items, "dim": ANN_DIM, "modes": modes, "queries": ANN_QUERIES, "k": ANN_K,
        "catalog_s": catalog_s, "brute_upload_s": brute_upload_s, "build_s": build_s,
        "build_stage_s": ivf.ivf_state.build_seconds, "index_stats": stats,
        "table_bytes": ivf.table_bytes(), "brute_table_bytes": brute.table_bytes()["payload_bytes"],
        "recall_at_100": hit, "recall_gate": RECALL_GATE, "topk_agreement": agreement,
        "brute_ms": timings["brute"], "ivf_ms": timings["ivf"], "speedup": speedup,
        "speedup_target": ANN_SPEEDUP_TARGET, "meets_target": speedup >= ANN_SPEEDUP_TARGET,
        "brute_qps": ANN_QUERIES / timings["brute"] * 1e3, "ivf_qps": ANN_QUERIES / timings["ivf"] * 1e3,
        "brute_product_device_ms": product_ms, "brute_top_k_device_ms": top_k_ms,
        "brute_torch_topk_device_ms": torch_topk_ms, "ivf_search_device_ms": ivf_device_ms,
        "ivf_stage_device_ms": ivf_split,
        # the least time of each on this card (HBM and f32 FMA rates): the
        # sweep reads the table once and does 2·Q·I·E operations; IVF's probe
        # gather reads Q × nprobe × CMAX rows
        "brute_bound_ms": {
            "bytes": items * ANN_DIM * 4 / HBM_BYTES_PER_S * 1e3,
            "operations": 2 * ANN_QUERIES * items * ANN_DIM / F32_FMA_FLOPS * 1e3,
        },
        "ivf_gather_bound_ms": ANN_QUERIES * nprobe * stats["cmax"] * ANN_DIM * 4 / HBM_BYTES_PER_S * 1e3,
        "peak_allocated_bytes": peak,
    }
    if hit < RECALL_GATE:
        raise AssertionError(f"ann gate: IVF recall@{ANN_K} {hit:.4f} < {RECALL_GATE} at nprobe={nprobe}")
    del brute, ivf
    release()

    # the int8 brute sweep over the same catalog: its product writes the f32
    # up-cast of the whole table first
    int8 = MIPSIndex(catalog, precision="int8", device=device)
    int8.search(queries, ANN_K)
    record["int8_brute_ms"] = wall_ms(lambda: int8.search(queries, ANN_K), ANN_BRUTE_REPS)
    record["int8_brute_recall_at_100"] = recall(found["brute"], int8.search(queries, ANN_K)[1])
    record["int8_brute_device_ms"] = event_ms(lambda: int8.search_jax(q, ANN_K))
    record["int8_scores_device_ms"] = event_ms(lambda: (q @ int8.item_vectors.T.to(torch.float32)) * int8.item_scales[None, :])
    record["int8_upcast_device_ms"] = event_ms(lambda: int8.item_vectors.T.to(torch.float32))
    record["int8_upcast_bytes"] = items * ANN_DIM * 4
    del int8
    release()
    return record


def ann_rungs(device) -> dict:
    """The quantized rungs on bench_serve.py's rung catalog (:538-596): int8
    on its raw sweep and int8+pq through 3x overfetch and the exact rescore,
    each gated at recall@100 0.99; each rung built twice and compared tensor
    by tensor; each searched on the card and, from the same state, on the
    CPU; and the 100M projection (:598-608)."""
    from replay_tpu_torch.models import MIPSIndex
    from replay_tpu_torch.models.ivf import brute_bytes, ivf_bytes

    rung_modes = max(8, RUNG_ROWS // 1400)
    catalog, queries = clustered_catalog(RUNG_SEED, RUNG_ROWS, rung_modes)
    truth = MIPSIndex(catalog, device=device).search(queries, ANN_K)[1]
    kwargs = dict(index="ivf", nlist=RUNG_NLIST, nprobe=RUNG_NPROBE, pq_subspaces=RUNG_PQ_M, device=device)
    record = {"items": RUNG_ROWS, "modes": rung_modes, "nlist": RUNG_NLIST, "nprobe": RUNG_NPROBE}
    for rung in ("int8", "int8+pq"):
        t0 = time.perf_counter()
        index = MIPSIndex(catalog, precision=rung, **kwargs)
        build_s = time.perf_counter() - t0
        again = MIPSIndex(catalog, precision=rung, **kwargs)
        differ = [
            name for name, tensor in index.ivf_state.tensors().items()
            if not torch.equal(tensor, again.ivf_state.tensors()[name])
        ]
        if differ:
            raise AssertionError(f"{rung}: two builds differ in {differ}")
        k = ANN_K if rung == "int8" else RUNG_OVERFETCH * ANN_K
        searched = index.search(queries, k)
        found = searched[1]
        if rung == "int8+pq":
            rescored = index.exact_rescore(queries, found).cpu().numpy()
            found = np.take_along_axis(found, np.argsort(-rescored, axis=1, kind="stable")[:, :ANN_K], axis=1)
        on_cpu = MIPSIndex.from_state(catalog, rung, ivf=index.ivf_state.to("cpu"), device="cpu")
        held = held_to_cpu(f"{rung} ivf", searched, on_cpu.search(queries, k + 1))
        hit = recall(truth, found)
        record[rung] = {
            "recall_at_100": hit, "build_s": build_s, "build_stage_s": index.ivf_state.build_seconds,
            "bitwise_rebuild": True, "index_stats": index.index_stats(), "table_bytes": index.table_bytes(),
            "search_ms": wall_ms(lambda i=index: i.search(queries, k), 10), "card_vs_cpu": held,
        }
        if hit < RECALL_GATE:
            raise AssertionError(f"ann gate: {rung} rung recall@{ANN_K} {hit:.4f} < {RECALL_GATE}")
    proj_pq = ivf_bytes(100_000_000, 256, 65536, "int8+pq", pq_subspaces=32)
    proj_int8_brute = brute_bytes(100_000_000, 256, "int8")
    if not proj_pq["total_bytes"] < PROJECTION_BUDGET_BYTES < proj_int8_brute["total_bytes"]:
        raise AssertionError(f"ann gate: 100M projection inverted: {proj_pq} vs {PROJECTION_BUDGET_BYTES} vs {proj_int8_brute}")
    record["projection_100m"] = {
        "budget_bytes": PROJECTION_BUDGET_BYTES, "pq_total_bytes": proj_pq["total_bytes"],
        "int8_brute_bytes": proj_int8_brute["total_bytes"],
    }
    return record


def pipeline_direct(plain, pipeline, windows: list, bucket: int):
    """The direct path for ``windows`` at batch ``bucket``: ``encode`` on the
    unfused model, then ``pipeline.rank`` at top-11 (the 11th pins the 10th
    rank's gap) over the same index. Returns (ids, scores) ``[n, 11]``."""
    scores, ids = pipeline.rank(plain_hidden(plain, windows, bucket))
    return ids[: len(windows)], scores[: len(windows)]


def retrieval_service(model, plain, params, item_weights, rerank, histories, device) -> dict:
    """``ScoringService`` in retrieval mode over the int8 pipeline (and, for the
    same-run comparison, over the brute f32 one): every user seeded cold, then
    a closed loop of RETRIEVAL_CLIENTS threads x RETRIEVAL_REQUESTS requests.
    Every int8 response primary and equal to ``pipeline.rank`` on the unfused
    model's hidden state for its window (ids at every rank the tolerance
    pins, scores within SERVE_TOL); the ``rescore`` span in the trace."""
    from replay_tpu_torch.serve import CandidatePipeline

    out = {}
    for precision in ("int8", "f32"):
        service = build_service(model, params, item_weights, rerank, histories, device, precision=precision)
        client = ServiceClient(service, histories)
        records, latencies, errors, lock = [], [], [], threading.Lock()
        with service:
            seeded = [client.seed(user) for user in range(SERVICE_USERS)]
            records += [(items, f.result(timeout=SERVICE_WAIT_S)) for f, items in seeded]

            def closed_client(index: int) -> None:
                rng = np.random.default_rng(2000 + index)
                for _ in range(RETRIEVAL_REQUESTS):
                    start = time.perf_counter()
                    future, items = client.request(rng, int(rng.integers(0, SERVICE_USERS)))
                    try:
                        response = future.result(timeout=SERVICE_WAIT_S)
                    except Exception as exc:  # noqa: BLE001 — recorded, fails the phase below
                        errors.append(repr(exc))
                        continue
                    with lock:
                        latencies.append(time.perf_counter() - start)
                        records.append((items, response))

            threads = [threading.Thread(target=closed_client, args=(i,), daemon=True) for i in range(RETRIEVAL_CLIENTS)]
            closed_start = time.perf_counter()
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(timeout=SERVICE_WAIT_S * RETRIEVAL_REQUESTS)
            closed_elapsed = time.perf_counter() - closed_start
        if any(thread.is_alive() for thread in threads):
            raise AssertionError("a retrieval closed-loop client never finished")
        not_primary = sorted({r.served_by for _, r in records} - {"primary"})
        if errors or not_primary or len(latencies) != RETRIEVAL_CLIENTS * RETRIEVAL_REQUESTS:
            raise AssertionError(f"retrieval service ({precision}): errors {errors[:5]}, served_by {not_primary}")
        spans = {e["name"] for e in service.tracer.to_chrome_trace()["traceEvents"]}
        record = {
            "requests": len(records), "closed_requests": len(latencies),
            "closed_qps": len(latencies) / closed_elapsed,
            "closed_p50_ms": percentile_ms(latencies, 0.5), "closed_p99_ms": percentile_ms(latencies, 0.99),
            "spans": sorted(spans), "encode_batches": service.engine.encode_calls,
            "capture_warmups": service.engine.graph_counts()["encode"]["warmups"],
            "pipeline": service.retrieval.stats(),
        }
        if precision == "int8":
            if "rescore" not in spans:
                raise AssertionError(f"the int8 service's trace has no rescore span: {sorted(spans)}")
            direct = CandidatePipeline(service.retrieval.index, num_candidates=SERVICE_CANDIDATES,
                                       top_k=SERVICE_TOPK + 1, reranker_weights=rerank)
            reading = check_responses(functools.partial(pipeline_direct, plain, direct), records)
            failures = reading.pop("failures")
            if failures:
                raise AssertionError(f"int8 service responses differ from pipeline.rank: {failures[:5]}")
            record["check"] = {**reading, "tol": SERVE_TOL}
        out[precision] = record
        del service
        release()
    return out


def retrieval_phase(device) -> dict:
    """Retrieval past brute force on the card: bench_serve.py's quant phase,
    its ann phase (the 10M-item headline, the quantized rungs, the 100M
    projection) and the scoring service over the int8 pipeline. K4 (the query
    states and the services' encodes) is counted from 0 over the phase."""
    from replay_tpu_torch.ops.flash_attention import flash_attention
    from replay_tpu_torch.serve import ScoringEngine

    start = time.perf_counter()
    model, plain_model, params, item_weights, rerank, histories = service_setup(device)
    plain = ScoringEngine(plain_model, params, batch_buckets=BATCH_BUCKETS, outputs="hidden", device=device)
    # the main path: counts start at 0 here and are read at the phase's end
    flash_attention.launches = 0
    quant = quant_checks(model, item_weights, rerank, device)
    quant_k4 = flash_attention.launches
    services = retrieval_service(model, plain, params, item_weights, rerank, histories, device)
    launches = flash_attention.launches
    expected = quant_k4 + model.num_blocks * sum(r["encode_batches"] + r["capture_warmups"] for r in services.values())
    if quant_k4 != model.num_blocks or launches != expected:
        raise AssertionError(f"retrieval: K4 ran {launches} times ({quant_k4} for the queries), not {expected}")
    emit("retrieval", part="quant", **quant)
    emit("retrieval", part="service", **services)
    headline = ann_headline(device)
    emit("retrieval", part="ann", **headline)
    rungs = ann_rungs(device)
    emit("retrieval", part="rungs", **rungs)
    seconds = time.perf_counter() - start
    emit("retrieval", part="phase", seconds=seconds, k4_launches=launches)
    return {"launches": launches}


def serialize_phase(device) -> dict:
    """The serialized form at the bench_serve.py width on K4:
    ``CompiledInference.serialize`` → ``deserialize`` in each output mode (and
    with a candidate slate), every bucket's replay bitwise equal to the live
    instance's at a full and a partial fill; the loaded program's trace holds
    K4 (its ``replay_tpu_torch::`` operator launches the kernel), as many as
    counted; then ``export_inference`` → ``import_inference`` against the live
    one-bucket instance. Returns K4's launches in the phase."""
    from torch.autograd import DeviceType

    from replay_tpu_torch.data import FeatureHint, FeatureType
    from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema
    from replay_tpu_torch.nn.compiled import CompiledInference, export_inference, import_inference
    from replay_tpu_torch.nn.sequential.sasrec import SasRec
    from replay_tpu_torch.ops.flash_attention import flash_attention
    from replay_tpu_torch.serve import make_window

    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
            cardinality=NUM_ITEMS, embedding_dim=EMBEDDING_DIM,
        )
    )
    model = SasRec(
        schema, embedding_dim=EMBEDDING_DIM, num_blocks=NUM_BLOCKS, num_heads=NUM_HEADS, max_sequence_length=SEQ_LEN,
        use_flash=True, generator=torch.Generator().manual_seed(SEED), device=device,
    )
    params = model.state_dict()
    rng = np.random.default_rng(SEED + 2)
    requests = histories(rng, 80)
    slate = np.sort(rng.choice(NUM_ITEMS, 100, replace=False)).astype(np.int32)

    def windows(rows, offset=0):
        made = [make_window(requests[(offset + i) % len(requests)], SEQ_LEN) for i in range(rows)]
        return np.stack([w[0] for w in made]), np.stack([w[1] for w in made])

    def traced(call):
        """K4 launches counted and K4 kernels in a trace, over one ``call()``."""
        with profiled_window(call) as prof:
            before = flash_attention.launches
            call()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        return flash_attention.launches - before, traced_kernels(events, [flash_attention])["flash_attention"]

    reset_counts(flash_attention)
    records = {}
    for outputs, candidates in (("logits", None), ("hidden", None), ("both", None), ("both", slate)):
        label = outputs + ("+slate" if candidates is not None else "")
        live = CompiledInference.compile(
            model, params, SEQ_LEN, mode="dynamic_batch_size", dynamic_buckets=BATCH_BUCKETS, outputs=outputs,
            candidates_count=None if candidates is None else len(candidates), device=device,
        )
        t0 = time.perf_counter()
        payload = live.serialize()
        export_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        served = CompiledInference.deserialize(payload, device=device)
        load_s = time.perf_counter() - t0
        if b"replay_tpu_torch.flash_attention_forward" not in payload:
            raise AssertionError(f"serialize {label}: the payload's programs do not hold K4's operator")
        kwargs = {} if candidates is None else {"candidates": candidates}
        compared = 0
        for bucket in BATCH_BUCKETS:
            for fill in sorted({bucket, max(1, bucket - 3)}):
                ids, mask = windows(fill, bucket)
                if not bitwise_equal(served(ids, mask, **kwargs), live(ids, mask, **kwargs)):
                    raise AssertionError(f"serialize {label}: bucket {bucket} fill {fill} differs from the live instance")
                compared += 1
        ids, mask = windows(max(BATCH_BUCKETS))
        launched, in_trace = traced(lambda: served(ids, mask, **kwargs))
        if launched != NUM_BLOCKS or in_trace != launched:
            raise AssertionError(f"serialize {label}: one replay counted {launched} K4 launches, the trace {in_trace}")
        records[label] = {
            "bytes": len(payload), "serialize_s": export_s, "deserialize_and_capture_s": load_s,
            "compared": compared, "traced_k4": in_trace, "graphs": len(served.graphs.keys),
        }
        live.close()
        served.close()

    batch = max(BATCH_BUCKETS)
    payload = export_inference(model, params, SEQ_LEN, batch, device=device)
    imported = import_inference(payload, device=device)
    live = CompiledInference.compile(model, params, SEQ_LEN, batch_size=batch, device=device)
    ids, mask = windows(batch, 7)
    if not bitwise_equal(imported(ids, mask), live(ids, mask)):
        raise AssertionError("import_inference differs from the live instance")
    launched, in_trace = traced(lambda: imported(ids, mask))
    if launched != NUM_BLOCKS or in_trace != launched:
        raise AssertionError(f"import_inference: {launched} K4 launches counted, {in_trace} in the trace")
    live.close()
    records["export_inference"] = {"bytes": len(payload), "traced_k4": in_trace}
    launches = flash_attention.launches
    emit("serialize", k4_launches=launches, outputs=records)
    return {"launches": launches}


def fused_case(rows, items, dim, dtype, device, seed):
    """hidden (LayerNorm-scale rows), table (the embedding init's scale), g."""
    rng = np.random.default_rng(seed)
    hidden = torch.tensor(rng.standard_normal((rows, dim), dtype=np.float32)).to(device, dtype)
    table = torch.tensor(rng.standard_normal((items, dim), dtype=np.float32) / math.sqrt(dim))
    grad = torch.tensor(rng.standard_normal(rows, dtype=np.float32))
    return hidden, table.to(device), grad.to(device)


def fused_bound(kernel, hidden, table):
    """Least time for one K1/K2/K3 call: inputs read once and outputs written
    once over HBM rate; 2·N·E·I FLOP for the logits h·Wᵀ (K1), and as many
    again for the weighted sum, the f32 weights against W (K2) or h (K3), each
    at its ``product_rate``. Returns (ms, bound_by, bytes, FLOP, rates)."""
    rows, dim = hidden.shape
    items = table.shape[0]
    inputs = hidden.numel() * hidden.element_size() + table.numel() * table.element_size()
    moved = {
        "K1": inputs + rows * 4,  # lse out
        "K2": inputs + 2 * rows * 4 + hidden.numel() * hidden.element_size(),  # g, lse in; dh out
        "K3": inputs + 2 * rows * 4 + table.numel() * table.element_size(),  # g, lse in; dW out
    }[kernel]
    half = 2 * rows * dim * items
    products = [("logits", half, product_rate(hidden.dtype, table.dtype))]
    if kernel == "K2":
        products.append(("PW", half, product_rate(torch.float32, table.dtype)))
    elif kernel == "K3":
        products.append(("Ph", half, product_rate(torch.float32, hidden.dtype)))
    ms, by, flop, rates = least_ms(moved, products)
    return ms, by, moved, flop, rates


def fused_ce_phase(device) -> dict:
    """K1, K2, K3 vs their plain versions at every case, each on the variant E
    calls for; returns the records by case and kernel."""
    from replay_tpu_torch.ops import fused_ce as fc

    wrappers = (fc.fused_lse_forward, fc.fused_lse_dh, fc.fused_lse_dw)
    records = {}
    for index, (name, rows, items, num_valid, dtype, dim) in enumerate(FUSED_CASES):
        hidden, table, grad = fused_case(rows, items, dim, dtype, device, 100 + index)
        valid = items if num_valid is None else num_valid
        reset_counts(*wrappers)
        lse = fc.fused_lse_forward(hidden, table, num_valid)
        want_lse = fc.fused_lse_reference(hidden, table, num_valid)
        dh = fc.fused_lse_dh(hidden, table, grad, want_lse, num_valid)
        dw = fc.fused_lse_dw(hidden, table, grad, want_lse, num_valid)
        variant = fc._variant(dim)
        expected_variant = "tf32" if dim % 8 == 0 and dim <= 128 else "simt"
        ran = {fn.__name__: variant_counts(fn) for fn in wrappers}
        if variant != expected_variant or any(
            counts != {key: int(key == variant) for key in fc.VARIANTS} for counts in ran.values()
        ):
            raise AssertionError(f"fused_ce {name}: variant {variant} (expected {expected_variant}), launches {ran}")
        # the plain versions on the same input values, their f32 results not
        # rounded: for a bf16 dh the error is then its own rounding
        want_dh = fc.fused_lse_dh_reference(hidden.float(), table, grad, want_lse, num_valid)
        want_dw = fc.fused_lse_dw_reference(hidden.float(), table, grad, want_lse, num_valid)
        torch.cuda.synchronize()
        if dh.dtype != hidden.dtype or dw.dtype != table.dtype or lse.shape != (rows,):
            raise AssertionError(f"fused_ce {name}: got {lse.shape} {dh.dtype} {dw.dtype}")

        # the library's call for the same function: the valid columns only
        # (masked ones add exactly 0), TF32 off; timed, never used by the port
        h32, w32 = hidden.float(), table[:valid].float()

        def library(kernel):
            if kernel == "K1":
                return lambda: torch.logsumexp(h32 @ w32.T, -1)
            weights = lambda: grad[:, None] * torch.softmax(h32 @ w32.T, -1)  # noqa: E731
            if kernel == "K2":
                return lambda: weights() @ w32
            return lambda: weights().T @ h32

        cases = {
            "K1": (lse, want_lse, lambda: fc.fused_lse_forward(hidden, table, num_valid),
                   lambda: fc.fused_lse_reference(hidden, table, num_valid)),
            "K2": (dh, want_dh, lambda: fc.fused_lse_dh(hidden, table, grad, want_lse, num_valid),
                   lambda: fc.fused_lse_dh_reference(hidden, table, grad, want_lse, num_valid)),
            "K3": (dw, want_dw, lambda: fc.fused_lse_dw(hidden, table, grad, want_lse, num_valid),
                   lambda: fc.fused_lse_dw_reference(hidden, table, grad, want_lse, num_valid)),
        }
        for kernel, (got, want, run, plain) in cases.items():
            if not torch.isfinite(got.float()).all():
                raise AssertionError(f"{kernel} {name}: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            scale = 1.0 if kernel == "K1" else want.float().abs().max().item()
            tol = FUSED_TOL[kernel] * scale
            if kernel == "K2" and dtype == torch.bfloat16:
                tol = FUSED_TOL_BF16_DH * scale
            bound_ms, bound_by, moved, flop, rates = fused_bound(kernel, hidden, table)
            record = {
                "kernel": kernel, "case": name, "N": rows, "I": items, "E": dim,
                "variant": variant,
                "num_valid": valid, "hidden_dtype": str(dtype).removeprefix("torch."), "table_dtype": "float32",
                "max_abs_err": err, "tol": tol, "max_abs_plain": scale if kernel != "K1" else None,
                "ms": graph_ms(run, launches=10, reps=5), "eager_ms": eager_ms(run, launches=10, reps=5),
                "plain_ms": graph_ms(plain, launches=5, reps=5),
                "library_ms": graph_ms(library(kernel), launches=5, reps=5),
                "bound_ms": bound_ms, "bound_by": bound_by, "bytes": moved, "flop": flop, "rates_tflops": rates,
            }
            emit("kernel", **record)
            if err > tol:
                raise AssertionError(f"{kernel} {name}: max abs err {err} > {tol}")
            records.setdefault(name, {})[kernel] = record
    # run to run, the kernels' fixed summation order gives the same bits: the
    # bench.py width in f32 and the long-sequence width on bf16 hidden states
    for name, rows, items, _, dtype, dim in FUSED_CASES:
        if name not in ("train_f32", "longseq_bf16_hidden"):
            continue
        hidden, table, grad = fused_case(rows, items, dim, dtype, device, 100)
        lse = fc.fused_lse_forward(hidden, table)
        if not torch.equal(lse, fc.fused_lse_forward(hidden, table)):
            raise AssertionError(f"fused_lse_forward {name} differs between two runs on the same inputs")
        for fn in (fc.fused_lse_dh, fc.fused_lse_dw):
            if not torch.equal(fn(hidden, table, grad, lse), fn(hidden, table, grad, lse)):
                raise AssertionError(f"{fn.__name__} {name} differs between two runs on the same inputs")
    return records


def flash_backward_check(device) -> dict:
    """K4's gradient (the Function's backward, torch ops mirroring the JAX
    _flash_bwd) at the training shape against autograd through the plain
    version, under the training (-inf) mask."""
    from replay_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_backward,
        flash_attention_reference,
    )

    q, k, v, bias = attention_case(TRAIN_BATCH, 1, SEQ_LEN, EMBEDDING_DIM, 1, "train", torch.float32, device, 7)
    g = torch.randn(q.shape, device=device, generator=torch.Generator(device).manual_seed(8))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.sum(flash_attention(*leaves, bias) * g).backward()
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.sum(flash_attention_reference(*plain, bias) * g).backward()
    torch.cuda.synchronize()
    err = max((a.grad - b.grad).abs().max().item() for a, b in zip(leaves, plain))
    finite = all(torch.isfinite(t.grad).all() for t in leaves)
    record = {
        "kernel": "K4_backward", "B": TRAIN_BATCH, "H": 1, "L": SEQ_LEN, "D": EMBEDDING_DIM, "mask": "train",
        "max_abs_err": err, "tol": FLASH_GRAD_TOL,
        "backward_ms": graph_ms(lambda: flash_attention_backward(q, k, v, bias, g), launches=10, reps=5),
    }
    emit("kernel", **record)
    if not finite or err > FLASH_GRAD_TOL:
        raise AssertionError(f"K4 gradient: finite={finite}, max abs err {err} > {FLASH_GRAD_TOL}")
    return record


def next_item_batch(batch: int, length: int, seed: int = 0):
    """Full next-item windows from default_rng(seed), as bench.py:222-230 and
    bench_suite.py:211-223 (``sasrec_batch``) build them (seed 0): no padding."""
    rng = np.random.default_rng(seed)
    items = rng.integers(0, NUM_ITEMS, size=(batch, length + 1)).astype(np.int32)
    mask = np.ones((batch, length), dtype=bool)
    return {
        "feature_tensors": {"item_id": items[:, :-1]},
        "padding_mask": mask,
        "positive_labels": items[:, 1:, None],
        "target_padding_mask": mask[:, :, None],
    }


def held_out_windows(count: int = 256):
    """Left-padded windows of held-out users, the next item as ground truth."""
    rng = np.random.default_rng(1)
    lengths = rng.integers(1, SEQ_LEN + 1, count)
    ids = rng.integers(0, NUM_ITEMS, (count, SEQ_LEN)).astype(np.int32)
    mask = np.arange(SEQ_LEN)[None, :] >= SEQ_LEN - lengths[:, None]
    ids = np.where(mask, ids, NUM_ITEMS).astype(np.int32)
    truth = rng.integers(0, NUM_ITEMS, (count, 1)).astype(np.int32)
    half = count // 2
    return [
        {
            "feature_tensors": {"item_id": ids[s]}, "padding_mask": mask[s], "ground_truth": truth[s],
            "train": np.where(mask[s], ids[s], -1), "query_id": np.arange(count)[s],
        }
        for s in (slice(0, half), slice(half, count))
    ]


def step_times(trainer, state, batch, steps: int):
    """Host-clock ms of each step, synchronised after every step."""
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, loss = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return state, times


# A step launches a fixed number of kernels, fixed by the trainer's code, and
# its kernels and copies run one after another on one stream. A trace that
# lost events shows fewer kernels, so a device time is read only from a trace
# whose kernel count is a whole number per step and agrees exactly with
# another trace of the same path, and whose device events took no longer
# than the CUDA events around the same steps. One retrace is allowed; then
# the run fails with every reading. The batch's host-to-device copies are
# timed but not counted: their number varies between traces of the same
# steps (400 and 399 for 10 steps of the bf16 long-sequence trainer on an
# H100, beside 5,390 kernels in both). A trace that starts cold also missed
# one kernel of the window in every trace (429 of the bf16 step's 430 bf16
# casts in 10 steps, three traces in a row, on an H100, after this script's
# CUDA graph phases): each trace runs one more step first as the profiler's
# warm-up cycle, whose events the profiler drops, and reads the window after it.
TRACES_AT_MOST = 3
COPY_EVENTS = ("Memcpy", "Memset")
# The profiler keeps a device event only inside its capture window: every
# window here is obs/profile.py::profiled_window, which opens and closes
# TRACE_MARGIN_S away from the work (chip_trace_probe.py takes traces with and
# without the margin).


def traced_steps(trainer, state, batch, steps: int):
    """One profiler trace of ``steps`` steps, between two CUDA events: the
    kernels and copies it holds, their summed device time and the events'
    time, and the profiler's averages and device events."""
    with profiled_window(lambda: trainer.train_step(state, batch)) as prof:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            state, _ = trainer.train_step(state, batch)
        end.record()
    events = prof.key_averages()
    device = device_events(events)
    copies = [e for e in device if e.key.startswith(COPY_EVENTS)]
    reading = {
        "kernels": sum(e.count for e in device) - sum(e.count for e in copies),
        "copies": sum(e.count for e in copies),
        "device_ms": sum(e.self_device_time_total for e in device) / 1e3,
        "event_ms": start.elapsed_time(end),
    }
    return state, reading, events, device


def device_time_per_step(trainer, state, batch, steps: int) -> dict:
    """Kernel time per step from a profiler trace of ``steps`` steps that
    agrees with another (see ``TRACES_AT_MOST``), and the kernels that take
    most of it; ``traces`` counts the traces taken (2 when none had to be
    retaken)."""
    from torch.autograd import DeviceType

    readings, sound_counts = [], []
    for _ in range(TRACES_AT_MOST):
        state, reading, events, kernels = traced_steps(trainer, state, batch, steps)
        # the kernels whose count is not a whole number per step, for the failure report
        reading["uneven"] = {e.key[:80]: e.count for e in kernels if e.count % steps}
        readings.append(reading)
        if reading["kernels"] % steps or reading["device_ms"] > reading["event_ms"]:
            continue
        if reading["kernels"] in sound_counts:
            break
        sound_counts.append(reading["kernels"])
    else:
        raise AssertionError(f"no two profiler traces of {steps} steps agree: {readings}")
    kernels.sort(key=lambda e: -e.self_device_time_total)
    host = sorted((e for e in events if e.device_type == DeviceType.CPU), key=lambda e: -e.self_cpu_time_total)
    return state, {
        "device_ms": reading["device_ms"] / steps,
        "kernels_per_step": reading["kernels"] // steps,
        "copies_per_step": reading["copies"] / steps,
        "traces": len(readings),
        "trace_readings": readings,
        "top_kernels_ms": {e.key[:60]: e.self_device_time_total / steps / 1e3 for e in kernels[:6]},
        # where the host's time goes, profiled (the profiler's own cost included)
        "top_host_ops_ms": {e.key[:60]: e.self_cpu_time_total / steps / 1e3 for e in host[:6]},
    }


def trainer_perf(trainer, state, batch, steps: int, warmup: int, profiled: int, tokens: int):
    """Step p50/p99, tokens/s, peak memory, then device time from a profiler trace."""
    device = trainer.device
    torch.cuda.reset_peak_memory_stats(device)
    at_start = torch.cuda.memory_allocated(device)
    state, _ = step_times(trainer, state, batch, warmup)
    state, times = step_times(trainer, state, batch, steps)
    times.sort()
    p50 = times[len(times) // 2]
    record = {
        "p50_ms": p50, "p99_ms": times[min(len(times) - 1, math.ceil(0.99 * len(times)) - 1)],
        "tokens_per_s": tokens / (p50 / 1e3),
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(device),
        # what the card held when the window began (both trainers' state, earlier phases' leftovers)
        "memory_allocated_at_start_bytes": at_start,
    }
    state, device_record = device_time_per_step(trainer, state, batch, profiled)
    record.update(device_record, device_busy_share=device_record["device_ms"] / p50)
    return state, record


def traced_chunks(trainer, state, chunk, repeats: int, counters):
    """One profiler trace of ``repeats`` ``train_steps`` calls on ``chunk``
    (each one graph replay, after the stacking and the copy to the card),
    between two CUDA events: kernels and copies, device time, each counter's
    kernels in the trace and its launches counted through the replays."""
    with profiled_window(lambda: trainer.train_steps(state, chunk)) as prof:
        before = {fn.__name__: fn.launches for fn in counters}
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(repeats):
            state, _ = trainer.train_steps(state, chunk)
        end.record()
    device = device_events(prof.key_averages())
    copies = [e for e in device if e.key.startswith(COPY_EVENTS)]
    kernels = [e for e in device if not e.key.startswith(COPY_EVENTS)]
    reading = {
        "kernels": sum(e.count for e in kernels),
        "copies": sum(e.count for e in copies),
        "device_ms": sum(e.self_device_time_total for e in device) / 1e3,
        "event_ms": start.elapsed_time(end),
        "traced": traced_kernels(kernels, counters),
        "launched": {fn.__name__: fn.launches - before[fn.__name__] for fn in counters},
    }
    kernels.sort(key=lambda e: -e.self_device_time_total)
    reading["top_kernels_ms"] = {e.key[:60]: e.self_device_time_total / 1e3 for e in kernels[:6]}
    return state, reading


def chunk_checks(trainer, initial, batches, chunk: int, counters, per_step: dict, tokens: int) -> dict:
    """``Trainer.train_steps`` (K = ``chunk`` steps, one CUDA graph) and
    ``fit(scan_chunk=K)`` against the per-step path, from ``initial``.

    The per-step path runs twice first: where the two runs are bitwise equal,
    the graph's ``[K]`` losses and final parameters, and the chunked fit's
    parameters and history (``device_feed`` on and off), must be bitwise equal
    to them; where not, within the two runs' spread. Launches: each counter
    once per step times ``per_step[name]``, for the K replayed steps and the
    capture's one eager warm-up step. Then time and memory: ``train_steps``
    calls and a whole ``fit`` on a captured state against the per-step
    ``fit``, and two profiler traces of replays that must agree with each
    other and with the launch counts."""
    device = trainer.device
    steps = batches[:chunk]

    def per_step_run():
        state = trainer.init_state(steps[0], params=initial)
        losses = torch.stack([trainer.train_step(state, b)[1] for b in steps])
        torch.cuda.synchronize()
        return losses, state.flat_params.clone()

    (losses_a, params_a), (losses_b, params_b) = per_step_run(), per_step_run()
    deterministic = torch.equal(losses_a, losses_b) and torch.equal(params_a, params_b)
    spread = {"loss": (losses_a - losses_b).abs().max().item(), "params": (params_a - params_b).abs().max().item()}

    reset_counts(*counters)
    warmups = trainer.capture_warmups
    state = trainer.init_state(steps[0], params=initial)
    state, graph_losses = trainer.train_steps(state, steps)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    variants = {fn.__name__: variant_counts(fn) for fn in counters if hasattr(fn, "launches_by_variant")}
    warmups = trainer.capture_warmups - warmups
    expected = {name: per_step[name] * (chunk + warmups) for name in launches}
    if launches != expected or warmups != 1:
        raise AssertionError(f"train_steps K={chunk}: launches {launches}, expected {expected} ({warmups} warm-ups)")
    graph_losses = torch.as_tensor(graph_losses, device=device)
    graph_spread = {
        "loss": (graph_losses - losses_a).abs().max().item(),
        "params": (state.flat_params - params_a).abs().max().item(),
    }
    held = (
        torch.equal(graph_losses, losses_a) and torch.equal(state.flat_params, params_a)
        if deterministic else all(graph_spread[key] <= spread[key] for key in spread)
    )
    if not held or int(state.bad_steps):
        raise AssertionError(f"train_steps K={chunk} vs the per-step path: {graph_spread} (per-step spread {spread})")

    def fit_run(**kwargs):
        run_state = trainer.init_state(batches[0], params=initial)
        trainer.history = []
        run_state = trainer.fit(batches, state=run_state, log_every=0, **kwargs)
        torch.cuda.synchronize()
        return run_state.flat_params.clone(), [dict(r) for r in trainer.history], run_state.step

    fits = {
        "per_step": fit_run(), "per_step_again": fit_run(),
        "device_feed": fit_run(scan_chunk=chunk, device_feed=True),
        "device_feed_off": fit_run(scan_chunk=chunk, device_feed=False),
    }
    reference = fits["per_step"]
    fit_deterministic = torch.equal(reference[0], fits["per_step_again"][0])
    fit_spread = (reference[0] - fits["per_step_again"][0]).abs().max().item()
    fit_readings = {}
    for name in ("device_feed", "device_feed_off"):
        params, history, step = fits[name]
        err = (params - reference[0]).abs().max().item()
        fit_readings[name] = {"params_max_abs_diff": err, "history_equal": history == reference[1], "step": step}
        sound = (err == 0 and history == reference[1]) if fit_deterministic else err <= fit_spread
        if not sound or step != len(batches):
            raise AssertionError(f"fit(scan_chunk={chunk}, {name}) vs fit(): {fit_readings[name]}, spread {fit_spread}")

    # time and memory on a captured state: the train_steps calls (stack, copy
    # to the card, one replay, the losses back), then whole fits
    torch.cuda.reset_peak_memory_stats(device)
    at_start = torch.cuda.memory_allocated(device)
    state = trainer.init_state(steps[0], params=initial)
    state, _ = trainer.train_steps(state, steps)  # the capture
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        state, _ = trainer.train_steps(state, steps)
        times.append((time.perf_counter() - t0) * 1e3 / chunk)
    peak = torch.cuda.max_memory_allocated(device)
    per_step_ms = statistics.median(times)
    fit_ms = {}
    for name, kwargs in (("per_step", {}), ("chunked", dict(scan_chunk=chunk, device_feed=True))):
        run_state = trainer.init_state(batches[0], params=initial)
        run_state = trainer.fit(batches[:chunk], state=run_state, log_every=0, **kwargs)  # warm, captured
        t0 = time.perf_counter()
        trainer.fit(batches, state=run_state, log_every=0, **kwargs)
        torch.cuda.synchronize()
        fit_ms[name] = (time.perf_counter() - t0) * 1e3 / len(batches)
    readings = []
    for _ in range(TRACES_AT_MOST):
        state, reading = traced_chunks(trainer, state, steps, 2, counters)
        readings.append(reading)
        sound = reading["traced"] == reading["launched"] and reading["device_ms"] <= reading["event_ms"]
        if sound and len(readings) > 1 and readings[-2]["kernels"] == reading["kernels"]:
            break
    else:
        raise AssertionError(f"no two profiler traces of K={chunk} replays agree with the counts: {readings}")
    device_ms = reading["device_ms"] / (2 * chunk)
    return {
        "chunk": chunk, "per_step_bitwise_deterministic": deterministic, "per_step_spread": spread,
        "graph_vs_per_step": graph_spread, "graph_losses": graph_losses.tolist(), "launches": launches,
        "variants": variants,
        "capture_warmup_steps": warmups, "fit_batches": len(batches), "fit_bitwise_deterministic": fit_deterministic,
        "fit": fit_readings,
        "perf": {
            "train_steps_ms_per_step": per_step_ms, "tokens_per_s": tokens / (per_step_ms / 1e3),
            "fit_ms_per_step": fit_ms, "fit_tokens_per_s": {k: tokens / (v / 1e3) for k, v in fit_ms.items()},
            "device_ms_per_step": device_ms, "device_busy_share": device_ms / per_step_ms,
            "kernels_per_step": reading["kernels"] / (2 * chunk), "copies_per_step": reading["copies"] / (2 * chunk),
            "traced_kernels": reading["traced"], "launched": reading["launched"], "traces": len(readings),
            "top_kernels_ms_per_step": {k: v / (2 * chunk) for k, v in reading["top_kernels_ms"].items()},
            "max_memory_allocated_bytes": peak, "memory_allocated_at_start_bytes": at_start,
        },
    }


def loss_gradient(model, loss, batch, device) -> torch.Tensor:
    """The loss's gradient w.r.t. every parameter, flattened, from the model
    and loss as the trainer binds them."""
    loss.logits_callback = model.get_logits
    loss.item_embeddings_callback = model.get_item_weights
    tensors = {
        key: torch.as_tensor(batch[key], device=device)
        for key in ("padding_mask", "positive_labels", "target_padding_mask")
    }
    ids = torch.as_tensor(batch["feature_tensors"]["item_id"], device=device)
    hidden = model({"item_id": ids}, tensors["padding_mask"], deterministic=False)
    value = loss(
        hidden, {}, tensors["positive_labels"], None, tensors["padding_mask"], tensors["target_padding_mask"]
    )
    return torch.cat([g.reshape(-1) for g in torch.autograd.grad(value, list(model.parameters()))])


def train_phase(device) -> dict:
    """Trainer(CEFused(), SasRec(use_flash=True)) against Trainer(CE(),
    SasRec(use_flash=False)) at the bench.py width, from the same weights."""
    from replay_tpu_torch.data import FeatureHint, FeatureType
    from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema
    from replay_tpu_torch.nn.loss import CE, CEFused
    from replay_tpu_torch.nn.postprocess import SeenItemsFilter
    from replay_tpu_torch.nn.sequential.sasrec import SasRec
    from replay_tpu_torch.nn.train import OptimizerFactory, Trainer
    from replay_tpu_torch.ops import fused_ce as fc
    from replay_tpu_torch.ops.flash_attention import flash_attention

    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
            cardinality=NUM_ITEMS, embedding_dim=EMBEDDING_DIM,
        )
    )
    width = dict(
        embedding_dim=EMBEDDING_DIM, num_blocks=NUM_BLOCKS, num_heads=NUM_HEADS,
        max_sequence_length=SEQ_LEN, dropout_rate=0.0, device=device,
    )
    optimizer = OptimizerFactory(name="adam", learning_rate=1e-3)
    fused_model = SasRec(schema, use_flash=True, generator=torch.Generator().manual_seed(SEED), **width)
    fused = Trainer(fused_model, CEFused(), optimizer=optimizer, device=device)
    plain = Trainer(SasRec(schema, use_flash=False, **width), CE(), optimizer=optimizer, device=device)
    batch = next_item_batch(TRAIN_BATCH, SEQ_LEN)
    fused_state = fused.init_state(batch)
    initial = {name: value.detach().clone() for name, value in fused_model.state_dict().items()}
    plain_state = plain.init_state(batch, params=fused_model.state_dict())
    counters = (fc.fused_lse_forward, fc.fused_lse_dh, fc.fused_lse_dw, flash_attention)

    # gradients at the shared starting weights (launches here are comparisons,
    # not the main path, and are not counted)
    unfused_ce = loss_gradient(plain.model, CE(), batch, device)
    grads = {
        "cefused_vs_ce": loss_gradient(plain.model, CEFused(), batch, device),
        "k4_route_vs_unfused": loss_gradient(fused.model, CE(), batch, device),
    }
    grad_err = {name: ((got - unfused_ce).norm() / unfused_ce.norm()).item() for name, got in grads.items()}
    finite = all(torch.isfinite(got).all() for got in grads.values())
    if not finite or any(grad_err[name] > TRAIN_GRAD_RTOL[name] for name in grad_err):
        raise AssertionError(f"gradients: finite={finite}, relative errors {grad_err} vs {TRAIN_GRAD_RTOL}")

    # the main path: counts start at 0 here and are read right after its steps
    reset_counts(*counters)
    fused_losses = []
    for _ in range(TRAIN_STEPS):
        fused_state, loss = fused.train_step(fused_state, batch)
        fused_losses.append(loss)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    fused_variants = fused_variant_counts(fc)
    plain_losses = []
    for _ in range(TRAIN_STEPS):
        plain_state, loss = plain.train_step(plain_state, batch)
        plain_losses.append(loss)
    torch.cuda.synchronize()
    after_plain = {fn.__name__: fn.launches for fn in counters}
    fused_losses = [float(x) for x in fused_losses]
    plain_losses = [float(x) for x in plain_losses]

    expected = {
        "fused_lse_forward": TRAIN_STEPS, "fused_lse_dh": TRAIN_STEPS, "fused_lse_dw": TRAIN_STEPS,
        "flash_attention": NUM_BLOCKS * TRAIN_STEPS,
    }
    if launches != expected or after_plain != launches:
        raise AssertionError(f"launches {launches}, after the plain trainer {after_plain}, expected {expected}")
    check_fused_variants("training", fused_variants, TRAIN_STEPS)
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(fused_losses, plain_losses))
    if not all(math.isfinite(x) for x in fused_losses + plain_losses) or loss_err > TRAIN_LOSS_RTOL:
        raise AssertionError(f"fused vs plain losses differ by rtol {loss_err}: {fused_losses} vs {plain_losses}")
    if not fused_losses[-1] < fused_losses[0] or int(fused_state.bad_steps) or int(plain_state.bad_steps):
        raise AssertionError(f"loss did not fall or steps were skipped: {fused_losses}")

    # the two trainers' weights after the same steps; a key bias has a zero
    # gradient up to rounding (it adds one constant to a query's every score),
    # which Adam scales to ±lr a step, so it is left out
    param_err = {
        name: (fused_state.params[name] - plain_state.params[name]).abs().max().item()
        for name in fused_state.params
        if not name.endswith("key.bias")
    }
    worst_params = dict(sorted(param_err.items(), key=lambda kv: -kv[1])[:3])

    # validation and top-k on held-out windows, both trainers after the same steps;
    # half the users' ground truth is an item of the fused trainer's own top 5,
    # so the metrics are not all 0 on this random data
    windows = held_out_windows()
    post = [SeenItemsFilter()]
    for window in windows:
        ranked = fused.predict_top_k(fused_state, window, 5, postprocessors=post)[1]
        picked = ranked[np.arange(len(ranked)), np.arange(len(ranked)) % 5]
        window["ground_truth"][::2, 0] = picked[::2]
    fused_metrics = fused.validate(fused_state, windows, top_k=(1, 5, 10), postprocessors=post)
    plain_metrics = plain.validate(plain_state, windows, top_k=(1, 5, 10), postprocessors=post)
    metric_err = max(abs(fused_metrics[k] - plain_metrics[k]) for k in plain_metrics)
    logits_err = max(
        (fused.predict_logits(fused_state, w) - plain.predict_logits(plain_state, w)).abs().max().item()
        for w in windows
    )
    # top 11, so that the 10th rank's gap to the next is known
    _, fused_items, fused_scores = fused.predict_top_k(fused_state, windows, 11, postprocessors=post)
    _, plain_items, plain_scores = plain.predict_top_k(plain_state, windows, 11, postprocessors=post)
    # a rank of the top 10 is pinned where its score is clear of both
    # neighbours by more than twice the two trainers' largest score difference
    gaps = -np.diff(plain_scores, axis=1)
    previous = np.concatenate([np.full((len(gaps), 1), np.inf), gaps[:, :9]], axis=1)
    pinned = np.minimum(previous, gaps) > 2 * logits_err
    # Adam steers each weight by the sign of its gradient where the gradient is
    # all cancellation (as on this random data), so f32 noise moves the two
    # trainers' weights apart by up to ~lr a step: a user's metrics can differ
    # only where one of its top-10 ranks is not pinned
    metric_tol = float((~pinned).any(axis=1).mean())
    if metric_err > metric_tol or not np.array_equal(fused_items[:, :10][pinned], plain_items[:, :10][pinned]):
        raise AssertionError(f"fused vs plain: metrics differ by {metric_err}, top-10 by rank {fused_items} vs {plain_items}")
    if fused_metrics["recall@5"] < 0.25 or fused_items.shape != (len(plain_items), 11) or not np.isfinite(fused_scores).all():
        raise AssertionError(f"predict_top_k: {fused_items.shape}, finite={np.isfinite(fused_scores).all()}")

    # speed: both trainers, same steps, a sync after each step
    perf = {}
    for name, trainer, state in (("fused", fused, fused_state), ("plain", plain, plain_state)):
        _, perf[name] = trainer_perf(
            trainer, state, batch, TIMED_STEPS, WARMUP_STEPS, PROFILED_STEPS,
            TRAIN_BATCH * SEQ_LEN,
        )
    # K steps a dispatch: train_steps at bench.py's REPLAY_TPU_BENCH_SCAN_K and
    # fit(scan_chunk) over two chunks and a tail, from the fused trainer's
    # initial weights, against its per-step path
    batches = [next_item_batch(TRAIN_BATCH, SEQ_LEN, seed) for seed in range(1, SCAN_BATCHES + 1)]
    per_step = {"flash_attention": NUM_BLOCKS, "fused_lse_forward": 1, "fused_lse_dh": 1, "fused_lse_dw": 1}
    chunked = chunk_checks(fused, initial, batches, SCAN_K, counters, per_step, TRAIN_BATCH * SEQ_LEN)
    check_fused_variants(
        "training on a graph", {k: v for k, v in chunked["variants"].items() if k.startswith("fused")}, SCAN_K + 1
    )
    emit(
        "train", batch=TRAIN_BATCH, seq_len=SEQ_LEN, items=NUM_ITEMS, embedding_dim=EMBEDDING_DIM,
        blocks=NUM_BLOCKS, steps=TRAIN_STEPS, launches=launches, fused_ce_variants=fused_variants, fused_losses=fused_losses,
        plain_losses=plain_losses, loss_max_rtol=loss_err, loss_tol=TRAIN_LOSS_RTOL,
        fused_metrics=fused_metrics, plain_metrics=plain_metrics, metric_max_abs_err=metric_err,
        metric_tol=metric_tol, logits_max_abs_err=logits_err, top10_ranks_checked=int(pinned.sum()),
        param_max_abs_err=worst_params, grad_rel_err=grad_err, grad_tol=TRAIN_GRAD_RTOL,
        perf=perf, chunked=chunked,
    )
    return {**launches, "graph": chunked["launches"]}


# the observe phase: the bench.py-width trainer's fit(scan_chunk=32) with
# every observability argument on, over 99 batches: at health cadence 33 that
# is 3 K=32 chunks and 3 health steps (steps 33, 66, 99); the profile window
# covers the first health step and the chunk after it (executed steps 32–64,
# 0-based); the planted SLO rule breaches from step 50 on, so it fires once
OBSERVE_BATCHES, OBSERVE_CADENCE, OBSERVE_WINDOW, OBSERVE_SLO_STEP = 99, 33, (32, 65), 50
# goodput fractions sum to 1 by construction, up to f64 rounding
GOODPUT_SUM_TOL = 1e-6


class FitEventRecorder:
    """A run-logger sink that keeps every event."""

    def __init__(self) -> None:
        self.events = []

    def log_event(self, event) -> None:
        self.events.append(event)

    def named(self, name: str) -> list:
        return [e for e in self.events if e.event == name]


def scrape_while(trainer, stop, scrapes) -> None:
    """Scrape the fit's exporter on localhost until ``stop`` is set: each
    successful read of ``/metrics`` and ``/snapshot`` is appended."""
    import urllib.request

    while not stop.is_set():
        exporter = trainer.metrics_exporter
        url = exporter.url if exporter is not None else None
        if url is not None:
            try:
                text = urllib.request.urlopen(f"{url}/metrics", timeout=2).read().decode()
                snapshot = json.loads(urllib.request.urlopen(f"{url}/snapshot", timeout=2).read().decode())
                scrapes.append({"metrics": text, "snapshot": snapshot})
            except OSError:
                pass
        stop.wait(0.05)


def goodput_sums(events) -> list:
    """The goodput fractions' sum of every event that carries them."""
    return [sum(e.payload["goodput"]["fractions"].values()) for e in events if "goodput" in e.payload]


OBSERVE_API_K = 3  # the steps of the graph that utils.profiling.trace and StepTimer read


def trace_kernel_counts(path: str, names) -> dict:
    """Each kernel's events in an exported Chrome trace, by ``TRACE_NAMES``."""
    from replay_tpu_torch.obs.profile import load_capture

    kernels = [e.get("name", "") for e in load_capture(path) if e.get("cat") == "kernel"]
    return {name: sum(1 for k in kernels if re.search(TRACE_NAMES[name], k)) for name in names}


def profiling_api_checks(make_trainer, batches, counters, steps_per_sec: float) -> dict:
    """The profiling API on the observe phase's trainer (graphs of
    ``OBSERVE_API_K`` steps, each captured before it is read):

    * ``utils.profiling.trace`` around one replay (``OBSERVE_API_K`` steps):
      each kernel's name in the exported trace as often as ``ops/counts.py``
      counted its launches, and those launches a step as the model predicts
      (K4 once a block, K1–K3 once);
    * ``utils.StepTimer`` over replays: its samples/s beside the phase's own
      (the plain fit's steady steps/s times the batch);
    * ``TensorBoardLogger`` on a short ``fit``: history and weights equal to
      the same fit without it; event files written where a backend is
      installed, else exactly one warning.
    """
    import logging
    import tempfile

    from replay_tpu_torch.obs import TensorBoardLogger
    from replay_tpu_torch.obs import events as events_module
    from replay_tpu_torch.obs.profile import latest_capture
    from replay_tpu_torch.utils import StepTimer, trace

    chunks = [batches[i:i + OBSERVE_API_K] for i in range(0, 5 * OBSERVE_API_K, OBSERVE_API_K)]
    trainer = make_trainer()
    state = trainer.init_state(batches[0])
    state, _ = trainer.train_steps(state, chunks[0])  # the capture
    root = tempfile.mkdtemp(prefix="observe-api-")
    before = {fn.__name__: fn.launches for fn in counters}
    with trace(f"{root}/trace"):
        state, _ = trainer.train_steps(state, chunks[1])
        torch.cuda.synchronize()
    launched = {fn.__name__: fn.launches - before[fn.__name__] for fn in counters}
    traced = trace_kernel_counts(latest_capture(f"{root}/trace"), launched)
    predicted = {name: OBSERVE_API_K * (NUM_BLOCKS if name == "flash_attention" else 1) for name in launched}
    if traced != launched or launched != predicted:
        raise AssertionError(f"observe: utils.profiling.trace holds {traced}, counted {launched}, predicted {predicted}")

    timer = StepTimer(warmup_steps=1, samples_per_step=OBSERVE_API_K * TRAIN_BATCH)
    for chunk in chunks[2:] * 3:
        state, _ = trainer.train_steps(state, chunk)
        timer.tick(state.flat_params)
    timed = timer.finish(state.flat_params)

    messages = []

    class Catch(logging.Handler):
        def emit(self, record):
            if "no tensorboard backend" in record.getMessage():
                messages.append(record.getMessage())

    handler = Catch()
    logging.getLogger("replay_tpu_torch").addHandler(handler)
    runs = {}
    try:
        for name in ("plain", "tensorboard"):
            fitted = make_trainer()
            sinks = [TensorBoardLogger(f"{root}/tensorboard")] if name == "tensorboard" else []
            end = fitted.fit(
                batches[:2 * OBSERVE_API_K], state=fitted.init_state(batches[0]), scan_chunk=OBSERVE_API_K,
                loggers=sinks, log_every=0,
            )
            for sink in sinks:
                sink.close()
            runs[name] = (list(fitted.history), end.flat_params.clone())
    finally:
        logging.getLogger("replay_tpu_torch").removeHandler(handler)
    backend = events_module._load_summary_writer() is not None
    written = sorted(os.listdir(f"{root}/tensorboard")) if os.path.isdir(f"{root}/tensorboard") else []
    board = {
        "backend": backend, "event_files": len(written), "warnings": len(messages),
        "outcome": "wrote event files" if written else "warned once, dropped the events" if len(messages) == 1 else "neither",
        "history_equal": runs["plain"][0] == runs["tensorboard"][0],
        "weights_equal": bool(torch.equal(runs["plain"][1], runs["tensorboard"][1])),
    }
    if not (board["history_equal"] and board["weights_equal"]) or (written if not backend else not written) or (
        not backend and len(messages) != 1
    ):
        raise AssertionError(f"observe: TensorBoardLogger on a short fit: {board}")
    shutil.rmtree(root, ignore_errors=True)
    return {
        "trace": {"launched": launched, "traced": traced, "predicted": predicted},
        "step_timer": {**timed, "phase_samples_per_sec": steps_per_sec * TRAIN_BATCH},
        "tensorboard": board,
    }


def observe_phase(device) -> dict:
    """The bench.py-width SasRec(use_flash=True) trainer with CEFused through
    fit(scan_chunk=32) four times from the same weights and batches: plain,
    health at cadence 33, tracing, and every observability argument at once
    (health, tracer, a profile window, the metrics exporter scraped from a
    thread, a planted SLO rule, the flight ring). Checks the observed fit's
    losses bitwise against the plain one, the window's traced K4 and K1–K3
    against their counted launches and their scopes (encoder, loss), goodput
    sums, one SLO violation, the scrapes and the ring; prints the step's MFU,
    each program's and each serving bucket's roofline, the per-scope device
    time and the overheads; then the profiling API (``profiling_api_checks``:
    ``utils.profiling.trace``, ``StepTimer``, ``TensorBoardLogger``)."""
    import tempfile

    from replay_tpu_torch.data import FeatureHint, FeatureType
    from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema
    from replay_tpu_torch.nn.compiled import CompiledInference
    from replay_tpu_torch.nn.loss import CEFused
    from replay_tpu_torch.nn.sequential.sasrec import SasRec
    from replay_tpu_torch.nn.train import OptimizerFactory, Trainer
    from replay_tpu_torch.obs import HealthConfig, SLORule, mfu, read_flight
    from replay_tpu_torch.ops import fused_ce as fc
    from replay_tpu_torch.ops.flash_attention import flash_attention

    started = time.perf_counter()
    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
            cardinality=NUM_ITEMS, embedding_dim=EMBEDDING_DIM,
        )
    )
    width = dict(
        embedding_dim=EMBEDDING_DIM, num_blocks=NUM_BLOCKS, num_heads=NUM_HEADS,
        max_sequence_length=SEQ_LEN, dropout_rate=0.0, device=device,
    )
    batches = [next_item_batch(TRAIN_BATCH, SEQ_LEN, seed) for seed in range(100, 100 + OBSERVE_BATCHES)]
    counters = (fc.fused_lse_forward, fc.fused_lse_dh, fc.fused_lse_dw, flash_attention)

    def refit(trainer, state, **observability):
        """One fit over the batches; its wall time, steady steps/s and losses."""
        sink = FitEventRecorder()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = trainer.fit(batches, state=state, scan_chunk=SCAN_K, loggers=[sink], log_every=0, **observability)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        losses = [e.payload["loss"] for e in sink.named("on_train_step")]
        telemetry = sink.named("on_fit_end")[0].payload["telemetry"]
        return state, sink, {"wall_s": wall, "steps_per_sec": telemetry["steps_per_sec"], "losses": losses}

    def fit(health=None, **observability):
        """A new trainer from the seed's weights, fitted twice: the first fit
        (its graph captured, its first eager step) for the checks, the second
        (the same trainer and state, nothing built) for the times."""
        model = SasRec(schema, use_flash=True, generator=torch.Generator().manual_seed(SEED), **width)
        trainer = Trainer(
            model, CEFused(), optimizer=OptimizerFactory(name="adam", learning_rate=1e-3), device=device, health=health
        )
        state, sink, first = refit(trainer, trainer.init_state(batches[0]), **observability)
        checked = {"state": state.flat_params.clone(), "losses": first["losses"]}
        _, _, warm = refit(trainer, state, **observability)
        return trainer, checked, sink, {"first_wall_s": first["wall_s"], "wall_s": warm["wall_s"], "steps_per_sec": warm["steps_per_sec"]}

    plain_trainer, plain, _, plain_times = fit()
    _, with_health, _, health_times = fit(health=HealthConfig(cadence=OBSERVE_CADENCE))
    _, _, traced_sink, tracer_times = fit(tracer=True)

    root = tempfile.mkdtemp(prefix="observe-")
    stop, scrapes = threading.Event(), []
    rule = SLORule(metric="replay_train_step", op=">=", threshold=OBSERVE_SLO_STEP, name="planted")
    model = SasRec(schema, use_flash=True, generator=torch.Generator().manual_seed(SEED), **width)
    trainer = Trainer(
        model, CEFused(), optimizer=OptimizerFactory(name="adam", learning_rate=1e-3), device=device,
        health=HealthConfig(cadence=OBSERVE_CADENCE),
    )
    state = trainer.init_state(batches[0])
    sink = FitEventRecorder()
    scraper = threading.Thread(target=scrape_while, args=(trainer, stop, scrapes), daemon=True)
    scraper.start()
    # the main path: counts start at 0 here and are read right after the fit
    reset_counts(*counters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        state = trainer.fit(
            batches, state=state, scan_chunk=SCAN_K, loggers=[sink], log_every=0, tracer=True,
            trace_path=f"{root}/trace.json", profile_steps=OBSERVE_WINDOW, profile_dir=f"{root}/profile",
            metrics_port=0, slo_rules=[rule], flight_path=f"{root}/flight.ring",
        )
        torch.cuda.synchronize()
    finally:
        stop.set()
        scraper.join(timeout=10)
    observed_wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    end = sink.named("on_fit_end")[0].payload
    observed_losses = [e.payload["loss"] for e in sink.named("on_train_step")]

    # the observed fit trains exactly as the plain one: losses and weights bit for bit
    failures = []
    if observed_losses != plain["losses"] or with_health["losses"] != plain["losses"] or len(plain["losses"]) != OBSERVE_BATCHES:
        failures.append(f"losses differ: observed/health/plain {len(observed_losses)}/{len(with_health['losses'])}/{len(plain['losses'])}")
    if not (torch.equal(state.flat_params, plain["state"]) and torch.equal(with_health["state"], plain["state"])):
        failures.append("weights differ from the plain fit")
    # the window: each kernel's traced count is its counted launches, K4 all in
    # encoder, K1–K3 all in loss, the replays matched their traced warm-up
    device_time = end.get("device_time", {})
    traced = {name: device_time.get("kernels", {}).get(name, {}).get("count") for name in launches}
    counted = {name: device_time.get("launches", {}).get(name) for name in launches}
    want_window = {"flash_attention": NUM_BLOCKS * 33, "fused_lse_forward": 33, "fused_lse_dh": 33, "fused_lse_dw": 33}
    if traced != counted or counted != want_window:
        failures.append(f"window kernels traced {traced}, counted {counted}, expected {want_window}")
    scopes = {name: device_time.get("kernels", {}).get(name, {}).get("scopes") for name in launches}
    want_scopes = {
        name: {"encoder" if name == "flash_attention" else "loss": want_window[name]} for name in want_window
    }
    if scopes != want_scopes or "train_scan" not in device_time.get("modules", {}):
        failures.append(
            f"kernel scopes {scopes}, modules {device_time.get('modules')}, "
            f"replays unmatched {device_time.get('unmatched_replays')}"
        )
    attributed = device_time.get("attributed_seconds", 0.0) + device_time.get("unattributed_seconds", 0.0)
    if abs(attributed - device_time.get("total_device_seconds", -1.0)) > 1e-9:
        failures.append(f"attributed + unattributed {attributed} != total {device_time.get('total_device_seconds')}")
    sums = goodput_sums(sink.events) + goodput_sums(traced_sink.events)
    if not sums or max(abs(s - 1.0) for s in sums) > GOODPUT_SUM_TOL:
        failures.append(f"goodput fractions sum to {sums}")
    violations = sink.named("on_slo_violation")
    if len(violations) != 1 or violations[0].payload.get("rule") != "planted":
        failures.append(f"SLO violations {[e.payload for e in violations]}")
    live = [s for s in scrapes if "replay_train_loss" in s["metrics"]]
    if not live or "__identity__" not in live[-1]["snapshot"]:
        failures.append(f"scrapes: {len(scrapes)}, with the train loss {len(live)}")
    flight = read_flight(f"{root}/flight.ring")
    flight_events = [r.get("event") for r in flight.records]
    if "on_fit_end" not in flight_events or flight.torn_tail:
        failures.append(f"flight ring: {len(flight.records)} records, torn {flight.torn_tail}")
    health_record = trainer.last_health or {}
    if set(health_record) < {"grad_norm", "update_ratio", "activations", "logits", "grad_norm_global"}:
        failures.append(f"health record keys {sorted(health_record)}")
    if "attention_entropy" in health_record:  # K4 never builds the weights
        failures.append("attention_entropy on the K4 route")
    roofline = end.get("roofline", {})
    if set(roofline) != {"train_step", "train_scan"} or any(r.get("roofline") is None for r in roofline.values()):
        failures.append(f"roofline programs {sorted(roofline)}")
    compiled = end.get("compile", {})
    if compiled.get("train_scan", {}).get("traces") != 1 or compiled.get("train_step", {}).get("traces") != 1:
        failures.append(f"compile report {compiled}")
    if failures:
        emit(
            "observe", failed=failures, launches=launches, device_time=device_time, compile=compiled,
            roofline=roofline, overhead={"plain": plain_times, "health": health_times, "tracer": tracer_times},
        )
        raise AssertionError("observe: " + "; ".join(failures))

    # MFU of a training step: the K-step program's counted FLOPs a step over
    # the plain fit's steady step time, against each of the card's peaks
    flops_per_step = roofline["train_scan"]["flops"] / SCAN_K
    tflops = flops_per_step * plain_times["steps_per_sec"] / 1e12
    kind = torch.cuda.get_device_name(0)
    step_mfu = {precision: mfu(tflops, kind, precision=precision) for precision in ("bf16", "tf32", "f32")}
    # the serving buckets' rooflines at the bench_serve.py width
    serving = CompiledInference.compile(
        plain_trainer.model, dict(plain_trainer.model.named_parameters()), SEQ_LEN, mode="dynamic_batch_size",
        dynamic_buckets=BATCH_BUCKETS, device=device,
    )
    buckets = serving.roofline()
    serving.close()
    if set(buckets) != set(BATCH_BUCKETS) or any(r.get("roofline") is None for r in buckets.values()):
        raise AssertionError(f"serving rooflines for buckets {sorted(buckets)}")

    def brief(record):
        rl = record["roofline"]
        return {
            "flops": record["flops"], "bytes_accessed": record["bytes_accessed"], "bound": rl["bound"],
            "intensity": rl["arithmetic_intensity"], "ceiling_tflops": rl["ceiling_tflops"],
            "min_step_ms": rl["min_step_seconds"] * 1e3, "hbm_peak_bytes": record.get("hbm_peak_bytes"),
        }

    def make_trainer():
        model = SasRec(schema, use_flash=True, generator=torch.Generator().manual_seed(SEED), **width)
        return Trainer(model, CEFused(), optimizer=OptimizerFactory(name="adam", learning_rate=1e-3), device=device)

    api = profiling_api_checks(make_trainer, batches, counters, plain_times["steps_per_sec"])
    overhead = {
        "plain": plain_times, "health": health_times, "tracer": tracer_times, "observed_wall_s": observed_wall,
        "health_wall_ratio": health_times["wall_s"] / plain_times["wall_s"],
        "tracer_wall_ratio": tracer_times["wall_s"] / plain_times["wall_s"],
    }
    emit(
        "observe", batches=OBSERVE_BATCHES, scan_chunk=SCAN_K, cadence=OBSERVE_CADENCE, window=list(OBSERVE_WINDOW),
        launches=launches, window_kernels=traced, window_scopes=scopes,
        device_time={k: device_time[k] for k in ("total_device_seconds", "attributed_seconds", "unattributed_seconds", "modules", "scopes")},
        flops_per_step=flops_per_step, tflops_per_sec=tflops, mfu=step_mfu,
        roofline={name: brief(r) for name, r in roofline.items()},
        serving_roofline={size: brief(r) for size, r in buckets.items()},
        goodput=end["goodput"], spans=end["spans"], compile=compiled, overhead=overhead,
        slo_violations=len(violations), scrapes=len(scrapes), flight_records=len(flight.records),
        health={k: health_record[k] for k in ("grad_norm_global", "logits", "embedding_coverage") if k in health_record},
        profiling_api=api, seconds=time.perf_counter() - started,
    )
    return launches


def pinned_top10(got: torch.Tensor, want: torch.Tensor, tol: float) -> int:
    """Ranks of the top 10 whose score is clear of both neighbours by more than
    ``tol`` must hold the same id in ``got`` and ``want``; returns how many were
    checked and raises on a difference."""
    want_scores, want_ids = torch.topk(want, 11, dim=-1)
    got_ids = torch.topk(got, 10, dim=-1).indices
    gaps = want_scores[:, :-1] - want_scores[:, 1:]
    previous = torch.cat([torch.full_like(gaps[:, :1], math.inf), gaps[:, :9]], dim=1)
    pinned = torch.minimum(previous, gaps[:, :10]) > tol
    if not torch.equal(got_ids[pinned], want_ids[:, :10][pinned]):
        raise AssertionError(f"top-10 differs at pinned ranks: {got_ids.tolist()} vs {want_ids[:, :10].tolist()}")
    return int(pinned.sum().item())


@contextlib.contextmanager
def k5_forward(forward):
    """Run K5's autograd Function with ``forward`` in place of its forward
    (the Function looks ``_forward`` up at call time); its backward stays. For
    the comparisons only: nothing on the main path runs under it."""
    from replay_tpu_torch.ops import flash_tiled

    saved = flash_tiled._forward
    flash_tiled._forward = forward
    try:
        yield
    finally:
        flash_tiled._forward = saved


def k5_plain(q, k, v, bias, causal):
    """K5's plain version, in the inputs' dtype."""
    from replay_tpu_torch.ops.flash_tiled import flash_attention_tiled_reference

    return flash_attention_tiled_reference(q, k, v, bias, causal)


def k5_scale_fault(q, k, v, bias, causal):
    """A faulty K5, for the controls: the plain version with its softmax scale
    off by ``SCALE_FAULT``."""
    from replay_tpu_torch.ops.flash_tiled import flash_attention_tiled_reference

    out, lse = flash_attention_tiled_reference(q.float() * SCALE_FAULT, k.float(), v.float(), bias, causal)
    return out.to(q.dtype), lse


def k5_bf16_scores_fault(q, k, v, bias, causal):
    """A faulty K5, for the controls: the plain version with its scores
    rounded to bf16 before the softmax, as the unfused route computes them."""
    from replay_tpu_torch.ops.flash_tiled import NEG_INF

    scale = 1.0 / math.sqrt(q.shape[-1])
    s = (torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale).to(torch.bfloat16).float()
    s = s + bias.float()[:, None, None, :]
    if causal:
        positions = torch.arange(q.shape[2], device=q.device)
        s = s.masked_fill(positions[None, :] > positions[:, None], NEG_INF)
    row_max = s.amax(dim=-1, keepdim=True)
    probs = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - row_max))
    denom = probs.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float()) / denom
    lse = torch.where(row_max <= NEG_INF / 2, NEG_INF, row_max + torch.log(denom))[..., 0]
    return out.to(q.dtype), lse


def k5_tf32_fault(q, k, v, bias, causal):
    """A faulty K5, for the controls: the plain version with its two products
    on cuBLAS's TF32 path, one TF32 product per f32 product — the precision
    that the tf32x3 variant's hi + lo splits keep above."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return k5_plain(q, k, v, bias, causal)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


# the comparisons of the long-sequence phase: (name, K5's forward or None for
# the unfused route, is it a control)
LONGSEQ_COMPARISONS = (
    ("unfused", None, False),
    ("k5_plain", k5_plain, False),
    ("scale_fault", k5_scale_fault, True),
    ("bf16_scores_fault", k5_bf16_scores_fault, True),
)
FAULTS = tuple(name for name, _, control in LONGSEQ_COMPARISONS if control)
# the f32-compute forward's comparisons add a third control: one TF32 product
# per f32 product (in bf16 compute, where q, k, v are exact in TF32, it would
# test little)
F32_COMPARISONS = LONGSEQ_COMPARISONS + (("tf32_products_fault", k5_tf32_fault, True),)
F32_FAULTS = tuple(name for name, _, control in F32_COMPARISONS if control)


def check_readings(kind: str, readings: dict, limit: float, sound, caught) -> None:
    """The comparisons in ``sound`` within ``limit``, the controls in ``caught`` outside it."""
    for name in sound:
        if readings[name] > limit:
            raise AssertionError(f"longseq {kind}: the tiled route differs from {name} by {readings[name]} > {limit}")
    for name in caught:
        if readings[name] <= limit:
            raise AssertionError(f"longseq {kind}: control {name} ({readings[name]}) passes the limit {limit}")


def longseq_setup(device):
    """The long-sequence width's schema, model widths, optimizer, the tiled
    model from seed ``SEED``, a copy of its initial weights, the bf16 tiled
    trainer on it and the bf16 unfused one (both ``CEFused``)."""
    from replay_tpu_torch.data import FeatureHint, FeatureType
    from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema
    from replay_tpu_torch.nn.loss import CEFused
    from replay_tpu_torch.nn.sequential.sasrec import SasRec
    from replay_tpu_torch.nn.train import OptimizerFactory, Trainer

    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
            cardinality=NUM_ITEMS, embedding_dim=LONG_DIM,
        )
    )
    width = dict(
        embedding_dim=LONG_DIM, num_blocks=LONG_BLOCKS, num_heads=LONG_HEADS,
        max_sequence_length=LONG_LEN, dropout_rate=0.0, device=device,
    )
    optimizer = OptimizerFactory(name="adam", learning_rate=1e-3)
    tiled_model = SasRec(schema, use_flash="tiled", generator=torch.Generator().manual_seed(SEED), **width)
    initial = {name: value.detach().clone() for name, value in tiled_model.state_dict().items()}
    tiled = Trainer(tiled_model, CEFused(), optimizer=optimizer, precision="bf16", device=device)
    plain = Trainer(SasRec(schema, use_flash=False, **width), CEFused(), optimizer=optimizer, precision="bf16", device=device)
    if tiled.model.dtype != torch.bfloat16 or plain.model.dtype != torch.bfloat16:
        raise AssertionError("precision='bf16' did not reach the models")
    return schema, width, optimizer, tiled_model, initial, tiled, plain


def trained_losses(trainer, batch, initial, forward=None):
    """``LONG_STEPS`` steps from ``initial`` on ``batch``, K5's forward
    swapped for ``forward`` where given: the state after them and the losses."""
    state = trainer.init_state(batch, params=initial)
    values = []
    with k5_forward(forward) if forward is not None else contextlib.nullcontext():
        for _ in range(LONG_STEPS):
            state, loss = trainer.train_step(state, batch)
            values.append(loss)
    torch.cuda.synchronize()
    return state, [float(x) for x in values]


def longseq_phase(device) -> dict:
    """The long-sequence path at the sasrec_l1024_tiled width, bf16 compute:
    training on K5 (and K1–K3), then serving on K5; each against the unfused
    attention route and against K5's plain version in the same model, with two
    faulty K5s as controls."""
    from replay_tpu_torch.nn.loss import CE, CEFused
    from replay_tpu_torch.nn.sequential.sasrec import SasRec
    from replay_tpu_torch.nn.train import Trainer
    from replay_tpu_torch.ops import fused_ce as fc
    from replay_tpu_torch.ops.flash_attention import flash_attention
    from replay_tpu_torch.ops.flash_tiled import flash_attention_tiled
    from replay_tpu_torch.serve import ScoringEngine, make_window

    schema, width, optimizer, tiled_model, initial, tiled, plain = longseq_setup(device)
    batch = next_item_batch(LONG_BATCH, LONG_LEN)
    counters = (flash_attention_tiled, fc.fused_lse_forward, fc.fused_lse_dh, fc.fused_lse_dw, flash_attention)

    def losses(trainer, forward=None):
        return trained_losses(trainer, batch, initial, forward)

    # the main path: counts start at 0 here and are read right after its steps
    reset_counts(*counters)
    tiled_state, tiled_losses = losses(tiled)
    train_launches = {fn.__name__: fn.launches for fn in counters}
    train_variants, train_fused_variants = variant_counts(flash_attention_tiled), fused_variant_counts(fc)
    expected = {
        "flash_attention_tiled": LONG_BLOCKS * LONG_STEPS, "fused_lse_forward": LONG_STEPS,
        "fused_lse_dh": LONG_STEPS, "fused_lse_dw": LONG_STEPS, "flash_attention": 0,
    }
    if train_launches != expected:
        raise AssertionError(f"longseq launches {train_launches}, expected {expected}")
    if train_variants != {"mma": expected["flash_attention_tiled"], "tf32x3": 0, "simt": 0}:
        raise AssertionError(f"bf16 training ran K5's variants {train_variants}, not mma only")
    check_fused_variants("bf16 training", train_fused_variants, LONG_STEPS)
    if not tiled_losses[-1] < tiled_losses[0] or int(tiled_state.bad_steps):
        raise AssertionError(f"longseq loss did not fall or steps were skipped: {tiled_losses}")
    if tiled_state.flat_params.dtype != torch.float32:
        raise AssertionError(f"master parameters are {tiled_state.flat_params.dtype}, not float32")

    # the comparisons, from the same weights; none of them launches K4 or K5
    other_losses, loss_err, plain_state = {}, {}, None
    for name, forward, _ in LONGSEQ_COMPARISONS:
        state, other_losses[name] = losses(plain if forward is None else tiled, forward)
        if not all(math.isfinite(x) for x in other_losses[name]) or int(state.bad_steps):
            raise AssertionError(f"longseq {name}: non-finite losses or skipped steps {other_losses[name]}")
        loss_err[name] = max(abs(a - b) / abs(b) for a, b in zip(tiled_losses, other_losses[name]))
        if forward is None:
            plain_state = state
    if flash_attention_tiled.launches != expected["flash_attention_tiled"] or flash_attention.launches:
        raise AssertionError("a comparison run launched K4 or K5")
    emit("longseq_check", part="train", loss_rel_err=loss_err, limit=LONGSEQ_LOSS_RTOL)
    check_readings("train losses", loss_err, LONGSEQ_LOSS_RTOL, ("unfused", "k5_plain"), ("scale_fault",))

    # the tiled model in f32 compute, from the same weights, on the training batch
    ids = {"item_id": torch.as_tensor(batch["feature_tensors"]["item_id"], device=device)}
    real = torch.as_tensor(batch["padding_mask"], device=device)
    unfused_f32 = tiled_model.clone(use_flash=False).to(device)
    f32_err = {}
    with torch.no_grad():
        # a path of its own: the f32-compute forward, on K5's tf32x3 variant, counted from 0
        reset_counts(flash_attention_tiled)
        hidden = tiled_model(ids, real)
        torch.cuda.synchronize()
        f32_launches, f32_variants = flash_attention_tiled.launches, variant_counts(flash_attention_tiled)
        if f32_variants != {"mma": 0, "tf32x3": LONG_BLOCKS, "simt": 0} or f32_launches != LONG_BLOCKS:
            raise AssertionError(f"the f32 forward ran K5's variants {f32_variants}, not tf32x3 once a block")
        for name, forward, _ in F32_COMPARISONS:
            if forward is None:
                other = unfused_f32(ids, real)
            else:
                with k5_forward(forward):
                    other = tiled_model(ids, real)
            f32_err[name] = (hidden - other).abs().max().item()
    if flash_attention_tiled.launches != f32_launches:
        raise AssertionError("a comparison of the f32 forward launched K5")
    emit("longseq_check", part="f32_hidden", max_abs_err=f32_err, limit=LONGSEQ_F32_TOL)
    check_readings("f32 hidden states", f32_err, LONGSEQ_F32_TOL, ("unfused", "k5_plain"), F32_FAULTS)

    # the f32 trainer, SasRec's default compute, from the same weights: the
    # tiled route on K5 (tf32x3) and K1–K3 (K3 on tf32) against the unfused
    # route with CE, whose logits are plain torch ops, step by step
    f32_tiled = Trainer(tiled_model.clone(), CEFused(), optimizer=optimizer, precision="f32", device=device)
    f32_plain = Trainer(SasRec(schema, use_flash=False, **width), CE(), optimizer=optimizer, precision="f32", device=device)
    if f32_tiled.model.dtype != torch.float32:
        raise AssertionError(f"precision='f32' left the tiled model in {f32_tiled.model.dtype}")
    # the main path: counts start at 0 here and are read right after its steps
    reset_counts(*counters)
    f32_tiled_state, f32_tiled_losses = losses(f32_tiled)
    f32_train_launches = {fn.__name__: fn.launches for fn in counters}
    f32_train_variants, f32_fused_variants = variant_counts(flash_attention_tiled), fused_variant_counts(fc)
    if f32_train_launches != expected:
        raise AssertionError(f"longseq f32 launches {f32_train_launches}, expected {expected}")
    if f32_train_variants != {"mma": 0, "tf32x3": expected["flash_attention_tiled"], "simt": 0}:
        raise AssertionError(f"f32 training ran K5's variants {f32_train_variants}, not tf32x3 only")
    check_fused_variants("f32 training", f32_fused_variants, LONG_STEPS)
    if not f32_tiled_losses[-1] < f32_tiled_losses[0] or int(f32_tiled_state.bad_steps):
        raise AssertionError(f"longseq f32 loss did not fall or steps were skipped: {f32_tiled_losses}")
    f32_plain_state, f32_plain_losses = losses(f32_plain)
    if {fn.__name__: fn.launches for fn in counters} != f32_train_launches:
        raise AssertionError("the unfused f32 trainer launched a kernel")
    if not all(math.isfinite(x) for x in f32_plain_losses) or int(f32_plain_state.bad_steps):
        raise AssertionError(f"longseq f32 unfused: non-finite losses or skipped steps {f32_plain_losses}")
    f32_loss_err = max(abs(a - b) / abs(b) for a, b in zip(f32_tiled_losses, f32_plain_losses))
    emit("longseq_check", part="f32_train", loss_rel_err=f32_loss_err, limit=TRAIN_LOSS_RTOL)
    if f32_loss_err > TRAIN_LOSS_RTOL:
        raise AssertionError(f"longseq f32 losses differ by rtol {f32_loss_err}: {f32_tiled_losses} vs {f32_plain_losses}")

    train_perf = {}
    for name, trainer, state in (
        ("tiled", tiled, tiled_state), ("unfused", plain, plain_state),
        ("f32_tiled", f32_tiled, f32_tiled_state), ("f32_unfused", f32_plain, f32_plain_state),
    ):
        _, train_perf[name] = trainer_perf(
            trainer, state, batch, LONG_TIMED_STEPS, LONG_WARMUP_STEPS, LONG_PROFILED_STEPS, LONG_BATCH * LONG_LEN
        )

    # K steps a dispatch on the bf16 tiled trainer: train_steps and
    # fit(scan_chunk) over two chunks and a tail, against its per-step path
    batches = [next_item_batch(LONG_BATCH, LONG_LEN, seed) for seed in range(1, LONG_SCAN_BATCHES + 1)]
    per_step = {
        "flash_attention_tiled": LONG_BLOCKS, "fused_lse_forward": 1, "fused_lse_dh": 1, "fused_lse_dw": 1,
        "flash_attention": 0,
    }
    chunked = chunk_checks(tiled, initial, batches, LONG_SCAN_K, counters, per_step, LONG_BATCH * LONG_LEN)
    graph_steps = LONG_SCAN_K + chunked["capture_warmup_steps"]
    if chunked["variants"]["flash_attention_tiled"] != {"mma": LONG_BLOCKS * graph_steps, "tf32x3": 0, "simt": 0}:
        raise AssertionError(f"bf16 training on a graph ran K5's variants {chunked['variants']}, not mma only")
    check_fused_variants(
        "bf16 training on a graph", {k: v for k, v in chunked["variants"].items() if k.startswith("fused")}, graph_steps
    )

    # serving: the tiled bf16 model behind ScoringEngine; the comparisons run
    # on engines of their own, so that the main engine's encodes are its own
    served = SasRec(schema, use_flash="tiled", dtype=torch.bfloat16, generator=torch.Generator().manual_seed(SEED), **width)
    unfused_served = SasRec(schema, use_flash=False, dtype=torch.bfloat16, **width)
    params = served.state_dict()
    other = SasRec(
        schema, use_flash="tiled", dtype=torch.bfloat16, generator=torch.Generator().manual_seed(SEED + 1), **width
    ).state_dict()
    buckets = dict(length_buckets=LONG_LENGTH_BUCKETS, batch_buckets=LONG_BATCH_BUCKETS, device=device)
    engine = ScoringEngine(served, params, **buckets)
    check_engine = ScoringEngine(served, params, **buckets)
    unfused = ScoringEngine(unfused_served, params, **buckets)
    rng = np.random.default_rng(SEED + 1)
    # users' histories, their lengths drawn as bench_serve.py:1057 draws them
    requests = [list(rng.integers(0, NUM_ITEMS, int(n))) for n in rng.integers(1, 2 * LONG_LEN, 80)]
    by_length = {}
    for history in requests:
        window, mask, length = make_window(history, LONG_LEN)
        lb = engine.route_length(length)
        by_length.setdefault(lb, []).append((window[LONG_LEN - lb :], mask[LONG_LEN - lb :]))

    # the main path: counts start at 0 here and are read at the end of the serving part
    reset_counts(flash_attention_tiled)
    serve_max = {name: 0.0 for name, _, _ in LONGSEQ_COMPARISONS}
    serve_sum, logit_count, top_checked = {name: 0.0 for name in serve_max}, 0, 0
    for lb, rows in sorted(by_length.items()):
        start = 0
        for fill in (1, 5, 8, 32, 20):
            chunk = rows[start : start + fill]
            start += len(chunk)
            if not chunk:
                break
            ids = np.stack([r[0] for r in chunk])
            mask = np.stack([r[1] for r in chunk])
            logits, hidden = engine.encode(lb, ids, mask)
            if logits.shape != (len(chunk), NUM_ITEMS) or hidden.shape != (len(chunk), LONG_DIM):
                raise AssertionError(f"longseq encode L={lb}: shapes {tuple(logits.shape)} {tuple(hidden.shape)}")
            if logits.dtype != torch.float32 or hidden.dtype != torch.bfloat16:
                raise AssertionError(f"longseq encode L={lb}: dtypes {logits.dtype} {hidden.dtype}")
            if not (torch.isfinite(logits).all() and torch.isfinite(hidden.float()).all()):
                raise AssertionError(f"longseq encode L={lb}: non-finite output")
            logit_count += logits.numel()
            for name, forward, _ in LONGSEQ_COMPARISONS:
                if forward is None:
                    want, _ = unfused.encode(lb, ids, mask)
                else:  # the eager program: a graph replay would not see the swap
                    with k5_forward(forward):
                        want, _ = eager_encode(check_engine, lb, ids, mask)
                diff = (logits - want).abs()
                serve_max[name] = max(serve_max[name], diff.max().item())
                serve_sum[name] += diff.sum().item()
                if name == "unfused":
                    top_checked += pinned_top10(logits, want, LONGSEQ_SERVE_MAX_TOL)
    serve_mean = {name: total / logit_count for name, total in serve_sum.items()}
    emit(
        "longseq_check", part="serve", logits_mean_abs_err=serve_mean, mean_limit=LONGSEQ_SERVE_MEAN_TOL,
        logits_max_abs_err=serve_max, max_limit=LONGSEQ_SERVE_MAX_TOL,
    )
    check_readings("serving logits, mean", serve_mean, LONGSEQ_SERVE_MEAN_TOL, ("k5_plain",), FAULTS)
    check_readings("serving logits, largest", serve_max, LONGSEQ_SERVE_MAX_TOL, ("unfused",), ())

    latency, inputs = {}, {}
    for lb in LONG_LENGTH_BUCKETS:
        for bucket in LONG_BATCH_BUCKETS:
            windows = [make_window(requests[i % len(requests)], lb) for i in range(bucket)]
            ids = np.stack([w[0] for w in windows])
            mask = np.stack([w[1] for w in windows])
            inputs[lb, bucket] = ids, mask
            record = {
                **encode_latency(lambda: engine.encode(lb, ids, mask), 30, 5),
                **device_time_per_encode(engine, lb, ids, mask, flash_attention_tiled, LONG_BLOCKS, calls=10),
            }
            record["device_busy_share"] = record["device_ms"] / record["p50_ms"]
            latency[f"L={lb},B={bucket}"] = record
    serve_launches = flash_attention_tiled.launches
    serve_variants = variant_counts(flash_attention_tiled)
    encode_calls = engine.stats()["encode_calls"]
    replays = engine.graph_counts()["encode"]["replays"]
    if serve_launches != LONG_BLOCKS * encode_calls or replays != encode_calls:
        raise AssertionError(
            f"K5 serving launches {serve_launches} != {LONG_BLOCKS} x {encode_calls} encode calls, or {replays} replays"
        )
    if serve_variants != {"mma": serve_launches, "tf32x3": 0, "simt": 0}:
        raise AssertionError(f"bf16 serving ran K5's variants {serve_variants}, not mma only")
    # the graphs against the eager bound program (comparisons, after the count)
    contract = graph_contract(engine, other, requests, LONG_LEN)
    for lb, bucket in inputs:
        ids, mask = inputs[lb, bucket]

        def eager():
            eager_encode(engine, lb, ids, mask)
            torch.cuda.synchronize()

        latency[f"L={lb},B={bucket}"]["eager"] = encode_latency(eager, 30, 5)
    for e in (engine, check_engine, unfused):
        e.close()
    emit(
        "longseq", batch=LONG_BATCH, seq_len=LONG_LEN, items=NUM_ITEMS, embedding_dim=LONG_DIM,
        blocks=LONG_BLOCKS, heads=LONG_HEADS, precision=tiled.precision.describe(), steps=LONG_STEPS,
        train_launches=train_launches, train_k5_variants=train_variants, train_fused_ce_variants=train_fused_variants,
        f32_forward_k5_variants=f32_variants,
        tiled_losses=tiled_losses, other_losses=other_losses,
        loss_rel_err=loss_err, loss_limit=LONGSEQ_LOSS_RTOL, f32_hidden_max_abs_err=f32_err,
        f32_limit=LONGSEQ_F32_TOL,
        f32_train_launches=f32_train_launches, f32_train_k5_variants=f32_train_variants,
        f32_train_fused_ce_variants=f32_fused_variants, f32_tiled_losses=f32_tiled_losses,
        f32_unfused_losses=f32_plain_losses, f32_loss_rel_err=f32_loss_err, f32_loss_limit=TRAIN_LOSS_RTOL,
        train_perf=train_perf,
        serve_requests=len(requests), serve_encode_calls=encode_calls, serve_k5_launches=serve_launches,
        serve_k5_variants=serve_variants,
        serve_logits_mean_abs_err=serve_mean, serve_mean_limit=LONGSEQ_SERVE_MEAN_TOL,
        serve_logits_max_abs_err=serve_max, serve_max_limit=LONGSEQ_SERVE_MAX_TOL, top10_ranks_checked=top_checked,
        serve_stats=engine.stats(), serve_latency_ms=latency, serve_replays=replays,
        serve_graphs=engine.graph_counts(), serve_graph_contract=contract, chunked=chunked,
    )
    return {
        "train": train_launches, "serve": serve_launches, "f32": f32_launches, "f32_train": f32_train_launches,
        "graph": chunked["launches"],
    }


def model_schema(dim: int):
    """The item-id schema of bench_suite.py's ``item_schema`` at ``dim``."""
    from replay_tpu_torch.data import FeatureHint, FeatureType
    from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema

    return TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
            cardinality=MODEL_ITEMS, embedding_dim=dim,
        )
    )


def mlm_batches(schema, count: int) -> list:
    """Masked-LM batches as bench_suite.py's ``run_bert4rec`` builds them
    (full windows of L=100 from default_rng(seed), the port's
    ``make_default_bert4rec_transforms(mask_prob=0.2)``), seeds 0 .. count-1."""
    from replay_tpu_torch.nn.transform import Compose, make_default_bert4rec_transforms

    pipeline = Compose(make_default_bert4rec_transforms(schema, mask_prob=B4R_MASK_PROB)["train"])
    batches = []
    for seed in range(count):
        items = np.random.default_rng(seed).integers(0, MODEL_ITEMS, (MODEL_BATCH, B4R_LEN)).astype(np.int32)
        raw = {"item_id": items, "item_id_mask": np.ones_like(items, bool)}
        batches.append(pipeline(raw, torch.Generator().manual_seed(seed)))
    return batches


def in_batch_batches(schema, count: int) -> list:
    """In-batch-negative batches as bench_suite.py's ``run_twotower`` builds
    them (full windows of L+1 from default_rng(seed), the port's
    ``make_default_twotower_transforms``: a pool of 512 negatives a batch)."""
    from replay_tpu_torch.nn.transform import Compose, make_default_twotower_transforms

    pipeline = Compose(make_default_twotower_transforms(schema)["train"])
    batches = []
    for seed in range(count):
        items = np.random.default_rng(seed).integers(0, MODEL_ITEMS, (MODEL_BATCH, TT_LEN + 1)).astype(np.int32)
        batches.append(pipeline({"item_id": items, "item_id_mask": np.ones_like(items, bool)}))
    return batches


def model_histories(rng, count: int):
    """Users' histories of 1–100 items of the 27,278-item catalog."""
    return [list(rng.integers(0, MODEL_ITEMS, int(rng.integers(1, 101)))) for _ in range(count)]


def release() -> None:
    """Return to the card what the parts before dropped (their graphs' pools
    too), so that the next part's memory readings are its own."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def model_training(label, make_model, make_loss, batches, blocks, length, dtype, device) -> dict:
    """One trainer at ``dtype`` compute on K4 (``make_model(use_flash=True)``):
    ``MODEL_STEPS`` steps from the model's initial weights (the main path: K4's
    count starts at 0 there and is read right after, once a block a step);
    in f32, the same steps on the unfused route from the same weights, losses
    within ``TRAIN_LOSS_RTOL``; step times, device time and memory
    (``trainer_perf``); then ``train_steps`` at K = ``MODEL_SCAN_K`` and
    ``fit(scan_chunk=K)`` bitwise against the per-step path (``chunk_checks``)."""
    from replay_tpu_torch.nn.train import OptimizerFactory, Trainer
    from replay_tpu_torch.ops.flash_attention import flash_attention

    optimizer = OptimizerFactory(name="adam", learning_rate=1e-3)
    precision = "bf16" if dtype == torch.bfloat16 else None
    model = make_model(use_flash=True)
    initial = {name: value.detach().clone() for name, value in model.state_dict().items()}
    trainer = Trainer(model, make_loss(), optimizer=optimizer, precision=precision, device=device)
    if trainer.model.dtype != dtype:
        raise AssertionError(f"{label}: the trainer's model computes in {trainer.model.dtype}, not {dtype}")
    tokens = MODEL_BATCH * length

    reset_counts(flash_attention)
    state = trainer.init_state(batches[0], params=initial)
    losses = [trainer.train_step(state, batch)[1] for batch in batches[:MODEL_STEPS]]
    torch.cuda.synchronize()
    launches = flash_attention.launches
    losses = [float(x) for x in losses]
    if launches != blocks * MODEL_STEPS or not all(math.isfinite(x) for x in losses) or int(state.bad_steps):
        raise AssertionError(f"{label}: K4 launches {launches} (expected {blocks * MODEL_STEPS}), losses {losses}")
    record = {"dtype": str(dtype).removeprefix("torch."), "losses": losses, "k4_launches": launches,
              "k4_launches_per_step": launches / MODEL_STEPS}
    if dtype == torch.float32:
        plain = Trainer(make_model(use_flash=False), make_loss(), optimizer=optimizer, device=device)
        plain_state = plain.init_state(batches[0], params=initial)
        plain_losses = [float(plain.train_step(plain_state, batch)[1]) for batch in batches[:MODEL_STEPS]]
        if flash_attention.launches != launches:
            raise AssertionError(f"{label}: the unfused trainer launched K4 {flash_attention.launches - launches} times")
        err = max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses))
        record.update(unfused_losses=plain_losses, loss_max_rtol_vs_unfused=err, loss_tol=TRAIN_LOSS_RTOL)
        del plain, plain_state
        release()
        if err > TRAIN_LOSS_RTOL:
            raise AssertionError(f"{label}: K4 route vs unfused losses differ by rtol {err}: {losses} vs {plain_losses}")
    _, record["perf"] = trainer_perf(
        trainer, state, batches[0], MODEL_TIMED_STEPS, MODEL_WARMUP_STEPS, MODEL_PROFILED_STEPS, tokens
    )
    record["chunked"] = chunk_checks(
        trainer, initial, batches, MODEL_SCAN_K, (flash_attention,), {"flash_attention": blocks}, tokens
    )
    del trainer, state, model
    release()
    return record


def traced_calls(call, calls: int, wrapper) -> dict:
    """``calls`` calls of ``call()`` (each synchronising) in a profiler trace:
    device time per call, and the wrapper's kernels in the trace against its
    launches counted over the calls."""
    from torch.autograd import DeviceType

    with profiled_window(call) as prof:
        before = wrapper.launches
        for _ in range(calls):
            call()
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return {
        "device_ms": sum(e.self_device_time_total for e in kernels) / calls / 1e3,
        "launched": wrapper.launches - before,
        "traced": traced_kernels(kernels, [wrapper])[wrapper.__name__],
    }


def model_serving(label, model, other_params, blocks, length, device) -> dict:
    """``CompiledInference`` in the ``"logits"`` mode (``forward_inference``:
    BERT4Rec's left shift and mask slot run inside the captured program), batch
    buckets ``BATCH_BUCKETS``, one CUDA graph each. The main path: encodes at a
    full and a partial fill of every bucket, with the installed and with
    per-call params, their latency and a profiled window; K4's count starts at
    0 and must equal the blocks times the replays, and the trace's K4 kernels
    the count. Then, as comparisons: every output bitwise equal to the eager
    bound program, across a ``swap_params``; within ``SERVE_TOL`` of the
    unfused route's ``forward_inference``; ``serialize`` → ``deserialize``
    bitwise equal to the live instance with K4 in the loaded program's trace;
    and ``ScoringEngine`` (the ``"both"`` definition: the model's forward at
    the last position) under ``graph_contract``."""
    from replay_tpu_torch.nn.compiled import CompiledInference, as_device_tensor, pad_rows
    from replay_tpu_torch.ops.flash_attention import flash_attention
    from replay_tpu_torch.serve import ScoringEngine, make_window

    params = {name: value.detach().clone() for name, value in model.state_dict().items()}
    requests = model_histories(np.random.default_rng(SEED + 5), 80)

    def windows(rows, offset=0):
        made = [make_window(requests[(offset + i) % len(requests)], length) for i in range(rows)]
        return np.stack([w[0] for w in made]), np.stack([w[1] for w in made])

    compiled = CompiledInference.compile(
        model, params, length, mode="dynamic_batch_size", dynamic_buckets=BATCH_BUCKETS, outputs="logits",
        device=device,
    )

    def eager(ids, mask, call_params=None):
        bucket = compiled._bucket_for(len(ids))
        out = compiled._compiled[bucket](
            compiled._params if call_params is None else call_params,
            pad_rows(as_device_tensor(ids, torch.int32, device), bucket),
            pad_rows(as_device_tensor(mask, torch.bool, device), bucket), None,
        )
        return out[: len(ids)]

    # the main path
    reset_counts(flash_attention)
    replays_before = compiled.graphs.replays
    outputs, latency = [], {}
    for bucket in BATCH_BUCKETS:
        for fill in sorted({bucket, max(1, bucket - 3)}):
            ids, mask = windows(fill, bucket)
            outputs.append((ids, mask, None, compiled(ids, mask)))
            outputs.append((ids, mask, other_params, compiled(ids, mask, params=other_params)))
        ids, mask = windows(bucket, 3)

        def encode():
            compiled(ids, mask)
            torch.cuda.synchronize()

        latency[f"B={bucket}"] = {**encode_latency(encode, 50, 5), **traced_calls(encode, 10, flash_attention)}
        latency[f"B={bucket}"]["device_busy_share"] = latency[f"B={bucket}"]["device_ms"] / latency[f"B={bucket}"]["p50_ms"]
    torch.cuda.synchronize()
    launches = flash_attention.launches
    replays = compiled.graphs.replays - replays_before
    if launches != blocks * replays or any(r["traced"] != r["launched"] for r in latency.values()):
        raise AssertionError(f"{label} serve: K4 launches {launches} for {replays} replays; traces {latency}")

    # comparisons: the eager bound program, the unfused route, the serialized form
    compared = 0
    for ids, mask, call_params, got in outputs:
        if got.shape != (len(ids), MODEL_ITEMS) or not torch.isfinite(got).all():
            raise AssertionError(f"{label} serve: {tuple(got.shape)} scores, finite={bool(torch.isfinite(got).all())}")
        if not bitwise_equal(got, eager(ids, mask, call_params)):
            raise AssertionError(f"{label} serve: a replay differs from the eager program at {len(ids)} rows")
        compared += 1
    compiled.swap_params(other_params)
    for ids, mask, call_params, got in outputs[1::2]:
        if not bitwise_equal(compiled(ids, mask), got):
            raise AssertionError(f"{label} serve: after swap_params a replay differs from the per-call params")
        compared += 1
    compiled.swap_params(params)
    plain = model.clone(use_flash=False)
    with torch.no_grad():
        unfused_err = max(
            (got - plain.forward_inference(
                {"item_id": as_device_tensor(ids, torch.int32, device)}, as_device_tensor(mask, torch.bool, device)
            )).abs().max().item()
            for ids, mask, call_params, got in outputs if call_params is None
        )
    if unfused_err > SERVE_TOL:
        raise AssertionError(f"{label} serve: K4 route vs unfused route differ by {unfused_err}")
    payload = compiled.serialize()
    served = CompiledInference.deserialize(payload, device=device)
    if b"replay_tpu_torch.flash_attention_forward" not in payload:
        raise AssertionError(f"{label} serialize: the payload's programs do not hold K4's operator")
    for ids, mask, call_params, got in outputs[::2]:
        if not bitwise_equal(served(ids, mask), got):
            raise AssertionError(f"{label} serialize: the loaded program differs from the live instance")
    ids, mask = windows(max(BATCH_BUCKETS))
    serialized = traced_calls(lambda: served(ids, mask), 1, flash_attention)
    if serialized["launched"] != blocks or serialized["traced"] != blocks:
        raise AssertionError(f"{label} serialize: one call counted {serialized} K4 launches")
    engine = ScoringEngine(model, params, length_buckets=(length,), batch_buckets=BATCH_BUCKETS, device=device)
    contract = graph_contract(engine, other_params, requests, length)
    record = {
        "k4_launches": launches, "replays": replays, "bitwise_compared": compared,
        "max_abs_err_vs_unfused": unfused_err, "tol": SERVE_TOL, "latency_ms": latency,
        "serialized_bytes": len(payload), "engine_graph_contract": contract,
    }
    for item in (engine, compiled, served):
        item.close()
    del engine, compiled, served, plain
    release()
    return record


def bert4rec_tiled(device) -> dict:
    """``Bert4Rec(use_flash="tiled")`` (K5, non-causal) at a smaller depth:
    in f32 compute, the hidden states of a masked-LM batch against the unfused
    route's within ``LONGSEQ_F32_TOL`` (K5's ``tf32x3``); a bf16 trainer
    (K5's ``mma``) taking ``MODEL_STEPS`` steps, K5 launched once a block a
    step, its losses beside the unfused bf16 trainer's from the same weights."""
    from replay_tpu_torch.nn.loss import CE
    from replay_tpu_torch.nn.sequential.bert4rec import Bert4Rec
    from replay_tpu_torch.nn.train import OptimizerFactory, Trainer
    from replay_tpu_torch.ops.flash_tiled import flash_attention_tiled

    schema = model_schema(B4R_TILED_DIM)
    width = dict(
        embedding_dim=B4R_TILED_DIM, num_blocks=B4R_TILED_BLOCKS, num_heads=B4R_TILED_HEADS,
        max_sequence_length=B4R_LEN, dropout_rate=0.0, device=device,
    )
    model = Bert4Rec(schema, use_flash="tiled", generator=torch.Generator().manual_seed(SEED), **width)
    plain = model.clone(use_flash=False)
    initial = {name: value.detach().clone() for name, value in model.state_dict().items()}
    batches = mlm_batches(schema, MODEL_STEPS)
    batch = {key: value.to(device) if isinstance(value, torch.Tensor) else value for key, value in batches[0].items()}
    ids = batch["feature_tensors"]["item_id"].to(device)
    reset_counts(flash_attention_tiled)
    with torch.no_grad():
        hidden = model({"item_id": ids}, batch["padding_mask"], token_mask=batch["token_mask"])
        torch.cuda.synchronize()
        f32_launches = variant_counts(flash_attention_tiled)
        want = plain({"item_id": ids}, batch["padding_mask"], token_mask=batch["token_mask"])
    f32_err = (hidden - want).abs().max().item()
    if f32_launches != {"mma": 0, "tf32x3": B4R_TILED_BLOCKS, "simt": 0} or f32_err > LONGSEQ_F32_TOL:
        raise AssertionError(f"bert4rec tiled f32: K5 {f32_launches}, hidden states vs unfused {f32_err}")

    optimizer = OptimizerFactory(name="adam", learning_rate=1e-3)
    tiled = Trainer(model, CE(), optimizer=optimizer, precision="bf16", device=device)
    reset_counts(flash_attention_tiled)
    state = tiled.init_state(batches[0], params=initial)
    losses = [tiled.train_step(state, b)[1] for b in batches]
    torch.cuda.synchronize()
    launches = variant_counts(flash_attention_tiled)
    losses = [float(x) for x in losses]
    unfused = Trainer(plain, CE(), optimizer=optimizer, precision="bf16", device=device)
    plain_state = unfused.init_state(batches[0], params=initial)
    plain_losses = [float(unfused.train_step(plain_state, b)[1]) for b in batches]
    if launches != {"mma": B4R_TILED_BLOCKS * MODEL_STEPS, "tf32x3": 0, "simt": 0} or not all(
        math.isfinite(x) for x in losses
    ) or int(state.bad_steps):
        raise AssertionError(f"bert4rec tiled bf16 trainer: K5 {launches}, losses {losses}")
    record = {
        "f32_hidden_max_abs_err_vs_unfused": f32_err, "f32_limit": LONGSEQ_F32_TOL, "f32_k5": f32_launches,
        "bf16_k5": launches, "bf16_losses": losses, "bf16_unfused_losses": plain_losses,
        "bf16_loss_max_rtol_vs_unfused": max(abs(a - b) / abs(b) for a, b in zip(losses, plain_losses)),
    }
    del model, plain, tiled, unfused, state, plain_state
    release()
    return record


def bert4rec_phase(device) -> dict:
    """bench_suite.py's bert4rec row on K4 (D=75, bidirectional): the trainer
    in f32 and bf16 compute (``model_training``), the serving programs
    (``model_serving``), then the tiled route at a smaller depth
    (``bert4rec_tiled``)."""
    from replay_tpu_torch.nn.loss import CE
    from replay_tpu_torch.nn.sequential.bert4rec import Bert4Rec

    schema = model_schema(B4R_DIM)
    width = dict(
        embedding_dim=B4R_DIM, num_blocks=B4R_BLOCKS, num_heads=B4R_HEADS, max_sequence_length=B4R_LEN,
        dropout_rate=0.0, device=device,
    )

    def make_model(use_flash, seed=SEED):
        return Bert4Rec(schema, use_flash=use_flash, generator=torch.Generator().manual_seed(seed), **width)

    batches = mlm_batches(schema, MODEL_SCAN_BATCHES)
    training = {
        name: model_training(f"bert4rec {name}", make_model, CE, batches, B4R_BLOCKS, B4R_LEN, dtype, device)
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))
    }
    serving = model_serving(
        "bert4rec", make_model(True), make_model(True, SEED + 1).state_dict(), B4R_BLOCKS, B4R_LEN, device
    )
    tiled = bert4rec_tiled(device)
    emit(
        "bert4rec", items=MODEL_ITEMS, embedding_dim=B4R_DIM, heads=B4R_HEADS, blocks=B4R_BLOCKS, seq_len=B4R_LEN,
        batch=MODEL_BATCH, mask_prob=B4R_MASK_PROB, train=training, serve=serving, tiled=tiled,
    )
    return {"train": training, "serve": serving, "tiled": tiled}


def literal_pool_step(make_model, batch, initial, dtype, device) -> dict:
    """One TwoTower step with the in-batch pool scored in its literal form
    (every [B, L, N] candidate row through the item tower): its peak memory,
    loss and host time (a first step, so it includes the allocator's growth),
    or the out-of-memory error that is the finding."""
    from replay_tpu_torch.nn.loss import CESampled
    from replay_tpu_torch.nn.train import OptimizerFactory, Trainer

    release()
    trainer = Trainer(
        make_model(use_flash=True), CESampled(), optimizer=OptimizerFactory(name="adam", learning_rate=1e-3),
        precision="bf16" if dtype == torch.bfloat16 else None, device=device,
    )
    trainer.model.dedup_candidates = False
    torch.cuda.reset_peak_memory_stats(device)
    state = None
    try:
        state = trainer.init_state(batch, params=initial)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, loss = trainer.train_step(state, batch)
        torch.cuda.synchronize()
        record = {"fits": True, "loss": float(loss), "step_ms": (time.perf_counter() - t0) * 1e3}
    except torch.cuda.OutOfMemoryError as exc:
        record = {"fits": False, "error": str(exc).splitlines()[0][:240]}
    record["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated(device)
    del trainer, state
    release()
    return record


def query_embedding_checks(trainer, state, held: dict, logits: torch.Tensor, blocks: int) -> dict:
    """``predict_query_embeddings`` on the ``held`` windows through the query
    graph (K4 counted from 0: one replay, and a capture's warm-up where the
    shape is new; ``predict_top_k`` through the catalog captured it), bitwise
    the eager program, and times the item tower against ``logits``
    (``forward_inference``'s scores of the same windows) within ``SERVE_TOL``,
    the top 10 pinned."""
    from replay_tpu_torch.ops.flash_attention import flash_attention

    device = trainer.device
    warmups = trainer._eval_runner.warmups
    reset_counts(flash_attention)
    query_ids, embeddings = trainer.predict_query_embeddings(state, [held])
    torch.cuda.synchronize()
    query = {"k4_launches": flash_attention.launches, "captures": trainer._eval_runner.warmups - warmups}
    with eager_evaluation(trainer):
        _, eager_embeddings = trainer.predict_query_embeddings(state, [held])
    with torch.no_grad():
        scored = torch.as_tensor(embeddings, device=device) @ trainer.model.encode_items(item_feature_tensors=None).T
    query.update(
        rows=len(query_ids), bitwise_eager=bool(np.array_equal(embeddings, eager_embeddings)),
        max_abs_err_vs_forward_inference=float((scored - logits).abs().max()),
        ranks_pinned=pinned_top10(scored, logits, SERVE_TOL),
    )
    on_graph = device.type != "cuda" or any(key[0] == "queries" for key in trainer._eval_runner.keys)
    if (query["k4_launches"] != blocks * (1 + query["captures"]) or not on_graph or not query["bitwise_eager"] or query["max_abs_err_vs_forward_inference"] > SERVE_TOL
            or len(query_ids) != len(logits)):
        raise AssertionError(f"twotower predict_query_embeddings: {query}")
    return query


def twotower_phase(device) -> dict:
    """bench_suite.py's twotower row on K4 (D=32, causal): the trainer in f32
    and bf16 compute with ``CESampled`` over the in-batch pool
    (``model_training``), the pool scored once a batch; one step with the
    pool's literal form, its memory or its OOM; ``predict_top_k`` through the
    catalog cache against ``forward_inference``'s top-k;
    ``predict_query_embeddings`` on the query graph against the eager program
    and, times the item tower, against ``forward_inference``; the serving
    programs (``model_serving``)."""
    from replay_tpu_torch.nn.loss import CESampled
    from replay_tpu_torch.nn.sequential.twotower import TwoTower
    from replay_tpu_torch.nn.train import Trainer

    schema = model_schema(TT_DIM)
    width = dict(
        embedding_dim=TT_DIM, num_blocks=TT_BLOCKS, num_heads=TT_HEADS, max_sequence_length=TT_LEN,
        dropout_rate=0.0, device=device,
    )

    def make_model(use_flash, seed=SEED):
        return TwoTower(schema, use_flash=use_flash, generator=torch.Generator().manual_seed(seed), **width)

    batches = in_batch_batches(schema, MODEL_SCAN_BATCHES)
    if tuple(batches[0]["negative_labels"].shape) != (MODEL_BATCH,):
        raise AssertionError(f"in-batch pool of shape {tuple(batches[0]['negative_labels'].shape)}")
    training = {
        name: model_training(f"twotower {name}", make_model, CESampled, batches, TT_BLOCKS, TT_LEN, dtype, device)
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))
    }
    initial = make_model(True).state_dict()
    literal = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        literal[name] = literal_pool_step(make_model, batches[0], initial, dtype, device)
        if literal[name]["fits"]:
            first = training[name]["losses"][0]
            literal[name]["loss_rtol_vs_deduplicated"] = abs(literal[name]["loss"] - first) / abs(first)
    if literal["f32"]["fits"] and literal["f32"]["loss_rtol_vs_deduplicated"] > TRAIN_LOSS_RTOL:
        raise AssertionError(f"twotower: the literal pool's loss differs from the deduplicated one: {literal}")

    # predict_top_k through the catalog cache against forward_inference's top-k
    trainer = Trainer(make_model(True), CESampled(), device=device)
    state = trainer.init_state(batches[0])
    for batch in batches[:MODEL_STEPS]:
        state, _ = trainer.train_step(state, batch)
    rng = np.random.default_rng(SEED + 7)
    lengths = rng.integers(1, TT_LEN + 1, 256)
    mask = np.arange(TT_LEN)[None, :] >= TT_LEN - lengths[:, None]
    ids = np.where(mask, rng.integers(0, MODEL_ITEMS, (256, TT_LEN)), MODEL_ITEMS).astype(np.int32)
    held = {"feature_tensors": {"item_id": ids}, "padding_mask": mask}
    _, items, scores = trainer.predict_top_k(state, [held], 10)
    want = trainer.predict_logits(state, held)
    want_scores, want_items = torch.topk(want, 11, dim=-1)
    want_scores, want_items = want_scores.cpu().numpy(), want_items.cpu().numpy()
    score_err = float(np.abs(scores - want_scores[:, :10]).max())
    gaps = -np.diff(want_scores, axis=1)
    previous = np.concatenate([np.full((len(gaps), 1), np.inf), gaps[:, :9]], axis=1)
    pinned = np.minimum(previous, gaps) > 2 * score_err
    if score_err > 1e-5 or not np.array_equal(items[pinned], want_items[:, :10][pinned]):
        raise AssertionError(f"twotower predict_top_k: scores differ by {score_err}, or a pinned rank differs")
    query = query_embedding_checks(trainer, state, held, want, TT_BLOCKS)
    del trainer, state
    release()
    serving = model_serving(
        "twotower", make_model(True), make_model(True, SEED + 1).state_dict(), TT_BLOCKS, TT_LEN, device
    )
    emit(
        "twotower", items=MODEL_ITEMS, embedding_dim=TT_DIM, heads=TT_HEADS, blocks=TT_BLOCKS, seq_len=TT_LEN,
        batch=MODEL_BATCH, pool=MODEL_BATCH, train=training, literal_pool=literal,
        predict_top_k={"score_max_abs_err": score_err, "ranks_pinned": int(pinned.sum())},
        predict_query_embeddings=query, serve=serving,
    )
    return {"train": training, "serve": serving, "query_embeddings": query}


def notebook_events(seed: int):
    """A synthetic log shaped like MovieLens-1M, from default_rng(seed):
    ``NB_USERS`` users with at least ``NB_MIN_EVENTS`` events each,
    ``NB_EVENTS`` events in all (lengths geometric above the minimum), over
    ``NB_ITEMS`` items. Each event follows its predecessor's successor item (a
    fixed random map) with probability ``NB_FOLLOW``, else it is a draw from a
    Zipf law (exponent 1, ids in a shuffled order): item popularity is
    skewed, and there is a sequential signal for the model to learn. Returns
    the ``[users, longest]`` item indices (each user's row in event order)
    and each user's length."""
    rng = np.random.default_rng(seed)
    extra = rng.geometric(1.0 / (NB_EVENTS / NB_USERS - NB_MIN_EVENTS + 1), NB_USERS) - 1
    extra = np.floor(extra * ((NB_EVENTS - NB_USERS * NB_MIN_EVENTS) / extra.sum())).astype(np.int64)
    extra[: NB_EVENTS - NB_USERS * NB_MIN_EVENTS - extra.sum()] += 1
    lengths = NB_MIN_EVENTS + extra
    popularity = 1.0 / np.arange(1, NB_ITEMS + 1)
    order = rng.permutation(NB_ITEMS)
    successor = rng.permutation(NB_ITEMS)
    width = int(lengths.max())
    draws = order[rng.choice(NB_ITEMS, size=(NB_USERS, width), p=popularity / popularity.sum())]
    follow = rng.random((NB_USERS, width)) < NB_FOLLOW
    log = np.empty((NB_USERS, width), dtype=np.int64)
    log[:, 0] = draws[:, 0]
    for t in range(1, width):  # one step of every user's chain at a time
        log[:, t] = np.where(follow[:, t], successor[log[:, t - 1]], draws[:, t])
    return log, lengths


def notebook_log(seed: int):
    """``notebook_events(seed)`` split last-one-out twice by hand, as
    examples/ml1m_parity.py splits it: each user's last event is the test
    target, the one before it the validation target, the rest the train
    history (the test's input history is the train history and the
    validation target). Returns the four splits (train, validation target,
    test history, test target) as numpy columns (a query id, an object array
    of item arrays) and the event count."""
    log, lengths = notebook_events(seed)
    users = np.arange(NB_USERS, dtype=np.int64)

    def split(part):
        column = np.empty(NB_USERS, dtype=object)
        for index in range(NB_USERS):
            column[index] = part(log[index, : lengths[index]])
        return {"user_id": users, "item_id": column}

    splits = (split(lambda s: s[:-2]), split(lambda s: s[-2:-1]), split(lambda s: s[:-1]), split(lambda s: s[-1:]))
    return (*splits, int(lengths.sum()))


def notebook_raw_items(seed: int) -> np.ndarray:
    """The raw id of each of the ``NB_ITEMS`` item indices: a fixed random
    subset of 1..3,952 (MovieLens-1M's ids are sparse: 3,706 of them rated)."""
    return np.sort(np.random.default_rng(seed + 1).choice(np.arange(1, 3953), NB_ITEMS, replace=False))


def notebook_raw_log(seed: int) -> dict:
    """``notebook_events(seed)`` as the raw log notebook 09 starts from:
    ``(user_id, item_id, timestamp)`` numpy columns, user ``u``'s raw id
    ``u + 1`` (1..6,040), item ``i``'s ``notebook_raw_items(seed)[i]``, the
    timestamp each user's event position (the notebook's cumcount); rows in
    time order (position, then user)."""
    log, lengths = notebook_events(seed)
    positions, users = np.nonzero(np.arange(log.shape[1])[:, None] < lengths[None, :])
    return {
        "user_id": users.astype(np.int64) + 1,
        "item_id": notebook_raw_items(seed)[log[users, positions]],
        "timestamp": positions.astype(np.int64),
    }


def notebook_front_end(raw: dict) -> dict:
    """Notebook 09's front end (examples/ml1m_parity.py:78-112) on the port:
    ``LastNSplitter(N=1)`` twice, dropping cold users and items, then
    ``FeatureSchema``, ``Dataset`` and ``SequenceTokenizer(handle_unknown_rule=
    "drop")`` fitted on train and applied to the validation target, the test
    history and the test target. Returns the four ``SequentialDataset``s,
    the tensor schema with the tokenizer's item cardinality, the tokenizer,
    the seconds of each stage and the rows dropped as cold."""
    from replay_tpu_torch.data import Dataset, FeatureHint, FeatureInfo, FeatureSchema, FeatureSource, FeatureType
    from replay_tpu_torch.data.nn import SequenceTokenizer, TensorFeatureInfo, TensorFeatureSource, TensorSchema
    from replay_tpu_torch.splitters import LastNSplitter

    seconds = {}

    def timed(stage, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[stage] = time.perf_counter() - t0
        return out

    splitter = LastNSplitter(
        N=1, divide_column="user_id", query_column="user_id", strategy="interactions",
        drop_cold_users=True, drop_cold_items=True,
    )
    test_events, test_gt = timed("split_test", lambda: splitter.split(raw))
    train_events, validation_gt = timed("split_validation", lambda: splitter.split(test_events))

    def cold(source, train, test):
        # N=1: before the drops, the test split holds each user's last event
        users = np.unique(source["user_id"])
        cold_users = int((~np.isin(users, train["user_id"])).sum())
        return {"cold_users": cold_users, "cold_items": len(users) - cold_users - len(test)}

    dropped = {"test": cold(raw, test_events, test_gt), "validation": cold(test_events, train_events, validation_gt)}
    feature_schema = FeatureSchema([
        FeatureInfo("user_id", FeatureType.CATEGORICAL, FeatureHint.QUERY_ID),
        FeatureInfo("item_id", FeatureType.CATEGORICAL, FeatureHint.ITEM_ID),
        FeatureInfo("timestamp", FeatureType.NUMERICAL, FeatureHint.TIMESTAMP),
    ])
    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
            feature_sources=[TensorFeatureSource(FeatureSource.INTERACTIONS, "item_id")], embedding_dim=NB_DIM,
        )
    )
    tokenizer = SequenceTokenizer(schema, handle_unknown_rule="drop")
    train = timed("fit", lambda: tokenizer.fit_transform(Dataset(feature_schema=feature_schema, interactions=train_events)))
    rest = [
        timed(f"transform_{name}", lambda part=part: tokenizer.transform(Dataset(feature_schema=feature_schema, interactions=part)))
        for name, part in (("validation_target", validation_gt), ("test_history", test_events), ("test_target", test_gt))
    ]
    return {
        "splits": (train, *rest), "schema": schema, "tokenizer": tokenizer, "seconds": seconds, "dropped": dropped,
    }


def decodes_to_hand_splits(front: dict, seed: int) -> dict:
    """The tokenized splits decoded through the encoders' inverse mappings
    against ``notebook_log(seed)``'s hand-built splits after the same cold
    drops: an item the train split lacks leaves a validation or test target
    (the splitter's drop) and a test history (the tokenizer's); a user whose
    target was dropped has no row there. Returns the rows compared and
    whether every one is equal."""
    tokenizer = front["tokenizer"]
    labels = tokenizer.item_id_encoder.inverse_mapping["item_id"]
    items = np.asarray([labels[code] for code in range(len(labels))])
    users = tokenizer.query_id_encoder.inverse_mapping["user_id"]
    raw_items = notebook_raw_items(seed)
    hand = notebook_log(seed)[:4]
    known = np.zeros(NB_ITEMS, bool)
    known[np.concatenate(list(hand[0]["item_id"]))] = True
    rows, equal = 0, True
    for split, columns in zip(front["splits"], hand):
        decoded = {
            users[int(query)]: items[split.get_sequence(index, "item_id")].tolist()
            for index, query in enumerate(split.query_ids)
        }
        for user, sequence in zip(columns["user_id"], columns["item_id"]):
            want = raw_items[sequence[known[sequence]]].tolist()
            got = decoded.pop(int(user) + 1, [])
            equal &= got == want
            rows += 1
        equal &= not decoded
    return {"rows": rows, "equal": bool(equal)}


class FitEvents:
    """An event sink that keeps every event (``fit``'s loggers)."""

    def __init__(self) -> None:
        self.events = []

    def log_event(self, event) -> None:
        self.events.append(event)

    def named(self, name: str) -> list:
        return [e for e in self.events if e.event == name]


def timed_method(obj, name: str, times: list) -> None:
    """Make ``obj.name`` record the host ms of each call into ``times``."""
    method = getattr(obj, name)

    @functools.wraps(method)
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        out = method(*args, **kwargs)
        times.append((time.perf_counter() - t0) * 1e3)
        return out

    setattr(obj, name, timed)


def state_equal(a, b) -> bool:
    tensors = lambda s: [s.flat_params, *(t for link in s.opt_state for t in link.values()), s.bad_steps]  # noqa: E731
    return a.step == b.step and torch.equal(a.rng, b.rng) and all(
        torch.equal(x, y) for x, y in zip(tensors(a), tensors(b))
    )


def checkpoint_leaves_equal(path_a, path_b) -> bool:
    with np.load(str(path_a)) as a, np.load(str(path_b)) as b:
        return sorted(a.files) == sorted(b.files) and all(np.array_equal(a[k], b[k]) for k in a.files)


def dropout_contract(make_trainer, initial, batches) -> dict:
    """Dropout inside a captured chunk, at the notebook width: one replay of
    the K-step graph equals K ``train_step``s bit for bit (losses, params,
    optimizer state, ``rng``); replays from the same params draw other masks
    as the stream advances; a control replaying one fixed mask (the stream
    reset before each replay) must fail that check."""
    from replay_tpu_torch.nn.train import _clone_state

    def tensors(state):
        return [state.flat_params, *(t for link in state.opt_state for t in link.values()), state.bad_steps]

    runs = []
    for _ in range(2):
        trainer = make_trainer()
        state = trainer.init_state(None, params=initial)
        losses = torch.stack([trainer.train_step(state, b)[1] for b in batches]).cpu().numpy()
        runs.append((losses, _clone_state(state)))
        del trainer
    repeatable = np.array_equal(runs[0][0], runs[1][0]) and state_equal(runs[0][1], runs[1][1])
    trainer = make_trainer()
    state = trainer.init_state(None, params=initial)
    start = _clone_state(state)
    _, graph_losses = trainer.train_steps(state, batches)
    torch.cuda.synchronize()
    equal = np.array_equal(graph_losses, runs[0][0]) and state_equal(state, runs[0][1])

    def replay_from(stream):
        for dst, src in zip(tensors(state), tensors(start)):
            dst.copy_(src)
        state.rng = stream.clone()
        _, losses = trainer.train_steps(state, batches)
        return losses, state.rng.clone()

    first, advanced = replay_from(start.rng)
    second, _ = replay_from(advanced)
    fixed, _ = replay_from(start.rng)
    record = {
        "K": len(batches), "per_step_repeatable": repeatable, "graph_equals_steps": equal,
        "graph_vs_steps_max_loss_diff": float(np.abs(graph_losses - runs[0][0]).max()),
        "replay_equals_first": bool(np.array_equal(first, graph_losses)),
        "masks_advance": not np.array_equal(second, first),
        "replays_loss_max_diff": float(np.abs(second - first).max()),
        "fixed_mask_control_caught": bool(np.array_equal(fixed, first)),
        "capture_warmups": trainer.capture_warmups,
    }
    captures = 1 if trainer.device.type == "cuda" else 0  # the CPU runs chunks eagerly
    del trainer, state
    release()
    if not (repeatable and equal and record["replay_equals_first"] and record["masks_advance"]
            and record["fixed_mask_control_caught"] and record["capture_warmups"] == captures):
        raise AssertionError(f"lifecycle: the dropout chunk contract failed: {record}")
    return record


@contextlib.contextmanager
def eager_evaluation(trainer):
    """The trainer's evaluation and metric programs run eagerly in the block
    (the reference each evaluation graph is held to), its graphs after."""
    from replay_tpu_torch.metrics.builder import metric_program
    from replay_tpu_torch.nn.graphs import EagerProgram

    saved = trainer._eval_runner, trainer._metric_runner
    trainer._eval_runner, trainer._metric_runner = EagerProgram(trainer._eval_program), EagerProgram(metric_program)
    try:
        yield trainer
    finally:
        trainer._eval_runner, trainer._metric_runner = saved


def evaluation_checks(trainer, states, batches, metric_kwargs: dict, blocks: int) -> dict:
    """Notebook 09's evaluation on graphs against the eager programs:

    * every validation batch's logits, graph replay against the eager
      program, bit for bit, for each of ``states`` (the trained best state
      and a second state in another buffer);
    * ``validate`` over the validation batches (made on the fly, as ``fit``
      makes them) on graphs and eagerly: metrics identical, seconds of each,
      K4 launches through the replays = ``blocks`` a batch;
    * a warm trace of the graph ``validate``: host ms, device ms and busy
      share a batch; K4 kernels in the trace = K4 counted.
    """
    from replay_tpu_torch.ops.flash_attention import flash_attention

    listed = list(batches())
    logits_equal = True
    for state in states:
        for batch in listed:
            graph = trainer.predict_logits(state, batch)
            with eager_evaluation(trainer):
                eager = trainer.predict_logits(state, batch)
            logits_equal &= bool(torch.equal(graph, eager))
    best = states[0]

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.validate(best, batches(), **metric_kwargs)
        torch.cuda.synchronize()
        return metrics, time.perf_counter() - t0

    reset_counts(flash_attention)
    graph_metrics, graph_s = timed()
    replayed = flash_attention.launches
    with eager_evaluation(trainer):
        eager_metrics, eager_s = timed()
    with profiled_window(lambda: trainer.validate(best, listed[:4], **metric_kwargs)) as prof:
        reset_counts(flash_attention)
        t0 = time.perf_counter()
        trainer.validate(best, batches(), **metric_kwargs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = device_events(prof.key_averages())
    device_ms = sum(e.self_device_time_total for e in device) / 1e3
    record = {
        "batches": len(listed), "states": len(states), "logits_bitwise": logits_equal,
        "metrics_identical": graph_metrics == eager_metrics, "graph_validate_s": graph_s, "eager_validate_s": eager_s,
        "k4_replayed": replayed, "k4_traced": traced_kernels(device, [flash_attention])["flash_attention"],
        "k4_in_trace_window": flash_attention.launches,
        "per_batch": {
            "host_ms": wall_ms / len(listed), "device_ms": device_ms / len(listed), "busy_share": device_ms / wall_ms,
            "kernels": sum(e.count for e in device if not e.key.startswith(COPY_EVENTS)) / len(listed),
        },
        "graphs": {"eval": len(trainer._eval_runner.keys), "metrics": len(trainer._metric_runner.keys)},
    }
    want = blocks * len(listed)
    if not (logits_equal and record["metrics_identical"] and replayed == want
            and record["k4_traced"] == record["k4_in_trace_window"] == want):
        raise AssertionError(f"lifecycle: evaluation on graphs differs from the eager programs: {record}")
    return record


# the trainer's per-user metrics that OfflineMetrics computes too, and its
# classes of them; notebook 09's test metrics (BASELINE.md:18)
NB_TRAINER_METRICS = ("recall", "precision", "map", "ndcg", "mrr", "hitrate")
NB_OFFLINE_NAMES = {"recall": "Recall", "precision": "Precision", "map": "MAP", "ndcg": "NDCG", "mrr": "MRR", "hitrate": "HitRate"}
NB_BASELINE_TEST = {"Recall@10": 0.1499, "MAP@10": 0.0469, "Precision@10": 0.0150}
# the trainer sums in f32 on the card, OfflineMetrics in f64 on the host
OFFLINE_TOL = 1e-5


def split_table(dataset, query_ids=None):
    """A tokenized split as a (query_id, item_id) ``ColumnTable``, one row an
    event, in the split's order; only the queries in ``query_ids`` where given."""
    from replay_tpu_torch.utils.types import ColumnTable

    column = dataset.item_id_column
    rows = range(len(dataset)) if query_ids is None else np.flatnonzero(np.isin(dataset.query_ids, query_ids))
    sequences = [dataset.get_sequence(i, column) for i in rows]
    return ColumnTable({
        "query_id": np.repeat(np.asarray(dataset.query_ids)[list(rows)], [len(q) for q in sequences]),
        "item_id": np.concatenate(sequences) if sequences else np.zeros(0, np.int64),
    })


def offline_evaluation(trainer, best, batches, train, test_gt, items: int) -> dict:
    """Notebook 09's test evaluation (cell 41) on the best state, from one
    count of K4 at 0 (the main path of this part):

    * ``validate`` with the six per-user metrics, ``predict_dataframe``,
      ``predict_top_k`` and ``predict_query_embeddings`` over the test
      batches, on the evaluation graphs; K4 = blocks × (4 replays a batch +
      the new captures' warm-ups: the query program's one, on the card);
    * ``OfflineMetrics`` ([Recall, Precision, MAP, NDCG, MRR, HitRate,
      Coverage, Novelty, Surprisal]) on the host over ``predict_dataframe``'s
      table, the test targets of the same queries and the train split: each
      of the six within ``OFFLINE_TOL`` of ``validate``'s;
    * ``predict_dataframe`` bitwise ``predict_top_k``;
    * the query embeddings times the item table: the top 10 of
      ``predict_top_k`` at every rank clear of its neighbours (``pinned_top10``).
    """
    from replay_tpu_torch.metrics import (
        MAP, MRR, NDCG, Coverage, HitRate, Novelty, OfflineMetrics, Precision, Recall, Surprisal,
    )
    from replay_tpu_torch.ops.flash_attention import flash_attention

    listed = list(batches)
    k = max(NB_TOP_K)
    runner = trainer._eval_runner
    warmups = runner.warmups
    reset_counts(flash_attention)
    test_metrics = trainer.validate(best, listed, metrics=NB_TRAINER_METRICS, top_k=NB_TOP_K, item_count=items)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table = trainer.predict_dataframe(best, listed, k=k)
    dataframe_s = time.perf_counter() - t0
    queries, top_items, top_scores = trainer.predict_top_k(best, listed, k)
    t0 = time.perf_counter()
    query_ids, embeddings = trainer.predict_query_embeddings(best, listed)
    embeddings_s = time.perf_counter() - t0
    launches = flash_attention.launches
    captures = runner.warmups - warmups
    expected = NB_BLOCKS * (4 * len(listed) + captures)

    gt = split_table(test_gt, queries)
    t0 = time.perf_counter()
    train_table = split_table(train)
    train_table_s = time.perf_counter() - t0
    metrics = [cls(list(NB_TOP_K)) for cls in (Recall, Precision, MAP, NDCG, MRR, HitRate, Coverage, Novelty, Surprisal)]
    t0 = time.perf_counter()
    offline = OfflineMetrics(metrics)(table, gt, train=train_table)
    offline_s = time.perf_counter() - t0
    by_class = {}  # each class alone: where the host's seconds go
    for metric in metrics:
        t0 = time.perf_counter()
        OfflineMetrics([metric])(table, gt, train=train_table)
        by_class[type(metric).__name__] = time.perf_counter() - t0
    differences = {
        f"{name}@{cut}": abs(offline[f"{NB_OFFLINE_NAMES[name]}@{cut}"] - test_metrics[f"{name}@{cut}"])
        for name in NB_TRAINER_METRICS for cut in NB_TOP_K
    }
    bitwise = (
        np.array_equal(table["query_id"], np.repeat(queries, k)) and np.array_equal(table["item_id"], top_items.reshape(-1))
        and np.array_equal(table["rating"], top_scores.reshape(-1))
    )
    with torch.no_grad():
        scored = torch.as_tensor(embeddings, device=trainer.device) @ trainer.model.get_item_weights().T
    want = torch.full_like(scored, -math.inf)
    want.scatter_(1, torch.as_tensor(top_items, device=want.device), torch.as_tensor(top_scores, device=want.device))
    record = {
        "test_batches": len(listed), "queries": len(queries), "gt_rows": len(gt), "k": k,
        "k4_launches": launches, "k4_expected": expected, "new_captures": captures,
        "predict_dataframe_s": dataframe_s, "predict_query_embeddings_s": embeddings_s,
        "offline_metrics_s": offline_s, "offline_metrics_s_by_class": by_class, "train_rows": len(train_table),
        "train_table_s": train_table_s, "offline_metrics": offline, "trainer_test": dict(test_metrics),
        "max_difference": max(differences.values()), "differences": differences, "tol": OFFLINE_TOL,
        "dataframe_bitwise_top_k": bool(bitwise), "embedding_ids_equal": bool(np.array_equal(query_ids, queries)),
        "embedding_ranks_pinned": pinned_top10(scored, want, SERVE_TOL),
        "beside_baseline": {name: {"port": offline[name], "notebook_09": value} for name, value in NB_BASELINE_TEST.items()},
    }
    if (launches != expected or captures != (1 if trainer.device.type == "cuda" else 0) or not bitwise
            or not record["embedding_ids_equal"] or record["max_difference"] > OFFLINE_TOL
            or not all(math.isfinite(v) for v in offline.values())):
        raise AssertionError(f"lifecycle: the test evaluation through OfflineMetrics and the predictions fails: {record}")
    return record


def top_k_times(device, cases) -> list:
    """``models/ann.py::top_k`` (``jax.lax.top_k``'s tie order) against a bare
    ``torch.topk`` at the evaluation shapes, device ms a call (``graph_ms``),
    on logits with a third of each row at ``SeenItemsFilter``'s fill."""
    from replay_tpu_torch.models.ann import top_k

    out = []
    for label, rows, columns, k in cases:
        generator = torch.Generator(device).manual_seed(SEED)
        logits = torch.randn(rows, columns, device=device, generator=generator)
        seen = torch.rand(rows, columns, device=device, generator=generator) < 1 / 3
        logits = torch.where(seen, torch.finfo(torch.float32).min, logits)
        _, ids = top_k(logits, k)
        order = torch.argsort(-logits, dim=-1, stable=True)[:, :k]
        out.append({
            "case": label, "shape": [rows, columns], "k": k, "top_k_ms": graph_ms(lambda: top_k(logits, k)),
            "torch_topk_ms": graph_ms(lambda: torch.topk(logits, k, dim=-1)),
            "ids_equal_stable_order": bool(torch.equal(ids, order)),
        })
    if not all(case["ids_equal_stable_order"] for case in out):
        raise AssertionError(f"top_k: ids differ from the stable descending order: {out}")
    return out


def float_target(batch):
    """The ``valid`` rows folded into an f32 target mask: the float leaf that
    ``inject_nan`` poisons (a NaN weight makes the step's loss non-finite)."""
    batch = dict(batch)
    valid = torch.as_tensor(batch.pop("valid"))
    target = torch.as_tensor(batch["target_padding_mask"])
    batch["target_padding_mask"] = (target & valid[:, None, None]).to(torch.float32)
    return batch


def lifecycle_phase(device) -> dict:
    """Notebook 09's training run (examples/ml1m_parity.py's settings) on the
    port: a MovieLens-1M-shaped raw log through the front end
    (``notebook_front_end``; its splits decoded back to the hand-built ones),
    ``SequenceBatcher(windows, shuffle, seed 0)`` with the SASRec
    templates through ``TransformedBatches``, ``validation_batches``,
    ``SasRec(use_flash=True, dropout 0.3)`` with ``CE`` and Adam 1e-3, and
    ``Trainer.fit``'s lifecycle:

    (e) the dropout chunk contract (``dropout_contract``);
    (a) one eager epoch, per step, with per-step events: step p50/p99,
        steps/s, device busy; the host's ms per batch (assembly, transforms);
    (b) the notebook run: ``fit(epochs=5, scan_chunk=K, prefetch, device_feed,
        checkpoint_manager, checkpoint_every, monitor="recall@10",
        loggers=JsonlLogger)``: chunk step p50, steps/s, epoch and
        validation seconds, busy share, checkpoint ms and bytes, peak memory,
        K4 launches counted through the replays (the main path: the count
        starts at 0 with the run and is read at its end), the history, the
        best epoch's state returned; the evaluation graphs against the eager
        programs (``evaluation_checks``); then the best state on the test split
        through ``validate``, ``predict_dataframe``, ``predict_top_k``,
        ``predict_query_embeddings`` and ``OfflineMetrics``, from a K4 count of
        its own (``offline_evaluation``);
    (c) the same run preempted mid-epoch 2 by ``SignalAtStep(SIGTERM)``, then
        ``fit(resume=True)``: returned state, history, best step and final
        checkpoint bitwise (b)'s;
    (d) one epoch with ``NaNInjector`` on ``NB_BAD_STEPS`` steps in a row and
        ``RecoveryPolicy(max_consecutive_bad=...)``: the rollback and the LR
        backoff in the events, a finite end;
    (f) one epoch of the notebook run with ``CEFused`` for ``CE``: K1–K3 at
        1,600 rows over the tokenizer's items, their ``tf32`` variant once a step;
    (g) ``top_k_times``: the tie-order top-k at the notebook's and BERT4Rec's widths.
    """
    import signal
    import tempfile
    from pathlib import Path

    from replay_tpu_torch.data.nn import SequenceBatcher, TransformedBatches, validation_batches
    from replay_tpu_torch.nn.loss import CE, CEFused
    from replay_tpu_torch.nn.sequential.sasrec import SasRec
    from replay_tpu_torch.nn.train import OptimizerFactory, RecoveryPolicy, Trainer
    from replay_tpu_torch.ops import fused_ce as fc
    from replay_tpu_torch.nn.transform import Compose, make_default_sasrec_transforms
    from replay_tpu_torch.obs import JsonlLogger
    from replay_tpu_torch.ops.flash_attention import flash_attention
    from replay_tpu_torch.utils import CheckpointManager, NaNInjector, SignalAtStep

    t0 = time.perf_counter()
    raw_log = notebook_raw_log(SEED)
    front = notebook_front_end(raw_log)
    train, val_gt, test_history, test_gt = front["splits"]
    schema = front["schema"]
    items = schema["item_id"].cardinality  # the model's table and the CE width follow it
    decoded = decodes_to_hand_splits(front, SEED)
    front_end = {
        "events": len(raw_log["user_id"]), "seconds": front["seconds"], "dropped": front["dropped"],
        "item_cardinality": items, "users": len(train), "validation_users": len(val_gt), "test_users": len(test_gt),
        "decoded_rows": decoded["rows"], "decodes_to_hand_splits": decoded["equal"],
    }
    emit("lifecycle", run="front_end", **front_end)
    if not decoded["equal"] or len(train) != NB_USERS or not 0 < items <= NB_ITEMS:
        raise AssertionError(f"lifecycle: the front end's splits do not decode to the hand-built ones: {front_end}")
    pipes = {split: Compose(p) for split, p in make_default_sasrec_transforms(schema).items()}
    batcher = SequenceBatcher(
        train, batch_size=NB_BATCH, max_sequence_length=NB_LEN + 1, windows=True, shuffle=True, seed=0
    )
    source = TransformedBatches(batcher, pipes["train"])
    setup_s = time.perf_counter() - t0

    def val_batches():
        return (pipes["validate"](b) for b in validation_batches(train, val_gt, NB_BATCH, NB_LEN))

    # the host's work per batch, alone: assembly (the batcher) and transforms
    t0 = time.perf_counter()
    raw = list(batcher)
    assembly_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    transformed = [pipes["train"](b) for b in raw]
    transform_s = time.perf_counter() - t0
    steps_per_epoch = len(raw)
    host = {
        "batches_per_epoch": steps_per_epoch, "assembly_ms_per_batch": assembly_s * 1e3 / steps_per_epoch,
        "transform_ms_per_batch": transform_s * 1e3 / steps_per_epoch,
    }
    host["host_ms_per_batch"] = host["assembly_ms_per_batch"] + host["transform_ms_per_batch"]
    t0 = time.perf_counter()
    val_count = sum(1 for _ in val_batches())
    host["validation_batches"] = val_count
    host["validation_host_ms_per_batch"] = (time.perf_counter() - t0) * 1e3 / val_count
    del raw

    def make_trainer(loss=CE):
        model = SasRec(
            schema, use_flash=True, embedding_dim=NB_DIM, num_blocks=NB_BLOCKS, num_heads=NB_HEADS,
            dropout_rate=NB_DROPOUT, max_sequence_length=NB_LEN, device=device,
            generator=torch.Generator().manual_seed(SEED),
        )
        return Trainer(model, loss(), optimizer=OptimizerFactory(name="adam", learning_rate=1e-3), seed=SEED, device=device)

    initial = {name: value.detach().clone() for name, value in make_trainer().model.state_dict().items()}
    params = sum(value.numel() for value in initial.values())
    fit_kwargs = dict(
        val_batches=val_batches, metrics=("ndcg", "recall", "map"), top_k=NB_TOP_K, item_count=items,
        monitor="recall@10", log_every=0,
    )
    import gc

    record = {
        "users": NB_USERS, "items": items, "events": front_end["events"],
        "train_events": int(sum(train.get_sequence_length(i) for i in range(len(train)))),
        "params": params, "setup_s": setup_s, "front_end": front_end, "host": host,
        # what the process carries into the phase (host times rise late in the script)
        "threads_alive": threading.active_count(), "gc_tracked_objects": len(gc.get_objects()),
    }
    emit("lifecycle", run="setup", **record)

    # (e) the dropout contract on the first K batches of epoch 0
    record["dropout_contract"] = dropout_contract(make_trainer, initial, transformed[:NB_SCAN_K])
    emit("lifecycle", run="dropout_contract", **record["dropout_contract"])

    with tempfile.TemporaryDirectory(prefix="lifecycle_") as scratch:
        root = Path(scratch)

        # (a) one eager epoch, per step, every step an event
        trainer = make_trainer()
        recorder = FitEvents()
        state = trainer.init_state(None, params=initial)
        t0 = time.perf_counter()
        trainer.fit(source, epochs=1, state=state, loggers=recorder, **fit_kwargs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        step_ms = sorted(1e3 * e.payload["step_seconds"] for e in recorder.named("on_train_step")[1:])
        _, device_record = device_time_per_step(trainer, state, transformed[0], NB_PROFILED_STEPS)
        p50 = step_ms[len(step_ms) // 2]
        eager = {
            "steps": len(step_ms) + 1, "p50_ms": p50, "p99_ms": step_ms[min(len(step_ms) - 1, math.ceil(0.99 * len(step_ms)) - 1)],
            "steps_per_s": recorder.named("on_fit_end")[0].payload["telemetry"]["steps_per_sec"],
            "epoch_s": wall, "device_ms_per_step": device_record["device_ms"],
            "device_busy_share": device_record["device_ms"] / p50, "kernels_per_step": device_record["kernels_per_step"],
            "history": list(trainer.history),
        }
        record["eager"] = eager
        emit("lifecycle", run="eager_epoch", **eager)
        del trainer, state, recorder
        release()

        # (b) the notebook run, the main path
        def notebook_run(directory, stream, resume=False):
            trainer = make_trainer()
            chunk_ms, val_ms, save_ms = [], [], []
            timed_method(trainer, "_run_chunk", chunk_ms)
            timed_method(trainer, "validate", val_ms)
            manager = CheckpointManager(str(directory), max_to_keep=3)
            timed_method(manager, "save", save_ms)
            recorder = FitEvents()
            sinks = [JsonlLogger(str(directory / "events")), recorder]
            t0 = time.perf_counter()
            state = trainer.fit(
                stream, epochs=NB_EPOCHS, scan_chunk=NB_SCAN_K, prefetch=2, device_feed=True,
                checkpoint_manager=manager, checkpoint_every=NB_CHECKPOINT_EVERY, loggers=sinks, resume=resume,
                **fit_kwargs,
            )
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            sinks[0].close()
            return trainer, state, manager, recorder, wall, chunk_ms, val_ms, save_ms

        torch.cuda.reset_peak_memory_stats(device)
        reset_counts(flash_attention)
        trainer, best, manager, recorder, wall, chunk_ms, val_ms, save_ms = notebook_run(root / "b", source)
        k4_launches = flash_attention.launches
        captures = trainer.capture_warmups
        eval_captures = trainer._eval_runner.warmups
        peak = torch.cuda.max_memory_allocated(device)
        steps = NB_EPOCHS * steps_per_epoch
        # chunk replays and tails, the chunk captures' and the evaluation
        # graph's warm-ups, and each epoch's validation replays
        expected = NB_BLOCKS * (steps + captures + eval_captures + NB_EPOCHS * val_count)
        if k4_launches != expected or eval_captures != (1 if device.type == "cuda" else 0):
            raise AssertionError(
                f"lifecycle: K4 ran {k4_launches} times in the notebook run, not {expected} "
                f"({eval_captures} evaluation captures)"
            )
        history = [dict(r) for r in trainer.history]
        best_step = manager.best_step()
        best_epoch = int(np.argmax([r["recall@10"] for r in history]))
        best_checkpoint = manager.restore(best, step=best_step)
        returned_best = state_equal(best, best_checkpoint) and best.step == (best_epoch + 1) * steps_per_epoch
        if not returned_best or manager.metadata(best_step)["epoch"] != best_epoch:
            raise AssertionError(f"lifecycle: the returned state is not the best epoch's ({best_epoch}, step {best_step})")
        final_step = manager.latest_step()
        final_files = root / "b" / f"step_{final_step}.npz"
        ends = [e.time for e in recorder.named("on_epoch_end")]
        starts = [recorder.named("on_fit_start")[0].time] + ends[:-1]
        epoch_s = [b - a for a, b in zip(starts, ends)]
        per_chunk = sorted(ms / NB_SCAN_K for ms in chunk_ms[1:])
        chunk_p50 = per_chunk[len(per_chunk) // 2]
        # device time a step on the graph, from traces of replays (K4 in the
        # trace = K4 counted), on the run's trainer and its best state
        trace_state = trainer.init_state(None, params=initial)
        traces = []
        for _ in range(TRACES_AT_MOST):
            trace_state, trace = traced_chunks(trainer, trace_state, transformed[:NB_SCAN_K], 2, (flash_attention,))
            traces.append(trace)
            sound = trace["traced"] == trace["launched"] and trace["device_ms"] <= trace["event_ms"]
            if sound and len(traces) > 1 and traces[-2]["kernels"] == trace["kernels"]:
                break
        else:
            raise AssertionError(f"lifecycle: no two traces of replays agree with the counts: {traces}")
        device_ms = trace["device_ms"] / (2 * NB_SCAN_K)
        validation_s = [ms / 1e3 for ms in val_ms]
        metric_kwargs = dict(metrics=fit_kwargs["metrics"], top_k=NB_TOP_K, item_count=items)
        evaluation = evaluation_checks(trainer, (best, trace_state), val_batches, metric_kwargs, NB_BLOCKS)
        emit("lifecycle", run="evaluation", **evaluation)
        # the test split: validate, predict_dataframe, predict_top_k and
        # predict_query_embeddings on the graphs, OfflineMetrics on the host
        offline = offline_evaluation(
            trainer, best, (pipes["validate"](b) for b in validation_batches(test_history, test_gt, NB_BATCH, NB_LEN)),
            train, test_gt, items,
        )
        emit("lifecycle", run="offline_metrics", **offline)
        test_metrics = offline["trainer_test"]
        ckpt_bytes = sum(p.stat().st_size for p in (root / "b").glob(f"step_{final_step}.*"))
        notebook = {
            "epochs": NB_EPOCHS, "K": NB_SCAN_K, "steps": steps, "wall_s": wall,
            "chunk_step_p50_ms": chunk_p50, "chunk_step_p99_ms": per_chunk[min(len(per_chunk) - 1, math.ceil(0.99 * len(per_chunk)) - 1)],
            "steps_per_s": steps / (wall - sum(val_ms) / 1e3 - sum(save_ms) / 1e3),
            "epoch_s": epoch_s, "validation_s": validation_s,
            "device_ms_per_step": device_ms, "kernels_per_step": trace["kernels"] / (2 * NB_SCAN_K),
            "device_busy_share_epoch": [device_ms * steps_per_epoch / 1e3 / s for s in epoch_s],
            "checkpoint_ms": save_ms, "checkpoint_bytes": ckpt_bytes, "checkpoints_saved": len(save_ms),
            "peak_memory_bytes": peak, "k4_launches": k4_launches, "capture_warmups": captures,
            "eval_capture_warmups": eval_captures, "evaluation": evaluation,
            "history": history, "best_epoch": best_epoch, "best_step": best_step, "returned_best": returned_best,
            "test": dict(test_metrics), "test_k4_launches": offline["k4_launches"],
        }
        record["notebook"] = notebook
        emit("lifecycle", run="notebook", **notebook)
        del trainer, trace_state
        release()

        # (c) preempted mid-epoch 2, then resumed
        at = 2 * steps_per_epoch + steps_per_epoch // 2
        signal_at = SignalAtStep(at, sig=signal.SIGTERM)

        def preempted(epoch):
            source.set_epoch(epoch)
            return signal_at.wrap(source)

        trainer_c, mid, manager_c, recorder_c, _, _, _, _ = notebook_run(root / "c", preempted)
        preempt = recorder_c.named("on_preemption")
        if not signal_at.raised or len(preempt) != 1 or mid.step >= steps:
            raise AssertionError(f"lifecycle: the preemption did not stop the run (step {mid.step})")
        stopped_at = mid.step
        del trainer_c, mid
        trainer_r, resumed, manager_r, _, resume_wall, _, _, _ = notebook_run(root / "c", source, resume=True)
        resumed_final = root / "c" / f"step_{manager_r.latest_step()}.npz"
        resume = {
            "signal_at_batch": at, "stopped_at_step": stopped_at, "resume_wall_s": resume_wall,
            "state_equal": state_equal(resumed, best), "history_equal": trainer_r.history == history,
            "best_step_equal": manager_r.best_step() == best_step,
            "final_checkpoint_equal": manager_r.latest_step() == final_step and checkpoint_leaves_equal(resumed_final, final_files),
        }
        record["preempt_resume"] = resume
        emit("lifecycle", run="preempt_resume", **resume)
        del trainer_r, resumed
        release()
        if not all(resume[k] for k in ("state_equal", "history_equal", "best_step_equal", "final_checkpoint_equal")):
            raise AssertionError(f"lifecycle: the resumed run differs from the uninterrupted one: {resume}")

        # (d) recovery: a run of NaN batches trips the policy, one epoch
        source.set_epoch(0)
        injector = NaNInjector(at_steps=range(NB_BAD_FROM, NB_BAD_FROM + NB_BAD_STEPS))
        trainer = make_trainer()
        recorder = FitEvents()
        recovered = trainer.fit(
            lambda: injector.wrap(float_target(b) for b in source), epochs=1,
            state=trainer.init_state(None, params=initial), scan_chunk=NB_SCAN_K, device_feed=True,
            checkpoint_manager=CheckpointManager(str(root / "d"), max_to_keep=3), checkpoint_every=NB_CHECKPOINT_EVERY,
            recovery=RecoveryPolicy(max_consecutive_bad=NB_MAX_BAD, max_restarts=2, lr_backoff=0.5),
            loggers=recorder, **fit_kwargs,
        )
        recoveries = recorder.named("on_recovery")
        anomalies = recorder.named("on_anomaly")
        recovery = {
            "injected_at": [injector.injected_at[0], injector.injected_at[-1]], "anomalies": len(anomalies),
            "first_anomaly_step": anomalies[0].step if anomalies else None,
            "recoveries": [e.payload for e in recoveries], "lr_scale": trainer._lr_scale,
            "train_loss": trainer.history[-1]["train_loss"], "finite": bool(torch.isfinite(recovered.flat_params).all()),
            "bad_steps": int(recovered.bad_steps),
        }
        record["recovery"] = recovery
        emit("lifecycle", run="recovery", **recovery)
        del trainer, recovered
        release()
        if (
            len(recoveries) != 1 or recoveries[0].payload["reason"] != "consecutive_bad_steps"
            or recoveries[0].payload["lr_scale"] != 0.5 or len(anomalies) < NB_MAX_BAD
            or recoveries[0].payload["restored_step"] != NB_CHECKPOINT_EVERY
            or not recovery["finite"] or not math.isfinite(recovery["train_loss"])
        ):
            raise AssertionError(f"lifecycle: the recovery run did not roll back as it should: {recovery}")

    # (f) one epoch on K1–K3: CEFused for CE
    wrappers = (fc.fused_lse_forward, fc.fused_lse_dh, fc.fused_lse_dw)
    reset_counts(*wrappers)
    trainer = make_trainer(CEFused)
    fused_state = trainer.fit(
        source, epochs=1, state=trainer.init_state(None, params=initial), scan_chunk=NB_SCAN_K, device_feed=True,
        **fit_kwargs,
    )
    torch.cuda.synchronize()
    steps = steps_per_epoch + trainer.capture_warmups
    fused = {fn.__name__: fn.launches for fn in wrappers}
    cefused = {
        "launches": fused, "variants": fused_variant_counts(fc), "capture_warmups": trainer.capture_warmups,
        "history": list(trainer.history), "finite": bool(torch.isfinite(fused_state.flat_params).all()),
    }
    record["cefused"] = cefused
    emit("lifecycle", run="cefused_epoch", **cefused)
    del trainer, fused_state
    release()
    if any(n != steps for n in fused.values()) or not cefused["finite"]:
        raise AssertionError(f"lifecycle: the CEFused epoch launched K1-K3 {fused} times, not {steps} each")
    check_fused_variants("the lifecycle's CEFused epoch", cefused["variants"], steps)

    # the evaluation top-k at notebook 09's and at BERT4Rec's catalog width
    record["top_k"] = top_k_times(device, (("notebook", NB_BATCH, items, max(NB_TOP_K)), ("bert4rec", 512, 27278, max(NB_TOP_K))))
    emit("lifecycle", run="top_k", cases=record["top_k"])
    return record


class SigtermAt:
    """A batch source that raises a real SIGTERM while batch ``at`` of its
    first iteration is fetched, and forwards the streaming protocol
    (``set_epoch``, the cursor calls, ``scan_compatible``) so that ``fit``
    still records and seeks the stream cursor."""

    def __init__(self, inner, at: int) -> None:
        self.inner, self.at, self.raised = inner, at, False

    def __iter__(self):
        import signal

        for position, batch in enumerate(self.inner):
            if position == self.at and not self.raised:
                self.raised = True
                signal.raise_signal(signal.SIGTERM)
            yield batch

    def set_epoch(self, epoch: int) -> None:
        self.inner.set_epoch(epoch)

    @property
    def supports_cursor(self) -> bool:
        return self.inner.supports_cursor

    def cursor_for(self, k: int):
        return self.inner.cursor_for(k)

    def restore_cursor(self, cursor) -> None:
        self.inner.restore_cursor(cursor)

    @property
    def scan_compatible(self) -> bool:
        return True


def stream_chunks(stream, epoch: int):
    """``bench_suite.py::run_stream``'s chunks: full groups of
    ``STREAM_SCAN_K`` transformed batches of one epoch, the rest dropped."""
    stream.set_epoch(epoch)
    chunk = []
    for batch in stream:
        chunk.append(batch)
        if len(chunk) == STREAM_SCAN_K:
            yield chunk
            chunk = []


def stream_tokens(batch) -> tuple:
    """Real tokens, grid tokens and user sequences of a transformed batch's
    valid rows, as ``bench_suite.py::run_stream`` counts them."""
    mask, valid = np.asarray(batch["padding_mask"]), np.asarray(batch["valid"])
    if "segment_ids" in batch:
        sequences = int((np.diff(np.asarray(batch["segment_ids"])[valid], prepend=0) > 0).sum())
    else:
        sequences = int(valid.sum())
    return int(mask[valid].sum()), mask.size, sequences


def stream_host_ms(batcher, pipeline, epoch: int) -> dict:
    """Host ms per batch over one epoch, the batcher's assembly (for the
    packed batcher, after the epoch's packing, timed apart) and the
    transforms apart."""
    batcher.set_epoch(epoch)
    record = {}
    if hasattr(batcher, "packing_summary"):
        t0 = time.perf_counter()
        len(batcher)  # packs the epoch (cached for the iteration)
        record["pack_ms_per_epoch"] = (time.perf_counter() - t0) * 1e3
    assembly, transforms = [], []
    iterator = iter(batcher)
    while True:
        t0 = time.perf_counter()
        raw = next(iterator, None)
        t1 = time.perf_counter()
        if raw is None:
            break
        pipeline(raw)
        assembly.append((t1 - t0) * 1e3)
        transforms.append((time.perf_counter() - t1) * 1e3)
    record.update(
        batches=len(assembly), assembly_ms=statistics.median(assembly), transforms_ms=statistics.median(transforms),
        assembly_ms_mean=statistics.fmean(assembly),
    )
    return record


def stream_row(name, trainer, initial, stream, counters) -> tuple:
    """One row of ``bench_suite.py::run_stream``: a warm-up epoch (the graph's
    capture), then whole epochs of full K-step chunks through
    ``prefetch(depth=2)`` until ``STREAM_MIN_STEPS`` steps, timed on the host
    clock; the counters set to 0 before the timed epochs and read after;
    then device time per step from a warm trace of two chunk replays, whose
    kernels must equal the launches counted."""
    from replay_tpu_torch.data.nn import prefetch

    state = trainer.init_state(None, params=initial)
    for chunk in prefetch(stream_chunks(stream, 0), depth=2):
        state, _ = trainer.train_steps(state, chunk)
    torch.cuda.synchronize()
    reset_counts(*counters)
    steps = epochs = real = grid = sequences = 0
    losses = []
    t0 = time.perf_counter()
    while steps < STREAM_MIN_STEPS or epochs < 2:
        epochs += 1
        for chunk in prefetch(stream_chunks(stream, epochs), depth=2):
            state, chunk_losses = trainer.train_steps(state, chunk)
            losses.extend(chunk_losses.tolist())
            steps += len(chunk)
            for batch in chunk:
                counts = stream_tokens(batch)
                real, grid, sequences = real + counts[0], grid + counts[1], sequences + counts[2]
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    last_chunk = chunk
    readings = []
    for _ in range(TRACES_AT_MOST):
        state, reading = traced_chunks(trainer, state, last_chunk, 2, counters)
        readings.append(reading)
        if reading["traced"] == reading["launched"] and reading["device_ms"] <= reading["event_ms"]:
            break
    else:
        raise AssertionError(f"{name}: no trace of K={STREAM_SCAN_K} replays agrees with the counts: {readings}")
    device_ms = reading["device_ms"] / (2 * STREAM_SCAN_K)
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"{name}: non-finite losses")
    record = {
        "row": name, "steps": steps, "epochs": epochs, "wall_s": elapsed,
        "samples_per_s": sequences / elapsed, "step_ms": elapsed / steps * 1e3,
        "effective_tokens_per_s": real / elapsed, "padding_fraction": 1.0 - real / grid,
        "sequences": sequences, "device_ms_per_step": device_ms, "device_busy_share": device_ms * steps / (elapsed * 1e3),
        "kernels_per_step": reading["kernels"] / (2 * STREAM_SCAN_K), "launches": launches,
        "traced_kernels": reading["traced"], "traces": len(readings),
        "top_kernels_ms_per_step": {k: v / (2 * STREAM_SCAN_K) for k, v in reading["top_kernels_ms"].items()},
        "first_loss": losses[0], "last_loss": losses[-1],
    }
    return state, record


def stream_leakage(model, batch, padding_value: int) -> dict:
    """No leakage across packed segments, on the card: (a) every row's first
    segment rewritten (its items shifted by one id) leaves every other
    segment's hidden states unchanged, and moves its own; the same check
    without ``segment_ids`` (a plain causal mask) is the control, which must
    show the leak; (b) the first segment (row offset 0) gives the hidden
    states of the same sequence alone in its row. Bitwise where the card
    holds it, else within ``STREAM_LEAK_TOL``."""
    items = batch["feature_tensors"]["item_id"]
    padding, segments = batch["padding_mask"], batch["segment_ids"]
    first = segments == 1
    shifted = torch.where(first, items % (NUM_ITEMS - 1) + 1, items)

    def hidden(ids, mask, seg):
        with torch.no_grad():
            return model({"item_id": ids}, mask, deterministic=True, segment_ids=seg).float()

    others = (segments > 1) & padding
    base, moved = hidden(items, padding, segments), hidden(shifted, padding, segments)
    leak = (base - moved)[others].abs().max().item()
    own = (base - moved)[first & padding].abs().max().item()
    control_base, control_moved = hidden(items, padding, None), hidden(shifted, padding, None)
    control = (control_base - control_moved)[others].abs().max().item()
    solo_ids = torch.where(first, items, torch.full_like(items, padding_value))
    solo = hidden(solo_ids, padding & first, first.to(segments.dtype))
    solo_diff = (base - solo)[first & padding].abs().max().item()
    record = {
        "rows": int(items.shape[0]), "segments": int(segments.max(dim=1).values.sum()),
        "neighbour_bitwise": leak == 0.0, "neighbour_max_abs_diff": leak, "own_segment_moved_by": own,
        "control_max_abs_diff": control, "control_caught": control > STREAM_LEAK_TOL,
        "solo_bitwise": solo_diff == 0.0, "solo_max_abs_diff": solo_diff, "tol": STREAM_LEAK_TOL,
    }
    if leak > STREAM_LEAK_TOL or solo_diff > STREAM_LEAK_TOL or own == 0.0 or not record["control_caught"]:
        raise AssertionError(f"stream: packed segments leak on the card: {record}")
    return record


def stream_fused_vs_ce(make_trainer, initial, batches, counters) -> dict:
    """``STREAM_LOSS_STEPS`` eager steps of the packed row with ``CEFused``
    (K1–K3 on bf16 hidden states) and with ``CE`` from the same weights: the
    first step's losses within ``STREAM_FUSED_FIRST_RTOL``, every step's
    within ``STREAM_FUSED_RTOL``; K1–K3 counted from 0 over the fused steps."""
    from replay_tpu_torch.nn.loss import CE, CEFused

    losses = {}
    for name, loss in (("ce", CE()), ("cefused", CEFused())):
        trainer = make_trainer(loss)
        state = trainer.init_state(None, params=initial)
        if name == "cefused":
            reset_counts(*counters)
        values = [trainer.train_step(state, batches[i % len(batches)])[1] for i in range(STREAM_LOSS_STEPS)]
        torch.cuda.synchronize()
        losses[name] = [float(v) for v in values]
        del trainer, state
    launches = {fn.__name__: fn.launches for fn in counters}
    rel = [abs(a - b) / abs(b) for a, b in zip(losses["cefused"], losses["ce"])]
    record = {
        "steps": STREAM_LOSS_STEPS, "first_rel_diff": rel[0], "max_rel_diff": max(rel), "rel_diff": rel,
        "first_tol": STREAM_FUSED_FIRST_RTOL, "tol": STREAM_FUSED_RTOL, "launches": launches,
        "variants": {fn.__name__: variant_counts(fn) for fn in counters},
    }
    if rel[0] > STREAM_FUSED_FIRST_RTOL or max(rel) > STREAM_FUSED_RTOL:
        raise AssertionError(f"stream: CEFused vs CE on packed batches: {record}")
    if any(n != STREAM_LOSS_STEPS for n in launches.values()):
        raise AssertionError(f"stream: K1–K3 launches {launches} for {STREAM_LOSS_STEPS} fused steps")
    return record


def stream_preempt_resume(make_trainer, initial, make_source, root) -> dict:
    """The parquet row's ``fit(scan_chunk=K)`` over two epochs, uninterrupted;
    the same with a SIGTERM while batch ``STREAM_PREEMPT_AT`` of epoch 0 is
    fetched and a checkpoint manager; then ``fit(resume=True)``: bitwise the
    uninterrupted state and history, the resumed epoch's slabs read from the
    cursor's on, each once."""
    from replay_tpu_torch.nn.loss import CE
    from replay_tpu_torch.utils import CheckpointManager

    trainer_a = make_trainer(CE())
    _, stream_a = make_source()
    state_a = trainer_a.fit(stream_a, epochs=2, state=trainer_a.init_state(None, params=initial), scan_chunk=STREAM_SCAN_K, log_every=0)
    trainer_b = make_trainer(CE())
    _, stream_b = make_source()
    interrupted = SigtermAt(stream_b, STREAM_PREEMPT_AT)
    manager = CheckpointManager(str(root / "stream"), max_to_keep=100)
    state_b = trainer_b.fit(
        interrupted, epochs=2, state=trainer_b.init_state(None, params=initial), scan_chunk=STREAM_SCAN_K,
        log_every=0, checkpoint_manager=manager,
    )
    meta = manager.metadata(manager.latest_step())
    cursor = meta.get("stream_cursor") or {}
    stopped = state_b.step
    del trainer_b, state_b
    trainer_c = make_trainer(CE())
    batcher_c, stream_c = make_source()
    reads = []
    read = batcher_c._read_slab
    batcher_c._read_slab = lambda path, slab: reads.append((slab.group, slab.start)) or read(path, slab)
    t0 = time.perf_counter()
    state_c = trainer_c.fit(stream_c, epochs=2, scan_chunk=STREAM_SCAN_K, log_every=0, checkpoint_manager=manager, resume=True)
    resume_s = time.perf_counter() - t0
    plans = [[(s.group, s.start) for s in batcher_c._plan(epoch)[0]] for epoch in (0, 1)]
    record = {
        "signal_at_batch": STREAM_PREEMPT_AT, "raised": interrupted.raised, "stopped_at_step": stopped,
        "checkpoint": {k: meta.get(k) for k in ("epoch", "step_in_epoch", "preempted", "mid_epoch")},
        "cursor": {k: cursor.get(k) for k in ("epoch", "slab", "rows", "batches")},
        "slabs_per_epoch": [len(p) for p in plans], "slabs_read_on_resume": len(reads),
        "reads_from_cursor_only": bool(cursor) and reads == plans[0][cursor["slab"] :] + plans[1],
        "state_equal": state_equal(state_c, state_a), "history_equal": trainer_c.history == trainer_a.history,
        "steps": state_a.step, "resume_s": resume_s,
    }
    emit("stream", run="preempt_resume", **record)
    checks = ("raised", "reads_from_cursor_only", "state_equal", "history_equal")
    if not all(record[k] for k in checks) or not meta.get("mid_epoch") or cursor.get("slab", 0) < 1:
        raise AssertionError(f"stream: the preempted parquet fit did not resume as the uninterrupted one: {record}")
    return record


def stream_phase(device) -> dict:
    """``bench_suite.py::run_stream``'s rows on the port at their full widths
    (``STREAM_*``, bf16 compute, the unfused attention route: the kernel
    routes refuse segments): ``stream_inmem`` (``SequenceBatcher``),
    ``stream_packed`` (``PackedSequenceBatcher``, segment masks),
    ``stream_parquet`` (``write_sequence_parquet`` → ``ParquetBatcher``, where
    pyarrow imports) and ``stream_packed_fused`` (the packed row with
    ``CEFused``: K1–K3 on bf16 hidden states), each through
    ``TransformedBatches`` and ``prefetch`` into K=8 ``train_steps`` graphs;
    one line a row. Then the checks: the K=8 graphs of the packed rows
    bitwise the per-step path (``chunk_checks``), no leakage across segments,
    ``CEFused`` against ``CE`` over 20 packed steps, and the parquet row's
    preemption and cursor resume."""
    import tempfile
    from pathlib import Path

    from replay_tpu_torch.data import FeatureHint, FeatureType
    from replay_tpu_torch.device import to_device
    from replay_tpu_torch.data.nn import (
        PackedSequenceBatcher,
        ParquetBatcher,
        SequenceBatcher,
        SequentialDataset,
        TensorFeatureInfo,
        TensorSchema,
        TransformedBatches,
        write_sequence_parquet,
    )
    from replay_tpu_torch.nn.loss import CE, CEFused
    from replay_tpu_torch.nn.sequential.sasrec import SasRec
    from replay_tpu_torch.nn.train import OptimizerFactory, Trainer
    from replay_tpu_torch.nn.transform import Compose, make_default_sasrec_transforms, make_packed_sasrec_transforms
    from replay_tpu_torch.ops import fused_ce as fc

    started = time.perf_counter()
    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
            cardinality=NUM_ITEMS, embedding_dim=EMBEDDING_DIM,
        )
    )
    rng = np.random.default_rng(0)
    lengths = rng.integers(2, max(3, SEQ_LEN // 2), size=STREAM_SEQUENCES)
    sequences = [rng.integers(1, NUM_ITEMS, n).astype(np.int64) for n in lengths]
    dataset = SequentialDataset(
        schema, "query_id", "item_id", {"query_id": np.arange(STREAM_SEQUENCES), "item_id": sequences}
    )
    width = dict(
        embedding_dim=EMBEDDING_DIM, num_blocks=NUM_BLOCKS, num_heads=NUM_HEADS, max_sequence_length=SEQ_LEN,
        dropout_rate=0.0, use_flash=False, device=device,
    )
    initial = {
        name: value.detach().clone()
        for name, value in SasRec(schema, generator=torch.Generator().manual_seed(SEED), **width).state_dict().items()
    }

    def make_trainer(loss):
        trainer = Trainer(
            SasRec(schema, **width), loss, optimizer=OptimizerFactory(name="adam", learning_rate=1e-3),
            precision="bf16", device=device,
        )
        if trainer.model.dtype != torch.bfloat16:
            raise AssertionError("stream: precision='bf16' did not reach the model")
        return trainer

    pipes = {
        "default": Compose(make_default_sasrec_transforms(schema)["train"]),
        "packed": Compose(make_packed_sasrec_transforms(schema)["train"]),
    }
    batcher_kwargs = dict(batch_size=TRAIN_BATCH, max_sequence_length=SEQ_LEN + 1, shuffle=True, seed=0)
    parquet_meta = {"item_id": {"shape": SEQ_LEN + 1, "padding": 0}}
    fused = (fc.fused_lse_forward, fc.fused_lse_dh, fc.fused_lse_dw)
    record = {"sequences": STREAM_SEQUENCES, "mean_length": float(lengths.mean())}
    try:
        import pyarrow
    except ImportError as exc:
        pyarrow = None
        emit(
            "stream", row="stream_parquet", run=False,
            reason=f"pyarrow does not import on this machine ({type(exc).__name__}: {exc}): the parquet row "
            "and its preemption check were not run",
        )
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stream_") as tmp:
        root = Path(tmp)
        rows = [
            ("stream_inmem", lambda: SequenceBatcher(dataset, **batcher_kwargs), "default", CE(), ()),
            ("stream_packed", lambda: PackedSequenceBatcher(dataset, **batcher_kwargs), "packed", CE(), ()),
            ("stream_packed_fused", lambda: PackedSequenceBatcher(dataset, **batcher_kwargs), "packed", CEFused(), fused),
        ]
        if pyarrow is not None:
            path = str(root / "stream.parquet")
            t0 = time.perf_counter()
            write_sequence_parquet(path, dataset, rows_per_chunk=TRAIN_BATCH)
            record["parquet"] = {
                "write_s": time.perf_counter() - t0, "bytes": Path(path).stat().st_size, "pyarrow": pyarrow.__version__,
            }

            def parquet_source():
                batcher = ParquetBatcher(
                    path, batch_size=TRAIN_BATCH, shuffle=True, seed=0, shard="row_groups", read_ahead=2,
                    memory_budget_bytes=8 << 20, metadata=parquet_meta,
                )
                return batcher, TransformedBatches(batcher, pipes["default"])

            rows.insert(1, ("stream_parquet", lambda: parquet_source()[0], "default", CE(), ()))
        emit("stream", run="data", **record)
        results = {}
        for name, make_batcher, pipe, loss, counters in rows:
            batcher = make_batcher()
            host = stream_host_ms(batcher, pipes[pipe], 0)
            if hasattr(batcher, "packing_summary"):
                host["packing_summary"] = batcher.packing_summary()
            trainer = make_trainer(loss)
            state, row = stream_row(name, trainer, initial, TransformedBatches(batcher, pipes[pipe]), counters)
            row["host_ms_per_batch"] = host
            row["segments_per_row"] = host.get("packing_summary", {}).get("segments_per_row", 1.0)
            results[name] = row
            emit("stream", **row)
            del trainer, state
            release()
        record["rows"] = results

        # the packed rows' K=8 graphs against the per-step path (and fit(scan_chunk=8))
        packed = [pipes["packed"](b) for b in PackedSequenceBatcher(dataset, **batcher_kwargs)]
        tokens = TRAIN_BATCH * SEQ_LEN
        checks = {}
        for name, loss, counters in (("stream_packed", CE(), ()), ("stream_packed_fused", CEFused(), fused)):
            trainer = make_trainer(loss)
            checks[name] = chunk_checks(
                trainer, initial, packed, STREAM_SCAN_K, counters, {fn.__name__: 1 for fn in counters}, tokens
            )
            emit("stream", run="chunk_checks", row=name, **checks[name])
            if name == "stream_packed":
                leak = stream_leakage(
                    trainer.model, to_device(packed[0], device), schema["item_id"].padding_value
                )
            del trainer
            release()
        record["chunk_checks"] = checks
        record["leakage"] = leak
        emit("stream", run="leakage", **leak)
        record["fused_vs_ce"] = stream_fused_vs_ce(make_trainer, initial, packed, fused)
        emit("stream", run="fused_vs_ce", **record["fused_vs_ce"])
        release()
        if pyarrow is not None:
            record["preempt_resume"] = stream_preempt_resume(make_trainer, initial, parquet_source, root)
            release()
    record["phase_s"] = time.perf_counter() - started
    emit("stream", run="phase", phase_s=record["phase_s"], parquet_run=pyarrow is not None)
    return {
        "record": record,
        "fused_eager": record["fused_vs_ce"]["launches"],
        "fused_graph": results["stream_packed_fused"]["launches"],
    }


class SigtermList:
    """A list of batches, iterable once an epoch, that raises a real SIGTERM
    while batch ``at`` (counted over every iteration) is fetched."""

    def __init__(self, batches, at: int) -> None:
        self.batches, self.at, self.fetched, self.raised = list(batches), at, 0, False

    def __iter__(self):
        import signal

        for batch in self.batches:
            if self.fetched == self.at and not self.raised:
                self.raised = True
                signal.raise_signal(signal.SIGTERM)
            self.fetched += 1
            yield batch


def scale_batch(num_items: int, seed: int, negatives: int = 0):
    """``bench_suite.py::sasrec_batch`` at the scale width: full windows of
    L + 1 items from default_rng(seed), and a shared pool of ``negatives``
    sampled ids where the loss takes one."""
    rng = np.random.default_rng(seed)
    items = rng.integers(0, num_items, size=(SCALE_BATCH, SEQ_LEN + 1)).astype(np.int32)
    mask = np.ones((SCALE_BATCH, SEQ_LEN), dtype=bool)
    batch = {
        "feature_tensors": {"item_id": items[:, :-1]},
        "padding_mask": mask,
        "positive_labels": items[:, 1:, None],
        "target_padding_mask": mask[:, :, None],
    }
    if negatives:
        batch["negative_labels"] = rng.integers(0, num_items, size=(negatives,)).astype(np.int32)
    return batch


def scale_loss(kind: str, num_items: int):
    from replay_tpu_torch.nn.loss import GBCE, SCE, CEFused, SCEParams

    if kind == "sce":
        return SCE(SCEParams(**SCALE_SCE))
    if kind == "gbce":
        return GBCE(catalog_size=num_items, t=0.75)
    return CEFused()


def scale_preempt_resume(make_trainer, initial, batches, root) -> dict:
    """The SCE trainer's ``fit(scan_chunk=K)`` over two epochs, uninterrupted;
    the same with a SIGTERM while batch ``SCALE_PREEMPT_AT`` is fetched and a
    checkpoint manager; then ``fit(resume=True)``: the resumed state (its
    projection stream in ``rng`` too) and history bitwise the uninterrupted
    run's."""
    from replay_tpu_torch.utils.checkpoint import CheckpointManager

    fit = dict(epochs=2, scan_chunk=SCALE_SCAN_K, log_every=0)
    trainer_a = make_trainer()
    state_a = trainer_a.fit(batches, state=trainer_a.init_state(batches[0], params=initial), **fit)
    trainer_b = make_trainer()
    interrupted = SigtermList(batches, SCALE_PREEMPT_AT)
    manager = CheckpointManager(str(root / "sce"), max_to_keep=100)
    state_b = trainer_b.fit(
        interrupted, state=trainer_b.init_state(batches[0], params=initial), checkpoint_manager=manager, **fit
    )
    stopped = state_b.step
    meta = manager.metadata(manager.latest_step())
    del trainer_b, state_b
    trainer_c = make_trainer()
    state_c = trainer_c.fit(batches, checkpoint_manager=manager, resume=True, **fit)
    record = {
        "signal_at_batch": SCALE_PREEMPT_AT, "raised": interrupted.raised, "stopped_at_step": stopped,
        "checkpoint": {k: meta.get(k) for k in ("epoch", "step_in_epoch", "preempted", "mid_epoch")},
        "state_equal": state_equal(state_c, state_a), "history_equal": trainer_c.history == trainer_a.history,
        "steps": state_a.step,
    }
    if not (record["raised"] and record["state_equal"] and record["history_equal"] and 0 < stopped < state_a.step):
        raise AssertionError(f"scale: the preempted SCE fit did not resume as the uninterrupted one: {record}")
    return record


def scale_row(name: str, num_items: int, kind: str, negatives: int, device, root) -> dict:
    """One catalog-scaling row: the bf16 SASRec at E=128 with the row's loss.
    The main path (each kernel counted from 0): ``SCALE_STEPS`` eager steps
    from the seed, K4 twice a step and, for CEFused, K1–K3 once each. SCE:
    the same seed repeats its losses bitwise, another seed does not, and a
    preempted fit resumes bitwise. gBCE: one health step whose logits stats
    stream over the 1M-row table. Then step times, device time and memory
    (``trainer_perf``) and the K=8 graphs against the per-step path
    (``chunk_checks``), which must be bitwise."""
    from replay_tpu_torch.data import FeatureHint, FeatureType
    from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema
    from replay_tpu_torch.nn.sequential.sasrec import SasRec
    from replay_tpu_torch.nn.train import OptimizerFactory, Trainer
    from replay_tpu_torch.obs.health import HealthConfig
    from replay_tpu_torch.ops import fused_ce as fc
    from replay_tpu_torch.ops.flash_attention import flash_attention

    started = time.perf_counter()
    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
            cardinality=num_items, embedding_dim=SCALE_DIM,
        )
    )
    width = dict(
        embedding_dim=SCALE_DIM, num_blocks=SCALE_BLOCKS, num_heads=SCALE_HEADS, max_sequence_length=SEQ_LEN,
        dropout_rate=0.0, use_flash=True, device=device,
    )
    initial = {
        key: value.detach().clone()
        for key, value in SasRec(schema, generator=torch.Generator().manual_seed(SEED), **width).state_dict().items()
    }
    fused = (fc.fused_lse_forward, fc.fused_lse_dh, fc.fused_lse_dw) if kind == "fused" else ()
    counters = (flash_attention, *fused)
    per_step = {"flash_attention": SCALE_BLOCKS, **{fn.__name__: 1 for fn in fused}}

    def make_trainer(seed=SEED, **kwargs):
        trainer = Trainer(
            SasRec(schema, **width), scale_loss(kind, num_items),
            optimizer=OptimizerFactory(name="adam", learning_rate=1e-3), precision="bf16", seed=seed,
            device=device, **kwargs,
        )
        if trainer.model.dtype != torch.bfloat16:
            raise AssertionError(f"{name}: precision='bf16' did not reach the model")
        return trainer

    batches = [scale_batch(num_items, seed, negatives) for seed in range(SCALE_BATCHES)]
    tokens = SCALE_BATCH * SEQ_LEN

    # the main path: eager steps from the seed, every kernel counted from 0
    trainer = make_trainer()
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts(*counters)
    state = trainer.init_state(batches[0], params=initial)
    losses = [trainer.train_step(state, batch)[1] for batch in batches[:SCALE_STEPS]]
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    variants = fused_variant_counts(fc) if fused else None
    losses = [float(x) for x in losses]
    expected = {key: count * SCALE_STEPS for key, count in per_step.items()}
    if launches != expected or not all(math.isfinite(x) for x in losses) or int(state.bad_steps):
        raise AssertionError(f"{name}: launches {launches} (expected {expected}), losses {losses}")
    if fused:
        check_fused_variants(name, variants, SCALE_STEPS)
    record = {
        "row": name, "items": num_items, "loss": type(trainer.loss).__name__, "negatives": negatives,
        "losses": losses, "launches": launches, "variants": variants,
        "max_memory_allocated_steps_bytes": torch.cuda.max_memory_allocated(device),
    }
    if kind == "sce":
        repeats = {}
        for seed in (SEED, SEED + 1):
            again = make_trainer(seed)
            again_state = again.init_state(batches[0], params=initial)
            repeats[seed] = [float(again.train_step(again_state, b)[1]) for b in batches[:SCALE_STEPS]]
            del again, again_state
        record.update(seed_repeats=repeats[SEED] == losses, other_seed_losses=repeats[SEED + 1])
        if repeats[SEED] != losses or repeats[SEED + 1] == losses:
            raise AssertionError(f"{name}: the projection does not follow the seed: {losses} vs {repeats}")
    if kind == "gbce":
        # one health step: the logits stats stream over the 1M-row table
        health = make_trainer(health=HealthConfig(cadence=1, attention_entropy=False, activation_stats=False))
        health_state = health.init_state(batches[0], params=initial)
        health.train_step(health_state, batches[0])
        got = health.last_step_metrics["health"]
        record["health"] = {
            "logits": {key: float(value) for key, value in got["logits"].items()},
            "embedding_coverage": float(got["embedding_coverage"]),
            "grad_norm_global": float(got["grad_norm_global"]),
        }
        # the rows the batch touches: its input ids, labels and negatives
        touched = np.unique(np.concatenate([batches[0][key].reshape(-1) for key in ("positive_labels", "negative_labels")]
                                           + [batches[0]["feature_tensors"]["item_id"].reshape(-1)]))
        record["health"]["coverage_bound"] = (len(touched) + 1) / (num_items + 1)
        stats = record["health"]["logits"]
        if set(stats) != {"mean", "absmax", "std"} or not all(math.isfinite(v) for v in stats.values()) or not (
            0.0 < record["health"]["embedding_coverage"] <= record["health"]["coverage_bound"]
        ):
            raise AssertionError(f"{name}: the streamed health record is wrong: {record['health']}")
        del health, health_state
    release()
    _, record["perf"] = trainer_perf(
        trainer, state, batches[0], SCALE_TIMED_STEPS, SCALE_WARMUP_STEPS, SCALE_PROFILED_STEPS, tokens
    )
    record["chunked"] = chunk_checks(trainer, initial, batches, SCALE_SCAN_K, counters, per_step, tokens)
    if not record["chunked"]["per_step_bitwise_deterministic"] or not record["chunked"]["fit_bitwise_deterministic"]:
        raise AssertionError(f"{name}: the per-step path is not bitwise repeatable: {record['chunked']}")
    del trainer, state
    release()
    if kind == "sce":
        record["preempt_resume"] = scale_preempt_resume(make_trainer, initial, batches, root)
        release()
    record["row_s"] = time.perf_counter() - started
    perf, chunked = record["perf"], record["chunked"]["perf"]
    emit(
        "scale", row=name, items=num_items, loss=record["loss"], losses=losses, launches=launches,
        eager_p50_ms=perf["p50_ms"], graph_step_ms=chunked["train_steps_ms_per_step"],
        device_ms_per_step=perf["device_ms"], graph_device_ms_per_step=chunked["device_ms_per_step"],
        kernels_per_step=perf["kernels_per_step"], copies_per_step=perf["copies_per_step"],
        max_memory_allocated_bytes=max(perf["max_memory_allocated_bytes"], chunked["max_memory_allocated_bytes"]),
        row_s=record["row_s"], record=record,
    )
    return record


def scale_phase(device) -> dict:
    """bench_suite.py's catalog-scaling rows on the port (``SCALE_ROWS``),
    one line a row, then the phase's seconds."""
    import tempfile
    from pathlib import Path

    started = time.perf_counter()
    rows = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_scale_") as tmp:
        for name, num_items, kind, negatives in SCALE_ROWS:
            rows[name] = scale_row(name, num_items, kind, negatives, device, Path(tmp))
    phase_s = time.perf_counter() - started
    emit("scale", run="phase", phase_s=phase_s)
    fused = rows["sasrec_100k_fused"]
    return {
        "rows": rows, "phase_s": phase_s,
        "k4": {name: row["launches"]["flash_attention"] for name, row in rows.items()},
        "k4_graph": {name: row["chunked"]["launches"]["flash_attention"] for name, row in rows.items()},
        "fused_eager": fused["launches"], "fused_graph": fused["chunked"]["launches"],
    }


# --------------------------------------------------------------------------- #
# continual: bench_continual.py's loop
# --------------------------------------------------------------------------- #
def continual_stream(rng):
    """``bench_continual.py::simulate_stream`` at ``CONT_*``: per-user, per-day
    interaction lists over a growing catalog (a noisy successor pattern), and
    the catalog of each day."""
    catalog = CONT_ITEMS
    events, catalog_by_day = [], []
    state = rng.integers(0, CONT_ITEMS, size=CONT_USERS)
    for day in range(CONT_DAYS):
        if day > 0 and CONT_GROW_EVERY > 0 and day % CONT_GROW_EVERY == 0:
            catalog += CONT_GROW_ITEMS
        catalog_by_day.append(catalog)
        day_events = []
        for user in range(CONT_USERS):
            items = []
            current = int(state[user])
            for _ in range(CONT_EVENTS_PER_DAY):
                if rng.random() < 0.2:
                    current = int(rng.integers(0, catalog))
                else:
                    current = (current * 3 + 7) % catalog
                items.append(current)
            state[user] = current
            day_events.append(items)
        events.append(day_events)
    return events, catalog_by_day


def continual_window(items, length: int):
    """A right-aligned window of the last ``length`` items, padded with 0."""
    window = np.zeros(length, np.int32)
    count = min(len(items), length)
    if count:
        window[length - count :] = np.asarray(items[-count:], np.int32)
    mask = np.zeros(length, bool)
    mask[length - count :] = True
    return window, mask


def continual_train_batches(histories, rng) -> list:
    """``bench_continual.py::train_batches``: fixed-shape next-item batches of
    each user's right-aligned window, shuffled, the last one padded with
    invalid rows."""
    users = [u for u, h in enumerate(histories) if len(h) >= 2]
    rng.shuffle(users)
    batches = []
    for start in range(0, len(users), CONT_BATCH):
        chunk = users[start : start + CONT_BATCH]
        windows = [continual_window(histories[user], CONT_LEN + 1) for user in chunk]
        ids = np.stack([w for w, _ in windows])
        mask = np.stack([m for _, m in windows])
        valid = np.zeros(CONT_BATCH, bool)
        valid[: len(chunk)] = True
        if len(chunk) < CONT_BATCH:
            pad = CONT_BATCH - len(chunk)
            ids = np.concatenate([ids, np.repeat(ids[:1], pad, 0)])
            mask = np.concatenate([mask, np.zeros((pad, CONT_LEN + 1), bool)])
        batches.append(
            {
                "feature_tensors": {"item_id": ids[:, :-1]},
                "padding_mask": mask[:, :-1],
                "positive_labels": ids[:, 1:, None],
                "target_padding_mask": (mask[:, :-1] & mask[:, 1:])[:, :, None],
                "valid": valid,
            }
        )
    return batches


def continual_eval_batches(histories, next_day_events) -> list:
    """``bench_continual.py::eval_batches``: each user's window against their
    first interaction of the next day."""
    rows = [
        (*continual_window(history, CONT_LEN), next_day_events[user][0])
        for user, history in enumerate(histories)
        if history and next_day_events[user]
    ]
    batches = []
    for start in range(0, len(rows), CONT_BATCH):
        part = rows[start : start + CONT_BATCH]
        ids = np.stack([r[0] for r in part])
        mask = np.stack([r[1] for r in part])
        truth = np.asarray([r[2] for r in part], np.int32)[:, None]
        valid = np.zeros(CONT_BATCH, bool)
        valid[: len(part)] = True
        if len(part) < CONT_BATCH:
            pad = CONT_BATCH - len(part)
            ids = np.concatenate([ids, np.repeat(ids[:1], pad, 0)])
            mask = np.concatenate([mask, np.repeat(mask[:1], pad, 0)])
            truth = np.concatenate([truth, np.repeat(truth[:1], pad, 0)])
        batches.append({"feature_tensors": {"item_id": ids}, "padding_mask": mask, "ground_truth": truth, "valid": valid})
    return batches


def host_state(state) -> dict:
    """A CPU copy of a train state's tensors and its parameter layout."""
    return {
        "flat": state.flat_params.detach().cpu().clone(),
        "opt": [{key: value.detach().cpu().clone() for key, value in link.items()} for link in state.opt_state],
        "rng": state.rng.clone(), "step": state.step, "bad_steps": state.bad_steps.detach().cpu().clone(),
        "layout": [(name, tuple(value.shape)) for name, value in state.params.items()],
    }


def table_rows(flat: torch.Tensor, layout, name: str) -> torch.Tensor:
    """The ``[rows, E]`` rows of parameter ``name`` in a flat buffer."""
    offset = 0
    for key, shape in layout:
        size = math.prod(shape)
        if key == name:
            return flat[offset : offset + size].view(shape)
        offset += size
    raise KeyError(name)


def resize_checks(resize: dict, make_trainer) -> dict:
    """One recorded resize of the continual trainer: the same resize of the
    same state on the CPU, bitwise; the item rows and every moment buffer's
    rows carried bitwise, the cold rows' moments zero, the padding row moved
    last; the captured programs dropped."""
    from replay_tpu_torch.nn.train import TrainState

    before, after, old, new = resize["before"], resize["after"], resize["old"], resize["new"]
    cpu = make_trainer(old, torch.device("cpu"))
    state = TrainState(
        step=before["step"], flat_params=before["flat"].clone(), params={},
        opt_state=[{key: value.clone() for key, value in link.items()} for link in before["opt"]],
        bad_steps=before["bad_steps"].clone(), rng=before["rng"].clone(),
    )
    grown = cpu.resize_vocabulary(state, new, **resize["kwargs"])
    same_as_cpu = torch.equal(grown.flat_params, after["flat"]) and all(
        torch.equal(a[key], b[key]) for a, b in zip(grown.opt_state, after["opt"]) for key in a
    )
    table = "body.embedder.embedding_item_id.table.weight"
    carried, cold_zero, padding_moved = True, True, True
    buffers = [("params", before["flat"], after["flat"])] + [
        (f"opt[{i}][{key}]", link[key], after["opt"][i][key])
        for i, link in enumerate(before["opt"]) for key in link if link[key].dim() == 1
    ]
    for label, old_flat, new_flat in buffers:
        old_rows, new_rows = table_rows(old_flat, before["layout"], table), table_rows(new_flat, after["layout"], table)
        carried &= bool(torch.equal(new_rows[:old], old_rows[:old]))
        padding_moved &= bool(torch.equal(new_rows[-1], old_rows[-1]))
        if label != "params":
            cold_zero &= not bool(new_rows[old:-1].any())
    record = {
        "old": old, "new": new, "resize_ms": resize["ms"], "same_as_cpu": same_as_cpu, "rows_carried": carried,
        "cold_moments_zero": cold_zero, "padding_row_moved": padding_moved, "programs_dropped": resize["dropped"],
        "moment_buffers": len(buffers) - 1,
    }
    if not all(record[k] for k in ("same_as_cpu", "rows_carried", "cold_moments_zero", "padding_row_moved",
                                  "programs_dropped")):
        raise AssertionError(f"continual: the resize is wrong: {record}")
    return record


def graph_equals_eager(trainer, state, batches) -> dict:
    """``train_steps`` on ``len(batches)`` batches (a graph captured for a
    copy of ``state``) against as many ``train_step`` calls on another copy:
    losses and parameters bitwise. The trainer is bound to ``state`` after."""
    from replay_tpu_torch.nn.train import _clone_state

    graph_state, eager_state = _clone_state(state), _clone_state(state)
    warmups = trainer.capture_warmups
    graph_state, graph_losses = trainer.train_steps(graph_state, batches)
    eager_losses = [float(trainer.train_step(eager_state, batch)[1]) for batch in batches]
    torch.cuda.synchronize()
    record = {
        "steps": len(batches), "captured": trainer.capture_warmups - warmups,
        "losses_bitwise": [float(x) for x in graph_losses] == eager_losses,
        "params_bitwise": bool(torch.equal(graph_state.flat_params, eager_state.flat_params)),
    }
    trainer._bind(state)
    if not (record["losses_bitwise"] and record["params_bitwise"] and record["captured"] == 1):
        raise AssertionError(f"continual: the K={len(batches)} graph differs from the eager steps: {record}")
    return record


def served_top10(service, trainer, state, histories, users) -> dict:
    """``CONT_SERVE_USERS`` requests to ``service`` against ``predict_top_k``
    on the same windows: ids equal at every rank clear of its neighbours by
    ``SERVE_TOL`` in ``predict_logits``' scores."""
    from replay_tpu_torch.serve.request import top_k_cut

    windows = [continual_window(histories[u], CONT_LEN) for u in users]
    batch = {
        "feature_tensors": {"item_id": np.stack([w for w, _ in windows])},
        "padding_mask": np.stack([m for _, m in windows]),
    }
    _, want_ids, _ = trainer.predict_top_k(state, [batch], k=CONT_TOPK)
    want_scores = trainer.predict_logits(state, batch)
    got = [service.score(f"user{u}", history=histories[u][-CONT_LEN:], timeout=60.0) for u in users]
    got_ids = np.stack([top_k_cut(response, CONT_TOPK)[0] for response in got])
    top = torch.topk(want_scores, CONT_TOPK + 1, dim=-1).values.cpu()
    gaps = top[:, :-1] - top[:, 1:]
    previous = torch.cat([torch.full_like(gaps[:, :1], math.inf), gaps[:, :-1]], dim=1)
    pinned = (torch.minimum(previous, gaps) > SERVE_TOL).numpy()
    record = {
        "users": len(users), "catalog": int(want_scores.shape[-1]),
        "scores_width": int(got[0].scores.shape[-1]), "pinned_ranks": int(pinned.sum()),
        "top10_equal_at_pinned": bool(np.array_equal(got_ids[pinned], want_ids[pinned])),
        "top10_equal": bool(np.array_equal(got_ids, want_ids)),
        "served_by": sorted({response.served_by for response in got}),
    }
    if not record["top10_equal_at_pinned"] or record["scores_width"] != record["catalog"] or record["served_by"] != ["primary"]:
        raise AssertionError(f"continual: the served grown generation differs from predict_top_k: {record}")
    return record


def continual_phase(device) -> dict:
    """bench_continual.py's loop on the port (``CONT_*``): each day the
    continual model runs ``Trainer.finetune`` on the day's tail (its catalog
    grown, moments carried, xavier cold rows) and a fresh model refits the
    whole history, both through ``fit(scan_chunk=32)`` on K4; both scored on
    the next day. Each resize is held to the same resize on the CPU and to
    the surgery's contract, its captured programs are dropped and captured
    anew, and a K=32 graph of the grown model equals 32 eager steps. The
    grown generation, published to a ``ScoringService`` built on the first
    day's model, takes the shape-change path and serves ``predict_top_k``'s
    top-10."""
    from replay_tpu_torch.data import FeatureHint, FeatureType
    from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema
    from replay_tpu_torch.nn.loss import CE
    from replay_tpu_torch.nn.sequential.sasrec import SasRec
    from replay_tpu_torch.nn.train import OptimizerFactory, Trainer
    from replay_tpu_torch.ops.flash_attention import flash_attention
    from replay_tpu_torch.serve import ScoringService

    started = time.perf_counter()
    events, catalog_by_day = continual_stream(np.random.default_rng(0))
    stream_s = time.perf_counter() - started

    def make_trainer(cardinality, on=device):
        schema = TensorSchema(
            TensorFeatureInfo(
                "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
                cardinality=cardinality, embedding_dim=CONT_DIM,
            )
        )
        model = SasRec(
            schema, embedding_dim=CONT_DIM, num_blocks=CONT_BLOCKS, num_heads=CONT_HEADS,
            max_sequence_length=CONT_LEN, dropout_rate=0.0, use_flash=True, device=on,
            generator=torch.Generator().manual_seed(SEED),
        )
        return Trainer(model, CE(), optimizer=OptimizerFactory(learning_rate=CONT_LR), device=on)

    continual = make_trainer(catalog_by_day[0])
    resizes = []
    resize = continual.resize_vocabulary

    def recorded(state, new_cardinality, **kwargs):
        old = continual.model.schema["item_id"].cardinality
        before = host_state(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grown = resize(state, new_cardinality, **kwargs)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        dropped = not continual._chunk_graphs and not continual._eval_runner.keys
        resizes.append({"old": old, "new": new_cardinality, "ms": ms, "kwargs": kwargs, "dropped": dropped,
                        "before": before, "after": host_state(grown)})
        return grown

    continual.resize_vocabulary = recorded  # finetune resizes through it
    fit = dict(scan_chunk=CONT_SCAN_K, log_every=0)
    metrics = dict(metrics=("ndcg", "recall"), top_k=(CONT_TOPK,))
    histories = [[] for _ in range(CONT_USERS)]
    state, service, days, checks = None, None, [], []
    continual_s = retrain_s = 0.0
    reset_counts(flash_attention)
    try:
        for day in range(CONT_DAYS - 1):
            for user in range(CONT_USERS):
                histories[user].extend(events[day][user])
            catalog = catalog_by_day[day]
            tail = continual_train_batches([h[-(CONT_LEN + 1) :] for h in histories], np.random.default_rng(100 + day))
            warm = (continual.capture_warmups, continual._eval_runner.warmups, len(resizes))
            t0 = time.perf_counter()
            if state is None:
                state = continual.fit(tail, epochs=CONT_TAIL_EPOCHS, **fit)
            else:
                grow = catalog if catalog > continual.model.schema["item_id"].cardinality else None
                state = continual.finetune(state, tail, new_cardinality=grow, epochs=CONT_TAIL_EPOCHS, **fit)
            torch.cuda.synchronize()
            continual_day_s = time.perf_counter() - t0

            retrain = make_trainer(catalog)
            full = continual_train_batches(histories, np.random.default_rng(200 + day))
            t0 = time.perf_counter()
            retrain_state = retrain.fit(full, epochs=CONT_RETRAIN_EPOCHS, **fit)
            torch.cuda.synchronize()
            retrain_day_s = time.perf_counter() - t0
            continual_s += continual_day_s
            retrain_s += retrain_day_s

            evals = continual_eval_batches(histories, events[day + 1])
            got = continual.validate(state, evals, **metrics)
            want = retrain.validate(retrain_state, evals, **metrics)
            day_record = {
                "day": day, "catalog": catalog, "model_catalog": continual.model.schema["item_id"].cardinality,
                "tail_batches": len(tail), "history_batches": len(full), "continual_fit_s": continual_day_s,
                "retrain_fit_s": retrain_day_s, "continual_ndcg": got[f"ndcg@{CONT_TOPK}"],
                "retrain_ndcg": want[f"ndcg@{CONT_TOPK}"], "continual_recall": got[f"recall@{CONT_TOPK}"],
                "retrain_recall": want[f"recall@{CONT_TOPK}"],
            }
            if len(resizes) > warm[2]:
                # no graph of the old shape ran after the resize: the fit and
                # the validation captured their programs anew
                day_record["resize"] = resize_checks(resizes[-1], make_trainer)
                day_record["recaptured"] = {
                    "chunk": continual.capture_warmups - warm[0], "eval": continual._eval_runner.warmups - warm[1],
                }
                if min(day_record["recaptured"].values()) < 1:
                    raise AssertionError(f"continual: a program of the old shape was not captured anew: {day_record}")
                day_record["graph_vs_eager"] = graph_equals_eager(continual, state, tail[:CONT_SCAN_K])
                checks.append(day_record)
            emit("continual", run="day", **day_record)
            days.append(day_record)
            if service is None:
                # the serving generation of day 0, on a model of its own
                service = ScoringService(
                    make_trainer(catalog).model, {k: v.detach().clone() for k, v in state.params.items()},
                    length_buckets=(CONT_LEN,), batch_buckets=(1, 8, 32), device=device,
                ).start()
            del retrain, retrain_state
            release()
        k4 = flash_attention.launches
        # the grown generation through publish_candidate's shape-change path
        generation = service.publish_candidate(
            {k: v.detach().clone() for k, v in state.params.items()}, label="grown"
        )
        fresh_engine = service.store.generation(generation).engine is not None
        service.promote(generation)
        users = list(range(0, CONT_USERS, CONT_USERS // CONT_SERVE_USERS))[:CONT_SERVE_USERS]
        served = served_top10(service, continual, state, histories, users)
        served["fresh_engine"] = fresh_engine
        if not fresh_engine:
            raise AssertionError("continual: the grown generation did not build a fresh engine")
    finally:
        if service is not None:
            service.close()
    continual_ndcg = float(np.mean([d["continual_ndcg"] for d in days]))
    retrain_ndcg = float(np.mean([d["retrain_ndcg"] for d in days]))
    record = {
        "continual_vs_retrain_ndcg": continual_ndcg / retrain_ndcg, "continual_ndcg": continual_ndcg,
        "retrain_ndcg": retrain_ndcg,
        "continual_recall": float(np.mean([d["continual_recall"] for d in days])),
        "retrain_recall": float(np.mean([d["retrain_recall"] for d in days])),
        "continual_fit_s": continual_s, "retrain_fit_s": retrain_s, "fit_s_ratio": continual_s / retrain_s,
        "resize_ms": [r["ms"] for r in resizes], "k4_launches": k4, "days": CONT_DAYS,
        "catalog_start": catalog_by_day[0], "catalog_end": catalog_by_day[-1],
        "model_catalog_end": continual.model.schema["item_id"].cardinality, "resizes": len(resizes),
        "served": served, "stream_s": stream_s,
    }
    if not resizes or not all(math.isfinite(d["continual_ndcg"]) and math.isfinite(d["retrain_ndcg"]) for d in days):
        raise AssertionError(f"continual: {record}")
    record["phase_s"] = time.perf_counter() - started
    emit("continual", run="summary", **record)
    del continual, state
    release()
    return record


def stacked_layout(state: dict) -> dict:
    """A loop-layout state dict in the scan_blocks layout: ``...block_<i>.<p>``
    becomes ``...blocks.block.<p>`` stacked over i (flax's ``nn.scan`` tree)."""
    out, layers = {}, {}
    for name, value in state.items():
        head, sep, tail = name.partition(".block_")
        if not sep:
            out[name] = value
            continue
        index, _, leaf = tail.partition(".")
        layers.setdefault(f"{head}.blocks.block.{leaf}", {})[int(index)] = value
    for name, stack in layers.items():
        out[name] = torch.stack([stack[i] for i in sorted(stack)])
    return out


def loop_layout(state: dict) -> dict:
    """The inverse of ``stacked_layout``: every stacked leaf split by layer."""
    out = {}
    for name, value in state.items():
        head, sep, leaf = name.partition(".blocks.block.")
        if not sep:
            out[name] = value
            continue
        for index in range(value.shape[0]):
            out[f"{head}.block_{index}.{leaf}"] = value[index]
    return out


def named_gradient(model, loss, batch, device) -> dict:
    """``loss_gradient`` by parameter name, in the loop layout."""
    loss.logits_callback = model.get_logits
    loss.item_embeddings_callback = model.get_item_weights
    tensors = {key: torch.as_tensor(batch[key], device=device) for key in ("padding_mask", "positive_labels", "target_padding_mask")}
    features = {k: torch.as_tensor(v, device=device) for k, v in batch["feature_tensors"].items()}
    hidden = model(features, tensors["padding_mask"], deterministic=False)
    value = loss(hidden, {}, tensors["positive_labels"], None, tensors["padding_mask"], tensors["target_padding_mask"])
    names = [name for name, _ in model.named_parameters()]
    grads = torch.autograd.grad(value, [p for _, p in model.named_parameters()])
    return loop_layout({name: grad.detach().clone() for name, grad in zip(names, grads)})


def same_tensors(got: dict, want: dict) -> dict:
    """Largest absolute difference of two name → tensor dicts, and whether they are equal bit for bit."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"different names: {sorted(set(got) ^ set(want))[:6]}")
    diff = max((got[n].float() - want[n].float()).abs().max().item() for n in got)
    return {"bitwise": all(torch.equal(got[n], want[n]) for n in got), "max_abs_diff": diff}


def counted(wrappers) -> dict:
    return {fn.__name__: fn.launches for fn in wrappers}


def state_diff(a, b) -> dict:
    """Two training states' largest absolute differences: loss-free leaves
    (parameters by name, the optimizer state, the generator), and whether
    every leaf is equal bit for bit."""
    names = {n: (a.params[n] - b.params[n]).abs().max().item() for n in a.params}
    moments = [(x, y) for la, lb in zip(a.opt_state, b.opt_state) for x, y in zip(la.values(), lb.values())]
    bitwise = (torch.equal(a.flat_params, b.flat_params) and all(torch.equal(x, y) for x, y in moments)
               and torch.equal(a.rng, b.rng))
    differing = sorted(((d, n) for n, d in names.items() if d), reverse=True)[:4]
    return {"bitwise": bitwise, "params_max_abs_diff": max(names.values()), "differing": {n: d for d, n in differing}}


def graph_vs_eager(trainer, initial, batches, wrappers, per_step: dict) -> dict:
    """``len(batches)`` steps as one ``train_steps`` graph against as many
    ``train_step`` calls from ``initial``, as ``chunk_checks`` holds them:
    the eager steps run twice first; where the two runs are bitwise equal,
    the graph's losses, parameters, optimizer state and generator state must
    be bitwise theirs, else within the two runs' spread. Each wrapper's
    launches through the capture and the replay = its launches a step
    (``per_step``) × (K + the capture's eager warm-up step). Then the graph's
    ms a step, host clock, median of three ``train_steps`` calls."""
    steps = len(batches)

    def eager_run():
        state = trainer.init_state(batches[0], params=initial)
        losses = torch.stack([trainer.train_step(state, batch)[1] for batch in batches]).cpu().numpy()
        torch.cuda.synchronize()
        return state, losses

    (eager, eager_losses), (again, again_losses) = eager_run(), eager_run()
    eager_vs_eager = state_diff(again, eager)
    deterministic = eager_vs_eager["bitwise"] and np.array_equal(eager_losses, again_losses)
    before, warm = counted(wrappers), trainer.capture_warmups
    state = trainer.init_state(batches[0], params=initial)
    state, losses = trainer.train_steps(state, batches)
    torch.cuda.synchronize()
    launches = {name: count - before[name] for name, count in counted(wrappers).items()}
    warmups = trainer.capture_warmups - warm
    expected = {name: per_step[name] * (steps + warmups) for name in launches}
    graph_vs = state_diff(state, eager)
    loss_diff = float(np.abs(np.asarray(losses) - eager_losses).max())
    if deterministic:
        held = graph_vs["bitwise"] and loss_diff == 0.0
    else:
        held = (loss_diff <= float(np.abs(again_losses - eager_losses).max())
                and graph_vs["params_max_abs_diff"] <= eager_vs_eager["params_max_abs_diff"])
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        state, _ = trainer.train_steps(state, batches)
        times.append((time.perf_counter() - t0) * 1e3 / steps)
    record = {
        "K": steps, "bitwise": held and deterministic, "held": held, "eager_bitwise_deterministic": deterministic,
        "eager_vs_eager": eager_vs_eager, "graph_vs_eager": graph_vs, "loss_max_abs_diff": loss_diff,
        "launches": launches, "expected": expected, "capture_warmups": warmups, "ms_a_step": statistics.median(times),
    }
    if not held or launches != expected or warmups != 1:
        raise AssertionError(f"train_steps K={steps} vs {steps} train_step calls: {record}")
    return record, state


def family_remat_k5(device) -> dict:
    """Remat on K5 at the long-sequence width: for each of ``FAMILY_REMAT``,
    one step and the gradient from the same weights bitwise the plain step's,
    K5 launches a step, eager p50, device ms and peak memory, a K=8 graph
    bitwise its eager steps and a trace of its replays whose K5 kernels equal
    the launches counted; then the dropout contract at ``FAMILY_DROPOUT``."""
    from replay_tpu_torch.data import FeatureHint, FeatureType
    from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema
    from replay_tpu_torch.nn.loss import CEFused
    from replay_tpu_torch.nn.sequential.sasrec import SasRec
    from replay_tpu_torch.nn.train import OptimizerFactory, Trainer
    from replay_tpu_torch.ops import fused_ce
    from replay_tpu_torch.ops.flash_tiled import flash_attention_tiled

    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
            cardinality=NUM_ITEMS, embedding_dim=LONG_DIM,
        )
    )
    width = dict(embedding_dim=LONG_DIM, num_blocks=LONG_BLOCKS, num_heads=LONG_HEADS, max_sequence_length=LONG_LEN,
                 use_flash="tiled", device=device)
    batches = [next_item_batch(LONG_BATCH, LONG_LEN, seed) for seed in range(FAMILY_K5_SCAN_K)]
    kernels = (flash_attention_tiled, fused_ce.fused_lse_forward, fused_ce.fused_lse_dh, fused_ce.fused_lse_dw)

    def trainer_for(policy, scan, dropout=0.0):
        model = SasRec(schema, scan_blocks=scan, dropout_rate=dropout, generator=torch.Generator().manual_seed(SEED),
                       **width)
        optimizer = OptimizerFactory(name="adam", learning_rate=1e-3)
        return Trainer(model, CEFused(), optimizer=optimizer, precision="bf16", remat_policy=policy, device=device)

    initial = {k: v.detach().clone() for k, v in trainer_for(None, False).model.state_dict().items()}
    rows, reference = {}, None
    reset_counts(*kernels)
    for label, policy, scan in FAMILY_REMAT:
        trainer = trainer_for(policy, scan)
        start = stacked_layout(initial) if scan else initial
        before = counted(kernels)
        state = trainer.init_state(batches[0], params=start)
        state, loss = trainer.train_step(state, batches[0])
        torch.cuda.synchronize()
        per_step = {name: count - before[name] for name, count in counted(kernels).items()}
        stepped = {
            "loss": loss.detach().clone(),
            "params": loop_layout({name: p.detach().clone() for name, p in state.params.items()}),
            "grads": named_gradient(trainer.model, CEFused(), batches[1], device),
        }
        if reference is None:
            reference = stepped
        against = {
            "loss_bitwise": bool(torch.equal(stepped["loss"], reference["loss"])),
            "params": same_tensors(stepped["params"], reference["params"]),
            "grads": same_tensors(stepped["grads"], reference["grads"]),
        }
        state, perf = trainer_perf(trainer, state, batches[0], FAMILY_STEPS, FAMILY_WARMUP_STEPS,
                                   FAMILY_PROFILED_STEPS, LONG_BATCH * LONG_LEN)
        graph, state = graph_vs_eager(trainer, start, batches, kernels, per_step)
        for _ in range(TRACES_AT_MOST):  # a trace that lost kernels at its window's edge is retaken
            state, trace = traced_chunks(trainer, state, batches, 2, kernels)
            if trace["traced"] == trace["launched"]:
                break
        row = {"remat_policy": policy, "scan_blocks": scan, "k5_launches_a_step": per_step["flash_attention_tiled"],
               "per_step_launches": per_step, "against_no_remat": against, "perf": perf, "graph": graph,
               "graph_trace": {k: trace[k] for k in ("traced", "launched", "kernels", "device_ms")}}
        emit("family", row=f"remat_k5_{label}", **row)
        want_k5 = LONG_BLOCKS * (2 if policy is not None else 1)
        if (per_step["flash_attention_tiled"] != want_k5 or not against["loss_bitwise"]
                or not against["params"]["bitwise"] or not against["grads"]["bitwise"]
                or trace["traced"] != trace["launched"]):
            raise AssertionError(f"family remat on K5, {label}: {row}")
        rows[label] = row
        del trainer, state
        release()
    rows["dropout_contract"] = family_dropout_contract(trainer_for, initial, batches, kernels)
    rows["launches"] = counted(kernels)
    return rows


def family_dropout_contract(trainer_for, initial, batches, kernels) -> dict:
    """At ``FAMILY_DROPOUT``: a remat step (``"full"`` and ``"dots"``) from the
    same weights and generator state bitwise the plain step, whose masks are
    real (its loss is not the dropout-0 step's); a K=8 graph of remat steps
    bitwise its eager steps (the recompute reads the forward's draws back)."""
    from replay_tpu_torch.ops.flash_tiled import flash_attention_tiled

    def one_step(policy, dropout=FAMILY_DROPOUT):
        trainer = trainer_for(policy, False, dropout)
        state = trainer.init_state(batches[0], params=initial)
        state, loss = trainer.train_step(state, batches[0])
        torch.cuda.synchronize()
        return trainer, state, loss.detach().clone()

    _, plain, plain_loss = one_step(None)
    _, _, no_dropout_loss = one_step(None, 0.0)
    record = {"masks_drawn": not torch.equal(plain_loss, no_dropout_loss)}
    for policy in ("full", "dots"):
        trainer, state, loss = one_step(policy)
        record[policy] = {
            "loss_bitwise": bool(torch.equal(loss, plain_loss)),
            "params_bitwise": bool(torch.equal(state.flat_params, plain.flat_params)),
            "rng_bitwise": bool(torch.equal(state.rng, plain.rng)),
        }
        per_step = {fn.__name__: 0 for fn in kernels}
        per_step.update(flash_attention_tiled=2 * LONG_BLOCKS, fused_lse_forward=1, fused_lse_dh=1, fused_lse_dw=1)
        record[policy]["graph"], _ = graph_vs_eager(trainer, initial, batches, kernels, per_step)
    emit("family", row="remat_k5_dropout_contract", dropout=FAMILY_DROPOUT, **record)
    if not record["masks_drawn"] or not all(all(v for k, v in record[p].items() if k != "graph") for p in ("full", "dots")):
        raise AssertionError(f"family: the dropout contract: {record}")
    return record


def family_remat_k4(device) -> dict:
    """Remat ``"dots"`` on K4: at the bench.py width (f32, CEFused) one step
    bitwise the plain step's, K4 launches a step 2 → 4, eager p50, device ms
    and memory of both, a K=32 graph bitwise its eager steps; at BERT4Rec's
    width (f32, CE) three eager steps of each, their losses bitwise, K4
    launches a step and peak memory."""
    from replay_tpu_torch.data import FeatureHint, FeatureType
    from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema
    from replay_tpu_torch.nn.loss import CE, CEFused
    from replay_tpu_torch.nn.sequential.bert4rec import Bert4Rec
    from replay_tpu_torch.nn.sequential.sasrec import SasRec
    from replay_tpu_torch.nn.train import Trainer
    from replay_tpu_torch.ops import fused_ce
    from replay_tpu_torch.ops.flash_attention import flash_attention

    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
            cardinality=NUM_ITEMS, embedding_dim=EMBEDDING_DIM,
        )
    )
    width = dict(embedding_dim=EMBEDDING_DIM, num_blocks=NUM_BLOCKS, num_heads=NUM_HEADS, max_sequence_length=SEQ_LEN,
                 use_flash=True, device=device)
    batches = [next_item_batch(TRAIN_BATCH, SEQ_LEN, seed) for seed in range(FAMILY_K4_SCAN_K)]
    kernels = (flash_attention, fused_ce.fused_lse_forward, fused_ce.fused_lse_dh, fused_ce.fused_lse_dw)
    initial = SasRec(schema, generator=torch.Generator().manual_seed(SEED), **width).state_dict()
    record = {"bench": {}, "bert4rec": {}}
    reset_counts(*kernels)
    losses = {}
    for label, policy in (("none", None), ("dots", "dots")):
        trainer = Trainer(SasRec(schema, **width), CEFused(), remat_policy=policy, device=device)
        before = counted(kernels)
        state = trainer.init_state(batches[0], params=initial)
        state, loss = trainer.train_step(state, batches[0])
        torch.cuda.synchronize()
        per_step = {name: count - before[name] for name, count in counted(kernels).items()}
        losses[label] = (loss.detach().clone(), state.flat_params.clone())
        state, perf = trainer_perf(trainer, state, batches[0], FAMILY_STEPS, FAMILY_WARMUP_STEPS,
                                   FAMILY_PROFILED_STEPS, TRAIN_BATCH * SEQ_LEN)
        row = {"k4_launches_a_step": per_step["flash_attention"], "per_step_launches": per_step, "perf": perf}
        if policy is not None:
            row["graph"], _ = graph_vs_eager(trainer, initial, batches, kernels, per_step)
            row["against_no_remat"] = {
                "loss_bitwise": bool(torch.equal(losses["dots"][0], losses["none"][0])),
                "params_bitwise": bool(torch.equal(losses["dots"][1], losses["none"][1])),
            }
        emit("family", row=f"remat_k4_bench_{label}", **row)
        if per_step["flash_attention"] != NUM_BLOCKS * (2 if policy else 1) or (
                policy and not all(row["against_no_remat"].values())):
            raise AssertionError(f"family remat on K4 at the bench.py width, {label}: {row}")
        record["bench"][label] = row
        del trainer, state
        release()
    record["bench"]["launches"] = counted(kernels)

    b4r_schema = model_schema(B4R_DIM)
    b4r_width = dict(embedding_dim=B4R_DIM, num_blocks=B4R_BLOCKS, num_heads=B4R_HEADS, max_sequence_length=B4R_LEN,
                     dropout_rate=0.0, use_flash=True, device=device)
    b4r_batches = mlm_batches(b4r_schema, FAMILY_B4R_STEPS)
    b4r_initial = Bert4Rec(b4r_schema, generator=torch.Generator().manual_seed(SEED), **b4r_width).state_dict()
    reset_counts(flash_attention)
    b4r_losses = {}
    for label, policy in (("none", None), ("dots", "dots")):
        trainer = Trainer(Bert4Rec(b4r_schema, **b4r_width), CE(), remat_policy=policy, device=device)
        state = trainer.init_state(b4r_batches[0], params=b4r_initial)
        release()
        torch.cuda.reset_peak_memory_stats(device)
        at_start = torch.cuda.memory_allocated(device)
        before, times, values = flash_attention.launches, [], []
        for batch in b4r_batches:
            t0 = time.perf_counter()
            state, loss = trainer.train_step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            values.append(loss.detach().clone())
        b4r_losses[label] = torch.stack(values)
        row = {
            "k4_launches_a_step": (flash_attention.launches - before) / FAMILY_B4R_STEPS, "step_ms": times,
            "losses": b4r_losses[label].tolist(), "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(device),
            "memory_allocated_at_start_bytes": at_start,
        }
        if policy is not None:
            row["losses_bitwise_no_remat"] = bool(torch.equal(b4r_losses["dots"], b4r_losses["none"]))
            row["peak_vs_no_remat"] = row["max_memory_allocated_bytes"] / record["bert4rec"]["none"][
                "max_memory_allocated_bytes"]
        emit("family", row=f"remat_k4_bert4rec_{label}", **row)
        if row["k4_launches_a_step"] != B4R_BLOCKS * (2 if policy else 1) or (
                policy and not row["losses_bitwise_no_remat"]):
            raise AssertionError(f"family remat on K4 at BERT4Rec's width, {label}: {row}")
        record["bert4rec"][label] = row
        del trainer, state
        release()
    record["bert4rec"]["launches"] = flash_attention.launches
    return record


def held_to_cpu_port(make_cpu_model, params, query: dict, got: torch.Tensor, dtype, predict=None) -> dict:
    """The card's logits against the CPU port's on the same weights and
    query (``forward_inference``, or ``predict(cpu_model)``), within
    ``FAMILY_CPU_TOL[dtype]``."""
    cpu = make_cpu_model()
    cpu.load_state_dict({k: v.detach().cpu() for k, v in params.items()})
    with torch.no_grad():
        if predict is not None:
            want = predict(cpu)
        else:
            want = cpu.forward_inference(
                {k: torch.as_tensor(v) for k, v in query["feature_tensors"].items()},
                torch.as_tensor(query["padding_mask"]),
            )
    err = (got.detach().float().cpu() - torch.as_tensor(want).float()).abs().max().item()
    if not err <= FAMILY_CPU_TOL[dtype]:
        raise AssertionError(f"family: logits differ from the CPU port's by {err} (limit {FAMILY_CPU_TOL[dtype]})")
    return {"max_abs_diff": err, "limit": FAMILY_CPU_TOL[dtype], "rows": int(got.shape[0])}


def family_diff(device) -> dict:
    """The diff encoder at the bench.py width, 2 heads, ``use_flash=True``, f32
    and bf16, ``CE``: eager steps, a K=32 graph bitwise its eager steps,
    ``ScoringEngine`` L (16, 50) × B (1, 8, 64) under ``graph_contract``, logits
    held to the CPU port, and no K4 or K5 launch anywhere."""
    from replay_tpu_torch.data import FeatureHint, FeatureType
    from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema
    from replay_tpu_torch.nn.loss import CE
    from replay_tpu_torch.nn.sequential.sasrec import SasRec
    from replay_tpu_torch.nn.train import Trainer
    from replay_tpu_torch.ops.flash_attention import flash_attention
    from replay_tpu_torch.ops.flash_tiled import flash_attention_tiled
    from replay_tpu_torch.serve import ScoringEngine

    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
            cardinality=NUM_ITEMS, embedding_dim=EMBEDDING_DIM,
        )
    )
    width = dict(embedding_dim=EMBEDDING_DIM, num_blocks=NUM_BLOCKS, num_heads=FAMILY_DIFF_HEADS,
                 max_sequence_length=SEQ_LEN, encoder_type="diff", use_flash=True)
    batches = [next_item_batch(TRAIN_BATCH, SEQ_LEN, seed) for seed in range(FAMILY_K4_SCAN_K)]
    kernels = (flash_attention, flash_attention_tiled)
    initial = SasRec(schema, device=device, generator=torch.Generator().manual_seed(SEED), **width).state_dict()
    other = SasRec(schema, device=device, generator=torch.Generator().manual_seed(SEED + 1), **width).state_dict()
    requests = histories(np.random.default_rng(SEED), 48)
    query = held_out_windows(64)[0]
    record = {}
    reset_counts(*kernels)
    for dtype in (torch.float32, torch.bfloat16):
        label = "f32" if dtype == torch.float32 else "bf16"
        trainer = Trainer(SasRec(schema, device=device, **width), CE(),
                          precision="bf16" if dtype == torch.bfloat16 else None, device=device)
        state = trainer.init_state(batches[0], params=initial)
        state, perf = trainer_perf(trainer, state, batches[0], FAMILY_STEPS, FAMILY_WARMUP_STEPS,
                                   FAMILY_PROFILED_STEPS, TRAIN_BATCH * SEQ_LEN)
        graph, state = graph_vs_eager(trainer, initial, batches, kernels, {fn.__name__: 0 for fn in kernels})
        params = {k: v.detach().clone() for k, v in state.params.items()}
        engine = ScoringEngine(trainer.model, params, length_buckets=LENGTH_BUCKETS, batch_buckets=BATCH_BUCKETS,
                               device=device)
        contract = graph_contract(engine, other, requests, SEQ_LEN)
        with torch.no_grad():
            got = trainer.model.forward_inference(
                {"item_id": torch.as_tensor(query["feature_tensors"]["item_id"], device=device)},
                torch.as_tensor(query["padding_mask"], device=device),
            )
        cpu = held_to_cpu_port(lambda: SasRec(schema, device="cpu", dtype=dtype, **width), params, query, got, dtype)
        row = {"perf": perf, "graph": graph, "engine": contract, "cpu_port": cpu, "launches": counted(kernels)}
        emit("family", row=f"diff_{label}", heads=FAMILY_DIFF_HEADS, **row)
        record[label] = row
        del trainer, state, engine
        release()
    if any(counted(kernels).values()):
        raise AssertionError(f"family: the diff encoder launched an attention kernel: {counted(kernels)}")
    return record


def ti_windows(count: int, rows: int, seed: int):
    """Next-item windows of ``notebook_raw_log(SEED)``'s users (the last
    ``SEQ_LEN + 1`` events of ``rows`` users drawn from default_rng(seed),
    left-padded), with their timestamps as float32 (the log's event
    positions); ``count`` batches, and the per-user arrays."""
    raw = notebook_raw_log(SEED)
    items = np.searchsorted(notebook_raw_items(SEED), raw["item_id"])
    order = np.lexsort((raw["timestamp"], raw["user_id"]))
    users, starts = np.unique(raw["user_id"][order], return_index=True)
    ends = np.append(starts[1:], len(order))
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(count):
        ids = np.full((rows, SEQ_LEN + 1), NUM_ITEMS, np.int32)
        stamps = np.zeros((rows, SEQ_LEN + 1), np.float32)
        for row, user in enumerate(rng.choice(len(users), rows, replace=False)):
            events = order[max(starts[user], ends[user] - SEQ_LEN - 1) : ends[user]]
            ids[row, -len(events) :] = items[events]
            stamps[row, -len(events) :] = raw["timestamp"][events]
        mask = ids[:, :-1] != NUM_ITEMS  # left-padded: a real input has a real next item
        batches.append({
            "feature_tensors": {"item_id": ids[:, :-1], "timestamp": stamps[:, :-1]},
            "padding_mask": mask,
            "positive_labels": ids[:, 1:, None],
            "target_padding_mask": mask[:, :, None],
        })
    return batches


def family_tisasrec(device) -> dict:
    """TiSasRec at the bench.py width, ``time_span`` 256, float timestamps
    from the MovieLens-1M-shaped log: eager steps, a K=8 graph bitwise its
    eager steps (the float feature through the graph's static buffers),
    ``predict_logits`` and ``validate`` on the evaluation graphs, the logits
    held to the CPU port on the trained weights."""
    from replay_tpu_torch.data import FeatureHint, FeatureType
    from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema
    from replay_tpu_torch.nn.loss import CE
    from replay_tpu_torch.nn.sequential.sasrec import TiSasRec
    from replay_tpu_torch.nn.train import Trainer
    from replay_tpu_torch.ops.flash_attention import flash_attention

    started = time.perf_counter()
    batches = ti_windows(FAMILY_SCAN_K + 1, TRAIN_BATCH, SEED)
    data_s = time.perf_counter() - started
    schema = TensorSchema([
        TensorFeatureInfo("item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
                          cardinality=NUM_ITEMS, embedding_dim=EMBEDDING_DIM),
        TensorFeatureInfo("timestamp", FeatureType.NUMERICAL, is_seq=True, tensor_dim=1),
    ])
    width = dict(embedding_dim=EMBEDDING_DIM, num_blocks=NUM_BLOCKS, num_heads=NUM_HEADS,
                 max_sequence_length=SEQ_LEN, time_span=TI_SPAN)
    model = TiSasRec(schema, device=device, generator=torch.Generator().manual_seed(SEED), **width)
    initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
    trainer = Trainer(model, CE(), device=device)
    reset_counts(flash_attention)
    state = trainer.init_state(batches[0], params=initial)
    state, perf = trainer_perf(trainer, state, batches[0], FAMILY_STEPS, FAMILY_WARMUP_STEPS,
                               FAMILY_PROFILED_STEPS, TRAIN_BATCH * SEQ_LEN)
    graph, state = graph_vs_eager(trainer, initial, batches[:FAMILY_SCAN_K], (flash_attention,), {"flash_attention": 0})
    held = batches[FAMILY_SCAN_K]
    query = {k: held[k] for k in ("feature_tensors", "padding_mask")}
    got = trainer.predict_logits(state, query)
    params = {k: v.detach().clone() for k, v in state.params.items()}
    cpu = held_to_cpu_port(lambda: TiSasRec(schema, device="cpu", **width), params, query, torch.as_tensor(got),
                           torch.float32)
    seen = np.where(held["padding_mask"], held["feature_tensors"]["item_id"], -1)
    validation = dict(query, ground_truth=held["positive_labels"][:, -1], train=seen, query_id=np.arange(TRAIN_BATCH))
    metrics = trainer.validate(state, [validation], metrics=("ndcg", "recall"), top_k=(10,))
    if not all(math.isfinite(v) for v in metrics.values()) or flash_attention.launches:
        raise AssertionError(f"family TiSasRec: metrics {metrics}, K4 launches {flash_attention.launches}")
    row = {"perf": perf, "graph": graph, "cpu_port": cpu, "validate": metrics, "data_s": data_s,
           "timestamp_dtype": str(batches[0]["feature_tensors"]["timestamp"].dtype), "time_span": TI_SPAN}
    emit("family", row="tisasrec", **row)
    del trainer, state
    release()
    return row


def genre_tables(seed: int):
    """Each item's genres (1–``GENRE_SLOTS`` of ``GENRES``, padded with
    ``GENRES``) and a numerical feature, from default_rng(seed); the padding
    item's row all padding and 0."""
    rng = np.random.default_rng(seed)
    genres = np.full((NUM_ITEMS + 1, GENRE_SLOTS), GENRES, np.int32)
    for item in range(NUM_ITEMS):
        drawn = rng.choice(GENRES, int(rng.integers(1, GENRE_SLOTS + 1)), replace=False)
        genres[item, : len(drawn)] = drawn
    numeric = np.append(rng.normal(size=NUM_ITEMS), 0.0).astype(np.float32)
    return genres, numeric


def family_embedders(device) -> dict:
    """A SASRec at the bench.py width over item ids, a genre list in each
    pooling and a numerical feature, tables drawn by
    ``xavier_normal_embed_init``, ``use_flash=True``, ``CEFused``: eager steps,
    a K=8 graph bitwise its eager steps, the first steps' losses held to the
    CPU port's and the trained logits too."""
    from replay_tpu_torch.data import FeatureHint, FeatureType
    from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema
    from replay_tpu_torch.nn.embedding import xavier_normal_embed_init
    from replay_tpu_torch.nn.loss import CEFused
    from replay_tpu_torch.nn.sequential.sasrec import SasRec
    from replay_tpu_torch.nn.train import Trainer
    from replay_tpu_torch.ops import fused_ce
    from replay_tpu_torch.ops.flash_attention import flash_attention

    genres, numeric = genre_tables(SEED)
    schema = TensorSchema([
        TensorFeatureInfo("item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
                          cardinality=NUM_ITEMS, embedding_dim=EMBEDDING_DIM),
        TensorFeatureInfo("genres", FeatureType.CATEGORICAL_LIST, is_seq=True, cardinality=GENRES,
                          embedding_dim=EMBEDDING_DIM),
        TensorFeatureInfo("score", FeatureType.NUMERICAL, is_seq=True, tensor_dim=1, embedding_dim=EMBEDDING_DIM),
    ])
    width = dict(embedding_dim=EMBEDDING_DIM, num_blocks=NUM_BLOCKS, num_heads=NUM_HEADS, max_sequence_length=SEQ_LEN,
                 use_flash=True)

    def with_features(batch):
        ids = batch["feature_tensors"]["item_id"]
        return dict(batch, feature_tensors={"item_id": ids, "genres": genres[ids], "score": numeric[ids]})

    batches = [with_features(next_item_batch(TRAIN_BATCH, SEQ_LEN, seed)) for seed in range(FAMILY_SCAN_K)]
    query = with_features(held_out_windows(64)[0])
    kernels = (flash_attention, fused_ce.fused_lse_forward, fused_ce.fused_lse_dh, fused_ce.fused_lse_dw)
    record = {}
    reset_counts(*kernels)

    def make(pooling, on):
        model = SasRec(schema, embedding_init=xavier_normal_embed_init(), device=on,
                       generator=torch.Generator().manual_seed(SEED), **width)
        # the SASRec body embeds with the default pooling, as in JAX: set each here
        model.body.embedder.embedder("genres").pooling = pooling
        return model

    for pooling in FAMILY_POOLINGS:
        model = make(pooling, device)
        initial = {k: v.detach().clone() for k, v in model.state_dict().items()}
        trainer = Trainer(model, CEFused(), device=device)
        cpu_trainer = Trainer(make(pooling, "cpu"), CEFused(), device="cpu")
        state = trainer.init_state(batches[0], params=initial)
        cpu_state = cpu_trainer.init_state(batches[0], params={k: v.cpu() for k, v in initial.items()})
        before = counted(kernels)
        card_losses = [float(trainer.train_step(state, b)[1]) for b in batches[:FAMILY_CPU_STEPS]]
        per_step = {n: (c - before[n]) // FAMILY_CPU_STEPS for n, c in counted(kernels).items()}
        cpu_losses = [float(cpu_trainer.train_step(cpu_state, b)[1]) for b in batches[:FAMILY_CPU_STEPS]]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_losses, cpu_losses))
        graph, state = graph_vs_eager(trainer, initial, batches, kernels, per_step)
        with torch.no_grad():
            got = trainer.model.forward_inference(
                {k: torch.as_tensor(v, device=device) for k, v in query["feature_tensors"].items()},
                torch.as_tensor(query["padding_mask"], device=device),
            )
        params = {k: v.detach().clone() for k, v in state.params.items()}
        cpu = held_to_cpu_port(lambda: make(pooling, "cpu"), params, query, got, torch.float32)
        row = {"losses": card_losses, "cpu_losses": cpu_losses, "loss_rel_diff": loss_err, "graph": graph,
               "cpu_port": cpu, "per_step_launches": per_step}
        emit("family", row=f"embedders_{pooling}", **row)
        if not loss_err <= TRAIN_LOSS_RTOL:
            raise AssertionError(f"family embedders ({pooling}): losses against the CPU port's: {row}")
        record[pooling] = row
        del trainer, state, cpu_trainer
        release()
    record["launches"] = counted(kernels)
    return record


def family_embedding_backward(device) -> dict:
    """Each ``FAMILY_EMBED_CASES`` table's gradient from uniform lookups, by
    torch's CUDA embedding backward and by ``table_gradient``: whether four
    runs on the same inputs repeat bit for bit, their largest difference, and
    ms a call; and which of the two the port's ``Embed`` takes there."""
    from replay_tpu_torch.nn.layers import DETERMINISTIC_LOOKUPS_PER_ROW, table_gradient

    generator = torch.Generator(device=device).manual_seed(SEED)
    record = {}
    for name, rows, dim, shape in FAMILY_EMBED_CASES:
        ids = torch.randint(0, rows, shape, device=device, generator=generator)
        grad = torch.randn(*shape, dim, device=device, generator=generator)
        ways = {
            "torch": lambda: torch.ops.aten.embedding_dense_backward(grad, ids, rows, -1, False),
            "fixed_order": lambda: table_gradient(ids, grad, rows),
        }
        row = {"rows": rows, "dim": dim, "lookups": ids.numel(),
               "embed_takes": "fixed_order" if ids.numel() >= DETERMINISTIC_LOOKUPS_PER_ROW * rows else "torch"}
        results = {}
        for way, fn in ways.items():
            outs = [fn() for _ in range(4)]
            results[way] = outs[0]
            row[way] = {"repeats_bitwise": all(torch.equal(outs[0], o) for o in outs[1:]),
                        "spread": max((outs[0] - o).abs().max().item() for o in outs[1:]), "ms": eager_ms(fn, 20, 5)}
        row["max_abs_diff"] = (results["torch"] - results["fixed_order"]).abs().max().item()
        emit("family", row=f"embedding_backward_{name}", **row)
        if not row["fixed_order"]["repeats_bitwise"]:
            raise AssertionError(f"family: table_gradient did not repeat: {row}")
        record[name] = row
    return record


def family_phase(device) -> dict:
    """The rest of the SASRec family on the card (see ``FAMILY_*``): remat
    and scan_blocks over K5 and K4, the diff encoder, TiSasRec, the list and
    numerical embedders; one ``{"phase": "family", "row": ...}`` line each."""
    started = time.perf_counter()
    record = {
        "remat_k5": family_remat_k5(device),
        "remat_k4": family_remat_k4(device),
        "diff": family_diff(device),
        "tisasrec": family_tisasrec(device),
        "embedders": family_embedders(device),
        "embedding_backward": family_embedding_backward(device),
    }
    record["phase_s"] = time.perf_counter() - started
    emit("family", row="summary", phase_s=record["phase_s"])
    return record


# --------------------------------------------------------------------------- #
# distributed training: ranks of one card, gloo collectives through the host
# --------------------------------------------------------------------------- #
# The card machine has one H100, so the ranks of a mesh are processes that
# share cuda:0. NCCL refuses two ranks of one communicator on one device
# (``python3 chip_smoke.py --nccl-probe`` shows its message), so the phase
# runs torch.distributed's gloo backend on CUDA tensors: the kernels run on
# the card in every rank and each collective goes through a host copy
# (replay_tpu_torch.parallel.mesh.host_copies counts them). Its times show
# correctness and launch counts, not NVLink speed.
#
# dp: bench.py's SASRec (3,706 items, E=64, 2 blocks, 1 head, L=50) on a
# 2x1x1 mesh, 2 ranks of 256 rows of the global batch of 512; CEFused on K1–K3,
# K4 attention, f32. sp_tp: bench_suite.py's sasrec_l1024_sp_remat_off
# (bench_suite.py:396-450): 3,705 items (the row trims the table to divide by
# tp), E=128, 2 blocks, 2 heads, L=1024, batch 32, on the 1x2x2 mesh that
# _longseq_mesh_layout() picks for 4 devices: ring attention over seq,
# CEFusedTP over model (K1–K3 per shard: 1,853 rows each, the second shard's
# num_valid 1,852).
DIST_STEPS = 3  # SGD steps of each parity run, as the JAX tests take
DIST_LR = 0.1
DIST_DP_RANKS, DIST_DP_ROWS = 2, TRAIN_BATCH
DIST_VAL_BATCHES, DIST_VAL_ROWS = 8, 64
DIST_SP_ITEMS, DIST_SP_MESH = 3705, (1, 2, 2)
DIST_TIMED_STEPS, DIST_WARMUP_STEPS = 5, 2
DIST_LAUNCH_TIMEOUT_S = 300.0
# Parity limits, each between the sound run's reading and its faulty control's
# (the gradient all-reduce dropped for dp, the ring never hopping for sp_tp):
# the largest relative loss difference over the steps, and the largest
# absolute parameter difference, against the single-process trainer on the
# global batch from the same weights. Read by this script on an NVIDIA H100
# 80GB HBM3 at 700 W: dp sound 1.09e-7 / 1.19e-7, control 4.4e-4 / 6.3e-3;
# sp_tp sound 1.08e-7 / 7.1e-7, control 2.1e-4 / 1.03e-4 (f32 sums in other
# orders against whole steps of another gradient).
DIST_LOSS_RTOL = {"dp": 1e-5, "sp_tp": 1e-5}
DIST_PARAM_TOL = {"dp": 1e-5, "sp_tp": 1e-5}
DIST_METRIC_TOL = 1e-6
# what a rank reads of the launching process's settings
DIST_SHARED = (
    "NUM_ITEMS", "EMBEDDING_DIM", "NUM_BLOCKS", "NUM_HEADS", "SEQ_LEN", "LONG_DIM", "LONG_BLOCKS", "LONG_HEADS",
    "LONG_LEN", "LONG_BATCH", "DIST_STEPS", "DIST_LR", "DIST_DP_RANKS", "DIST_DP_ROWS", "DIST_VAL_BATCHES",
    "DIST_VAL_ROWS", "DIST_SP_ITEMS", "DIST_SP_MESH", "DIST_TIMED_STEPS", "DIST_WARMUP_STEPS",
)


def dist_schema(items: int, dim: int):
    from replay_tpu_torch.data import FeatureHint, FeatureType
    from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema

    return TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
            cardinality=items, embedding_dim=dim,
        )
    )


def dist_model(row: str, device, use_flash=None, dtype=torch.float32):
    """The row's SASRec from the seed's weights: ``dp`` at bench.py's width on
    K4, ``sp_tp`` at the L=1024 width on the ring route."""
    from replay_tpu_torch.nn.sequential.sasrec import SasRec

    if row == "dp":
        width = dict(embedding_dim=EMBEDDING_DIM, num_blocks=NUM_BLOCKS, num_heads=NUM_HEADS, max_sequence_length=SEQ_LEN)
        schema = dist_schema(NUM_ITEMS, EMBEDDING_DIM)
        use_flash = True if use_flash is None else use_flash
    else:
        width = dict(embedding_dim=LONG_DIM, num_blocks=LONG_BLOCKS, num_heads=LONG_HEADS, max_sequence_length=LONG_LEN)
        schema = dist_schema(DIST_SP_ITEMS, LONG_DIM)
        use_flash = "ring" if use_flash is None else use_flash
    return SasRec(
        schema, use_flash=use_flash, dtype=dtype, dropout_rate=0.0, device=device,
        generator=torch.Generator().manual_seed(SEED), **width,
    )


def dist_batch(row: str, step: int, rows=slice(None)):
    """Global batch ``step`` of the row (bench.py's full windows), cut to ``rows``."""
    items, length, batch = (NUM_ITEMS, SEQ_LEN, DIST_DP_ROWS) if row == "dp" else (DIST_SP_ITEMS, LONG_LEN, LONG_BATCH)
    rng = np.random.default_rng(1000 + step)
    ids = rng.integers(0, items, size=(batch, length + 1)).astype(np.int32)[rows]
    mask = np.ones((ids.shape[0], length), dtype=bool)
    return {
        "feature_tensors": {"item_id": ids[:, :-1]},
        "padding_mask": mask,
        "positive_labels": ids[:, 1:, None],
        "target_padding_mask": mask[:, :, None],
    }


def dist_val_batches(rows=slice(None)):
    """``DIST_VAL_BATCHES`` held-out batches of left-padded windows (the
    next item, or for half the users an item near the front of the catalog,
    as ground truth), cut to ``rows``."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(DIST_VAL_BATCHES):
        lengths = rng.integers(1, SEQ_LEN + 1, DIST_VAL_ROWS)
        ids = rng.integers(0, NUM_ITEMS, (DIST_VAL_ROWS, SEQ_LEN)).astype(np.int32)
        mask = np.arange(SEQ_LEN)[None, :] >= SEQ_LEN - lengths[:, None]
        ids = np.where(mask, ids, NUM_ITEMS).astype(np.int32)
        truth = np.where(rng.random((DIST_VAL_ROWS, 1)) < 0.5, rng.integers(0, 20, (DIST_VAL_ROWS, 1)),
                         rng.integers(0, NUM_ITEMS, (DIST_VAL_ROWS, 1))).astype(np.int32)
        out.append({"feature_tensors": {"item_id": ids[rows]}, "padding_mask": mask[rows], "ground_truth": truth[rows]})
    return out


def dist_trainer(row: str, device, mesh=None, optimizer="sgd", remat_policy=None, **model_kwargs):
    """The row's trainer: on ``mesh`` with ``CEFusedTP`` and the table
    sharded for ``sp_tp``; without a mesh (the single process) ``CEFused``."""
    from replay_tpu_torch.nn.loss import CEFused, CEFusedTP
    from replay_tpu_torch.nn.train import OptimizerFactory, Trainer

    lr = DIST_LR if optimizer == "sgd" else 1e-3
    loss = CEFusedTP() if row == "sp_tp" and mesh is not None else CEFused()
    return Trainer(
        dist_model(row, device, **model_kwargs), loss, optimizer=OptimizerFactory(name=optimizer, learning_rate=lr),
        device=device, mesh=mesh, shard_vocab=row == "sp_tp" and mesh is not None, remat_policy=remat_policy,
    )


def dist_params(state) -> dict:
    return {name: value.detach().cpu().numpy().copy() for name, value in state.params.items()}


def dist_starts(trainer) -> dict:
    """The global row of each parameter's first local row on this rank."""
    return {name: p.index[0].start if p.sharded else 0 for name, p in trainer.placements.items()}


def dist_kernels():
    from replay_tpu_torch.ops import fused_ce as fc
    from replay_tpu_torch.ops.flash_attention import flash_attention

    return (flash_attention, fc.fused_lse_forward, fc.fused_lse_dh, fc.fused_lse_dw)


def dist_steps(trainer, state, batches):
    losses = []
    for batch in batches:
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
    return state, losses


def dist_traced_step(trainer, state, batch, kernels) -> dict:
    """Each kernel's launches in one profiler trace of one step (card only)."""
    if trainer.device.type != "cuda":
        return {}
    with profiled_window(lambda: trainer.train_step(state, batch)) as prof:
        trainer.train_step(state, batch)
    return traced_kernels(device_events(prof.key_averages()), kernels)


def dist_main_run(trainer, state, batches, kernels, mesh_ops):
    """The main path of a row on this rank: every count at 0 before its steps
    and read after them, with the collective log and the host copies."""
    from replay_tpu_torch.parallel import collective_inventory, collective_log

    reset_counts(*kernels)
    mesh_ops.reset_host_copies()
    with collective_log() as log:
        state, losses = dist_steps(trainer, state, batches)
    if trainer.device.type == "cuda":
        torch.cuda.synchronize()
    return state, {
        "losses": losses,
        "launches": counted(kernels),
        "host_copies": mesh_ops.host_copies(),
        "collectives": collective_inventory(log, trainer.mesh.shape),
    }


def dist_timed(trainer, batch, steps: int, warmup: int) -> dict:
    """Host-clock ms a step (synchronised) and the peak memory of this rank."""
    state = trainer.init_state(batch)
    if trainer.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(trainer.device)
    times = []
    for index in range(warmup + steps):
        started = time.perf_counter()
        state, loss = trainer.train_step(state, batch)
        if trainer.device.type == "cuda":
            torch.cuda.synchronize()
        if index >= warmup:
            times.append((time.perf_counter() - started) * 1e3)
        if not math.isfinite(float(loss)):
            raise AssertionError(f"non-finite loss while timing: {float(loss)}")
    peak = torch.cuda.max_memory_allocated(trainer.device) if trainer.device.type == "cuda" else None
    return {"step_ms": sorted(times)[len(times) // 2], "step_ms_all": times, "peak_memory_bytes": peak}


def dist_worker_dp(device, out: dict, mesh_ops) -> None:
    from replay_tpu_torch.nn.train import make_mesh

    mesh = make_mesh()
    rows = slice(mesh.axis_index("data") * DIST_DP_ROWS // mesh.shape["data"],
                 (mesh.axis_index("data") + 1) * DIST_DP_ROWS // mesh.shape["data"])
    batches = [dist_batch("dp", step, rows) for step in range(DIST_STEPS)]
    kernels = dist_kernels()
    trainer = dist_trainer("dp", device, mesh)
    state, run = dist_main_run(trainer, trainer.init_state(batches[0]), batches, kernels, mesh_ops)
    out["main"] = run
    out["params"] = dist_params(state)
    out["starts"] = dist_starts(trainer)
    out["metrics"] = trainer.validate(state, dist_val_batches(rows), metrics=("recall", "ndcg"), top_k=(1, 10))
    out["traced_step"] = dist_traced_step(trainer, state, batches[0], kernels)
    # the faulty control: the gradient's all-reduce dropped (each rank steps
    # on its half of the batch alone)
    real = mesh_ops.all_reduce
    mesh_ops.all_reduce = lambda x, mesh, axes, name="all_reduce": x if name == "grad" else real(x, mesh, axes, name)
    try:
        control = dist_trainer("dp", device, mesh)
        _, losses = dist_steps(control, control.init_state(batches[0]), batches)
        out["control"] = {"losses": losses, "params": dist_params(_)}
    finally:
        mesh_ops.all_reduce = real
    adam = dist_trainer("dp", device, mesh, optimizer="adam")
    out["adam"] = dist_timed(adam, batches[0], DIST_TIMED_STEPS, DIST_WARMUP_STEPS)


def dist_worker_sp_tp(device, out: dict, mesh_ops, checkpoint_dir: str) -> None:
    from replay_tpu_torch.nn.train import make_mesh
    from replay_tpu_torch.parallel import ring as ring_module
    from replay_tpu_torch.utils.checkpoint import CheckpointManager

    mesh = make_mesh(model_parallel=DIST_SP_MESH[1], seq_parallel=DIST_SP_MESH[2])
    batches = [dist_batch("sp_tp", step) for step in range(2 * DIST_STEPS)]
    kernels = dist_kernels()
    trainer = dist_trainer("sp_tp", device, mesh)
    state, run = dist_main_run(trainer, trainer.init_state(batches[0]), batches[:DIST_STEPS], kernels, mesh_ops)
    out["main"] = run
    out["params"] = dist_params(state)
    out["starts"] = dist_starts(trainer)
    # saved at step 3, then 3 more steps: what fresh ranks must reproduce
    CheckpointManager(checkpoint_dir, max_to_keep=1).save(DIST_STEPS, state)
    state, losses = dist_steps(trainer, state, batches[DIST_STEPS:])
    out["uninterrupted"] = {"losses": losses, "params": dist_params(state)}
    out["traced_step"] = dist_traced_step(trainer, state, batches[0], kernels)
    # the faulty control: the ring never hops (each block attends to itself)
    real = ring_module.RingShift
    ring_module.RingShift = type("NoHop", (), {"apply": staticmethod(lambda x, mesh, axis, shift: x)})
    try:
        control = dist_trainer("sp_tp", device, mesh)
        state, losses = dist_steps(control, control.init_state(batches[0]), batches[:DIST_STEPS])
        out["control"] = {"losses": losses, "params": dist_params(state)}
    finally:
        ring_module.RingShift = real
    del trainer, control, state
    # the row as bench_suite.py runs it on an accelerator: bf16 compute
    reset_counts(*kernels)
    speed = dist_trainer("sp_tp", device, mesh, optimizer="adam", dtype=torch.bfloat16)
    out["bf16"] = dist_timed(speed, batches[0], DIST_TIMED_STEPS, DIST_WARMUP_STEPS)
    out["bf16"]["launches"] = counted(kernels)
    out["bf16"]["steps"] = DIST_TIMED_STEPS + DIST_WARMUP_STEPS
    del speed
    if device.type == "cuda":
        torch.cuda.empty_cache()
    # bench_suite.py's _remat_on twin: its peak memory
    twin = dist_trainer("sp_tp", device, mesh, optimizer="adam", remat_policy="dots", dtype=torch.bfloat16)
    out["bf16_remat_dots"] = dist_timed(twin, batches[0], 2, 1)


def dist_worker_resume(device, out: dict, checkpoint_dir: str) -> None:
    from replay_tpu_torch.nn.train import make_mesh
    from replay_tpu_torch.utils.checkpoint import CheckpointManager

    mesh = make_mesh(model_parallel=DIST_SP_MESH[1], seq_parallel=DIST_SP_MESH[2])
    batches = [dist_batch("sp_tp", step) for step in range(2 * DIST_STEPS)]
    trainer = dist_trainer("sp_tp", device, mesh)
    state = CheckpointManager(checkpoint_dir, max_to_keep=1).restore(trainer.init_state(batches[0]))
    state, losses = dist_steps(trainer, state, batches[DIST_STEPS:])
    out["restored_step"] = DIST_STEPS
    out["resumed"] = {"losses": losses, "params": dist_params(state), "step": state.step}


def distributed_worker(argv) -> int:
    """One rank of the distributed phase (``chip_smoke.py --distributed-worker
    <row> <out_dir> <device>``, started by ``distributed_phase`` through the
    port's ``launch_workers``): its results go to ``<out_dir>/<row>_rank<r>.pt``."""
    import pickle

    from replay_tpu_torch.parallel import initialize_distributed
    from replay_tpu_torch.parallel import mesh as mesh_ops

    row, out_dir, device_name = argv
    config = os.path.join(out_dir, "config.json")
    if os.path.exists(config):
        with open(config) as handle:
            globals().update(json.load(handle))
    device = torch.device(device_name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a card rank found no CUDA device")
    backend = "nccl" if row == "nccl_probe" else "gloo"
    layout = initialize_distributed(backend=backend, timeout=120.0)
    out = {"layout": layout}
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.set_device(device)
    if row == "nccl_probe":
        x = torch.ones(4, device=device)
        torch.distributed.all_reduce(x)
        torch.cuda.synchronize()
        out["sum"] = x.tolist()
    elif row == "dp":
        dist_worker_dp(device, out, mesh_ops)
    elif row == "sp_tp":
        dist_worker_sp_tp(device, out, mesh_ops, os.path.join(out_dir, "ckpt"))
    else:
        dist_worker_resume(device, out, os.path.join(out_dir, "ckpt"))
    with open(os.path.join(out_dir, f"{row}_rank{layout['process_id']}.pkl"), "wb") as handle:
        pickle.dump(out, handle)
    torch.distributed.destroy_process_group()
    return 0


def dist_launch(row: str, ranks: int, out_dir: str, device, check: bool = True):
    """``ranks`` processes of ``chip_smoke.py --distributed-worker`` through
    the port's launcher, under ``DIST_LAUNCH_TIMEOUT_S``; the ranks' records."""
    import pickle

    from replay_tpu_torch.parallel import launch_workers

    here = os.path.dirname(os.path.abspath(__file__))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, (here, os.environ.get("PYTHONPATH"))))}
    started = time.perf_counter()
    results = launch_workers(
        os.path.abspath(__file__), ranks, args_for=lambda rank: ["--distributed-worker", row, out_dir, str(device)],
        env=env, timeout=DIST_LAUNCH_TIMEOUT_S, grace_s=30.0, check=check, pass_rank_argv=False,
    )
    seconds = time.perf_counter() - started
    if not check:
        return results, seconds
    records = []
    for rank in range(ranks):
        with open(os.path.join(out_dir, f"{row}_rank{rank}.pkl"), "rb") as handle:
            records.append(pickle.load(handle))
    return records, seconds


def nccl_probe(device) -> dict:
    """Two NCCL ranks on one card: the communicator's refusal, as NCCL words it."""
    import tempfile

    out_dir = tempfile.mkdtemp(prefix="nccl-probe-")
    try:
        results, seconds = dist_launch("nccl_probe", 2, out_dir, device, check=False)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    lines = [line for r in results for line in r.stderr.splitlines() if "NCCL" in line or "Error" in line]
    record = {"returncodes": [r.returncode for r in results], "killed_by": [r.killed_by for r in results],
              "message": lines[-6:], "seconds": seconds}
    emit("distributed", row="nccl_probe", **record)
    return record


def dist_param_err(got: dict, want: dict) -> float:
    return max(float(np.abs(got[name] - want[name]).max()) for name in want)


def dist_loss_err(got, want) -> float:
    return max(abs(a - b) / abs(b) for a, b in zip(got, want))


def dist_whole(ranks, params=lambda rank: rank["params"]) -> dict:
    """Rank 0's parameters (``params(rank)``), each sharded table put back
    from every rank's rows in the order of their start rows."""
    whole = dict(params(ranks[0]))
    for name in whole:
        parts = {rank["starts"][name]: params(rank)[name] for rank in ranks}
        if len(parts) > 1:
            whole[name] = np.concatenate([parts[start] for start in sorted(parts)])
    return whole


def dist_checked(row: str, ranks, reference: dict, per_step: dict) -> dict:
    """The parity record of a row: losses and parameters against the single
    process, the faulty control against the same limits (it must fail them),
    replicated parameters bitwise across ranks, launches per step against
    one rank's trace of a step."""
    whole = dist_whole(ranks)
    control = dist_whole(ranks, lambda rank: rank["control"]["params"])
    record = {
        "loss_rel_err": max(dist_loss_err(r["main"]["losses"], reference["losses"]) for r in ranks),
        "param_max_abs_err": dist_param_err(whole, reference["params"]),
        "control_loss_rel_err": max(dist_loss_err(r["control"]["losses"], reference["losses"]) for r in ranks),
        "control_param_max_abs_err": dist_param_err(control, reference["params"]),
        "losses": ranks[0]["main"]["losses"], "reference_losses": reference["losses"],
    }
    record["sound"] = record["loss_rel_err"] <= DIST_LOSS_RTOL[row] and record["param_max_abs_err"] <= DIST_PARAM_TOL[row]
    record["control_caught"] = (record["control_loss_rel_err"] > DIST_LOSS_RTOL[row]
                                or record["control_param_max_abs_err"] > DIST_PARAM_TOL[row])
    # every rank that holds the same rows of a parameter holds the same bits
    groups = {}
    for r in ranks:
        for name, value in r["params"].items():
            groups.setdefault((name, r.get("starts", {}).get(name, 0)), []).append(value)
    record["replicated_bitwise"] = all(all(np.array_equal(v[0], x) for x in v[1:]) for v in groups.values())
    record["launches_by_rank"] = [r["main"]["launches"] for r in ranks]
    record["traced_step_by_rank"] = [r["traced_step"] for r in ranks]
    # on the card: each rank's launches are the expected kernels a step, and
    # one rank's trace of one step holds as many (a CPU rehearsal counts none)
    record["launches_match_trace"] = all(
        not r["traced_step"] or (
            {k: v // DIST_STEPS for k, v in r["main"]["launches"].items()} == r["traced_step"] == per_step
            and all(v % DIST_STEPS == 0 for v in r["main"]["launches"].values())
        )
        for r in ranks
    )
    record["launches_total"] = {k: sum(r["main"]["launches"][k] for r in ranks) for k in per_step}
    record["per_step_expected"] = per_step
    record["per_step_launches"] = [{k: v / DIST_STEPS for k, v in r["main"]["launches"].items()} for r in ranks]
    record["host_copies_by_rank"] = [r["main"]["host_copies"] for r in ranks]
    if not (record["sound"] and record["control_caught"] and record["replicated_bitwise"]
            and record["launches_match_trace"]):
        raise AssertionError(f"distributed {row}: {record}")
    return record


def dist_reference(row: str, device, steps: int = DIST_STEPS) -> dict:
    """The single-process trainer on the global batch from the same weights:
    ``dp`` on K4 with CEFused, ``sp_tp`` on the unfused route with CEFused."""
    trainer = dist_trainer(row, device, use_flash=None if row == "dp" else False)
    batches = [dist_batch(row, step) for step in range(steps)]
    state, losses = dist_steps(trainer, trainer.init_state(batches[0]), batches)
    return {"losses": losses, "params": dist_params(state), "trainer": trainer, "state": state}


def distributed_phase(device) -> dict:
    """Distributed training on the card (see ``DIST_*``): the ``dp`` and
    ``sp_tp`` rows through the port's ``launch_workers``, gloo on ``cuda:0``,
    each against the single-process trainer; a checkpoint saved by the
    ``sp_tp`` ranks restored by fresh ones. One ``{"phase": "distributed",
    "row": ...}`` line a row."""
    import tempfile

    from replay_tpu_torch.ops import build
    from replay_tpu_torch.nn.train import Trainer

    started = time.perf_counter()
    if device.type == "cuda":
        # built here, once: the ranks load the cached libraries and never race nvcc
        build.build_all(["flash_attention", "fused_ce"])
    out_dir = tempfile.mkdtemp(prefix="distributed-")
    # the ranks read this process's widths and limits (a rehearsal's too)
    with open(os.path.join(out_dir, "config.json"), "w") as handle:
        json.dump({name: globals()[name] for name in DIST_SHARED}, handle)
    record = {}
    try:
        # dp: the single process on the global batch, then the two ranks
        reference = dist_reference("dp", device)
        ranks, seconds = dist_launch("dp", DIST_DP_RANKS, out_dir, device)
        per_step = {"flash_attention": NUM_BLOCKS, "fused_lse_forward": 1, "fused_lse_dh": 1, "fused_lse_dw": 1}
        dp = dist_checked("dp", ranks, reference, per_step)
        # validate: the ranks' summed metrics against the single process on the
        # ranks' own final weights and the global batches
        single = Trainer(dist_model("dp", device), reference["trainer"].loss, device=device)
        state = single.init_state(None, params={k: torch.tensor(v) for k, v in ranks[0]["params"].items()})
        want = single.validate(state, dist_val_batches(), metrics=("recall", "ndcg"), top_k=(1, 10))
        dp["metric_max_abs_err"] = max(abs(r["metrics"][k] - want[k]) for r in ranks for k in want)
        dp["metrics"] = ranks[0]["metrics"]
        dp["adam_step_ms_by_rank"] = [r["adam"]["step_ms"] for r in ranks]
        dp["launch_s"] = seconds
        dp["backend"] = ranks[0]["layout"]["backend"]
        emit("distributed", row="dp", **{k: v for k, v in dp.items() if k not in ("per_step_expected",)})
        if dp["metric_max_abs_err"] > DIST_METRIC_TOL:
            raise AssertionError(f"distributed dp: metrics differ from the single process's: {dp}")
        record["dp"] = dp
        del reference, single, state
        release()

        # sp_tp: the single process (f32, unfused route, CEFused), the four ranks, fresh ranks
        reference = dist_reference("sp_tp", device)
        del reference["trainer"], reference["state"]
        release()
        ranks, seconds = dist_launch("sp_tp", math.prod(DIST_SP_MESH), out_dir, device)
        per_step = {"flash_attention": 0, "fused_lse_forward": 1, "fused_lse_dh": 1, "fused_lse_dw": 1}
        sp_tp = dist_checked("sp_tp", ranks, reference, per_step)
        # the guard: no all-gather as large as a table shard (only the [rows]
        # lse values move over model), ring traffic point to point on seq only
        shard_bytes = (DIST_SP_ITEMS + 1) // DIST_SP_MESH[1] * LONG_DIM * 4
        collectives = ranks[0]["main"]["collectives"]
        sp_tp["guard"] = {
            "table_gathers": [c for r in ranks for c in r["main"]["collectives"]
                              if c["op"] == "all-gather" and c["bytes"] >= shard_bytes],
            "permute_axes": sorted({str(c["mesh_axis"]) for r in ranks for c in r["main"]["collectives"]
                                    if c["op"] == "collective-permute"}),
            "by_op": {op: sum(1 for c in collectives if c["op"] == op) for op in {c["op"] for c in collectives}},
            "bytes": sum(c["bytes"] for c in collectives),
        }
        resumed, resume_s = dist_launch("resume", math.prod(DIST_SP_MESH), out_dir, device)
        sp_tp["resume_bitwise"] = all(
            all(np.array_equal(a["resumed"]["params"][n], b["uninterrupted"]["params"][n]) for n in b["uninterrupted"]["params"])
            and a["resumed"]["losses"] == b["uninterrupted"]["losses"]
            for a, b in zip(resumed, ranks)
        )
        sp_tp["bf16_step_ms_by_rank"] = [r["bf16"]["step_ms"] for r in ranks]
        sp_tp["bf16_peak_memory_bytes_by_rank"] = [r["bf16"]["peak_memory_bytes"] for r in ranks]
        sp_tp["bf16_remat_dots_peak_memory_bytes_by_rank"] = [r["bf16_remat_dots"]["peak_memory_bytes"] for r in ranks]
        sp_tp["bf16_remat_dots_step_ms_by_rank"] = [r["bf16_remat_dots"]["step_ms"] for r in ranks]
        sp_tp["bf16_launches_by_rank"] = [r["bf16"]["launches"] for r in ranks]
        sp_tp["bf16_launches_total"] = {k: sum(r["bf16"]["launches"][k] for r in ranks) for k in per_step}
        sp_tp["launch_s"], sp_tp["resume_launch_s"] = seconds, resume_s
        sp_tp["backend"] = ranks[0]["layout"]["backend"]
        emit("distributed", row="sp_tp", **{k: v for k, v in sp_tp.items() if k not in ("per_step_expected",)})
        if sp_tp["guard"]["table_gathers"] or sp_tp["guard"]["permute_axes"] != ["seq"] or not sp_tp["resume_bitwise"]:
            raise AssertionError(f"distributed sp_tp: guard or resume: {sp_tp}")
        record["sp_tp"] = sp_tp
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    record["phase_s"] = time.perf_counter() - started
    emit("distributed", row="summary", phase_s=record["phase_s"])
    return record


class FleetTraffic:
    """bench_fleet.py's returning-user mix (``Traffic``, :200-255) over a Zipf
    population: a user's first request sends the whole history (1–99 items
    drawn from the user's id), later ones are pure hits (70%), one-item
    advances (20%) or history resends (10%). Each request comes back with the
    history it carried, or None for hits and advances: their window is the
    answering replica's cached one, which failover and hedging can leave
    behind the client's. One lock of a stripe per user keeps a history's
    update and its submit in one order."""

    def __init__(self, population: int, num_items: int, seq_len: int) -> None:
        self.population, self.num_items, self.seq_len = int(population), int(num_items), int(seq_len)
        self.histories = {}
        self._lock = threading.Lock()
        self._stripe = [threading.Lock() for _ in range(256)]

    def pick_user(self, rng) -> int:
        return int(rng.zipf(FLEET_ZIPF_A)) % self.population

    def history_for(self, user: int) -> list:
        with self._lock:
            history = self.histories.get(user)
            if history is None:
                user_rng = np.random.default_rng(900_000 + user)
                history = user_rng.integers(0, self.num_items, size=int(user_rng.integers(1, 2 * self.seq_len))).tolist()
                self.histories[user] = history
            return history

    def submit(self, target, rng, user=None):
        if user is None:
            user = self.pick_user(rng)
        with self._stripe[user % len(self._stripe)]:
            with self._lock:
                seeded = user in self.histories
            history = self.history_for(user)
            draw = rng.random() if seeded else 1.0
            if draw < 0.7:
                return target.submit(user), None
            if draw < 0.9:
                new_item = int(rng.integers(0, self.num_items))
                history.append(new_item)
                return target.submit(user, new_items=[new_item]), None
            items = list(history)
            return target.submit(user, history=items), items

    def reanchor(self, target, user: int):
        """The client's answer to a cold-cache refusal of an advance: resend
        the whole history (it both answers and seeds the new home)."""
        with self._stripe[user % len(self._stripe)]:
            items = list(self.history_for(user))
            return target.submit(user, history=items), items

    @property
    def touched(self) -> int:
        with self._lock:
            return len(self.histories)


def fleet_classify(exc) -> str:
    """bench_fleet.py's error taxonomy (``_classify``, :258-282); anything
    else is ``error`` and fails the phase."""
    from replay_tpu_torch.serve import CircuitOpen, DeadlineExceeded, NoHealthyReplica, RequestShed, ServiceClosed

    for kind, types in (
        ("shed", RequestShed), ("deadline_missed", DeadlineExceeded), ("circuit_refused", CircuitOpen),
        ("no_healthy", NoHealthyReplica), ("service_closed", ServiceClosed), ("cold_reanchor_needed", KeyError),
    ):
        if isinstance(exc, types):
            return kind
    return "error"


def fleet_closed_loop(target, traffic, seed: int) -> dict:
    """FLEET_CLIENTS threads × FLEET_CLOSED_REQUESTS requests, each waited for
    (bounded); a request still unanswered past FLEET_WAIT_S is a hang."""
    records, errors, lock = [], [], threading.Lock()

    def client(index: int) -> None:
        rng = np.random.default_rng(seed + index)
        for _ in range(FLEET_CLOSED_REQUESTS):
            future, items = traffic.submit(target, rng)
            try:
                response = future.result(timeout=FLEET_WAIT_S)
            except Exception as exc:  # noqa: BLE001 — classified below
                with lock:
                    errors.append(exc)
                continue
            with lock:
                records.append((items, response))

    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(FLEET_CLIENTS)]
    start = time.perf_counter()
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=FLEET_WAIT_S * 2)
    elapsed = time.perf_counter() - start
    if any(thread.is_alive() for thread in threads):
        raise AssertionError("fleet: a closed-loop client never finished")
    return {"qps": FLEET_CLIENTS * FLEET_CLOSED_REQUESTS / elapsed, "records": records, "errors": errors}


def fleet_summary(loop: dict) -> dict:
    """An ``open_loop`` through the fleet as bench_fleet.py reports it: qps,
    p50 and p99 of the answered, errors by kind of its taxonomy, and the
    answered requests' (items, response)."""
    kinds = dict(collections.Counter(loop["errors"]))
    if loop["cancelled"]:
        kinds["cancelled"] = loop["cancelled"]
    latencies, submitted = loop["latencies"], len(loop["records"])
    return {
        "submitted": submitted, "answered": len(latencies), "arrival_rate": loop["arrival_rate"],
        "qps": len(latencies) / loop["elapsed"], "p50_ms": percentile_ms(latencies, 0.5) if latencies else None,
        "p99_ms": percentile_ms(latencies, 0.99) if latencies else None, "hung_requests": loop["hung"],
        "errors_by_kind": kinds, "error_rate": sum(kinds.values()) / max(submitted, 1), "elapsed_s": loop["elapsed"],
        "records": [
            (items, f.result()) for items, f in loop["records"] if f.done() and not f.cancelled() and f.exception() is None
        ],
    }


def fleet_open_loop(target, traffic, rate: float, seconds: float, seed: int) -> dict:
    """``open_loop`` of ``traffic`` through ``target`` (a fleet or one
    service), FLEET_WAIT_S at most for each answer, summarised."""
    def submit(rng):
        return traffic.submit(target, rng)

    return fleet_summary(open_loop(submit, seconds, np.random.default_rng(seed), rate, FLEET_WAIT_S, fleet_classify))


def fleet_hit_rate(services) -> float:
    """State reuse across replicas (hits + advances over answered): the
    locality numerator (bench_fleet.py's ``_fleet_hit_rate``)."""
    reused = answered = 0
    for service in services:
        stats = service.stats()
        reused += stats["served_from"]["hit"] + stats["served_from"]["advance"]
        answered += stats["answered"]
    return reused / answered if answered else 0.0


def fleet_quiet(fleet) -> None:
    """Wait (bounded) until no replica holds queued or in-flight work, then
    for the card: a hedge's losing twin, already in a batch when its client
    was answered, may still be replaying after the client returned."""
    deadline = time.perf_counter() + FLEET_WAIT_S
    while not all(handle.service.batcher.idle for handle in fleet.handles.values()):
        if time.perf_counter() > deadline:
            raise AssertionError("fleet: a replica never went idle")
        time.sleep(0.002)
    torch.cuda.synchronize()


def fleet_drain_swap(fleet, traffic, candidate: dict) -> dict:
    """bench_fleet.py's rollout under load (``_run_drain_swap``, :653-720):
    FLEET_CLIENTS threads keep scoring while every replica in turn is
    drained, hot-swapped to ``candidate`` and rejoined. A cold-cache refusal
    of an advance is re-anchored with the whole history; any other error
    fails the phase."""
    records, latencies, errors, reanchors, lock, stop = [], [], [], [0], threading.Lock(), threading.Event()

    def client(index: int) -> None:
        rng = np.random.default_rng(7000 + index)
        while not stop.is_set():
            user = traffic.pick_user(rng)
            started = time.perf_counter()
            future, items = traffic.submit(fleet, rng, user=user)
            try:
                try:
                    response = future.result(timeout=FLEET_WAIT_S)
                except KeyError:
                    future, items = traffic.reanchor(fleet, user)
                    response = future.result(timeout=FLEET_WAIT_S)
                    with lock:
                        reanchors[0] += 1
            except Exception as exc:  # noqa: BLE001 — counted, must be none
                with lock:
                    errors.append(repr(exc))
                continue
            with lock:
                records.append((items, response))
                latencies.append(time.perf_counter() - started)

    threads = [threading.Thread(target=client, args=(i,), daemon=True) for i in range(FLEET_CLIENTS)]
    for thread in threads:
        thread.start()
    time.sleep(0.1)
    swap_start = time.perf_counter()
    results = fleet.rolling_swap(candidate, label="fleet-rollout")
    swap_seconds = time.perf_counter() - swap_start
    time.sleep(0.1)
    stop.set()
    for thread in threads:
        thread.join(timeout=FLEET_WAIT_S + 10)
    if any(thread.is_alive() for thread in threads):
        raise AssertionError("fleet: a drain-and-swap client never finished")
    if errors:
        raise AssertionError(f"fleet: drain-and-swap saw {len(errors)} errors: {errors[:3]}")
    return {
        "replicas_swapped": sum(1 for r in results if "generation" in r),
        "drained": sum(1 for r in results if r.get("drained")),
        "generations": sorted({r["generation"] for r in results if "generation" in r}),
        "requests": len(latencies), "reanchors": reanchors[0], "errors": 0,
        "p50_ms": percentile_ms(latencies, 0.5), "p99_ms": percentile_ms(latencies, 0.99),
        "rollout_seconds": swap_seconds,
        "served_generations": sorted({r.generation for _, r in records}), "records": records,
    }


def fleet_chaos(fleet, traffic, victim: str) -> dict:
    """bench_fleet.py's in-process chaos (``_run_chaos``, :384-488): open-loop
    traffic for FLEET_CHAOS_SECONDS; at a third the victim's service is
    closed, a probe measures the failover gap (kill → the first answer for a
    user homed on the victim), at two thirds it starts again and the monitor
    must see it healthy."""
    before = fleet.stats()
    box, done = {}, threading.Event()

    def generator():
        box["record"] = fleet_open_loop(fleet, traffic, FLEET_RATE, FLEET_CHAOS_SECONDS, seed=31)
        done.set()

    thread = threading.Thread(target=generator, daemon=True)
    thread.start()
    time.sleep(FLEET_CHAOS_SECONDS / 3.0)
    probe_user = next((u for u in list(traffic.histories) if fleet.ring.route(u) == victim), None)
    if probe_user is None:
        probe_user = next(u for u in range(traffic.population) if fleet.ring.route(u) == victim)
        traffic.history_for(probe_user)
    handle = fleet.handles[victim]
    kill_at = time.perf_counter()
    handle.service.close()
    gap_ms = served_by = replica = trace_id = None
    probe_rng = np.random.default_rng(47)
    while time.perf_counter() < kill_at + max(10.0, FLEET_CHAOS_SECONDS):
        future, _ = traffic.submit(fleet, probe_rng, user=probe_user)
        try:
            response = future.result(timeout=5.0)
        except Exception:  # noqa: BLE001 — the gap is these failures
            time.sleep(0.01)
            continue
        gap_ms = (time.perf_counter() - kill_at) * 1e3
        served_by, replica, trace_id = response.served_by, response.replica, response.trace_id
        break
    time.sleep(max(FLEET_CHAOS_SECONDS * 2.0 / 3.0 - (time.perf_counter() - kill_at), 0.0))
    dead_observed = fleet.health().get(victim)
    handle.service.start()
    revived, revive_start = False, time.perf_counter()
    while time.perf_counter() < revive_start + max(5.0, 20 * FLEET_HEARTBEAT_S):
        if fleet.health().get(victim) == "healthy":
            revived = True
            break
        time.sleep(FLEET_HEARTBEAT_S)
    if not done.wait(timeout=FLEET_CHAOS_SECONDS + FLEET_WAIT_S + 20):
        raise AssertionError("fleet: the chaos traffic never finished")
    after = fleet.stats()
    record = box["record"]
    return {
        "killed": victim, "dead_observed": dead_observed, "revived": revived, "failover_gap_ms": gap_ms,
        "failover_served_by": served_by, "failover_replica": replica, "failover_trace_id": trace_id,
        "reroutes": after["reroutes"] - before["reroutes"], "retries": after["retries"] - before["retries"],
        "failovers": after["failovers"] - before["failovers"], **{k: v for k, v in record.items() if k != "records"},
        "records": record["records"],
    }


def process_rss(pids) -> dict:
    """Each process's resident host memory (``VmRSS``); the card's share of
    the server processes is read from its free memory (a machine may hide
    other processes from ``nvidia-smi``)."""
    out = {}
    for pid in pids:
        with contextlib.suppress(OSError), open(f"/proc/{pid}/status") as fh:
            out[str(pid)] = next((line.split()[1] + " kB" for line in fh if line.startswith("VmRSS")), None)
    return out


def fleet_socket_chaos(run_dir: str, device) -> dict:
    """bench_fleet.py's socket chaos (``_run_socket_chaos``, :491-650) on the
    card: FLEET_SOCKET_REPLICAS ``python -m replay_tpu_torch.serve.remote``
    processes (each its own CUDA context and graphs, the demo SASRec on K4)
    behind ``RemoteReplica``s, open-loop traffic, one server SIGKILLed a third
    of the way in and respawned on a fresh port at two thirds; the startup
    time and each process's memory; the members' ``/snapshot``s federated;
    the victim's flight ring read after the kill. The card's free memory
    before the spawn, with the servers up, after the kill (which must give
    the victim's share back) and after the respawn. Every server's K4
    launches since it started taking requests (``GET /launches``; the
    victim's read just before the kill): each must have launched K4, and a
    survivor once per block of each encode batch and capture warm-up. Every
    primary answer with a window is held to the demo model on the unfused
    attention in this process (the servers' seed-0 weights)."""
    from replay_tpu_torch.obs import FleetFederator, read_flight
    from replay_tpu_torch.serve import RemoteReplica, ReplicaServerProcess, ScoringEngine, ServingFleet
    from replay_tpu_torch.serve.remote import DEMO_BATCH_BUCKETS, _demo_model
    from replay_tpu_torch.utils import KillAtStep

    widths = (FLEET_SOCKET_ITEMS, FLEET_SOCKET_LEN, FLEET_SOCKET_DIM, FLEET_SOCKET_BLOCKS, device)
    demo_params = _demo_model(*widths).state_dict()
    plain = ScoringEngine(_demo_model(*widths, use_flash=False), demo_params, batch_buckets=DEMO_BATCH_BUCKETS, device=device)

    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (os.path.dirname(os.path.abspath(__file__)), env.get("PYTHONPATH")) if p)
    servers = [
        ReplicaServerProcess(
            env=env, args=["--device", device.type, *FLEET_SOCKET_ARGS], startup_timeout_s=FLEET_STARTUP_S,
            flight_path=os.path.join(run_dir, f"flight.s{i}.ring"), metrics_port=0,
        )
        for i in range(FLEET_SOCKET_REPLICAS)
    ]
    def free_mib():
        return torch.cuda.mem_get_info(device)[0] / 2**20 if device.type == "cuda" else None

    free = {"before": free_mib()}
    try:
        spawn_start = time.perf_counter()
        for server in servers:  # the servers start and capture at once
            server.spawn(wait=False)
        for server in servers:
            server.wait_ready()
        spawn_seconds = time.perf_counter() - spawn_start
        free["servers_up"] = free_mib()
        replicas = {f"s{i}": RemoteReplica(server) for i, server in enumerate(servers)}
        fleet = ServingFleet(replicas, heartbeat_interval_s=FLEET_HEARTBEAT_S, heartbeat_misses=3)
        traffic = FleetTraffic(10_000, FLEET_SOCKET_ITEMS, FLEET_SOCKET_LEN)
        victim, victim_server = "s1", servers[1]
        with fleet:
            box, done = {}, threading.Event()

            def generator():
                box["record"] = fleet_open_loop(fleet, traffic, FLEET_SOCKET_RATE, FLEET_CHAOS_SECONDS, seed=53)
                done.set()

            thread = threading.Thread(target=generator, daemon=True)
            thread.start()
            time.sleep(FLEET_CHAOS_SECONDS / 3.0)
            memory = process_rss([s.pid for s in servers])
            federated = FleetFederator([s.metrics_url for s in servers], port=0).scrape()
            probe_user = next(u for u in range(traffic.population) if fleet.ring.route(u) == victim)
            with contextlib.suppress(Exception):  # seeding is best-effort
                fleet.score(probe_user, history=traffic.history_for(probe_user), timeout=FLEET_WAIT_S)
            launches = {f"{victim}_killed": replicas[victim].launches()}
            kill_at = time.perf_counter()
            KillAtStep(pid=victim_server.pid).fire()
            sigkill_rc = victim_server.proc.wait(timeout=30)
            flight = read_flight(victim_server.flight_path)
            freed_by = time.perf_counter() + 10.0  # the CUDA runtime frees a dead context shortly after
            while free["servers_up"] is not None and time.perf_counter() < freed_by:
                free["after_kill"] = free_mib()
                if free["after_kill"] > free["servers_up"] + 64:
                    break
                time.sleep(0.05)
            gap_ms = replica = None
            probe_rng = np.random.default_rng(59)
            while time.perf_counter() < kill_at + max(10.0, FLEET_CHAOS_SECONDS):
                future, _ = traffic.submit(fleet, probe_rng, user=probe_user)
                try:
                    response = future.result(timeout=5.0)
                except Exception:  # noqa: BLE001 — the gap is these failures
                    time.sleep(0.01)
                    continue
                gap_ms, replica = (time.perf_counter() - kill_at) * 1e3, response.replica
                break
            time.sleep(max(FLEET_CHAOS_SECONDS * 2.0 / 3.0 - (time.perf_counter() - kill_at), 0.0))
            dead_observed = fleet.health().get(victim)
            old_address = replicas[victim].address
            respawn_start = time.perf_counter()
            victim_server.respawn()
            respawn_seconds = time.perf_counter() - respawn_start
            free["after_respawn"] = free_mib()
            address_changed = replicas[victim].address != old_address
            revived, revive_start = False, time.perf_counter()
            while time.perf_counter() < revive_start + max(5.0, 30 * FLEET_HEARTBEAT_S):
                if fleet.health().get(victim) == "healthy":
                    revived = True
                    break
                time.sleep(FLEET_HEARTBEAT_S)
            if not done.wait(timeout=FLEET_CHAOS_SECONDS + FLEET_WAIT_S + 20):
                raise AssertionError("fleet: the socket-chaos traffic never finished")
            # the respawned server comes up after the traffic's end: users
            # homed on it send their windows, which its own graphs answer
            rejoined = []
            homed = (u for u in range(traffic.population) if fleet.ring.route(u) == victim)
            for user in itertools.islice(homed, 8) if revived else ():
                items = list(traffic.history_for(user))
                rejoined.append((items, fleet.score(user, history=items, timeout=FLEET_WAIT_S)))
            stats = fleet.stats()
            # a hedge's losing twin runs on in its server: read until two
            # reads agree (bounded)
            previous, settled_by = None, time.perf_counter() + 10.0
            while time.perf_counter() < settled_by:
                current = {rid: replica.launches() for rid, replica in replicas.items()}
                if current == previous:
                    break
                previous = current
                time.sleep(0.2)
            launches.update(current)
        record = box["record"]
        kinds = record["errors_by_kind"]
        direct = fleet_direct_check(plain, {0: demo_params}, record["records"] + rejoined, seq_len=FLEET_SOCKET_LEN)
        direct["rejoined_answers_by"] = dict(collections.Counter(f"{r.replica}/{r.served_by}" for _, r in rejoined))
        out = {
            "replicas": FLEET_SOCKET_REPLICAS, "killed": victim, "sigkill_rc": sigkill_rc,
            "dead_observed": dead_observed, "revived": revived, "respawned_address_changed": address_changed,
            "failover_gap_ms": gap_ms, "failover_replica": replica, "spawn_seconds": spawn_seconds,
            "respawn_seconds": respawn_seconds, "host_rss": memory, "free_device_mib": free,
            "federated_rows": federated.registry.value("replay_serve_rows_total"),
            "federated_batches": federated.registry.value("replay_serve_batches_total"),
            "federated_members": len(federated.members), "federation_errors": federated.errors,
            "flight_last_seqno": flight.last_seqno, "flight_records_recovered": flight.recovered,
            "torn_tail": flight.torn_tail, "taxonomy_only": kinds.get("error", 0) == 0,
            "reroutes": stats["reroutes"], "retries": stats["retries"], "hedges": stats["hedges"],
            "k4_launches": sum(counted["flash_attention"] for counted in launches.values()),
            "launches_by_server": launches, "direct": direct,
            **{k: v for k, v in record.items() if k != "records"},
        }
    finally:
        for server in servers:
            server.terminate()
    for name, counted in launches.items():
        settled = name.endswith("_killed") or counted["flash_attention"] == FLEET_SOCKET_BLOCKS * (
            counted["encode_calls"] + counted["warmups"]
        )
        if counted["flash_attention"] < 1 or not settled:
            raise AssertionError(f"fleet: server {name} launched K4 {counted['flash_attention']} times: {counted}")
    if direct["checked"] < 1 or direct["rejoined_answers_by"] != {f"{victim}/primary": 8}:
        raise AssertionError(f"fleet: the socket answers held to the direct path: {direct}")
    if out["hung_requests"] or not out["taxonomy_only"] or out["sigkill_rc"] != -9:
        raise AssertionError(f"fleet: socket chaos {out}")
    if out["dead_observed"] != "dead" or not out["revived"] or not out["respawned_address_changed"]:
        raise AssertionError(f"fleet: the killed server was not declared dead, respawned and taken back: {out}")
    if free["servers_up"] is not None and free.get("after_kill", 0.0) <= free["servers_up"] + 64:
        raise AssertionError(f"fleet: the SIGKILLed server's device memory was not freed: {free}")
    return out


def quality_observe_us(descriptor, records) -> float:
    """Host microseconds of one ``QualityMonitor.observe`` of a full-catalog
    response (the work each replica's serve worker does per response before
    resolving it), over ``records`` fed to a fresh monitor."""
    from replay_tpu_torch.obs import QualityMonitor
    from replay_tpu_torch.serve import ScoreRequest

    monitor = QualityMonitor(descriptor)
    requests = [(ScoreRequest(user_id=r.user_id, history=items), r) for items, r in records]
    start = time.perf_counter()
    for request, response in requests:
        monitor.observe(response, request)
    return (time.perf_counter() - start) / max(len(requests), 1) * 1e6


def fleet_cache_probe(fleet, traffic, users, kinds, seed: int) -> list:
    """Bursts of requests for ``users`` through the quiet fleet, one burst
    per entry of ``kinds``: ``history`` (the whole window), ``hit`` (nothing)
    or ``advance`` (one new item). Each answer comes back with the window the
    client holds after its request: a hit or an advance answers from the home
    replica's cached state, which must hold that window (the traffic never
    draws these users, so no failover or hedge moved them), and after a swap
    a hit on a state of the old generation must re-encode on the new one."""
    rng = np.random.default_rng(seed)
    records = []
    for kind in kinds:
        sent = []
        for user in users:
            history = traffic.history_for(user)
            if kind == "history":
                future = fleet.submit(user, history=list(history))
            elif kind == "hit":
                future = fleet.submit(user)
            else:
                history.append(int(rng.integers(0, traffic.num_items)))
                future = fleet.submit(user, new_items=history[-1:])
            sent.append((list(history), future))
        records += [(items, future.result(timeout=FLEET_WAIT_S)) for items, future in sent]
        fleet_quiet(fleet)
    return records


def fleet_direct_check(plain, generations: dict, records, seq_len: int = SEQ_LEN) -> dict:
    """Every primary response of ``records`` with a window (a request that
    carried its history, or one of ``fleet_cache_probe``), held to the
    unfused model's logits for that window (the last ``seq_len`` items) at
    the response's batch bucket and with the weights of the response's
    generation: one that mixed two generations matches neither. Returns the
    reading; fails the phase on a response beyond SERVE_TOL."""
    from replay_tpu_torch.serve import make_window

    groups, skipped = {}, {}
    for items, response in records:
        if items is None:
            continue
        if response.served_by != "primary":
            skipped[response.served_by] = skipped.get(response.served_by, 0) + 1
            continue
        if response.generation not in generations:
            raise AssertionError(f"fleet: a response of generation {response.generation}, not one of {sorted(generations)}")
        groups.setdefault((response.batch_bucket, response.generation), []).append((items, response))
    checked, max_err, failures = 0, 0.0, []
    for (bucket, generation), group in sorted(groups.items()):
        for start in range(0, len(group), bucket):
            chunk = group[start : start + bucket]
            rows = [make_window(items, seq_len) for items, _ in chunk]
            rows += rows[:1] * (bucket - len(rows))
            logits, _ = plain.encode(
                seq_len, np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]), params=generations[generation]
            )
            want = logits[: len(chunk)].double().cpu().numpy()
            for (items, response), row in zip(chunk, want):
                got = np.asarray(response.scores, np.float64)
                if got.shape != row.shape or not np.isfinite(got).all():
                    failures.append(f"user {response.user_id}: scores {got.shape}")
                    continue
                err = float(np.abs(got - row).max())
                max_err = max(max_err, err)
                checked += 1
                if err > SERVE_TOL:
                    failures.append(f"user {response.user_id} (gen {generation}, bucket {bucket}): max err {err}")
    if failures:
        raise AssertionError(f"fleet responses differ from the direct path: {failures[:5]} ({len(failures)})")
    return {"checked": checked, "max_score_err": max_err, "not_primary": skipped, "tol": SERVE_TOL}


def fleet_report(run_dir: str) -> dict:
    """The run directory through the port's run report (``python -m
    replay_tpu_torch.obs.report``, text and ``--json``) and its post-mortem;
    either raising or exiting non-zero fails the phase."""
    import io

    from replay_tpu_torch.obs import report
    from replay_tpu_torch.obs.postmortem import build_postmortem, render_postmortem

    outputs = {}
    for mode, argv in (("text", [run_dir]), ("json", [run_dir, "--json"]), ("postmortem", [run_dir, "--postmortem", "--json"])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code = report.main(argv)
        if code != 0:
            raise AssertionError(f"fleet: obs.report {mode} exited {code}: {out.getvalue()[-2000:]}")
        outputs[mode] = out.getvalue()
    summary = json.loads(outputs["json"])
    fleet = summary.get("fleet") or {}
    missing = {f"r{i}" for i in range(FLEET_REPLICAS)} - set(fleet.get("per_replica") or {})
    if missing or not summary.get("tail_attribution") or "tail attribution" not in outputs["text"]:
        raise AssertionError(f"fleet: the report lacks replicas {sorted(missing)} or the tail attribution")
    post = build_postmortem(run_dir)
    render_postmortem(post)
    return {
        "report_lines": len(outputs["text"].splitlines()),
        "fleet_section": {k: fleet.get(k) for k in ("health_transitions", "failover_events", "hedge_events", "requests", "reroutes")},
        "tail_attribution_p99": (summary["tail_attribution"]["quantiles"].get("p99") or {}).get("fractions"),
        "postmortem": {
            key: {k: v for k, v in proc.items() if k in ("flight_records_recovered", "torn_tail", "dead", "last_flight_record")}
            for key, proc in post["processes"].items() if key.startswith("s")
        },
        "rings": len(post["rings"]), "torn_tails": post["torn_tails"], "unreadable_rings": post["unreadable_rings"],
    }


def fleet_models(device):
    """The fleet's SASRec at bench_serve.py's width on K4, its unfused twin,
    the weights, the popularity fallback and the quality monitors' shared
    popularity descriptor (one popularity draw for both)."""
    from replay_tpu_torch.data import FeatureHint, FeatureType
    from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema
    from replay_tpu_torch.nn.sequential.sasrec import SasRec
    from replay_tpu_torch.obs import PopularityDescriptor
    from replay_tpu_torch.serve import FallbackScorer

    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
            cardinality=NUM_ITEMS, embedding_dim=EMBEDDING_DIM,
        )
    )
    width = dict(
        embedding_dim=EMBEDDING_DIM, num_blocks=NUM_BLOCKS, num_heads=NUM_HEADS, max_sequence_length=SEQ_LEN,
        dropout_rate=0.0, device=device,
    )
    model = SasRec(schema, use_flash=True, generator=torch.Generator().manual_seed(SEED), **width)
    plain_model = SasRec(schema, use_flash=False, **width)
    popularity = np.random.default_rng(SEED).integers(0, NUM_ITEMS, size=8192)
    fallback = FallbackScorer.from_interactions(popularity, NUM_ITEMS)
    descriptor = PopularityDescriptor.from_train({0: popularity.tolist()}, num_items=NUM_ITEMS)
    return model, plain_model, model.state_dict(), fallback, descriptor


def fleet_service(model, params, fallback, device, logger=None, tracer=None, quality=None):
    """One replica (or the baseline) as bench_fleet.py builds them: full
    mode, FLEET_CACHE entries, cold misses answered by the fallback."""
    from replay_tpu_torch.serve import FallbackScorer, ScoringService

    return ScoringService(
        model, params, batch_buckets=BATCH_BUCKETS, max_wait_ms=FLEET_MAX_WAIT_MS, cache_capacity=FLEET_CACHE,
        logger=logger, tracer=tracer, cold_miss="fallback", fallback=FallbackScorer(fallback.item_scores),
        quality=quality, device=device,
    )


def fleet_phase(device) -> dict:
    """bench_fleet.py on the card at its defaults (module constants FLEET_*):
    FLEET_REPLICAS ``ScoringService`` replicas of the bench_serve.py SASRec on
    K4 behind the consistent-hash router, each with a ``QualityMonitor`` over
    one shared popularity descriptor, a live ``Tracer`` and an events shard;
    the single-replica baseline, the closed and open loops, a profiled
    second, the drain-and-swap rollout, in-process chaos and socket chaos;
    every primary response to a history-carrying request held to the unfused
    model with its generation's weights; the merged trace, the run report and
    the post-mortem. Returns K4's launches on the main path."""
    import tempfile

    from replay_tpu_torch.obs import JsonlLogger, QualityMonitor, Tracer, merge_traces
    from replay_tpu_torch.ops.flash_attention import flash_attention
    from replay_tpu_torch.serve import ScoringEngine, ServingFleet

    model, plain_model, params, fallback, descriptor = fleet_models(device)
    candidate = {k: v * FLEET_SWAP_SCALE if v.is_floating_point() else v for k, v in params.items()}
    plain = ScoringEngine(plain_model, params, batch_buckets=BATCH_BUCKETS, device=device)
    run_dir = tempfile.mkdtemp(prefix="fleet_run_")

    def build(logger=None, tracer=None, quality=None):
        return fleet_service(model, params, fallback, device, logger=logger, tracer=tracer, quality=quality)

    try:
        build_start = time.perf_counter()
        fleet_logger = JsonlLogger(run_dir, mode="w")
        replica_loggers = [JsonlLogger(run_dir, mode="w", process_index=i + 1) for i in range(FLEET_REPLICAS)]
        router_tracer = Tracer(enabled=True)
        tracers = {f"r{i}": Tracer(enabled=True) for i in range(FLEET_REPLICAS)}
        services = {
            rid: build(replica_loggers[i], tracers[rid], QualityMonitor(descriptor)) for i, rid in enumerate(tracers)
        }
        baseline = build()
        build_seconds = time.perf_counter() - build_start
        engines = [s.engine for s in (*services.values(), baseline)]
        warmups_before = sum(e.graph_counts()["encode"]["warmups"] for e in engines)

        # the main path: K4's count starts at 0 here and is read once the fleet closes
        flash_attention.launches = 0
        traffic = FleetTraffic(FLEET_USERS, NUM_ITEMS, SEQ_LEN)
        with baseline:
            single_closed = fleet_closed_loop(baseline, traffic, seed=100)
            single_open = fleet_open_loop(baseline, traffic, FLEET_RATE, max(FLEET_SECONDS / 2.0, 1.0), seed=11)
            single_hit_rate = fleet_hit_rate([baseline])
        # fresh histories: the fleet builds its own cache locality
        traffic = FleetTraffic(FLEET_USERS, NUM_ITEMS, SEQ_LEN)
        fleet = ServingFleet(
            services, hedge_ms=None, heartbeat_interval_s=FLEET_HEARTBEAT_S, logger=fleet_logger, tracer=router_tracer,
        )
        with fleet:
            closed = fleet_closed_loop(fleet, traffic, seed=200)
            steady = fleet_open_loop(fleet, traffic, FLEET_RATE, FLEET_SECONDS, seed=21)
            fleet_hit = fleet_hit_rate(services.values())
            profiled = profiled_open_second(
                lambda rng: traffic.submit(fleet, rng), np.random.default_rng(41), FLEET_RATE, fleet_classify,
                functools.partial(fleet_quiet, fleet),
            )
            profiled["second"] = fleet_summary(profiled)
            # users the traffic never draws (ids past the population): their
            # hits and advances are held to the windows they sent, before the
            # rollout and after it
            probe_traffic = FleetTraffic(FLEET_USERS, NUM_ITEMS, SEQ_LEN)
            probe_users = range(FLEET_USERS, FLEET_USERS + FLEET_PROBE_USERS)
            probe_before = fleet_cache_probe(fleet, probe_traffic, probe_users, ("history", "hit", "advance", "hit"), 43)
            drain_swap = fleet_drain_swap(fleet, traffic, candidate)
            probe_after = fleet_cache_probe(fleet, probe_traffic, probe_users, ("hit", "advance", "hit"), 47)
            chaos = fleet_chaos(fleet, traffic, victim="r1")
            final = fleet.stats()
            per_replica = {}
            for rid, service in services.items():
                stats, router = service.stats(), final["per_replica"][rid]
                per_replica[rid] = {
                    "routed": router["routed"], "answered": stats["answered"], "cache_hit_rate": stats["cache_hit_rate"],
                    "errors": stats["errors"], "health": router["health"], "health_transitions": router["health_transitions"],
                    "hedges": router["hedges"], "hedge_wins": router["hedge_wins"],
                    "hedge_cancelled": router["hedge_cancelled"], "retries": router["retries"],
                }
        torch.cuda.synchronize()
        launches = flash_attention.launches
        encode_calls = sum(e.encode_calls for e in engines)
        warmups = sum(e.graph_counts()["encode"]["warmups"] for e in engines) - warmups_before

        hung = sum(part["hung_requests"] for part in (single_open, steady, profiled["second"], chaos))
        kinds = {}
        for part in (single_open, steady, profiled["second"], chaos):
            for kind, count in part["errors_by_kind"].items():
                kinds[kind] = kinds.get(kind, 0) + count
        for exc in single_closed["errors"] + closed["errors"]:
            kinds[fleet_classify(exc)] = kinds.get(fleet_classify(exc), 0) + 1
        if hung or kinds.get("error"):
            raise AssertionError(f"fleet: {hung} hung requests, errors by kind {kinds}")
        if launches < 1 or launches != NUM_BLOCKS * (encode_calls + warmups):
            raise AssertionError(f"fleet: K4 ran {launches} times, not {NUM_BLOCKS} x ({encode_calls} + {warmups})")
        if chaos["dead_observed"] != "dead" or not chaos["revived"]:
            raise AssertionError(f"fleet: the closed replica was not declared dead and taken back: {chaos['dead_observed']}")
        records = (
            single_closed["records"] + single_open["records"] + closed["records"] + steady["records"]
            + profiled["second"]["records"] + drain_swap["records"] + chaos["records"]
        )
        reading = fleet_direct_check(plain, {0: params, 1: candidate}, records)
        probe = fleet_direct_check(plain, {0: params, 1: candidate}, probe_before + probe_after)
        probe["served_from"] = dict(collections.Counter(r.served_from for _, r in probe_before + probe_after))
        probe["after_swap_generations"] = sorted({r.generation for _, r in probe_after})
        if probe["checked"] != len(probe_before) + len(probe_after) or probe["after_swap_generations"] != [1]:
            raise AssertionError(f"fleet: the cache probe's answers were not all primary on their generation: {probe}")
        observe_us = quality_observe_us(descriptor, closed["records"])
        # the router alone: the bare baseline replica (no tracer, logger or
        # monitor) behind a fleet of one, the same closed loop on fresh users
        with ServingFleet({"r0": baseline}, hedge_ms=None, heartbeat_interval_s=FLEET_HEARTBEAT_S) as solo:
            router_only = fleet_closed_loop(solo, FleetTraffic(FLEET_USERS, NUM_ITEMS, SEQ_LEN), seed=300)
        if router_only["errors"]:
            raise AssertionError(f"fleet: the one-replica fleet saw errors {router_only['errors'][:3]}")

        socket = fleet_socket_chaos(run_dir, device)
        merge_traces({"router": router_tracer, **tracers}, os.path.join(run_dir, "trace.json"))
        locality = fleet_hit / single_hit_rate if single_hit_rate else None
        record = {
            "metric": "fleet_qps", "value": steady["qps"], "unit": "req/s", "qps": steady["qps"],
            "arrival_rate": steady["arrival_rate"], "closed_loop_qps": closed["qps"], "p50_ms": steady["p50_ms"],
            "p99_ms": steady["p99_ms"], "replicas": FLEET_REPLICAS, "users_population": FLEET_USERS,
            "users_touched": traffic.touched, "requests": final["requests"], "fleet_error_rate": final["error_rate"],
            "hung_requests": hung, "errors_by_kind": kinds, "reroutes": final["reroutes"],
            "reroute_rate": final["reroute_rate"], "retries": final["retries"], "hedges": final["hedges"],
            "hedge_wins": final["hedge_wins"], "hedge_cancelled": final["hedge_cancelled"],
            "failovers": final["failovers"], "cache_hit_rate": fleet_hit, "single_replica_qps": single_closed["qps"],
            "single_replica_open_qps": single_open["qps"], "single_replica_p50_ms": single_open["p50_ms"],
            "single_replica_p99_ms": single_open["p99_ms"], "single_replica_hit_rate": single_hit_rate,
            "cache_hit_locality": locality, "qps_vs_single": closed["qps"] / single_closed["qps"],
            "per_replica": per_replica, "quality": final.get("quality"),
            "latency_exemplars": final["latency_exemplars"],
            "replica_shards": {str(i + 1): f"r{i}" for i in range(FLEET_REPLICAS)},
            "drain_swap": {k: v for k, v in drain_swap.items() if k != "records"},
            "chaos": {k: v for k, v in chaos.items() if k != "records"}, "socket_chaos": socket,
            "batch_buckets": list(BATCH_BUCKETS), "open_loop_rate": FLEET_RATE, "open_loop_seconds": FLEET_SECONDS,
            "clients": FLEET_CLIENTS, "build_seconds": build_seconds,
        }
        fleet_logger.log_record(record)
        fleet_logger.close()
        for logger in replica_loggers:
            logger.close()
        report = fleet_report(run_dir)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    quality = record["quality"] or {}
    emit(
        "fleet", part="steady", router_only_closed_qps=router_only["qps"], **{k: record[k] for k in (
            "qps", "arrival_rate", "closed_loop_qps", "p50_ms", "p99_ms", "single_replica_qps",
            "single_replica_open_qps", "single_replica_p50_ms", "single_replica_p99_ms", "qps_vs_single",
            "cache_hit_rate", "single_replica_hit_rate", "cache_hit_locality", "reroutes", "retries", "hedges",
            "hedge_wins", "hedge_cancelled", "failovers", "hung_requests", "errors_by_kind", "users_touched",
            "requests", "build_seconds", "per_replica",
        )},
        steady_errors_by_kind=steady["errors_by_kind"], single_open_arrival_rate=single_open["arrival_rate"],
    )
    emit("fleet", part="profiled_second", requests=profiled["second"]["submitted"], **{k: profiled[k] for k in (
        "device_ms_per_s", "device_busy_share", "traced_k4_kernels", "k4_launched_in_window", "lost_records",
        "top_device_ms",
    )})
    emit("fleet", part="drain_swap", **record["drain_swap"])
    emit("fleet", part="chaos", **record["chaos"])
    emit("fleet", part="socket_chaos", **socket)
    emit("fleet", part="quality", observe_us=observe_us, joins=quality.get("joins"),
         online_hitrate_cum=quality.get("online_hitrate_cum"),
         drift_psi_max=quality.get("drift_psi_max"),
         per_replica_observed={rid: q.get("observed") for rid, q in (quality.get("per_replica") or {}).items()})
    emit("fleet", part="checks", k4_launches=launches, encode_batches=encode_calls, capture_warmups=warmups,
         num_blocks=NUM_BLOCKS, direct=reading, cache_probe=probe, report=report)
    emit("fleet", part="sharded_retrieval", run=False,
         reason="bench_fleet.py:723 needs MIPSIndex(mesh=...), the mesh-sharded index of the rest of item 9")
    release()
    return {"launches": launches, "socket_launches": socket["k4_launches"]}


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

    for name, (seconds, report) in build.build_all(["flash_attention", "fused_ce", "flash_tiled"]).items():
        emit("build", kernel=name, seconds=seconds, ptxas=report.strip().splitlines())

    k4 = kernel_phase(device)
    fused = fused_ce_phase(device)
    flash_backward_check(device)
    tiled_records = tiled_kernel_phase(device)
    tiled_backward_check(device)
    served = serve_phase(device)
    serviced = service_phase(device)
    retrieval = retrieval_phase(device)
    serialized = serialize_phase(device)
    trained = train_phase(device)
    observed = observe_phase(device)
    longseq = longseq_phase(device)
    bert4rec = bert4rec_phase(device)
    twotower = twotower_phase(device)
    lifecycle = lifecycle_phase(device)
    stream = stream_phase(device)
    scaled = scale_phase(device)
    continual = continual_phase(device)
    family = family_phase(device)
    distributed = distributed_phase(device)
    fleet = fleet_phase(device)

    kernels = kernel_records(
        k4, fused, tiled_records, served, serviced, retrieval, serialized, trained, longseq, bert4rec, twotower,
        lifecycle, stream, observed, scaled, continual, family, distributed, fleet,
    )
    emit("kernels", kernels=[{k: r[k] for k in ("name", "launches", "passed")} for r in kernels])
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    device_record = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device_record}), flush=True)
    return 0


def k4_entry(name: str, record: dict, by_path: dict) -> dict:
    """A kernels-line entry of K4 at one instantiation (a kernel-phase record)."""
    return {
        "name": name,
        "route": "cuda",
        "source": "replay_tpu_torch/csrc/flash_attention.cu",
        "replaces": "replay_tpu/ops/flash_attention.py:32",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": record["max_abs_err"],
        "ms": record["ms"],
        "plain_ms": record["plain_ms"],
        "bound_ms": record["bound_ms"],
        "bound_by": record["bound_by"],
        "library_ms": record["library_ms"],
        "passed": True,
        "shape": f"B={record['B']} H={record['H']} L={record['L']} D={record['D']} {record['mask']} {record['dtype']}",
    }


def kernel_records(
    k4, fused, tiled_records, served, serviced, retrieval, serialized, trained, longseq, bert4rec, twotower, lifecycle,
    stream, observed, scaled, continual, family, distributed, fleet,
) -> list:
    """The kernels line: every kernel of the paths driven, one entry per
    instantiation a path runs, with its launches there (counted through graph
    replays: the serving paths and ``*_graph`` run on captured graphs); raises
    if one of them launched no time."""
    k4_paths = {
        "serve": served["launches"], "service": serviced["launches"], "retrieval": retrieval["launches"],
        "serialize": serialized["launches"],
        "train": trained["flash_attention"], "train_graph": trained["graph"]["flash_attention"],
        "observe": observed["flash_attention"],
        # the family phase at the bench.py width: remat "dots" (each block's
        # forward twice a step), the SASRec over list and numerical features
        "family_remat_k4": family["remat_k4"]["bench"]["launches"]["flash_attention"],
        "family_embedders": family["embedders"]["launches"]["flash_attention"],
        # the dp row's two ranks at the same width, summed
        "distributed_dp": distributed["dp"]["launches_total"]["flash_attention"],
        # the fleet's in-process replicas and its single-replica baseline
        "fleet": fleet["launches"],
    }
    kernels = [k4_entry("flash_attention", k4[("serve", torch.float32)], k4_paths)]
    # K4 on the BERT4Rec (D=75, bidirectional) and TwoTower (D=32, causal)
    # paths: the trainers in f32 and bf16 (eager and on graphs), the serving
    # programs in f32
    for model, result in (("bert4rec", bert4rec), ("twotower", twotower)):
        for dtype, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
            train = result["train"]["f32" if dtype == torch.float32 else "bf16"]
            by_path = {
                f"{model}_train": train["k4_launches"],
                f"{model}_train_graph": train["chunked"]["launches"]["flash_attention"],
            }
            if dtype == torch.float32:
                by_path[f"{model}_serve"] = result["serve"]["k4_launches"]
            if model == "twotower" and dtype == torch.float32:
                by_path["twotower_query_embeddings"] = result["query_embeddings"]["k4_launches"]
            if model == "bert4rec" and dtype == torch.float32:
                by_path["family_remat_k4_bert4rec"] = family["remat_k4"]["bert4rec"]["launches"]
            kernels.append(k4_entry(f"flash_attention_{model}{suffix}", k4[(model, dtype)], by_path))
    # K4 at notebook 09's width (D=32, batch 32, f32): the lifecycle's
    # notebook run, its training graphs, tails and validation
    # and bench_continual.py's loop at the same width (the continual phase)
    kernels.append(
        k4_entry("flash_attention_notebook", k4[("notebook", torch.float32)],
                 {"lifecycle": lifecycle["notebook"]["k4_launches"], "lifecycle_test": lifecycle["notebook"]["test_k4_launches"],
                  "continual": continual["k4_launches"]})
    )
    # K4 at the catalog-scaling width (B=512, D=64, causal, bf16): each
    # scale row's eager steps and K=8 graphs
    scale_paths = {f"scale_{row}": count for row, count in scaled["k4"].items()}
    scale_paths.update({f"scale_{row}_graph": count for row, count in scaled["k4_graph"].items()})
    kernels.append(k4_entry("flash_attention_scale_bf16", k4[("scale", torch.bfloat16)], scale_paths))
    # K4 at the demo server's width (D=8, L=12, f32, batch buckets 1 and 8;
    # timed at 8): the fleet phase's server processes, each counting its own
    kernels.append(k4_entry("flash_attention_demo", k4[("demo", torch.float32)], {"fleet_socket": fleet["socket_launches"]}))
    # K1–K3, one entry per kernel and instantiation on the paths: f32 at the
    # bench.py width (train), bf16 hidden states at the long-sequence width
    # (the bf16 trainer), f32 there (the f32 trainer)
    fused_kernels = (
        ("fused_lse_forward", "K1", 132), ("fused_lse_dh", "K2", 156), ("fused_lse_dw", "K3", 177),
    )
    fused_paths = (
        ("", "train_f32", {"train": trained, "train_graph": trained["graph"], "observe": observed,
                           "family_remat_k4": family["remat_k4"]["bench"]["launches"],
                           "family_embedders": family["embedders"]["launches"],
                           "distributed_dp": distributed["dp"]["launches_total"]}),
        ("_longseq_bf16_hidden", "longseq_bf16_hidden", {"longseq_train": longseq["train"], "longseq_train_graph": longseq["graph"],
                                                         "family_remat_k5": family["remat_k5"]["launches"]}),
        ("_longseq_f32", "longseq_f32", {"longseq_f32_train": longseq["f32_train"]}),
    )
    fused_paths += (("_notebook", "notebook", {"lifecycle_cefused": lifecycle["cefused"]["launches"]}),)
    # bf16 hidden states at the bench.py width: the stream phase's packed row
    # with CEFused, its eager steps and its K=8 graphs
    fused_paths += (
        ("_stream_bf16_hidden", "train_bf16_hidden",
         {"stream_packed": stream["fused_eager"], "stream_packed_graph": stream["fused_graph"]}),
    )
    # bf16 hidden states at 100,000 items, E=128: the scale phase's CEFused row
    fused_paths += (
        ("_scale_100k", "scale_100k",
         {"scale_fused": scaled["fused_eager"], "scale_fused_graph": scaled["fused_graph"]}),
    )
    # each catalog shard of the sp_tp row (1,853 rows, num_valid 1,852 on the
    # second): the f32 parity run and the bf16 timed run, ranks summed
    fused_paths += (
        ("_sp_tp_shard_f32", "sp_tp_shard_f32", {"distributed_sp_tp": distributed["sp_tp"]["launches_total"]}),
        ("_sp_tp_shard_bf16_hidden", "sp_tp_shard",
         {"distributed_sp_tp_bf16": distributed["sp_tp"]["bf16_launches_total"]}),
    )
    for suffix, case, paths in fused_paths:
        for name, kernel, line in fused_kernels:
            record = fused[case][kernel]
            if record["variant"] != "tf32":
                raise AssertionError(f"{name}{suffix}: the kernel phase timed {record['variant']}, the paths ran tf32")
            entry = {
                "name": name + suffix,
                "route": "cuda",
                "source": "replay_tpu_torch/csrc/fused_ce.cu",
                "replaces": f"replay_tpu/ops/fused_ce.py:{line}",
                "launches": sum(path_launches[name] for path_launches in paths.values()),
                "launches_by_path": {path: path_launches[name] for path, path_launches in paths.items()},
                "max_abs_err": record["max_abs_err"],
                "ms": record["ms"],
                "plain_ms": record["plain_ms"],
                "bound_ms": record["bound_ms"],
                "bound_by": record["bound_by"],
                "library_ms": record["library_ms"],
                "passed": True,
                "shape": f"N={record['N']} E={record['E']} I={record['I']} {record['hidden_dtype']}",
            }
            entry["variant"] = record["variant"]
            kernels.append(entry)
    # K5, one entry per variant: bf16 (mma) on the long-sequence training and
    # serving paths, f32 (tf32x3) on the f32-compute forward and the f32 trainer
    tiled = bert4rec["tiled"]
    k5_paths = (
        ("flash_attention_tiled", "longseq", "mma", torch.bfloat16,
         {"longseq_train": longseq["train"]["flash_attention_tiled"], "longseq_serve": longseq["serve"],
          "longseq_train_graph": longseq["graph"]["flash_attention_tiled"],
          # remat on K5 (each block's forward twice a step), eager and on graphs
          "family_remat_k5": family["remat_k5"]["launches"]["flash_attention_tiled"]}),
        ("flash_attention_tiled_f32", "longseq", "tf32x3", torch.float32,
         {"longseq_f32_forward": longseq["f32"], "longseq_f32_train": longseq["f32_train"]["flash_attention_tiled"]}),
        # BERT4Rec's tiled route, non-causal at L=100: the bf16 trainer, the f32 forward
        ("flash_attention_tiled_bert4rec", "bert4rec_tiled", "mma", torch.bfloat16,
         {"bert4rec_tiled_train": tiled["bf16_k5"]["mma"]}),
        ("flash_attention_tiled_bert4rec_f32", "bert4rec_tiled", "tf32x3", torch.float32,
         {"bert4rec_tiled_f32_forward": tiled["f32_k5"]["tf32x3"]}),
    )
    for name, shape, variant, dtype, by_path in k5_paths:
        k5 = tiled_records[(shape, dtype)]
        if k5["variant"] != variant:
            raise AssertionError(f"{name}: the kernel phase timed {k5['variant']}, the paths ran {variant}")
        kernels.append(
            {
                "name": name,
                "variant": variant,
                "route": "cuda",
                "source": "replay_tpu_torch/csrc/flash_tiled.cu",
                "replaces": "replay_tpu/ops/flash_tiled.py:34",
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": k5["max_abs_err"],
                "ms": k5["ms"],
                "plain_ms": k5["plain_ms"],
                "bound_ms": k5["bound_ms"],
                "bound_by": k5["bound_by"],
                "library_ms": k5["library_ms"],
                "passed": True,
                "shape": f"B={k5['B']} H={k5['H']} L={k5['L']} D={k5['D']} "
                f"{'causal' if k5['causal'] else 'non-causal'} {k5['dtype']}",
            }
        )
    idle = [r["name"] for r in kernels if r["launches"] < 1]
    if idle:
        raise AssertionError(f"kernels never launched on the paths driven: {idle}")
    return kernels


if __name__ == "__main__":
    if sys.argv[1:2] == ["--distributed-worker"]:
        sys.exit(distributed_worker(sys.argv[2:]))
    if sys.argv[1:2] == ["--nccl-probe"]:
        if not torch.cuda.is_available():
            print("chip_smoke: torch sees no CUDA device; this script runs only on the GPU", file=sys.stderr)
            sys.exit(2)
        print(nvidia_smi_line(), flush=True)
        nccl_probe(torch.device("cuda", 0))
        sys.exit(0)
    sys.exit(main())
