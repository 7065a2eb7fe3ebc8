"""Counted costs, the roofline and device-time attribution of the port
(``replay_tpu_torch/obs/{mfu,roofline,profile}.py``), on the CPU.

* ``classify``, ``bench_fields`` and ``of_ceiling`` equal the JAX package's
  on the same inputs, with the H100's entries put into the JAX tables by the
  test (monkeypatched, nothing of the JAX package changes).
* The FLOP counter (``torch.utils.flop_counter`` over one call) gives an
  analytic ``6·M·N·K`` on a ``Dense`` step exactly, a SASRec step within 1%
  of its hand count (here exactly), K4's and K5's formulas, and the same
  count for ``CEFused`` (K1–K3 through ``fused_ce_flops``, their plain
  versions hidden from the counter) as for ``CE``.
* ``analyze_programs`` after a chunked fit and ``CompiledInference.roofline()``
  give a record per program and per bucket.
* ``attribute_capture`` on a hand-written torch-profiler trace (eager
  kernels, a backward on another thread, graph replays that match their
  warm-up and one that does not) and on a CPU ``fit(profile_steps=...)``:
  attributed plus unattributed equals the window's total.
"""

import importlib
import json

import numpy as np
import pytest
import torch

from replay_tpu_torch.data import FeatureHint, FeatureType
from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu_torch.nn.compiled import CompiledInference
from replay_tpu_torch.nn.layers import Dense
from replay_tpu_torch.nn.loss import CE, CEFused
from replay_tpu_torch.nn.sequential.sasrec import SasRec
from replay_tpu_torch.nn.train import Trainer
from replay_tpu_torch.obs import profile, roofline
from replay_tpu_torch.ops.flash_attention import flash_attention
from replay_tpu_torch.ops.flash_tiled import flash_attention_tiled

# the modules, not the functions of the same name that the packages export
mfu = importlib.import_module("replay_tpu_torch.obs.mfu")
jax_mfu = importlib.import_module("replay_tpu.obs.mfu")
jax_roofline = importlib.import_module("replay_tpu.obs.roofline")

H100 = "NVIDIA H100 80GB HBM3"
NUM_ITEMS, DIM, HEADS, SEQ_LEN, BATCH = 40, 16, 2, 8, 4


def schema():
    return TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True,
            feature_hint=FeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )


def sasrec(use_flash=False):
    return SasRec(
        schema(), embedding_dim=DIM, num_blocks=1, num_heads=HEADS, max_sequence_length=SEQ_LEN,
        use_flash=use_flash, device="cpu", generator=torch.Generator().manual_seed(0),
    )


def train_batch(seed):
    rng = np.random.default_rng(seed)
    mask = np.arange(SEQ_LEN)[None, :] >= SEQ_LEN - rng.integers(2, SEQ_LEN + 1, BATCH)[:, None]
    items = rng.integers(0, NUM_ITEMS, (BATCH, SEQ_LEN + 1)).astype(np.int32)
    return {
        "feature_tensors": {"item_id": np.where(mask, items[:, :-1], NUM_ITEMS).astype(np.int32)},
        "padding_mask": mask,
        "positive_labels": items[:, 1:, None],
        "target_padding_mask": mask[:, :, None],
    }


@pytest.fixture
def jax_tables_with_the_h100(monkeypatch):
    monkeypatch.setitem(jax_mfu.PEAK_BF16_TFLOPS, "h100 80gb hbm3", mfu.PEAK_BF16_TFLOPS["h100 80gb hbm3"])
    monkeypatch.setitem(jax_roofline.PEAK_HBM_GBPS, "h100 80gb hbm3", roofline.PEAK_HBM_GBPS["h100 80gb hbm3"])


@pytest.mark.parametrize("assumed", [None, H100])
def test_classify_bench_fields_and_of_ceiling_equal_jax(jax_tables_with_the_h100, monkeypatch, assumed):
    for name in ("REPLAY_TPU_ROOFLINE_ASSUME_KIND", "REPLAY_TPU_BENCH_ASSUME_KIND"):
        monkeypatch.delenv(name, raising=False)
    if assumed:
        monkeypatch.setenv("REPLAY_TPU_ROOFLINE_ASSUME_KIND", assumed)
    cases = [
        (5.4e10, 2.6e9, H100), (1.7e12, 7.4e10, H100.lower()), (3e15, 1e12, H100), (1e9, 0.0, H100),
        (0.0, 1e6, H100), (1e10, 1e8, "cpu"), (1e10, 1e8, ""),
    ]
    for flops, nbytes, kind in cases:
        got = roofline.classify(flops, nbytes, kind)
        assert got == jax_roofline.classify(flops, nbytes, kind), (flops, nbytes, kind)
        static = {"roofline": got, "hbm_peak_bytes": 123456, "collective_bytes": None}
        for rate in (None, 12.5, 400.0):
            assert roofline.bench_fields(static, rate) == jax_roofline.bench_fields(static, rate)
            assert roofline.of_ceiling(rate, got) == jax_roofline.of_ceiling(rate, got)
    assert roofline.classify(1e10, 1e8, H100)["peak_tflops"] == 989.0
    assert roofline.bench_fields(None) == jax_roofline.bench_fields(None) == {}


def test_peak_table_and_mfu():
    assert (mfu.peak_tflops(H100), mfu.peak_tflops(H100, "tf32"), mfu.peak_tflops(H100, "f32")) == (989.0, 495.0, 67.0)
    assert roofline.peak_bandwidth(H100) == 3350.0 and mfu.peak_tflops("cpu") is None
    assert mfu.mfu(98.9, H100) == pytest.approx(0.1) and mfu.mfu(1.0, "cpu") is None
    assert mfu.fused_ce_flops(3, 4, 5) == jax_mfu.fused_ce_flops(3, 4, 5)


def test_dense_step_counts_six_mnk_exactly():
    m, k, n = 24, 16, 40
    dense = Dense(k, n)
    x = torch.randn(m, k, requires_grad=True)

    def step(x):
        dense(x).sum().backward()  # dX, dW and the bias' sum

    assert mfu.program_costs(step, x)["flops"] == 6 * m * n * k
    assert mfu.flops_per_step(step, x, extra_flops=10.0) == 6 * m * n * k + 10.0


def sasrec_step_flops() -> int:
    """The SASRec step by hand: every product of the forward (four E×E
    projections, the 4E FFN, QKᵀ and PV, the logits), three times with the
    backward's two products per forward product."""
    n, hidden, head_dim = BATCH * SEQ_LEN, 4 * DIM, DIM // HEADS
    forward = (
        4 * 2 * n * DIM * DIM
        + 2 * 2 * n * DIM * hidden
        + 4 * BATCH * HEADS * SEQ_LEN * SEQ_LEN * head_dim
        + 2 * n * DIM * NUM_ITEMS
    )
    return 3 * forward


@pytest.mark.parametrize("loss", [CE, CEFused])
def test_a_sasrec_step_counts_the_hand_count(loss):
    trainer = Trainer(sasrec(), loss(), device="cpu")
    state = trainer.init_state(train_batch(0))
    trainer.train_step(state, train_batch(0))
    record = trainer.analyze_programs()["train_step"]
    want = sasrec_step_flops()
    assert abs(record["flops"] - want) <= 0.01 * want
    assert record["bytes_accessed"] > 0
    # the step itself is untouched by the analysis' call
    assert state.step == 1


def test_the_attention_operators_have_their_formulas():
    b, h, length, d = 2, 3, 16, 8
    q, k, v = (torch.randn(b, h, length, d) for _ in range(3))
    bias = torch.zeros(b, 1, length, length)
    assert mfu.program_costs(flash_attention, q, k, v, bias)["flops"] == 4 * b * h * length * length * d
    padding = torch.zeros(b, length)
    tiled = mfu.program_costs(flash_attention_tiled, q, k, v, padding, True)
    assert tiled["flops"] == 4 * b * h * length * length * d
    assert tiled["bytes_accessed"] >= 4 * (4 * b * h * length * d)


def test_analyze_programs_after_a_chunked_fit_and_the_serving_buckets(monkeypatch):
    monkeypatch.setenv("REPLAY_TPU_ROOFLINE_ASSUME_KIND", H100)
    trainer = Trainer(sasrec(use_flash=True), CEFused(), device="cpu")
    trainer.fit([train_batch(seed) for seed in range(7)], scan_chunk=3, log_every=0)
    records = trainer.analyze_programs()
    assert set(records) == {"train_step", "train_scan"}
    assert records["train_scan"]["flops"] == 3 * records["train_step"]["flops"]
    assert records["train_scan"]["roofline"]["peak_assumed"] == H100
    assert records["train_scan"]["roofline"]["bound"] in ("memory", "compute")
    served = CompiledInference.compile(
        trainer.model, dict(trainer.model.named_parameters()), SEQ_LEN, mode="dynamic_batch_size",
        dynamic_buckets=(1, 4), device="cpu",
    )
    buckets = served.roofline()
    assert sorted(buckets) == [1, 4]
    assert all(r["flops"] > 0 and r["bytes_accessed"] > 0 and r["roofline"] is not None for r in buckets.values())
    assert buckets[4]["flops"] > buckets[1]["flops"]


def event(cat, name, ts, dur, tid, **args):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur, "args": args}


def hand_written_trace():
    """Two host threads (the step's and autograd's) and the device: eager
    kernels under named ranges, a backward linked by sequence number, an
    unscoped optimizer kernel and copy, a graph replay of two steps that
    matches its warm-up and one that does not."""
    launch = lambda corr, ts, tid=1, name="cudaLaunchKernel": event("cuda_runtime", name, ts, 1, tid, correlation=corr)  # noqa: E731
    kernel = lambda corr, name, ts, dur: event("kernel", name, ts, dur, 7, correlation=corr)  # noqa: E731
    return [
        event("user_annotation", "forward", 0, 100, 1),
        event("user_annotation", "encoder", 10, 50, 1),
        event("cpu_op", "aten::mm", 20, 10, 1, **{"Sequence number": 7}),
        launch(1, 25), kernel(1, "void attention_forward<64>(float*)", 1000, 10),
        event("user_annotation", "loss", 100, 50, 1),
        event("cpu_op", "_FusedLSE", 110, 10, 1, **{"Sequence number": 9}),
        launch(2, 115), kernel(2, "lse_forward_tf32(float const*)", 1020, 10),
        event("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 200, 20, 2, **{"Sequence number": 7}),
        launch(3, 210, tid=2), kernel(3, "gemm_x", 1040, 5),
        event("cpu_op", "autograd::engine::evaluate_function: _FusedLSEBackward", 230, 20, 2, **{"Sequence number": 9}),
        launch(4, 240, tid=2), kernel(4, "lse_grad_hidden_tf32(float const*)", 1050, 10),
        launch(5, 300), kernel(5, "adam_update", 1070, 2),
        launch(6, 305, name="cudaMemcpyAsync"), event("gpu_memcpy", "Memcpy HtoD", 1073, 1, 7, correlation=6),
        launch(7, 400, name="cudaGraphLaunch"),
        kernel(7, "k_a", 1100, 1), kernel(7, "k_b", 1101, 2), kernel(7, "k_a", 1103, 1), kernel(7, "k_b", 1104, 2),
        event("gpu_memcpy", "Memcpy DtoD", 1106, 1, 7, correlation=7),
        launch(8, 500, name="cudaGraphLaunch"), kernel(8, "k_a", 1200, 1), kernel(8, "k_c", 1201, 4),
    ]


def test_attribute_capture_on_a_hand_written_trace(tmp_path):
    path = tmp_path / "host.1.2.pt.trace.json"
    path.write_text(json.dumps({"traceEvents": hand_written_trace()}))
    record = profile.attribute_capture(
        str(tmp_path), {"train_scan": [("k_a", "encoder"), ("k_b", "loss")]}, kernels=profile.TRACE_NAMES
    )
    us = 1e-6
    assert record["capture"] == str(path)
    assert record["scopes"]["encoder"]["seconds"] == pytest.approx((10 + 5 + 1 + 1) * us)
    assert record["scopes"]["loss"]["seconds"] == pytest.approx((10 + 10 + 2 + 2) * us)
    assert set(record["scopes"]) == {"encoder", "loss"}
    assert record["unattributed_seconds"] == pytest.approx((2 + 1 + 1 + 1 + 4) * us)
    assert record["attributed_seconds"] + record["unattributed_seconds"] == pytest.approx(record["total_device_seconds"])
    assert record["modules"] == pytest.approx({"eager": 38 * us, "train_scan": 7 * us, "graph": 5 * us})
    kernels = record["kernels"]
    assert kernels["flash_attention"] == {"count": 1, "scopes": {"encoder": 1}}
    assert kernels["fused_lse_forward"] == {"count": 1, "scopes": {"loss": 1}}
    assert kernels["fused_lse_dh"] == {"count": 1, "scopes": {"loss": 1}}
    assert kernels["fused_lse_dw"]["count"] == 0
    # the replay that matched no warm-up is recorded where it parts from it
    assert record["unmatched_replays"] == [
        {"kernels": 2, "train_scan": {"warmup_kernels": 2, "first_difference": 1, "replayed": "k_c", "warmup": "k_b"}}
    ]
    with pytest.raises(FileNotFoundError):
        profile.attribute_capture(str(tmp_path / "nothing"))


def test_out_of_range_records_and_kernels_by_launch_read_from_the_trace(tmp_path):
    line = (
        "INFO:2026-10-18 18:08:02 121:121 CuptiActivityProfiler.cpp:408] Record counts: Out-of-range = 7223, "
        "Blocklisted runtime = 907, Invalid ext correlations = 0, CPU GPU out-of-order = 1480, "
        "Unexpected CUDA events = 0, CUPTI stopped early? = 0"
    )
    logged, silent = tmp_path / "logged.json", tmp_path / "silent.json"
    logged.write_text(json.dumps({"traceEvents": hand_written_trace(), "INFO": ["Processed 13310 GPU records", line]}))
    silent.write_text(json.dumps({"traceEvents": hand_written_trace(), "INFO": ["Processed 13310 GPU records"]}))
    assert profile.out_of_range_records(str(logged)) == 7223
    assert profile.out_of_range_records(str(silent)) is None
    # three replays of a two-block encode: the second lost one K4 record; one
    # eager K4 (the hand-written trace's), and one whose launch call is absent
    k4 = "void attention_forward<float, 2>(float const*)"
    replays = [
        event("cuda_runtime", "cudaGraphLaunch", 600 + 10 * corr, 1, 1, correlation=corr) for corr in (20, 21, 22)
    ]
    kernels = [
        event("kernel", name, 2000 + 10 * i, 1, 7, correlation=corr)
        for i, (corr, name) in enumerate([(20, k4), (20, "k_a"), (20, k4), (21, k4), (21, "k_a"), (22, k4), (22, k4)])
    ]
    orphan = event("kernel", k4, 3000, 1, 7, correlation=99)
    replayed = tmp_path / "replayed.json"
    replayed.write_text(json.dumps({"traceEvents": hand_written_trace() + replays + kernels + [orphan]}))
    pattern = profile.TRACE_NAMES["flash_attention"]
    assert profile.kernels_by_launch(str(replayed), pattern) == {
        "kernels": 7, "graph_launches": [2, 1, 2], "eager": 1, "orphans": 1,
    }
    # graph launches with no K4 kernel (the hand-written trace's) are not listed
    assert profile.kernels_by_launch(str(logged), pattern) == {
        "kernels": 1, "graph_launches": [], "eager": 1, "orphans": 0,
    }


def test_a_cpu_fit_with_a_profile_window_attributes_its_host_ops(tmp_path):
    events = []

    class Sink:
        def log_event(self, e):
            events.append(e)

    trainer = Trainer(sasrec(), CE(), device="cpu")
    trainer.fit(
        [train_batch(seed) for seed in range(5)], log_every=0, loggers=[Sink()], profile_steps=(1, 3),
        profile_dir=str(tmp_path / "profile"),
    )
    end = [e for e in events if e.event == "on_fit_end"][0].payload
    record = end["device_time"]
    assert record["capture"].startswith(str(tmp_path / "profile"))
    assert record["modules"].keys() == {"cpu"}
    assert {"embed", "encoder", "final_norm", "forward", "loss"} >= set(record["scopes"]) >= {"encoder", "loss"}
    assert record["attributed_seconds"] + record["unattributed_seconds"] == pytest.approx(
        record["total_device_seconds"], rel=1e-12
    )
    assert record["launches"] == dict.fromkeys(record["launches"], 0)  # no kernel on the CPU
    assert set(end["roofline"]) == {"train_step"}
    # the scopes exist only inside the window
    assert profile.scope("encoder") is profile.scope("loss")
