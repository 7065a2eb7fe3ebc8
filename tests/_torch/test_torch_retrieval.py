"""Brute-force retrieval (f32 and int8): the port's MIPSIndex and
CandidatePipeline against the JAX package's, on seeded numpy tables.

Ids must be equal, ties included: ``jax.lax.top_k`` puts the lower index first
among equal values, and the port's ``top_k`` keeps that order on any device.
Ties are made on purpose with small-integer tables and queries (every inner
product exact in f32, whatever the summation order) and with a re-rank whose
sigmoid saturates to exactly 1.0. Scores are held at atol/rtol 1e-5. The
int8 table is the JAX one bitwise (host quantization), and its products of
small integers with small-integer queries are exact, so ties hold there too.
The IVF index has its own file, ``test_torch_ivf.py``.
"""

import numpy as np
import pytest
import torch

import jax

from replay_tpu.models.ann import MIPSIndex as JaxMIPSIndex
from replay_tpu.serve.pipeline import CandidatePipeline as JaxCandidatePipeline
from replay_tpu_torch.models import MIPSIndex
from replay_tpu_torch.models.ann import top_k
from replay_tpu_torch.serve import CandidatePipeline

ATOL = RTOL = 1e-5


def _tables(kind, seed, items=300, dim=16, queries=9):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return (rng.normal(size=(items, dim)).astype(np.float32), rng.normal(size=(queries, dim)).astype(np.float32))
    # entries in {-1, 0, 1} over 4 dims: inner products in -4..4, so most
    # cuts fall inside a run of exactly equal scores
    if kind == "clustered":
        centers = rng.normal(size=(12, dim)).astype(np.float32)
        centers /= np.linalg.norm(centers, axis=1, keepdims=True)
        table = (centers[rng.integers(0, 12, items)] + 0.1 * rng.normal(size=(items, dim))).astype(np.float32)
        return table, (centers[rng.integers(0, 12, queries)] + 0.1 * rng.normal(size=(queries, dim))).astype(np.float32)
    table = rng.integers(-1, 2, (items, 4)).astype(np.float32)
    return table, rng.integers(-1, 2, (queries, 4)).astype(np.float32)


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_search_matches_jax(kind, k):
    table, queries = _tables(kind, seed=k)
    got_scores, got_ids = MIPSIndex(table, device="cpu").search(queries, k)
    want_scores, want_ids = JaxMIPSIndex(table).search(queries, k)
    np.testing.assert_array_equal(got_ids, want_ids)
    assert got_ids.dtype == want_ids.dtype
    np.testing.assert_allclose(got_scores, want_scores, atol=ATOL, rtol=RTOL)
    if kind == "ties":
        np.testing.assert_array_equal(got_scores, want_scores)  # integer products are exact
        full = queries @ table.T
        assert ((full == got_scores[:, -1:]).sum(axis=1) > 1).mean() >= 0.5, "most cuts must fall on a tie"


@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_exact_rescore_matches_jax(kind):
    table, queries = _tables(kind, seed=5)
    ids = np.random.default_rng(6).integers(0, len(table), (len(queries), 12))
    got = MIPSIndex(table, device="cpu").exact_rescore(queries, ids)
    want = np.asarray(JaxMIPSIndex(table).exact_rescore(queries, ids))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    # on the brute f32 index the rescore reproduces the scan's scores
    values, found = MIPSIndex(table, device="cpu").search_jax(queries, 12)
    np.testing.assert_allclose(MIPSIndex(table, device="cpu").exact_rescore(queries, found).numpy(), values.numpy(), atol=ATOL)


def test_index_introspection_matches_jax():
    table, _ = _tables("normal", seed=1)
    got, want = MIPSIndex(table, device="cpu"), JaxMIPSIndex(table)
    assert got.is_approximate is want.is_approximate is False
    assert got.table_bytes() == want.table_bytes()
    assert (got.num_items, got.dim, got.precision, got.index_mode) == (want.num_items, want.dim, "f32", "brute")
    with pytest.raises(ValueError, match="exceeds the catalog size"):
        got.search(table[:2], len(table) + 1)


@pytest.mark.parametrize(
    "kwargs, error, match",
    [
        ({"mesh": object()}, NotImplementedError, "ROADMAP.md queue 1, 'Distributed training' \\(item 9\\)"),
        ({"index": "ivf", "mesh": object()}, NotImplementedError, "ROADMAP.md queue 1, 'Distributed training'"),
        ({"index": "hnsw"}, ValueError, "index must be 'brute' or 'ivf'"),
        ({"precision": "bf16"}, ValueError, "precision must be 'f32' or 'int8'"),
        ({"precision": "int8+pq"}, ValueError, "precision must be 'f32' or 'int8'"),
        ({"index": "ivf", "precision": "fp8"}, ValueError, "precision must be 'f32', 'int8' or 'int8\\+pq'"),
    ],
    ids=["mesh", "ivf_mesh", "bad_index", "bad_precision", "brute_pq", "bad_ivf_precision"],
)
def test_unported_and_invalid_index_modes_raise(kwargs, error, match):
    table, _ = _tables("normal", seed=2)
    with pytest.raises(error, match=match):
        MIPSIndex(table, device="cpu", **kwargs)
    if error is ValueError:
        with pytest.raises(ValueError) as want:
            JaxMIPSIndex(table, **kwargs)
        with pytest.raises(ValueError) as got:
            MIPSIndex(table, device="cpu", **kwargs)
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "kwargs",
    [
        {"index": "ivf", "nlist": 8, "nprobe": 4, "build_sample": 300},
        {"index": "ivf", "precision": "int8", "nlist": 8, "nprobe": 4, "build_sample": 300},
        {"precision": "int8"},
    ],
    ids=["ivf", "ivf_int8", "int8"],
)
def test_index_modes_that_raised_before_match_jax(kwargs):
    """The modes that raised ``NotImplementedError`` until the retrieval slice
    was ported: the port's own build searches as the JAX build does."""
    table, queries = _tables("clustered", seed=2)
    port, ref = MIPSIndex(table, device="cpu", **kwargs), JaxMIPSIndex(table, **kwargs)
    assert port.is_approximate is ref.is_approximate is True
    got_scores, got_ids = port.search(queries, 20)
    want_scores, want_ids = ref.search(queries, 20)
    np.testing.assert_array_equal(got_ids, np.asarray(want_ids))
    np.testing.assert_allclose(got_scores, np.asarray(want_scores), atol=ATOL, rtol=RTOL)
    assert port.table_bytes() == ref.table_bytes() and port.index_stats() == ref.index_stats()


@pytest.mark.parametrize("kind", ["normal", "ties"])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_int8_search_matches_jax(kind, k):
    table, queries = _tables(kind, seed=20 + k)
    port, ref = MIPSIndex(table, precision="int8", device="cpu"), JaxMIPSIndex(table, precision="int8")
    np.testing.assert_array_equal(port.item_vectors.numpy(), np.asarray(ref.item_vectors))
    np.testing.assert_array_equal(port.item_scales.numpy(), np.asarray(ref.item_scales))
    got_scores, got_ids = port.search(queries, k)
    want_scores, want_ids = ref.search(queries, k)
    np.testing.assert_array_equal(got_ids, np.asarray(want_ids))
    np.testing.assert_allclose(got_scores, np.asarray(want_scores), atol=ATOL, rtol=RTOL)
    if kind == "ties":
        np.testing.assert_array_equal(got_scores, np.asarray(want_scores))
    # the rescore reads the host f32 master, not the int8 rows
    np.testing.assert_allclose(
        port.exact_rescore(queries, got_ids).numpy(), np.asarray(ref.exact_rescore(queries, want_ids)), atol=ATOL, rtol=RTOL
    )
    np.testing.assert_allclose(port.exact_rescore(queries, got_ids).numpy(), np.take_along_axis(queries @ table.T, got_ids.astype(np.int64), 1), atol=ATOL, rtol=RTOL)


def test_int8_index_bytes_and_carry_across_match_jax():
    from replay_tpu_torch.convert import mips_index_from_jax

    table, queries = _tables("normal", seed=21)
    ref = JaxMIPSIndex(table, precision="int8")
    port = mips_index_from_jax(ref, device="cpu")
    assert port.table_bytes() == ref.table_bytes() == MIPSIndex(table, precision="int8", device="cpu").table_bytes()
    assert port.table_bytes()["payload_bytes"] == table.shape[0] * (table.shape[1] + 4)
    assert port.table_shard_bytes() == ref.table_shard_bytes()
    assert port.item_vectors.dtype == torch.int8 and port.item_scales.dtype == torch.float32
    np.testing.assert_array_equal(port.search(queries, 10)[1], np.asarray(ref.search(queries, 10)[1]))


@pytest.mark.parametrize("columns", [1, 7, 64, 3706])
def test_top_k_keeps_jax_order_on_ties_and_signed_zeros(columns):
    rng = np.random.default_rng(columns)
    x = rng.integers(-2, 3, (6, columns)).astype(np.float32)
    x[0] = -0.0
    x[0, ::2] = 0.0
    x[1, :: max(columns // 3, 1)] = np.inf
    k = min(columns, 10)
    values, positions = top_k(torch.tensor(x), k)
    want_values, want_positions = jax.lax.top_k(x, k)
    np.testing.assert_array_equal(positions.numpy(), np.asarray(want_positions))
    np.testing.assert_array_equal(values.numpy(), np.asarray(want_values))


def _pipelines(table, **kwargs):
    return CandidatePipeline(MIPSIndex(table, device="cpu"), **kwargs), JaxCandidatePipeline(JaxMIPSIndex(table), **kwargs)


@pytest.mark.parametrize(
    "kind, weights",
    [("normal", None), ("normal", [1.5, -0.2]), ("ties", [0.7, 0.1]), ("normal", [40.0, 60.0]), ("ties", [50.0, 200.0])],
    ids=["raw_scores", "logistic", "logistic_ties", "saturated", "saturated_ties"],
)
def test_pipeline_rank_matches_jax(kind, weights):
    table, queries = _tables(kind, seed=11)
    port, ref = _pipelines(table, num_candidates=50, top_k=10, reranker_weights=weights)
    got_scores, got_ids = port.rank(queries)
    want_scores, want_ids = ref.rank(queries)
    np.testing.assert_array_equal(got_ids, want_ids)
    assert got_ids.dtype == want_ids.dtype and got_scores.dtype == want_scores.dtype
    np.testing.assert_allclose(got_scores, want_scores, atol=ATOL, rtol=RTOL)
    if weights is not None and weights[0] >= 40:
        assert (got_scores == 1.0).sum() > len(queries), "the re-rank must saturate into ties"


def test_pipeline_spans_and_errors_match_jax():
    from replay_tpu_torch.obs import Tracer

    table, queries = _tables("normal", seed=12)
    tracer = Tracer()
    port, _ = _pipelines(table, num_candidates=20, top_k=5)
    port.rank(torch.tensor(queries), tracer=tracer, span_args={"trace_ids": ["t-1"]})
    spans = tracer.to_chrome_trace()["traceEvents"]
    assert [(e["name"], e["args"]) for e in spans] == [
        ("retrieve", {"rows": len(queries), "k": 20, "trace_ids": ["t-1"]}),
        ("rerank", {"rows": len(queries), "k": 5, "trace_ids": ["t-1"]}),
    ]
    for kwargs in ({"num_candidates": len(table) + 1}, {"num_candidates": 5, "top_k": 6}, {"reranker_weights": [1.0, 2.0, 3.0]}):
        with pytest.raises(ValueError) as want:
            JaxCandidatePipeline(JaxMIPSIndex(table), **kwargs)
        with pytest.raises(ValueError) as got:
            CandidatePipeline(MIPSIndex(table, device="cpu"), **kwargs)
        assert str(got.value) == str(want.value)


def test_index_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MIPSIndex(np.zeros((4, 2), np.float32))
