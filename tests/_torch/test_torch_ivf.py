"""The port's IVF index and int8 table against the JAX package's, on the CPU.

Both packages get the same seeded numpy tables. Tolerances: centroids and
scores atol 1e-5 (f32 products summed in another order); ids exactly. The
JAX build runs once per rung (module fixtures), as its own tests run it on
the CPU.

* Host pieces (``default_nlist``, ``ladder_width``, ``_spill_overflow``,
  ``ivf_bytes``, ``brute_bytes``, ``quantize_embeddings``,
  ``quantization_error``) equal the JAX ones exactly; the port's spill pass is
  vectorised and must give the reference's cells.
* k-means and the top-2 assignment from one sample and seed: centroids within
  1e-5; assignments equal except rows whose top-2 margin is below 1e-4.
* A whole build per rung on a catalog built so that every sum the build
  takes is exact in f32 (dyadic rows in ± pairs about well-separated modes):
  then centroids, layout, scales, codebooks and codes are bitwise the JAX
  build's, whatever order the sums run in.
* Searches of a JAX state carried across (``convert.py``), for every rung and
  k ∈ {10, 100}; the probed-pool error; padding never surfacing; two builds
  bitwise equal; ``CandidatePipeline`` over int8 and IVF indexes with its
  ``rescore`` span; the stats and byte records.
"""

import numpy as np
import pytest
import torch

from replay_tpu.models import ivf as jax_ivf
from replay_tpu.models.ann import MIPSIndex as JaxMIPSIndex
from replay_tpu.serve import quant as jax_quant
from replay_tpu.serve.pipeline import CandidatePipeline as JaxCandidatePipeline
from replay_tpu_torch.convert import ivf_state_from_jax, mips_index_from_jax
from replay_tpu_torch.models import MIPSIndex
from replay_tpu_torch.models import ivf
from replay_tpu_torch.obs import Tracer
from replay_tpu_torch.serve import CandidatePipeline, quantization_error, quantize_embeddings

ATOL = 1e-5
RUNGS = ("f32", "int8", "int8+pq")
ITEMS, DIM, MODES, QUERIES = 6000, 16, 24, 12
IVF = dict(index="ivf", nlist=32, nprobe=12, build_sample=4096, pq_subspaces=4, seed=3)


def _clustered(seed, items=ITEMS, dim=DIM, modes=MODES, queries=QUERIES):
    """bench_serve.py's catalog family: unit modes plus 0.1 noise."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(modes, dim)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    table = (centers[rng.integers(0, modes, items)] + 0.1 * rng.normal(size=(items, dim))).astype(np.float32)
    query = (centers[rng.integers(0, modes, queries)] + 0.1 * rng.normal(size=(queries, dim))).astype(np.float32)
    return table, query


@pytest.fixture(scope="module")
def catalog():
    return _clustered(0)


@pytest.fixture(scope="module")
def jax_indexes(catalog):
    table, _ = catalog
    return {rung: JaxMIPSIndex(table, precision=rung, **IVF) for rung in RUNGS}


# -- host pieces ------------------------------------------------------------------ #
@pytest.mark.parametrize("items", [1, 7, 100, 4096, 10_000, 10_000_000])
def test_default_nlist_and_ladder_width_match_jax(items):
    assert ivf.default_nlist(items) == jax_ivf.default_nlist(items)
    assert ivf.default_nlist(items, 8) == jax_ivf.default_nlist(items, 8)
    for n in (0, 1, 8, 9, items % 5000, items % 777 + 3000):
        assert ivf.ladder_width(n) == jax_ivf.ladder_width(n)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_vectorised_spill_gives_the_reference_cells(seed):
    """Random top-2 pairs skewed onto a few cells: the first pass overflows
    some runner-up cells, so the later passes have work."""
    rng = np.random.default_rng(seed)
    nlist, rows = 16, 4000
    first = np.minimum(rng.geometric(0.25, rows) - 1, nlist - 1)
    second = (first + 1 + np.minimum(rng.geometric(0.6, rows) - 1, nlist - 2)) % nlist
    top2 = np.stack([first, second], axis=1)
    cap = int(np.ceil(1.6 * rows / nlist))
    want = jax_ivf._spill_overflow(top2, nlist, cap)
    np.testing.assert_array_equal(ivf._spill_overflow(top2, nlist, cap), want)
    # more than one pass was needed: one pass alone leaves a cell over the cap
    cells = top2[:, 0].copy()
    counts = np.bincount(cells, minlength=nlist)
    for c in np.where(counts > cap)[0]:
        members = np.where(cells == c)[0]
        spill = members[len(members) - (counts[c] - cap):]
        cells[spill] = top2[spill, 1]
    assert np.bincount(cells, minlength=nlist).max() > cap


@pytest.mark.parametrize("rung", RUNGS)
def test_byte_models_match_jax(rung):
    for items, dim, nlist, m, padded in ((100_000_000, 256, 65536, 32, 0.1), (10_000_000, 64, 4096, 16, 0.137), (611, 16, 16, 4, 0.0)):
        assert ivf.ivf_bytes(items, dim, nlist, rung, m, padded) == jax_ivf.ivf_bytes(items, dim, nlist, rung, m, padded)
        assert ivf.brute_bytes(items, dim, rung) == jax_ivf.brute_bytes(items, dim, rung)


def test_quantization_matches_jax_bitwise():
    rng = np.random.default_rng(4)
    table = rng.normal(size=(300, 24)).astype(np.float32)
    table[7] = 0.0  # a zero row quantizes to exact zeros, scale 0
    table[8] = np.float32(0.5) * 127  # a row on the grid: values ±127 exactly
    table[9, ::2] = 1e-30
    got, want = quantize_embeddings(table), jax_quant.quantize_embeddings(table)
    assert got.values.dtype == np.int8 and got.scales.dtype == np.float32
    np.testing.assert_array_equal(got.values, want.values)
    np.testing.assert_array_equal(got.scales, want.scales)
    assert (got.num_items, got.dim, got.nbytes) == (want.num_items, want.dim, want.nbytes)
    np.testing.assert_array_equal(got.dequantize(), want.dequantize())
    assert quantization_error(table, got) == jax_quant.quantization_error(table, want)
    assert got.scales[7] == 0 and not got.values[7].any()
    for bad in ({"table": table, "bits": 4}, {"table": table[0]}):
        with pytest.raises(ValueError) as w:
            jax_quant.quantize_embeddings(**bad)
        with pytest.raises(ValueError) as g:
            quantize_embeddings(**bad)
        assert str(g.value) == str(w.value)


# -- k-means and the assignment ---------------------------------------------------- #
def test_kmeans_and_top2_assignment_match_jax(catalog):
    table, _ = catalog
    sample = table[np.random.default_rng(5).choice(len(table), 4096, replace=False)]
    want = np.asarray(jax_ivf._kmeans_centroids(sample, 32, 10, 5))
    got = ivf._kmeans_centroids(sample, 32, 10, 5, "cpu")
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    got_top2 = ivf._assign_top2(torch.as_tensor(table), got)
    want_top2 = jax_ivf._assign_top2(table, want)
    scores = table.astype(np.float64) @ want.T - 0.5 * (want.astype(np.float64) ** 2).sum(1)
    ranked = np.sort(scores, axis=1)
    margin = np.minimum(ranked[:, -1] - ranked[:, -2], ranked[:, -2] - ranked[:, -3])
    differ = (got_top2 != want_top2).any(axis=1)
    assert np.all(margin[differ] < 1e-4), margin[differ]
    near = margin < 1e-4
    assert near.sum() == 7  # this seed's rows within 1e-4 of a tie (float64 scores)
    assert not differ[~near].any() and differ.sum() == 0


# -- whole builds ------------------------------------------------------------------- #
def _dyadic_catalog(nlist=8, per_mode=256, dim=16, subspaces=4, seed=6, sample=2048):
    """Rows ``mode ± offset``, every value a multiple of 1/8: well-separated
    modes (Hadamard rows × 2), offsets whose subspace parts come from four
    dyadic points, each row's partner carrying the negated offset. Every sum
    the build takes is then exact in f32, and every cell's mean is its mode.
    The k-means init (the build's own draws, replayed here) is one row of
    each mode, so each cell is one mode."""
    hadamard = np.array([[1.0]])
    while hadamard.shape[0] < dim:
        hadamard = np.block([[hadamard, hadamard], [hadamard, -hadamard]])
    modes = 2.0 * hadamard[:nlist]
    items = nlist * per_mode
    sample_ids = np.random.default_rng(seed).choice(items, sample, replace=False)
    init_rows = sample_ids[np.random.default_rng(seed).choice(sample, nlist, replace=False)]
    mode_of = np.full(items, -1)
    mode_of[init_rows] = np.arange(nlist)
    rest = np.flatnonzero(mode_of < 0)
    mode_of[rest] = np.repeat(np.arange(nlist), per_mode - 1)
    points = np.array([[0.25, 0.5, -0.125, 0.0], [-0.5, 0.125, 0.25, 0.375], [0.0, -0.25, 0.5, -0.5], [0.375, 0.0, 0.0, 0.25]])
    rng = np.random.default_rng(seed + 1)
    table = np.zeros((items, dim), np.float32)
    for mode in range(nlist):
        rows = np.flatnonzero(mode_of == mode)
        half = len(rows) // 2
        offsets = points[rng.integers(0, len(points), (half, subspaces))].reshape(half, dim)
        table[rows[:half]] = modes[mode] + offsets
        table[rows[half:]] = modes[mode] - offsets
    return table, modes


@pytest.fixture(scope="module")
def dyadic_builds():
    table, modes = _dyadic_catalog()
    kwargs = dict(index="ivf", nlist=8, nprobe=4, build_sample=2048, pq_subspaces=4, seed=6)
    return table, modes, {rung: (JaxMIPSIndex(table, precision=rung, **kwargs), MIPSIndex(table, precision=rung, device="cpu", **kwargs)) for rung in RUNGS}


@pytest.mark.parametrize("rung", RUNGS)
def test_whole_build_matches_jax_bitwise(dyadic_builds, rung):
    _, modes, builds = dyadic_builds
    jax_index, port_index = builds[rung]
    want, got = jax_index._ivf, port_index.ivf_state
    # the premise: each cell is one mode, its centroid the mode exactly
    assert sorted(map(tuple, got.centroids.numpy())) == sorted(map(tuple, modes.astype(np.float32)))
    for name in ("centroids", "storage", "row_scales", "codes", "codebooks", "storage_ids", "starts", "lengths"):
        if getattr(want, name) is None:
            assert getattr(got, name) is None, name
        else:
            want_array = np.asarray(getattr(want, name))
            assert getattr(got, name).numpy().dtype == want_array.dtype, name
            np.testing.assert_array_equal(getattr(got, name).numpy(), want_array, err_msg=name)
    assert (got.cmax, got.storage_rows, got.padded_fraction) == (want.cmax, want.storage_rows, want.padded_fraction)
    if rung == "int8+pq":
        assert len(np.unique(got.codes.numpy())) > 4  # the codes are not all one entry


@pytest.mark.parametrize("rung", RUNGS)
def test_build_layout_on_a_noisy_catalog_matches_jax(catalog, jax_indexes, rung):
    """On bench_serve.py's catalog family (continuous noise, sums inexact):
    centroids within 1e-5, the same cells, layout and scales exactly."""
    table, _ = catalog
    want = jax_indexes[rung]._ivf
    got = MIPSIndex(table, precision=rung, device="cpu", **IVF).ivf_state
    np.testing.assert_allclose(got.centroids.numpy(), np.asarray(want.centroids), atol=ATOL, rtol=0)
    for name in ("storage_ids", "starts", "lengths"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    assert (got.cmax, got.storage_rows, got.padded_fraction) == (want.cmax, want.storage_rows, want.padded_fraction)
    if rung == "int8":
        np.testing.assert_array_equal(got.storage.numpy(), np.asarray(want.storage))
        np.testing.assert_array_equal(got.row_scales.numpy(), np.asarray(want.row_scales))
    assert set(got.build_seconds) >= {"sample", "kmeans", "assign", "spill", "layout", "storage"}


def test_two_builds_are_bitwise_equal(catalog):
    table, _ = catalog
    first = MIPSIndex(table, precision="int8+pq", device="cpu", **IVF).ivf_state
    second = MIPSIndex(table, precision="int8+pq", device="cpu", **IVF).ivf_state
    for name, tensor in first.tensors().items():
        assert torch.equal(tensor, getattr(second, name)), name


# -- searches from a carried-across state -------------------------------------------- #
@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("k", [10, 100])
def test_search_of_a_jax_state_matches_jax(catalog, jax_indexes, rung, k):
    _, queries = catalog
    jax_index = jax_indexes[rung]
    port = mips_index_from_jax(jax_index, device="cpu")
    want_scores, want_ids = jax_index.search(queries, k)
    got_scores, got_ids = port.search(queries, k)
    np.testing.assert_array_equal(got_ids, np.asarray(want_ids))
    assert got_ids.dtype == np.int32
    np.testing.assert_allclose(got_scores, np.asarray(want_scores), atol=ATOL, rtol=ATOL)
    state = ivf_state_from_jax(jax_index._ivf, device="cpu")
    for name, tensor in state.tensors().items():
        np.testing.assert_array_equal(tensor.numpy(), np.asarray(getattr(jax_index._ivf, name)), err_msg=name)
    rescored = port.exact_rescore(queries, got_ids)
    np.testing.assert_allclose(rescored.numpy(), np.asarray(jax_index.exact_rescore(queries, want_ids)), atol=ATOL, rtol=ATOL)


def test_k_past_the_probed_pool_raises_as_jax(jax_indexes):
    jax_index = jax_indexes["f32"]
    port = mips_index_from_jax(jax_index, device="cpu")
    state = jax_index._ivf
    too_many = state.config.nprobe * state.cmax + 1
    with pytest.raises(ValueError) as want:
        jax_ivf.make_search_fn(state, too_many)
    with pytest.raises(ValueError) as got:
        port.search(np.zeros((2, DIM), np.float32), too_many)
    assert str(got.value) == str(want.value) and "raise nprobe" in str(got.value)


@pytest.mark.parametrize("rung", RUNGS)
def test_strictly_negative_catalog_never_surfaces_padding(rung):
    """Every true score < 0 while padded rows are zeros: an unmasked padded
    row would win the top-k."""
    rng = np.random.default_rng(3)
    items, dim = 611, 16
    table = (-np.abs(rng.normal(size=(items, dim))) - 0.5).astype(np.float32)
    queries = (np.abs(rng.normal(size=(16, dim))) + 0.5).astype(np.float32)
    index = MIPSIndex(table, index="ivf", precision=rung, nlist=16, nprobe=16, build_sample=items, pq_subspaces=4, device="cpu")
    assert index.ivf_state.padded_fraction > 0
    values, ids = index.search(queries, 20)
    assert np.all(ids >= 0) and np.all(ids < items)
    assert np.all(np.isfinite(values))
    if rung != "int8+pq":  # pq scores are approximate sums
        assert np.all(values < 0.0), values.max()
    for row in ids:
        assert len(set(row.tolist())) == len(row)


def test_stats_and_bytes_match_jax(catalog, jax_indexes):
    table, _ = catalog
    for rung, jax_index in jax_indexes.items():
        port = mips_index_from_jax(jax_index, device="cpu")
        assert port.is_approximate is jax_index.is_approximate is True
        assert port.index_stats() == jax_index.index_stats(), rung
        assert port.table_bytes() == jax_index.table_bytes(), rung
        assert port.table_shard_bytes() == jax_index.table_shard_bytes(), rung
    for rung in ("f32", "int8"):
        port, want = MIPSIndex(table, precision=rung, device="cpu"), JaxMIPSIndex(table, precision=rung)
        assert port.index_stats() == want.index_stats()
        assert port.table_bytes() == want.table_bytes()
        assert port.table_shard_bytes() == want.table_shard_bytes()
    # the built index's arrays: the device holds exactly the byte model's rows
    state = MIPSIndex(table, precision="int8", device="cpu", **IVF).ivf_state
    assert state.storage.numel() == state.storage_rows * DIM and state.storage.dtype == torch.int8


@pytest.mark.parametrize("rung", ["int8", "ivf_f32", "ivf_int8+pq"])
def test_pipeline_over_an_approximate_index_matches_jax(catalog, jax_indexes, rung):
    table, queries = catalog
    if rung == "int8":
        jax_index = JaxMIPSIndex(table, precision="int8")
    else:
        jax_index = jax_indexes[rung[4:]]
    port_index = mips_index_from_jax(jax_index, device="cpu")
    kwargs = dict(num_candidates=60, top_k=10, reranker_weights=[1.5, -0.2])
    port, ref = CandidatePipeline(port_index, **kwargs), JaxCandidatePipeline(jax_index, **kwargs)
    tracer = Tracer()
    got_scores, got_ids = port.rank(torch.tensor(queries), tracer=tracer, span_args={"trace_ids": ["t-1"]})
    want_scores, want_ids = ref.rank(queries)
    np.testing.assert_array_equal(got_ids, np.asarray(want_ids))
    np.testing.assert_allclose(got_scores, np.asarray(want_scores), atol=ATOL, rtol=ATOL)
    spans = tracer.to_chrome_trace()["traceEvents"]
    assert [e["name"] for e in spans] == ["retrieve", "rescore", "rerank"]
    assert spans[1]["args"] == {"rows": len(queries), "k": 60, "trace_ids": ["t-1"]}
    assert port.stats() == ref.stats()
    # the rescore reads the host f32 master: the final scores are the f32 pipeline's
    f32 = CandidatePipeline(MIPSIndex(table, device="cpu"), **kwargs)
    f32_scores, f32_ids = f32.rank(queries)
    same = (got_ids == f32_ids).all(axis=1)
    assert same.mean() > 0.9
    np.testing.assert_allclose(got_scores[same], f32_scores[same], atol=ATOL, rtol=ATOL)
