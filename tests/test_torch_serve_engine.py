"""The port's ScoringEngine against the JAX package's, on the same windows.

Both engines serve ``SasRec(use_flash=True)`` on the same weights (carried
across with ``convert.flax_to_torch``): the JAX side runs the Pallas kernel in
interpret mode, the port its plain version on the CPU. Windows come from
``make_window`` on seeded histories. Scores agree at atol 1e-5 / rtol 1e-5 (f32
with different summation orders); routing, errors and accounting agree exactly.
"""

import numpy as np
import pytest
import torch

import jax

from replay_tpu.data import FeatureHint, FeatureType
from replay_tpu.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu.nn.sequential.sasrec import SasRec as JaxSasRec
from replay_tpu.serve.engine import ScoringEngine as JaxScoringEngine
from replay_tpu.serve.request import make_window as jax_make_window
from replay_tpu_torch.convert import flax_to_torch
from replay_tpu_torch.data import FeatureHint as PortFeatureHint
from replay_tpu_torch.data import FeatureType as PortFeatureType
from replay_tpu_torch.data.nn import TensorFeatureInfo as PortTensorFeatureInfo
from replay_tpu_torch.data.nn import TensorSchema as PortTensorSchema
from replay_tpu_torch.nn.sequential.sasrec import SasRec
from replay_tpu_torch.serve import ScoreResponse, ScoringEngine, make_window, top_k_cut

NUM_ITEMS, DIM, BLOCKS, HEADS, SEQ_LEN = 50, 16, 2, 2, 8
LENGTHS, BATCHES = (4, SEQ_LEN), (1, 4)
SLATE = np.array([3, 7, 11, 19, 23, 42], np.int32)
ATOL = RTOL = 1e-5


def _jax_model():
    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True,
            feature_hint=FeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )
    return JaxSasRec(
        schema=schema, embedding_dim=DIM, num_blocks=BLOCKS, num_heads=HEADS,
        max_sequence_length=SEQ_LEN, use_flash=True,
    )


def _port_model():
    schema = PortTensorSchema(
        PortTensorFeatureInfo(
            "item_id", PortFeatureType.CATEGORICAL, is_seq=True,
            feature_hint=PortFeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )
    return SasRec(
        schema, embedding_dim=DIM, num_blocks=BLOCKS, num_heads=HEADS,
        max_sequence_length=SEQ_LEN, use_flash=True, device="cpu",
    )


@pytest.fixture(scope="module")
def setup():
    jax_model = _jax_model()
    ids = np.zeros((2, SEQ_LEN), np.int32)
    params = jax_model.init(jax.random.PRNGKey(0), {"item_id": ids}, np.ones((2, SEQ_LEN), bool))
    params = jax.tree.map(np.asarray, params["params"])
    return jax_model, _port_model(), params


def _engines(setup, **kwargs):
    jax_model, port_model, params = setup
    kwargs = {"length_buckets": LENGTHS, "batch_buckets": BATCHES, **kwargs}
    return (
        JaxScoringEngine(jax_model, params, **kwargs),
        ScoringEngine(port_model, flax_to_torch(params), device="cpu", **kwargs),
    )


@pytest.fixture(scope="module")
def engines(setup):
    return _engines(setup)


def _windows(count, seed, length_bucket=SEQ_LEN):
    rng = np.random.default_rng(seed)
    windows = [make_window(list(rng.integers(0, NUM_ITEMS, rng.integers(0, 12))), length_bucket) for _ in range(count)]
    return np.stack([w[0] for w in windows]), np.stack([w[1] for w in windows])


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_make_window_is_the_jax_one():
    for items in ([], [5], list(range(1, 12)), [3, 1, 4]):
        for pad_id in (0, NUM_ITEMS):
            for got, want in zip(make_window(items, SEQ_LEN, pad_id), jax_make_window(items, SEQ_LEN, pad_id)):
                np.testing.assert_array_equal(got, want)


def test_routing_and_bucket_errors_match(engines):
    jax_engine, port = engines
    assert port.length_buckets == jax_engine.length_buckets == LENGTHS
    assert port.batch_buckets == jax_engine.batch_buckets == BATCHES
    for length in (0, 1, 4, 5, SEQ_LEN):
        assert port.route_length(length) == jax_engine.route_length(length)
    for rows in (1, 2, 4):
        assert port.batch_bucket(rows) == jax_engine.batch_bucket(rows)
    for call, arg in (("route_length", SEQ_LEN + 1), ("batch_bucket", 5)):
        with pytest.raises(ValueError) as want:
            getattr(jax_engine, call)(arg)
        with pytest.raises(ValueError, match=str(want.value)):
            getattr(port, call)(arg)
    ids, mask = _windows(5, 0)
    with pytest.raises(ValueError, match="exceeds the largest compiled bucket"):
        port.encode(SEQ_LEN, ids, mask)


@pytest.mark.parametrize(
    "kwargs",
    [
        {"length_buckets": (4, 6)},
        {"outputs": "logits"},
        {"outputs": "hidden", "candidates": SLATE},
    ],
    ids=["buckets_below_max_length", "unknown_outputs", "slate_without_scores"],
)
def test_construction_errors_match(setup, kwargs):
    jax_model, port_model, params = setup
    kwargs = {"length_buckets": LENGTHS, "batch_buckets": BATCHES, **kwargs}
    with pytest.raises(ValueError) as want:
        JaxScoringEngine(jax_model, params, **kwargs)
    with pytest.raises(ValueError) as got:
        ScoringEngine(port_model, flax_to_torch(params), device="cpu", **kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fill", [1, 3, 4])
@pytest.mark.parametrize("length_bucket", LENGTHS)
def test_encode_matches_jax(engines, fill, length_bucket):
    jax_engine, port = engines
    ids, mask = _windows(fill, fill * 10 + length_bucket, length_bucket)
    got_logits, got_hidden = port.encode(length_bucket, ids, mask)
    want_logits, want_hidden = jax_engine.encode(length_bucket, ids, mask)
    assert got_logits.shape == (fill, NUM_ITEMS) and got_hidden.shape == (fill, DIM)
    np.testing.assert_allclose(_np(got_logits), _np(want_logits), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_np(got_hidden), _np(want_hidden), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(_np(port.score_hidden(got_hidden)), _np(want_logits), atol=ATOL, rtol=RTOL)
    got_top, _ = top_k_cut(ScoreResponse(0, _np(got_logits)[0], None, "cold", "encode", 0.0), 5)
    assert got_top.shape == (5,)


def test_retrieval_mode_and_slate_match(setup):
    ids, mask = _windows(3, 7)
    jax_hidden, port_hidden = _engines(setup, outputs="hidden")
    none, got = port_hidden.encode(SEQ_LEN, ids, mask)
    _, want = jax_hidden.encode(SEQ_LEN, ids, mask)
    assert none is None
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=RTOL)
    with pytest.raises(ValueError, match="retrieval-mode engine has no hidden scorer"):
        port_hidden.score_hidden(got)

    jax_slate, port_slate = _engines(setup, candidates=SLATE)
    got_logits, got_hidden = port_slate.encode(SEQ_LEN, ids, mask)
    want_logits, _ = jax_slate.encode(SEQ_LEN, ids, mask)
    assert got_logits.shape == (3, len(SLATE))
    np.testing.assert_allclose(_np(got_logits), _np(want_logits), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(
        _np(port_slate.score_hidden(got_hidden)), _np(jax_slate.score_hidden(_np(got_hidden))),
        atol=ATOL, rtol=RTOL,
    )


def _port_leaf(jax_leaf: str) -> str:
    """The port's state_dict key for a flax param path."""
    *parents, leaf = jax_leaf.split("/")
    return ".".join([*parents, {"kernel": "weight", "scale": "weight", "embedding": "weight"}.get(leaf, leaf)])


def test_swap_params_accepted_and_refused_like_jax(setup):
    jax_engine, port = _engines(setup)
    _, _, params = setup
    rng = np.random.default_rng(8)
    swapped = jax.tree.map(lambda a: (a + rng.normal(scale=0.01, size=a.shape)).astype(a.dtype), params)
    assert port.validate_params(flax_to_torch(swapped)) is None
    port.swap_params(flax_to_torch(swapped))
    jax_engine.swap_params(swapped)
    ids, mask = _windows(4, 9)
    got, _ = port.encode(SEQ_LEN, ids, mask)
    want, _ = jax_engine.encode(SEQ_LEN, ids, mask)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=RTOL)

    grown = jax.tree.map(lambda a: a, swapped)
    table = grown["body"]["embedder"]["embedding_item_id"]["table"]
    table["embedding"] = np.concatenate([table["embedding"], table["embedding"][:10]])
    with pytest.raises(ValueError) as want_err:
        jax_engine.swap_params(grown)
    with pytest.raises(ValueError) as got_err:
        port.swap_params(flax_to_torch(grown))
    jax_leaf = "body/embedder/embedding_item_id/table/embedding"
    assert jax_leaf in str(want_err.value)
    assert str(got_err.value) == str(want_err.value).replace(jax_leaf, _port_leaf(jax_leaf))


def test_stats_match(setup):
    jax_engine, port = _engines(setup)
    for fill, bucket in ((1, SEQ_LEN), (3, 4), (4, SEQ_LEN)):
        ids, mask = _windows(fill, fill, bucket)
        _, hidden = port.encode(bucket, ids, mask)
        jax_engine.encode(bucket, ids, mask)
        port.score_hidden(hidden[:2])
        jax_engine.score_hidden(_np(hidden)[:2])
    port.record_ranked_batch(2, 4)
    jax_engine.record_ranked_batch(2, 4)
    assert port.stats() == jax_engine.stats()


def test_scores_within_a_bucket_ignore_fill_co_riders_and_row_order(engines):
    _, port = engines
    target, target_mask, _ = make_window([3, 1, 4, 1, 5, 9], SEQ_LEN)
    alone, _ = port.encode(SEQ_LEN, np.stack([target, target]), np.stack([target_mask, target_mask]))
    others, others_mask = _windows(3, 11)
    for position in range(4):
        ids = np.insert(others, position, target, axis=0)
        mask = np.insert(others_mask, position, target_mask, axis=0)
        for fill in range(max(position + 1, 2), 5):  # fills 2..4 share the batch bucket of 4
            assert port.batch_bucket(fill) == 4
            logits, _ = port.encode(SEQ_LEN, ids[:fill], mask[:fill])
            assert torch.equal(logits[position], alone[0])


def test_padding_id_zero_and_cardinality_give_the_same_scores(engines):
    """The serving window pads with item 0 while SasRec's padding row is the
    cardinality; the mask gives padded keys exact-zero weight, so the
    last-position scores are identical, as in the JAX engine."""
    jax_engine, port = engines
    rng = np.random.default_rng(12)
    histories = [list(rng.integers(0, NUM_ITEMS, n)) for n in (0, 1, 3, 7)]
    scores = {}
    for pad_id in (0, NUM_ITEMS):
        windows = [make_window(h, SEQ_LEN, pad_id) for h in histories]
        ids, mask = np.stack([w[0] for w in windows]), np.stack([w[1] for w in windows])
        scores[pad_id] = (port.encode(SEQ_LEN, ids, mask)[0], jax_engine.encode(SEQ_LEN, ids, mask)[0])
    assert torch.equal(scores[0][0], scores[NUM_ITEMS][0])
    np.testing.assert_array_equal(_np(scores[0][1]), _np(scores[NUM_ITEMS][1]))
