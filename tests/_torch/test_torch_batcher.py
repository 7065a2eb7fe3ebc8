"""The port's host data path against the JAX package's, bit for bit.

The same pandas frame (made from a seed with numpy) goes to the JAX
``SequentialDataset`` and to the port's, which takes it by duck type; a
numpy-built port dataset (the form the card machine uses: it has no pandas)
must equal the frame-built one. Then ``Partitioning``, the ragged gather,
``SequenceBatcher`` (windows on and off, a stride, shuffling over three
epochs, length buckets, a scalar feature, the padded tail, replicas),
``validation_batches`` and ``TransformedBatches`` with the SASRec and
BERT4Rec templates: every batch's keys, dtypes, shapes and values equal to
the JAX ones (tolerance: none; the data path has no arithmetic to round).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax

from replay_tpu.data import FeatureHint, FeatureType
from replay_tpu.data.nn import Partitioning as JaxPartitioning
from replay_tpu.data.nn import ReplicasInfo as JaxReplicasInfo
from replay_tpu.data.nn import SequenceBatcher as JaxSequenceBatcher
from replay_tpu.data.nn import SequentialDataset as JaxSequentialDataset
from replay_tpu.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu.data.nn import TransformedBatches as JaxTransformedBatches
from replay_tpu.data.nn import validation_batches as jax_validation_batches
from replay_tpu.native import gather_pad_spans as jax_gather_pad_spans
from replay_tpu.nn import transform as jt
from replay_tpu_torch.data import FeatureHint as PortFeatureHint
from replay_tpu_torch.data import FeatureType as PortFeatureType
from replay_tpu_torch.data.batching import uniform_batch_count
from replay_tpu_torch.data.nn import (
    Partitioning,
    ReplicasInfo,
    SequenceBatcher,
    SequentialDataset,
    TensorFeatureInfo as PortTensorFeatureInfo,
    TensorSchema as PortTensorSchema,
    TransformedBatches,
    validation_batches,
)
from replay_tpu_torch.data.nn.ragged import gather_pad_spans
from replay_tpu_torch.nn import transform as pt
from replay_tpu_torch.obs import Tracer

NUM_ITEMS, USERS = 40, 23


def histories(seed=0):
    """Per-user item sequences of 1–29 events, a float rating per event and
    one scalar age per user, the query ids not a range."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 30, USERS)
    items = [rng.integers(0, NUM_ITEMS, n) for n in lengths]
    ratings = [rng.standard_normal(n) for n in lengths]
    return {
        "user_id": 3 * np.arange(USERS) + 7,
        "item_id": items,
        "rating": ratings,
        "age": rng.integers(18, 70, USERS),
    }


def features(module, hint, ftype, scalar=True):
    out = [
        module.TensorFeatureInfo(
            "item_id", ftype.CATEGORICAL, is_seq=True, feature_hint=hint.ITEM_ID, cardinality=NUM_ITEMS,
            embedding_dim=8,
        ),
        module.TensorFeatureInfo("rating", ftype.NUMERICAL, is_seq=True, tensor_dim=1, embedding_dim=8),
    ]
    if scalar:
        out.append(module.TensorFeatureInfo("age", ftype.CATEGORICAL, is_seq=False, cardinality=80, embedding_dim=8))
    return out


class _Jax:
    TensorFeatureInfo = TensorFeatureInfo


class _Port:
    TensorFeatureInfo = PortTensorFeatureInfo


def schemas(scalar=True):
    return (
        TensorSchema(features(_Jax, FeatureHint, FeatureType, scalar)),
        PortTensorSchema(features(_Port, PortFeatureHint, PortFeatureType, scalar)),
    )


def datasets(scalar=True, seed=0, columns=None):
    data = histories(seed)
    if columns is not None:
        data = {name: data[name] for name in columns}
    frame = pd.DataFrame(data)
    jax_schema, port_schema = schemas(scalar)
    return (
        JaxSequentialDataset(jax_schema, "user_id", "item_id", frame),
        SequentialDataset(port_schema, "user_id", "item_id", frame),
        SequentialDataset(port_schema, "user_id", "item_id", data),
    )


def assert_same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for key in w:
            if isinstance(w[key], dict):
                assert_same_batches([g[key]], [w[key]])
                continue
            a = g[key].numpy() if isinstance(g[key], torch.Tensor) else np.asarray(g[key])
            b = np.asarray(w[key])
            assert a.dtype == b.dtype and a.shape == b.shape, (key, a.dtype, b.dtype, a.shape, b.shape)
            np.testing.assert_array_equal(a, b, err_msg=key)


def test_numpy_built_dataset_equals_the_frame_built_one():
    jax_data, from_frame, from_numpy = datasets()
    for port in (from_frame, from_numpy):
        assert len(port) == len(jax_data) == USERS
        np.testing.assert_array_equal(port.query_ids, jax_data.query_ids)
        assert port.get_max_sequence_length() == jax_data.get_max_sequence_length()
        for row in range(USERS):
            assert port.get_query_id(row) == jax_data.get_query_id(row)
            for name in ("item_id", "rating", "age"):
                np.testing.assert_array_equal(port.get_sequence(row, name), jax_data.get_sequence(row, name))
        np.testing.assert_array_equal(
            port.get_sequence_by_query_id(7 + 3 * 5, "item_id"), jax_data.get_sequence_by_query_id(22, "item_id")
        )
    keep = np.array([40, 7, 22, 1000])
    np.testing.assert_array_equal(from_numpy.filter_by_query_id(keep).query_ids, jax_data.filter_by_query_id(keep).query_ids)
    left, right = SequentialDataset.keep_common_query_ids(from_numpy, from_numpy.filter_by_query_id(keep))
    assert left.query_ids.tolist() == right.query_ids.tolist() == [7, 22, 40]
    with pytest.raises(ValueError, match="missing"):
        SequentialDataset(schemas()[1], "user_id", "item_id", {"user_id": [1]})
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, item 11"):
        from_numpy.save("anywhere")


@pytest.mark.parametrize("replicas, shuffle", [(1, False), (1, True), (3, True), (4, False)])
def test_partitioning_matches_jax(replicas, shuffle):
    for replica in range(replicas):
        port = Partitioning(ReplicasInfo(replicas, replica), shuffle=shuffle, seed=5)
        ref = JaxPartitioning(JaxReplicasInfo(replicas, replica), shuffle=shuffle, seed=5)
        for n in (0, 1, 10, 17):
            for epoch in range(3):
                np.testing.assert_array_equal(port.generate(n, epoch), ref.generate(n, epoch))
                np.testing.assert_array_equal(port.shard_items(n, epoch), ref.shard_items(n, epoch))
    assert uniform_batch_count(17, 4) == 5
    with pytest.raises(ValueError):
        ReplicasInfo(2, 2)


def test_ragged_gather_matches_jax_bitwise():
    rng = np.random.default_rng(3)
    lengths = rng.integers(0, 12, 9)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    rows = rng.integers(0, 9, 30)
    stops = np.array([rng.integers(0, lengths[r] + 1) for r in rows])
    starts = np.array([rng.integers(0, s + 1) for s in stops])
    for values, pad in ((rng.integers(0, 100, offsets[-1]), -5), (rng.standard_normal(offsets[-1]), 0.5)):
        for max_len in (1, 4, 12):
            got = gather_pad_spans(values, offsets, rows, starts, stops, max_len, pad)
            want = jax_gather_pad_spans(values, offsets, rows, starts, stops, max_len, pad)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="out of range"):
        gather_pad_spans(values, offsets, rows, starts, stops + 100, 4, 0)


BATCHER_CASES = {
    "last_window": dict(max_sequence_length=8),
    "windows": dict(max_sequence_length=8, windows=True),
    "windows_stride": dict(max_sequence_length=8, windows=True, window_stride=3),
    "shuffle": dict(max_sequence_length=8, windows=True, shuffle=True, seed=4),
    "buckets": dict(max_sequence_length=12, windows=True, shuffle=True, bucket_boundaries=(4, 8, 30)),
    "replicas": dict(max_sequence_length=8, windows=True),
}


@pytest.mark.parametrize("case", sorted(BATCHER_CASES))
def test_sequence_batcher_matches_jax_bitwise(case):
    """Batch size 5 leaves a padded tail; three epochs advance the shuffle."""
    kwargs = dict(BATCHER_CASES[case])
    jax_data, from_frame, from_numpy = datasets()
    if case == "replicas":
        kwargs_port = dict(partitioning=Partitioning(ReplicasInfo(2, 1), shuffle=True, seed=2))
        kwargs_jax = dict(partitioning=JaxPartitioning(JaxReplicasInfo(2, 1), shuffle=True, seed=2))
    else:
        kwargs_port = kwargs_jax = {}
    want = JaxSequenceBatcher(jax_data, batch_size=5, **kwargs, **kwargs_jax)
    for dataset in (from_frame, from_numpy):
        got = SequenceBatcher(dataset, batch_size=5, **kwargs, **kwargs_port)
        assert got.scan_compatible == want.scan_compatible == (case != "buckets")
        for epoch in range(3):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            assert len(got) == len(want)
            batches = list(got)
            assert_same_batches(batches, list(want))
        assert not batches[-1]["valid"].all() or case == "buckets"


def test_every_batch_assembly_is_a_batch_build_span():
    tracer = Tracer()
    batcher = SequenceBatcher(datasets()[2], batch_size=5, max_sequence_length=8, windows=True, tracer=tracer)
    assert len(list(batcher)) == len(batcher) == tracer.summary()["batch_build"]["count"]


def test_validation_batches_match_jax_bitwise():
    jax_train, _, port_train = datasets(scalar=False, columns=("user_id", "item_id", "rating"))
    data = histories(1)
    held = {"user_id": data["user_id"][::2], "item_id": [s[:2] for s in data["item_id"][::2]], "rating": data["rating"][::2]}
    jax_schema, port_schema = schemas(scalar=False)
    jax_gt = JaxSequentialDataset(jax_schema, "user_id", "item_id", pd.DataFrame(held))
    port_gt = SequentialDataset(port_schema, "user_id", "item_id", held)
    assert_same_batches(validation_batches(port_train, port_gt, 5, 8), jax_validation_batches(jax_train, jax_gt, 5, 8))


@pytest.mark.parametrize("template", ["sasrec", "bert4rec"])
def test_transformed_batches_match_jax_bitwise(template):
    """The templates' train pipelines over windowed, shuffled batches; the
    BERT4Rec mask at ``mask_prob`` 1, where no draw changes the outcome
    (``test_torch_transforms.py``)."""
    jax_data, _, port_data = datasets(scalar=False, columns=("user_id", "item_id", "rating"))
    jax_schema, port_schema = schemas(scalar=False)
    if template == "sasrec":
        jax_pipe = jt.Compose(jt.make_default_sasrec_transforms(jax_schema)["train"])
        port_pipe = pt.Compose(pt.make_default_sasrec_transforms(port_schema)["train"])
        jax_fn, port_fn = jax_pipe, port_pipe
    else:
        jax_pipe = jt.Compose(jt.make_default_bert4rec_transforms(jax_schema, mask_prob=1.0)["train"])
        port_pipe = pt.Compose(pt.make_default_bert4rec_transforms(port_schema, mask_prob=1.0)["train"])
        jax_fn = lambda b: jax_pipe(b, jax.random.PRNGKey(0))  # noqa: E731
        port_fn = lambda b: port_pipe(b, torch.Generator().manual_seed(0))  # noqa: E731
    kwargs = dict(batch_size=5, max_sequence_length=9, windows=True, shuffle=True, seed=1)
    got = TransformedBatches(SequenceBatcher(port_data, **kwargs), port_fn)
    want = JaxTransformedBatches(JaxSequenceBatcher(jax_data, **kwargs), jax_fn)
    assert got.scan_compatible and not got.supports_cursor
    for epoch in (0, 2):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        assert_same_batches(list(got), list(want))
