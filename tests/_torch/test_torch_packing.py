"""Packed rows in the port against the JAX package.

* ``segment_attention_mask`` and ``attention_mask_for_route(segment_ids=...)``:
  the JAX masks exactly (causal and bidirectional, training and
  ``deterministic``, padding rows); every kernel route raises the JAX
  ``ValueError``, word for word.
* ``first_fit_pack`` gives the JAX rows; ``PackedSequenceBatcher`` gives the
  JAX batches bit for bit over two epochs (shuffle, bucket boundaries,
  ``max_segments``, ``open_rows``, windows, a float feature shorter than the
  item sequence, a scalar feature, a short final batch), with the same
  ``len()`` and ``packing_summary()``. Tolerance: none, the data path has no
  arithmetic to round.
* Segment isolation on the port, bit for bit: rewriting one segment leaves
  every other segment's hidden states unchanged, and a packed segment equals
  the same sequence alone in its row (the JAX suite's two isolation tests,
  port against port).
* The packed SASRec against the JAX model on the same packed batch and
  converted weights: hidden states and logits at rtol 1e-5 / atol 1e-5 (f32,
  other summation orders). A packed ``fit`` over 4 epochs at dropout 0:
  per-epoch ``train_loss`` at rtol 1e-4 against the JAX ``fit`` (f32 sums
  over several steps in other orders); ``fit(scan_chunk=2)`` bit for bit the
  per-step fit.
* A model whose ``forward`` takes no ``segment_ids`` (TwoTower) refuses a
  packed batch in ``train_step`` and in ``fit(scan_chunk=2)``, and the
  evaluation programs refuse one too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from replay_tpu.data import FeatureHint, FeatureType
from replay_tpu.data.nn import PackedSequenceBatcher as JaxPackedSequenceBatcher
from replay_tpu.data.nn import SequentialDataset as JaxSequentialDataset
from replay_tpu.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu.data.nn import TransformedBatches as JaxTransformedBatches
from replay_tpu.data.nn import first_fit_pack as jax_first_fit_pack
from replay_tpu.nn import OptimizerFactory as JaxOptimizerFactory
from replay_tpu.nn import Trainer as JaxTrainer
from replay_tpu.nn import mask as jax_mask
from replay_tpu.nn.loss import CE as JaxCE
from replay_tpu.nn.sequential.sasrec import SasRec as JaxSasRec
from replay_tpu.nn.transform import Compose as JaxCompose
from replay_tpu.nn.transform.template import make_packed_sasrec_transforms as jax_packed_transforms
from replay_tpu_torch.convert import torch_to_flax
from replay_tpu_torch.data import FeatureHint as PortFeatureHint
from replay_tpu_torch.data import FeatureType as PortFeatureType
from replay_tpu_torch.data.nn import PackedSequenceBatcher, SequentialDataset, TransformedBatches, first_fit_pack
from replay_tpu_torch.data.nn import TensorFeatureInfo as PortTensorFeatureInfo
from replay_tpu_torch.data.nn import TensorSchema as PortTensorSchema
from replay_tpu_torch.nn import mask as port_mask
from replay_tpu_torch.nn.loss import CE
from replay_tpu_torch.nn.sequential import TwoTower
from replay_tpu_torch.nn.sequential.sasrec import SasRec
from replay_tpu_torch.nn.train import OptimizerFactory, Trainer
from replay_tpu_torch.nn.transform import Compose, make_packed_sasrec_transforms

NUM_ITEMS, DIM, SEQ_LEN, BATCH, ROWS, EPOCHS, LR = 30, 16, 12, 8, 48, 4, 5e-2
WIDTH = dict(embedding_dim=DIM, num_blocks=2, num_heads=2, max_sequence_length=SEQ_LEN)


def columns(rows=ROWS, seed=0, max_len=8):
    """Histories of 2–7 items, a float rating per event that is one or two
    events short in some rows, one scalar age per user; query ids not a range."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, max_len, rows)
    return {
        "query_id": 5 * np.arange(rows) + 3,
        "item_id": [rng.integers(1, NUM_ITEMS, n).astype(np.int64) for n in lengths],
        "rating": [
            rng.standard_normal(n - (i % 3 == 0) - (i % 5 == 0)).astype(np.float32) for i, n in enumerate(lengths)
        ],
        "age": rng.integers(18, 70, rows),
    }


def schema(info, ftype, hint, schema_type, extra=True):
    features = [
        info("item_id", ftype.CATEGORICAL, is_seq=True, feature_hint=hint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM)
    ]
    if extra:
        features += [
            info("rating", ftype.NUMERICAL, is_seq=True, tensor_dim=1, embedding_dim=DIM),
            info("age", ftype.CATEGORICAL, is_seq=False, cardinality=80, embedding_dim=DIM),
        ]
    return schema_type(features)


def datasets(extra=True, **kwargs):
    """The same columns as the JAX dataset (a pandas frame) and the port's."""
    data = columns(**kwargs)
    if not extra:
        data = {"query_id": data["query_id"], "item_id": data["item_id"]}
    jax_ds = JaxSequentialDataset(
        schema(TensorFeatureInfo, FeatureType, FeatureHint, TensorSchema, extra), "query_id", "item_id",
        pd.DataFrame(data),
    )
    port_ds = SequentialDataset(
        schema(PortTensorFeatureInfo, PortFeatureType, PortFeatureHint, PortTensorSchema, extra), "query_id",
        "item_id", data,
    )
    return jax_ds, port_ds


def assert_batches_equal(got, want):
    assert list(got) == list(want)
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


# --------------------------------------------------------------------------- #
# the segment mask
# --------------------------------------------------------------------------- #
def segments():
    """[4, 9] segment ids: three segments, two and a padding tail, one, none."""
    return np.array(
        [
            [1, 1, 2, 2, 2, 3, 3, 3, 3],
            [1, 1, 1, 2, 2, 0, 0, 0, 0],
            [1, 1, 1, 1, 1, 1, 1, 0, 0],
            [0, 0, 0, 0, 0, 0, 0, 0, 0],
        ],
        np.int32,
    )


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("deterministic", [False, True])
def test_segment_mask_equals_jax(causal, deterministic):
    seg = segments()
    padding = seg > 0
    want = jax_mask.segment_attention_mask(
        jnp.asarray(padding), jnp.asarray(seg), causal=causal, deterministic=deterministic
    )
    got = port_mask.segment_attention_mask(
        torch.tensor(padding), torch.tensor(seg), causal=causal, deterministic=deterministic
    )
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 1, 9, 9)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    routed = port_mask.attention_mask_for_route(
        False, torch.tensor(padding), causal=causal, deterministic=deterministic, segment_ids=torch.tensor(seg)
    )
    np.testing.assert_array_equal(routed.numpy(), np.asarray(want))


@pytest.mark.parametrize("route", [True, "tiled", "ring"])
def test_kernel_routes_refuse_segments_as_jax_does(route):
    seg = segments()
    with pytest.raises(ValueError) as want:
        jax_mask.attention_mask_for_route(route, jnp.asarray(seg > 0), segment_ids=jnp.asarray(seg))
    with pytest.raises(ValueError) as got:
        port_mask.attention_mask_for_route(route, torch.tensor(seg > 0), segment_ids=torch.tensor(seg))
    assert str(got.value) == str(want.value)


# --------------------------------------------------------------------------- #
# packing
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize(
    "lengths, capacity, boundaries, open_rows",
    [
        ([3, 4, 5, 2, 6, 1], 8, None, 64),
        ([3, 4, 3, 4, 9, 0], 8, [4], 64),
        ([7, 7, 7, 2, 1, 1], 8, None, 1),
        ([20, 1, 4, 4], 4, [2, 9], 2),
        (list(np.random.default_rng(3).integers(0, 30, 200)), 25, [4, 8, 16], 3),
        (list(np.random.default_rng(4).integers(1, 13, 300)), 13, None, 64),
    ],
)
def test_first_fit_pack_equals_jax(lengths, capacity, boundaries, open_rows):
    assert first_fit_pack(lengths, capacity, boundaries, open_rows) == jax_first_fit_pack(
        lengths, capacity, boundaries, open_rows
    )


PACKED_CASES = {
    "shuffled": dict(batch_size=5, shuffle=True, seed=3),
    "buckets": dict(batch_size=5, shuffle=True, bucket_boundaries=(4, 8)),
    "max_segments": dict(batch_size=4, max_segments=2, open_rows=2),
    "windows": dict(batch_size=6, shuffle=True, windows=True, window_stride=2, max_sequence_length=6),
}


@pytest.mark.parametrize("case", sorted(PACKED_CASES))
def test_packed_batches_equal_jax(case):
    kwargs = {"max_sequence_length": SEQ_LEN + 1, **PACKED_CASES[case]}
    jax_ds, port_ds = datasets()
    want_batcher = JaxPackedSequenceBatcher(jax_ds, **kwargs)
    got_batcher = PackedSequenceBatcher(port_ds, **kwargs)
    short_tail = False
    for epoch in (0, 1):
        want_batcher.set_epoch(epoch)
        got_batcher.set_epoch(epoch)
        assert len(got_batcher) == len(want_batcher)
        assert got_batcher.packing_summary() == want_batcher.packing_summary()
        wants, gots = list(want_batcher), list(got_batcher)
        assert len(gots) == len(wants) == len(want_batcher)
        for got, want in zip(gots, wants):
            assert_batches_equal(got, want)
        short_tail |= not wants[-1]["valid"].all()
    assert short_tail and got_batcher.scan_compatible


def test_packed_rows_isolate_a_shorter_secondary_feature():
    """The float feature is written left-aligned in its segment's slot and
    never reaches past it, where it is shorter than the items."""
    _, port_ds = datasets()
    batch = next(iter(PackedSequenceBatcher(port_ds, batch_size=BATCH, max_sequence_length=SEQ_LEN + 1)))
    seg = batch["segment_ids"]
    assert (batch["rating"][seg == 0] == 0).all() and (batch["item_id_mask"] == (seg > 0)).all()


# --------------------------------------------------------------------------- #
# segment isolation on the port, and the packed model against JAX
# --------------------------------------------------------------------------- #
def port_schema():
    return schema(PortTensorFeatureInfo, PortFeatureType, PortFeatureHint, PortTensorSchema, extra=False)


def port_model(seed=0, **kwargs):
    return SasRec(
        port_schema(), use_flash=False, dropout_rate=0.0, device="cpu", generator=torch.Generator().manual_seed(seed),
        **{**WIDTH, **kwargs},
    )


def hidden(model, items, padding, segment_ids):
    with torch.no_grad():
        return model(
            {"item_id": torch.tensor(items)}, torch.tensor(padding), segment_ids=torch.tensor(segment_ids)
        ).numpy()


def test_adversarial_neighbor_segment_cannot_move_hidden_states():
    """Rewriting segment 1's tokens (extreme ids too) leaves segment 2's hidden
    states and the other row bit for bit unchanged, and the reverse."""
    model = port_model()
    seg = np.zeros((2, SEQ_LEN), np.int32)
    seg[0, :5], seg[0, 5:9], seg[1, :7] = 1, 2, 1
    padding = seg > 0
    items = np.random.default_rng(0).integers(1, NUM_ITEMS, (2, SEQ_LEN)).astype(np.int32) * padding
    base = hidden(model, items, padding, seg)
    seg1, seg2 = seg[0] == 1, seg[0] == 2
    for adversarial in (1, NUM_ITEMS - 1):
        perturbed = items.copy()
        perturbed[0, seg1] = adversarial
        out = hidden(model, perturbed, padding, seg)
        np.testing.assert_array_equal(base[0][seg2], out[0][seg2])
        np.testing.assert_array_equal(base[1], out[1])
        assert not np.array_equal(base[0][seg1], out[0][seg1])
    perturbed = items.copy()
    perturbed[0, seg2] = NUM_ITEMS - 1
    np.testing.assert_array_equal(base[0][seg1], hidden(model, perturbed, padding, seg)[0][seg1])
    # the control: without segment ids (a plain causal mask) segment 2 sees segment 1
    perturbed = items.copy()
    perturbed[0, seg1] = NUM_ITEMS - 1
    with torch.no_grad():
        plain = model({"item_id": torch.tensor(items)}, torch.tensor(padding)).numpy()
        leaked = model({"item_id": torch.tensor(perturbed)}, torch.tensor(padding)).numpy()
    assert not np.array_equal(plain[0][seg2], leaked[0][seg2])


def test_packed_segment_matches_solo_forward_bitwise():
    """A segment at row offset 0 gives bit for bit the hidden states of the
    same sequence alone in the row."""
    model = port_model()
    rng = np.random.default_rng(1)
    a, b = 4, 5
    row = np.zeros((1, SEQ_LEN), np.int32)
    row[0, :a] = rng.integers(1, NUM_ITEMS, a)
    row[0, a : a + b] = rng.integers(1, NUM_ITEMS, b)
    seg = np.zeros((1, SEQ_LEN), np.int32)
    seg[0, :a], seg[0, a : a + b] = 1, 2
    solo_items, solo_seg = np.where(seg == 1, row, 0), (seg == 1).astype(np.int32)
    packed = hidden(model, row, seg > 0, seg)
    solo = hidden(model, solo_items, solo_seg > 0, solo_seg)
    np.testing.assert_array_equal(packed[0, :a], solo[0, :a])


def packed_batches(dataset, pipeline, batcher_type):
    batcher = batcher_type(dataset, batch_size=BATCH, max_sequence_length=SEQ_LEN + 1, shuffle=True, seed=0)
    return [pipeline(raw) for raw in batcher]


def test_packed_sasrec_equals_jax():
    jax_ds, port_ds = datasets(extra=False)
    port = port_model()
    params = torch_to_flax(port.state_dict())
    jax_schema = schema(TensorFeatureInfo, FeatureType, FeatureHint, TensorSchema, extra=False)
    jax_model = JaxSasRec(schema=jax_schema, dropout_rate=0.0, **WIDTH)
    batch = packed_batches(port_ds, Compose(make_packed_sasrec_transforms(port_schema())["train"]), PackedSequenceBatcher)[0]
    assert int(batch["segment_ids"].max()) > 1
    args = (
        {"item_id": np.asarray(batch["feature_tensors"]["item_id"])}, np.asarray(batch["padding_mask"]),
    )
    want = jax_model.apply({"params": params}, *args, segment_ids=np.asarray(batch["segment_ids"]))
    want_logits = jax_model.apply({"params": params}, want, method=JaxSasRec.get_logits)
    with torch.no_grad():
        got = port(batch["feature_tensors"], batch["padding_mask"], segment_ids=batch["segment_ids"])
        got_logits = port.get_logits(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), rtol=1e-5, atol=1e-5)


def port_fit(initial, scan_chunk=None):
    _, port_ds = datasets(extra=False)
    model = port_model()
    trainer = Trainer(model, CE(), optimizer=OptimizerFactory(learning_rate=LR), device="cpu")
    batcher = PackedSequenceBatcher(port_ds, batch_size=BATCH, max_sequence_length=SEQ_LEN + 1, shuffle=True, seed=0)
    source = TransformedBatches(batcher, Compose(make_packed_sasrec_transforms(port_schema())["train"]))
    state = trainer.fit(
        source, epochs=EPOCHS, state=trainer.init_state(None, params=initial), log_every=0, scan_chunk=scan_chunk
    )
    return trainer, state


def test_packed_fit_equals_jax_and_its_chunked_form():
    initial = {name: value.detach().clone() for name, value in port_model().state_dict().items()}
    trainer, state = port_fit(initial)
    chunked, chunked_state = port_fit(initial, scan_chunk=2)
    assert torch.equal(chunked_state.flat_params, state.flat_params)
    assert [h["train_loss"] for h in chunked.history] == [h["train_loss"] for h in trainer.history]

    jax_ds, _ = datasets(extra=False)
    jax_schema = schema(TensorFeatureInfo, FeatureType, FeatureHint, TensorSchema, extra=False)
    pipeline = JaxCompose(jax_packed_transforms(jax_schema)["train"])
    batcher = JaxPackedSequenceBatcher(jax_ds, batch_size=BATCH, max_sequence_length=SEQ_LEN + 1, shuffle=True, seed=0)
    jax_trainer = JaxTrainer(
        model=JaxSasRec(schema=jax_schema, dropout_rate=0.0, **WIDTH), loss=JaxCE(),
        optimizer=JaxOptimizerFactory(learning_rate=LR),
    )
    first = jax_trainer.init_state(pipeline(next(iter(batcher))), params=torch_to_flax(initial))
    first = jax.tree.map(jax.device_put, first, jax.tree.map(jax_trainer._template_sharding, first))
    jax_trainer.fit(JaxTransformedBatches(batcher, pipeline), epochs=EPOCHS, state=first, log_every=0)
    got = [h["train_loss"] for h in trainer.history]
    want = [h["train_loss"] for h in jax_trainer.history]
    assert len(got) == len(want) == EPOCHS
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_models_without_segment_ids_refuse_packed_batches():
    _, port_ds = datasets(extra=False)
    item_schema = port_schema()
    pipeline = Compose(make_packed_sasrec_transforms(item_schema)["train"])
    batches = packed_batches(port_ds, pipeline, PackedSequenceBatcher)
    model = TwoTower(item_schema, use_flash=False, device="cpu", generator=torch.Generator().manual_seed(0), **WIDTH)
    trainer = Trainer(model, CE(), device="cpu")
    state = trainer.init_state(None)
    before = state.flat_params.clone()
    refusal = "TwoTower.forward accepts no segment_ids parameter — training would silently attend"
    with pytest.raises(ValueError, match=refusal):
        trainer.train_step(state, batches[0])
    with pytest.raises(ValueError, match=refusal):
        trainer.train_steps(state, batches[:2])
    batcher = PackedSequenceBatcher(port_ds, batch_size=BATCH, max_sequence_length=SEQ_LEN + 1)
    with pytest.raises(ValueError, match=refusal):
        trainer.fit(TransformedBatches(batcher, pipeline), epochs=1, state=state, scan_chunk=2, log_every=0)
    assert torch.equal(state.flat_params, before) and state.step == 0
    # the evaluation programs take no segment ids on any model
    sasrec = Trainer(port_model(), CE(), device="cpu")
    with pytest.raises(ValueError, match="SasRec.forward_inference accepts no segment_ids"):
        sasrec.predict_logits(sasrec.init_state(None), batches[0])
    with pytest.raises(ValueError, match="TwoTower.get_query_embeddings accepts no segment_ids"):
        trainer.validate(state, batches[:1])
