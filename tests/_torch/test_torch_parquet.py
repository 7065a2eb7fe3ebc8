"""The parquet stream, ``DataModule`` and ``TensorSchemaBuilder`` of the port
against the JAX package's.

* ``gather_pad`` / ``gather_pad_2d``: bit for bit the JAX ones, its C++
  library and its numpy fallback, ints and floats, and the same errors.
* ``write_sequence_parquet``: the table the JAX writer writes, as pyarrow
  reads it back (values, schema, row groups).
* ``ParquetBatcher`` on one file: every batch bit for bit the JAX batcher's
  (``shard="rows"`` and ``"row_groups"``, shuffled, a memory budget small
  enough to force sub-slabs, ``read_ahead`` 0 and 2, 2, 3 and 4 replicas each
  as its own batcher with their ``valid=False`` alignment batches, a
  list-of-list column), and every ``StreamCursor.to_metadata()`` equal to
  JAX's. A cursor written by either package restores in the other and both
  emit the same rest of the epoch; ``rehash`` and ``migration_coverage`` are
  equal and the migrated epochs give the same batches.
* A SIGTERM in the middle of the port's ``fit(scan_chunk=2)`` over the
  stream, then ``resume=True``: bit for bit the uninterrupted run, and no
  slab before the cursor is read again.
* ``DataModule``: the JAX batches for a deterministic pipeline; a stochastic
  one repeats from its seed and epoch. ``TensorSchemaBuilder``: the JAX
  builder's schema.

Tolerance: none anywhere; the data path has no arithmetic to round.
"""

import json
import signal

import jax
import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import replay_tpu.native as jax_native
from replay_tpu.data import FeatureHint, FeatureType
from replay_tpu.data.nn import DataModule as JaxDataModule
from replay_tpu.data.nn import ParquetBatcher as JaxParquetBatcher
from replay_tpu.data.nn import Partitioning as JaxPartitioning
from replay_tpu.data.nn import ReplicasInfo as JaxReplicasInfo
from replay_tpu.data.nn import SequentialDataset as JaxSequentialDataset
from replay_tpu.data.nn import StreamCursor as JaxStreamCursor
from replay_tpu.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu.data.nn import TensorSchemaBuilder as JaxTensorSchemaBuilder
from replay_tpu.data.nn import write_sequence_parquet as jax_write_sequence_parquet
from replay_tpu.nn.transform.template import make_default_sasrec_transforms as jax_sasrec_transforms
from replay_tpu_torch.data import FeatureHint as PortFeatureHint
from replay_tpu_torch.data import FeatureSource as PortFeatureSource
from replay_tpu_torch.data import FeatureType as PortFeatureType
from replay_tpu_torch.data.nn import (
    DataModule,
    ParquetBatcher,
    Partitioning,
    ReplicasInfo,
    SequentialDataset,
    StreamCursor,
    TensorFeatureSource,
    TensorSchemaBuilder,
    TransformedBatches,
    write_sequence_parquet,
)
from replay_tpu_torch.data.nn import TensorFeatureInfo as PortTensorFeatureInfo
from replay_tpu_torch.data.nn import TensorSchema as PortTensorSchema
from replay_tpu_torch.data.nn.ragged import gather_pad, gather_pad_2d
from replay_tpu_torch.nn.loss import CE
from replay_tpu_torch.nn.sequential.sasrec import SasRec
from replay_tpu_torch.nn.train import OptimizerFactory, Trainer
from replay_tpu_torch.nn.transform import Compose, make_default_bert4rec_transforms, make_default_sasrec_transforms
from replay_tpu_torch.utils.checkpoint import CheckpointManager

NUM_ITEMS, ROWS, GROUP, BATCH, LIST_LEN = 30, 61, 10, 8, 7
METADATA = {"item_id": {"shape": LIST_LEN, "padding": NUM_ITEMS}, "rating": {"shape": LIST_LEN, "padding": 0}}
BUDGET = 256  # bytes: below a row group's footprint, so groups split into sub-slabs


def schemas():
    def build(info, ftype, hint, schema_type):
        return schema_type([
            info("item_id", ftype.CATEGORICAL, is_seq=True, feature_hint=hint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=8),
            info("rating", ftype.NUMERICAL, is_seq=True, tensor_dim=1, embedding_dim=8),
        ])

    return (
        build(TensorFeatureInfo, FeatureType, FeatureHint, TensorSchema),
        build(PortTensorFeatureInfo, PortFeatureType, PortFeatureHint, PortTensorSchema),
    )


def columns(seed=0):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 10, ROWS)
    return {
        "user_id": 3 * np.arange(ROWS) + 1,
        "item_id": [rng.integers(0, NUM_ITEMS, n).astype(np.int64) for n in lengths],
        "rating": [rng.standard_normal(n).astype(np.float32) for n in lengths],
    }


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The same sequences written by each package's writer, row groups of 10."""
    folder = tmp_path_factory.mktemp("stream")
    jax_schema, port_schema = schemas()
    data = columns()
    extra = {"age": list(np.random.default_rng(1).integers(18, 70, ROWS))}
    paths = {"jax": str(folder / "jax.parquet"), "port": str(folder / "port.parquet")}
    jax_write_sequence_parquet(
        paths["jax"], JaxSequentialDataset(jax_schema, "user_id", "item_id", pd.DataFrame(data)), extra, GROUP
    )
    write_sequence_parquet(paths["port"], SequentialDataset(port_schema, "user_id", "item_id", data), extra, GROUP)
    return paths


def assert_batches_equal(got, want):
    assert list(got) == list(want)
    for name in want:
        g, w = np.asarray(got[name]), np.asarray(want[name])
        assert g.dtype == w.dtype and g.shape == w.shape, name
        np.testing.assert_array_equal(g, w, err_msg=name)


def assert_streams_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_batches_equal(g, w)


# --------------------------------------------------------------------------- #
# the ragged gathers
# --------------------------------------------------------------------------- #
def ragged(floating, width=1):
    rng = np.random.default_rng(2)
    lengths = rng.integers(0, 9, 12)
    offsets = np.concatenate([[0], np.cumsum(lengths)])
    values = rng.standard_normal(offsets[-1] * width) if floating else rng.integers(-5, 99, offsets[-1] * width)
    return values.astype(np.float32 if floating else np.int32), offsets, rng.integers(0, 12, 20)


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("floating", [False, True])
def test_gathers_equal_jax(path, floating, monkeypatch):
    if path == "numpy":
        monkeypatch.setattr(jax_native, "native_available", lambda: False)
        monkeypatch.setattr(jax_native, "_native_has", lambda name: False)
    else:
        assert jax_native.native_available(), "the JAX package's C++ library did not build"
    values, offsets, rows = ragged(floating)
    for max_len in (0, 3, 9):
        for got, want in zip(gather_pad(values, offsets, rows, max_len, -7),
                             jax_native.gather_pad(values, offsets, rows, max_len, -7)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    values, offsets, rows = ragged(floating, width=3)
    for got, want in zip(gather_pad_2d(values, offsets, rows, 5, 3, 2),
                         jax_native.gather_pad_2d(values, offsets, rows, 5, 3, 2)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for bad_rows, bad_offsets in (([12], offsets), ([-1], offsets), ([0], np.array([0, 10**6]))):
        with pytest.raises(ValueError, match="out of range"):
            jax_native.gather_pad(values, bad_offsets, np.array(bad_rows), 4, 0)
        with pytest.raises(ValueError, match="out of range"):
            gather_pad(values, bad_offsets, np.array(bad_rows), 4, 0)


# --------------------------------------------------------------------------- #
# the writer and the batcher
# --------------------------------------------------------------------------- #
def test_writer_writes_the_jax_table(files):
    got, want = pq.ParquetFile(files["port"]), pq.ParquetFile(files["jax"])
    assert got.schema_arrow.remove_metadata() == want.schema_arrow.remove_metadata()
    assert got.metadata.num_row_groups == want.metadata.num_row_groups == -(-ROWS // GROUP)
    assert [got.metadata.row_group(g).num_rows for g in range(got.metadata.num_row_groups)] == [
        want.metadata.row_group(g).num_rows for g in range(want.metadata.num_row_groups)
    ]
    assert got.read().to_pydict() == want.read().to_pydict()
    with pytest.raises(ValueError, match="rows_per_chunk"):
        write_sequence_parquet(files["port"] + ".x", SequentialDataset(schemas()[1], "user_id", "item_id", columns()), None, 0)


def replica(count, index):
    return (
        JaxPartitioning(JaxReplicasInfo(count, index), shuffle=True, seed=5),
        Partitioning(ReplicasInfo(count, index), shuffle=True, seed=5),
    )


BATCHER_CASES = {
    "rows": dict(shard="rows", partition_size=16),
    "rows_shuffled": dict(shard="rows", partition_size=16, shuffle=True, seed=4),
    "row_groups": dict(shard="row_groups", shuffle=True, seed=4),
    "row_groups_plain": dict(shard="row_groups"),
    "budget": dict(shard="row_groups", shuffle=True, seed=4, memory_budget_bytes=BUDGET),
    "budget_read_ahead": dict(shard="row_groups", shuffle=True, seed=4, memory_budget_bytes=BUDGET, read_ahead=2),
}


def batchers(path, epoch=0, jax_part=None, port_part=None, **kwargs):
    kwargs = {"batch_size": BATCH, "metadata": METADATA, **kwargs}
    want = JaxParquetBatcher(path, partitioning=jax_part, **kwargs)
    got = ParquetBatcher(path, partitioning=port_part, **kwargs)
    want.set_epoch(epoch)
    got.set_epoch(epoch)
    return got, want


def cursors(batcher, count):
    return [batcher.cursor_for(k).to_metadata() for k in range(count + 1)]


@pytest.mark.parametrize("case", sorted(BATCHER_CASES))
def test_batches_and_cursors_equal_jax(files, case):
    kwargs = BATCHER_CASES[case]
    for epoch in (0, 1):
        got, want = batchers(files["jax"], epoch, **kwargs)
        wants = list(want)
        assert_streams_equal(list(got), wants)
        assert not wants[-1]["valid"].all()  # the padded tail
        if got.supports_cursor:
            assert cursors(got, len(wants)) == cursors(want, len(wants))
            assert json.loads(json.dumps(cursors(got, len(wants)))) == cursors(got, len(wants))
    if kwargs.get("memory_budget_bytes"):
        unbudgeted = ParquetBatcher(files["jax"], BATCH, METADATA, shard="row_groups")
        assert len(got._plan(0)[0]) > len(unbudgeted._plan(0)[0]) == -(-ROWS // GROUP)


@pytest.mark.parametrize("count", [2, 3, 4])
def test_replicas_equal_jax(files, count):
    streams = []
    for index in range(count):
        jax_part, port_part = replica(count, index)
        got, want = batchers(
            files["jax"], 1, jax_part, port_part, shard="row_groups", shuffle=True, seed=5, memory_budget_bytes=BUDGET
        )
        wants = list(want)
        assert_streams_equal(list(got), wants)
        assert cursors(got, len(wants)) == cursors(want, len(wants))
        streams.append(wants)
    assert len({len(s) for s in streams}) == 1  # every replica takes the same steps
    seen = np.concatenate([b["user_id"][b["valid"]] for s in streams for b in s])
    assert sorted(seen.tolist()) == sorted(columns()["user_id"].tolist())  # disjoint, each row once
    if count == 4:  # 7 row groups: one replica holds one, and pads with alignment batches
        assert any(not b["valid"].any() for s in streams for b in s)


def test_list_of_list_column_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    path = str(tmp_path / "vectors.parquet")
    lengths = rng.integers(1, 6, 23)
    table = pa.table({
        "user_id": np.arange(23),
        "vectors": [rng.standard_normal((n, 3)).round(3).tolist() for n in lengths],
    })
    pq.write_table(table, path, row_group_size=5)
    kwargs = dict(batch_size=4, metadata={"vectors": {"shape": [4, 3], "padding": -1}}, shard="row_groups", shuffle=True)
    got, want = ParquetBatcher(path, **kwargs), JaxParquetBatcher(path, **kwargs)
    got.set_epoch(0)
    want.set_epoch(0)
    assert_streams_equal(list(got), list(want))


def test_cursors_restore_across_packages(files):
    """Each package's cursor, through JSON, restores in the other: the rest
    of the epoch is the same batches. Also a fresh cursor's epoch check."""
    kwargs = dict(shard="row_groups", shuffle=True, seed=4, memory_budget_bytes=BUDGET, read_ahead=2)
    got, want = batchers(files["jax"], 1, **kwargs)
    full = list(want)
    list(got)
    for k in (1, 3, len(full) - 1, len(full)):
        for source, target_type in ((want, ParquetBatcher), (got, JaxParquetBatcher)):
            record = json.loads(json.dumps(source.cursor_for(k).to_metadata()))
            target = target_type(files["jax"], batch_size=BATCH, metadata=METADATA, **kwargs)
            target.set_epoch(1)
            target.restore_cursor(record)
            assert_streams_equal(list(target), full[k:])
    assert StreamCursor.from_metadata(record).to_metadata() == JaxStreamCursor.from_metadata(record).to_metadata()
    stale = ParquetBatcher(files["jax"], batch_size=BATCH, metadata=METADATA, **kwargs)
    stale.set_epoch(2)
    stale.restore_cursor(record)
    with pytest.raises(ValueError, match="epoch"):
        list(stale)
    other = ParquetBatcher(files["jax"], batch_size=BATCH, metadata=METADATA, **{**kwargs, "seed": 9})
    other.set_epoch(1)
    with pytest.raises(ValueError, match="different epoch plan"):
        other.restore_cursor(record)


def test_rehash_and_migration_equal_jax(files):
    """A 2-replica cursor rehashed onto 3 replicas: the same record, the same
    coverage audit, and each new replica's migrated epoch the same batches."""
    kwargs = dict(shard="row_groups", shuffle=True, seed=5, memory_budget_bytes=BUDGET)
    jax_part, port_part = replica(2, 0)
    got, want = batchers(files["jax"], 1, jax_part, port_part, **kwargs)
    list(got), list(want)
    rehashed = got.cursor_for(2).rehash(3)
    assert rehashed.to_metadata() == want.cursor_for(2).rehash(3).to_metadata()
    for index in range(3):
        jax_part, port_part = replica(3, index)
        new_got, new_want = batchers(files["jax"], 1, jax_part, port_part, **kwargs)
        assert new_got.migration_coverage(rehashed) == new_want.migration_coverage(rehashed.to_metadata())
        new_got.restore_cursor(rehashed)
        new_want.restore_cursor(rehashed.to_metadata())
        assert_streams_equal(list(new_got), list(new_want))
    with pytest.raises(ValueError, match="rehash-of-rehash"):
        rehashed.rehash(2)


# --------------------------------------------------------------------------- #
# a preempted fit over the stream
# --------------------------------------------------------------------------- #
class SigtermAt:
    """The stream, with a SIGTERM raised while batch ``at`` is fetched; it
    forwards the streaming protocol so that the cursor stays in use."""

    def __init__(self, inner, at):
        self.inner, self.at, self.raised = inner, at, False

    def __iter__(self):
        for position, batch in enumerate(self.inner):
            if position == self.at and not self.raised:
                self.raised = True
                signal.raise_signal(signal.SIGTERM)
            yield batch

    def set_epoch(self, epoch):
        self.inner.set_epoch(epoch)

    @property
    def supports_cursor(self):
        return self.inner.supports_cursor

    def cursor_for(self, k):
        return self.inner.cursor_for(k)

    def restore_cursor(self, cursor):
        self.inner.restore_cursor(cursor)

    @property
    def scan_compatible(self):
        return True


def stream_trainer(path):
    schema = schemas()[1]
    model = SasRec(
        PortTensorSchema(schema["item_id"]), embedding_dim=8, num_blocks=1, num_heads=1,
        max_sequence_length=LIST_LEN - 1, device="cpu", generator=torch.Generator().manual_seed(0),
    )
    trainer = Trainer(model, CE(), optimizer=OptimizerFactory(learning_rate=1e-2), device="cpu")
    pipeline = Compose(make_default_sasrec_transforms(PortTensorSchema(schema["item_id"]))["train"])
    batcher = ParquetBatcher(
        path, batch_size=BATCH, shuffle=True, seed=0, shard="row_groups", memory_budget_bytes=BUDGET, read_ahead=2,
        metadata={"item_id": METADATA["item_id"]}, columns=["item_id"],
    )
    stream = TransformedBatches(batcher, lambda raw: pipeline({k: raw[k] for k in ("item_id", "item_id_mask", "valid")}))
    return trainer, batcher, stream


def test_preempted_stream_fit_resumes_bitwise_without_rereading(files, tmp_path):
    trainer_a, _, stream_a = stream_trainer(files["port"])
    state_a = trainer_a.fit(stream_a, epochs=2, scan_chunk=2, log_every=0)

    trainer_b, _, stream_b = stream_trainer(files["port"])
    manager = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=100)
    interrupted = SigtermAt(stream_b, at=5)
    state_mid = trainer_b.fit(interrupted, epochs=2, scan_chunk=2, log_every=0, checkpoint_manager=manager)
    assert interrupted.raised and state_mid.step < state_a.step
    meta = manager.metadata(manager.latest_step())
    assert meta["preempted"] and meta["mid_epoch"]
    cursor = meta["stream_cursor"]
    assert cursor["batches"] == meta["step_in_epoch"] and cursor["slab"] > 0

    trainer_c, batcher_c, stream_c = stream_trainer(files["port"])
    reads = []
    original = ParquetBatcher._read_slab
    batcher_c._read_slab = lambda path, slab: reads.append((slab.group, slab.start)) or original(batcher_c, path, slab)
    state_c = trainer_c.fit(stream_c, epochs=2, scan_chunk=2, log_every=0, checkpoint_manager=manager, resume=True)
    assert state_c.step == state_a.step
    assert torch.equal(state_c.flat_params, state_a.flat_params)
    assert all(torch.equal(a, c) for la, lc in zip(state_a.opt_state, state_c.opt_state) for a, c in zip(la.values(), lc.values()))
    assert trainer_c.history[-1]["train_loss"] == trainer_a.history[-1]["train_loss"]
    # the resumed epoch reads its slabs from the cursor's on, each once, then epoch 1 whole
    plans = [[(s.group, s.start) for s in batcher_c._plan(epoch)[0]] for epoch in (0, 1)]
    assert reads == plans[0][cursor["slab"] :] + plans[1]


# --------------------------------------------------------------------------- #
# DataModule and TensorSchemaBuilder
# --------------------------------------------------------------------------- #
def test_data_module_equals_jax_and_repeats_its_masks(files):
    jax_schema, port_schema = schemas()
    item_jax, item_port = TensorSchema(jax_schema["item_id"]), PortTensorSchema(port_schema["item_id"])
    common = dict(
        sources={"train": files["jax"], "validate": files["jax"]}, batch_size=BATCH, partition_size=16, seed=3,
        metadata=METADATA,
    )
    want = JaxDataModule(transforms={"train": jax_sasrec_transforms(item_jax)["train"]}, **common)
    got = DataModule(transforms={"train": make_default_sasrec_transforms(item_port)["train"]}, **common)
    keep = ("item_id", "item_id_mask", "valid")
    for epoch in (0, 1):
        wants = [jax.tree.map(np.asarray, {k: v for k, v in b.items() if k != "rating"})
                 for b in want.train_batches(epoch)]
        gots = [{k: v for k, v in b.items() if k != "rating"} for b in got.train_batches(epoch)]
        assert len(gots) == len(wants)
        for g, w in zip(gots, wants):
            assert sorted(g) == sorted(w)
            for name in w:
                g_leaf = g[name]["item_id"] if name == "feature_tensors" else g[name]
                w_leaf = w[name]["item_id"] if name == "feature_tensors" else w[name]
                np.testing.assert_array_equal(np.asarray(g_leaf), w_leaf, err_msg=name)
    for g, w in zip(got.val_batches(), want.val_batches()):  # no pipeline: the raw batches
        assert_batches_equal({k: g[k] for k in keep}, {k: w[k] for k in keep})

    masked = dict(common, transforms={"train": make_default_bert4rec_transforms(item_port)["train"]})
    first, again = DataModule(**masked), DataModule(**masked)
    assert Compose(masked["transforms"]["train"]).needs_rng
    runs = [[b["token_mask"].clone() for b in module.train_batches(epoch)] for module, epoch in ((first, 0), (again, 0), (again, 1))]
    assert all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
    assert not all(torch.equal(a, b) for a, b in zip(runs[0], runs[2]))
    with pytest.raises(KeyError, match="No source configured for split 'test'"):
        next(got.test_batches())


def test_schema_builder_equals_jax():
    from replay_tpu.data import FeatureSource
    from replay_tpu.data.nn import TensorFeatureSource as JaxTensorFeatureSource

    def chain(builder, source, tensor_source, hint):
        return (
            builder.categorical("item_id", 40, is_seq=True, feature_hint=hint.ITEM_ID,
                                feature_source=tensor_source(source.INTERACTIONS, "item_id"), embedding_dim=16)
            .categorical_list("tags", 9, is_seq=True, padding_value=3)
            .numerical("price", 1, feature_sources=[tensor_source(source.ITEM_FEATURES, "price")])
            .numerical_list("vec", 4, is_seq=True, feature_hint=hint.RATING)
            .categorical("item_id", 41, is_seq=True, feature_hint=hint.ITEM_ID)  # replaces the first
            .build()
        )

    got = chain(TensorSchemaBuilder(), PortFeatureSource, TensorFeatureSource, PortFeatureHint)
    want = chain(JaxTensorSchemaBuilder(), FeatureSource, JaxTensorFeatureSource, FeatureHint)
    assert list(got) == ["item_id", "tags", "price", "vec"] and got["item_id"].cardinality == 41
    assert json.loads(got.to_json()) == json.loads(want.to_json())
