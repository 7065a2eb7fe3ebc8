"""The rest of the single-device API against the JAX package's, on the CPU.

* ``Trainer.predict_query_embeddings`` and ``Trainer.predict_dataframe`` for
  SASRec and TwoTower, on weights drawn by the port and carried to JAX by
  ``convert.py``, against the jitted JAX trainer: embeddings and ratings
  within rtol 1e-5 (f32, summation orders differ), query ids exactly, item
  ids exactly where neighbouring scores are clear of ties; the dataframe
  bitwise the port's own ``predict_top_k``.
* ``UniformBatching``, ``DefaultAttentionMask``, ``json_default``,
  ``df_backend``, ``CompileTracker.wrap`` (one build at fixed shapes, two
  after a shape change), ``StepTimer``'s record and ``utils.trace``.
* ``TensorBoardLogger``: both packages' loggers write through the same stub
  ``SummaryWriter`` and make the same calls; with no backend the logger warns
  once and drops every event.
"""

import datetime
import json
import logging
import math

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from replay_tpu.data import FeatureHint, FeatureType
from replay_tpu.data import batching as jax_batching
from replay_tpu.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu.nn import Trainer as JaxTrainer
from replay_tpu.nn import mask as jax_mask
from replay_tpu.nn.loss import CE as JaxCE
from replay_tpu.nn.loss import CESampled as JaxCESampled
from replay_tpu.nn.sequential.sasrec import SasRec as JaxSasRec
from replay_tpu.nn.sequential.twotower import TwoTower as JaxTwoTower
from replay_tpu.obs import collectors as jax_collectors
from replay_tpu.obs import events as jax_events
from replay_tpu.utils import profiling as jax_profiling
from replay_tpu.utils import serde as jax_serde
from replay_tpu.utils import types as jax_types
from replay_tpu_torch import utils as port_utils
from replay_tpu_torch.convert import torch_to_flax, flax_to_torch
from replay_tpu_torch.data import FeatureHint as PortFeatureHint
from replay_tpu_torch.data import FeatureType as PortFeatureType
from replay_tpu_torch.data import UniformBatching
from replay_tpu_torch.data.nn import TensorFeatureInfo as PortTensorFeatureInfo
from replay_tpu_torch.data.nn import TensorSchema as PortTensorSchema
from replay_tpu_torch.nn import DefaultAttentionMask
from replay_tpu_torch.nn.loss import CE, CESampled
from replay_tpu_torch.nn.sequential import TwoTower
from replay_tpu_torch.nn.sequential.sasrec import SasRec
from replay_tpu_torch.nn.train import Trainer
from replay_tpu_torch.obs import CompileTracker
from replay_tpu_torch.obs import events as port_events
from replay_tpu_torch.utils.serde import json_default
from replay_tpu_torch.utils.types import ColumnTable, df_backend

NUM_ITEMS, DIM, BLOCKS, HEADS, SEQ_LEN, BATCH = 40, 16, 2, 2, 8, 4
WIDTH = dict(embedding_dim=DIM, num_blocks=BLOCKS, num_heads=HEADS, max_sequence_length=SEQ_LEN)
RTOL = ATOL = 1e-5
K = 5


# --------------------------------------------------------------------------- #
# predict_query_embeddings and predict_dataframe against the jitted JAX trainer
# --------------------------------------------------------------------------- #
def _schema(info, feature_type, hint, schema):
    return schema(
        info("item_id", feature_type.CATEGORICAL, is_seq=True, feature_hint=hint.ITEM_ID,
             cardinality=NUM_ITEMS, embedding_dim=DIM)
    )


def jax_schema():
    return _schema(TensorFeatureInfo, FeatureType, FeatureHint, TensorSchema)


def port_schema():
    return _schema(PortTensorFeatureInfo, PortFeatureType, PortFeatureHint, PortTensorSchema)


def eval_batch(seed, with_ids=True):
    """Left-padded windows (padding id = cardinality; one cold row), the last
    row batch padding."""
    rng = np.random.default_rng(seed)
    lengths = np.array([SEQ_LEN, 5, 0, 3])
    mask = np.arange(SEQ_LEN)[None, :] >= SEQ_LEN - lengths[:, None]
    ids = np.where(mask, rng.integers(0, NUM_ITEMS, (BATCH, SEQ_LEN)), NUM_ITEMS).astype(np.int32)
    batch = {"feature_tensors": {"item_id": ids}, "padding_mask": mask, "valid": np.array([True, True, True, False])}
    if with_ids:
        batch["query_id"] = np.arange(BATCH) + 10 * seed
    return batch


MODELS = {
    "sasrec": (lambda: SasRec(port_schema(), device="cpu", generator=torch.Generator().manual_seed(0), **WIDTH),
               lambda: JaxSasRec(schema=jax_schema(), **WIDTH), CE, JaxCE),
    "twotower": (lambda: TwoTower(port_schema(), device="cpu", generator=torch.Generator().manual_seed(0), **WIDTH),
                 lambda: JaxTwoTower(schema=jax_schema(), **WIDTH), CESampled, JaxCESampled),
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def trainers(request):
    make_port, make_jax, port_loss, jax_loss = MODELS[request.param]
    model = make_port()
    params = torch_to_flax(model.state_dict())
    trainer = Trainer(model, port_loss(), device="cpu")
    state = trainer.init_state(None, params=flax_to_torch(params))
    jax_trainer = JaxTrainer(model=make_jax(), loss=jax_loss())
    jax_state = jax_trainer.init_state(eval_batch(1), params=params)
    return request.param, trainer, state, jax_trainer, jax_state


def test_predict_query_embeddings_match_jax(trainers):
    _, trainer, state, jax_trainer, jax_state = trainers
    batches = [eval_batch(1), eval_batch(2)]
    ids, embeddings = trainer.predict_query_embeddings(state, batches)
    want_ids, want = jax_trainer.predict_query_embeddings(jax_state, batches)
    np.testing.assert_array_equal(ids, want_ids)
    assert embeddings.shape == want.shape == (2 * (BATCH - 1), DIM)  # invalid rows dropped
    np.testing.assert_allclose(embeddings, want, rtol=RTOL, atol=ATOL)
    # no query_id: arange over the kept rows
    ids, _ = trainer.predict_query_embeddings(state, [eval_batch(3, with_ids=False)])
    np.testing.assert_array_equal(ids, np.arange(BATCH - 1))
    ids, embeddings = trainer.predict_query_embeddings(state, [])
    assert ids.shape == (0,) and embeddings.shape == (0, 0)


def _pinned(scores, k):
    """Ranks whose score is clear of both neighbours by more than 2·RTOL·|s|."""
    gaps = -np.diff(scores, axis=1)
    before = np.concatenate([np.full((len(scores), 1), np.inf), gaps], axis=1)
    after = np.concatenate([gaps, np.full((len(scores), 1), np.inf)], axis=1)
    limit = 4 * RTOL * np.maximum(1.0, np.abs(scores))
    return (np.minimum(before, after) > limit)[:, :k]


def test_predict_dataframe_matches_jax(trainers):
    _, trainer, state, jax_trainer, jax_state = trainers
    batches = [eval_batch(4), eval_batch(5)]
    table = trainer.predict_dataframe(state, batches, K)
    frame = jax_trainer.predict_dataframe(jax_state, batches, K)
    assert isinstance(table, ColumnTable) and table.columns == list(frame.columns) == ["query_id", "item_id", "rating"]
    assert len(table) == len(frame) == 2 * (BATCH - 1) * K
    np.testing.assert_array_equal(table["query_id"], frame["query_id"].to_numpy())
    np.testing.assert_allclose(table["rating"], frame["rating"].to_numpy(), rtol=RTOL, atol=ATOL)
    pinned = _pinned(frame["rating"].to_numpy().reshape(-1, K), K).reshape(-1)
    assert pinned.mean() > 0.5
    np.testing.assert_array_equal(table["item_id"][pinned], frame["item_id"].to_numpy()[pinned])
    # the table is predict_top_k's arrays, row for row
    queries, items, scores = trainer.predict_top_k(state, batches, K)
    np.testing.assert_array_equal(table["query_id"], np.repeat(queries, K))
    np.testing.assert_array_equal(table["item_id"], items.reshape(-1))
    np.testing.assert_array_equal(table["rating"], scores.reshape(-1))


def test_query_embeddings_score_like_the_logits(trainers):
    name, trainer, state, _, _ = trainers
    batch = eval_batch(6)
    _, embeddings = trainer.predict_query_embeddings(state, [batch])
    logits = trainer.predict_logits(state, batch).numpy()[batch["valid"]]
    if name == "sasrec":
        table = trainer.model.get_item_weights().detach().numpy()
    else:
        table = trainer.model.encode_items().detach().numpy()
    np.testing.assert_allclose(embeddings @ table.T, logits, rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------- #
# the small API
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("total, size", [(0, 4), (10, 4), (12, 4), (3, 7)])
def test_uniform_batching_matches_jax(total, size):
    port, want = UniformBatching(total, size), jax_batching.UniformBatching(total, size)
    assert len(port) == len(want)
    assert [(port.start(i), port.limit(i)) for i in range(len(port))] == [
        (want.start(i), want.limit(i)) for i in range(len(want))
    ]
    for bad in (-1, len(port)):
        with pytest.raises(IndexError, match="out of range"):
            port.limit(bad)
    with pytest.raises(ValueError, match="batch_size positive"):
        UniformBatching(total, 0)


@pytest.mark.parametrize("deterministic", [False, True])
def test_default_attention_mask_matches_jax(deterministic):
    ids = np.array([[0, 0, 3, 4], [1, 2, 3, 4], [0, 0, 0, 0]], np.int32)
    got = DefaultAttentionMask("item_id", padding_value=0)({"item_id": torch.tensor(ids)}, deterministic=deterministic)
    want = jax_mask.DefaultAttentionMask("item_id", padding_value=0)({"item_id": jnp.asarray(ids)}, deterministic=deterministic)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 1, 4, 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_json_default_matches_jax():
    record = {
        "a": np.int64(3), "b": np.float32(0.5), "c": np.arange(3), "d": datetime.datetime(2024, 5, 1, 12, 30),
        "e": datetime.date(2024, 5, 2), "f": np.bool_(True),
    }
    assert json.dumps(record, default=json_default) == json.dumps(record, default=jax_serde.json_default)
    for bad in (object(), {1, 2}):
        with pytest.raises(TypeError) as got:
            json_default(bad)
        with pytest.raises(TypeError) as want:
            jax_serde.json_default(bad)
        assert str(got.value) == str(want.value)


def test_df_backend_matches_jax():
    frame = pd.DataFrame({"a": [1]})
    assert df_backend(frame) == jax_types.df_backend(frame) == "pandas"
    assert df_backend(ColumnTable({"a": [1]})) == "column_table"
    for name, module in (("polars", "polars.dataframe.frame"), ("spark", "pyspark.sql.dataframe")):
        fake = type("DataFrame", (), {"__module__": module})
        assert df_backend(fake()) == name  # by the class's module; nothing imported
    for bad in ({"a": [1]}, np.zeros(2)):
        with pytest.raises(TypeError) as got:
            df_backend(bad)
        with pytest.raises(TypeError) as want:
            jax_types.df_backend(bad)
        assert str(got.value) == str(want.value)


def test_compile_tracker_wrap_counts_builds_as_jax_counts_traces():
    def step(x, scale=2.0):
        return x * scale

    port = CompileTracker()
    jax_tracker = jax_collectors.CompileTracker()
    port_step = port.wrap(step, "step")
    jax_step = jax.jit(jax_tracker.wrap(step, "step"))
    for shape in ((3,), (3,), (3,), (4, 2), (4, 2)):
        port_step(torch.ones(shape))
        jax_step(jnp.ones(shape))
    assert port.traces == jax_tracker.traces == {"step": 2}
    assert set(port.report()) == set(jax_tracker.report()) == {"step"}
    assert port.wrap(step).__name__ == "step" and "step" in port.traces


@pytest.mark.parametrize("ticks, warmup, samples", [(6, 3, 8), (2, 3, 8), (3, 3, None), (5, 1, None)])
def test_step_timer_record_matches_jax(ticks, warmup, samples):
    port, want = port_utils.StepTimer(warmup, samples), jax_profiling.StepTimer(warmup, samples)
    for _ in range(ticks):
        port.tick(torch.ones(2))
        want.tick(jnp.ones(2))
    got, want = port.finish(torch.ones(1)), want.finish(jnp.ones(1))
    assert list(got) == list(want) == ["steps", "steps_per_sec", "samples_per_sec"]
    assert got["steps"] == want["steps"]
    for key in ("steps_per_sec", "samples_per_sec"):
        assert math.isnan(got[key]) == math.isnan(want[key]), key


def test_trace_writes_a_chrome_trace(tmp_path):
    with port_utils.trace(str(tmp_path / "profile")):
        torch.ones(4).add_(1)
    written = list((tmp_path / "profile").glob("*.pt.trace.json"))
    assert len(written) == 1 and "traceEvents" in json.loads(written[0].read_text())
    with pytest.raises(NotImplementedError, match="Perfetto"):
        with port_utils.trace(str(tmp_path / "other"), create_perfetto_link=True):
            pass


class StubWriter:
    """Records every call a TensorBoard SummaryWriter gets."""

    calls = []

    def __init__(self, log_dir):
        StubWriter.calls.append(("init", log_dir))

    def add_scalar(self, tag, value, global_step=None):
        StubWriter.calls.append(("scalar", tag, float(value), global_step))

    def add_histogram(self, tag, values, global_step=None):
        StubWriter.calls.append(("histogram", tag, np.asarray(values).tolist(), global_step))

    def close(self):
        StubWriter.calls.append(("close",))


def _script(module):
    health = {"grad_norm_global": 1.5, "activations": {"block_0": 0.25}, "attention_entropy": {"block_0": [0.5, np.nan, 0.75]}}
    events = [
        ("on_fit_start", None, None, {"epochs": 2, "model": "SasRec"}),
        ("on_train_step", 1, 0, {"loss": 4.5, "lr": 1e-3, "good": True, "health": health}),
        ("on_validation_end", 2, 0, {"record": {"recall@10": 0.25, "ndcg@10": 0.125, "epoch": 0}}),
        ("on_epoch_end", 2, 0, {"record": {"train_loss": 4.25}, "health": health, "bad_steps": 0}),
        ("on_fit_end", None, None, {"stopped_early": False, "history_length": 2}),
    ]
    return [module.TrainerEvent(event=e, step=s, epoch=p, payload=dict(payload)) for e, s, p, payload in events]


def test_tensorboard_logger_makes_the_jax_calls(monkeypatch, tmp_path):
    calls = []
    for module in (jax_events, port_events):
        StubWriter.calls = []
        monkeypatch.setattr(module, "_load_summary_writer", lambda: StubWriter)
        sink = module.TensorBoardLogger(str(tmp_path))
        for event in _script(module):
            sink.log_event(event)
        sink.log_histogram("extra", [1.0, 2.0], step=7)
        sink.close()
        calls.append(StubWriter.calls)
    assert calls[0] == calls[1]
    assert ("histogram", "health/attention_entropy/block_0", [0.5, 0.75], 1) in calls[1]
    assert ("scalar", "on_validation_end/record/recall@10", 0.25, 2) in calls[1]


def test_tensorboard_logger_without_a_backend_warns_once(monkeypatch, caplog, tmp_path):
    monkeypatch.setattr(port_events, "_load_summary_writer", lambda: None)
    with caplog.at_level(logging.WARNING, logger="replay_tpu_torch"):
        sink = port_events.TensorBoardLogger(str(tmp_path))
        for event in _script(port_events):
            sink.log_event(event)
        sink.log_histogram("extra", [1.0])
        sink.close()
    warnings = [r for r in caplog.records if "no tensorboard backend" in r.getMessage()]
    assert len(warnings) == 1 and not list(tmp_path.iterdir())
