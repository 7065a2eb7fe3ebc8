"""Model health in the port (``replay_tpu_torch/obs/health.py`` and the
trainer's health step) against the JAX package's, on the CPU.

One SASRec (1 block, E=16, L=8, 40 items, batch 4, the unfused attention
route, so that the entropy is computed) on the same converted weights and
batch through both trainers' ``train_step`` with a ``HealthConfig``: the
health records agree within rtol 1e-5 (atol 1e-7 for values near zero),
group norms and update ratios, stage rms and absmax, entropy per block, the
full-logits stats under ``CE`` and the streamed ones under ``CEFused`` (the
JAX side runs the Pallas kernels in interpret mode). The optimizer is SGD:
Adam's first update is about ``lr · sign(g)``, and a key bias's gradient is
rounding noise (``test_torch_train.py``), so its update norm would compare
noise. ``HealthWatcher`` gives
the JAX warnings on one record stream, ``_chunk_schedule`` the JAX schedule
with a health cadence, and a health-enabled ``fit(scan_chunk=K)`` trains
bitwise as ``health=None`` does.
"""

import math

import numpy as np
import pytest
import torch

from replay_tpu.data import FeatureHint, FeatureType
from replay_tpu.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu.nn import Trainer as JaxTrainer
from replay_tpu.nn.loss import CE as JaxCE
from replay_tpu.nn.loss import CEFused as JaxCEFused
from replay_tpu.nn.sequential.sasrec import SasRec as JaxSasRec
from replay_tpu.nn.train import OptimizerFactory as JaxOptimizerFactory
from replay_tpu.nn.train import _chunk_schedule as jax_chunk_schedule
from replay_tpu.obs import health as jax_health
from replay_tpu_torch.convert import torch_to_flax
from replay_tpu_torch.data import FeatureHint as PortFeatureHint
from replay_tpu_torch.data import FeatureType as PortFeatureType
from replay_tpu_torch.data.nn import TensorFeatureInfo as PortTensorFeatureInfo
from replay_tpu_torch.data.nn import TensorSchema as PortTensorSchema
from replay_tpu_torch.nn.loss import CE, CEFused
from replay_tpu_torch.nn.sequential.bert4rec import Bert4Rec
from replay_tpu_torch.nn.sequential.sasrec import SasRec
from replay_tpu_torch.nn.train import OptimizerFactory, Trainer, _chunk_schedule
from replay_tpu_torch.obs import health

NUM_ITEMS, DIM, SEQ_LEN, BATCH = 40, 16, 8, 4
WIDTH = dict(embedding_dim=DIM, num_blocks=1, num_heads=2, max_sequence_length=SEQ_LEN)
RTOL, ATOL = 1e-5, 1e-7


def train_batch(seed):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, SEQ_LEN + 1, BATCH)
    mask = np.arange(SEQ_LEN)[None, :] >= SEQ_LEN - lengths[:, None]
    items = rng.integers(0, NUM_ITEMS, (BATCH, SEQ_LEN + 1)).astype(np.int32)
    return {
        "feature_tensors": {"item_id": np.where(mask, items[:, :-1], NUM_ITEMS).astype(np.int32)},
        "padding_mask": mask,
        "positive_labels": items[:, 1:, None],
        "target_padding_mask": mask[:, :, None],
    }


BATCHES = [train_batch(seed) for seed in range(9)]


def port_schema():
    return PortTensorSchema(
        PortTensorFeatureInfo(
            "item_id", PortFeatureType.CATEGORICAL, is_seq=True,
            feature_hint=PortFeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )


SGD = dict(name="sgd", learning_rate=0.1)


def port_trainer(loss_name="CE", health_config=None, **kwargs):
    model = SasRec(port_schema(), device="cpu", generator=torch.Generator().manual_seed(0), **WIDTH)
    loss = CEFused() if loss_name == "CEFused" else CE()
    return Trainer(model, loss, device="cpu", health=health_config, **kwargs)


def jax_trainer(loss_name, health_config):
    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True,
            feature_hint=FeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )
    loss = JaxCEFused(tile=8) if loss_name == "CEFused" else JaxCE()
    return JaxTrainer(
        model=JaxSasRec(schema=schema, **WIDTH), loss=loss, health=health_config, optimizer=JaxOptimizerFactory(**SGD)
    )


def jax_record(trainer):
    import jax

    fetched = jax.device_get(trainer.last_step_metrics["health"])
    return jax.tree.map(lambda x: x.tolist() if getattr(x, "ndim", 0) else float(x), fetched)


@pytest.mark.parametrize("loss_name", ["CE", "CEFused"])
def test_health_record_matches_jax(loss_name):
    """One step of each trainer, same weights and batch: every leaf of the
    health record within rtol 1e-5."""
    port = port_trainer(loss_name, health.HealthConfig(cadence=1), optimizer=OptimizerFactory(**SGD))
    initial = {name: value.detach().clone() for name, value in port.model.state_dict().items()}
    state = port.init_state(BATCHES[0], params=initial)
    port.train_step(state, BATCHES[0])
    got = health.flatten_health(health.to_host(port.last_step_metrics["health"]))

    jax_side = jax_trainer(loss_name, jax_health.HealthConfig(cadence=1))
    jax_state = jax_side.init_state(BATCHES[0], params=torch_to_flax(initial))
    jax_side.train_step(jax_state, BATCHES[0])
    want = jax_health.flatten_health(jax_record(jax_side))

    assert set(got) == set(want), (sorted(set(got) ^ set(want)))
    assert {"health/attention_entropy/block_0", "health/activations/block_0/rms", "health/logits/std"} <= set(got)
    for tag, value in want.items():
        np.testing.assert_allclose(np.asarray(got[tag]), np.asarray(value), rtol=RTOL, atol=ATOL, err_msg=tag)


def test_streamed_logits_stats_never_build_the_logits_and_agree_with_the_full_ones():
    """The streamed sweep in blocks narrower than the catalog gives the full
    block's mean, std and absmax, and the JAX streamed function's."""
    rng = np.random.default_rng(3)
    hidden, table = rng.normal(size=(5, DIM)).astype(np.float32), rng.normal(size=(37, DIM)).astype(np.float32)
    streamed = health.streamed_logits_stats(torch.from_numpy(hidden), torch.from_numpy(table), chunk=8)
    full = health.health_metrics(
        health.HealthConfig(groups=False, embedding_coverage=False), {}, {}, {},
        logits=torch.from_numpy(hidden @ table.T),
    )["logits"]
    jax_streamed = jax_health.streamed_logits_stats(hidden, table, chunk=8)
    for key in ("mean", "std", "absmax"):
        np.testing.assert_allclose(float(streamed[key]), float(full[key]), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(float(streamed[key]), float(jax_streamed[key]), rtol=RTOL, atol=ATOL)


def test_health_watcher_gives_the_jax_warnings():
    """One record stream, a spike after the warm-up, a reset, then a second
    spike: the same warnings (or None) at every record."""
    norms = [1.0, 1.1, 0.9, 1.05, 9.0, 1.0, 1.2, math.nan, 1.1, 30.0, 1.0, 1.0, 1.1, 12.0]
    ratios = [0.01, 0.012, 0.011, 0.2, 0.01, 0.013, 0.01, 0.01, 0.9, 0.01, 0.01, 0.011, 0.012, 0.01]
    watchers = (health.HealthWatcher(warmup=2), jax_health.HealthWatcher(warmup=2))
    seen = [[], []]
    for index, (norm, ratio) in enumerate(zip(norms, ratios)):
        record = {"grad_norm_global": norm, "update_ratio": {"block_0": ratio, "head": ratio / 2}}
        for watcher, out in zip(watchers, seen):
            out.append(watcher.observe(record))
            if index == 9:
                watcher.reset()
    assert seen[0] == seen[1]
    assert sum(w is not None for w in seen[0]) >= 2
    assert {w["signal"] for w in seen[0] if w} == {"grad_norm", "update_ratio_max"}


@pytest.mark.parametrize(
    "chunk, cadence, start, count",
    [(3, 4, 0, 14), (3, 4, 5, 9), (32, 33, 0, 99), (4, 1, 0, 6), (3, None, 2, 8), (2, 3, 1, 1)],
)
def test_chunk_schedule_with_a_health_cadence_matches_jax(chunk, cadence, start, count):
    def layout(schedule):
        return [(kind, [b["id"] for b in payload] if kind == "scan" else payload["id"]) for kind, payload in schedule]

    batches = [{"id": i} for i in range(count)]
    got = layout(_chunk_schedule(iter(batches), chunk, cadence, start=start))
    want = layout(jax_chunk_schedule(iter(batches), chunk, cadence, start=start))
    assert got == want


@pytest.mark.parametrize("loss_name", ["CE", "CEFused"])
def test_health_fit_trains_bitwise_as_without_health(loss_name):
    """fit(scan_chunk=3) over 9 batches with health at cadence 4 (steps 4 and
    8 run singly, with health) against health=None: weights, rng, history
    bitwise; the records ride the step events at the cadence."""
    plain = port_trainer(loss_name)
    state_a = plain.fit(BATCHES, epochs=1, log_every=0, scan_chunk=3)
    events = []

    class Sink:
        def log_event(self, event):
            events.append(event)

    watched = port_trainer(loss_name, health.HealthConfig(cadence=4, watcher=health.HealthWatcher()))
    state_b = watched.fit(BATCHES, epochs=1, log_every=0, scan_chunk=3, loggers=[Sink()])
    assert torch.equal(state_a.flat_params, state_b.flat_params) and torch.equal(state_a.rng, state_b.rng)
    assert plain.history == watched.history
    with_health = [e.step for e in events if e.event == "on_train_step" and "health" in e.payload]
    assert with_health == [4, 8]
    epoch_end = [e for e in events if e.event == "on_epoch_end"][0]
    assert epoch_end.payload["health"] == watched.last_health
    assert math.isfinite(watched.last_health["grad_norm_global"])


def test_sow_sites_are_silent_without_a_capture_and_repeat_per_pass():
    """No capture: nothing is sown. A capture over BERT4Rec with two passes
    over its block: two values for each block site, stage names as in JAX."""
    schema = port_schema()
    model = Bert4Rec(
        schema, embedding_dim=DIM, num_blocks=1, num_heads=2, max_sequence_length=SEQ_LEN,
        num_passes_over_block=2, device="cpu",
    )
    batch = {
        "feature_tensors": {"item_id": torch.from_numpy(BATCHES[0]["feature_tensors"]["item_id"]).long()},
        "padding_mask": torch.from_numpy(BATCHES[0]["padding_mask"]),
    }
    assert not health.capturing()
    model(**batch)
    with health.capture_intermediates() as sown:
        model(**batch)
    assert sorted(sown) == sorted([
        "embed_rms", "embed_absmax", "final_norm_rms", "final_norm_absmax",
        "block_0_rms", "block_0_absmax", "block_0/attention_entropy",
    ])
    assert len(sown["block_0_rms"]) == 2 and len(sown["block_0/attention_entropy"]) == 2
    assert not health.capturing()
