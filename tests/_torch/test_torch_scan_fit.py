"""``Trainer.train_steps`` and ``fit(scan_chunk=K, prefetch=n, device_feed=...)``
of the port against its own per-step path and against the JAX package, on the CPU.

* ``train_steps`` (K steps in one dispatch; on the card one CUDA graph, here K
  eager steps): the ``[K]`` losses and the final parameters bitwise equal to K
  ``train_step`` calls, for CE and CEFused; against the JAX ``train_steps``
  (one ``lax.scan``) from the same converted weights, losses within rtol 1e-4
  and parameters within atol 1e-5, the tolerances of ``test_torch_train.py``
  (f32 in another summation order; Adam scales gradient noise by up to lr·1e-2).
  The JAX side runs CEFused's Pallas kernels in interpret mode.
* ``fit(scan_chunk=3)`` over 7 batches × 2 epochs (two chunks and a tail of
  one per epoch) bitwise against ``fit()``: parameters, step, ``bad_steps``,
  ``rng`` and the history; also with a NaN batch in mid-chunk, with
  ``device_feed=False`` and with ``prefetch=2``, as the JAX package's
  ``tests/nn/test_scan_fit.py`` asks of its own. Two tests of that file fail
  at the seed (``ROADMAP.md`` queue 3), so the JAX chunked fit is not taken as
  a bitwise reference here: the JAX reference is ``train_steps`` above.
* ``scan_chunk < 1`` raises, and every argument of the JAX fit runs on the
  chunked path.
"""

import numpy as np
import pytest
import torch

import jax

from replay_tpu.data import FeatureHint, FeatureType
from replay_tpu.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu.nn import Trainer as JaxTrainer
from replay_tpu.nn.loss import CE as JaxCE
from replay_tpu.nn.loss import CEFused as JaxCEFused
from replay_tpu.nn.sequential.sasrec import SasRec as JaxSasRec
from replay_tpu_torch.convert import flax_to_torch, torch_to_flax
from replay_tpu_torch.data import FeatureHint as PortFeatureHint
from replay_tpu_torch.data import FeatureType as PortFeatureType
from replay_tpu_torch.data.nn import TensorFeatureInfo as PortTensorFeatureInfo
from replay_tpu_torch.data.nn import TensorSchema as PortTensorSchema
from replay_tpu_torch.nn.loss import CE, CEFused
from replay_tpu_torch.nn.sequential.sasrec import SasRec
from replay_tpu_torch.nn.train import RecoveryPolicy, Trainer
from replay_tpu_torch.utils.checkpoint import CheckpointManager

NUM_ITEMS, DIM, SEQ_LEN, BATCH, K = 50, 16, 8, 4, 3
WIDTH = dict(embedding_dim=DIM, num_blocks=2, num_heads=2, max_sequence_length=SEQ_LEN)


def train_batch(seed, nan=False):
    """Left-padded windows (padding id = cardinality) with next-item labels;
    the target mask in f32, so that one batch can carry a NaN weight, which
    makes that step's loss and gradient non-finite (the sentinel skips it)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, SEQ_LEN + 1, BATCH)
    mask = np.arange(SEQ_LEN)[None, :] >= SEQ_LEN - lengths[:, None]
    items = rng.integers(0, NUM_ITEMS, (BATCH, SEQ_LEN + 1)).astype(np.int32)
    target = mask[:, :, None].astype(np.float32)
    if nan:
        target[0, -1, 0] = np.nan
    return {
        "feature_tensors": {"item_id": np.where(mask, items[:, :-1], NUM_ITEMS).astype(np.int32)},
        "padding_mask": mask,
        "positive_labels": items[:, 1:, None],
        "target_padding_mask": target,
    }


BATCHES = [train_batch(seed) for seed in range(7)]


def port_trainer(loss_name="CE", **kwargs):
    schema = PortTensorSchema(
        PortTensorFeatureInfo(
            "item_id", PortFeatureType.CATEGORICAL, is_seq=True,
            feature_hint=PortFeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )
    model = SasRec(schema, device="cpu", generator=torch.Generator().manual_seed(0), **WIDTH)
    return Trainer(model, CEFused() if loss_name == "CEFused" else CE(), device="cpu", **kwargs)


def jax_trainer(loss_name):
    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True,
            feature_hint=FeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )
    loss = JaxCEFused(tile=8) if loss_name == "CEFused" else JaxCE()
    return JaxTrainer(model=JaxSasRec(schema=schema, **WIDTH), loss=loss)


def assert_same_state(a, b):
    assert a.step == b.step
    assert torch.equal(a.flat_params, b.flat_params)
    assert torch.equal(a.bad_steps, b.bad_steps)
    assert torch.equal(a.rng, b.rng)
    for link_a, link_b in zip(a.opt_state, b.opt_state):
        assert all(torch.equal(link_a[key], link_b[key]) for key in link_a)


@pytest.mark.parametrize("loss_name", ["CE", "CEFused"])
def test_train_steps_match_k_train_steps_and_the_jax_scan(loss_name):
    trainer = port_trainer(loss_name)
    initial = {name: value.detach().clone() for name, value in trainer.model.state_dict().items()}
    chunk = BATCHES[:K]

    state = trainer.init_state(chunk[0], params=initial)
    state, losses = trainer.train_steps(state, chunk)
    metrics = trainer.last_step_metrics
    assert losses.shape == (K,) and isinstance(losses, np.ndarray)
    assert {name: tuple(value.shape) for name, value in metrics.items()} == dict.fromkeys(
        ("loss", "good", "grad_norm"), (K,)
    )
    assert metrics["good"].all() and state.step == K and int(state.bad_steps) == 0

    stepper = port_trainer(loss_name)
    want = stepper.init_state(chunk[0], params=initial)
    want_losses = []
    for batch in chunk:
        want, loss = stepper.train_step(want, batch)
        want_losses.append(loss)
    np.testing.assert_array_equal(losses, torch.stack(want_losses).numpy())
    assert_same_state(state, want)

    jax_side = jax_trainer(loss_name)
    jax_state = jax_side.init_state(chunk[0], params=torch_to_flax(initial))
    jax_state, jax_losses = jax_side.train_steps(jax_state, chunk)
    np.testing.assert_allclose(losses, np.asarray(jax_losses), rtol=1e-4)
    got = torch_to_flax(trainer.model.state_dict())
    for path, value in jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jax_state.params)):
        node = got
        for key in path:
            node = node[key.key]
        name = jax.tree_util.keystr(path)
        if "['key']['bias']" not in name:  # zero gradient up to noise: see test_torch_train.py
            np.testing.assert_allclose(node, value, atol=1e-5, err_msg=name)


@pytest.mark.parametrize(
    "variant",
    [dict(), dict(device_feed=False), dict(prefetch=2), dict(nan=True)],
    ids=["device_feed", "device_feed_off", "prefetch", "nan_mid_chunk"],
)
def test_chunked_fit_bitwise_equals_the_per_step_fit(variant):
    """7 batches x 2 epochs with K=3: two chunks and a tail of one per epoch."""
    variant = dict(variant)
    batches = list(BATCHES)
    if variant.pop("nan", False):
        batches[4] = train_batch(4, nan=True)  # step 5, inside the second chunk
    per_step = port_trainer()
    state_a = per_step.fit(batches, epochs=2, log_every=0)
    chunked = port_trainer()
    state_b = chunked.fit(batches, epochs=2, log_every=0, scan_chunk=K, **variant)
    assert state_b.step == 14
    assert_same_state(state_a, state_b)
    assert per_step.history == chunked.history
    assert int(state_b.bad_steps) == (2 if batches[4] is not BATCHES[4] else 0)


def test_chunked_fit_logs_every_step_number(caplog):
    """``log_every`` counts the steps of a chunk one by one, as the per-step
    loop; the lines are the JAX ``ConsoleLogger``'s (``epoch e step s loss l``)."""
    records = []
    for scan_chunk in (None, K):
        caplog.clear()
        with caplog.at_level("INFO", logger="replay_tpu_torch"):
            port_trainer().fit(BATCHES, epochs=1, log_every=2, scan_chunk=scan_chunk)
        records.append([r.getMessage() for r in caplog.records if " step " in r.getMessage()])
    assert records[0] == records[1] and len(records[0]) == 3
    assert [line.split(" loss ")[0] for line in records[0]] == ["epoch 0 step 2", "epoch 0 step 4", "epoch 0 step 6"]


def test_scan_chunk_must_be_positive():
    with pytest.raises(ValueError, match="scan_chunk"):
        port_trainer().fit(BATCHES[:1], scan_chunk=0)


def test_batches_that_cannot_stack_raise():
    ragged = [BATCHES[0], {**BATCHES[1], "padding_mask": BATCHES[1]["padding_mask"][:, :4]}]
    with pytest.raises(ValueError, match="stacking failed"):
        port_trainer().train_steps(port_trainer().init_state(BATCHES[0]), ragged)


# the lifecycle and observability arguments of the JAX fit, each with a
# value the chunked fit must take (the observability ones raised until the
# observability slice; every fit argument is ported now)
PORTED_VALUES = {
    "checkpoint_manager": None, "checkpoint_every": 2, "resume": False, "monitor": "train_loss",
    "patience": 2, "mode": "min", "loggers": [], "recovery": None, "detect_anomalies": True,
    "handle_preemption": True,
}
UNPORTED_VALUES = {
    "profile_steps": (1, 2), "profile_dir": "profile", "tracer": True, "trace_path": "trace.json",
    "metrics_port": 0, "slo_rules": [], "flight_path": "flight.ring",
}


@pytest.mark.parametrize("name", sorted({**PORTED_VALUES, **UNPORTED_VALUES}))
def test_every_unported_fit_argument_still_raises_on_the_chunked_path(name, tmp_path):
    """Every argument of the JAX fit runs on the chunked path (paths under
    the test's directory)."""
    trainer = port_trainer()
    value = {**PORTED_VALUES, **UNPORTED_VALUES}[name]
    if name == "checkpoint_manager":
        value = CheckpointManager(str(tmp_path / "run"))
    elif name == "recovery":
        value = RecoveryPolicy()
    elif name in ("profile_dir", "trace_path", "flight_path"):
        value = str(tmp_path / value)
    extra = {"profile_dir": str(tmp_path / "profile")} if name == "profile_steps" else {}
    state = trainer.fit(BATCHES[:K], scan_chunk=K, log_every=0, **{name: value}, **extra)
    assert state.step == K and len(trainer.history) == 1
