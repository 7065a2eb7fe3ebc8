"""Checkpoints, resume, recovery and preemption of the port's ``Trainer.fit``.

* The scenarios of the JAX package's ``tests/utils/test_checkpoint.py`` and
  ``tests/nn/test_fault_tolerance.py`` that need neither orbax nor a mesh, on
  the port: a tiny SASRec with dropout 0.3, so that every resume also has to
  restore the stream of dropout masks. Tolerance: none — a resumed or
  rolled-back run must equal the reference run of the port bit for bit
  (parameters, optimizer state, ``bad_steps``, ``rng``, history).
* One scenario through both packages' ``fit`` at dropout 0, f32, on the same
  batches and converted weights (one module-scoped run each): a NaN run
  that trips ``RecoveryPolicy`` (rollback, LR backoff), ``checkpoint_every``
  mid-epoch saves, a SIGTERM in the last epoch, then ``resume=True`` in a
  fresh trainer with ``monitor``. The events (names, steps, epochs, every
  payload value but timings), the checkpoints' metadata, the best step and
  the histories must agree; losses, gradient norms and metrics within rtol
  1e-4 (f32 in another summation order, as in ``test_torch_train.py``). Two
  documented deviations are pinned, not skipped: a resumed epoch's
  ``train_loss`` covers the whole epoch (the JAX fit averages only the steps
  after the resume), carried by the mid-epoch metadata's ``epoch_loss`` and
  ``epoch_good``; and ``num_leaves`` counts the port's flat leaves.
"""

import functools
import json
import shutil
import signal

import jax
import numpy as np
import pytest
import torch

from replay_tpu.data import FeatureHint as JaxFeatureHint
from replay_tpu.data import FeatureType as JaxFeatureType
from replay_tpu.data.nn import TensorFeatureInfo as JaxTensorFeatureInfo
from replay_tpu.data.nn import TensorSchema as JaxTensorSchema
from replay_tpu.nn import OptimizerFactory as JaxOptimizerFactory
from replay_tpu.nn import RecoveryPolicy as JaxRecoveryPolicy
from replay_tpu.nn import Trainer as JaxTrainer
from replay_tpu.nn.loss import CE as JaxCE
from replay_tpu.nn.sequential.sasrec import SasRec as JaxSasRec
from replay_tpu.utils import faults as jax_faults
from replay_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from replay_tpu_torch.convert import torch_to_flax
from replay_tpu_torch.data import FeatureHint, FeatureType
from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu_torch.nn import PreemptionHandler, RecoveryPolicy
from replay_tpu_torch.nn.loss import CE
from replay_tpu_torch.nn.sequential.sasrec import SasRec
from replay_tpu_torch.nn.train import OptimizerFactory, Trainer
from replay_tpu_torch.utils.checkpoint import CheckpointManager, load_metadata, restore_pytree, save_pytree
from replay_tpu_torch.utils import faults
from replay_tpu_torch.utils.faults import NaNInjector, SignalAtStep, inject_nan, truncate_file

NUM_ITEMS, SEQ_LEN, BATCH = 12, 6, 4


def make_batch(seed: int) -> dict:
    """Full windows with next-item labels; the target mask in f32, the float
    leaf ``inject_nan`` poisons (a NaN weight makes the loss non-finite)."""
    rng = np.random.default_rng(seed)
    items = rng.integers(0, NUM_ITEMS, size=(BATCH, SEQ_LEN + 1)).astype(np.int32)
    mask = np.ones((BATCH, SEQ_LEN), dtype=bool)
    return {
        "feature_tensors": {"item_id": items[:, :-1]},
        "padding_mask": mask,
        "positive_labels": items[:, 1:, None],
        "target_padding_mask": mask[:, :, None].astype(np.float32),
    }


def make_trainer(learning_rate=1e-2, dropout=0.3, items=NUM_ITEMS) -> Trainer:
    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
            cardinality=items, embedding_dim=8,
        )
    )
    model = SasRec(
        schema, embedding_dim=8, num_blocks=1, num_heads=1, max_sequence_length=SEQ_LEN, dropout_rate=dropout,
        device="cpu", generator=torch.Generator().manual_seed(0),
    )
    return Trainer(model, CE(), optimizer=OptimizerFactory(learning_rate=learning_rate), device="cpu")


def stream(epoch: int, count: int = 5):
    return [make_batch(epoch * 100 + i) for i in range(count)]


class EventSink:
    def __init__(self):
        self.events = []

    def log_event(self, event):
        self.events.append(event)

    def named(self, name):
        return [e for e in self.events if e.event == name]


def assert_same_state(a, b):
    assert a.step == b.step
    assert torch.equal(a.flat_params, b.flat_params)
    assert torch.equal(a.bad_steps, b.bad_steps)
    assert torch.equal(a.rng, b.rng)
    for link_a, link_b in zip(a.opt_state, b.opt_state):
        assert list(link_a) == list(link_b)
        assert all(torch.equal(link_a[key], link_b[key]) for key in link_a)


def copy_steps(source, target, up_to):
    target.mkdir(parents=True, exist_ok=True)
    for path in source.glob("step_*"):
        if int(path.stem.split("_")[1]) <= up_to:
            shutil.copy(path, target / path.name)


def test_pytree_roundtrip_and_validation(tmp_path):
    trainer = make_trainer()
    state = trainer.init_state(make_batch(0))
    trainer.train_step(state, make_batch(0))
    save_pytree(str(tmp_path / "ckpt"), state, {"note": "x"})
    meta = load_metadata(str(tmp_path / "ckpt"))
    # step, flat_params, Adam's count/mu/nu, bad_steps, rng
    assert meta == {"note": "x", "num_leaves": 7, "backend": "npz"}
    with np.load(tmp_path / "ckpt.npz") as payload:
        assert int(payload["leaf_0"]) == 1 and payload["leaf_6"].dtype == np.uint8
    restored = restore_pytree(str(tmp_path / "ckpt"), make_trainer().init_state(make_batch(0)))
    assert_same_state(restored, state)
    with pytest.raises(ValueError, match="shape"):
        restore_pytree(str(tmp_path / "ckpt"), make_trainer(items=NUM_ITEMS + 1).init_state(make_batch(0)))
    save_pytree(str(tmp_path / "tree"), {"w": np.arange(4, dtype=np.float32)})
    with pytest.raises(ValueError, match="dtype"):
        restore_pytree(str(tmp_path / "tree"), {"w": np.zeros(4, np.float64)})
    with pytest.raises(NotImplementedError, match="queue 1, item 9"):
        CheckpointManager(str(tmp_path / "o"), backend="orbax")
    # Trainer.save_checkpoint / restore_checkpoint carry the same leaves
    trainer.save_checkpoint(str(tmp_path / "trainer"), state)
    assert_same_state(make_trainer().restore_checkpoint(str(tmp_path / "trainer"), make_batch(0)), state)


def test_manager_retention_best_and_history(tmp_path):
    manager = CheckpointManager(str(tmp_path / "run"), max_to_keep=2)
    tree = {"w": np.ones(3, np.float32)}
    manager.save(1, tree, history=[{"epoch": 0}])
    manager.mark_best(1)
    for step in (2, 3, 4):
        manager.save(step, tree, history=[{"epoch": e} for e in range(step)], metadata={"epoch": step})
    assert manager.all_steps() == [1, 3, 4]  # the best survives rotation
    assert manager.best_step() == 1 and manager.latest_step() == 4
    assert manager.history() == [{"epoch": e} for e in range(4)]
    assert manager.metadata(4)["epoch"] == 4
    manager.save(5, tree, process_metadata={"stream_cursor": {"batches": 3}})
    assert manager.process_metadata(5) == {"stream_cursor": {"batches": 3}}
    assert not list((tmp_path / "run").glob("*.tmp"))


def test_torn_saves_are_invisible_and_corrupt_steps_named(tmp_path):
    manager = CheckpointManager(str(tmp_path / "run"), max_to_keep=10)
    tree = {"w": np.arange(64, dtype=np.float32)}
    manager.save(5, tree)
    (tmp_path / "run" / "step_7.npz").write_bytes(b"torn half-write")  # no commit marker
    (tmp_path / "run" / "step_9.json").write_text(json.dumps({"step": 9, "backend": "npz"}))  # no payload
    assert manager.all_steps() == [5, 9] and manager.latest_step() == 5 and manager.skipped_steps == [9]
    np.testing.assert_array_equal(manager.restore({"w": np.zeros(64, np.float32)})["w"], tree["w"])
    manager.save(11, tree)
    truncate_file(str(tmp_path / "run" / "step_11.npz"), keep_fraction=0.3)
    with pytest.raises(ValueError, match="step_11"):
        manager.restore({"w": np.zeros(64, np.float32)}, step=11)
    manager.save(13, tree)
    (tmp_path / "run" / "step_13.json").write_text("{not json")
    with pytest.raises(ValueError, match="step_13"):
        manager.restore({"w": np.zeros(64, np.float32)}, step=13)
    manager.save(15, tree)
    with pytest.raises(ValueError, match="step_15.*num_leaves"):
        manager.restore({"w": np.zeros(64, np.float32), "b": np.zeros(2, np.float32)}, step=15)


@pytest.mark.parametrize("scan_chunk", [None, 2])
def test_mid_epoch_exact_resume(tmp_path, scan_chunk):
    """A run killed after a mid-epoch save and resumed equals the
    uninterrupted run: state, dropout stream and history."""
    kwargs = dict(epochs=2, checkpoint_every=2, log_every=0, scan_chunk=scan_chunk)
    trainer_a = make_trainer()
    state_a = trainer_a.fit(stream, checkpoint_manager=CheckpointManager(str(tmp_path / "a"), max_to_keep=100), **kwargs)
    copy_steps(tmp_path / "a", tmp_path / "b", up_to=9)  # epoch 1, step 4 of 5
    manager_b = CheckpointManager(str(tmp_path / "b"), max_to_keep=100)
    meta = manager_b.metadata(manager_b.latest_step())
    assert meta["mid_epoch"] and meta["epoch"] == 1 and meta["step_in_epoch"] == 4
    (tmp_path / "b" / "history.json").write_text(json.dumps(trainer_a.history[:1]))  # as saved at step 9
    trainer_b = make_trainer()
    state_b = trainer_b.fit(stream, checkpoint_manager=manager_b, resume=True, **kwargs)
    assert_same_state(state_b, state_a)
    assert trainer_b.history == trainer_a.history


def test_resume_from_epoch_end_checkpoint_and_already_complete(tmp_path):
    trainer_a = make_trainer()
    state_a = trainer_a.fit(stream, epochs=3, checkpoint_manager=CheckpointManager(str(tmp_path / "a")), log_every=0)
    trainer_b = make_trainer()
    manager_b = CheckpointManager(str(tmp_path / "b"))
    trainer_b.fit(stream, epochs=1, checkpoint_manager=manager_b, log_every=0)
    state_b = make_trainer().fit(stream, epochs=3, checkpoint_manager=manager_b, resume=True, log_every=0)
    assert_same_state(state_b, state_a)
    # the run is complete: a resume returns its checkpoint
    done = make_trainer().fit(stream, epochs=3, checkpoint_manager=manager_b, resume=True, log_every=0)
    assert_same_state(done, state_a)
    with pytest.raises(ValueError, match="checkpoint_manager"):
        make_trainer().fit(stream, resume=True)
    with pytest.raises(ValueError, match="ambiguous"):
        make_trainer().fit(stream, resume=True, checkpoint_manager=manager_b, state=state_a)


def test_monitored_best_survives_resume_and_is_returned(tmp_path):
    """A worse epoch after the resume (every batch poisoned: its loss is NaN,
    which improves on nothing) neither steals best.json nor the returned
    state; a resume of the complete run returns the best."""

    def batches(epoch):
        return [inject_nan(b) for b in stream(epoch, 3)] if epoch >= 2 else stream(epoch, 3)

    kwargs = dict(monitor="train_loss", mode="min", log_every=0)
    manager = CheckpointManager(str(tmp_path / "run"), max_to_keep=100)
    make_trainer(0.1).fit(batches, epochs=2, checkpoint_manager=manager, **kwargs)
    best_before = manager.best_step()
    trainer = make_trainer(0.1)
    state = trainer.fit(batches, epochs=3, checkpoint_manager=manager, resume=True, **kwargs)
    assert len(trainer.history) == 3 and not np.isfinite(trainer.history[-1]["train_loss"])
    assert manager.best_step() == best_before
    assert_same_state(state, manager.restore(state, step=best_before))
    done = make_trainer(0.1).fit(batches, epochs=3, checkpoint_manager=manager, resume=True, **kwargs)
    assert_same_state(done, state)


def test_patience_stops_early_and_returns_the_best(tmp_path):
    trainer = make_trainer(0.5)
    sink = EventSink()
    state = trainer.fit(
        lambda epoch: stream(0, 3), epochs=6, monitor="train_loss", mode="max", patience=1, loggers=sink,
        log_every=0, checkpoint_manager=CheckpointManager(str(tmp_path / "run")),
    )
    losses = [r["train_loss"] for r in trainer.history]
    assert len(losses) < 6 and sink.named("on_fit_end")[0].payload["stopped_early"]
    assert state.step == 3 * (int(np.argmax(losses)) + 1)


@pytest.mark.parametrize("scan_chunk", [None, 2])
def test_sigterm_mid_epoch_then_resume_is_bit_for_bit(tmp_path, scan_chunk):
    kwargs = dict(epochs=2, log_every=0, scan_chunk=scan_chunk, monitor="train_loss", mode="min")
    trainer_a = make_trainer()
    manager_a = CheckpointManager(str(tmp_path / "a"), max_to_keep=100)
    state_a = trainer_a.fit(stream, checkpoint_manager=manager_a, **kwargs)
    sig = SignalAtStep(7)  # epoch 1, while batch 2 is fetched
    sink = EventSink()
    handler_before = signal.getsignal(signal.SIGTERM)
    manager_b = CheckpointManager(str(tmp_path / "b"), max_to_keep=100)
    mid = make_trainer().fit(lambda epoch: sig.wrap(stream(epoch)), checkpoint_manager=manager_b, loggers=sink, **kwargs)
    assert sig.raised and mid.step < 10
    preempt = sink.named("on_preemption")
    assert len(preempt) == 1 and preempt[0].payload["signal"] == "SIGTERM"
    assert sink.named("on_fit_end")[0].payload["preempted"]
    assert manager_b.metadata(manager_b.latest_step())["preempted"]
    assert signal.getsignal(signal.SIGTERM) == handler_before  # fit put the handler back
    trainer_b = make_trainer()
    state_b = trainer_b.fit(stream, checkpoint_manager=manager_b, resume=True, **kwargs)
    assert_same_state(state_b, state_a)
    assert trainer_b.history == trainer_a.history
    assert manager_b.best_step() == manager_a.best_step()


def test_second_signal_restores_previous_handler():
    sentinel = []
    previous = signal.signal(signal.SIGTERM, lambda *a: sentinel.append("previous"))
    try:
        with PreemptionHandler() as handler:
            signal.raise_signal(signal.SIGTERM)
            assert handler.requested and handler.signal_name == "SIGTERM"
            signal.raise_signal(signal.SIGTERM)  # the second: the previous handler
            assert sentinel == ["previous"]
        signal.raise_signal(signal.SIGTERM)  # the context restored it
        assert sentinel == ["previous", "previous"]
    finally:
        signal.signal(signal.SIGTERM, previous)


@pytest.mark.parametrize("scan_chunk", [None, 2])
def test_recovery_rolls_back_to_checkpoint_with_lr_backoff(tmp_path, scan_chunk):
    injector = NaNInjector(at_steps=(3, 4, 5))  # three bad steps in a row
    trainer = make_trainer()
    sink = EventSink()
    state = trainer.fit(
        lambda epoch: injector.wrap(stream(0, 8)), epochs=1, scan_chunk=scan_chunk, log_every=0,
        checkpoint_manager=CheckpointManager(str(tmp_path / "run"), max_to_keep=10), checkpoint_every=2,
        recovery=RecoveryPolicy(max_consecutive_bad=3, max_restarts=2, lr_backoff=0.5), loggers=sink,
    )
    assert injector.injected_at == [3, 4, 5] and len(sink.named("on_anomaly")) == 3
    assert [e.step for e in sink.named("on_anomaly")] == [4, 5, 6]
    (recovery,) = sink.named("on_recovery")
    # checkpoint_every=2 saved steps 2 and 4 before the third bad step; the
    # sentinel kept step 4's parameters finite
    assert recovery.payload["reason"] == "consecutive_bad_steps"
    assert recovery.payload["restored_step"] == 4 and recovery.payload["lr_scale"] == 0.5
    assert trainer._lr_scale == 0.5 and state.step > 4
    assert np.isfinite(trainer.history[-1]["train_loss"]) and torch.isfinite(state.flat_params).all()


def test_recovery_budget_exhausted_raises_even_with_detect_anomalies_off():
    injector = NaNInjector(at_steps=range(2, 10))
    sink = EventSink()
    with pytest.raises(RuntimeError, match="budget exhausted"):
        make_trainer().fit(
            lambda epoch: injector.wrap(stream(0, 12)), epochs=1, log_every=0,
            recovery=RecoveryPolicy(max_consecutive_bad=2, max_restarts=1), detect_anomalies=False, loggers=sink,
        )
    assert sink.named("on_anomaly") == []  # silenced, never the trigger
    assert [e.payload.get("exhausted", False) for e in sink.named("on_recovery")] == [False, True]
    assert sink.named("on_recovery")[0].payload["restored_step"] is None  # the initial snapshot


def test_recovery_metric_blowup_triggers_rollback(tmp_path):
    injector = NaNInjector(at_steps=(3, 4, 5))  # all of epoch 1

    def batches(epoch):
        return injector.wrap(stream(epoch, 3))

    trainer = make_trainer()
    sink = EventSink()
    trainer.fit(
        batches, epochs=3, log_every=0, checkpoint_manager=CheckpointManager(str(tmp_path / "run"), max_to_keep=10),
        monitor="train_loss", mode="min", loggers=sink,
        recovery=RecoveryPolicy(max_consecutive_bad=10, max_restarts=2, blowup_factor=1.5),
    )
    (recovery,) = sink.named("on_recovery")
    assert recovery.payload["reason"] == "metric_blowup" and recovery.epoch == 1
    assert recovery.payload["restored_step"] == 3  # epoch 0's save; the diverged epoch never became one
    assert not np.isfinite(trainer.history[1]["train_loss"]) and np.isfinite(trainer.history[-1]["train_loss"])


def test_inject_nan_refuses_a_batch_without_floats():
    batch = make_batch(0)
    assert np.isnan(inject_nan(batch)["target_padding_mask"]).all()
    with pytest.raises(ValueError, match="no float leaves"):
        inject_nan({"ids": np.arange(3)})


# -- the same lifecycle through both packages' fit ----------------------------- #
# NaN at stream positions 4, 5 and 6. Steps 5 and 6 are two bad steps in a
# row: a rollback to the latest save (step 4's, not step 2's) at half the
# LR. The step after it is bad again and starts a new count: no second
# rollback. SIGTERM before position 14 (epoch 2, batch 2) preempts after
# that batch's step.
LIFECYCLE = dict(epochs=3, batches=6, nan_at=(4, 5, 6), signal_at=14, checkpoint_every=2)
# wall-clock values, never equal across packages (the compile report's build
# counts are compared; its seconds are timings)
TIMINGS = {
    "telemetry", "input", "samples_per_sec", "steps_per_sec", "step_seconds", "effective_tokens_per_sec",
    "compile_seconds",
}


def make_jax_trainer() -> JaxTrainer:
    schema = JaxTensorSchema(
        JaxTensorFeatureInfo(
            "item_id", JaxFeatureType.CATEGORICAL, is_seq=True, feature_hint=JaxFeatureHint.ITEM_ID,
            cardinality=NUM_ITEMS, embedding_dim=8,
        )
    )
    model = JaxSasRec(schema=schema, embedding_dim=8, num_blocks=1, num_heads=1, max_sequence_length=SEQ_LEN)
    return JaxTrainer(model=model, loss=JaxCE(), optimizer=JaxOptimizerFactory(learning_rate=1e-2))


def placed_like_a_step(trainer: JaxTrainer, state):
    """``state`` on the shardings a JAX train step returns (as the JAX fit
    places a restored state), so that the first step does not compile twice."""
    return jax.tree.map(jax.device_put, state, jax.tree.map(trainer._template_sharding, state))


def validation_batch() -> dict:
    rng = np.random.default_rng(7)
    return {
        "feature_tensors": {"item_id": rng.integers(0, NUM_ITEMS, size=(BATCH, SEQ_LEN)).astype(np.int32)},
        "padding_mask": np.ones((BATCH, SEQ_LEN), dtype=bool),
        "ground_truth": rng.integers(0, NUM_ITEMS, size=(BATCH, 1)).astype(np.int32),
    }


def lifecycle_run(package: str, directory) -> dict:
    """The scenario through one package's ``fit``, then ``resume=True`` in a
    fresh trainer; what each call emitted and left behind."""
    initial = {name: value.detach().clone() for name, value in make_trainer(dropout=0.0).model.state_dict().items()}
    if package == "port":
        new_trainer, params = (lambda: make_trainer(dropout=0.0)), initial
        manager_cls, policy_cls, injectors = CheckpointManager, RecoveryPolicy, faults
    else:
        params = torch_to_flax(initial)

        def new_trainer():
            trainer = make_jax_trainer()
            # a resuming fit builds a template state and restores into it; the
            # restore overwrites its values, so the template takes the weights
            # given and skips flax's eager init (7 s on the CPU)
            trainer.init_state = functools.partial(trainer.init_state, params=params)
            return trainer

        manager_cls, policy_cls, injectors = JaxCheckpointManager, JaxRecoveryPolicy, jax_faults
    nan = injectors.NaNInjector(at_steps=LIFECYCLE["nan_at"])
    sig = injectors.SignalAtStep(LIFECYCLE["signal_at"])
    count = LIFECYCLE["batches"]
    manager = manager_cls(str(directory), max_to_keep=100)
    validation = validation_batch()
    kwargs = dict(
        epochs=LIFECYCLE["epochs"], checkpoint_manager=manager, checkpoint_every=LIFECYCLE["checkpoint_every"],
        val_batches=lambda: [validation], monitor="recall@5", top_k=(1, 5), item_count=NUM_ITEMS, log_every=0,
        recovery=policy_cls(max_consecutive_bad=2, max_restarts=2, lr_backoff=0.5),
    )
    handler_before = signal.getsignal(signal.SIGTERM)
    run = {}
    interrupted, sink = new_trainer(), EventSink()
    state = interrupted.init_state(make_batch(0), params=params)
    if package == "jax":
        state = placed_like_a_step(interrupted, state)
    state = interrupted.fit(lambda epoch: sig.wrap(nan.wrap(stream(epoch, count))), state=state, loggers=sink, **kwargs)
    run["interrupted"] = (sink, list(interrupted.history), int(state.step))
    run["handler_restored"] = signal.getsignal(signal.SIGTERM) == handler_before
    resumed, sink = new_trainer(), EventSink()
    state = resumed.fit(lambda epoch: stream(epoch, count), resume=True, loggers=sink, **kwargs)
    run["resumed"] = (sink, list(resumed.history), int(state.step))
    run["lr_scale"] = resumed._lr_scale
    run["checkpoints"] = {step: manager.metadata(step) for step in manager.all_steps()}
    run["best_step"] = manager.best_step()
    run["saved_history"] = manager.history()
    return run


@pytest.fixture(scope="module")
def lifecycle_runs(tmp_path_factory):
    return {package: lifecycle_run(package, tmp_path_factory.mktemp(package)) for package in ("port", "jax")}


def assert_same_value(got, want, where):
    if isinstance(want, dict):
        assert set(got) <= set(want), (where, set(got) - set(want))
        for key in got:
            if key not in TIMINGS:
                assert_same_value(got[key], want[key], f"{where}.{key}")
    elif isinstance(want, float) and not isinstance(got, bool):
        np.testing.assert_allclose(got, want, rtol=1e-4, err_msg=where)
    else:
        assert got == want, where


def resumed_epoch_losses(run) -> list:
    """The ``on_train_step`` losses the resumed fit emitted."""
    return [e.payload["loss"] for e in run["resumed"][0].named("on_train_step")]


@pytest.mark.parametrize("fit_call", ["interrupted", "resumed"])
def test_recovery_and_preemption_events_are_the_jax_events(lifecycle_runs, fit_call):
    port, jax = lifecycle_runs["port"][fit_call][0], lifecycle_runs["jax"][fit_call][0]
    assert [(e.event, e.step, e.epoch) for e in port.events] == [(e.event, e.step, e.epoch) for e in jax.events]
    last_epoch = LIFECYCLE["epochs"] - 1
    for got, want in zip(port.events, jax.events):
        payload = dict(got.payload)
        if fit_call == "resumed" and "record" in payload and got.epoch == last_epoch:
            # the one deviation, pinned by the next test
            payload["record"] = {k: v for k, v in payload["record"].items() if k != "train_loss"}
        assert_same_value(payload, want.payload, f"{got.event}@{got.step}")
    if fit_call == "interrupted":
        (recovery,) = port.named("on_recovery")
        assert recovery.payload["restored_step"] == 4 and recovery.payload["lr_scale"] == 0.5
        assert [(e.step, e.payload["consecutive_bad"]) for e in port.named("on_anomaly")] == [(5, 1), (6, 2), (5, 1)]
        assert port.named("on_preemption")[0].step == 13 and port.named("on_fit_end")[0].payload["preempted"]
    else:
        assert port.named("on_fit_start")[0].payload["resumed"]


def test_recovery_and_preemption_checkpoints_and_histories_are_the_jax_ones(lifecycle_runs):
    port, jax = lifecycle_runs["port"], lifecycle_runs["jax"]
    assert list(port["checkpoints"]) == list(jax["checkpoints"])
    for step, want in jax["checkpoints"].items():
        got = dict(port["checkpoints"][step])
        if want.get("mid_epoch"):
            # the port's addition: the epoch's running loss sum and count
            assert isinstance(got.pop("epoch_loss"), float) and isinstance(got.pop("epoch_good"), int)
        assert got.pop("num_leaves") == 7  # step, flat_params, Adam's 3, bad_steps, rng
        want = {k: v for k, v in want.items() if k != "num_leaves"}
        assert sorted(got) == sorted(want), step
        assert_same_value(got, want, f"step_{step}")
    assert port["best_step"] == jax["best_step"] == 4  # epoch 0's end: the resume kept it
    assert port["resumed"][2] == jax["resumed"][2] == port["best_step"]  # the returned best state
    assert port["interrupted"][2] == jax["interrupted"][2] == 13  # the preempted state
    assert port["lr_scale"] == jax["lr_scale"] == 0.5  # the backoff survived the resume
    assert port["handler_restored"] and jax["handler_restored"]
    for history in ("interrupted", "resumed"):
        got, want = port[history][1], jax[history][1]
        assert len(got) == len(want)
        for index, (record, expected) in enumerate(zip(got, want)):
            if history == "resumed" and index == LIFECYCLE["epochs"] - 1:
                record = {k: v for k, v in record.items() if k != "train_loss"}
                expected = {k: v for k, v in expected.items() if k != "train_loss"}
            assert_same_value(record, expected, f"{history}[{index}]")
    # the deviation: the JAX fit averages the steps after the resume, the
    # port the whole epoch, from the sums the preempted save carried
    saved = port["checkpoints"][13]
    whole = (saved["epoch_loss"] + sum(resumed_epoch_losses(port))) / LIFECYCLE["batches"]
    np.testing.assert_allclose(port["resumed"][1][-1]["train_loss"], whole, rtol=1e-6)
    np.testing.assert_allclose(jax["resumed"][1][-1]["train_loss"], np.mean(resumed_epoch_losses(jax)), rtol=1e-6)
    assert saved["epoch_good"] == 3 and port["saved_history"] == port["resumed"][1]
