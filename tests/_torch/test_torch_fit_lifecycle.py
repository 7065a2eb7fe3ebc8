"""``Trainer.fit``'s lifecycle in the port against the JAX package's.

* The same SequenceBatcher batches (the port's and the JAX one's are equal
  bit for bit, ``test_torch_batcher.py``), the SASRec train and validate
  templates, the same converted weights at dropout 0 in f32:
  ``fit(monitor="recall@10", patience=1)`` of both packages stops at the same
  epoch, picks the same best epoch, and their histories agree within rtol
  1e-4 (train losses: f32 in another summation order, as in
  ``test_torch_train.py``; the metrics are counts over the same top-10
  lists). The events are the JAX ones: the same names in the same order,
  each payload's keys among the JAX payload's. One JAX trainer compile for
  the module.
* ``fit(scan_chunk=3)`` at dropout 0.3 on the CPU: bit for bit the per-step
  fit, with the checkpoints, the monitored best and the dropout stream.
* The seven observability arguments of the JAX ``fit`` are taken, each alone.
"""

import jax
import numpy as np
import pytest
import torch

from replay_tpu.data import FeatureHint, FeatureType
from replay_tpu.data.nn import SequenceBatcher as JaxSequenceBatcher
from replay_tpu.data.nn import SequentialDataset as JaxSequentialDataset
from replay_tpu.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu.data.nn import validation_batches as jax_validation_batches
from replay_tpu.nn import Trainer as JaxTrainer
from replay_tpu.nn.loss import CE as JaxCE
from replay_tpu.nn.sequential.sasrec import SasRec as JaxSasRec
from replay_tpu.nn.transform import Compose as JaxCompose
from replay_tpu.nn.transform.template import make_default_sasrec_transforms as jax_sasrec_transforms
from replay_tpu.utils.checkpoint import CheckpointManager as JaxCheckpointManager
from replay_tpu_torch.convert import torch_to_flax
from replay_tpu_torch.data import FeatureHint as PortFeatureHint
from replay_tpu_torch.data import FeatureType as PortFeatureType
from replay_tpu_torch.data.nn import SequenceBatcher, SequentialDataset, TransformedBatches, validation_batches
from replay_tpu_torch.data.nn import TensorFeatureInfo as PortTensorFeatureInfo
from replay_tpu_torch.data.nn import TensorSchema as PortTensorSchema
from replay_tpu_torch.nn.loss import CE
from replay_tpu_torch.nn.sequential.sasrec import SasRec
from replay_tpu_torch.nn.train import OptimizerFactory, Trainer
from replay_tpu_torch.nn.transform import Compose, make_default_sasrec_transforms
from replay_tpu_torch.utils.checkpoint import CheckpointManager

NUM_ITEMS, DIM, SEQ_LEN, BATCH, USERS, EPOCHS = 30, 16, 8, 8, 40, 6
WIDTH = dict(embedding_dim=DIM, num_blocks=1, num_heads=2, max_sequence_length=SEQ_LEN)
TOP_K = (1, 5, 10)
LR = 3e-2


def log(seed=0):
    """Per-user histories of 4–24 events over a small Zipf-skewed catalog:
    the train sequences and the held-out last item of each user."""
    rng = np.random.default_rng(seed)
    weights = 1.0 / np.arange(1, NUM_ITEMS + 1)
    sequences = [rng.choice(NUM_ITEMS, rng.integers(4, 25), p=weights / weights.sum()) for _ in range(USERS)]
    users = np.arange(USERS) * 2
    return (
        {"user_id": users, "item_id": [s[:-1] for s in sequences]},
        {"user_id": users, "item_id": [s[-1:] for s in sequences]},
    )


def schemas():
    def info(module, hint, ftype):
        return module(
            "item_id", ftype.CATEGORICAL, is_seq=True, feature_hint=hint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM
        )

    return (
        TensorSchema(info(TensorFeatureInfo, FeatureHint, FeatureType)),
        PortTensorSchema(info(PortTensorFeatureInfo, PortFeatureHint, PortFeatureType)),
    )


def port_side(dropout=0.0):
    """The port's trainer, train source and validation factory."""
    _, schema = schemas()
    train, truth = (SequentialDataset(schema, "user_id", "item_id", part) for part in log())
    pipes = {split: Compose(p) for split, p in make_default_sasrec_transforms(schema).items()}
    batcher = SequenceBatcher(train, batch_size=BATCH, max_sequence_length=SEQ_LEN + 1, windows=True, shuffle=True)
    model = SasRec(schema, device="cpu", generator=torch.Generator().manual_seed(0), dropout_rate=dropout, **WIDTH)
    trainer = Trainer(model, CE(), optimizer=OptimizerFactory(learning_rate=LR), device="cpu")
    return (
        trainer,
        TransformedBatches(batcher, pipes["train"]),
        lambda: (pipes["validate"](b) for b in validation_batches(train, truth, BATCH, SEQ_LEN)),
    )


class EventSink:
    def __init__(self):
        self.events = []

    def log_event(self, event):
        self.events.append(event)


@pytest.fixture(scope="module")
def both_fits(tmp_path_factory):
    """One fit of each package from the same weights, with sinks and managers."""
    trainer, source, val = port_side()
    initial = {name: value.detach().clone() for name, value in trainer.model.state_dict().items()}
    kwargs = dict(epochs=EPOCHS, monitor="recall@10", patience=1, top_k=TOP_K, item_count=NUM_ITEMS, log_every=0)
    port_sink = EventSink()
    port_state = trainer.fit(
        source, state=trainer.init_state(None, params=initial), val_batches=val, loggers=port_sink,
        checkpoint_manager=CheckpointManager(str(tmp_path_factory.mktemp("port"))), **kwargs,
    )

    jax_schema, _ = schemas()
    import pandas as pd

    train, truth = (JaxSequentialDataset(jax_schema, "user_id", "item_id", pd.DataFrame(part)) for part in log())
    pipes = {split: JaxCompose(p) for split, p in jax_sasrec_transforms(jax_schema).items()}
    batcher = JaxSequenceBatcher(train, batch_size=BATCH, max_sequence_length=SEQ_LEN + 1, windows=True, shuffle=True)
    from replay_tpu.data.nn import TransformedBatches as JaxTransformedBatches
    from replay_tpu.nn import OptimizerFactory as JaxOptimizerFactory

    jax_trainer = JaxTrainer(
        model=JaxSasRec(schema=jax_schema, **WIDTH), loss=JaxCE(), optimizer=JaxOptimizerFactory(learning_rate=LR)
    )
    first = jax_trainer.init_state(pipes["train"](next(iter(batcher))), params=torch_to_flax(initial))
    # on the shardings a train step returns, so that the first step compiles once
    first = jax.tree.map(jax.device_put, first, jax.tree.map(jax_trainer._template_sharding, first))
    jax_sink = EventSink()
    jax_state = jax_trainer.fit(
        JaxTransformedBatches(batcher, pipes["train"]), state=first,
        val_batches=lambda: (pipes["validate"](b) for b in jax_validation_batches(train, truth, BATCH, SEQ_LEN)),
        loggers=jax_sink, checkpoint_manager=JaxCheckpointManager(str(tmp_path_factory.mktemp("jax"))), **kwargs,
    )
    return trainer, port_state, port_sink, jax_trainer, jax_state, jax_sink


def test_monitored_fit_stops_and_picks_the_best_as_the_jax_fit(both_fits):
    trainer, port_state, _, jax_trainer, jax_state, _ = both_fits
    assert len(trainer.history) == len(jax_trainer.history) < EPOCHS  # the same early stop
    for got, want in zip(trainer.history, jax_trainer.history):
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, err_msg=key)
    recalls = [r["recall@10"] for r in trainer.history]
    best = int(np.argmax(recalls))
    assert best == int(np.argmax([r["recall@10"] for r in jax_trainer.history]))
    steps_per_epoch = port_state.step // (best + 1)
    assert port_state.step == int(jax_state.step) == steps_per_epoch * (best + 1)


def test_fit_events_are_the_jax_events(both_fits):
    _, _, port_sink, _, _, jax_sink = both_fits
    assert [e.event for e in port_sink.events] == [e.event for e in jax_sink.events]
    for got, want in zip(port_sink.events, jax_sink.events):
        assert (got.step, got.epoch) == (want.step, want.epoch), got.event
        assert set(got.payload) <= set(want.payload), (got.event, set(got.payload) - set(want.payload))
    names = {e.event for e in port_sink.events}
    assert {"on_fit_start", "on_train_step", "on_validation_end", "on_epoch_end", "on_checkpoint", "on_fit_end"} <= names


def test_chunked_fit_with_dropout_equals_the_per_step_fit(tmp_path):
    """Dropout 0.3: the chunks (here eager, on the card one graph each) draw
    the same masks as the steps, so states, histories and checkpoints agree."""
    runs = []
    for index, scan_chunk in enumerate((None, 3)):
        trainer, source, val = port_side(dropout=0.3)
        manager = CheckpointManager(str(tmp_path / str(index)), max_to_keep=100)
        state = trainer.fit(
            source, epochs=2, val_batches=val, monitor="recall@10", top_k=TOP_K, log_every=0,
            checkpoint_manager=manager, checkpoint_every=4, scan_chunk=scan_chunk,
        )
        runs.append((state, trainer.history, manager.all_steps(), manager.best_step()))
    (a, history_a, steps_a, best_a), (b, history_b, steps_b, best_b) = runs
    assert a.step == b.step and torch.equal(a.flat_params, b.flat_params) and torch.equal(a.rng, b.rng)
    assert torch.equal(a.bad_steps, b.bad_steps)
    assert history_a == history_b and best_a == best_b
    assert len(steps_a) > 2 and len(steps_b) > 2  # mid-epoch saves in both (at chunk ends when chunked)
    assert not torch.equal(a.rng, torch.Generator().manual_seed(0).get_state())  # the masks were drawn


# the seven fit arguments of the JAX signature that raised until the
# observability slice; each is now taken (obs/ tests hold them to JAX)
OBSERVABILITY_FIT_ARGS = (
    "flight_path", "metrics_port", "profile_dir", "profile_steps", "slo_rules", "trace_path", "tracer",
)


@pytest.mark.parametrize("name", OBSERVABILITY_FIT_ARGS)
def test_every_unported_fit_argument_still_raises(name, tmp_path):
    """None of them raises any more: the fit runs with each alone, and each
    leaves its mark (a ring, a registry, a capture, a goodput record)."""
    from replay_tpu_torch.obs import SLORule, read_flight

    values = {
        "profile_steps": (1, 2), "profile_dir": str(tmp_path / "profile"), "tracer": True,
        "trace_path": str(tmp_path / "trace.json"), "metrics_port": 0,
        "slo_rules": [SLORule(metric="replay_train_loss", op=">", threshold=0.0)],
        "flight_path": str(tmp_path / "flight.ring"),
    }
    extra = {"profile_dir": str(tmp_path / "profile")} if name == "profile_steps" else {}
    trainer, source, _ = port_side()
    sink = EventSink()
    trainer.fit(source, log_every=0, loggers=[sink], **{name: values[name]}, **extra)
    assert len(trainer.history) == 1
    end = [e for e in sink.events if e.event == "on_fit_end"][0].payload
    if name == "profile_steps":
        assert end["device_time"]["capture"].startswith(str(tmp_path / "profile")) and "roofline" in end
    elif name == "tracer":
        assert set(end["goodput"]["fractions"]) >= {"train_step", "data_wait", "other"} and trainer.tracer is None
    elif name == "flight_path":
        assert read_flight(values[name]).records[-1]["event"] == "on_fit_end"
    elif name in ("metrics_port", "slo_rules"):
        assert trainer.metrics_registry is not None and trainer.metrics_exporter is None
        assert any(e.event == "on_slo_violation" for e in sink.events) == (name == "slo_rules")
    else:  # profile_dir without a window, trace_path without a tracer: nothing is written
        assert not (tmp_path / "profile").exists() and not (tmp_path / "trace.json").exists()
        assert "device_time" not in end and "goodput" not in end


def test_console_and_multi_loggers_print_the_jax_lines(caplog, monkeypatch):
    """The same fit events through the JAX ``ConsoleLogger`` and the port's
    give the same lines; ``MultiLogger`` fans out to every sink; the
    TensorBoard sink builds and writes the events' scalars."""
    from replay_tpu.obs import events as jax_events
    from replay_tpu_torch.obs import events as port_events

    script = [
        ("on_train_step", 2, 0, {"loss": 4.5}), ("on_train_step", 4, 0, {"loss": 4.25}),
        ("on_anomaly", 5, 0, {"consecutive_bad": 1}),
        ("on_recovery", 6, 0, {"reason": "consecutive_bad_steps", "restored_step": 4, "lr_scale": 0.5, "restarts": 1}),
        ("on_preemption", 7, 0, {"signal": "SIGTERM"}), ("on_epoch_end", 7, 0, {"record": {"epoch": 0}}),
    ]
    lines = []
    for module, name in ((jax_events, "replay_tpu"), (port_events, "replay_tpu_torch")):
        caplog.clear()
        sinks = [module.ConsoleLogger(every=2), EventSink()]
        with caplog.at_level("INFO", logger=name):
            fan = module.MultiLogger(sinks)
            for event, step, epoch, payload in script:
                fan.log_event(module.TrainerEvent(event=event, step=step, epoch=epoch, payload=payload))
        assert len(sinks[1].events) == len(script)
        lines.append([r.getMessage() for r in caplog.records if r.name == name])
    assert lines[0] == lines[1] and len(lines[1]) == 5
    scalars = []
    writer = type("Writer", (), {
        "__init__": lambda self, log_dir: None, "close": lambda self: None,
        "add_scalar": lambda self, tag, value, global_step=None: scalars.append((tag, value, global_step)),
    })
    monkeypatch.setattr(port_events, "_load_summary_writer", lambda: writer)
    board = port_events.TensorBoardLogger("runs")
    for event, step, epoch, payload in script:
        board.log_event(port_events.TrainerEvent(event=event, step=step, epoch=epoch, payload=payload))
    assert ("loss", 4.5, 2) in scalars and ("on_epoch_end/record/epoch", 0.0, 7) in scalars
