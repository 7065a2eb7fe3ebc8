"""Remat and scan_blocks on the port's SASRec and BERT4Rec encoders.

On the CPU every attention route runs its plain version (the unfused einsums,
K4's and K5's plain versions), and a remat or scanned model's loss and
gradients must be bitwise those of the plain loop model, at dropout 0 and at
dropout 0.3 (the recompute redraws the forward's masks from the restored
generator on the CPU; the card's way, the forward's draws saved and read back,
is exercised here too on ``native_dropout``, the op dropout is on the card).
The ``remat_policy`` spellings resolve as the JAX trainer resolves them, and
refuse what it refuses; ``Trainer(remat_policy=...)`` refuses TwoTower and
TiSasRec as the JAX trainer does; a scanned SASRec with ``remat_policy="dots"``
trains like the JAX one (weights carried across the stacked layout; losses
rtol 1e-4, parameters atol 1e-5, as ``test_torch_train.py``); a chunk of
``train_steps`` equals its eager steps; a health step sows each block once; a
checkpoint of one layout refuses the other; and the FLOPs count of a remat
step counts the recompute, K4's forward formula included.
"""

import importlib

import numpy as np
import pytest
import torch

import jax

from replay_tpu.data import FeatureHint, FeatureType
from replay_tpu.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu.nn import OptimizerFactory as JaxOptimizerFactory
from replay_tpu.nn import Trainer as JaxTrainer
from replay_tpu.nn.loss import CE as JaxCE
from replay_tpu.nn.sequential.sasrec import SasRec as JaxSasRec
from replay_tpu.nn.sequential.sasrec import TiSasRec as JaxTiSasRec
from replay_tpu.nn.train import _resolve_remat_policy as jax_resolve_remat_policy
from replay_tpu_torch.convert import flax_to_torch, torch_to_flax
from replay_tpu_torch.data import FeatureHint as PortFeatureHint
from replay_tpu_torch.data import FeatureType as PortFeatureType
from replay_tpu_torch.data.nn import TensorFeatureInfo as PortTensorFeatureInfo
from replay_tpu_torch.data.nn import TensorSchema as PortTensorSchema
from replay_tpu_torch.nn import remat
from replay_tpu_torch.nn.loss import CE
from replay_tpu_torch.nn.remat import checkpoint_dots, checkpoint_dots_with_no_batch_dims
from replay_tpu_torch.nn.sequential.bert4rec import Bert4Rec
from replay_tpu_torch.nn.sequential.sasrec import SasRec, TiSasRec
from replay_tpu_torch.nn.sequential.twotower import TwoTower
from replay_tpu_torch.nn.train import OptimizerFactory, Trainer, _resolve_remat_policy
from replay_tpu_torch.obs.health import HealthConfig
from replay_tpu_torch.utils.checkpoint import CheckpointManager

mfu = importlib.import_module("replay_tpu_torch.obs.mfu")

NUM_ITEMS, DIM, BLOCKS, HEADS, SEQ_LEN, BATCH = 30, 16, 2, 2, 8, 4
STEPS, LR = 3, 1e-2
WIDTH = dict(embedding_dim=DIM, num_blocks=BLOCKS, num_heads=HEADS, max_sequence_length=SEQ_LEN)
ROUTES = [False, True, "tiled"]
VARIANTS = {
    "remat": dict(remat=True),
    "remat_dots": dict(remat=True, remat_policy=checkpoint_dots),
    "remat_dots_no_batch": dict(remat=True, remat_policy=checkpoint_dots_with_no_batch_dims),
    "scan": dict(scan_blocks=True),
    "scan_remat_dots": dict(scan_blocks=True, remat=True, remat_policy=checkpoint_dots),
}


def port_schema(with_time=False):
    features = [
        PortTensorFeatureInfo(
            "item_id", PortFeatureType.CATEGORICAL, is_seq=True, feature_hint=PortFeatureHint.ITEM_ID,
            cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    ]
    if with_time:
        features.append(PortTensorFeatureInfo("timestamp", PortFeatureType.NUMERICAL, is_seq=True, tensor_dim=1))
    return PortTensorSchema(features)


def jax_schema():
    return TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
            cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )


def next_item_batch(seed):
    """Left-padded next-item windows (one row of one item)."""
    rng = np.random.default_rng(seed)
    mask = np.arange(SEQ_LEN)[None, :] >= SEQ_LEN - np.array([SEQ_LEN, 5, 1, 3])[:, None]
    ids = np.where(mask, rng.integers(0, NUM_ITEMS, (BATCH, SEQ_LEN)), NUM_ITEMS).astype(np.int32)
    labels = np.where(mask, rng.integers(0, NUM_ITEMS, (BATCH, SEQ_LEN)), NUM_ITEMS).astype(np.int32)
    return {
        "feature_tensors": {"item_id": ids},
        "padding_mask": mask,
        "positive_labels": labels[:, :, None],
        "target_padding_mask": mask[:, :, None],
    }


BATCHES = [next_item_batch(10 + i) for i in range(STEPS)]


def make_model(kind, route=False, dropout=0.0, **kwargs):
    cls = SasRec if kind == "sasrec" else Bert4Rec
    return cls(port_schema(), use_flash=route, dropout_rate=dropout, device="cpu",
               generator=torch.Generator().manual_seed(0), **WIDTH, **kwargs)


def scanned(state):
    """A loop layout's state_dict in the scanned layout: ``block_<i>.<p>`` → ``blocks.block.<p>[i]``."""
    out, stacked = {}, {}
    for name, value in state.items():
        head, sep, tail = name.partition(".block_")
        if not sep:
            out[name] = value
            continue
        index, _, leaf = tail.partition(".")
        stacked.setdefault(f"{head}.blocks.block.{leaf}", {})[int(index)] = value
    for name, layers in stacked.items():
        out[name] = torch.stack([layers[i] for i in sorted(layers)])
    return out


def forward_kwargs(kind, batch):
    kwargs = {
        "feature_tensors": {"item_id": torch.tensor(batch["feature_tensors"]["item_id"])},
        "padding_mask": torch.tensor(batch["padding_mask"]),
        "deterministic": False,
    }
    if kind == "bert4rec":
        kwargs["token_mask"] = torch.tensor(np.random.default_rng(3).random((BATCH, SEQ_LEN)) > 0.3)
    return kwargs


def loss_and_grads(model, kind, seed=5):
    """The sum of squares of the hidden states and its gradient w.r.t. every
    parameter, with the dropout generator seeded."""
    torch.manual_seed(seed)
    hidden = model(**forward_kwargs(kind, BATCHES[0]))
    loss = torch.sum(hidden.float() ** 2)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return loss.detach(), dict(zip([name for name, _ in model.named_parameters()], grads))


def assert_bitwise(got, want):
    (loss, grads), (want_loss, want_grads) = got, want
    assert torch.equal(loss, want_loss)
    assert sorted(grads) == sorted(want_grads)
    for name in grads:
        assert torch.equal(grads[name], want_grads[name]), name


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("route", ROUTES, ids=["unfused", "k4", "k5"])
@pytest.mark.parametrize("kind", ["sasrec", "bert4rec"])
@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_remat_and_scan_are_bitwise_the_loop_model(kind, route, variant, dropout):
    plain = make_model(kind, route, dropout)
    other = make_model(kind, route, dropout, **VARIANTS[variant])
    state = plain.state_dict()
    other.load_state_dict(scanned(state) if "scan" in variant else state)
    want = loss_and_grads(plain, kind)
    got = loss_and_grads(other, kind)
    if "scan" in variant:
        want = (want[0], scanned(want[1]))
    assert_bitwise(got, want)
    # evaluation runs the block once, no checkpoint
    with torch.no_grad():
        kwargs = dict(forward_kwargs(kind, BATCHES[1]), deterministic=True)
        assert torch.equal(other(**kwargs), plain(**kwargs))


def native_dropout(x, p=0.5, training=True, inplace=False):
    """``F.dropout`` as the card runs it: the ``native_dropout`` op."""
    if not training or p == 0.0:
        return x
    return torch.native_dropout(x, p, True)[0]


@pytest.mark.parametrize("policy", [None, checkpoint_dots])
def test_the_cards_recompute_reads_the_forwards_draws(monkeypatch, policy):
    """The card's mechanism on the CPU: dropout as ``native_dropout`` and the
    draws saved by the forward. The generator is disturbed before the
    backward: a recompute that redrew would see other masks."""
    monkeypatch.setattr(torch.nn.functional, "dropout", native_dropout)
    plain = make_model("sasrec", dropout=0.3)
    other = make_model("sasrec", dropout=0.3, remat=True, remat_policy=policy)
    other.load_state_dict(plain.state_dict())
    want = loss_and_grads(plain, "sasrec")
    monkeypatch.setattr(remat, "_draws_saved", lambda x: True)
    torch.manual_seed(5)
    hidden = other(**forward_kwargs("sasrec", BATCHES[0]))
    torch.manual_seed(123)
    disturbed = torch.random.get_rng_state()
    loss = torch.sum(hidden.float() ** 2)
    grads = dict(zip([n for n, _ in other.named_parameters()], torch.autograd.grad(loss, list(other.parameters()))))
    assert_bitwise((loss.detach(), grads), want)
    # the recompute drew nothing: the generator is where the disturbance left it
    assert torch.equal(torch.random.get_rng_state(), disturbed)


def test_remat_policy_spellings_resolve_as_in_jax():
    assert _resolve_remat_policy("full") is None and _resolve_remat_policy(True) is None
    assert _resolve_remat_policy("dots") is checkpoint_dots
    assert _resolve_remat_policy("dots_no_batch") is checkpoint_dots_with_no_batch_dims
    custom = checkpoint_dots_with_no_batch_dims
    assert _resolve_remat_policy(custom) is custom
    for bad in ("bogus", False, 1.5, 0):
        for resolve in (_resolve_remat_policy, jax_resolve_remat_policy):
            with pytest.raises(ValueError) as raised:
                resolve(bad)
        want = "unknown remat_policy" if isinstance(bad, str) else "must be a string, True, or callable"
        assert want in str(raised.value)
    aten, ops = torch.ops.aten, torch.ops.replay_tpu_torch
    saved = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    for op in (aten.mm.default, aten.addmm.default, aten.bmm.default, aten.baddbmm.default):
        assert checkpoint_dots(None, op) == saved
        no_batch = op in (aten.mm.default, aten.addmm.default)
        assert (checkpoint_dots_with_no_batch_dims(None, op) == saved) == no_batch
    # the attention kernels are not products: both policies recompute them
    for op in (ops.flash_attention_forward.default, ops.flash_attention_tiled_forward.default, aten.softmax.int):
        assert checkpoint_dots(None, op) != saved and checkpoint_dots_with_no_batch_dims(None, op) != saved
    with pytest.raises(TypeError, match="selective-checkpoint policy"):
        make_model("sasrec", remat=True, remat_policy="dots")


def test_trainer_remat_policy_clones_the_model_and_refuses_models_without_remat():
    trainer = Trainer(make_model("sasrec"), CE(), remat_policy="dots", device="cpu")
    assert trainer.model.remat and trainer.model.body.encoder.remat_policy is checkpoint_dots
    b4r = Trainer(make_model("bert4rec"), CE(), remat_policy=True, device="cpu")
    assert b4r.model.remat and b4r.model.body.encoder.remat_policy is None
    assert Trainer(make_model("sasrec"), CE(), device="cpu").model.remat is False
    refused = {
        "TwoTower": TwoTower(port_schema(), device="cpu", **WIDTH),
        "TiSasRec": TiSasRec(port_schema(with_time=True), device="cpu", **WIDTH),
    }
    for name, model in refused.items():
        with pytest.raises(ValueError, match=f"needs a model with a remat field \\(SasRec/Bert4Rec\\); {name} has none"):
            Trainer(model, CE(), remat_policy="full", device="cpu")
    with pytest.raises(ValueError, match=r"needs a model with a remat field \(SasRec/Bert4Rec\); TiSasRec has none"):
        JaxTrainer(model=JaxTiSasRec(schema=jax_schema(), embedding_dim=DIM), loss=JaxCE(), remat_policy="full")


def test_scanned_remat_trainer_matches_the_jax_trainer():
    """``Trainer(SasRec(scan_blocks=True), remat_policy="dots")`` in both
    packages from the same weights, carried across the stacked layout."""
    port_model = make_model("sasrec", scan_blocks=True)
    params = torch_to_flax(port_model.state_dict())
    assert params["body"]["encoder"]["blocks"]["block"]["attention"]["query"]["kernel"].shape == (BLOCKS, DIM, DIM)
    jax_model = JaxSasRec(schema=jax_schema(), scan_blocks=True, **WIDTH)
    jax_trainer = JaxTrainer(model=jax_model, loss=JaxCE(), optimizer=JaxOptimizerFactory(learning_rate=LR),
                             remat_policy="dots")
    jax_state = jax_trainer.init_state(BATCHES[0], params=params)
    assert jax.tree.structure(jax_state.params) == jax.tree.structure(params)
    trainer = Trainer(port_model, CE(), optimizer=OptimizerFactory(learning_rate=LR), remat_policy="dots",
                      device="cpu")
    state = trainer.init_state(BATCHES[0], params=flax_to_torch(params))
    want, got = [], []
    for batch in BATCHES:
        jax_state, loss = jax_trainer.train_step(jax_state, batch)
        want.append(float(loss))
        state, loss = trainer.train_step(state, batch)
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    trained = torch_to_flax(trainer.model.state_dict())
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jax_state.params)):
        node, start = trained, params
        for key in path:
            node, start = node[key.key], start[key.key]
        name = jax.tree_util.keystr(path)
        if "['key']['bias']" in name:
            # rounding noise scaled to ±lr per step by Adam (test_torch_train.py)
            assert np.abs(node - start).max() <= STEPS * LR * 1.01, name
            continue
        np.testing.assert_allclose(node, leaf, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("dropout", [0.0, 0.3])
def test_train_steps_chunk_is_bitwise_its_eager_steps_and_no_remat(dropout):
    def run(chunk, **kwargs):
        trainer = Trainer(make_model("sasrec", route=True, dropout=dropout), CE(), device="cpu", seed=4, **kwargs)
        state = trainer.init_state(BATCHES[0])
        if chunk:
            state, losses = trainer.train_steps(state, BATCHES)
        else:
            losses = [float(trainer.train_step(state, batch)[1]) for batch in BATCHES]
        return np.asarray(losses, np.float32), state.flat_params.clone(), state.rng.clone()

    plain = run(False)
    for got in (run(True, remat_policy="dots"), run(False, remat_policy="full"), run(True, remat_policy="full")):
        assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(got, plain))


def test_health_step_sows_each_block_once():
    """A health step on a remat model: the record of the plain model's step,
    each block's stage stats and attention entropy sowed once (the
    recompute sows nothing); a scanned stack sows no stage stats and stacks
    its layers' entropies [N, H]."""
    records = {}
    for name, kwargs in {"plain": {}, "remat": dict(remat_policy="full"), "dots": dict(remat_policy="dots")}.items():
        trainer = Trainer(make_model("sasrec"), CE(), device="cpu", health=HealthConfig(cadence=1), **kwargs)
        state = trainer.init_state(BATCHES[0])
        trainer.train_step(state, BATCHES[0])
        records[name] = trainer.last_step_metrics["health"]
    plain = records.pop("plain")
    assert sorted(plain["activations"]) == ["block_0", "block_1", "embed", "final_norm"]
    assert sorted(plain["attention_entropy"]) == ["block_0", "block_1"]

    def flat(record, prefix=""):
        for key, value in record.items():
            if isinstance(value, dict):
                yield from flat(value, f"{prefix}{key}/")
            else:
                yield f"{prefix}{key}", value

    want = dict(flat(plain))
    for record in records.values():
        got = dict(flat(record))
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[key], want[key]) for key in want)
    trainer = Trainer(make_model("sasrec", scan_blocks=True), CE(), device="cpu", health=HealthConfig(cadence=1),
                      remat_policy="dots")
    trainer.train_step(trainer.init_state(BATCHES[0]), BATCHES[0])
    record = trainer.last_step_metrics["health"]
    assert sorted(record["activations"]) == ["embed", "final_norm"]
    (entropy,) = record["attention_entropy"].values()
    assert entropy.shape == (BLOCKS, HEADS)
    for i in range(BLOCKS):
        torch.testing.assert_close(entropy[i], plain["attention_entropy"][f"block_{i}"], rtol=0, atol=0)


def test_a_checkpoint_of_one_layout_refuses_the_other(tmp_path):
    loop = Trainer(make_model("sasrec"), CE(), device="cpu")
    scan = Trainer(make_model("sasrec", scan_blocks=True), CE(), device="cpu")
    for saver, loader, name in ((scan, loop, "scan"), (loop, scan, "loop")):
        state = saver.init_state(BATCHES[0])
        saver.save_checkpoint(str(tmp_path / name), state)
        # the flat buffers have one size: only the layout mark can tell
        assert loader.init_state(BATCHES[0]).flat_params.shape == state.flat_params.shape
        with pytest.raises(ValueError, match="checkpoints do not mix across scan_blocks"):
            loader.restore_checkpoint(str(tmp_path / name), BATCHES[0])
        restored = saver.restore_checkpoint(str(tmp_path / name), BATCHES[0])
        assert torch.equal(restored.flat_params, state.flat_params)
    manager = CheckpointManager(str(tmp_path / "fit"))
    scan.fit(BATCHES, epochs=1, checkpoint_manager=manager, log_every=0)
    assert manager.metadata(manager.latest_step())["scan_blocks"] is True
    with pytest.raises(ValueError, match="checkpoints do not mix across scan_blocks"):
        loop.fit(BATCHES, epochs=2, checkpoint_manager=manager, resume=True, log_every=0)


def test_flops_count_the_recompute():
    """``obs/mfu.py``'s count of a step, as JAX's compiled cost counts it:
    full remat adds one forward of every block; ``"dots"`` adds the
    recomputed non-products, here K4's forward formula for each block."""
    def step_flops(model):
        def run():
            hidden = model(**forward_kwargs("sasrec", BATCHES[0]))
            return torch.autograd.grad(torch.sum(hidden**2), list(model.parameters()))

        return mfu.program_costs(run)["flops"]

    plain = make_model("sasrec", route=True)
    flops = {"plain": step_flops(plain)}
    for name, kwargs in (("full", dict(remat=True)), ("dots", dict(remat=True, remat_policy=checkpoint_dots))):
        model = make_model("sasrec", route=True, **kwargs)
        model.load_state_dict(plain.state_dict())
        flops[name] = step_flops(model)
    x = torch.zeros(BATCH, SEQ_LEN, DIM)
    mask = torch.zeros(BATCH, 1, SEQ_LEN, SEQ_LEN)
    with torch.no_grad():
        blocks = mfu.program_costs(
            lambda: plain.body.encoder(x, mask, torch.ones(BATCH, SEQ_LEN, dtype=torch.bool))
        )["flops"]
    k4 = mfu.attention_flops((BATCH, HEADS, SEQ_LEN, DIM // HEADS), (BATCH, HEADS, SEQ_LEN, DIM // HEADS))
    assert flops["full"] - flops["plain"] == blocks
    assert flops["dots"] - flops["plain"] == BLOCKS * k4
