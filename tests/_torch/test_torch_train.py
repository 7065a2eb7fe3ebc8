"""The port's training path against the JAX package's, on the CPU.

* Optimizers: each ``OptimizerFactory`` name and ``LRSchedulerFactory`` kind
  against the optax transformation the JAX factory builds, on a fixed
  quadratic problem: parameter trajectories within rtol 1e-5 / atol 1e-7 (f32
  elementwise arithmetic in another order; ``pow`` and ``cos`` may differ by an
  ulp).
* Training steps: the JAX ``Trainer`` and the port's ``Trainer`` take 4
  ``train_step``s from the same converted weights, for each of {CE, CEFused} ×
  {use_flash False, True}; on the JAX side the Pallas kernels run in interpret
  mode, on the port's the kernels' plain versions. Step losses within rtol 1e-4
  (the JAX package's own CEFused-vs-CE tolerance); parameters after the steps
  within atol 1e-5: Adam divides each gradient by its own running RMS, so f32
  noise of ~1e-7 in a gradient moves a parameter by up to ~lr·1e-2.
* The sentinel, ``fit`` history, ``MetricsBuilder``, ``validate``,
  ``predict_top_k`` and ``SeenItemsFilter`` against their JAX counterparts.
  Ranked ids of the model's own logits are compared where neighbouring
  scores are clear of ties: the two packages' logits differ by f32 rounding,
  which can reorder near-equal scores.
* Exact ties: on the same tied logits (``SeenItemsFilter``'s fill, logits
  rounded to 0.1), ``validate`` and ``predict_top_k`` give exactly
  ``jax.lax.top_k``'s ids (the lower index first among equal scores).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from replay_tpu.data import FeatureHint, FeatureType
from replay_tpu.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu.metrics.builder import MetricsBuilder as JaxMetricsBuilder
from replay_tpu.nn import LRSchedulerFactory as JaxLRSchedulerFactory
from replay_tpu.nn import OptimizerFactory as JaxOptimizerFactory
from replay_tpu.nn import Trainer as JaxTrainer
from replay_tpu.nn.loss import CE as JaxCE
from replay_tpu.nn.loss import CEFused as JaxCEFused
from replay_tpu.nn.postprocess import SeenItemsFilter as JaxSeenItemsFilter
from replay_tpu.nn.sequential.sasrec import SasRec as JaxSasRec
from replay_tpu_torch.convert import flax_to_torch, torch_to_flax
from replay_tpu_torch.data import FeatureHint as PortFeatureHint
from replay_tpu_torch.data import FeatureType as PortFeatureType
from replay_tpu_torch.data.nn import TensorFeatureInfo as PortTensorFeatureInfo
from replay_tpu_torch.data.nn import TensorSchema as PortTensorSchema
from replay_tpu_torch.metrics import MetricsBuilder
from replay_tpu_torch.nn.loss import CE, CEFused
from replay_tpu_torch.nn.postprocess import SeenItemsFilter
from replay_tpu_torch.nn.sequential.sasrec import SasRec
from replay_tpu_torch.nn.train import LRSchedulerFactory, OptimizerFactory, RecoveryPolicy, Trainer
from replay_tpu_torch.utils.checkpoint import CheckpointManager

NUM_ITEMS, DIM, BLOCKS, HEADS, SEQ_LEN, BATCH = 50, 16, 1, 2, 8, 4
STEPS = 4
# scores closer than this are a tie for the rank comparisons; where the two
# packages' scores agree within TIE_GAP / 2, no rank beyond a tie can swap
TIE_GAP = 1e-5


# --------------------------------------------------------------------------- #
# optimizers
# --------------------------------------------------------------------------- #
OPTIMIZERS = {
    "adam": dict(name="adam", learning_rate=0.05),
    "adam_l2": dict(name="adam", learning_rate=0.05, weight_decay=0.1),
    "adamw": dict(name="adamw", learning_rate=0.05, weight_decay=0.1, betas=(0.8, 0.99)),
    "sgd": dict(name="sgd", learning_rate=0.02),
    "sgd_momentum_l2": dict(name="sgd", learning_rate=0.02, momentum=0.9, weight_decay=0.05),
    "adam_clipped": dict(name="adam", learning_rate=0.05, clip_grad_norm=0.5),
    "sgd_clipped": dict(name="sgd", learning_rate=0.02, clip_grad_norm=0.5),
    "constant": dict(name="adam", learning_rate=0.05, scheduler=dict(kind="constant")),
    "step": dict(name="sgd", learning_rate=0.02, scheduler=dict(kind="step", step_size=3, gamma=0.5)),
    "warmup_linear": dict(name="adam", learning_rate=0.05, scheduler=dict(kind="warmup_linear", warmup_steps=4)),
    "warmup_cosine": dict(
        name="sgd", learning_rate=0.02, scheduler=dict(kind="warmup_cosine", warmup_steps=3, total_steps=9)
    ),
}


def _quadratic(seed=0):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((9, 7)).astype(np.float32)
    b = rng.standard_normal(9).astype(np.float32)
    p0 = rng.standard_normal(7).astype(np.float32)
    return a, b, p0


@pytest.mark.parametrize("case", sorted(OPTIMIZERS))
def test_optimizer_trajectory_matches_optax(case):
    config = dict(OPTIMIZERS[case])
    scheduler = config.pop("scheduler", None)
    jax_factory = JaxOptimizerFactory(
        **config, scheduler=JaxLRSchedulerFactory(**scheduler) if scheduler else None
    )
    port_factory = OptimizerFactory(**config, scheduler=LRSchedulerFactory(**scheduler) if scheduler else None)
    a, b, p0 = _quadratic()

    tx = jax_factory.create()
    params = jnp.asarray(p0)
    opt_state = tx.init(params)
    port_tx = port_factory.create()
    flat = torch.tensor(p0)
    port_state = port_tx.init(flat)
    first_norm = None
    for _ in range(12):
        grad = a.T @ (a @ np.asarray(params) - b)  # of 0.5·|A p − b|², from JAX's params
        port_grad = torch.tensor(a).T @ (torch.tensor(a) @ flat - torch.tensor(b))
        first_norm = first_norm or float(np.linalg.norm(grad))
        updates, opt_state = tx.update(jnp.asarray(grad), opt_state, params)
        params = params + updates
        port_updates, port_state = port_tx.update(port_grad, port_state, flat)
        flat = flat + port_updates
        np.testing.assert_allclose(flat.numpy(), np.asarray(params), rtol=1e-5, atol=1e-7)
    if "clipped" in case:
        assert first_norm > 0.5  # the clip was hit


# --------------------------------------------------------------------------- #
# training steps against the JAX trainer
# --------------------------------------------------------------------------- #
def jax_schema():
    return TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True,
            feature_hint=FeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )


def port_schema():
    return PortTensorSchema(
        PortTensorFeatureInfo(
            "item_id", PortFeatureType.CATEGORICAL, is_seq=True,
            feature_hint=PortFeatureHint.ITEM_ID, cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )


WIDTH = dict(embedding_dim=DIM, num_blocks=BLOCKS, num_heads=HEADS, max_sequence_length=SEQ_LEN)


def train_batch(seed, valid=(True,) * BATCH):
    """Left-padded windows (padding id = cardinality) with next-item labels."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(2, SEQ_LEN + 1, BATCH)
    lengths[0] = SEQ_LEN
    mask = np.arange(SEQ_LEN)[None, :] >= SEQ_LEN - lengths[:, None]
    items = rng.integers(0, NUM_ITEMS, (BATCH, SEQ_LEN + 1)).astype(np.int32)
    ids = np.where(mask, items[:, :-1], NUM_ITEMS).astype(np.int32)
    batch = {
        "feature_tensors": {"item_id": ids},
        "padding_mask": mask,
        "positive_labels": items[:, 1:, None],
        "target_padding_mask": mask[:, :, None],
    }
    # every batch carries `valid`: one key structure, one JAX program
    return {**batch, "valid": np.asarray(valid)}


BATCHES = [train_batch(1), train_batch(2, valid=(True, True, True, False)), train_batch(3), train_batch(4)]


def val_batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, NUM_ITEMS, (BATCH, SEQ_LEN)).astype(np.int32)
    ids[1, :3] = NUM_ITEMS  # left padding
    truth = np.full((BATCH, 3), -1, np.int32)
    truth[:, 0] = rng.integers(0, NUM_ITEMS, BATCH)
    truth[0, 1:] = rng.integers(0, NUM_ITEMS, 2)
    return {
        "feature_tensors": {"item_id": ids},
        "padding_mask": ids != NUM_ITEMS,
        "ground_truth": truth,
        "train": np.where(ids == NUM_ITEMS, -1, ids),
        "valid": np.array([True, True, True, False]),
        "query_id": np.arange(BATCH) + 100 * seed,
    }


VAL_BATCHES = [val_batch(7), val_batch(8)]


@pytest.fixture(scope="module")
def initial_params():
    """Initial params as a flax tree (numpy leaves), shared by every run: drawn
    by the port's SasRec from a seed (a JAX init would compile one more program)."""
    model = SasRec(port_schema(), device="cpu", generator=torch.Generator().manual_seed(0), **WIDTH)
    return torch_to_flax(model.state_dict())


def jax_trainer(loss_name, use_flash):
    loss = JaxCEFused(tile=8) if loss_name == "CEFused" else JaxCE()
    return JaxTrainer(model=JaxSasRec(schema=jax_schema(), use_flash=use_flash, **WIDTH), loss=loss)


def port_trainer(loss_name, use_flash, **kwargs):
    loss = CEFused() if loss_name == "CEFused" else CE()
    model = SasRec(port_schema(), use_flash=use_flash, device="cpu", **WIDTH)
    return Trainer(model, loss, device="cpu", **kwargs)


class JaxRuns:
    """One JAX trainer per configuration, compiled once and shared by the tests."""

    def __init__(self, params):
        self.params = params
        self.trainers = {}
        self.runs = {}

    def trainer(self, config):
        if config not in self.trainers:
            self.trainers[config] = jax_trainer(*config)
        return self.trainers[config]

    def steps(self, config):
        if config not in self.runs:
            trainer = self.trainer(config)
            state = trainer.init_state(BATCHES[0], params=self.params)
            losses = []
            for batch in BATCHES[:STEPS]:
                state, loss = trainer.train_step(state, batch)
                losses.append(float(loss))
            self.runs[config] = (losses, jax.tree.map(np.asarray, state.params))
        return self.runs[config]


@pytest.fixture(scope="module")
def jax_runs(initial_params):
    return JaxRuns(initial_params)


CONFIGS = [(loss, flash) for loss in ("CE", "CEFused") for flash in (False, True)]


@pytest.mark.parametrize("config", CONFIGS, ids=[f"{loss}-flash={flash}" for loss, flash in CONFIGS])
def test_train_steps_match_the_jax_trainer(config, jax_runs, initial_params):
    want_losses, want_params = jax_runs.steps(config)
    trainer = port_trainer(*config)
    state = trainer.init_state(BATCHES[0], params=flax_to_torch(initial_params))
    losses = []
    for batch in BATCHES[:STEPS]:
        state, loss = trainer.train_step(state, batch)
        losses.append(float(loss))
        assert bool(trainer.last_step_metrics["good"])
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    assert losses[-1] < losses[0]
    assert state.step == STEPS and int(state.bad_steps) == 0
    got = torch_to_flax(trainer.model.state_dict())
    for path, want in jax.tree_util.tree_leaves_with_path(want_params):
        node, start = got, initial_params
        for key in path:
            node, start = node[key.key], start[key.key]
        name = jax.tree_util.keystr(path)
        if "['key']['bias']" in name:
            # a bias on the keys adds one constant to a query's every score: its
            # gradient is zero up to rounding noise, which Adam scales to ±lr
            # per step on either side, so it can only stay within STEPS·lr
            assert np.abs(node - start).max() <= STEPS * 1e-3 * 1.01, name
            continue
        np.testing.assert_allclose(node, want, atol=1e-5, err_msg=name)


def test_sentinel_skips_a_non_finite_step(jax_runs, initial_params):
    """A NaN target weight makes the loss and every gradient NaN: params and
    optimizer state stay, step advances, bad_steps counts one — as in JAX."""
    poisoned = {k: v for k, v in BATCHES[1].items() if k != "valid"}
    poisoned["target_padding_mask"] = np.full((BATCH, SEQ_LEN, 1), np.nan, np.float32)
    jax_trainer_ = jax_runs.trainer(("CE", False))
    jax_state = jax_trainer_.init_state(BATCHES[0], params=initial_params)
    jax_state, _ = jax_trainer_.train_step(jax_state, BATCHES[0])
    jax_state, jax_loss = jax_trainer_.train_step(jax_state, poisoned)
    assert not np.isfinite(float(jax_loss)) and int(jax_state.bad_steps) == 1

    trainer = port_trainer("CE", False)
    state = trainer.init_state(BATCHES[0], params=flax_to_torch(initial_params))
    state, _ = trainer.train_step(state, BATCHES[0])
    params_before = state.flat_params.clone()
    opt_before = [{k: v.clone() for k, v in link.items()} for link in state.opt_state]
    state, loss = trainer.train_step(state, poisoned)
    assert not torch.isfinite(loss)
    assert not bool(trainer.last_step_metrics["good"])
    assert state.step == int(jax_state.step) == 2
    assert int(state.bad_steps) == 1
    assert torch.equal(state.flat_params, params_before)
    for link, before in zip(state.opt_state, opt_before):
        for key in link:
            assert torch.equal(link[key], before[key]), key
    # and the next good step trains again from the kept state
    state, loss = trainer.train_step(state, BATCHES[2])
    assert torch.isfinite(loss) and int(state.bad_steps) == 1


def _tie_free(logits, k):
    """True where each row's top-k+1 scores are more than TIE_GAP apart."""
    top = np.sort(np.asarray(logits), axis=-1)[:, ::-1][:, : k + 1]
    return np.all(-np.diff(top, axis=-1) > TIE_GAP)


def test_fit_history_matches_jax(jax_runs, initial_params):
    """Two epochs over a re-iterable stream with a validation stream."""
    jax_trainer_ = jax_runs.trainer(("CE", False))
    jax_trainer_.history = []
    jax_state = jax_trainer_.fit(
        BATCHES, epochs=2, state=jax_trainer_.init_state(BATCHES[0], params=initial_params),
        val_batches=lambda: VAL_BATCHES, log_every=0,
    )
    trainer = port_trainer("CE", False)
    state = trainer.fit(
        BATCHES, epochs=2, state=trainer.init_state(BATCHES[0], params=flax_to_torch(initial_params)),
        val_batches=lambda: VAL_BATCHES, log_every=0,
    )
    for batch in VAL_BATCHES:  # the metrics are only comparable away from ties
        want_logits = np.asarray(jax_trainer_.predict_logits(jax_state, batch))
        assert _tie_free(want_logits, 10)
        np.testing.assert_allclose(trainer.predict_logits(state, batch).numpy(), want_logits, rtol=0, atol=TIE_GAP / 2)
    assert [r.keys() for r in trainer.history] == [r.keys() for r in jax_trainer_.history]
    for got, want in zip(trainer.history, jax_trainer_.history):
        assert got["epoch"] == want["epoch"]
        np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=1e-4)
        for key in want:
            if "@" in key:
                np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
    assert state.step == int(jax_state.step) == 2 * len(BATCHES)


def test_fit_takes_a_callable_and_a_one_shot_stream():
    trainer = port_trainer("CE", False)
    seen = []

    def per_epoch(epoch):
        seen.append(epoch)
        return BATCHES[:2]

    state = trainer.fit(per_epoch, epochs=2, log_every=0)
    assert seen == [0, 1] and state.step == 4
    state = trainer.fit(iter(BATCHES[:2]), epochs=3, state=state, log_every=0)
    assert state.step == 10 and len(trainer.history) == 5
    assert all(np.isfinite(r["train_loss"]) for r in trainer.history)


@pytest.mark.parametrize(
    "name,value",
    [("checkpoint_manager", object()), ("scan_chunk", 2), ("monitor", "ndcg@10"), ("recovery", object()), ("loggers", [])],
)
def test_unported_fit_arguments_raise(name, value, tmp_path):
    """The lifecycle arguments are ported: each runs (a monitor missing
    from the epoch record raises ``KeyError``, as in the JAX fit), alone and
    beside ``tracer=True``, which raised until every fit argument was ported."""
    trainer = port_trainer("CE", False)
    usable = {"checkpoint_manager": CheckpointManager(str(tmp_path)), "recovery": RecoveryPolicy()}.get(name, value)
    if name == "monitor":
        for extra in ({}, {"tracer": True}):
            with pytest.raises(KeyError, match="not in the epoch record"):
                trainer.fit(BATCHES[:1], monitor=value, log_every=0, **extra)
    else:
        trainer.fit(BATCHES[:1], log_every=0, tracer=True, **{name: usable})
        trainer.fit(BATCHES[:1], log_every=0, **{name: usable})
        assert trainer.tracer is None
    # the JAX defaults are accepted and change nothing
    trainer.fit(BATCHES[:1], scan_chunk=None, prefetch=0, mode="max", resume=False, log_every=0)
    with pytest.raises(TypeError, match="unexpected keyword"):
        trainer.fit(BATCHES[:1], no_such_argument=1)


def test_cefused_needs_a_tying_head():
    trainer = port_trainer("CEFused", False)
    type(trainer.model).logits_via_item_weights = False
    try:
        with pytest.raises(ValueError, match="logits_via_item_weights"):
            trainer.train_step(trainer.init_state(BATCHES[0]), BATCHES[0])
    finally:
        type(trainer.model).logits_via_item_weights = True


# --------------------------------------------------------------------------- #
# metrics, postprocessing, prediction
# --------------------------------------------------------------------------- #
def test_metrics_builder_sums_match_jax():
    rng = np.random.default_rng(20)
    metrics = ("coverage", "hitrate", "map", "mrr", "ndcg", "novelty", "precision", "recall")
    kwargs = dict(metrics=metrics, top_k=(1, 3, 5), item_count=30)
    port, jax_builder = MetricsBuilder(**kwargs), JaxMetricsBuilder(**kwargs)
    for _ in range(3):
        predictions = np.stack([rng.permutation(30)[:6] for _ in range(8)]).astype(np.int32)
        truth = np.where(rng.random((8, 4)) < 0.6, rng.integers(0, 30, (8, 4)), -1).astype(np.int32)
        truth[:, 0] = predictions[:, rng.integers(0, 6)]  # guarantee some hits
        truth[2] = -1  # a user with no ground truth
        train = np.where(rng.random((8, 5)) < 0.7, rng.integers(0, 30, (8, 5)), -1).astype(np.int32)
        valid = rng.random(8) < 0.8
        port.add_prediction(torch.tensor(predictions), truth, train, valid)
        jax_builder.add_prediction(predictions, truth, train, valid)
    got, want = port.state(), jax_builder.state()
    assert got["sums"].keys() == want["sums"].keys()
    for name in want["sums"]:
        # the same per-user values; the batch sums may differ in their last bit
        # (XLA and torch add the rows in different orders)
        np.testing.assert_allclose(got["sums"][name].numpy(), np.asarray(want["sums"][name]), rtol=2.4e-7, err_msg=name)
    assert int(got["count"]) == int(want["count"])
    for name in want["coverage"]:
        np.testing.assert_array_equal(got["coverage"][name].numpy(), np.asarray(want["coverage"][name]))
    assert port.get_metrics() == pytest.approx(jax_builder.get_metrics(), rel=2.4e-7, abs=0)


@pytest.mark.parametrize("candidates", [None, "shared", "per_row"])
def test_seen_items_filter_matches_jax(candidates):
    rng = np.random.default_rng(21)
    seen = rng.integers(-1, NUM_ITEMS + 2, (BATCH, 6)).astype(np.int32)  # -1 and past-the-end ids too
    batch = {"feature_tensors": {"item_id": seen}}
    width = NUM_ITEMS
    if candidates == "shared":
        batch["candidates_to_score"] = np.sort(rng.choice(NUM_ITEMS, 12, replace=False)).astype(np.int32)
        width = 12
    elif candidates == "per_row":
        batch["candidates_to_score"] = np.stack(
            [np.concatenate([seen[b, :2].clip(0, NUM_ITEMS - 1), rng.choice(NUM_ITEMS, 10)]) for b in range(BATCH)]
        ).astype(np.int32)
        width = 12
    logits = rng.standard_normal((BATCH, width)).astype(np.float32)
    want = JaxSeenItemsFilter()(jnp.asarray(logits), jax.tree.map(jnp.asarray, batch))
    got = SeenItemsFilter()(torch.tensor(logits), batch)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() == np.finfo(np.float32).min).any()


def test_validate_and_predict_top_k_match_jax(jax_runs, initial_params):
    """On the converted initial weights, with SeenItemsFilter on."""
    jax_trainer_ = jax_runs.trainer(("CE", False))
    jax_state = jax_trainer_.init_state(BATCHES[0], params=initial_params)
    trainer = port_trainer("CE", False)
    state = trainer.init_state(BATCHES[0], params=flax_to_torch(initial_params))
    post = dict(jax=[JaxSeenItemsFilter()], port=[SeenItemsFilter()])

    for batch in VAL_BATCHES:
        want_logits = np.asarray(jax_trainer_.predict_logits(jax_state, batch))
        got_logits = trainer.predict_logits(state, batch).numpy()
        np.testing.assert_allclose(got_logits, want_logits, rtol=0, atol=TIE_GAP / 2)
        filtered = np.asarray(post["jax"][0](jnp.asarray(want_logits), jax.tree.map(jnp.asarray, batch)))
        assert _tie_free(filtered, 10)

    want = jax_trainer_.validate(jax_state, VAL_BATCHES, top_k=(1, 5, 10), postprocessors=post["jax"])
    got = trainer.validate(state, VAL_BATCHES, top_k=(1, 5, 10), postprocessors=post["port"])
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)

    queries, items, scores = trainer.predict_top_k(state, VAL_BATCHES, 5, postprocessors=post["port"])
    want_q, want_items, want_scores = jax_trainer_.predict_top_k(jax_state, VAL_BATCHES, 5, postprocessors=post["jax"])
    np.testing.assert_array_equal(queries, want_q)
    np.testing.assert_array_equal(items, want_items)
    np.testing.assert_allclose(scores, want_scores, atol=1e-5, rtol=1e-5)
    assert items.shape == (2 * (BATCH - 1), 5)  # invalid rows dropped

    slate = np.array([3, 7, 11, 19, 23, 31, 40, 44], np.int32)
    slate_logits = np.asarray(jax_trainer_.predict_logits(jax_state, VAL_BATCHES[0], jnp.asarray(slate)))
    assert _tie_free(slate_logits, 3)
    _, items, scores = trainer.predict_top_k(state, VAL_BATCHES[:1], 3, post["port"], candidates=slate)
    _, want_items, want_scores = jax_trainer_.predict_top_k(jax_state, VAL_BATCHES[:1], 3, post["jax"], candidates=slate)
    np.testing.assert_array_equal(items, want_items)
    np.testing.assert_allclose(scores, want_scores, atol=1e-5, rtol=1e-5)


class FixedLogits:
    """A postprocessor that replaces the model's logits with fixed values
    (``convert`` makes them a torch tensor or a jax array): both packages then
    rank exactly the same numbers."""

    def __init__(self, values, convert):
        self.values, self.convert = values, convert

    def __call__(self, logits, batch):
        return self.convert(self.values[: logits.shape[0]])


def tied_logits(case, seed):
    """``[BATCH, NUM_ITEMS]`` f32 logits full of exact ties, and the batch
    key the seen-items filter reads (all items but 4 of each row seen)."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((BATCH, NUM_ITEMS)).astype(np.float32)
    if case == "rounded":
        logits = np.round(logits * 10) / 10
    seen = np.stack([rng.permutation(NUM_ITEMS)[: NUM_ITEMS - 4] for _ in range(BATCH)]).astype(np.int32)
    return logits, seen


@pytest.mark.parametrize("case", ["seen_fill", "rounded"])
def test_validate_and_predict_top_k_keep_jax_tie_order(case, jax_runs, initial_params):
    """Exactly tied logits through both trainers' validate and predict_top_k:
    the port's ids are jax.lax.top_k's, ids compared exactly (no tolerance),
    metrics within rtol 1e-6 (the same hits summed in another order)."""
    jax_trainer_ = jax_runs.trainer(("CE", False))
    jax_state = jax_trainer_.init_state(BATCHES[0], params=initial_params)
    trainer = port_trainer("CE", False)
    state = trainer.init_state(BATCHES[0], params=flax_to_torch(initial_params))
    batches, posts = [], {"jax": [], "port": []}
    for seed in (30, 31):
        logits, seen = tied_logits(case, seed)
        batch = dict(val_batch(seed), seen=seen)
        # ground truth among the tied items, where the tie order decides a hit
        order = np.asarray(jax.lax.top_k(jnp.asarray(logits), 10)[1])
        batch["ground_truth"] = np.stack([order[:, 7], order[:, 9], np.full(BATCH, -1)], 1).astype(np.int32)
        batches.append(batch)
        posts["jax"].append(FixedLogits(logits, jnp.asarray))
        posts["port"].append(FixedLogits(logits, torch.as_tensor))
    filters = dict(jax=[JaxSeenItemsFilter("seen")], port=[SeenItemsFilter("seen")]) if case == "seen_fill" else dict(jax=[], port=[])
    for index, batch in enumerate(batches):
        post = {side: [posts[side][index], *filters[side]] for side in posts}
        tied = np.asarray(post["jax"][-1](jnp.asarray(posts["jax"][index].values), jax.tree.map(jnp.asarray, batch)))
        top = np.sort(tied, axis=-1)[:, ::-1][:, :11]
        assert (np.diff(top, axis=-1) == 0).any(axis=-1).all()  # every row ties inside its top 10
        want_q, want_items, want_scores = jax_trainer_.predict_top_k(jax_state, [batch], 10, postprocessors=post["jax"])
        queries, items, scores = trainer.predict_top_k(state, [batch], 10, postprocessors=post["port"])
        np.testing.assert_array_equal(queries, want_q)
        np.testing.assert_array_equal(items, want_items)
        np.testing.assert_array_equal(scores, want_scores)
        want = jax_trainer_.validate(jax_state, [batch], top_k=(1, 5, 10), postprocessors=post["jax"])
        got = trainer.validate(state, [batch], top_k=(1, 5, 10), postprocessors=post["port"])
        assert got.keys() == want.keys() and want["recall@10"] > 0
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-6, err_msg=key)
