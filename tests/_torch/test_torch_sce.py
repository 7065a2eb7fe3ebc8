"""The port's SCE (Scalable Cross-Entropy) against the JAX loss, and its trainer binding.

SCE draws a random projection; ``jax.random.normal`` has no torch
counterpart, so the JAX loss draws it from a key and the test passes the
same draw to the port (``scalable_cross_entropy``, and ``SCE`` with the drawn
tensor as its ``rng``). Cases: ``mix_x`` both ways, f32 and bf16 hidden
states against an f32 table (the bf16 model's types), more padded positions
than ``bucket_size_x`` leaves room for, and every valid position in every
bucket (the scatter-max over buckets, its gradient to the winning bucket).
Values and gradients with respect to the hidden states and the table: f32
within rtol 1e-5 / atol 1e-6 (sums in another order); bf16 within rtol 2e-2
/ atol 2e-3 of the largest magnitude: the mining scores, the masked value and
the per-position losses are bf16 in both packages, half an ulp is 2**-9, and
XLA and torch round their bf16 products and sums at different points.
Padded positions tie at the dtype's minimum; which of them fill a bucket
changes nothing (the test swaps ``torch.topk``'s tie order for the reverse
one): ``torch.topk`` serves.

On the trainer: the projection draws from the dropout stream
(``TrainState.rng``): a seed repeats its losses, ``train_steps`` equals K
``train_step`` calls bitwise, and the health record streams its logits
stats for SCE and GBCE on SASRec and BERT4Rec and records ``skipped`` on
TwoTower, which has no bias-free tying head.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from replay_tpu.nn.loss import SCE as JaxSCE
from replay_tpu.nn.loss import ScalableCrossEntropyLoss as JaxScalableCrossEntropyLoss
from replay_tpu.nn.loss import SCEParams as JaxSCEParams
from replay_tpu_torch.data import FeatureHint, FeatureType
from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu_torch.nn.loss import GBCE, SCE, SCEParams
from replay_tpu_torch.nn.loss import sce as sce_module
from replay_tpu_torch.nn.sequential import Bert4Rec, TwoTower
from replay_tpu_torch.nn.sequential.sasrec import SasRec
from replay_tpu_torch.nn.train import OptimizerFactory, Trainer
from replay_tpu_torch.obs.health import HealthConfig

BATCH, SEQ_LEN, DIM, NUM_ITEMS = 2, 6, 8, 30
# 4 buckets of 8 positions and 5 items; 5 of the 12 positions are valid, so
# each bucket takes every valid position and 3 padded ones
PARAMS = dict(n_buckets=4, bucket_size_x=8, bucket_size_y=5)
TOL = {"float32": (1e-5, 1e-6), "bfloat16": (2e-2, 2e-3)}


def inputs(seed):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((BATCH, SEQ_LEN, DIM)).astype(np.float32)
    table = (rng.standard_normal((NUM_ITEMS, DIM)) * 0.5).astype(np.float32)
    labels = rng.integers(0, NUM_ITEMS, (BATCH, SEQ_LEN)).astype(np.int32)
    padding = np.zeros((BATCH, SEQ_LEN), bool)
    padding[0, 3:] = True
    padding[1, 4:] = True
    labels[~padding] = NUM_ITEMS  # the padding id: out of range, as a batcher pads
    tokens = padding.copy()
    tokens[0, 3] = False  # one valid position whose target is masked
    return hidden, table, labels, padding, tokens


def run_jax(params, hidden, table, labels, padding, tokens, dtype, key):
    loss = JaxScalableCrossEntropyLoss(params)

    def value(h, w):
        return loss(h.astype(dtype), jnp.asarray(labels), w, jnp.asarray(padding), key, tokens_mask=jnp.asarray(tokens))

    out, grads = jax.jit(jax.value_and_grad(value, argnums=(0, 1)))(jnp.asarray(hidden), jnp.asarray(table))
    return float(out), [np.asarray(g, np.float32) for g in grads]


def run_port(params, hidden, table, labels, padding, tokens, dtype, projection):
    hidden_t = torch.tensor(hidden, requires_grad=True)
    table_t = torch.tensor(table, requires_grad=True)
    out = sce_module.scalable_cross_entropy(
        hidden_t.to(dtype), torch.tensor(labels), table_t, torch.tensor(padding), projection, params,
        tokens_mask=torch.tensor(tokens),
    )
    out.backward()
    return float(out.detach()), [hidden_t.grad.numpy(), table_t.grad.numpy()]


def jax_projection(params, dtype, key):
    shape = sce_module.projection_shape(params, BATCH * SEQ_LEN, DIM)
    return torch.tensor(np.asarray(jax.random.normal(key, shape, dtype=dtype), np.float32))


@pytest.mark.parametrize("mix_x", [False, True], ids=["buckets", "mix_x"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sce_matches_jax_on_the_same_projection(mix_x, dtype):
    hidden, table, labels, padding, tokens = inputs(0)
    key = jax.random.PRNGKey(3)
    jax_dtype = getattr(jnp, dtype)
    want = run_jax(JaxSCEParams(mix_x=mix_x, **PARAMS), hidden, table, labels, padding, tokens, jax_dtype, key)
    params = SCEParams(mix_x=mix_x, **PARAMS)
    projection = jax_projection(params, jax_dtype, key)
    got = run_port(params, hidden, table, labels, padding, tokens, getattr(torch, dtype), projection)
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got[0], want[0], rtol=rtol, atol=atol)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol * max(1.0, np.abs(w).max()))
    assert np.isfinite(got[0]) and np.abs(got[1][0]).sum() > 0 and np.abs(got[1][1]).sum() > 0
    # padded positions carry no gradient; every valid one lands in every bucket
    assert np.abs(got[1][0][~padding]).max() == 0


def test_sce_tie_order_among_padded_positions_changes_nothing(monkeypatch):
    """7 padded positions tie at finfo.min for 3 slots a bucket: the reverse
    tie order (the highest index first) gives the same loss and gradients."""
    hidden, table, labels, padding, tokens = inputs(1)
    params = SCEParams(**PARAMS)
    projection = torch.tensor(np.random.default_rng(5).standard_normal((4, DIM)).astype(np.float32))
    first = run_port(params, hidden, table, labels, padding, tokens, torch.float32, projection)

    topk = torch.topk

    def reverse_ties(scores, k, dim):
        flipped = topk(scores.flip(dim), k, dim=dim)
        return torch.return_types.topk((flipped.values, scores.shape[dim] - 1 - flipped.indices))

    monkeypatch.setattr(sce_module.torch, "topk", reverse_ties)
    second = run_port(params, hidden, table, labels, padding, tokens, torch.float32, projection)
    monkeypatch.undo()
    assert first[0] == second[0]
    for a, b in zip(first[1], second[1]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_sce_adapter_draws_binds_and_refuses_as_jax():
    hidden, table, labels, padding, tokens = inputs(2)
    params = SCEParams(**PARAMS)
    key = jax.random.PRNGKey(0)
    projection = jax_projection(params, jnp.float32, key)
    loss = SCE(params)
    assert (loss.needs_item_embeddings, loss.needs_rng, loss.avoid_full_logits) == (True, True, True)
    args = (
        torch.tensor(hidden), {}, torch.tensor(labels)[..., None], None, torch.tensor(padding),
        torch.tensor(tokens)[..., None],
    )
    jax_loss = JaxSCE(JaxSCEParams(**PARAMS))
    jax_args = tuple(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                     for a in (hidden, {}, labels[..., None], None, padding, tokens[..., None]))
    for package_loss, package_args in ((loss, args), (jax_loss, jax_args)):
        with pytest.raises(AttributeError) as missing:
            package_loss(*package_args)
        assert str(missing.value) == "SCE requires the trainer to bind item_embeddings_callback and rng."
    table_t = torch.tensor(table)
    loss.item_embeddings_callback = lambda: table_t
    loss.rng = projection
    direct = sce_module.scalable_cross_entropy(
        args[0], args[2][..., 0], table_t, args[4], projection, params, tokens_mask=args[5][..., 0]
    )
    assert torch.equal(loss(*args), direct)
    jax_loss.item_embeddings_callback = lambda: jnp.asarray(table)
    jax_loss.rng = key
    np.testing.assert_allclose(float(direct), float(jax.jit(lambda: jax_loss(*jax_args))()), rtol=1e-5, atol=1e-6)
    two = torch.cat([args[2], args[2]], dim=-1)
    with pytest.raises(NotImplementedError, match="Multi-positive labels are not supported by the SCE loss"):
        loss(args[0], {}, two, None, args[4], args[5])
    # a generator draws [n_buckets, E] in the hidden states' dtype
    loss.rng = torch.Generator().manual_seed(0)
    assert torch.isfinite(loss(*args))
    with pytest.raises(ValueError, match="must all be set"):
        SCE(SCEParams(n_buckets=None, bucket_size_x=2, bucket_size_y=2))


# --------------------------------------------------------------------------- #
# the trainer
# --------------------------------------------------------------------------- #
def schema():
    return TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
            cardinality=NUM_ITEMS, embedding_dim=DIM,
        )
    )


def batches(count, seed=0, negatives=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        items = rng.integers(0, NUM_ITEMS, (4, SEQ_LEN + 1)).astype(np.int32)
        mask = np.ones((4, SEQ_LEN), bool)
        batch = {
            "feature_tensors": {"item_id": items[:, :-1]}, "padding_mask": mask,
            "positive_labels": items[:, 1:, None], "target_padding_mask": mask[:, :, None],
            "token_mask": rng.random((4, SEQ_LEN)) > 0.3,
        }
        if negatives:
            batch["negative_labels"] = rng.integers(0, NUM_ITEMS, negatives).astype(np.int32)
        out.append(batch)
    return out


def sce_trainer(seed=0):
    model = SasRec(schema(), embedding_dim=DIM, num_blocks=1, max_sequence_length=SEQ_LEN, device="cpu")
    return Trainer(model, SCE(SCEParams(n_buckets=4, bucket_size_x=6, bucket_size_y=5)), seed=seed,
                   optimizer=OptimizerFactory(learning_rate=1e-2), device="cpu")


def test_sce_trainer_draws_from_the_state_stream():
    data = batches(4)

    def losses(seed):
        trainer = sce_trainer(seed)
        state = trainer.init_state(data[0])
        return [float(trainer.train_step(state, b)[1]) for b in data], state

    (first, state_a), (again, state_b), (other, _) = losses(0), losses(0), losses(1)
    assert first == again and first != other
    assert torch.equal(state_a.flat_params, state_b.flat_params) and torch.equal(state_a.rng, state_b.rng)
    # K steps a dispatch: the same draws, the same bits
    trainer = sce_trainer(0)
    state = trainer.init_state(data[0])
    state, chunk = trainer.train_steps(state, data)
    assert chunk.tolist() == first
    assert torch.equal(state.flat_params, state_a.flat_params) and torch.equal(state.rng, state_a.rng)


@pytest.mark.parametrize(
    "kind,loss", [("sasrec", "sce"), ("sasrec", "gbce"), ("bert4rec", "sce"), ("bert4rec", "gbce"), ("twotower", "gbce")]
)
def test_health_streams_logits_stats_for_losses_without_full_logits(kind, loss):
    if kind == "sasrec":
        model = SasRec(schema(), embedding_dim=DIM, num_blocks=1, max_sequence_length=SEQ_LEN, device="cpu")
    elif kind == "bert4rec":
        model = Bert4Rec(schema(), embedding_dim=DIM, num_blocks=1, num_heads=2, max_sequence_length=SEQ_LEN, device="cpu")
    else:
        model = TwoTower(schema(), embedding_dim=DIM, num_blocks=1, num_heads=2, max_sequence_length=SEQ_LEN, device="cpu")
    made = SCE(SCEParams(n_buckets=4, bucket_size_x=6, bucket_size_y=5)) if loss == "sce" else GBCE(
        catalog_size=NUM_ITEMS, t=0.75
    )
    trainer = Trainer(model, made, health=HealthConfig(cadence=1), device="cpu")
    data = batches(1, negatives=7)[0]
    state = trainer.init_state(data)
    trainer.train_step(state, data)
    stats = trainer.last_step_metrics["health"]["logits"]
    if kind == "twotower":
        assert set(stats) == {"skipped"} and float(stats["skipped"]) == 1.0
        return
    assert set(stats) == {"mean", "absmax", "std"}
    assert all(np.isfinite(float(v)) for v in stats.values())
