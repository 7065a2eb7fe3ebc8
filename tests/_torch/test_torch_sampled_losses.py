"""The port's sampled and weighted cross-entropy losses against the JAX ones.

``CESampled`` in each negative shape (a shared ``[N]`` pool, ``[B, N]`` per
row, ``[B, L, N]`` per position), with ignored negative ids and two positives
per position; ``CESampledWeighted`` and ``CEWeighted``. Both packages score
through a tying head over one table (``hidden · table[ids]``); the values and
the gradients with respect to the hidden states and the table are held to
rtol 1e-5 / atol 1e-6 (f32, summation orders differ between XLA and torch).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from replay_tpu.nn.loss import CESampled as JaxCESampled
from replay_tpu.nn.loss import CESampledWeighted as JaxCESampledWeighted
from replay_tpu.nn.loss import CEWeighted as JaxCEWeighted
from replay_tpu_torch.nn.loss import CESampled, CESampledWeighted, CEWeighted

NUM_ITEMS, DIM, BATCH, SEQ_LEN, NEGATIVES = 50, 8, 3, 5, 6
IGNORE = -100
RTOL, ATOL = 1e-5, 1e-6


def inputs(seed, positives=1):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((BATCH, SEQ_LEN, DIM)).astype(np.float32)
    table = rng.standard_normal((NUM_ITEMS, DIM)).astype(np.float32) * 0.5
    labels = rng.integers(0, NUM_ITEMS, (BATCH, SEQ_LEN, positives)).astype(np.int32)
    target = rng.random((BATCH, SEQ_LEN, positives)) > 0.3
    padding = np.ones((BATCH, SEQ_LEN), bool)
    return hidden, table, labels, target, padding


def negatives(shape_kind, seed):
    rng = np.random.default_rng(seed)
    shape = {"pool": (NEGATIVES,), "row": (BATCH, NEGATIVES), "position": (BATCH, SEQ_LEN, NEGATIVES)}[shape_kind]
    ids = rng.integers(0, NUM_ITEMS, shape).astype(np.int32)
    ignored = rng.random(shape) < 0.25
    ignored.reshape(-1)[0] = True
    return np.where(ignored, IGNORE, ids).astype(np.int32)


def jax_logits(table):
    def get_logits(hidden, candidates=None):
        embedded = table[candidates]
        return jnp.einsum("...e,...ke->...k", hidden, embedded)

    return get_logits


def port_logits(table):
    def get_logits(hidden, candidates=None):
        embedded = table[candidates.long()]
        return torch.einsum("...e,...ke->...k", hidden, embedded)

    return get_logits


def run_jax(loss, hidden, table, labels, negs, padding, target):
    def value(hidden, table):
        loss.logits_callback = jax_logits(table)
        return loss(hidden, {}, jnp.asarray(labels), None if negs is None else jnp.asarray(negs), padding, target)

    out, grads = jax.value_and_grad(value, argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(table))
    return float(out), [np.asarray(g) for g in grads]


def run_port(loss, hidden, table, labels, negs, padding, target, full=False):
    hidden_t = torch.tensor(hidden, requires_grad=True)
    table_t = torch.tensor(table, requires_grad=True)
    if full:
        loss.logits_callback = lambda h, c=None: torch.einsum("...e,ie->...i", h, table_t)
    else:
        loss.logits_callback = port_logits(table_t)
    out = loss(
        hidden_t, {}, torch.tensor(labels), None if negs is None else torch.tensor(negs),
        torch.tensor(padding), torch.tensor(target),
    )
    out.backward()
    return float(out.detach()), [hidden_t.grad.numpy(), table_t.grad.numpy()]


def close(port, jax_result):
    (got, got_grads), (want, want_grads) = port, jax_result
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for g, w in zip(got_grads, want_grads):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape_kind", ["pool", "row", "position"])
@pytest.mark.parametrize("positives", [1, 2])
def test_ce_sampled_matches_jax(shape_kind, positives):
    hidden, table, labels, target, padding = inputs(0, positives)
    negs = negatives(shape_kind, 1)
    assert (negs == IGNORE).any() and (negs != IGNORE).any()
    want = run_jax(JaxCESampled(negative_labels_ignore_index=IGNORE), hidden, table, labels, negs, padding, target)
    got = run_port(CESampled(negative_labels_ignore_index=IGNORE), hidden, table, labels, negs, padding, target)
    close(got, want)
    assert np.isfinite(got[0]) and np.abs(got[1][1]).sum() > 0


def test_ce_sampled_every_negative_ignored_leaves_only_the_positive():
    """All negatives ignored: each term is logaddexp(p, lse of nothing) - p,
    which is 0 in both packages (the ignored logits sit at finfo.min)."""
    hidden, table, labels, target, padding = inputs(2)
    negs = np.full((NEGATIVES,), IGNORE, np.int32)
    want = run_jax(JaxCESampled(IGNORE), hidden, table, labels, negs, padding, target)
    got = run_port(CESampled(IGNORE), hidden, table, labels, negs, padding, target)
    close(got, want)


@pytest.mark.parametrize("shape_kind", ["pool", "position"])
def test_ce_sampled_weighted_matches_jax(shape_kind):
    hidden, table, labels, target, padding = inputs(3, positives=2)
    negs = negatives(shape_kind, 4)
    weight = np.random.default_rng(5).random(NUM_ITEMS).astype(np.float32) + 0.1
    want = run_jax(JaxCESampledWeighted(weight, IGNORE), hidden, table, labels, negs, padding, target)
    got = run_port(CESampledWeighted(torch.tensor(weight), IGNORE), hidden, table, labels, negs, padding, target)
    close(got, want)


def test_ce_weighted_matches_jax():
    hidden, table, labels, target, padding = inputs(6)
    weight = np.random.default_rng(7).random(NUM_ITEMS).astype(np.float32) + 0.1

    def value(hidden, table):
        loss = JaxCEWeighted(weight)
        loss.logits_callback = lambda h, c=None: jnp.einsum("...e,ie->...i", h, table)
        return loss(hidden, {}, jnp.asarray(labels), None, padding, target)

    out, grads = jax.value_and_grad(value, argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(table))
    want = (float(out), [np.asarray(g) for g in grads])
    got = run_port(CEWeighted(weight), hidden, table, labels, None, padding, target, full=True)
    close(got, want)
    # the weights change the loss
    plain = run_port(CEWeighted(np.ones(NUM_ITEMS, np.float32)), hidden, table, labels, None, padding, target, full=True)
    assert abs(plain[0] - got[0]) > 1e-3
