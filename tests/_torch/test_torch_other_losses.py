"""The port's BCE, gBCE, LogInCE and LogOutCE families against the JAX ones.

``BCE`` (the full catalog, multi-hot targets), ``BCESampled`` and ``GBCE``
(each negative shape: a shared ``[N]`` pool, ``[B, N]`` per row, ``[B, L, N]``
per position, with ignored ids), ``LogInCE``, ``LogInCESampled``,
``LogOutCE`` and ``LogOutCEWeighted``, with one and two positives a position
(a repeated label among them). Both packages score through a tying head over
one table; the values and the gradients with respect to the hidden states and
the table are held to rtol 1e-5 / atol 1e-6 (f32, summation orders differ
between XLA and torch). ``GBCE`` at ``t=0`` equals ``BCESampled`` bit for
bit, as in the JAX package.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import replay_tpu.nn.loss as jax_losses
import replay_tpu_torch.nn.loss as port_losses
from replay_tpu.nn import Trainer as JaxTrainer
from replay_tpu_torch.nn.train import Trainer

NUM_ITEMS, DIM, BATCH, SEQ_LEN, NEGATIVES = 40, 8, 3, 5, 6
IGNORE = -100
RTOL, ATOL = 1e-5, 1e-6
WEIGHT = np.random.default_rng(9).random(NUM_ITEMS).astype(np.float32) + 0.1


def inputs(seed, positives=1):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((BATCH, SEQ_LEN, DIM)).astype(np.float32)
    table = rng.standard_normal((NUM_ITEMS, DIM)).astype(np.float32) * 0.5
    labels = rng.integers(0, NUM_ITEMS, (BATCH, SEQ_LEN, positives)).astype(np.int32)
    if positives > 1:
        labels[0, :2, 1] = labels[0, :2, 0]  # a label repeated at one position
    target = rng.random((BATCH, SEQ_LEN, positives)) > 0.3
    padding = np.ones((BATCH, SEQ_LEN), bool)
    padding[-1, :2] = False
    return hidden, table, labels, target & padding[..., None], padding


def negatives(kind, seed):
    if kind is None:
        return None
    rng = np.random.default_rng(seed)
    shape = {"pool": (NEGATIVES,), "row": (BATCH, NEGATIVES), "position": (BATCH, SEQ_LEN, NEGATIVES)}[kind]
    ids = rng.integers(0, NUM_ITEMS, shape).astype(np.int32)
    ignored = rng.random(shape) < 0.25
    ignored.reshape(-1)[0] = True
    return np.where(ignored, IGNORE, ids).astype(np.int32)


def run_jax(loss, hidden, table, labels, negs, padding, target):
    def value(hidden, table):
        def get_logits(h, candidates=None):
            if candidates is None:
                return jnp.einsum("...e,ie->...i", h, table)
            return jnp.einsum("...e,...ke->...k", h, table[candidates])

        loss.logits_callback = get_logits
        return loss(hidden, {}, jnp.asarray(labels), None if negs is None else jnp.asarray(negs), padding, target)

    out, grads = jax.jit(jax.value_and_grad(value, argnums=(0, 1)))(jnp.asarray(hidden), jnp.asarray(table))
    return float(out), [np.asarray(g) for g in grads]


def run_port(loss, hidden, table, labels, negs, padding, target):
    hidden_t = torch.tensor(hidden, requires_grad=True)
    table_t = torch.tensor(table, requires_grad=True)

    def get_logits(h, candidates=None):
        if candidates is None:
            return torch.einsum("...e,ie->...i", h, table_t)
        return torch.einsum("...e,...ke->...k", h, table_t[candidates.long()])

    loss.logits_callback = get_logits
    out = loss(
        hidden_t, {}, torch.tensor(labels), None if negs is None else torch.tensor(negs),
        torch.tensor(padding), torch.tensor(target),
    )
    out.backward()
    return float(out.detach()), [hidden_t.grad.numpy(), table_t.grad.numpy()]


# name -> (constructor arguments, negative shape or None for a full-catalog loss)
CASES = {
    "BCE": ((), None),
    "BCESampled": ((), "pool"),
    "GBCE": ({"catalog_size": NUM_ITEMS, "t": 0.75}, "pool"),
    "GBCE_beta": ({"beta": 0.3}, "pool"),
    "LogInCE": ((NUM_ITEMS,), None),
    "LogInCESampled": ((), "pool"),
    "LogOutCE": ((NUM_ITEMS,), None),
    "LogOutCEWeighted": ((NUM_ITEMS, WEIGHT), None),
}


def make(package, name):
    args, _ = CASES[name]
    cls = getattr(package, name.split("_")[0])
    if isinstance(args, dict):
        return cls(**args)
    if name.startswith("BCESampled") or name.startswith("LogInCESampled"):
        return cls(negative_labels_ignore_index=IGNORE)
    return cls(*args)


# the full-catalog losses with one and two positives; the sampled ones with
# two (one positive runs the same code)
@pytest.mark.parametrize(
    "name,positives",
    [(name, p) for name in sorted(CASES) for p in ((1, 2) if CASES[name][1] is None else (2,))],
)
def test_loss_matches_jax(name, positives):
    hidden, table, labels, target, padding = inputs(0, positives)
    negs = negatives(CASES[name][1], 1)
    want = run_jax(make(jax_losses, name), hidden, table, labels, negs, padding, target)
    got = run_port(make(port_losses, name), hidden, table, labels, negs, padding, target)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)
    assert np.isfinite(got[0]) and np.abs(got[1][1]).sum() > 0


@pytest.mark.parametrize("kind", ["row", "position"])
@pytest.mark.parametrize("name", ["GBCE", "LogInCESampled"])  # GBCE runs BCESampled's code
def test_sampled_losses_in_every_negative_shape(name, kind):
    hidden, table, labels, target, padding = inputs(2, positives=2)
    negs = negatives(kind, 3)
    want = run_jax(make(jax_losses, name), hidden, table, labels, negs, padding, target)
    got = run_port(make(port_losses, name), hidden, table, labels, negs, padding, target)
    np.testing.assert_allclose(got[0], want[0], rtol=RTOL, atol=ATOL)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL)


def test_gbce_t_zero_is_bitwise_bce_sampled_and_beta_matches_jax():
    """β = 1 at t=0: the scale is the IEEE identity, as the JAX test holds
    (``tests/nn/test_gbce.py``'s shapes: 12 items, 5 negatives)."""
    hidden, table, labels, target, padding = inputs(4)
    negs = negatives("pool", 5)[:5]
    plain = run_port(port_losses.BCESampled(), hidden, table, labels, negs, padding, target)
    calibrated = run_port(port_losses.GBCE(catalog_size=12, t=0.0), hidden, table, labels, negs, padding, target)
    assert plain[0] == calibrated[0]
    for a, b in zip(plain[1], calibrated[1]):
        np.testing.assert_array_equal(a, b)
    for t in (0.0, 0.5, 0.75, 1.0):
        assert port_losses.GBCE(catalog_size=101, t=t).resolved_beta(25) == jax_losses.GBCE(
            catalog_size=101, t=t
        ).resolved_beta(25)
    for kwargs, match in (({}, "exactly one"), ({"catalog_size": 10, "beta": 0.5}, "exactly one"),
                          ({"catalog_size": 10, "t": 1.5}, "t must be"), ({"catalog_size": 1}, "catalog_size")):
        with pytest.raises(ValueError, match=match):
            port_losses.GBCE(**kwargs)
    assert port_losses.GBCE.avoid_full_logits is True


def test_exports_and_the_bce_shorthand():
    """Every JAX loss but CEFusedTP is exported; ``LogOutCESampled`` is the
    ``CESampled`` alias; ``loss="bce"`` builds ``BCE`` and an unknown name
    raises the JAX text (the package's name aside)."""
    missing = [name for name in jax_losses.__all__ if name != "CEFusedTP" and not hasattr(port_losses, name)]
    assert missing == []
    assert port_losses.LogOutCESampled is port_losses.CESampled
    assert isinstance(Trainer(model=_Stub(), loss="BCE", device="cpu").loss, port_losses.BCE)
    with pytest.raises(ValueError) as jax_error:
        JaxTrainer(model=None, loss="sce")
    with pytest.raises(ValueError) as port_error:
        Trainer(model=_Stub(), loss="sce", device="cpu")
    assert str(port_error.value) == str(jax_error.value).replace("replay_tpu.nn", "replay_tpu_torch.nn")


class _Stub(torch.nn.Module):
    def forward(self, feature_tensors, padding_mask):
        return feature_tensors

    def forward_inference(self, feature_tensors, padding_mask):
        return feature_tensors
