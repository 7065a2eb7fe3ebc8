"""Kernels K1–K3 of the PyTorch port and its CE losses against the JAX package.

On the CPU the port's ``fused_lse`` runs its plain versions (forward and both
gradients, through the same ``torch.autograd.Function`` that launches the
kernels on the GPU); the JAX side runs the Pallas kernels in interpret mode, as
``tests/ops/test_fused_ce.py`` does. Inputs come from numpy with a seed and go
through both.

Tolerances are the JAX test's own: log-sum-exp rtol = atol = 2e-5, gradients
rtol 2e-4 / atol 2e-5 (f32 throughout, summation orders differ). A bf16 ``dh``
is compared to one bf16 ulp (rtol 2**-7). Losses: rtol 1e-5, f32 means of
values that already agree to 2e-5. The CUDA kernels are tested on the card in
``test_torch_kernels_cuda.py``; here, which of their two variants the wrappers
pick (one rule for K1, K2 and K3), K3's row split, and that the card's
precision probes (K3's; K1's and K2's) tell one TF32 product from three.
"""

import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tf32_probes
from replay_tpu.nn.loss import CE as JaxCE
from replay_tpu.nn.loss import CEFused as JaxCEFused
from replay_tpu.nn.loss import base as jax_base
from replay_tpu.ops.fused_ce import fused_lse as jax_fused_lse
from replay_tpu_torch.nn.loss import CE, CEFused
from replay_tpu_torch.nn.loss import base as loss_base
from replay_tpu_torch.ops import fused_ce
from replay_tpu_torch.ops.fused_ce import fused_lse

N, E, ITEMS = 37, 16, 50  # N not a multiple of the JAX row tile (8), ITEMS not of its lane (128)
LSE_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _inputs(seed=0, n=N, items=ITEMS):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, E)).astype(np.float32)
    w = (0.5 * rng.standard_normal((items, E))).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    return h, w, g


def _jax_lse_and_grads(h, w, g, num_valid=None, h_dtype=jnp.float32):
    def weighted(hh, ww):
        return jnp.sum(jax_fused_lse(hh, ww, 8, None, True, num_valid) * g)

    hj, wj = jnp.asarray(h).astype(h_dtype), jnp.asarray(w)
    lse = jax_fused_lse(hj, wj, 8, None, True, num_valid)
    dh, dw = jax.grad(weighted, argnums=(0, 1))(hj, wj)
    return np.asarray(lse), np.asarray(dh.astype(jnp.float32)), np.asarray(dw), dh.dtype


def _port_lse_and_grads(h, w, g, num_valid=None, h_dtype=torch.float32):
    ht = torch.tensor(h).to(h_dtype).requires_grad_()
    wt = torch.tensor(w).requires_grad_()
    lse = fused_lse(ht, wt, num_valid=num_valid)
    torch.sum(lse * torch.tensor(g)).backward()
    return lse.detach().numpy(), ht.grad.float().numpy(), wt.grad.numpy(), ht.grad.dtype


@pytest.mark.parametrize("num_valid", [None, 41], ids=["all_valid", "num_valid_41"])
def test_fused_lse_and_gradients_match_pallas(num_valid):
    h, w, g = _inputs()
    lse, dh, dw, _ = _port_lse_and_grads(h, w, g, num_valid)
    want_lse, want_dh, want_dw, _ = _jax_lse_and_grads(h, w, g, num_valid)
    assert lse.dtype == np.float32 and lse.shape == (N,)
    np.testing.assert_allclose(lse, want_lse, **LSE_TOL)
    np.testing.assert_allclose(dh, want_dh, **GRAD_TOL)
    np.testing.assert_allclose(dw, want_dw, **GRAD_TOL)
    if num_valid is not None:
        # masked columns drop out: the log-sum-exp of the valid columns alone
        plain = torch.logsumexp(torch.tensor(h) @ torch.tensor(w[:num_valid]).T, dim=-1)
        np.testing.assert_allclose(lse, plain.numpy(), **LSE_TOL)


def test_fully_masked_table_gives_a_finite_lse():
    h, w, g = _inputs(1, n=5, items=3)
    lse, dh, dw, _ = _port_lse_and_grads(h, w, g, num_valid=0)
    want_lse, want_dh, want_dw, _ = _jax_lse_and_grads(h, w, g, num_valid=0)
    assert np.isfinite(lse).all() and np.isfinite(dh).all() and np.isfinite(dw).all()
    np.testing.assert_allclose(lse, np.full(5, -1e30, np.float32), rtol=1e-6)
    np.testing.assert_allclose(lse, want_lse, rtol=1e-6)
    np.testing.assert_allclose(dh, want_dh, **GRAD_TOL)
    np.testing.assert_allclose(dw, want_dw, **GRAD_TOL)


def test_bf16_hidden_against_an_f32_table():
    h, w, g = _inputs(2)
    lse, dh, dw, dh_dtype = _port_lse_and_grads(h, w, g, h_dtype=torch.bfloat16)
    want_lse, want_dh, want_dw, want_dtype = _jax_lse_and_grads(h, w, g, h_dtype=jnp.bfloat16)
    assert dh_dtype == torch.bfloat16 and want_dtype == jnp.bfloat16
    # bf16 values convert to f32 exactly: the products are the f32 ones
    np.testing.assert_allclose(lse, want_lse, **LSE_TOL)
    np.testing.assert_allclose(dh, want_dh, rtol=2**-7, atol=2e-5)
    np.testing.assert_allclose(dw, want_dw, **GRAD_TOL)


def test_tiles_never_change_results():
    h, w, _ = _inputs(3)
    base = fused_lse(torch.tensor(h), torch.tensor(w))
    for tile, item_tile in ((8, None), (1024, 128), (256, 4096)):
        np.testing.assert_array_equal(fused_lse(torch.tensor(h), torch.tensor(w), tile, item_tile).numpy(), base.numpy())
    with pytest.raises(ValueError, match="tile"):
        fused_lse(torch.tensor(h), torch.tensor(w), tile=0)


def test_cpu_wrappers_launch_nothing():
    h, w, g = _inputs(4)
    counters = (fused_ce.fused_lse_forward, fused_ce.fused_lse_dh, fused_ce.fused_lse_dw)
    before = [c.launches for c in counters]
    _port_lse_and_grads(h, w, g)
    assert [c.launches for c in counters] == before


def _loss_inputs(seed=5):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((3, 4, E)).astype(np.float32)
    table = (0.5 * rng.standard_normal((ITEMS, E))).astype(np.float32)
    labels = rng.integers(0, ITEMS, (3, 4, 1)).astype(np.int32)
    labels[0, 0, 0] = ITEMS + 7  # out of range: clipped to the last item, as in JAX
    target = rng.random((3, 4, 1)) > 0.3
    return hidden, table, labels, target


@pytest.mark.parametrize("fused", [False, True], ids=["CE", "CEFused"])
def test_ce_losses_match_jax(fused):
    hidden, table, labels, target = _loss_inputs()
    padding = np.ones((3, 4), bool)

    def jax_loss(hh, ww):
        loss = JaxCEFused(tile=8, interpret=True) if fused else JaxCE()
        loss.logits_callback = lambda x: x @ ww.T
        loss.item_embeddings_callback = lambda: ww
        return loss(hh, {}, jnp.asarray(labels), None, jnp.asarray(padding), jnp.asarray(target))

    want, (want_dh, want_dw) = jax.value_and_grad(jax_loss, argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(table))
    ht, wt = torch.tensor(hidden).requires_grad_(), torch.tensor(table).requires_grad_()
    loss = CEFused() if fused else CE()
    loss.logits_callback = lambda x: x @ wt.T
    loss.item_embeddings_callback = lambda: wt
    got = loss(ht, {}, torch.tensor(labels), None, torch.tensor(padding), torch.tensor(target))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want_dh), **GRAD_TOL)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_dw), **GRAD_TOL)


def test_cefused_needs_its_item_table_callback():
    hidden, _, labels, target = _loss_inputs()
    with pytest.raises(AttributeError, match="item_embeddings_callback"):
        CEFused()(torch.tensor(hidden), {}, torch.tensor(labels), None, None, torch.tensor(target))


_DTYPES = {
    "float32": (jnp.float32, torch.float32),
    "bfloat16": (jnp.bfloat16, torch.bfloat16),
    "float16": (jnp.float16, torch.float16),
    "float64": (jnp.float64, torch.float64),
    "int8": (jnp.int8, torch.int8),
    "int32": (jnp.int32, torch.int32),
}


@pytest.mark.parametrize("table_dtype", sorted(_DTYPES))
@pytest.mark.parametrize("hidden_dtype", sorted(_DTYPES))
def test_check_dtypes_accepts_and_refuses_the_jax_pairs(hidden_dtype, table_dtype):
    def verdict(check, hidden, table):
        try:
            check(hidden, table)
        except ValueError:
            return False
        return True

    jh, th = _DTYPES[hidden_dtype]
    jt, tt = _DTYPES[table_dtype]
    jax_ok = verdict(
        JaxCEFused()._check_dtypes, types.SimpleNamespace(dtype=jnp.dtype(jh)), types.SimpleNamespace(dtype=jnp.dtype(jt))
    )
    port_ok = verdict(CEFused()._check_dtypes, torch.empty(0, dtype=th), torch.empty(0, dtype=tt))
    assert port_ok == jax_ok


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_loss_base_helpers_match_jax(rank):
    """broadcast_negatives, masked_mean and mask_negative_logits, exactly."""
    rng = np.random.default_rng(rank)
    shape = {1: (5,), 2: (3, 5), 3: (3, 4, 5)}[rank]  # [N] | [B, N] | [B, L, N]
    negatives = rng.integers(-1, 9, shape).astype(np.int32)
    np.testing.assert_array_equal(
        loss_base.broadcast_negatives(torch.tensor(negatives), 3, 4).numpy(),
        np.asarray(jax_base.broadcast_negatives(jnp.asarray(negatives), 3, 4)),
    )
    values = rng.standard_normal((3, 4)).astype(np.float32)
    mask = rng.random((3, 4)) > 0.5
    np.testing.assert_allclose(
        loss_base.masked_mean(torch.tensor(values), torch.tensor(mask)).item(),
        float(jax_base.masked_mean(jnp.asarray(values), jnp.asarray(mask))), rtol=1e-6,
    )
    assert loss_base.masked_mean(torch.tensor(values), torch.zeros(3, 4, dtype=torch.bool)).item() == 0.0
    labels = loss_base.broadcast_negatives(torch.tensor(negatives), 3, 4)
    logits = rng.standard_normal(tuple(labels.shape)).astype(np.float32)
    np.testing.assert_array_equal(
        loss_base.mask_negative_logits(torch.tensor(logits), labels, -1).numpy(),
        np.asarray(jax_base.mask_negative_logits(jnp.asarray(logits), jnp.asarray(labels.numpy()), -1)),
    )
    with pytest.raises(ValueError, match="rank"):
        loss_base.broadcast_negatives(torch.zeros(1, 1, 1, 1), 3, 4)


def test_dw_variant_is_tf32_at_multiples_of_8_up_to_128():
    got = {dim: fused_ce._dw_variant(dim) for dim in range(1, 300)}
    assert [dim for dim, variant in got.items() if variant == "tf32"] == list(range(8, 129, 8))
    assert set(got.values()) == set(fused_ce.DW_VARIANTS) == {"tf32", "simt"}
    assert set(fused_ce.fused_lse_dw.launches_by_variant) == set(fused_ce.DW_VARIANTS)
    assert all(isinstance(n, int) for n in fused_ce.fused_lse_dw.launches_by_variant.values())


@pytest.mark.parametrize(
    "rows,items,dim",
    [(25600, 3706, 64), (32768, 3706, 128), (1000, 1000, 64), (5, 3, 16), (77, 129, 100), (130, 70, 256)],
)
@pytest.mark.parametrize("variant", ["tf32", "simt"])
def test_dw_row_split_covers_the_rows_in_whole_tiles(rows, items, dim, variant):
    """Each split a whole number of 64-row tiles, together covering every row
    and none twice, about the variant's target of blocks, from shapes alone."""
    splits, per_split = fused_ce.dw_row_split(rows, items, dim, variant)
    assert per_split % 64 == 0 and splits * per_split >= rows > (splits - 1) * per_split
    blocks = -(-items // 64) * (1 if variant == "tf32" else -(-dim // 64))
    row_tiles = -(-rows // 64)
    assert splits == row_tiles or splits * blocks >= fused_ce._DW_TARGET_BLOCKS[variant]
    assert fused_ce.dw_row_split(rows, items, dim, variant) == (splits, per_split)


def test_k3_probe_tells_one_tf32_product_from_three():
    """The inputs of the card's K3 precision probe (``tf32_probes.k3_probe``):
    with one TF32 product per f32 product dW misses its limit (1e-4 of the
    largest |dW|), with three it keeps it, in the numpy emulation; and K3's
    plain version, which the card's test holds the kernel to, matches the
    exact result well inside the limit."""
    h, table, g = tf32_probes.k3_probe()
    exact = tf32_probes.k3_emulated(h, table, g)
    limit = tf32_probes.K3_LIMIT * np.abs(exact).max()
    one = np.abs(tf32_probes.k3_emulated(h, table, g, lo=()) - exact).max()
    three = np.abs(tf32_probes.k3_emulated(h, table, g, lo=tf32_probes.K3_OPERANDS) - exact).max()
    assert one > limit > 4 * three, (one, limit, three)
    ht, wt, gt = (torch.tensor(t) for t in (h, table, g))
    lse = fused_ce.fused_lse_reference(ht, wt)
    plain = fused_ce.fused_lse_dw_reference(ht, wt, gt, lse).numpy()
    assert np.abs(plain - exact).max() < limit / 4


@pytest.mark.parametrize("dropped", tf32_probes.K3_OPERANDS)
def test_k3_probe_fails_when_any_one_operand_loses_its_lo_part(dropped):
    """On the same probe, a K3 that splits every operand but one (h, in both
    products; W, in the logits; the softmax weights P, in dW = Pᵀh) into hi +
    lo misses the limit by far, in the numpy emulation: the table's logits
    spread so that W's rounding reaches the weights, and the card's probe
    sees each part the design keeps."""
    h, table, g = tf32_probes.k3_probe()
    exact = tf32_probes.k3_emulated(h, table, g)
    limit = tf32_probes.K3_LIMIT * np.abs(exact).max()
    kept = tuple(name for name in tf32_probes.K3_OPERANDS if name != dropped)
    assert np.abs(tf32_probes.k3_emulated(h, table, g, lo=kept) - exact).max() > 4 * limit
    lse = fused_ce.fused_lse_reference(torch.tensor(h), torch.tensor(table)).numpy()
    weights = np.exp(h.astype(np.float64) @ table.T - lse[:, None])
    assert 0.3 < weights.max(axis=1).mean() < 0.9  # neither uniform nor one-hot


@pytest.mark.parametrize("wrapper", ["fused_lse_forward", "fused_lse_dh", "fused_lse_dw"])
def test_one_variant_rule_for_k1_k2_and_k3(wrapper):
    """K1, K2 and K3 take their variant from one pure function of E (K3's rule,
    still reachable by its earlier name), and each wrapper counts its launches
    by variant; on CPU tensors the plain version runs and nothing is counted."""
    assert fused_ce._dw_variant is fused_ce._variant
    got = {dim: fused_ce._variant(dim) for dim in range(1, 300)}
    assert [dim for dim, variant in got.items() if variant == "tf32"] == list(range(8, 129, 8))
    fn = getattr(fused_ce, wrapper)
    assert set(fn.launches_by_variant) == set(fused_ce.VARIANTS) == {"tf32", "simt"}
    h, w, g = _inputs(6)
    args = (torch.tensor(h), torch.tensor(w)) if wrapper == "fused_lse_forward" else (
        torch.tensor(h), torch.tensor(w), torch.tensor(g), torch.zeros(N)
    )
    before = (fn.launches, dict(fn.launches_by_variant))
    fn(*args)
    assert (fn.launches, fn.launches_by_variant) == before


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_lse_probe_tells_one_tf32_product_from_three(kernel):
    """The inputs of the card's K1 and K2 precision probe
    (``tf32_probes.lse_probe``): with one TF32 product per f32 product lse
    misses K1's limit (1e-4) and dh K2's (1e-4 of the largest |dh|), with three
    both keep them, in the numpy emulation; and the plain versions, which the
    card's test holds the kernels to, match the exact results well inside."""
    h, table, g = tf32_probes.lse_probe()
    ht, wt, gt = (torch.tensor(t) for t in (h, table, g))
    lse = fused_ce.fused_lse_reference(ht, wt)
    if kernel == "K1":
        exact, limit = tf32_probes.k1_emulated(h, table), tf32_probes.K1_LIMIT
        one = np.abs(tf32_probes.k1_emulated(h, table, lo=()) - exact).max()
        three = np.abs(tf32_probes.k1_emulated(h, table, lo=tf32_probes.K1_OPERANDS) - exact).max()
        plain = lse.numpy()
    else:
        exact = tf32_probes.k2_emulated(h, table, g)
        limit = tf32_probes.K2_LIMIT * np.abs(exact).max()
        one = np.abs(tf32_probes.k2_emulated(h, table, g, lo=()) - exact).max()
        three = np.abs(tf32_probes.k2_emulated(h, table, g, lo=tf32_probes.K2_OPERANDS) - exact).max()
        plain = fused_ce.fused_lse_dh_reference(ht, wt, gt, lse).numpy()
    assert one > limit > 4 * three, (one, limit, three)
    assert np.abs(plain - exact).max() < limit / 4


@pytest.mark.parametrize(
    "kernel,dropped", [("K1", name) for name in tf32_probes.K1_OPERANDS] + [("K2", name) for name in tf32_probes.K2_OPERANDS]
)
def test_lse_probe_fails_when_any_one_operand_loses_its_lo_part(kernel, dropped):
    """On the same probe, a K1 or K2 that splits every operand but one (h in
    the logits; W in the logits and, for K2, in dh = P W; the weights P) into
    hi + lo misses its limit by far, in the numpy emulation."""
    h, table, g = tf32_probes.lse_probe()
    operands = tf32_probes.K1_OPERANDS if kernel == "K1" else tf32_probes.K2_OPERANDS
    kept = tuple(name for name in operands if name != dropped)
    if kernel == "K1":
        exact = tf32_probes.k1_emulated(h, table)
        err = np.abs(tf32_probes.k1_emulated(h, table, lo=kept) - exact).max()
        assert err > 4 * tf32_probes.K1_LIMIT
    else:
        exact = tf32_probes.k2_emulated(h, table, g)
        err = np.abs(tf32_probes.k2_emulated(h, table, g, lo=kept) - exact).max()
        assert err > 4 * tf32_probes.K2_LIMIT * np.abs(exact).max()
    weights = np.exp(h.astype(np.float64) @ table.T - tf32_probes.k1_emulated(h, table)[:, None])
    assert 0.05 < weights.max(axis=1).mean() < 0.9  # neither uniform nor one-hot
