"""Kernel K4 of the PyTorch port against the JAX package's Pallas kernel.

On the CPU the port's ``flash_attention`` is its plain version; the JAX side
runs the Pallas kernel in interpret mode, as ``tests/ops/test_flash_attention.py``
does. Inputs come from numpy with a seed and go through both. Tolerance in f32:
rtol 2e-5 / atol 2e-6, the JAX test's own; in bf16 both sides compute in f32 and
round once, so they agree to one bf16 ulp.

The CUDA kernel itself is tested on the card in ``test_torch_kernels_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from replay_tpu.nn import mask as jax_mask
from replay_tpu.ops import flash_attention as jax_flash_attention
from replay_tpu_torch.nn import mask as torch_mask
from replay_tpu_torch.nn.attention import dot_product_attention
from replay_tpu_torch.ops.flash_attention import flash_attention

B, H, L, D = 2, 2, 16, 8


def _qkv(seed, shape=(B, H, L, D)):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


def _padding(seed, batch=B, length=L):
    """Left-padded [B, L] mask with one all-padding row."""
    lengths = np.random.default_rng(seed).integers(1, length + 1, batch)
    lengths[-1] = 0
    return np.arange(length)[None, :] >= length - lengths[:, None]


def _both(q, k, v, bias, bf16=False):
    """(port, JAX) outputs as f32 numpy; q, k, v cast to bf16 on both sides if asked."""
    jdtype = jnp.bfloat16 if bf16 else jnp.float32
    tdtype = torch.bfloat16 if bf16 else torch.float32
    want = jax_flash_attention(*(jnp.asarray(t).astype(jdtype) for t in (q, k, v)), jnp.asarray(bias), interpret=True)
    got = flash_attention(*(torch.tensor(t).to(tdtype) for t in (q, k, v)), torch.tensor(bias))
    assert got.dtype == tdtype and want.dtype == jdtype
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


def _causal(neg):
    return np.where(np.tril(np.ones((L, L), bool)), 0.0, neg).astype(np.float32)[None, None]


@pytest.mark.parametrize(
    "case",
    ["shared_head_bias", "per_head_bias", "eval_mask", "train_mask"],
)
def test_plain_version_matches_pallas(case):
    q, k, v = _qkv(0)
    rng = np.random.default_rng(1)
    if case == "shared_head_bias":
        bias = np.broadcast_to(_causal(-1e30), (B, 1, L, L)) + rng.normal(size=(B, 1, L, L)).astype(np.float32)
    elif case == "per_head_bias":
        bias = rng.normal(size=(B, H, L, L)).astype(np.float32)
    else:
        padding = _padding(2)
        bias = np.asarray(
            jax_mask.causal_attention_mask(jnp.asarray(padding), deterministic=case == "eval_mask")
        )
        ported = torch_mask.causal_attention_mask(torch.tensor(padding), deterministic=case == "eval_mask")
        np.testing.assert_array_equal(ported.numpy(), bias)
    got, want = _both(q, k, v, np.ascontiguousarray(bias))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_all_masked_rows_give_the_mean_of_v():
    q, k, v = _qkv(3)
    bias = np.full((B, 1, L, L), -1e30, np.float32)
    got, want = _both(q, k, v, bias)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got, np.broadcast_to(v.mean(axis=2, keepdims=True), v.shape), rtol=2e-5, atol=2e-6)


def test_bf16_inputs_keep_their_dtype():
    q, k, v = _qkv(4)
    bias = np.asarray(jax_mask.causal_attention_mask(jnp.asarray(_padding(5)), deterministic=True))
    got, want = _both(q, k, v, bias, bf16=True)
    # one ulp of bf16 (8 significant bits) at the outputs' magnitude
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -7)


@pytest.mark.parametrize("deterministic", [False, True])
def test_flash_route_matches_unfused_route(deterministic):
    """dot_product_attention's two routes agree (the JAX test's MHA check)."""
    q, k, v = (torch.tensor(t) for t in _qkv(6))
    mask = torch_mask.causal_attention_mask(torch.tensor(_padding(7)), deterministic=deterministic)
    fused = dot_product_attention(q, k, v, mask, use_flash=True)
    plain = dot_product_attention(q, k, v, mask, use_flash=False)
    np.testing.assert_allclose(fused.numpy(), plain.numpy(), rtol=2e-5, atol=2e-6)


def test_cpu_path_launches_nothing():
    q, k, v = (torch.tensor(t) for t in _qkv(8))
    bias = torch.zeros(B, 1, L, L)
    before = flash_attention.launches
    flash_attention(q, k, v, bias)
    assert flash_attention.launches == before


@pytest.mark.parametrize("route", ["tiled", "ring", "segment_ids"])
def test_routes_not_ported_yet_raise(route):
    """"ring" is not ported and raises. "tiled" is ported (K5) and behaves as
    the JAX route: no additive mask is built, and the route refuses a missing
    padding mask or an additive mask it would drop. Packed rows are ported:
    the unfused route builds the JAX segment mask, every kernel route refuses
    them with the JAX error (``test_torch_packing.py`` covers the masks)."""
    padding = torch.tensor(_padding(9))
    if route == "tiled":
        assert torch_mask.attention_mask_for_route("tiled", padding) is None
        assert jax_mask.attention_mask_for_route("tiled", jnp.asarray(padding.numpy())) is None
        q, k, v = (torch.tensor(t) for t in _qkv(10))
        with pytest.raises(ValueError, match="padding_mask"):
            dot_product_attention(q, k, v, None, use_flash="tiled")
        with pytest.raises(ValueError, match="additive mask"):
            dot_product_attention(q, k, v, torch.zeros(B, 1, L, L), use_flash="tiled", padding_mask=padding)
        return
    if route == "segment_ids":
        segment_ids = padding.long()
        got = torch_mask.attention_mask_for_route(False, padding, segment_ids=segment_ids)
        want = jax_mask.attention_mask_for_route(
            False, jnp.asarray(padding.numpy()), segment_ids=jnp.asarray(segment_ids.numpy())
        )
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        with pytest.raises(ValueError, match="cannot honor"):
            torch_mask.attention_mask_for_route(True, padding, segment_ids=segment_ids)
        return
    with pytest.raises(NotImplementedError, match="not ported yet: ROADMAP.md queue 1"):
        torch_mask.attention_mask_for_route(route, padding)
    q, k, v = (torch.tensor(t) for t in _qkv(10))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        dot_product_attention(q, k, v, None, use_flash=route)


def _grads_both(q, k, v, bias, g):
    """q, k, v (and bias) gradients of sum(out * g) through the port's
    ``flash_attention`` and through the JAX one (its ``custom_vjp``)."""

    def jax_objective(qq, kk, vv, bb):
        return jnp.sum(jax_flash_attention(qq, kk, vv, bb, interpret=True) * g)

    want = jax.grad(jax_objective, argnums=(0, 1, 2, 3))(*(jnp.asarray(t) for t in (q, k, v, bias)))
    leaves = [torch.tensor(t).requires_grad_() for t in (q, k, v, bias)]
    torch.sum(flash_attention(*leaves) * torch.tensor(g)).backward()
    return [t.grad.numpy() for t in leaves], [np.asarray(w) for w in want]


@pytest.mark.parametrize("case", ["eval_mask", "train_mask", "per_head_bias"])
def test_gradients_match_jax_flash_bwd(case):
    """The Function's backward is the JAX ``_flash_bwd``: f32 recompute, softmax
    backward, scale on dq and dk, a [B, 1, L, L] bias gradient summed over heads.
    Tolerance rtol 2e-5 / atol 2e-6 scaled by 10: the backward chains four
    f32 contractions where the forward has two."""
    q, k, v = _qkv(11)
    g = np.random.default_rng(12).normal(size=q.shape).astype(np.float32)
    if case == "per_head_bias":
        bias = np.random.default_rng(13).normal(size=(B, H, L, L)).astype(np.float32)
    else:
        bias = np.asarray(
            jax_mask.causal_attention_mask(jnp.asarray(_padding(14)), deterministic=case == "eval_mask")
        )
    (dq, dk, dv, dbias), (want_dq, want_dk, want_dv, want_dbias) = _grads_both(q, k, v, bias, g)
    for got, want in ((dq, want_dq), (dk, want_dk), (dv, want_dv)):
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    assert dbias.shape == bias.shape
    finite = np.isfinite(bias)  # -inf entries: JAX and torch agree on 0 gradient there
    np.testing.assert_allclose(dbias[np.broadcast_to(finite, dbias.shape)], want_dbias[np.broadcast_to(finite, dbias.shape)], rtol=2e-4, atol=2e-5)


def test_wrapper_output_carries_a_gradient():
    """The fault this Function repairs: the launch path returned a tensor with no
    autograd node, so on the card the q/k/v projections got no gradient. Every
    output built from inputs that need a gradient has a grad_fn, and a bias
    that needs none gets None."""
    q, k, v = (torch.tensor(t).requires_grad_() for t in _qkv(15))
    bias = torch.zeros(B, 1, L, L)
    out = flash_attention(q, k, v, bias)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    out.sum().backward()
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in (q, k, v))
    assert bias.grad is None
    frozen = flash_attention(*(t.detach() for t in (q, k, v)), bias)
    assert frozen.grad_fn is None
