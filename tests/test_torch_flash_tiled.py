"""Kernel K5 of the PyTorch port against the JAX package's tiled Pallas kernel.

On the CPU the port's ``flash_attention_tiled`` is its plain version (the whole
``[B, H, L, L]`` scores in f32) and its backward the torch-ops loop over key
blocks; the JAX side runs the Pallas kernel in interpret mode and its
``custom_vjp`` backward, as ``tests/ops/test_flash_tiled.py`` does. Inputs come
from numpy with a seed and go through both.

Tolerances: outputs and lse rtol/atol 2e-5 and gradients rtol 2e-4 / atol 2e-5,
the JAX test's own (f32 in another summation order: one pass against an online
softmax over blocks); bf16 inputs one bf16 ulp (2**-7), since both sides compute
in f32 and round the output once; the backward under another ``block_k`` within
rtol 1e-5 / atol 1e-6, the same f32 terms summed in another grouping.

The CUDA kernel itself is tested on the card in ``test_torch_kernels_cuda.py``;
here, which of its three variants the wrapper picks, what it refuses, and that
the card's TF32 precision probe tells one TF32 product from three.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tf32_probes
from replay_tpu.ops import flash_tiled as jax_tiled
from replay_tpu_torch.ops import flash_tiled
from replay_tpu_torch.ops.flash_tiled import (
    NEG_INF,
    flash_attention_tiled,
    flash_attention_tiled_backward,
    flash_attention_tiled_reference,
    padding_mask_bias,
)

SHAPES = [
    (2, 2, 16, 8, 8),  # multiple blocks, exact division
    (1, 1, 23, 8, 8),  # ragged: L % block != 0
    (2, 1, 7, 4, 16),  # single block bigger than L
    (1, 2, 65, 16, 32),  # ragged again, larger dim
]


def _inputs(batch, heads, length, dim, seed, min_length=1):
    """q, k, v from a seeded normal and a [B, L] padding mask (right-padded, as
    the JAX test's)."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(batch, heads, length, dim)).astype(np.float32) for _ in range(3))
    lengths = rng.integers(min_length, length + 1, batch)
    return q, k, v, np.arange(length)[None, :] < lengths[:, None]


def test_padding_mask_bias_matches_jax():
    mask = np.array([[True, False, True], [False, False, False]])
    np.testing.assert_array_equal(
        padding_mask_bias(torch.tensor(mask)).numpy(), np.asarray(jax_tiled.padding_mask_bias(jnp.asarray(mask)))
    )
    assert NEG_INF == jax_tiled.NEG_INF


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("batch,heads,length,dim,block", SHAPES)
def test_matches_the_pallas_kernel(batch, heads, length, dim, block, causal):
    q, k, v, mask = _inputs(batch, heads, length, dim, 0)
    bias = np.asarray(jax_tiled.padding_mask_bias(jnp.asarray(mask)))
    want_out, want_lse = jax_tiled._forward(
        *(jnp.asarray(t) for t in (q, k, v, bias)), causal, block, block, True
    )
    got = flash_attention_tiled(*(torch.tensor(t) for t in (q, k, v, bias)), causal, block, block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_out), rtol=2e-5, atol=2e-5)
    _, lse = flash_attention_tiled_reference(*(torch.tensor(t) for t in (q, k, v, bias)), causal)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=2e-5, atol=2e-5)


def test_all_padded_batch_row_is_zero_and_finite():
    q = torch.ones((2, 1, 8, 4))
    mask = torch.tensor([[False] * 8, [True] * 8])  # row 0: nothing valid
    for causal in (True, False):
        out, lse = flash_attention_tiled_reference(q, q, q, padding_mask_bias(mask), causal)
        assert torch.isfinite(out).all()
        assert torch.equal(out[0], torch.zeros_like(out[0]))
        assert torch.equal(lse[0], torch.full_like(lse[0], NEG_INF))
    want = jax_tiled.flash_attention_tiled(
        jnp.ones((2, 1, 8, 4)), jnp.ones((2, 1, 8, 4)), jnp.ones((2, 1, 8, 4)),
        jax_tiled.padding_mask_bias(jnp.asarray(mask.numpy())), True, 4, 4, True,
    )
    np.testing.assert_array_equal(np.asarray(want)[0], 0.0)


def _grads_both(q, k, v, bias, g, causal, block):
    """q, k, v and kv_bias gradients of sum(out * g) through the port and
    through the JAX custom VJP."""

    def jax_objective(qq, kk, vv, bb):
        return jnp.sum(jax_tiled.flash_attention_tiled(qq, kk, vv, bb, causal, block, block, True) * g)

    want = jax.grad(jax_objective, argnums=(0, 1, 2, 3))(*(jnp.asarray(t) for t in (q, k, v, bias)))
    leaves = [torch.tensor(t).requires_grad_() for t in (q, k, v, bias)]
    out = flash_attention_tiled(*leaves, causal, block, block)
    torch.sum(out * torch.tensor(g)).backward()
    return [t.grad.numpy() for t in leaves], [np.asarray(w) for w in want]


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_the_jax_custom_vjp(causal):
    """dq, dk, dv and dbias: the JAX test's shape, left-padded rows included."""
    q, k, v, mask = _inputs(2, 2, 19, 8, 1, min_length=2)
    bias = np.asarray(jax_tiled.padding_mask_bias(jnp.asarray(mask)))
    g = np.random.default_rng(2).normal(size=q.shape).astype(np.float32)
    got, want = _grads_both(q, k, v, bias, g, causal, 8)
    for a, b, name in zip(got, want, ("q", "k", "v", "bias")):
        assert np.isfinite(a).all(), name
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5, err_msg=name)


def test_gradients_match_autograd_through_the_plain_version():
    """The torch-ops backward against autograd through the dense plain version."""
    q, k, v, mask = _inputs(2, 2, 21, 8, 3, min_length=2)
    leaves = [torch.tensor(t).requires_grad_() for t in (q, k, v)]
    bias = padding_mask_bias(torch.tensor(mask)).requires_grad_()
    g = torch.tensor(np.random.default_rng(4).normal(size=q.shape).astype(np.float32))
    torch.sum(flash_attention_tiled(*leaves, bias, True, 8, 8) * g).backward()
    plain = [t.detach().clone().requires_grad_() for t in (*leaves, bias)]
    torch.sum(flash_attention_tiled_reference(*plain, True)[0] * g).backward()
    for a, b in zip((*leaves, bias), plain):
        np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=2e-4, atol=2e-5)


def test_bf16_inputs_keep_their_dtype():
    q, k, v, mask = _inputs(2, 2, 37, 16, 5)
    bias = np.asarray(jax_tiled.padding_mask_bias(jnp.asarray(mask)))
    want = jax_tiled.flash_attention_tiled(
        *(jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)), jnp.asarray(bias), True, 16, 16, True
    )
    got = flash_attention_tiled(*(torch.tensor(t).to(torch.bfloat16) for t in (q, k, v)), torch.tensor(bias))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    # one ulp of bf16 (8 significant bits) at the outputs' magnitude
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), rtol=2**-7, atol=2**-7
    )


@pytest.mark.parametrize("causal", [True, False])
def test_backward_does_not_depend_on_block_k(causal):
    q, k, v, mask = _inputs(2, 2, 29, 8, 6, min_length=3)
    tq, tk, tv = (torch.tensor(t) for t in (q, k, v))
    bias = padding_mask_bias(torch.tensor(mask))
    g = torch.tensor(np.random.default_rng(7).normal(size=q.shape).astype(np.float32))
    out, lse = flash_attention_tiled_reference(tq, tk, tv, bias, causal)
    whole = flash_attention_tiled_backward(tq, tk, tv, bias, out, lse, g, causal, block_k=29)
    for block_k in (1, 4, 8, 13, 256):
        blocked = flash_attention_tiled_backward(tq, tk, tv, bias, out, lse, g, causal, block_k=block_k)
        for a, b in zip(blocked, whole):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_backward_without_bias_gradient_gives_the_same_dq_dk_dv(causal):
    """The training path's padding bias needs no gradient: the backward then
    skips the dbias reduction and returns the same dq, dk, dv."""
    q, k, v, mask = _inputs(2, 2, 21, 8, 9, min_length=2)
    tq, tk, tv = (torch.tensor(t) for t in (q, k, v))
    bias = padding_mask_bias(torch.tensor(mask))
    g = torch.tensor(np.random.default_rng(3).normal(size=q.shape).astype(np.float32))
    out, lse = flash_attention_tiled_reference(tq, tk, tv, bias, causal)
    full = flash_attention_tiled_backward(tq, tk, tv, bias, out, lse, g, causal, block_k=8)
    no_bias = flash_attention_tiled_backward(tq, tk, tv, bias, out, lse, g, causal, block_k=8, bias_grad=False)
    assert full[3] is not None and no_bias[3] is None
    for a, b in zip(no_bias[:3], full[:3]):
        assert torch.equal(a, b)


def test_wrapper_output_carries_a_gradient_and_launches_nothing_on_the_cpu():
    q, k, v, mask = _inputs(1, 2, 9, 4, 8)
    leaves = [torch.tensor(t).requires_grad_() for t in (q, k, v)]
    bias = padding_mask_bias(torch.tensor(mask))
    before = flash_attention_tiled.launches
    out = flash_attention_tiled(*leaves, bias)
    assert flash_attention_tiled.launches == before
    assert out.grad_fn is not None and "FlashAttentionTiled" in type(out.grad_fn).__name__
    out.sum().backward()
    assert all(t.grad is not None for t in leaves) and bias.grad is None
    with pytest.raises(ValueError, match="positive"):
        flash_attention_tiled(*leaves, bias, block_k=0)
    assert flash_tiled.KERNEL == "flash_tiled"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_variant_is_mma_only_for_bf16_at_multiples_of_8_up_to_128(dtype):
    """The tensor-core variants take D a multiple of 8 up to 128 — ``mma`` in
    bf16, ``tf32x3`` in f32 — and ``simt`` every other D."""
    got = {dim: flash_tiled._variant(dtype, dim) for dim in range(1, flash_tiled.MAX_HEAD_DIM + 1)}
    tensor_cores = list(range(8, 129, 8))
    mma = [dim for dim, variant in got.items() if variant == "mma"]
    tf32x3 = [dim for dim, variant in got.items() if variant == "tf32x3"]
    assert mma == (tensor_cores if dtype == torch.bfloat16 else [])
    assert tf32x3 == (tensor_cores if dtype == torch.float32 else [])
    assert [dim for dim, variant in got.items() if variant == "simt"] == [
        dim for dim in got if dim not in tensor_cores
    ]
    assert set(got.values()) <= set(flash_tiled.VARIANTS)


def test_launch_counts_by_variant_start_at_zero_for_each():
    assert set(flash_attention_tiled.launches_by_variant) == {"mma", "tf32x3", "simt"} == set(flash_tiled.VARIANTS)
    assert all(isinstance(n, int) for n in flash_attention_tiled.launches_by_variant.values())


def test_each_variant_has_an_entry_point():
    assert set(flash_tiled._ENTRY_POINTS) == set(flash_tiled.VARIANTS)
    assert len(set(flash_tiled._ENTRY_POINTS.values())) == len(flash_tiled.VARIANTS)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_tf32x3_probe_tells_one_tf32_product_from_three(causal):
    """The inputs of the card's TF32 precision probe (``tf32_probes.k5_probe``):
    with one TF32 product per f32 product K5's output misses its f32 limit
    (1e-5), with three it keeps it, in the numpy emulation; and the plain
    version, which the card's test holds the kernel to, matches the exact
    result well inside the limit. Causal or not, rows 1.. see both live keys."""
    q, k, v, padding = tf32_probes.k5_probe()
    exact = tf32_probes.k5_emulated(q, k, v, padding)
    one = np.abs(tf32_probes.k5_emulated(q, k, v, padding, lo=()) - exact).max()
    three = np.abs(tf32_probes.k5_emulated(q, k, v, padding, lo=tf32_probes.K5_OPERANDS) - exact).max()
    assert one > tf32_probes.K5_LIMIT > 4 * three, (one, three)
    bias = padding_mask_bias(torch.tensor(padding))
    plain, _ = flash_attention_tiled_reference(*(torch.tensor(t) for t in (q, k, v)), bias, causal)
    rows = slice(1, None) if causal else slice(None)
    assert np.abs(plain[0, 0].numpy()[rows] - exact[rows]).max() < tf32_probes.K5_LIMIT / 4


@pytest.mark.parametrize("dropped", tf32_probes.K5_OPERANDS)
def test_tf32x3_probe_fails_when_any_one_operand_loses_its_lo_part(dropped):
    """On the same probe, a K5 that splits every operand but one (q or k in
    S = q kᵀ, p or v in P·V) into hi + lo misses the limit by far, in the
    numpy emulation: the card's probe sees each part the design keeps."""
    q, k, v, padding = tf32_probes.k5_probe()
    exact = tf32_probes.k5_emulated(q, k, v, padding)
    kept = tuple(name for name in tf32_probes.K5_OPERANDS if name != dropped)
    assert np.abs(tf32_probes.k5_emulated(q, k, v, padding, lo=kept) - exact).max() > 4 * tf32_probes.K5_LIMIT


def test_tf32_rounding_is_to_nearest_at_10_mantissa_bits():
    one_ulp = 2.0**-10
    x = np.array([1 + one_ulp, 1 + one_ulp / 2, 1 + one_ulp / 2 - 2.0**-20, -(1 + 3 * one_ulp / 2), 2.0**-20], np.float32)
    np.testing.assert_array_equal(
        tf32_probes.tf32(x), np.array([1 + one_ulp, 1 + one_ulp, 1, -(1 + 2 * one_ulp), 2.0**-20], np.float32)
    )
    hi, lo = tf32_probes.parts(np.float32(np.pi))
    assert hi != np.float32(np.pi) and abs(float(hi) + float(lo) - float(np.float32(np.pi))) <= np.pi * 2.0**-21


@pytest.mark.parametrize(
    "dtype,dim,error,match",
    [
        (torch.float16, 64, TypeError, "dtype"),
        (torch.float64, 64, TypeError, "dtype"),
        (torch.bfloat16, 257, ValueError, "head dim"),
        (torch.float32, 512, ValueError, "head dim"),
    ],
)
def test_wrapper_refuses_what_neither_variant_takes(dtype, dim, error, match):
    """Checked before the device, so meta tensors reach the checks here; the
    launch count does not move."""
    q = torch.zeros(2, 1, 8, dim, dtype=dtype, device="meta")
    bias = torch.zeros(2, 8, device="meta")
    before = dict(flash_attention_tiled.launches_by_variant)
    with pytest.raises(error, match=match):
        flash_attention_tiled(q, q, q, bias)
    assert flash_attention_tiled.launches_by_variant == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_refuses_mismatched_shapes_and_bias(dtype):
    q = torch.zeros(2, 1, 8, 16, dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="one shape"):
        flash_attention_tiled(q, q[:, :, :4], q, torch.zeros(2, 8, device="meta"))
    with pytest.raises(TypeError, match="dtype"):
        flash_attention_tiled(q, q.float() if dtype == torch.bfloat16 else q.bfloat16(), q, torch.zeros(2, 8, device="meta"))
    with pytest.raises(ValueError, match="kv_bias"):
        flash_attention_tiled(q, q, q, torch.zeros(2, 4, device="meta"))
    with pytest.raises(ValueError, match="kv_bias"):
        flash_attention_tiled(q, q, q, torch.zeros(2, 8, dtype=torch.int32, device="meta"))
