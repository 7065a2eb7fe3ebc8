"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. This file imports
neither JAX nor the JAX package, so it runs on a GPU machine that has only
PyTorch; the repo's ``tests/conftest.py`` needs pandas and the JAX package's
data module, so skip it there:

    python -m pytest --noconftest tests/_torch/test_torch_kernels_cuda.py -q

Tolerances (max abs error against the plain version, f32 result): K4 f32
1e-5, the kernel differing only in summation order; bf16 2e-2, its output's
own rounding (half an ulp is 1.6e-2 below 8). K1 1e-4 absolute on an lse of
about 5 to 10, K2 and K3 1e-4 of the output's largest magnitude: f32 products
summed in another order (a bf16 dh adds its rounding, 2**-8 of the largest).
K4's gradient 1e-4: the same f32 recompute by other formulas. K5 (max abs
error against its plain version): out f32 1e-5 and bf16 2e-2 as K4's; lse rtol
1e-5 / atol 1e-5 (f32, about log L plus the row max); its gradient 1e-4 of the largest magnitude (dbias sums over queries).
K5 runs its "mma" variant (bf16 tensor cores) for bf16 and its "tf32x3"
variant (TF32 tensor cores, three products per f32 product) for f32 where D is
a multiple of 8 up to 128, its "simt" variant elsewhere; the same limits hold
for all. K3 runs its "tf32" variant where E is a multiple of 8 up to 128, its
"simt" variant elsewhere, under the same limits; so do K1 and K2. The P-precision probe's limit
is set from the plain version in the test: the output's own bf16 rounding plus
2**-15 of the products' magnitude (f32 P carried as a bf16 hi + lo pair), which
a P rounded to bf16 must exceed. The TF32 probes (``tf32_probes``) hold the
tf32 kernels to their f32 limits on inputs where one TF32 product per f32
product misses them.
"""

import numpy as np
import pytest
import torch

import tf32_probes
from replay_tpu_torch.data import FeatureHint, FeatureType
from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu_torch.nn.loss import CEFused
from replay_tpu_torch.nn.mask import causal_attention_mask
from replay_tpu_torch.nn.sequential.sasrec import SasRec
from replay_tpu_torch.nn.train import Trainer
from replay_tpu_torch.ops import fused_ce
from replay_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference
from replay_tpu_torch.ops.flash_tiled import (
    NEG_INF,
    flash_attention_tiled,
    flash_attention_tiled_reference,
    padding_mask_bias,
)
from replay_tpu_torch.ops import flash_tiled
from replay_tpu_torch.serve import ScoringEngine, make_window

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels run only on a GPU; torch sees none here")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _left_padded(batch, length, seed):
    """[B, L] padding mask, left-padded, last row all padding."""
    lengths = np.random.default_rng(seed).integers(1, length + 1, batch)
    lengths[-1] = 0
    return np.arange(length)[None, :] >= length - lengths[:, None]


@pytest.mark.parametrize(
    "batch,heads,length,dim,bias_heads",
    [(64, 1, 50, 64, 1), (8, 4, 200, 48, 4), (2, 2, 1024, 64, 1), (3, 2, 37, 256, 1), (2, 1, 5, 16, 1), (16, 1, 130, 64, 1)],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("deterministic", [True, False], ids=["eval_mask", "train_mask"])
def test_flash_attention_matches_plain_version(cuda_device, batch, heads, length, dim, bias_heads, dtype, deterministic):
    rng = np.random.default_rng(length)
    q, k, v = (
        torch.tensor(rng.normal(size=(batch, heads, length, dim)).astype(np.float32)).to(cuda_device, dtype)
        for _ in range(3)
    )
    padding = torch.tensor(_left_padded(batch, length, dim), device=cuda_device)
    bias = causal_attention_mask(padding, deterministic=deterministic)
    if bias_heads > 1:
        bias = bias + torch.randn(batch, bias_heads, length, length, device=cuda_device)
    before = flash_attention.launches
    got = flash_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_reference(q.float(), k.float(), v.float(), bias)
    assert (got.float() - want).abs().max().item() <= TOL[dtype]


def test_flash_attention_takes_head_split_views(cuda_device):
    """q/k/v as the attention module makes them: non-contiguous views."""
    x = torch.randn(4, 20, 3, 16, device=cuda_device)  # [B, L, H, D]
    q = x.transpose(1, 2)
    assert not q.is_contiguous()
    bias = causal_attention_mask(torch.ones(4, 20, dtype=torch.bool, device=cuda_device), deterministic=True)
    got = flash_attention(q, q, q, bias)
    want = flash_attention_reference(q, q, q, bias)
    assert (got - want).abs().max().item() <= TOL[torch.float32]


def test_all_masked_rows_give_the_mean_of_v(cuda_device):
    q, k, v = (torch.randn(2, 2, 70, 32, device=cuda_device) for _ in range(3))
    got = flash_attention(q, k, v, torch.full((2, 1, 70, 70), -1e30, device=cuda_device))
    assert (got - v.mean(dim=2, keepdim=True)).abs().max().item() <= 1e-5


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    q = torch.randn(2, 1, 8, 16, device=cuda_device)
    bias = torch.zeros(2, 1, 8, 8, device=cuda_device)
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention(q, q, q, bias.cpu())
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q.half(), q.half(), q.half(), bias)
    wide = torch.randn(2, 1, 8, 512, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention(wide, wide, wide, bias)
    with pytest.raises(ValueError, match="bias"):
        flash_attention(q, q, q, bias[:, :, :4])


def test_serving_on_the_kernel_matches_the_unfused_route(cuda_device):
    """ScoringEngine on SasRec(use_flash=True) vs use_flash=False, same weights."""
    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True,
            feature_hint=FeatureHint.ITEM_ID, cardinality=300, embedding_dim=32,
        )
    )
    width = dict(embedding_dim=32, num_blocks=2, num_heads=2, max_sequence_length=12, device=cuda_device)
    fused = SasRec(schema, use_flash=True, generator=torch.Generator().manual_seed(1), **width)
    plain = SasRec(schema, use_flash=False, **width)
    params = fused.state_dict()
    buckets = dict(length_buckets=(6, 12), batch_buckets=(1, 4), device=cuda_device)
    engines = ScoringEngine(fused, params, **buckets), ScoringEngine(plain, params, **buckets)
    rng = np.random.default_rng(2)
    windows = [make_window(list(rng.integers(0, 300, n)), 12) for n in (0, 1, 5, 20)]
    ids, mask = np.stack([w[0] for w in windows]), np.stack([w[1] for w in windows])
    before = flash_attention.launches
    (got, got_hidden), (want, want_hidden) = (e.encode(12, ids, mask) for e in engines)
    assert flash_attention.launches == before + 2  # one launch per block
    assert (got - want).abs().max().item() <= 1e-4
    assert (got_hidden - want_hidden).abs().max().item() <= 1e-4


@pytest.mark.parametrize(
    "rows,items,dim,num_valid",
    [(25600, 3706, 64, None), (1000, 1000, 64, 900), (300, 1000, 64, 0), (77, 129, 100, 50), (5, 3, 16, None), (130, 70, 256, None)],
    ids=["train_width", "ragged", "fully_masked", "dim_100", "tiny", "dim_256"],
)
@pytest.mark.parametrize(
    "hidden_dtype,table_dtype",
    [(torch.float32, torch.float32), (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)],
    ids=["f32", "bf16_hidden", "bf16_both"],
)
def test_fused_ce_kernels_match_plain_versions(cuda_device, rows, items, dim, num_valid, hidden_dtype, table_dtype):
    gen = torch.Generator(cuda_device).manual_seed(rows + items)
    hidden = torch.randn(rows, dim, device=cuda_device, generator=gen).to(hidden_dtype)
    table = (torch.randn(items, dim, device=cuda_device, generator=gen) / dim**0.5).to(table_dtype)
    grad = torch.randn(rows, device=cuda_device, generator=gen)
    counters = (fused_ce.fused_lse_forward, fused_ce.fused_lse_dh, fused_ce.fused_lse_dw)
    before = [c.launches for c in counters]
    variants_before = dict(fused_ce.fused_lse_dw.launches_by_variant)
    lse = fused_ce.fused_lse_forward(hidden, table, num_valid)
    dh = fused_ce.fused_lse_dh(hidden, table, grad, lse, num_valid)
    dw = fused_ce.fused_lse_dw(hidden, table, grad, lse, num_valid)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [b + 1 for b in before]
    # K3 on the tensor cores where E is a multiple of 8 up to 128, on its simt variant elsewhere
    variant = "tf32" if dim % 8 == 0 and dim <= 128 else "simt"
    assert fused_ce._dw_variant(dim) == variant
    assert fused_ce.fused_lse_dw.launches_by_variant == {
        key: count + (key == variant) for key, count in variants_before.items()
    }
    assert lse.dtype == torch.float32 and dh.dtype == hidden_dtype and dw.dtype == table_dtype
    h32, w32 = hidden.float(), table.float()
    want_lse = fused_ce.fused_lse_reference(h32, w32, num_valid)
    want_dh = fused_ce.fused_lse_dh_reference(h32, w32, grad, lse, num_valid)
    want_dw = fused_ce.fused_lse_dw_reference(h32, w32, grad, lse, num_valid)
    assert torch.isfinite(lse).all()
    if num_valid == 0:  # every column masked: finite, at the mask
        assert torch.allclose(lse, torch.full_like(lse, -1e30), rtol=1e-6)
    assert torch.allclose(lse, want_lse, rtol=1e-6, atol=1e-4)
    dh_tol = (2**-8 if hidden_dtype == torch.bfloat16 else 1e-4) * want_dh.abs().max().item()
    dw_tol = (2**-8 if table_dtype == torch.bfloat16 else 1e-4) * want_dw.abs().max().item()
    assert (dh.float() - want_dh).abs().max().item() <= dh_tol
    assert (dw.float() - want_dw).abs().max().item() <= dw_tol


def test_fused_ce_is_the_same_from_run_to_run(cuda_device):
    gen = torch.Generator(cuda_device).manual_seed(3)
    hidden = torch.randn(25600, 64, device=cuda_device, generator=gen)
    table = torch.randn(3706, 64, device=cuda_device, generator=gen) / 8
    grad = torch.randn(25600, device=cuda_device, generator=gen)
    lse = fused_ce.fused_lse_forward(hidden, table)
    assert torch.equal(lse, fused_ce.fused_lse_forward(hidden, table))
    assert torch.equal(fused_ce.fused_lse_dh(hidden, table, grad, lse), fused_ce.fused_lse_dh(hidden, table, grad, lse))
    assert torch.equal(fused_ce.fused_lse_dw(hidden, table, grad, lse), fused_ce.fused_lse_dw(hidden, table, grad, lse))


def test_fused_lse_gradients_through_autograd(cuda_device):
    """fused_lse's Function: K1 forward, K2 and K3 backward, against autograd
    through torch.logsumexp; the table also gets a second gradient, as the
    tied table does, and the two add."""
    gen = torch.Generator(cuda_device).manual_seed(4)
    hidden = torch.randn(300, 64, device=cuda_device, generator=gen).requires_grad_()
    table = (torch.randn(500, 64, device=cuda_device, generator=gen) / 8).requires_grad_()
    weights = torch.randn(300, device=cuda_device, generator=gen)
    (fused_ce.fused_lse(hidden, table) * weights).sum().backward()
    (table.sum() * 2).backward()
    got = hidden.grad.clone(), table.grad.clone()
    hidden.grad, table.grad = None, None
    (torch.logsumexp(hidden @ table.T, -1) * weights).sum().backward()
    (table.sum() * 2).backward()
    for a, b in zip(got, (hidden.grad, table.grad)):
        assert (a - b).abs().max().item() <= 1e-4 * b.abs().max().item()


def test_fused_ce_wrappers_refuse_what_the_kernels_do_not_take(cuda_device):
    hidden = torch.randn(8, 16, device=cuda_device)
    table = torch.randn(5, 16, device=cuda_device)
    with pytest.raises(ValueError, match="one CUDA device"):
        fused_ce.fused_lse_forward(hidden, table.cpu())
    with pytest.raises(TypeError, match="must each be one of"):
        fused_ce.fused_lse_forward(hidden.half(), table)
    with pytest.raises(ValueError, match="hidden must be"):
        fused_ce.fused_lse_forward(hidden, table[:, :8])
    with pytest.raises(ValueError, match="at least one item"):
        fused_ce.fused_lse_forward(hidden, table[:0])
    with pytest.raises(ValueError, match="grad and lse"):
        fused_ce.fused_lse_dh(hidden, table, torch.zeros(8, device=cuda_device, dtype=torch.float64), torch.zeros(8, device=cuda_device))


@pytest.mark.parametrize("mask", ["train", "eval"])
def test_flash_attention_gradient_matches_autograd_through_the_plain_version(cuda_device, mask):
    """At the training shape (bench.py: B=512, H=1, L=50, D=64)."""
    gen = torch.Generator(cuda_device).manual_seed(5)
    q, k, v = (torch.randn(512, 1, 50, 64, device=cuda_device, generator=gen) for _ in range(3))
    padding = torch.tensor(_left_padded(512, 50, 6), device=cuda_device)
    bias = causal_attention_mask(padding, deterministic=mask == "eval")
    g = torch.randn(q.shape, device=cuda_device, generator=gen)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = flash_attention.launches
    out = flash_attention(*leaves, bias)
    assert flash_attention.launches == before + 1 and out.grad_fn is not None
    torch.sum(out * g).backward()
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    torch.sum(flash_attention_reference(*plain, bias) * g).backward()
    for a, b in zip(leaves, plain):
        assert torch.isfinite(a.grad).all()
        assert (a.grad - b.grad).abs().max().item() <= 1e-4


def test_training_on_the_card_reaches_every_attention_projection(cuda_device):
    """The fault the K4 Function repairs: through the kernel, every block's
    query, key and value weights get a non-zero gradient, and a Trainer step
    moves them."""
    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True,
            feature_hint=FeatureHint.ITEM_ID, cardinality=300, embedding_dim=32,
        )
    )
    model = SasRec(
        schema, embedding_dim=32, num_blocks=2, num_heads=2, max_sequence_length=12, use_flash=True,
        device=cuda_device, generator=torch.Generator().manual_seed(7),
    )
    rng = np.random.default_rng(8)
    items = rng.integers(0, 300, (16, 13)).astype(np.int32)
    mask = np.ones((16, 12), bool)
    batch = {
        "feature_tensors": {"item_id": items[:, :-1]}, "padding_mask": mask,
        "positive_labels": items[:, 1:, None], "target_padding_mask": mask[:, :, None],
    }
    projections = [
        f"body.encoder.block_{i}.attention.{name}.weight" for i in range(2) for name in ("query", "key", "value")
    ]
    loss = CEFused()
    loss.logits_callback = model.get_logits
    loss.item_embeddings_callback = model.get_item_weights
    ids = torch.tensor(items[:, :-1], device=cuda_device)
    hidden = model({"item_id": ids}, torch.tensor(mask, device=cuda_device), deterministic=False)
    loss(
        hidden, {}, torch.tensor(items[:, 1:, None], device=cuda_device), None, None,
        torch.tensor(mask[:, :, None], device=cuda_device),
    ).backward()
    grads = dict(model.named_parameters())
    for name in projections:
        assert grads[name].grad is not None and grads[name].grad.abs().sum().item() > 0, name

    trainer = Trainer(model, CEFused(), device=cuda_device)
    state = trainer.init_state(batch)
    before = {name: state.params[name].detach().clone() for name in projections}
    launches = flash_attention.launches
    state, value = trainer.train_step(state, batch)
    torch.cuda.synchronize()
    assert flash_attention.launches == launches + 2 and torch.isfinite(value)
    for name in projections:
        assert not torch.equal(state.params[name], before[name]), name


# --------------------------------------------------------------------------- #
# K5: the length-tiled kernel
# --------------------------------------------------------------------------- #
def _tiled_case(batch, heads, length, dim, dtype, device, seed, dead_row=True):
    """q, k, v from a seeded normal; kv_bias from a left-padded mask with, if
    asked, one fully padded row."""
    rng = np.random.default_rng(seed)
    q, k, v = (
        torch.tensor(rng.normal(size=(batch, heads, length, dim)).astype(np.float32)).to(device, dtype)
        for _ in range(3)
    )
    lengths = rng.integers(1, length + 1, batch)
    if dead_row:
        lengths[-1] = 0
    padding = torch.tensor(np.arange(length)[None, :] >= length - lengths[:, None], device=device)
    return q, k, v, padding_mask_bias(padding), padding


@pytest.mark.parametrize(
    "batch,heads,length,dim",
    [(32, 2, 1024, 64), (2, 2, 1000, 64), (3, 2, 37, 256), (2, 1, 5, 16), (2, 3, 130, 100)],
    ids=["slice", "ragged", "dim_256", "tiny", "dim_100"],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_tiled_matches_plain_version(cuda_device, batch, heads, length, dim, dtype, causal):
    q, k, v, bias, padding = _tiled_case(batch, heads, length, dim, dtype, cuda_device, length + dim)
    before = flash_attention_tiled.launches
    out, lse = flash_tiled._launch(q, k, v, bias, causal)
    torch.cuda.synchronize()
    assert flash_attention_tiled.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape and lse.shape == q.shape[:3]
    want, want_lse = flash_attention_tiled_reference(q.float(), k.float(), v.float(), bias, causal)
    assert torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert (out.float() - want).abs().max().item() <= TOL[dtype]
    assert torch.allclose(lse, want_lse, rtol=1e-5, atol=1e-5)
    # the fully padded row: exactly 0, lse at the mask
    assert torch.equal(out[-1].float(), torch.zeros_like(out[-1].float()))
    assert torch.equal(lse[-1], torch.full_like(lse[-1], NEG_INF))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_tiled_skips_padding_tiles_exactly(cuda_device, dtype, causal):
    """Key tiles whose every key is padding are skipped: masks with such tiles
    at the start, in the middle and at the end of a row, and a row whose only
    valid keys sit after a padded tile, match the plain version."""
    q, k, v, _, _ = _tiled_case(3, 2, 300, 64, dtype, cuda_device, 16, dead_row=False)
    padding = torch.ones(3, 300, dtype=torch.bool, device=cuda_device)
    padding[0, :128] = False  # two whole tiles at the start
    padding[1, 64:192] = False  # two whole tiles in the middle
    padding[1, 256:] = False  # the ragged last tile
    padding[2, :250] = False  # only the last 50 keys are real
    bias = padding_mask_bias(padding)
    got, lse = flash_tiled._launch(q, k, v, bias, causal)
    want, want_lse = flash_attention_tiled_reference(q.float(), k.float(), v.float(), bias, causal)
    assert (got.float() - want).abs().max().item() <= TOL[dtype]
    assert torch.allclose(lse, want_lse, rtol=1e-5, atol=1e-5)


def test_flash_tiled_long_rows(cuda_device):
    """bench_suite.py's attention_long shape: B=4, H=4, L=4096, D=64, causal, no padding."""
    q, k, v, bias, _ = _tiled_case(4, 4, 4096, 64, torch.float32, cuda_device, 9, dead_row=False)
    bias = torch.zeros_like(bias)
    got = flash_attention_tiled(q, k, v, bias)
    want, _ = flash_attention_tiled_reference(q, k, v, bias)
    assert (got - want).abs().max().item() <= TOL[torch.float32]
    # causal row 0 attends only to itself
    assert torch.allclose(got[:, :, 0], v[:, :, 0])


def test_flash_tiled_takes_head_split_views(cuda_device):
    x = torch.randn(4, 20, 3, 16, device=cuda_device)  # [B, L, H, D]
    q = x.transpose(1, 2)
    assert not q.is_contiguous()
    bias = torch.zeros(4, 20, device=cuda_device)
    got = flash_attention_tiled(q, q, q, bias)
    want, _ = flash_attention_tiled_reference(q, q, q, bias)
    assert (got - want).abs().max().item() <= TOL[torch.float32]


def test_flash_tiled_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    q = torch.randn(2, 1, 8, 16, device=cuda_device)
    bias = torch.zeros(2, 8, device=cuda_device)
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention_tiled(q, q, q, bias.cpu())
    with pytest.raises(TypeError, match="dtype"):
        flash_attention_tiled(q.half(), q.half(), q.half(), bias)
    wide = torch.randn(2, 1, 8, 512, device=cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_tiled(wide, wide, wide, bias)
    with pytest.raises(ValueError, match="kv_bias"):
        flash_attention_tiled(q, q, q, bias[:, :4])


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_tiled_gradient_matches_autograd_through_the_plain_version(cuda_device, causal):
    """At the slice's shape, B=32, H=2, L=1024, D=64, f32, with padded rows."""
    q, k, v, bias, _ = _tiled_case(32, 2, 1024, 64, torch.float32, cuda_device, 10)
    g = torch.randn(q.shape, device=cuda_device, generator=torch.Generator(cuda_device).manual_seed(11))
    leaves = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    before = flash_attention_tiled.launches
    out = flash_attention_tiled(*leaves, causal)
    assert flash_attention_tiled.launches == before + 1 and out.grad_fn is not None
    torch.sum(out * g).backward()
    plain = [t.clone().requires_grad_() for t in (q, k, v, bias)]
    torch.sum(flash_attention_tiled_reference(*plain, causal)[0] * g).backward()
    for a, b in zip(leaves, plain):
        assert torch.isfinite(a.grad).all()
        # 1e-4 of the largest magnitude (at least 1e-4): dbias sums over 1024 queries and 2 heads
        assert (a.grad - b.grad).abs().max().item() <= 1e-4 * max(1.0, b.grad.abs().max().item())


def _long_schema():
    return TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True,
            feature_hint=FeatureHint.ITEM_ID, cardinality=300, embedding_dim=32,
        )
    )


def test_bf16_training_on_the_tiled_route_launches_k5_per_block(cuda_device):
    """Trainer(precision="bf16") on SasRec(use_flash="tiled"): two K5 launches a
    step (one per block), f32 master parameters, every projection moves."""
    model = SasRec(
        _long_schema(), embedding_dim=32, num_blocks=2, num_heads=2, max_sequence_length=300,
        use_flash="tiled", device=cuda_device, generator=torch.Generator().manual_seed(12),
    )
    rng = np.random.default_rng(13)
    lengths = rng.integers(10, 301, 8)
    mask = np.arange(300)[None, :] >= 300 - lengths[:, None]
    items = rng.integers(0, 300, (8, 301)).astype(np.int32)
    batch = {
        "feature_tensors": {"item_id": np.where(mask, items[:, :-1], 300).astype(np.int32)},
        "padding_mask": mask, "positive_labels": items[:, 1:, None], "target_padding_mask": mask[:, :, None],
    }
    trainer = Trainer(model, CEFused(), precision="bf16", device=cuda_device)
    state = trainer.init_state(batch)
    start = state.flat_params.clone()
    launches = flash_attention_tiled.launches
    losses = []
    for _ in range(3):
        state, value = trainer.train_step(state, batch)
        losses.append(float(value))
    torch.cuda.synchronize()
    assert flash_attention_tiled.launches == launches + 6
    assert state.flat_params.dtype == torch.float32 and trainer.model.dtype == torch.bfloat16
    assert all(np.isfinite(losses)) and losses[-1] < losses[0] and int(state.bad_steps) == 0
    assert not torch.equal(state.flat_params, start)


def test_serving_on_the_tiled_kernel_matches_the_unfused_route(cuda_device):
    """ScoringEngine on SasRec(use_flash="tiled") vs use_flash=False, f32, same weights."""
    width = dict(embedding_dim=32, num_blocks=2, num_heads=2, max_sequence_length=300, device=cuda_device)
    tiled = SasRec(_long_schema(), use_flash="tiled", generator=torch.Generator().manual_seed(14), **width)
    plain = SasRec(_long_schema(), use_flash=False, **width)
    params = tiled.state_dict()
    buckets = dict(length_buckets=(64, 300), batch_buckets=(1, 4), device=cuda_device)
    engines = ScoringEngine(tiled, params, **buckets), ScoringEngine(plain, params, **buckets)
    rng = np.random.default_rng(15)
    windows = [make_window(list(rng.integers(0, 300, n)), 300) for n in (0, 1, 50, 400)]
    ids, mask = np.stack([w[0] for w in windows]), np.stack([w[1] for w in windows])
    before = flash_attention_tiled.launches
    (got, got_hidden), (want, want_hidden) = (e.encode(300, ids, mask) for e in engines)
    assert flash_attention_tiled.launches == before + 2  # one launch per block
    assert (got - want).abs().max().item() <= 1e-4
    assert (got_hidden - want_hidden).abs().max().item() <= 1e-4


# --------------------------------------------------------------------------- #
# K5's mma variant (bf16, tensor cores) and K4 at short and long windows
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("length", [1000, 77])
@pytest.mark.parametrize("dim", [32, 48, 64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_tiled_mma_matches_plain_version(cuda_device, length, dim, causal):
    """bf16 at L not a multiple of 64, every D the mma variant takes, the
    served padding (left-padded lengths) and one fully padded row."""
    q, k, v, bias, _ = _tiled_case(4, 2, length, dim, torch.bfloat16, cuda_device, length * dim)
    assert flash_tiled._variant(q.dtype, dim) == "mma"
    before = dict(flash_attention_tiled.launches_by_variant)
    out, lse = flash_tiled._launch(q, k, v, bias, causal)
    torch.cuda.synchronize()
    assert flash_attention_tiled.launches_by_variant["mma"] == before["mma"] + 1
    assert flash_attention_tiled.launches_by_variant["simt"] == before["simt"]
    want, want_lse = flash_attention_tiled_reference(q.float(), k.float(), v.float(), bias, causal)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all() and torch.isfinite(lse).all()
    assert (out.float() - want).abs().max().item() <= TOL[torch.bfloat16]
    assert torch.allclose(lse, want_lse, rtol=1e-5, atol=1e-5)
    assert torch.equal(out[-1].float(), torch.zeros_like(out[-1].float()))
    assert torch.equal(lse[-1], torch.full_like(lse[-1], NEG_INF))


@pytest.mark.parametrize("dim", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_tiled_mma_skips_padding_tiles_without_changing_the_result(cuda_device, dim, causal):
    """All-padding key tiles at the start, in the middle and at the end of a
    row: the mma variant skips them, and matches the plain version and a run
    where the same keys carry a bias just above the skip threshold."""
    q, k, v, _, _ = _tiled_case(3, 2, 300, dim, torch.bfloat16, cuda_device, 17 + dim, dead_row=False)
    padding = torch.ones(3, 300, dtype=torch.bool, device=cuda_device)
    padding[0, :128] = False
    padding[1, 64:192] = False
    padding[1, 256:] = False
    padding[2, :250] = False
    bias = padding_mask_bias(padding)
    got, lse = flash_tiled._launch(q, k, v, bias, causal)
    want, want_lse = flash_attention_tiled_reference(q.float(), k.float(), v.float(), bias, causal)
    assert (got.float() - want).abs().max().item() <= TOL[torch.bfloat16]
    assert torch.allclose(lse, want_lse, rtol=1e-5, atol=1e-5)
    # the same keys visited, not skipped: a bias of 0.9 * NEG_INF still gives them probability 0
    visited = torch.where(padding, 0.0, 0.9 * NEG_INF).to(torch.float32)
    again, again_lse = flash_tiled._launch(q, k, v, visited, causal)
    assert torch.equal(again, got) and torch.allclose(again_lse, lse, rtol=1e-6, atol=0)


def test_flash_tiled_mma_keeps_p_at_f32_precision(cuda_device):
    """Two live keys whose unnormalised probabilities are 1 and about 0.99, V
    entries of +256 and -256: the output is a small difference of large
    products. The kernel must match the f32 plain version within the output's
    bf16 rounding plus the hi + lo pair's error, and P rounded to bf16 must not."""
    length, dim = 64, 64
    rng = np.random.default_rng(21)
    # row r's scores: 0 for key 0 and -c_r / 100 for key 1 (q's first column c_r * 8, k's -1/100 and 0)
    scales = torch.tensor(rng.uniform(0.5, 2.0, length).astype(np.float32))
    q = torch.zeros(1, 1, length, dim)
    q[0, 0, :, 0] = scales * 8
    k = torch.zeros(1, 1, length, dim)
    k[0, 0, 1, 0] = -0.01
    signs = torch.tensor(np.where(rng.random(dim) < 0.5, -1.0, 1.0).astype(np.float32))
    v = torch.zeros(1, 1, length, dim)
    v[0, 0, 0] = 256 * signs
    v[0, 0, 1] = -256 * signs
    q, k, v = (t.to(cuda_device, torch.bfloat16) for t in (q, k, v))
    padding = torch.zeros(1, length, dtype=torch.bool, device=cuda_device)
    padding[0, :2] = True
    bias = padding_mask_bias(padding)
    assert flash_tiled._variant(q.dtype, dim) == "mma"
    got, _ = flash_tiled._launch(q, k, v, bias, False)
    want, _ = flash_attention_tiled_reference(q.float(), k.float(), v.float(), bias, False)
    # P rounded to bf16 before the product, from the plain version's own scores
    s = q.float()[0, 0] @ k.float()[0, 0].T / 8 + bias[0]
    p = torch.where(s <= NEG_INF / 2, 0.0, torch.exp(s - s.amax(dim=-1, keepdim=True)))
    rounded = (p.to(torch.bfloat16).float() @ v.float()[0, 0]) / p.sum(dim=-1, keepdim=True)
    products = (p @ v.float()[0, 0].abs()) / p.sum(dim=-1, keepdim=True)
    limit = (want[0, 0].abs() * 2**-8 + products * 2**-15).max().item()
    err = (got.float() - want).abs().max().item()
    rounded_err = (rounded - want[0, 0]).abs().max().item()
    assert err <= limit, (err, limit)
    assert rounded_err > limit, (rounded_err, limit)


@pytest.mark.parametrize("length", [16, 50, 130, 200, 1024])
@pytest.mark.parametrize("bias_heads", [1, 2])
@pytest.mark.parametrize("mask", ["-inf", "finfo.min", "-1e30"])
def test_flash_attention_short_and_long_windows(cuda_device, length, bias_heads, mask):
    """K4 at serving (16, 50), from_params (200) and long (1024) windows, and at
    130 (one pass, six keys a lane), a bias per head or shared, each of the
    three masks the callers write, and a row whose every entry is masked (the
    diagonal rescue is not applied here)."""
    neg = {"-inf": float("-inf"), "finfo.min": torch.finfo(torch.float32).min, "-1e30": -1e30}[mask]
    rng = np.random.default_rng(length + bias_heads)
    batch, heads, dim = 3, 2, 64
    q, k, v = (
        torch.tensor(rng.normal(size=(batch, heads, length, dim)).astype(np.float32)).to(cuda_device)
        for _ in range(3)
    )
    lengths = rng.integers(1, length + 1, batch)
    padding = np.arange(length)[None, :] >= length - lengths[:, None]
    allowed = np.tril(np.ones((length, length), bool))[None] & padding[:, None, :]
    allowed |= np.eye(length, dtype=bool)[None]
    bias = np.where(allowed, 0.0, neg).astype(np.float32)[:, None].repeat(bias_heads, axis=1)
    if bias_heads > 1:
        bias = bias + np.where(allowed[:, None], rng.normal(size=bias.shape), 0.0).astype(np.float32)
    if mask != "-inf":
        bias[1, :, length // 2] = neg  # one row with every entry masked: softmax of equal scores
    bias = torch.tensor(bias, device=cuda_device)
    got = flash_attention(q, k, v, bias)
    want = flash_attention_reference(q, k, v, bias)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= TOL[torch.float32]
    if mask != "-inf":  # -1e30 and finfo.min absorb the scores: the mean of V
        assert (got[1, :, length // 2] - v[1].mean(dim=1)).abs().max().item() <= 1e-5


@pytest.mark.parametrize("length", [16, 50, 130, 200, 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_head_dim_48(cuda_device, length, dtype):
    """D=48, not a multiple of 32: the lanes past D hold no column."""
    rng = np.random.default_rng(length)
    q, k, v = (
        torch.tensor(rng.normal(size=(2, 4, length, 48)).astype(np.float32)).to(cuda_device, dtype) for _ in range(3)
    )
    padding = torch.tensor(_left_padded(2, length, 3), device=cuda_device)
    bias = causal_attention_mask(padding, deterministic=True) + torch.randn(2, 4, length, length, device=cuda_device)
    got = flash_attention(q, k, v, bias)
    want = flash_attention_reference(q.float(), k.float(), v.float(), bias)
    assert got.dtype == dtype and (got.float() - want).abs().max().item() <= TOL[dtype]


@pytest.mark.parametrize("batch", [1, 8, 64])
def test_flash_attention_serving_buckets(cuda_device, batch):
    """The serving buckets B=1, 8, 64 at L=50 (4 or 16 rows a block), and a
    misaligned view, which the wrapper copies to a 16-byte boundary."""
    rng = np.random.default_rng(batch)
    flat = torch.tensor(rng.normal(size=3 * batch * 50 * 64 + 1).astype(np.float32), device=cuda_device)
    q, k, v = (flat[1 + i * batch * 3200 : 1 + (i + 1) * batch * 3200].view(batch, 1, 50, 64) for i in range(3))
    assert q.data_ptr() % 16 != 0
    bias = causal_attention_mask(torch.tensor(_left_padded(batch, 50, 4), device=cuda_device), deterministic=True)
    got = flash_attention(q, k, v, bias)
    want = flash_attention_reference(q, k, v, bias)
    assert (got - want).abs().max().item() <= TOL[torch.float32]


# --------------------------------------------------------------------------- #
# K5's tf32x3 variant (f32, TF32 tensor cores) and K3's tf32 variant
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("length", [1000, 77])
@pytest.mark.parametrize("dim", [32, 48, 64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_tiled_tf32x3_matches_plain_version(cuda_device, length, dim, causal):
    """f32 at L not a multiple of 64, every D the tf32x3 variant takes at each
    of its three widths, the served padding and one fully padded row."""
    q, k, v, bias, _ = _tiled_case(4, 2, length, dim, torch.float32, cuda_device, length * dim + 1)
    assert flash_tiled._variant(q.dtype, dim) == "tf32x3"
    before = dict(flash_attention_tiled.launches_by_variant)
    out, lse = flash_tiled._launch(q, k, v, bias, causal)
    torch.cuda.synchronize()
    assert flash_attention_tiled.launches_by_variant == {
        key: count + (key == "tf32x3") for key, count in before.items()
    }
    want, want_lse = flash_attention_tiled_reference(q, k, v, bias, causal)
    assert out.dtype == torch.float32 and torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert (out - want).abs().max().item() <= TOL[torch.float32]
    assert torch.allclose(lse, want_lse, rtol=1e-5, atol=1e-5)
    assert torch.equal(out[-1], torch.zeros_like(out[-1]))
    assert torch.equal(lse[-1], torch.full_like(lse[-1], NEG_INF))


@pytest.mark.parametrize("dim", [32, 64, 128])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_tiled_tf32x3_skips_padding_tiles_without_changing_the_result(cuda_device, dim, causal):
    """All-padding key tiles at the start, in the middle and at the end of a
    row: the tf32x3 variant skips them, and matches the plain version and a run
    where the same keys carry a bias just above the skip threshold."""
    q, k, v, _, _ = _tiled_case(3, 2, 300, dim, torch.float32, cuda_device, 27 + dim, dead_row=False)
    padding = torch.ones(3, 300, dtype=torch.bool, device=cuda_device)
    padding[0, :128] = False
    padding[1, 64:192] = False
    padding[1, 256:] = False
    padding[2, :250] = False
    bias = padding_mask_bias(padding)
    got, lse = flash_tiled._launch(q, k, v, bias, causal)
    want, want_lse = flash_attention_tiled_reference(q, k, v, bias, causal)
    assert (got - want).abs().max().item() <= TOL[torch.float32]
    assert torch.allclose(lse, want_lse, rtol=1e-5, atol=1e-5)
    visited = torch.where(padding, 0.0, 0.9 * NEG_INF).to(torch.float32)
    again, again_lse = flash_tiled._launch(q, k, v, visited, causal)
    assert torch.equal(again, got) and torch.allclose(again_lse, lse, rtol=1e-6, atol=0)


def test_flash_tiled_tf32x3_keeps_f32_precision(cuda_device):
    """The TF32 probe (``tf32_probes.k5_probe``): the kernel within 1e-5 of the
    f32 plain version, where a K5 with any one operand in one TF32 part
    (emulated) is not."""
    q, k, v, padding = tf32_probes.k5_probe()
    exact = tf32_probes.k5_emulated(q, k, v, padding)
    one_term = min(
        np.abs(tf32_probes.k5_emulated(q, k, v, padding, lo=tuple(set(tf32_probes.K5_OPERANDS) - {name})) - exact).max()
        for name in tf32_probes.K5_OPERANDS
    )
    qt, kt, vt = (torch.tensor(t, device=cuda_device) for t in (q, k, v))
    bias = padding_mask_bias(torch.tensor(padding, device=cuda_device))
    assert flash_tiled._variant(qt.dtype, qt.shape[-1]) == "tf32x3"
    got, _ = flash_tiled._launch(qt, kt, vt, bias, False)
    want, _ = flash_attention_tiled_reference(qt, kt, vt, bias, False)
    err = (got - want).abs().max().item()
    assert err <= tf32_probes.K5_LIMIT < one_term, (err, one_term)


def test_fused_ce_k3_tf32_keeps_f32_precision(cuda_device):
    """The TF32 probe (``tf32_probes.k3_probe``): K3 within 1e-4 of the largest
    |dW| of its f32 plain version, where a K3 with any one operand (h, W or
    the softmax weights) in one TF32 part (emulated) is not; four row splits
    added by the second pass."""
    h, table, g = tf32_probes.k3_probe()
    exact = tf32_probes.k3_emulated(h, table, g)
    one_term = min(
        np.abs(tf32_probes.k3_emulated(h, table, g, lo=tuple(set(tf32_probes.K3_OPERANDS) - {name})) - exact).max()
        for name in tf32_probes.K3_OPERANDS
    )
    ht, wt, gt = (torch.tensor(t, device=cuda_device) for t in (h, table, g))
    assert fused_ce._dw_variant(ht.shape[1]) == "tf32"
    assert fused_ce.dw_row_split(*ht.shape[:1], *wt.shape, "tf32")[0] == 4
    lse = fused_ce.fused_lse_reference(ht, wt)
    got = fused_ce.fused_lse_dw(ht, wt, gt, lse)
    want = fused_ce.fused_lse_dw_reference(ht, wt, gt, lse)
    limit = tf32_probes.K3_LIMIT * want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= limit < one_term, (err, limit, one_term)


@pytest.mark.parametrize(
    "kernel,dtype", [("K5", torch.float32), ("K3", torch.float32), ("K3", torch.bfloat16)],
    ids=["k5_tf32x3", "k3_tf32_f32", "k3_tf32_bf16_hidden"],
)
def test_tf32_kernels_are_the_same_from_run_to_run(cuda_device, kernel, dtype):
    """At the long-sequence width: K5 tf32x3 at B=32 H=2 L=1024 D=64 causal, K3
    at N=32,768 E=128 against the 3,706-item table (f32, and bf16 hidden
    states), the same bits twice."""
    gen = torch.Generator(cuda_device).manual_seed(23)
    if kernel == "K5":
        q, k, v = (torch.randn(32, 2, 1024, 64, device=cuda_device, generator=gen) for _ in range(3))
        bias = torch.zeros(32, 1024, device=cuda_device)
        assert flash_tiled._variant(q.dtype, 64) == "tf32x3"
        first, second = (flash_tiled._launch(q, k, v, bias, True) for _ in range(2))
        assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])
        return
    hidden = torch.randn(32768, 128, device=cuda_device, generator=gen).to(dtype)
    table = torch.randn(3706, 128, device=cuda_device, generator=gen) / 128**0.5
    grad = torch.randn(32768, device=cuda_device, generator=gen)
    assert fused_ce._dw_variant(128) == "tf32"
    lse = fused_ce.fused_lse_forward(hidden, table)
    assert torch.equal(fused_ce.fused_lse_dw(hidden, table, grad, lse), fused_ce.fused_lse_dw(hidden, table, grad, lse))


@pytest.mark.parametrize(
    "rows,items,dim,num_valid",
    [(25600, 3706, 64, None), (32768, 3706, 128, None), (1000, 1000, 128, 900), (300, 1000, 32, 0),
     (130, 77, 40, 50), (5, 3, 8, None)],
    ids=["train_width", "longseq_width", "ragged_e128", "fully_masked_e32", "e40", "tiny"],
)
@pytest.mark.parametrize(
    "hidden_dtype,table_dtype",
    [(torch.float32, torch.float32), (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16),
     (torch.float32, torch.bfloat16)],
    ids=["f32", "bf16_hidden", "bf16_both", "bf16_table"],
)
def test_fused_ce_k1_k2_tf32_match_plain_versions(cuda_device, rows, items, dim, num_valid, hidden_dtype, table_dtype):
    """K1 and K2 on their tf32 variant, every pair of input types the wrappers
    take, rows and items not multiples of 64, masked columns, a fully masked
    table, E below its instantiation's width (40 on the 64-wide one) and f32
    h and W at E=128 (the instantiation that streams 32 items a tile)."""
    gen = torch.Generator(cuda_device).manual_seed(rows + dim)
    hidden = torch.randn(rows, dim, device=cuda_device, generator=gen).to(hidden_dtype)
    table = (torch.randn(items, dim, device=cuda_device, generator=gen) / dim**0.5).to(table_dtype)
    grad = torch.randn(rows, device=cuda_device, generator=gen)
    assert fused_ce._variant(dim) == "tf32"
    counters = (fused_ce.fused_lse_forward, fused_ce.fused_lse_dh)
    before = [dict(c.launches_by_variant) for c in counters]
    lse = fused_ce.fused_lse_forward(hidden, table, num_valid)
    dh = fused_ce.fused_lse_dh(hidden, table, grad, lse, num_valid)
    torch.cuda.synchronize()
    assert [c.launches_by_variant for c in counters] == [{**b, "tf32": b["tf32"] + 1} for b in before]
    assert lse.dtype == torch.float32 and dh.dtype == hidden_dtype
    h32, w32 = hidden.float(), table.float()
    want_lse = fused_ce.fused_lse_reference(h32, w32, num_valid)
    want_dh = fused_ce.fused_lse_dh_reference(h32, w32, grad, lse, num_valid)
    assert torch.isfinite(lse).all() and torch.isfinite(dh.float()).all()
    if num_valid == 0:  # every column masked: finite, at the mask
        assert torch.allclose(lse, torch.full_like(lse, -1e30), rtol=1e-6)
    assert torch.allclose(lse, want_lse, rtol=1e-6, atol=1e-4)
    dh_tol = (2**-8 if hidden_dtype == torch.bfloat16 else 1e-4) * want_dh.abs().max().item()
    assert (dh.float() - want_dh).abs().max().item() <= dh_tol


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_fused_ce_k1_k2_tf32_keep_f32_precision(cuda_device, kernel):
    """The TF32 probe (``tf32_probes.lse_probe``): K1 within 1e-4 of the f32
    plain version's lse, K2 within 1e-4 of its largest |dh|, where a kernel
    with any one operand (h, W, or K2's weights P) in one TF32 part (emulated)
    is not."""
    h, table, g = tf32_probes.lse_probe()
    ht, wt, gt = (torch.tensor(t, device=cuda_device) for t in (h, table, g))
    assert fused_ce._variant(ht.shape[1]) == "tf32"
    want_lse = fused_ce.fused_lse_reference(ht, wt)
    if kernel == "K1":
        exact = tf32_probes.k1_emulated(h, table)
        one_term = min(
            np.abs(tf32_probes.k1_emulated(h, table, lo=tuple(set(tf32_probes.K1_OPERANDS) - {name})) - exact).max()
            for name in tf32_probes.K1_OPERANDS
        )
        err = (fused_ce.fused_lse_forward(ht, wt) - want_lse).abs().max().item()
        limit = tf32_probes.K1_LIMIT
    else:
        exact = tf32_probes.k2_emulated(h, table, g)
        one_term = min(
            np.abs(tf32_probes.k2_emulated(h, table, g, lo=tuple(set(tf32_probes.K2_OPERANDS) - {name})) - exact).max()
            for name in tf32_probes.K2_OPERANDS
        )
        want = fused_ce.fused_lse_dh_reference(ht, wt, gt, want_lse)
        err = (fused_ce.fused_lse_dh(ht, wt, gt, want_lse) - want).abs().max().item()
        limit = tf32_probes.K2_LIMIT * want.abs().max().item()
    assert err <= limit < one_term, (err, limit, one_term)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16_hidden"])
def test_k1_k2_tf32_are_the_same_from_run_to_run(cuda_device, dtype):
    """K1 and K2 tf32 at the long-sequence width (N=32,768, E=128, the
    3,706-item table; f32, and bf16 hidden states): the same bits twice."""
    gen = torch.Generator(cuda_device).manual_seed(29)
    hidden = torch.randn(32768, 128, device=cuda_device, generator=gen).to(dtype)
    table = torch.randn(3706, 128, device=cuda_device, generator=gen) / 128**0.5
    grad = torch.randn(32768, device=cuda_device, generator=gen)
    assert fused_ce._variant(128) == "tf32"
    lse = fused_ce.fused_lse_forward(hidden, table)
    assert torch.equal(lse, fused_ce.fused_lse_forward(hidden, table))
    assert torch.equal(fused_ce.fused_lse_dh(hidden, table, grad, lse), fused_ce.fused_lse_dh(hidden, table, grad, lse))


@pytest.mark.parametrize("dim", [64, 100], ids=["tf32", "simt"])
def test_fused_lse_forward_carries_a_nan_logit_to_lse(cuda_device, dim):
    """A NaN in one row of h makes that row's lse NaN, on either variant, and
    leaves the other rows as they were."""
    gen = torch.Generator(cuda_device).manual_seed(31)
    hidden = torch.randn(200, dim, device=cuda_device, generator=gen)
    table = torch.randn(300, dim, device=cuda_device, generator=gen) / dim**0.5
    clean = fused_ce.fused_lse_forward(hidden, table)
    hidden[70, 3] = float("nan")
    got = fused_ce.fused_lse_forward(hidden, table)
    assert torch.isnan(got[70]) and torch.isfinite(got[torch.arange(200, device=cuda_device) != 70]).all()
    assert torch.equal(got[:64], clean[:64]) and torch.equal(got[128:], clean[128:])


# --------------------------------------------------------------------------- #
# CUDA graphs: the kernels captured and replayed, counted per replay
# --------------------------------------------------------------------------- #
def _kernel_calls(device):
    """(name, wrapper whose count moves, call) for K1-K5 at small shapes."""
    gen = torch.Generator(device).manual_seed(41)
    q, k, v = (torch.randn(8, 2, 50, 32, device=device, generator=gen) for _ in range(3))
    bias = causal_attention_mask(torch.tensor(_left_padded(8, 50, 42), device=device), deterministic=True)
    tq, tk, tv = (torch.randn(4, 2, 300, 64, device=device, generator=gen).to(torch.bfloat16) for _ in range(3))
    kv_bias = padding_mask_bias(torch.tensor(_left_padded(4, 300, 43), device=device))
    hidden = torch.randn(500, 64, device=device, generator=gen)
    table = torch.randn(700, 64, device=device, generator=gen) / 8
    grad = torch.randn(500, device=device, generator=gen)
    lse = fused_ce.fused_lse_forward(hidden, table)
    return [
        ("K4", flash_attention, lambda: flash_attention(q, k, v, bias)),
        ("K5", flash_attention_tiled, lambda: flash_attention_tiled(tq, tk, tv, kv_bias)),
        ("K1", fused_ce.fused_lse_forward, lambda: fused_ce.fused_lse_forward(hidden, table)),
        ("K2", fused_ce.fused_lse_dh, lambda: fused_ce.fused_lse_dh(hidden, table, grad, lse)),
        ("K3", fused_ce.fused_lse_dw, lambda: fused_ce.fused_lse_dw(hidden, table, grad, lse)),
    ]


def test_each_kernel_replays_bitwise_and_counts_per_replay(cuda_device):
    """K1-K5 captured in a graph: each replay writes the eager launch's bits,
    the capture itself counts only its warm-up launch, and every replay counts one."""
    from replay_tpu_torch.nn.graphs import capture

    for name, wrapper, call in _kernel_calls(cuda_device):
        eager = call()
        before = wrapper.launches
        graph, out = capture(call, cuda_device)
        assert wrapper.launches == before + 1, name  # the warm-up ran eagerly
        assert len(graph.launches) == 1 and graph.launches[0][0] is wrapper, name
        out.zero_()
        for replay in range(3):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, eager), name
            assert wrapper.launches == before + 2 + replay, name


def test_a_kernel_error_inside_a_capture_raises(cuda_device):
    """A launch the card refuses (grid.z = 70,000 > 65,535 batches) raises
    through the capture; nothing runs eagerly instead, and capturing works after."""
    from replay_tpu_torch.nn.graphs import capture

    name, wrapper, call = _kernel_calls(cuda_device)[0]
    call()  # built and loaded before the capture
    q = torch.randn(70_000, 1, 1, 8, device=cuda_device)
    bias = torch.zeros(70_000, 1, 1, 1, device=cuda_device)
    before = flash_attention.launches
    with pytest.raises(RuntimeError):
        capture(lambda: flash_attention(q, q, q, bias), cuda_device, warmup=lambda: None)
    assert flash_attention.launches == before
    graph, out = capture(call, cuda_device)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, call())


@pytest.mark.parametrize("use_flash", [True, "tiled"], ids=["K4", "K5"])
def test_exported_programs_keep_the_kernel_operators(cuda_device, use_flash):
    """CompiledInference on the card: replays bitwise equal to the eager
    program, and the serialized form's programs hold K4 / K5 as
    ``replay_tpu_torch::`` operators that launch the kernels when loaded."""
    from replay_tpu_torch.nn.compiled import CompiledInference

    model = SasRec(
        _long_schema(), embedding_dim=32, num_blocks=2, num_heads=2, max_sequence_length=64,
        use_flash=use_flash, device=cuda_device, generator=torch.Generator().manual_seed(44),
    )
    params = model.state_dict()
    compiled = CompiledInference.compile(
        model, params, 64, mode="dynamic_batch_size", dynamic_buckets=(1, 8), outputs="both", device=cuda_device,
    )
    payload = compiled.serialize()
    op = b"flash_attention_forward" if use_flash is True else b"flash_attention_tiled_forward"
    assert op in payload
    served = CompiledInference.deserialize(payload, device=cuda_device)
    wrapper = flash_attention if use_flash is True else flash_attention_tiled
    rng = np.random.default_rng(45)
    for rows in (1, 5, 8):
        mask = _left_padded(rows, 64, rows)
        mask[-1, -1] = True
        ids = np.where(mask, rng.integers(0, 300, (rows, 64)), 0).astype(np.int32)
        before = wrapper.launches
        got = served(ids, mask)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 2  # one replay, two blocks
        want = compiled(ids, mask)
        bucket = 8 if rows > 1 else 1
        padded = (torch.as_tensor(np.concatenate([x, np.repeat(x[:1], bucket - rows, 0)]), device=cuda_device) for x in (ids, mask))
        eager = compiled._compiled[bucket](params, *padded, None)  # the eager bound program
        for a, b, c in zip(got, want, eager):
            assert torch.equal(a, b) and torch.equal(b, c[:rows])


def test_train_steps_graph_equals_the_eager_steps(cuda_device):
    """Trainer.train_steps on the card (one graph of K steps) against K
    train_step calls from the same weights: the same losses and parameters, bit for bit."""
    model = SasRec(
        _long_schema(), embedding_dim=32, num_blocks=2, num_heads=2, max_sequence_length=50,
        use_flash=True, dropout_rate=0.0, device=cuda_device, generator=torch.Generator().manual_seed(46),
    )
    initial = {name: value.detach().clone() for name, value in model.state_dict().items()}
    rng = np.random.default_rng(47)
    batches = []
    for _ in range(4):
        items = rng.integers(0, 300, (16, 51)).astype(np.int32)
        mask = np.ones((16, 50), bool)
        batches.append({
            "feature_tensors": {"item_id": items[:, :-1]}, "padding_mask": mask,
            "positive_labels": items[:, 1:, None], "target_padding_mask": mask[:, :, None],
        })
    trainer = Trainer(model, CEFused(), device=cuda_device)
    eager = trainer.init_state(batches[0], params=initial)
    want = [float(trainer.train_step(eager, batch)[1]) for batch in batches]
    want_params = eager.flat_params.clone()
    state = trainer.init_state(batches[0], params=initial)
    before = {fn: fn.launches for fn in (flash_attention, fused_ce.fused_lse_forward)}
    state, losses = trainer.train_steps(state, batches)
    assert trainer.capture_warmups == 1
    assert losses.tolist() == want and torch.equal(state.flat_params, want_params)
    # the warm-up step and the four replayed steps
    assert flash_attention.launches == before[flash_attention] + 2 * 5
    assert fused_ce.fused_lse_forward.launches == before[fused_ce.fused_lse_forward] + 5


# --------------------------------------------------------------------------- #
# K4 on the BERT4Rec and TwoTower paths; their trainers and serving on graphs
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize(
    "batch,heads,length,dim,bidirectional",
    [(512, 4, 100, 75, True), (512, 2, 50, 32, False), (3, 4, 37, 75, True), (2, 3, 100, 75, False),
     (32, 2, 50, 32, False)],
    ids=["bert4rec", "twotower", "d75_short", "d75_causal", "notebook"],
)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("deterministic", [True, False], ids=["eval_mask", "train_mask"])
def test_flash_attention_at_the_model_widths(cuda_device, batch, heads, length, dim, bidirectional, dtype, deterministic):
    """BERT4Rec's D=75 (no multiple of 4: Q, K and V staged by scalar loads,
    rows at a 300-byte stride; in bf16 at 150 bytes) with its padding-only
    mask, one bias head for all heads, TwoTower's D=32 causal, and notebook
    09's SASRec (batch 32, 2 heads of E=64, L=50) causal."""
    from replay_tpu_torch.nn.mask import bidirectional_attention_mask

    rng = np.random.default_rng(dim + length)
    q, k, v = (
        torch.tensor(rng.normal(size=(batch, heads, length, dim)).astype(np.float32)).to(cuda_device, dtype)
        for _ in range(3)
    )
    padding = torch.tensor(_left_padded(batch, length, 5), device=cuda_device)
    make_mask = bidirectional_attention_mask if bidirectional else causal_attention_mask
    bias = make_mask(padding, deterministic=deterministic)
    got = flash_attention(q, k, v, bias)
    want = flash_attention_reference(q.float(), k.float(), v.float(), bias)
    assert got.dtype == dtype and torch.isfinite(got.float()).all()
    assert (got.float() - want).abs().max().item() <= TOL[dtype]


def _model_schema(kind):
    return TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
            cardinality=300, embedding_dim=60 if kind == "bert4rec" else 32,
        )
    )


def _model(kind, device, use_flash=True, seed=0):
    """BERT4Rec at D=15 (4 heads of E=60) or TwoTower at D=16, 2 blocks, L=20."""
    from replay_tpu_torch.nn.sequential import Bert4Rec, TwoTower

    schema = _model_schema(kind)
    width = dict(num_blocks=2, max_sequence_length=20, device=device, generator=torch.Generator().manual_seed(seed))
    if kind == "bert4rec":
        return Bert4Rec(schema, embedding_dim=60, num_heads=4, use_flash=use_flash, **width)
    return TwoTower(schema, embedding_dim=32, num_heads=2, use_flash=use_flash, **width)


def _model_batches(kind, count):
    from replay_tpu_torch.nn.transform import Compose, make_default_bert4rec_transforms, make_default_twotower_transforms

    schema = _model_schema(kind)
    batches = []
    for seed in range(count):
        rng = np.random.default_rng(seed)
        if kind == "bert4rec":
            items = rng.integers(0, 300, (16, 20)).astype(np.int32)
            pipeline = Compose(make_default_bert4rec_transforms(schema, mask_prob=0.2)["train"])
            batches.append(pipeline({"item_id": items, "item_id_mask": np.ones_like(items, bool)},
                                    torch.Generator().manual_seed(seed)))
        else:
            items = rng.integers(0, 300, (16, 21)).astype(np.int32)
            pipeline = Compose(make_default_twotower_transforms(schema)["train"])
            batches.append(pipeline({"item_id": items, "item_id_mask": np.ones_like(items, bool)}))
    return batches


@pytest.mark.parametrize("kind", ["bert4rec", "twotower"])
def test_model_train_steps_on_a_graph_match_the_per_step_path(cuda_device, kind):
    """K masked-LM (BERT4Rec, ``CE``) or in-batch (TwoTower, ``CESampled``)
    steps as one CUDA graph, bitwise equal to K ``train_step``s where two
    per-step runs are; K4 launched once a block a step, the capture's warm-up
    step included."""
    from replay_tpu_torch.nn.loss import CE, CESampled

    batches = _model_batches(kind, 4)
    initial = {name: value.detach().clone() for name, value in _model(kind, cuda_device).state_dict().items()}
    runs = []
    for _ in range(2):
        trainer = Trainer(_model(kind, cuda_device), CE() if kind == "bert4rec" else CESampled(), device=cuda_device)
        state = trainer.init_state(batches[0], params=initial)
        losses = torch.stack([trainer.train_step(state, batch)[1] for batch in batches])
        runs.append((losses, state.flat_params.clone()))
    deterministic = torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    trainer = Trainer(_model(kind, cuda_device), CE() if kind == "bert4rec" else CESampled(), device=cuda_device)
    state = trainer.init_state(batches[0], params=initial)
    flash_attention.launches = 0
    state, losses = trainer.train_steps(state, batches)
    torch.cuda.synchronize()
    assert flash_attention.launches == 2 * (len(batches) + 1) and trainer.capture_warmups == 1
    state, again = trainer.train_steps(state, batches)  # a replay
    assert flash_attention.launches == 2 * (2 * len(batches) + 1) and np.isfinite(again).all()
    if deterministic:
        fresh = Trainer(_model(kind, cuda_device), CE() if kind == "bert4rec" else CESampled(), device=cuda_device)
        fresh_state = fresh.init_state(batches[0], params=initial)
        _, graph_losses = fresh.train_steps(fresh_state, batches)
        assert np.array_equal(graph_losses, runs[0][0].cpu().numpy())
        assert torch.equal(fresh_state.flat_params, runs[0][1])


@pytest.mark.parametrize("kind", ["bert4rec", "twotower"])
def test_model_serving_buckets_on_graphs(cuda_device, kind):
    """``CompiledInference`` in the ``"logits"`` mode: each bucket's replay
    bitwise equal to the eager bound program (BERT4Rec's shift inside the
    graph), K4 once a block a replay."""
    from replay_tpu_torch.nn.compiled import CompiledInference, as_device_tensor, pad_rows

    model = _model(kind, cuda_device)
    params = model.state_dict()
    compiled = CompiledInference.compile(
        model, params, 20, mode="dynamic_batch_size", dynamic_buckets=(1, 8, 64), device=cuda_device
    )
    rng = np.random.default_rng(1)
    for bucket in (1, 8, 64):
        for rows in sorted({bucket, max(1, bucket - 3)}):
            windows = [make_window(list(rng.integers(0, 300, int(rng.integers(1, 30)))), 20) for _ in range(rows)]
            ids, mask = np.stack([w[0] for w in windows]), np.stack([w[1] for w in windows])
            before = flash_attention.launches
            got = compiled(ids, mask)
            torch.cuda.synchronize()
            assert flash_attention.launches - before == 2
            want = compiled._compiled[bucket](
                params, pad_rows(as_device_tensor(ids, torch.int32, cuda_device), bucket),
                pad_rows(as_device_tensor(mask, torch.bool, cuda_device), bucket), None,
            )[:rows]
            assert torch.equal(got, want) and got.shape == (rows, 300)
    compiled.close()


# --------------------------------------------------------------------------- #
# Dropout inside a captured chunk
# --------------------------------------------------------------------------- #
def _dropout_trainer(device, initial=None):
    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
            cardinality=300, embedding_dim=32,
        )
    )
    model = SasRec(
        schema, embedding_dim=32, num_blocks=2, num_heads=2, max_sequence_length=12, use_flash=True,
        dropout_rate=0.3, device=device, generator=torch.Generator().manual_seed(3),
    )
    from replay_tpu_torch.nn.loss import CE

    trainer = Trainer(model, CE(), device=device)
    return trainer, trainer.init_state(None, params=initial)


def _state_tensors(state):
    return [state.flat_params, *(t for link in state.opt_state for t in link.values()), state.bad_steps]


def test_dropout_chunk_graph_equals_k_steps_and_its_masks_advance(cuda_device, tmp_path):
    """Dropout 0.3: one replay of a K-step graph equals K ``train_step``s
    bit for bit (losses, parameters, optimizer state, ``rng``); replays from
    the same parameters draw other masks as the stream advances, and a
    replay that reuses one stream position (a chunk replaying a fixed mask)
    is caught by that check; a checkpoint restores the stream."""
    from replay_tpu_torch.nn.train import _clone_state
    from replay_tpu_torch.utils.checkpoint import restore_pytree, save_pytree

    rng = np.random.default_rng(4)
    batches = []
    for _ in range(4):
        items = rng.integers(0, 300, (16, 13)).astype(np.int32)
        mask = np.ones((16, 12), bool)
        batches.append({
            "feature_tensors": {"item_id": items[:, :-1]}, "padding_mask": mask,
            "positive_labels": items[:, 1:, None], "target_padding_mask": mask[:, :, None],
        })
    first, _ = _dropout_trainer(cuda_device)
    initial = {name: value.detach().clone() for name, value in first.model.state_dict().items()}
    runs = []
    for _ in range(2):
        trainer, state = _dropout_trainer(cuda_device, initial)
        losses = torch.stack([trainer.train_step(state, b)[1] for b in batches])
        runs.append((losses.cpu().numpy(), _clone_state(state)))
    assert np.array_equal(runs[0][0], runs[1][0]), "the per-step path is not repeatable"
    trainer, state = _dropout_trainer(cuda_device, initial)
    start = _clone_state(state)
    _, graph_losses = trainer.train_steps(state, batches)
    assert np.array_equal(graph_losses, runs[0][0])
    want = runs[0][1]
    assert state.step == want.step and torch.equal(state.rng, want.rng)
    for got, ref in zip(_state_tensors(state), _state_tensors(want)):
        assert torch.equal(got, ref)

    def replay_from(snapshot, stream):
        for dst, src in zip(_state_tensors(state), _state_tensors(snapshot)):
            dst.copy_(src)
        state.rng = stream.clone()
        _, losses = trainer.train_steps(state, batches)
        return losses, state.rng.clone()

    losses_a, advanced = replay_from(start, start.rng)
    assert np.array_equal(losses_a, graph_losses) and trainer.capture_warmups == 1
    losses_b, _ = replay_from(start, advanced)  # the next stretch of the stream
    assert not np.array_equal(losses_b, losses_a)
    losses_c, _ = replay_from(start, start.rng)  # the control: one fixed mask
    assert np.array_equal(losses_c, losses_a)  # the check above would fail for it

    # a checkpoint taken after one chunk continues the same masks
    replay_from(start, start.rng)
    save_pytree(str(tmp_path / "ckpt"), state)
    _, uninterrupted = trainer.train_steps(state, batches)
    resumed_trainer, template = _dropout_trainer(cuda_device, initial)
    resumed = restore_pytree(str(tmp_path / "ckpt"), template)
    _, after = resumed_trainer.train_steps(resumed, batches)
    assert np.array_equal(after, uninterrupted) and torch.equal(resumed.rng, state.rng)


# --------------------------------------------------------------------------- #
# The evaluation programs on CUDA graphs
# --------------------------------------------------------------------------- #
class _Eager:
    """The trainer's evaluation and metric programs run eagerly for the body
    (the reference each graph is held to), then its graphs again."""

    def __init__(self, trainer):
        self.trainer = trainer

    def __enter__(self):
        from replay_tpu_torch.metrics.builder import metric_program
        from replay_tpu_torch.nn.graphs import EagerProgram

        self.saved = self.trainer._eval_runner, self.trainer._metric_runner
        self.trainer._eval_runner = EagerProgram(self.trainer._eval_program)
        self.trainer._metric_runner = EagerProgram(metric_program)
        return self.trainer

    def __exit__(self, *exc_info):
        self.trainer._eval_runner, self.trainer._metric_runner = self.saved


def _eval_batches(kind, count=3, rows=16, length=20):
    """Validation batches of one shape: left-padded histories, a padded
    ground truth and seen set, the last batch's tail rows invalid."""
    batches = []
    for seed in range(count):
        rng = np.random.default_rng(100 + seed)
        mask = _left_padded(rows, length, seed) | (np.arange(length) == length - 1)
        ids = np.where(mask, rng.integers(0, 300, (rows, length)), 300).astype(np.int32)
        truth = np.full((rows, 3), -1, np.int64)
        truth[:, 0] = rng.integers(0, 300, rows)
        valid = np.ones(rows, bool)
        if seed == count - 1:
            valid[-5:] = False
        batches.append({
            "feature_tensors": {"item_id": ids}, "padding_mask": mask, "ground_truth": truth,
            "train": np.where(mask, ids, -1).astype(np.int64), "valid": valid, "query_id": np.arange(rows) + rows * seed,
        })
    return batches


@pytest.mark.parametrize("kind", ["sasrec", "twotower"])
def test_eval_graphs_equal_the_eager_programs(cuda_device, kind):
    """``predict_logits``, the catalog encode and the query embeddings
    (TwoTower), and the metric sums and coverage replay graphs bitwise equal
    to the eager programs: on the initial weights, after in-place training
    steps (the static parameters are copied in once per call, never stale),
    and for a second state with another buffer. One capture per program and
    shape; K4 counted once a block a replay."""
    from replay_tpu_torch.nn.loss import CE, CESampled
    from replay_tpu_torch.nn.postprocess import SeenItemsFilter

    if kind == "sasrec":
        model = SasRec(
            _model_schema("twotower"), embedding_dim=32, num_blocks=2, num_heads=2, max_sequence_length=20,
            use_flash=True, device=cuda_device, generator=torch.Generator().manual_seed(5),
        )
        trainer = Trainer(model, CE(), device=cuda_device)
        train_batches = [
            {"feature_tensors": {"item_id": b["feature_tensors"]["item_id"]}, "padding_mask": b["padding_mask"],
             "positive_labels": b["feature_tensors"]["item_id"][:, :, None], "target_padding_mask": b["padding_mask"][:, :, None]}
            for b in _eval_batches(kind)
        ]
    else:
        trainer = Trainer(_model("twotower", cuda_device), CESampled(), device=cuda_device)
        train_batches = _model_batches("twotower", 3)
    batches = _eval_batches(kind)
    kwargs = dict(metrics=("coverage", "map", "ndcg", "recall"), top_k=(1, 5, 10), item_count=300,
                  postprocessors=[SeenItemsFilter()])
    state = trainer.init_state(None)
    other = trainer.init_state(None, params={k: v * 0.5 for k, v in trainer.model.state_dict().items()})

    def compare(state):
        flash_attention.launches = 0
        graph_logits = [trainer.predict_logits(state, b) for b in batches]
        graph_metrics = trainer.validate(state, batches, **kwargs)
        _, graph_items, graph_scores = trainer.predict_top_k(state, batches, 10)
        torch.cuda.synchronize()
        launches = flash_attention.launches
        with _Eager(trainer):
            eager_logits = [trainer.predict_logits(state, b) for b in batches]
            eager_metrics = trainer.validate(state, batches, **kwargs)
            _, eager_items, eager_scores = trainer.predict_top_k(state, batches, 10)
        assert all(torch.equal(g, e) for g, e in zip(graph_logits, eager_logits))
        assert graph_metrics == eager_metrics
        assert np.array_equal(graph_items, eager_items) and np.array_equal(graph_scores, eager_scores)
        return graph_logits[0], launches

    first, _ = compare(state)
    for batch in train_batches:  # in place: the state's buffer changes under the graphs
        trainer.train_step(state, batch)
    trained, launches = compare(state)
    assert not torch.equal(first, trained)
    assert not torch.equal(compare(other)[0], trained)  # another buffer
    # one capture per program and shape: logits (or queries and the catalog
    # encode), the metric sums and one coverage graph per k
    programs = {"sasrec": 1, "twotower": 3}[kind]
    assert trainer._eval_runner.warmups == len(trainer._eval_runner.keys) == programs
    assert trainer._metric_runner.warmups == len(trainer._metric_runner.keys) == 1 + 3
    # K4: once a block for each replay (3 predict_logits, 3 validate, 3
    # predict_top_k batches; TwoTower's catalog encode has no attention)
    assert launches == 2 * 9


def test_eval_graph_capture_failure_raises(cuda_device):
    """A program that cannot be captured raises; nothing runs it eagerly instead."""
    model = SasRec(
        _model_schema("twotower"), embedding_dim=32, num_blocks=1, num_heads=2, max_sequence_length=20,
        use_flash=True, device=cuda_device, generator=torch.Generator().manual_seed(5),
    )
    trainer = Trainer(model, CEFused(), device=cuda_device)
    state = trainer.init_state(None)
    original = model.forward_inference

    def syncing(*args, **kwargs):
        out = original(*args, **kwargs)
        out.sum().item()  # a host read: illegal while capturing
        return out

    model.forward_inference = syncing
    batch = _eval_batches("sasrec", 1)[0]
    with pytest.raises(RuntimeError):
        trainer.predict_logits(state, batch)
    assert trainer._eval_runner.keys == ()
    model.forward_inference = original  # and capturing works after
    with _Eager(trainer):
        want = trainer.predict_logits(state, batch)
    assert torch.equal(trainer.predict_logits(state, batch), want)


# -- retrieval on the card: the IVF index and the int8 table ----------------------- #
# The card's search against the CPU's on one index state: scores within
# RETRIEVAL_TOL (f32 products summed in another order), ids equal at every
# rank whose score is clear of its neighbours by more than it.
RETRIEVAL_TOL = 1e-4


def _clustered_catalog(items=20_000, dim=32, modes=40, queries=32, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((modes, dim), dtype=np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    table = centers[rng.integers(0, modes, items)] + np.float32(0.1) * rng.standard_normal((items, dim), dtype=np.float32)
    query = centers[rng.integers(0, modes, queries)] + np.float32(0.1) * rng.standard_normal((queries, dim), dtype=np.float32)
    return table, query


def _assert_search_equal(got, want):
    """``got`` (the card's search at k) against ``want`` (the CPU's at k + 1)."""
    got_values, got_ids = got
    want_values, want_ids = want
    k = got_ids.shape[1]
    np.testing.assert_allclose(got_values, want_values[:, :k], atol=RETRIEVAL_TOL, rtol=0)
    gaps = want_values[:, :-1] - want_values[:, 1:]
    previous = np.concatenate([np.full_like(gaps[:, :1], np.inf), gaps[:, : k - 1]], axis=1)
    pinned = np.minimum(previous, gaps[:, :k]) > RETRIEVAL_TOL
    assert pinned.mean() > 0.5
    np.testing.assert_array_equal(got_ids[pinned], want_ids[:, :k][pinned])


@pytest.mark.parametrize("precision", ["f32", "int8", "int8+pq"])
def test_ivf_build_on_the_card_is_bitwise_repeatable_and_searches_as_the_cpu(cuda_device, precision):
    from replay_tpu_torch.models import MIPSIndex

    table, queries = _clustered_catalog()
    kwargs = dict(index="ivf", precision=precision, nlist=64, nprobe=16, build_sample=16_384, pq_subspaces=8)
    first = MIPSIndex(table, device=cuda_device, **kwargs)
    second = MIPSIndex(table, device=cuda_device, **kwargs)
    assert first.ivf_state.device.type == "cuda"
    for name, tensor in first.ivf_state.tensors().items():
        assert torch.equal(tensor, second.ivf_state.tensors()[name]), name
    on_cpu = MIPSIndex.from_state(table, precision, ivf=first.ivf_state.to("cpu"), device="cpu")
    for k in (10, 100):
        _assert_search_equal(first.search(queries, k), on_cpu.search(queries, k + 1))
    # the rescore reads the host master: the same f32 products on either side
    ids = first.search(queries, 50)[1]
    np.testing.assert_allclose(
        first.exact_rescore(queries, ids).cpu().numpy(), on_cpu.exact_rescore(queries, ids).numpy(), atol=RETRIEVAL_TOL
    )


def test_int8_brute_index_on_the_card_equals_the_cpu_one(cuda_device):
    from replay_tpu_torch.models import MIPSIndex
    from replay_tpu_torch.serve import CandidatePipeline

    table, queries = _clustered_catalog(items=30_000, dim=64)
    card = MIPSIndex(table, precision="int8", device=cuda_device)
    cpu = MIPSIndex(table, precision="int8", device="cpu")
    assert card.item_vectors.dtype == torch.int8 and card.item_vectors.device.type == "cuda"
    assert torch.equal(card.item_vectors.cpu(), cpu.item_vectors) and torch.equal(card.item_scales.cpu(), cpu.item_scales)
    for k in (10, 100):
        _assert_search_equal(card.search(queries, k), cpu.search(queries, k + 1))
    rerank = np.array([1.5, -0.2], np.float32)
    got = CandidatePipeline(card, num_candidates=100, top_k=11, reranker_weights=rerank).rank(queries)
    want = CandidatePipeline(cpu, num_candidates=100, top_k=12, reranker_weights=rerank).rank(queries)
    _assert_search_equal(got, want)


# --------------------------------------------------------------------------- #
# packed rows (segment masks, unfused attention) with K1–K3 on bf16 hidden states
# --------------------------------------------------------------------------- #
def _packed_training(cuda_device, loss, batches=8):
    """A bf16 SASRec trainer on the unfused route and ``batches`` packed
    batches of 32 rows of L=50 (sequences of 2–24 items over 300)."""
    from replay_tpu_torch.data.nn import PackedSequenceBatcher, SequentialDataset
    from replay_tpu_torch.nn.transform import Compose, make_packed_sasrec_transforms

    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID, cardinality=300,
            embedding_dim=64,
        )
    )
    rng = np.random.default_rng(48)
    sequences = [rng.integers(1, 300, n) for n in rng.integers(2, 25, 140 * batches)]
    data = SequentialDataset(schema, "user_id", "item_id", {"user_id": np.arange(len(sequences)), "item_id": sequences})
    pipeline = Compose(make_packed_sasrec_transforms(schema)["train"])
    packed = [pipeline(b) for b in PackedSequenceBatcher(data, batch_size=32, max_sequence_length=51, shuffle=True)]
    assert len(packed) >= batches and int(packed[0]["segment_ids"].max()) > 1
    model = SasRec(
        schema, embedding_dim=64, num_blocks=2, num_heads=1, max_sequence_length=50, use_flash=False,
        dropout_rate=0.0, device=cuda_device, generator=torch.Generator().manual_seed(49),
    )
    return Trainer(model, loss, precision="bf16", device=cuda_device), packed[:batches]


def test_packed_bf16_cefused_steps_match_ce(cuda_device):
    """Packed batches, bf16 compute: CEFused (K1–K3 on bf16 hidden states,
    their tf32 variant at E=64) against CE from the same weights, 8 steps.
    The first step's loss, from the same hidden states, at rtol 1e-5 (f32
    sums in another order); every step's at 5e-4: the two gradients differ
    by f32 rounding, which flips bf16 roundings of the activations in later
    steps (5.7e-5 at most on the CPU at this width, the plain versions)."""
    from replay_tpu_torch.nn.loss import CE

    fused, batches = _packed_training(cuda_device, CEFused())
    plain, _ = _packed_training(cuda_device, CE())
    initial = {name: value.detach().clone() for name, value in plain.model.state_dict().items()}
    fused_state, plain_state = fused.init_state(None, params=initial), plain.init_state(None, params=initial)
    before = fused_ce.fused_lse_dh.launches
    got = [float(fused.train_step(fused_state, batch)[1]) for batch in batches]
    want = [float(plain.train_step(plain_state, batch)[1]) for batch in batches]
    assert fused_ce.fused_lse_dh.launches == before + len(batches)
    assert fused_ce.fused_lse_dh.launches_by_variant["tf32"] >= len(batches)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got, want, rtol=5e-4)


def test_packed_chunk_graph_equals_the_eager_steps(cuda_device):
    """``train_steps`` over K=8 packed batches (one graph) against 8
    ``train_step`` calls from the same weights: bit for bit."""
    trainer, batches = _packed_training(cuda_device, CEFused())
    initial = {name: value.detach().clone() for name, value in trainer.model.state_dict().items()}
    eager = trainer.init_state(None, params=initial)
    want = [float(trainer.train_step(eager, batch)[1]) for batch in batches]
    state = trainer.init_state(None, params=initial)
    state, losses = trainer.train_steps(state, batches)
    assert losses.tolist() == want and torch.equal(state.flat_params, eager.flat_params)
    _, again = trainer.train_steps(trainer.init_state(None, params=initial), batches)  # a replay
    assert again.tolist() == want


def _observed_trainer(cuda_device, health=None):
    from replay_tpu_torch.obs.health import HealthConfig

    schema = TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True, feature_hint=FeatureHint.ITEM_ID,
            cardinality=300, embedding_dim=64,
        )
    )
    model = SasRec(
        schema, embedding_dim=64, num_blocks=2, num_heads=1, max_sequence_length=16, use_flash=True,
        device=cuda_device, generator=torch.Generator().manual_seed(3),
    )
    return Trainer(model, CEFused(), device=cuda_device, health=HealthConfig(cadence=health) if health else None)


def _observed_batches(count):
    rng = np.random.default_rng(5)
    batches = []
    for _ in range(count):
        items = rng.integers(0, 300, (32, 17)).astype(np.int32)
        mask = np.ones((32, 16), dtype=bool)
        batches.append({
            "feature_tensors": {"item_id": items[:, :-1]}, "padding_mask": mask,
            "positive_labels": items[:, 1:, None], "target_padding_mask": mask[:, :, None],
        })
    return batches


def test_observe_a_profiled_chunked_fit_attributes_its_kernels(cuda_device, tmp_path):
    """fit(scan_chunk=4) over 10 batches with health at cadence 5 (steps 5
    and 10 singly), tracing and a profile window over executed steps 4–8 (a
    health step and a graph replay): the window's traced K4 and K1–K3 equal
    their counted launches, K4 all in ``encoder``, K1–K3 all in ``loss`` (the
    replay's through its traced warm-up); the losses bitwise a plain fit's."""
    batches = _observed_batches(10)
    events = []

    class Sink:
        def log_event(self, event):
            events.append(event)

    plain = _observed_trainer(cuda_device)
    plain_state = plain.fit(batches, scan_chunk=4, log_every=0)
    trainer = _observed_trainer(cuda_device, health=5)
    state = trainer.fit(
        batches, scan_chunk=4, log_every=0, loggers=[Sink()], tracer=True, profile_steps=(4, 9),
        profile_dir=str(tmp_path / "profile"),
    )
    assert torch.equal(state.flat_params, plain_state.flat_params)
    record = [e for e in events if e.event == "on_fit_end"][0].payload["device_time"]
    counted = {name: record["launches"][name] for name in ("flash_attention", "fused_lse_forward", "fused_lse_dh", "fused_lse_dw")}
    assert counted == {"flash_attention": 10, "fused_lse_forward": 5, "fused_lse_dh": 5, "fused_lse_dw": 5}
    for name, launches in counted.items():
        scope = "encoder" if name == "flash_attention" else "loss"
        assert record["kernels"][name] == {"count": launches, "scopes": {scope: launches}}
    assert "train_scan" in record["modules"] and "eager" in record["modules"]
    assert record["attributed_seconds"] + record["unattributed_seconds"] == pytest.approx(record["total_device_seconds"])


def test_observe_flops_on_the_card_equal_the_cpu_count(cuda_device):
    """The counted FLOPs of one step: the same on the card (K4 through its
    operator's formula, K1–K3 reported by their wrappers) as on the CPU
    (their plain versions hidden from the counter)."""
    batch = _observed_batches(1)[0]
    counts = []
    for device in (cuda_device, torch.device("cpu")):
        trainer = _observed_trainer(device)
        state = trainer.init_state(batch)
        trainer.train_step(state, batch)
        counts.append(trainer.analyze_programs()["train_step"])
    assert counts[0]["flops"] == counts[1]["flops"] > 0
    assert counts[0]["roofline"]["bound"] in ("memory", "compute")
    assert counts[0]["temp_bytes"] > 0 and counts[0]["argument_bytes"] > 0


def test_observe_compiled_inference_roofline_per_bucket(cuda_device):
    from replay_tpu_torch.nn.compiled import CompiledInference

    trainer = _observed_trainer(cuda_device)
    served = CompiledInference.compile(
        trainer.model, dict(trainer.model.named_parameters()), 16, mode="dynamic_batch_size",
        dynamic_buckets=(1, 8, 64), device=cuda_device,
    )
    records = served.roofline()
    served.close()
    assert sorted(records) == [1, 8, 64]
    assert all(r["roofline"] is not None and r["flops"] > 0 and "hbm_peak_bytes" in r for r in records.values())


# --------------------------------------------------------------------------- #
# the catalog slice: SCE on graphs, vocabulary surgery, a grown generation served
# --------------------------------------------------------------------------- #
def _next_item_batches(count, num_items, seed, batch=16, length=50):
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(count):
        items = rng.integers(0, num_items, (batch, length + 1)).astype(np.int32)
        mask = np.ones((batch, length), bool)
        batches.append({
            "feature_tensors": {"item_id": items[:, :-1]}, "padding_mask": mask,
            "positive_labels": items[:, 1:, None], "target_padding_mask": mask[:, :, None],
        })
    return batches


def test_scale_sce_chunk_graph_equals_eager_steps_and_repeats_from_the_seed(cuda_device):
    """SCE on a bf16 SASRec (K4): its projection draws from the state's
    stream, so a K=8 graph equals 8 eager steps bit for bit (losses, weights,
    the stream's state), the same seed repeats the losses and another does not."""
    from replay_tpu_torch.nn.loss import SCE, SCEParams

    model = SasRec(
        _long_schema(), embedding_dim=32, num_blocks=2, num_heads=2, max_sequence_length=50,
        use_flash=True, dropout_rate=0.0, device=cuda_device, generator=torch.Generator().manual_seed(51),
    )
    initial = {name: value.detach().clone() for name, value in model.state_dict().items()}
    batches = _next_item_batches(8, 300, 52)

    def trainer(seed=0):
        return Trainer(SasRec(_long_schema(), embedding_dim=32, num_blocks=2, num_heads=2, max_sequence_length=50,
                              use_flash=True, device=cuda_device),
                       SCE(SCEParams(n_buckets=8, bucket_size_x=64, bucket_size_y=32)), precision="bf16",
                       seed=seed, device=cuda_device)

    def eager(seed=0):
        t = trainer(seed)
        state = t.init_state(batches[0], params=initial)
        return [float(t.train_step(state, b)[1]) for b in batches], state

    want, want_state = eager()
    again, _ = eager()
    other, _ = eager(1)
    assert want == again and want != other
    t = trainer()
    state = t.init_state(batches[0], params=initial)
    state, losses = t.train_steps(state, batches)
    assert t.capture_warmups == 1
    assert losses.tolist() == want
    assert torch.equal(state.flat_params, want_state.flat_params) and torch.equal(state.rng, want_state.rng)


def test_continual_resized_trainer_replays_no_graph_of_the_old_shape(cuda_device):
    """After ``resize_vocabulary`` the chunk and evaluation graphs of the old
    table are gone: the next fit and validate capture anew, their results are
    the eager programs' over the grown catalog, and a K=4 graph equals 4
    eager steps bit for bit."""
    from replay_tpu_torch.nn.loss import CE
    from replay_tpu_torch.nn.train import _clone_state

    schema = _long_schema()
    trainer = Trainer(
        SasRec(schema, embedding_dim=32, num_blocks=2, num_heads=2, max_sequence_length=50, use_flash=True,
               device=cuda_device, generator=torch.Generator().manual_seed(53)),
        CE(), device=cuda_device,
    )
    batches = _next_item_batches(8, 300, 54)
    state = trainer.fit(batches, scan_chunk=4, log_every=0)
    probe = {"feature_tensors": batches[0]["feature_tensors"], "padding_mask": batches[0]["padding_mask"]}
    assert trainer.predict_logits(state, probe).shape == (16, 300)
    warmups = (trainer.capture_warmups, trainer._eval_runner.warmups)
    assert trainer._chunk_graphs and trainer._eval_runner.keys
    grown = trainer.resize_vocabulary(state, 340, init="xavier")
    assert not trainer._chunk_graphs and not trainer._eval_runner.keys
    grown_batches = _next_item_batches(8, 340, 55)
    grown = trainer.fit(grown_batches, state=grown, scan_chunk=4, log_every=0)
    logits = trainer.predict_logits(grown, probe)
    assert logits.shape == (16, 340)
    assert trainer.capture_warmups == warmups[0] + 1 and trainer._eval_runner.warmups == warmups[1] + 1
    with _Eager(trainer):
        assert torch.equal(trainer.predict_logits(grown, probe), logits)
    a, b = _clone_state(grown), _clone_state(grown)
    a, losses = trainer.train_steps(a, grown_batches[:4])
    want = [float(trainer.train_step(b, batch)[1]) for batch in grown_batches[:4]]
    assert losses.tolist() == want and torch.equal(a.flat_params, b.flat_params)


def test_continual_grown_generation_serves_the_top10_of_predict_top_k(cuda_device):
    """A service built on the model at 300 items takes a generation grown to
    340 through ``publish_candidate``'s shape-change path (a fresh engine on
    graphs) and serves ``predict_top_k``'s top-10 over the 340 items."""
    from replay_tpu_torch.nn.loss import CE
    from replay_tpu_torch.serve import ScoringService
    from replay_tpu_torch.serve.request import top_k_cut

    def model():
        return SasRec(_long_schema(), embedding_dim=32, num_blocks=2, num_heads=2, max_sequence_length=50,
                      use_flash=True, device=cuda_device, generator=torch.Generator().manual_seed(56))

    trainer = Trainer(model(), CE(), device=cuda_device)
    state = trainer.init_state(None)
    service = ScoringService(model(), {k: v.detach().clone() for k, v in state.params.items()},
                             length_buckets=(50,), batch_buckets=(1, 8), device=cuda_device).start()
    try:
        grown = trainer.resize_vocabulary(state, 340, init="xavier")
        generation = service.publish_candidate({k: v.detach().clone() for k, v in grown.params.items()})
        assert service.store.generation(generation).engine is not None
        service.promote(generation)
        history = [5, 310, 7, 330, 12]
        window, mask, _ = make_window(history, 50)
        batch = {"feature_tensors": {"item_id": window[None]}, "padding_mask": mask[None]}
        _, items, _ = trainer.predict_top_k(grown, [batch], k=10)
        response = service.score("u", history=history, timeout=60.0)
        assert response.scores.shape == (340,)
        assert top_k_cut(response, 10)[0].tolist() == items[0].tolist()
    finally:
        service.close()
