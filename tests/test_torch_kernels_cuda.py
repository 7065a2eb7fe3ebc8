"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA device and skips without one. This file imports
neither JAX nor the JAX package, so it runs on a GPU machine that has only
PyTorch; the repo's ``tests/conftest.py`` needs pandas and the JAX package's
data module, so skip it there:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerances (max abs error against the plain version, f32 result): f32 1e-5,
the kernel differing only in summation order; bf16 2e-2, its output's own
rounding (half an ulp is 1.6e-2 below 8).
"""

import numpy as np
import pytest
import torch

from replay_tpu_torch.data import FeatureHint, FeatureType
from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu_torch.nn.mask import causal_attention_mask
from replay_tpu_torch.nn.sequential.sasrec import SasRec
from replay_tpu_torch.ops.flash_attention import flash_attention, flash_attention_reference
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
    [(64, 1, 50, 64, 1), (8, 4, 200, 48, 4), (2, 2, 1024, 64, 1), (3, 2, 37, 256, 1), (2, 1, 5, 16, 1)],
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
