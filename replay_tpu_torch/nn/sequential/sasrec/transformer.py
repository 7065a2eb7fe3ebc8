"""SASRec encoder stacks.

Counterpart of ``replay_tpu/nn/sequential/sasrec/transformer.py``:

* ``_SasRecBlock`` (pre-LN multi-head attention + point-wise FFN) and
  ``SasRecTransformerLayer`` (N such blocks, each output multiplied by the
  padding ``keep`` mask). LayerNorm epsilon is flax's 1e-6, not torch's
  default 1e-5. Every block computes in the stack's ``dtype`` and receives the
  ``[B, L]`` padding mask and the causal flag on every route: the ``"tiled"``
  route builds its mask from them.
* ``remat=True`` runs each block under activation checkpointing
  (:mod:`replay_tpu_torch.nn.remat`; ``remat_policy`` picks what the forward
  keeps): the block's forward, kernels K4 and K5 included, runs again in the
  backward pass.
* ``scan_blocks=True`` is flax's ``nn.scan`` layout: ONE block,
  ``blocks.block``, whose every parameter is stacked on a leading ``[N, ...]``
  layer axis, run N times over the layer slices
  (``torch.func.functional_call``). The parameter names differ from the loop
  layout's ``block_<i>``, so checkpoints do not mix across the flag; a scanned
  stack sows no health stage stats, as in JAX, and its layers' attention
  entropies are stacked ``[N, H]`` under ``blocks/block``.
* ``DiffTransformerLayer``: N Differential-Transformer blocks (RMSNorm →
  differential attention → residual → RMSNorm → SwiGLU → dropout → residual,
  times ``keep``), λ_init = 0.8 − 0.6·exp(−0.3·i) computed in f32 as the JAX
  layer computes it; it has no remat, scan or kernel route, as in JAX.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call

from replay_tpu_torch.nn.attention import MultiHeadAttention, MultiHeadDifferentialAttention, RMSNorm
from replay_tpu_torch.nn.ffn import PointWiseFeedForward, SwiGLU
from replay_tpu_torch.nn.layers import LayerNorm
from replay_tpu_torch.nn.remat import rematerialized
from replay_tpu_torch.obs import health
from replay_tpu_torch.obs.health import sow_scope, sow_stage_stats


class _SasRecBlock(nn.Module):
    """One pre-LN block: LayerNorm → MHA → residual → LayerNorm → FFN."""

    def __init__(
        self,
        embedding_dim: int,
        num_heads: int,
        hidden_dim: int,
        dropout_rate: float = 0.0,
        activation: str = "gelu",
        use_flash=False,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.attn_norm = LayerNorm(embedding_dim, dtype)
        self.attention = MultiHeadAttention(
            embedding_dim, num_heads, dropout_rate=dropout_rate, use_flash=use_flash, dtype=dtype
        )
        self.ffn_norm = LayerNorm(embedding_dim, dtype)
        self.ffn = PointWiseFeedForward(
            embedding_dim, hidden_dim, dropout_rate=dropout_rate, activation=activation, dtype=dtype
        )

    def reset_parameters(self, generator: torch.Generator) -> None:
        self.attn_norm.reset_parameters()
        self.attention.reset_parameters(generator)
        self.ffn_norm.reset_parameters()
        self.ffn.reset_parameters(generator)

    def forward(self, x, attention_mask, keep, deterministic: bool = True, padding_mask=None, causal: bool = True):
        x = x + self.attention(
            self.attn_norm(x), attention_mask, deterministic=deterministic,
            padding_mask=padding_mask, causal=causal,
        )
        x = self.ffn(self.ffn_norm(x), deterministic=deterministic)
        return x * keep


class _ScannedBlocks(nn.Module):
    """The ``nn.scan`` layout: one template block, ``block``, whose every
    parameter is stacked ``[N, ...]`` over the N layers."""

    def __init__(self, num_blocks: int, **block_kwargs) -> None:
        super().__init__()
        self.num_blocks = num_blocks
        self._block_kwargs = block_kwargs
        self.block = _SasRecBlock(**block_kwargs)
        for name, param in list(self.block.named_parameters()):
            self._set(name, nn.Parameter(param.detach().expand(num_blocks, *param.shape).clone()))

    def _set(self, name: str, value: torch.Tensor) -> None:
        *path, leaf = name.split(".")
        setattr(self.block.get_submodule(".".join(path)), leaf, value)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        # each layer drawn as a block of the loop layout draws it, in layer order
        stacked = dict(self.block.named_parameters())
        for index in range(self.num_blocks):
            layer = _SasRecBlock(**self._block_kwargs)
            layer.reset_parameters(generator)
            for name, param in layer.named_parameters():
                stacked[name][index].copy_(param)

    def layer(self, index: int, x, *args):
        """Block ``index``: the template block on the layers' slice ``index``."""
        params = {name: param[index] for name, param in self.block.named_parameters()}
        return functional_call(self.block, params, (x, *args))


class SasRecTransformerLayer(nn.Module):
    """N pre-LN blocks: LayerNorm → MHA → residual → LayerNorm → point-wise FFN."""

    def __init__(
        self,
        embedding_dim: int,
        num_blocks: int,
        num_heads: int,
        hidden_dim: int,
        dropout_rate: float = 0.0,
        activation: str = "gelu",
        remat: bool = False,
        remat_policy=None,  # a torch selective-checkpoint policy; None = recompute all
        scan_blocks: bool = False,  # one block over [layers, ...] params
        use_flash=False,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        if remat_policy is not None and not callable(remat_policy):
            msg = f"remat_policy must be a selective-checkpoint policy function or None, got {remat_policy!r}"
            raise TypeError(msg)
        self.num_blocks = num_blocks
        self.remat = remat
        self.remat_policy = remat_policy
        self.scan_blocks = scan_blocks
        block_kwargs = dict(
            embedding_dim=embedding_dim, num_heads=num_heads, hidden_dim=hidden_dim, dropout_rate=dropout_rate,
            activation=activation, use_flash=use_flash, dtype=dtype,
        )
        if scan_blocks:
            self.blocks = _ScannedBlocks(num_blocks, **block_kwargs)
        else:
            for i in range(num_blocks):
                self.add_module(f"block_{i}", _SasRecBlock(**block_kwargs))

    def reset_parameters(self, generator: torch.Generator) -> None:
        if self.scan_blocks:
            self.blocks.reset_parameters(generator)
            return
        for i in range(self.num_blocks):
            getattr(self, f"block_{i}").reset_parameters(generator)

    def _run(self, block, x, *args):
        if self.remat:
            return rematerialized(block, x, *args, policy=self.remat_policy)
        return block(x, *args)

    def forward(
        self,
        x: torch.Tensor,
        attention_mask: Optional[torch.Tensor],  # None on the "tiled" route
        padding_mask: torch.Tensor,
        deterministic: bool = True,
        causal: bool = True,
    ) -> torch.Tensor:
        keep = padding_mask[..., None].to(x.dtype)
        args = (attention_mask, keep, deterministic, padding_mask, causal)
        if self.scan_blocks:
            # no stage stats from a scanned stack (the JAX scan sows none);
            # what the layers sow (attention entropy) is stacked [N, ...],
            # as nn.scan stacks the `intermediates` collection
            sowed = []
            for index in range(self.num_blocks):
                with health.capture_intermediates() if health.capturing() else contextlib.nullcontext({}) as layer:
                    x = self._run(functools.partial(self.blocks.layer, index), x, *args)
                sowed.append(layer)
            with sow_scope("blocks"), sow_scope("block"):
                for key in sowed[0]:
                    health.sow(key, torch.stack([layer[key][0] for layer in sowed]))
            return x
        for i in range(self.num_blocks):
            with sow_scope(f"block_{i}"):
                x = self._run(getattr(self, f"block_{i}"), x, *args)
            # model-health stage stats (a no-op outside a health capture)
            sow_stage_stats(self, f"block_{i}", x)
        return x


class DiffTransformerLayer(nn.Module):
    """N Differential-Transformer blocks: RMSNorm → DiffAttention → RMSNorm → SwiGLU."""

    def __init__(
        self,
        embedding_dim: int,
        num_blocks: int,
        num_heads: int,
        hidden_dim: int,
        dropout_rate: float = 0.0,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.num_blocks = num_blocks
        self.dropout_rate = dropout_rate
        for i in range(num_blocks):
            # exp in f32, then a python float, as the JAX layer computes it
            lambda_init = 0.8 - 0.6 * float(torch.exp(torch.tensor(-0.3 * i, dtype=torch.float32)))
            self.add_module(f"attn_norm_{i}", RMSNorm(embedding_dim, dtype=dtype))
            self.add_module(
                f"attention_{i}",
                MultiHeadDifferentialAttention(
                    embedding_dim, num_heads, lambda_init=lambda_init, dropout_rate=dropout_rate, dtype=dtype
                ),
            )
            self.add_module(f"ffn_norm_{i}", RMSNorm(embedding_dim, dtype=dtype))
            self.add_module(f"ffn_{i}", SwiGLU(embedding_dim, hidden_dim, embedding_dim, dtype))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(self.num_blocks):
            getattr(self, f"attn_norm_{i}").reset_parameters()
            getattr(self, f"attention_{i}").reset_parameters(generator)
            getattr(self, f"ffn_norm_{i}").reset_parameters()
            getattr(self, f"ffn_{i}").reset_parameters(generator)

    def forward(
        self,
        x: torch.Tensor,
        attention_mask: torch.Tensor,
        padding_mask: torch.Tensor,
        deterministic: bool = True,
    ) -> torch.Tensor:
        keep = padding_mask[..., None].to(x.dtype)
        for i in range(self.num_blocks):
            h = getattr(self, f"attention_{i}")(
                getattr(self, f"attn_norm_{i}")(x), attention_mask, deterministic=deterministic
            )
            x = x + h
            h = getattr(self, f"ffn_{i}")(getattr(self, f"ffn_norm_{i}")(x))
            x = (x + F.dropout(h, self.dropout_rate, training=not deterministic)) * keep
        return x
