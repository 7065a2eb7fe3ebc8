"""Activation checkpointing of an encoder block: the port's ``nn.remat``.

The JAX encoders wrap each block in ``jax.checkpoint`` (flax ``nn.remat``)
when ``remat=True``: the block's activations are dropped after the forward
and rebuilt in the backward, the HBM-for-FLOPs trade. Here a block runs under
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``, and a
``remat_policy`` is a torch selective-checkpoint policy function ``(ctx, op,
*args, **kwargs) -> CheckpointPolicy`` (``None`` saves nothing and recomputes
the whole block, as ``jax.checkpoint`` with no policy). The two policies the
trainer names:

* :func:`checkpoint_dots`, ``jax.checkpoint_policies.checkpoint_dots``: the
  outputs of every matrix product (``aten.mm``, ``addmm``, ``bmm``,
  ``baddbmm``) are saved, everything else is recomputed;
* :func:`checkpoint_dots_with_no_batch_dims`: only the products without a
  batch dimension (``mm``, ``addmm``: a ``Dense`` over ``[B, L, E]`` is one
  of these in JAX too), so the attention einsums are recomputed.

Kernels K4 and K5 reach a policy as their operators
(``replay_tpu_torch::flash_attention_forward``,
``replay_tpu_torch::flash_attention_tiled_forward``). They are not products,
so both policies recompute them, as ``checkpoint_dots`` recomputes a
``pallas_call``: under remat each attention kernel's forward runs twice a
step, and its launch count says so.

Dropout: the recompute must see the masks the forward drew. On the CPU the
checkpoint saves the generator's state and restores it for the recompute
(``preserve_rng_state``). On the card a step may be captured into a CUDA
graph, where the generator's state cannot be read or set; so there every op
that draws from a generator (the ops tagged ``nondeterministic_seeded``:
dropout) is saved by the forward and read back by the recompute, which draws
nothing. Either way the generator advances by the forward's draws only, so a
remat step draws the masks of a step without remat, and a captured chunk of
remat steps equals as many eager ones.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts

__all__ = ["checkpoint_dots", "checkpoint_dots_with_no_batch_dims", "rematerialized"]

Policy = Callable[..., CheckpointPolicy]

_aten = torch.ops.aten
_NO_BATCH_DOTS = frozenset((_aten.mm.default, _aten.addmm.default))
_DOTS = _NO_BATCH_DOTS | {_aten.bmm.default, _aten.baddbmm.default}


def checkpoint_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Save every matrix product's output; recompute the rest."""
    return CheckpointPolicy.MUST_SAVE if op in _DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def checkpoint_dots_with_no_batch_dims(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Save the outputs of the products without a batch dimension; recompute the rest."""
    return CheckpointPolicy.MUST_SAVE if op in _NO_BATCH_DOTS else CheckpointPolicy.PREFER_RECOMPUTE


def _saving_draws(policy: Optional[Policy], ctx, op, *args, **kwargs) -> CheckpointPolicy:
    if torch.Tag.nondeterministic_seeded in op.tags:
        return CheckpointPolicy.MUST_SAVE
    if policy is None:
        return CheckpointPolicy.PREFER_RECOMPUTE
    return policy(ctx, op, *args, **kwargs)


def _draws_saved(x: torch.Tensor) -> bool:
    """Whether the recompute reads the forward's draws back (on the card)
    instead of redrawing them from a restored generator (on the CPU)."""
    return x.device.type == "cuda"


def rematerialized(fn: Callable[..., Any], x: torch.Tensor, *args, policy: Optional[Policy] = None) -> Any:
    """``fn(x, *args)`` with its activations rebuilt in the backward pass.

    ``policy`` picks what the forward keeps (``None``: nothing). Without
    autograd (evaluation, ``torch.no_grad``) ``fn`` just runs."""
    if not torch.is_grad_enabled():
        return fn(x, *args)
    if _draws_saved(x):
        # the draws are saved, not redrawn: see the module docstring
        context = functools.partial(create_selective_checkpoint_contexts, functools.partial(_saving_draws, policy))
        return checkpoint(fn, x, *args, use_reentrant=False, preserve_rng_state=False, context_fn=context)
    if policy is None:
        return checkpoint(fn, x, *args, use_reentrant=False, preserve_rng_state=True)
    context = functools.partial(create_selective_checkpoint_contexts, policy)
    return checkpoint(fn, x, *args, use_reentrant=False, preserve_rng_state=True, context_fn=context)
