"""Scalable Cross-Entropy for huge item catalogs (arXiv 2409.18721).

Counterpart of ``replay_tpu/nn/loss/sce.py``: bucket the hidden states and the
item embeddings by a shared random projection, take the top ``bucket_size_x``
positions and the top ``bucket_size_y`` items of each bucket, and compute the
CE of each selected position's correct item against its bucket's hard
negatives; a position's loss is the largest over the buckets it landed in
(a scatter-max).

The projection is a standard normal draw: ``[n_buckets, E]`` bucket centres,
or with ``mix_x`` the ``[T, n_buckets]`` mixing weights ``omega`` whose
products with the hidden states are the centres.
:func:`scalable_cross_entropy` takes it drawn;
:class:`ScalableCrossEntropyLoss` draws it from a ``torch.Generator`` (the
trainer's: the device's default generator, set to ``TrainState.rng``, the
stream dropout draws from, so a captured step draws it as an eager one does)
or takes a drawn tensor. The JAX loss draws with ``jax.random.normal`` from
a key; the two streams differ, so the packages agree only on a projection
passed to both.

Types follow the JAX loss's promotions: the mining products ``buckets @ x.T``
stay in the hidden states' dtype, the products with the item table (f32
under a bf16 model) and the bucket logits in the promoted dtype, the masked
value and the per-position losses in the hidden states' dtype.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F


@dataclass(frozen=True)
class SCEParams:
    n_buckets: int
    bucket_size_x: int
    bucket_size_y: int
    mix_x: bool = False


def projection_shape(params: SCEParams, tokens: int, dim: int) -> Tuple[int, int]:
    """The shape of the standard normal draw: ``[T, n_buckets]`` with
    ``mix_x``, else ``[n_buckets, E]``."""
    return (tokens, params.n_buckets) if params.mix_x else (params.n_buckets, dim)


def scalable_cross_entropy(
    embeddings: torch.Tensor,  # [B, L, E]
    positive_labels: torch.Tensor,  # [B, L]
    all_embeddings: torch.Tensor,  # [I, E]
    padding_mask: torch.Tensor,  # [B, L] bool
    projection: torch.Tensor,  # standard normal, projection_shape(...)
    params: SCEParams,
    tokens_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The SCE loss for a drawn projection (see the module docstring)."""
    dim = embeddings.shape[-1]
    x = embeddings.reshape(-1, dim)  # [T, E]
    w = all_embeddings  # [I, E]
    y = positive_labels.reshape(-1)  # [T]
    # a gather clamps out-of-range ids (the padding id), as the JAX gather does
    y_rows = torch.clamp(y.long(), 0, w.shape[0] - 1)
    flat_pad = padding_mask.reshape(-1)
    loss_tokens = flat_pad if tokens_mask is None else (flat_pad & tokens_mask.reshape(-1))
    compute = torch.promote_types(x.dtype, w.dtype)
    neg_inf = torch.finfo(x.dtype).min

    correct_logits = torch.sum(x.to(compute) * F.embedding(y_rows, w).to(compute), dim=1)  # [T]

    scale = torch.reciprocal(torch.sqrt(torch.sqrt(torch.full((), dim, dtype=x.dtype, device=x.device))))
    projection = projection.to(x.dtype)
    if params.mix_x:
        buckets = ((scale * projection).T @ x).detach()  # [n_b, E]
    else:
        buckets = scale * projection

    # the hardest positions and items of each bucket (no gradient through mining)
    with torch.no_grad():
        x_scores = torch.where(flat_pad[None, :], buckets @ x.T, neg_inf)  # [n_b, T]
        top_x = torch.topk(x_scores, params.bucket_size_x, dim=1).indices  # [n_b, bs_x]
        y_scores = buckets.to(compute) @ w.to(compute).T  # [n_b, I]
        top_y = torch.topk(y_scores, params.bucket_size_y, dim=1).indices  # [n_b, bs_y]

    # gathers as embedding lookups: their gradients are sorted segment sums,
    # the same bits on every run (a captured step equals an eager one)
    x_bucket = F.embedding(top_x, x)  # [n_b, bs_x, E]
    y_bucket = F.embedding(top_y, w)  # [n_b, bs_y, E]
    wrong_logits = torch.einsum("nxe,nye->nxy", x_bucket.to(compute), y_bucket.to(compute))
    # a bucket's item that is the position's own positive is no negative
    same = y[top_x][:, :, None] == top_y[:, None, :]
    wrong_logits = torch.where(same, neg_inf, wrong_logits)

    pos = F.embedding(top_x, correct_logits[:, None])  # [n_b, bs_x, 1]
    logits = torch.cat([wrong_logits, pos], dim=2)
    nll = torch.logsumexp(logits, dim=2) - pos[..., 0]  # [n_b, bs_x]

    # scatter-max per original position (a position can land in several
    # buckets); ties share the gradient, the zero start value among them
    per_token = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device).scatter_reduce(
        0, top_x.reshape(-1), nll.reshape(-1).to(x.dtype), "amax", include_self=True
    )
    counted = (per_token != 0) & loss_tokens
    return torch.sum(per_token * counted) / torch.clamp(torch.sum(counted), min=1.0)


class ScalableCrossEntropyLoss:
    """Bucketed hard-negative-mined cross-entropy."""

    def __init__(self, sce_params: SCEParams) -> None:
        if None in (sce_params.n_buckets, sce_params.bucket_size_x, sce_params.bucket_size_y):
            msg = "n_buckets, bucket_size_x and bucket_size_y must all be set"
            raise ValueError(msg)
        self.params = sce_params

    def draw(self, embeddings: torch.Tensor, generator: Optional[torch.Generator]) -> torch.Tensor:
        """The standard normal projection for ``embeddings`` ``[B, L, E]``,
        in their dtype and on their device, from ``generator``."""
        tokens = embeddings.numel() // embeddings.shape[-1]
        shape = projection_shape(self.params, tokens, embeddings.shape[-1])
        return torch.randn(shape, generator=generator, device=embeddings.device, dtype=embeddings.dtype)

    def __call__(
        self,
        embeddings: torch.Tensor,  # [B, L, E]
        positive_labels: torch.Tensor,  # [B, L]
        all_embeddings: torch.Tensor,  # [I, E]
        padding_mask: torch.Tensor,  # [B, L] bool
        rng: Union[torch.Generator, torch.Tensor],
        tokens_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """``rng``: the generator to draw the projection from, or the drawn projection."""
        projection = rng if isinstance(rng, torch.Tensor) else self.draw(embeddings, rng)
        return scalable_cross_entropy(
            embeddings, positive_labels, all_embeddings, padding_mask, projection, self.params, tokens_mask
        )


class SCE:
    """Trainer-protocol adapter around :class:`ScalableCrossEntropyLoss`.

    SCE reads the raw item table (not logits) and draws a projection, so the
    trainer binds two more hooks when it sees the flags below:
    ``item_embeddings_callback`` (the model's ``get_item_weights``) and
    ``rng`` (the generator of the step's stream; a drawn projection tensor
    works too). The rest follows the shared loss signature.
    """

    needs_item_embeddings = True
    needs_rng = True
    # SCE scores buckets, never the [B, L, I] logits: health's logits stats
    # stream over the item table instead (obs/health.py)
    avoid_full_logits = True

    def __init__(self, sce_params: SCEParams) -> None:
        self.inner = ScalableCrossEntropyLoss(sce_params)
        self.item_embeddings_callback = None
        self.logits_callback = None  # unused; kept for protocol symmetry
        self.rng = None

    def __call__(
        self,
        model_embeddings,
        feature_tensors,
        positive_labels,
        negative_labels,
        padding_mask,
        target_padding_mask,
    ):
        if self.item_embeddings_callback is None or self.rng is None:
            msg = "SCE requires the trainer to bind item_embeddings_callback and rng."
            raise AttributeError(msg)
        if positive_labels.dim() == 3 and positive_labels.shape[-1] != 1:
            # dropped positives would be mined as hard negatives: reject loudly
            msg = "Multi-positive labels are not supported by the SCE loss"
            raise NotImplementedError(msg)
        labels = positive_labels[..., 0] if positive_labels.dim() == 3 else positive_labels
        tokens_mask = target_padding_mask[..., 0] if target_padding_mask.dim() == 3 else target_padding_mask
        return self.inner(
            model_embeddings,
            labels,
            self.item_embeddings_callback(),
            padding_mask,
            self.rng,
            tokens_mask=tokens_mask,
        )
