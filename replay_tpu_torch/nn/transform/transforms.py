"""Composable batch transforms over dict batches.

Counterpart of ``replay_tpu/nn/transform/transforms.py``: ``NextToken``, negative
sampling (uniform, multi-class, in-batch), ``SegmentBoundaryMask``,
``TokenMask``, ``SequenceRoll``, ``Trim``/``AdaptiveTrim``, ``EqualityMask``,
``Copy``, ``Rename``, ``Select``, ``Unsqueeze`` and ``Group``, composed per
split by :mod:`replay_tpu_torch.nn.transform.template`.

Every transform is a callable ``batch, generator -> batch`` with no state of
its own. It takes torch tensors or numpy arrays and returns torch tensors; it
runs on the host, before the batch goes to the card. Randomness comes from an
explicit ``torch.Generator``: :class:`Compose` draws one generator for each
stochastic transform from the caller's, the counterpart of the JAX
``jax.random.split``. The draws cannot equal JAX's PRNG, so a stochastic
transform matches the JAX one by its contract (what it may draw, and the
corner cases it repairs), not by its values.
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

DEFAULT_MASK_POSTFIX = "_mask"
Batch = Dict[str, Any]


def _tensor(value: Any) -> Any:
    """A batch leaf as a torch tensor (numpy arrays without a copy); nested
    dicts leaf by leaf."""
    if isinstance(value, Mapping):
        return {key: _tensor(item) for key, item in value.items()}
    if isinstance(value, torch.Tensor):
        return value
    return torch.as_tensor(np.asarray(value))


def _tensors(batch: Mapping[str, Any]) -> Batch:
    return {name: _tensor(value) for name, value in batch.items()}


def _child_generator(generator: torch.Generator) -> torch.Generator:
    """A generator of its own for one transform, seeded from ``generator``."""
    seed = int(torch.randint(0, 2**62, (1,), generator=generator))
    return torch.Generator().manual_seed(seed)


class Transform:
    """Base: a pure batch→batch function; ``needs_rng`` marks stochastic transforms."""

    needs_rng = False

    def __call__(self, batch: Batch, rng: Optional[torch.Generator] = None) -> Batch:
        raise NotImplementedError


class Compose(Transform):
    """Apply transforms in order, giving each stochastic one a generator of its own."""

    def __init__(self, transforms: Sequence[Transform]) -> None:
        self.transforms = list(transforms)

    @property
    def needs_rng(self) -> bool:  # type: ignore[override]
        return any(t.needs_rng for t in self.transforms)

    def __call__(self, batch: Batch, rng: Optional[torch.Generator] = None) -> Batch:
        for transform in self.transforms:
            if transform.needs_rng:
                if rng is None:
                    msg = f"{type(transform).__name__} needs an rng key"
                    raise ValueError(msg)
                batch = transform(batch, _child_generator(rng))
            else:
                batch = transform(batch)
        return batch


class NextTokenTransform(Transform):
    """Shift ``label_name`` by ``shift`` to build ``positive_labels`` (+ its mask);
    trim the last ``shift`` steps off the declared sequential features.

    ``apply_to`` names the sequential features (and their masks) to trim; only
    those are touched, so non-sequence [B, N] tensors such as sampled
    ``negative_labels`` pass through untouched. When ``apply_to`` is None every
    tensor of two or more dimensions not in ``ignore`` is trimmed, which is only
    safe if the batch holds nothing but sequences.
    """

    def __init__(
        self,
        label_name: str,
        shift: int = 1,
        ignore: Union[List[str], str, None] = None,
        apply_to: Union[List[str], str, None] = None,
        out_feature_name: str = "positive_labels",
        mask_postfix: str = DEFAULT_MASK_POSTFIX,
    ) -> None:
        self.label_name = label_name
        self.shift = shift
        self.ignore = [ignore] if isinstance(ignore, str) else list(ignore or [])
        if apply_to is not None:
            apply_to = [apply_to] if isinstance(apply_to, str) else list(apply_to)
            # trim a feature's mask together with the feature
            apply_to = list(dict.fromkeys(apply_to + [f"{name}{mask_postfix}" for name in apply_to]))
        self.apply_to = apply_to
        self.out_feature_name = out_feature_name
        self.mask_postfix = mask_postfix

    def _should_trim(self, name: str, value) -> bool:
        if name in self.ignore or not isinstance(value, torch.Tensor) or value.dim() < 2:
            return False
        if self.apply_to is not None:
            return name in self.apply_to
        return True

    def __call__(self, batch: Batch, rng=None) -> Batch:
        batch = _tensors(batch)
        shift = self.shift
        labels = batch[self.label_name][:, shift:]
        label_mask_name = f"{self.label_name}{self.mask_postfix}"
        out = {}
        for name, value in batch.items():
            out[name] = value[:, :-shift] if self._should_trim(name, value) else value
        out[self.out_feature_name] = labels
        if label_mask_name in batch:
            out[f"{self.out_feature_name}{self.mask_postfix}"] = batch[label_mask_name][:, shift:]
        else:
            out[f"{self.out_feature_name}{self.mask_postfix}"] = torch.ones_like(labels, dtype=torch.bool)
        return out


class UniformNegativeSamplingTransform(Transform):
    """Sample ``num_negative_samples`` global negatives per batch (without replacement)."""

    needs_rng = True

    def __init__(
        self,
        cardinality: int,
        num_negative_samples: int,
        *,
        out_feature_name: str = "negative_labels",
        sample_distribution=None,
    ) -> None:
        if num_negative_samples >= cardinality:
            msg = f"num_negative_samples ({num_negative_samples}) must be < cardinality ({cardinality})"
            raise ValueError(msg)
        if sample_distribution is not None:
            sample_distribution = _tensor(sample_distribution).to(torch.float64)
            if sample_distribution.shape[-1] != cardinality:
                msg = "sample_distribution size must match cardinality"
                raise ValueError(msg)
        self.cardinality = cardinality
        self.num_negative_samples = num_negative_samples
        self.out_feature_name = out_feature_name
        self.sample_distribution = sample_distribution

    def __call__(self, batch: Batch, rng=None) -> Batch:
        if self.sample_distribution is None:
            negatives = torch.randperm(self.cardinality, generator=rng)[: self.num_negative_samples]
        else:
            probs = self.sample_distribution / torch.sum(self.sample_distribution)
            negatives = torch.multinomial(probs, self.num_negative_samples, replacement=False, generator=rng)
        return {**_tensors(batch), self.out_feature_name: negatives.to(torch.int32)}


class MultiClassNegativeSamplingTransform(Transform):
    """Per-row negatives sampled from class-conditional distributions.

    ``class_assignment`` maps each item to a class; for each batch row the sampler
    draws negatives from the items of the same class as the row's reference item.
    """

    needs_rng = True

    def __init__(
        self,
        class_assignment,  # [num_items] int class per item
        num_negative_samples: int,
        reference_name: str = "item_id",
        out_feature_name: str = "negative_labels",
    ) -> None:
        class_assignment = np.asarray(class_assignment)
        self.class_assignment = torch.as_tensor(class_assignment)
        self.num_negative_samples = num_negative_samples
        self.reference_name = reference_name
        self.out_feature_name = out_feature_name
        # per-class item-id index lists padded to the largest class: a draw is
        # a random index into the row's class list, never a [B, num_items]
        # probability matrix
        num_classes = int(class_assignment.max()) + 1
        members = [np.flatnonzero(class_assignment == c) for c in range(num_classes)]
        empty = [c for c, m in enumerate(members) if len(m) == 0]
        if empty:
            msg = (
                f"class_assignment has empty classes {empty}: every draw for such a "
                "class would silently return item 0. Use contiguous class ids."
            )
            raise ValueError(msg)
        sizes = np.array([len(m) for m in members], dtype=np.int32)
        table = np.zeros((num_classes, int(sizes.max())), dtype=np.int32)
        for c, m in enumerate(members):
            table[c, : len(m)] = m
        self._class_items = torch.as_tensor(table)  # [num_classes, max_class_size]
        self._class_sizes = torch.as_tensor(sizes)  # [num_classes]

    def __call__(self, batch: Batch, rng=None) -> Batch:
        batch = _tensors(batch)
        reference = batch[self.reference_name]
        last_items = reference[:, -1] if reference.dim() > 1 else reference
        classes = self.class_assignment[torch.clamp(last_items.long(), 0, self.class_assignment.shape[0] - 1)].long()
        draws = torch.randint(
            0, np.iinfo(np.int32).max, (classes.shape[0], self.num_negative_samples), generator=rng, dtype=torch.int32
        )
        indices = draws % self._class_sizes[classes][:, None]
        negatives = torch.take_along_dim(self._class_items[classes], indices.long(), dim=1)
        return {**batch, self.out_feature_name: negatives}


class InBatchNegativeSamplingTransform(Transform):
    """Use the batch's own positives as the shared negative pool (two-tower
    retrieval training: every query scores against every other query's target).

    Emits ``out_feature_name`` of shape [B], the ``[N]`` shared-pool form the
    sampled losses broadcast; own-positive collisions stay in the denominator,
    the standard in-batch-softmax formulation.
    """

    def __init__(self, label_name: str = "positive_labels", out_feature_name: str = "negative_labels") -> None:
        self.label_name = label_name
        self.out_feature_name = out_feature_name

    def __call__(self, batch: Batch, rng=None) -> Batch:
        batch = _tensors(batch)
        labels = batch[self.label_name]
        while labels.dim() > 1:  # [B, L, P] -> last position's positive per row
            labels = labels[:, -1]
        return {**batch, self.out_feature_name: labels}


class SegmentBoundaryMaskTransform(Transform):
    """Packed-batch fixup after :class:`NextTokenTransform`: mask labels that
    cross a segment boundary, and trim ``segment_ids`` to the input length.

    A packed row concatenates several user sequences (segment ids 1..k, 0 on
    padding). At the last positions of a segment the shifted label belongs to
    the next user's sequence; this transform ANDs the target mask with "label
    position is in the same (non-padding) segment as the input position", then
    replaces the full-length ``segment_ids`` with its input-aligned
    ``[:, :-shift]`` view.
    """

    def __init__(self, segment_name: str = "segment_ids", mask_name: str = "target_padding_mask", shift: int = 1) -> None:
        if shift < 1:
            msg = "shift must be >= 1 (the NextTokenTransform shift)"
            raise ValueError(msg)
        self.segment_name = segment_name
        self.mask_name = mask_name
        self.shift = shift

    def __call__(self, batch: Batch, rng=None) -> Batch:
        batch = _tensors(batch)
        segments = batch[self.segment_name]
        shift = self.shift
        if segments.shape[-1] == batch[self.mask_name].shape[1]:
            msg = (
                f"'{self.segment_name}' is already trimmed to the label "
                f"length; run {type(self).__name__} on the FULL-length "
                "segment ids (before any trim), after NextTokenTransform "
                f"excluded '{self.segment_name}' from apply_to."
            )
            raise ValueError(msg)
        inputs = segments[:, :-shift]
        labels_seg = segments[:, shift:]
        same_segment = (inputs == labels_seg) & (labels_seg != 0) & (inputs != 0)
        return {**batch, self.mask_name: batch[self.mask_name] & same_segment, self.segment_name: inputs}


class TokenMaskTransform(Transform):
    """BERT-style keep-mask: True = visible token, False = masked-out token.

    Padded positions are always masked (``uniform * padding >= mask_prob``). A
    row with nothing masked gets its last valid token masked; a row with
    everything masked keeps the position before its last valid one.
    """

    needs_rng = True

    def __init__(
        self,
        token_name: str,
        out_feature_name: str = "token_mask",
        mask_prob: float = 0.15,
        mask_postfix: str = DEFAULT_MASK_POSTFIX,
    ) -> None:
        self.token_name = token_name
        self.out_feature_name = out_feature_name
        self.mask_prob = mask_prob
        self.mask_postfix = mask_postfix

    def __call__(self, batch: Batch, rng=None) -> Batch:
        batch = _tensors(batch)
        padding = batch[self.token_name]
        if padding.dtype != torch.bool:
            msg = "Source tensor for token mask must be boolean (a padding mask)."
            raise ValueError(msg)
        uniform = torch.rand(padding.shape, generator=rng)
        keep = (uniform * padding) >= self.mask_prob  # padded positions always False

        valid_count = padding.sum(dim=1)
        kept_count = (keep & padding).sum(dim=1)
        rows = torch.arange(padding.shape[0])
        # nothing masked -> mask the last valid position (argmax: the first
        # maximum, as jnp.argmax)
        all_kept = kept_count == valid_count
        last_valid = padding.shape[1] - 1 - torch.argmax(padding.flip(1).to(torch.int32), dim=1)
        keep[rows, last_valid] = torch.where(all_kept, False, keep[rows, last_valid])
        # everything masked -> keep the position before the last valid one
        none_kept = (kept_count == 0) & (valid_count > 1)
        before_last = torch.clamp(last_valid - 1, min=0)
        keep[rows, before_last] = torch.where(none_kept, True, keep[rows, before_last])
        return {**batch, self.out_feature_name: keep}


class SequenceRollTransform(Transform):
    """Roll a sequence along the time axis, refilling the vacated slots with padding."""

    def __init__(self, feature_name: str, roll: int = 1, padding_value: int = 0) -> None:
        if roll == 0:
            msg = "roll must be non-zero"
            raise ValueError(msg)
        self.feature_name = feature_name
        self.roll = roll
        self.padding_value = padding_value

    def __call__(self, batch: Batch, rng=None) -> Batch:
        batch = _tensors(batch)
        rolled = torch.roll(batch[self.feature_name], self.roll, dims=1)
        if self.roll > 0:
            rolled[:, : self.roll] = self.padding_value
        else:
            rolled[:, self.roll :] = self.padding_value
        return {**batch, self.feature_name: rolled}


class TrimTransform(Transform):
    """Keep the LAST ``seq_len`` positions of the named (left-padded) sequences."""

    def __init__(self, seq_len: int, feature_names: Union[List[str], str]) -> None:
        self.seq_len = seq_len
        self.feature_names = [feature_names] if isinstance(feature_names, str) else list(feature_names)

    def __call__(self, batch: Batch, rng=None) -> Batch:
        out = _tensors(batch)
        for name in self.feature_names:
            if out[name].shape[1] < self.seq_len:
                msg = f"Cannot trim '{name}' of length {out[name].shape[1]} to {self.seq_len}"
                raise ValueError(msg)
            out[name] = out[name][:, -self.seq_len :]
        return out


class AdaptiveTrimTransform(Transform):
    """Trim to the batch's longest real sequence (a data-dependent shape: one
    CUDA graph per length would follow, so keep it out of captured chunks)."""

    def __init__(self, feature_names: Union[List[str], str], padding_mask_name: str = "padding_mask") -> None:
        self.feature_names = [feature_names] if isinstance(feature_names, str) else list(feature_names)
        self.padding_mask_name = padding_mask_name

    def __call__(self, batch: Batch, rng=None) -> Batch:
        if self.padding_mask_name not in batch:
            msg = f"Padding mask '{self.padding_mask_name}' not found in batch."
            raise KeyError(msg)
        batch = _tensors(batch)
        mask = batch[self.padding_mask_name]
        max_len = int(mask.sum(dim=1).max())
        if max_len == mask.shape[1]:
            return batch
        out = dict(batch)
        for name in self.feature_names:
            out[name] = batch[name][:, -max_len:]
        return out


class EqualityMaskTransform(Transform):
    """Combine ``mask_name`` with (feature == value) under AND/OR/XOR."""

    _OPS = {"and": torch.logical_and, "or": torch.logical_or, "xor": torch.logical_xor}

    def __init__(self, feature_name: str, mask_name: str, equality_value, op: str = "and") -> None:
        if op not in self._OPS:
            msg = f"op must be one of {sorted(self._OPS)}"
            raise ValueError(msg)
        self.feature_name = feature_name
        self.mask_name = mask_name
        self.equality_value = equality_value
        self.op = op

    def __call__(self, batch: Batch, rng=None) -> Batch:
        batch = _tensors(batch)
        modification = batch[self.feature_name] == self.equality_value
        return {**batch, self.mask_name: self._OPS[self.op](batch[self.mask_name], modification)}


class CopyTransform(Transform):
    def __init__(self, mapping: Dict[str, str]) -> None:
        self.mapping = mapping

    def __call__(self, batch: Batch, rng=None) -> Batch:
        out = _tensors(batch)
        for src, dst in self.mapping.items():
            out[dst] = out[src]
        return out


class RenameTransform(Transform):
    def __init__(self, mapping: Dict[str, str]) -> None:
        self.mapping = mapping

    def __call__(self, batch: Batch, rng=None) -> Batch:
        return {self.mapping.get(name, name): value for name, value in _tensors(batch).items()}


class SelectTransform(Transform):
    def __init__(self, feature_names: List[str]) -> None:
        self.feature_names = list(feature_names)

    def __call__(self, batch: Batch, rng=None) -> Batch:
        return {name: _tensor(batch[name]) for name in self.feature_names}


class UnsqueezeTransform(Transform):
    def __init__(self, feature_name: str, axis: int = -1) -> None:
        self.feature_name = feature_name
        self.axis = axis

    def __call__(self, batch: Batch, rng=None) -> Batch:
        batch = _tensors(batch)
        return {**batch, self.feature_name: torch.unsqueeze(batch[self.feature_name], self.axis)}


class GroupTransform(Transform):
    """Nest the named features under a sub-dict key (e.g. ``feature_tensors``)."""

    def __init__(self, mapping: Dict[str, List[str]]) -> None:
        self.mapping = mapping

    def __call__(self, batch: Batch, rng=None) -> Batch:
        batch = _tensors(batch)
        grouped_names = {name for names in self.mapping.values() for name in names}
        out = {name: value for name, value in batch.items() if name not in grouped_names}
        for group, names in self.mapping.items():
            out[group] = {name: batch[name] for name in names if name in batch}
        return out
