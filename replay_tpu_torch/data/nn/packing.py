"""Sequence packing: several short user sequences in one ``[B, L]`` row.

Counterpart of ``replay_tpu/data/nn/packing.py``, batch for batch. On real
interaction logs most sequences are far shorter than ``max_sequence_length``,
so fixed-shape batches are mostly padding. Packing fills the rows with
first-fit, length-bucketed bin packing:

* each entry's length is rounded up to the smallest bucket boundary holding
  it (no boundaries: exact lengths);
* entries go first-fit, in stream order, into a bounded window of open rows
  of capacity ``max_sequence_length``;
* every packed row carries ``segment_ids``, 0 on padding and ``1..k`` per
  packed sequence, which the unfused attention route turns into a
  block-diagonal mask (``nn/mask.py::segment_attention_mask``) and the packed
  transform template into a cross-segment label mask.

The packed batch is assembled by one gather per feature over the batcher's
flat columns (the JAX package loops over every segment in Python).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from replay_tpu_torch.data.batching import uniform_batch_count
from replay_tpu_torch.data.nn.iterator import Batch, SequenceBatcher


def bucketed_length(length: int, capacity: int, boundaries: Optional[Sequence[int]]) -> int:
    """``length`` rounded up to the smallest bucket boundary holding it
    (boundaries at or above ``capacity`` are ignored; no boundaries = exact)."""
    length = min(length, capacity)
    if not boundaries:
        return length
    for bound in sorted(b for b in set(boundaries) if b < capacity):
        if length <= bound:
            return bound
    return capacity


def first_fit_pack(
    lengths: Sequence[int],
    capacity: int,
    bucket_boundaries: Optional[Sequence[int]] = None,
    open_rows: int = 64,
) -> List[List[int]]:
    """First-fit bin packing of entry indices into rows of ``capacity`` slots.

    Deterministic in input order: each entry goes to the first open row with
    room for its (bucket-rounded) length; at most ``open_rows`` rows stay
    open, the oldest closing first. Returns the packed rows, each a list of
    entry indices in placement order.
    """
    if capacity < 1:
        msg = "capacity must be >= 1"
        raise ValueError(msg)
    bounds = sorted(b for b in set(bucket_boundaries or ()) if b < capacity)
    closed: List[List[int]] = []
    open_bins: List[Tuple[int, List[int]]] = []  # (free slots, entry indices)
    for index, raw in enumerate(lengths):
        need = min(int(raw), capacity)
        if bounds:  # round up to the smallest holding bucket, else capacity
            need = next((b for b in bounds if need <= b), capacity)
        if need < 1:
            need = 1
        placed = False
        for slot, (free, members) in enumerate(open_bins):
            if need <= free:
                members.append(index)
                open_bins[slot] = (free - need, members)
                placed = True
                break
        if not placed:
            open_bins.append((capacity - need, [index]))
            if len(open_bins) > open_rows:
                free, members = open_bins.pop(0)
                closed.append(members)
    closed.extend(members for _, members in open_bins)
    return closed


def _slot_widths(takes: np.ndarray, capacity: int, boundaries: Optional[Sequence[int]]) -> np.ndarray:
    """:func:`bucketed_length` of every entry of ``takes`` at once."""
    takes = np.minimum(takes, capacity)
    if not boundaries:
        return takes
    bounds = np.asarray(sorted(b for b in set(boundaries) if b < capacity) + [capacity], np.int64)
    return bounds[np.searchsorted(bounds, takes, side="left")]


@dataclass
class PackedSequenceBatcher(SequenceBatcher):
    """A :class:`SequenceBatcher` that packs several sequences per row.

    Emits fixed ``[batch_size, max_sequence_length]`` batches where each row
    holds up to ``max_segments`` (0: no limit) left-aligned sequences back to
    back: ``{feature: [B, L], feature_mask: [B, L], segment_ids: [B, L],
    valid: [B]}``. ``segment_ids`` is 0 on padding and ``1..k`` per packed
    sequence; the feature masks are True exactly where ``segment_ids > 0``.
    A scalar feature takes the row's first sequence's value.

    Feed it through
    :func:`~replay_tpu_torch.nn.transform.template.make_packed_sasrec_transforms`
    into a model whose ``forward`` takes ``segment_ids`` (SASRec, BERT4Rec) on
    the unfused route: attention and loss then never cross a segment. Every
    batch has one shape, so ``fit(scan_chunk=K)`` takes it.

    ``bucket_boundaries`` sets the packing's slot quantization here, not
    per-batch widths, so multi-replica partitioning keeps working.
    """

    max_segments: int = 0  # 0 = unlimited
    open_rows: int = 64

    def __post_init__(self) -> None:
        # the parent refuses bucket boundaries with replicas (bucketed widths);
        # here they only quantize slots, and every batch keeps one shape
        boundaries, self.bucket_boundaries = self.bucket_boundaries, None
        super().__post_init__()
        self.bucket_boundaries = boundaries
        self._pack_cache = None

    @property
    def scan_compatible(self) -> bool:  # type: ignore[override]
        """Packed batches all share one ``[B, L]`` shape (the packing rounds
        slots, not batch widths), so the scan-chunked fit accepts them."""
        return True

    def _packed_rows(self, order: np.ndarray) -> List[List[int]]:
        # the packing is a pure function of the epoch's entry order: packed
        # once for len(), iteration and packing_summary()
        cache_key = (self.epoch, self.shuffle, self.seed, len(order))
        if self._pack_cache is not None and self._pack_cache[0] == cache_key:
            return self._pack_cache[1]
        entries = self._entries[order]
        lengths = np.minimum(entries[:, 2] - entries[:, 1], self.max_sequence_length)
        rows = first_fit_pack(lengths.tolist(), self.max_sequence_length, self.bucket_boundaries, open_rows=self.open_rows)
        if self.max_segments:
            rows = [
                members[start : start + self.max_segments]
                for members in rows
                for start in range(0, len(members), self.max_segments)
            ]
        rows = [order[members].tolist() for members in rows]  # positions in the order -> entry ids
        self._pack_cache = (cache_key, rows)
        return rows

    def __len__(self) -> int:  # type: ignore[override]
        return uniform_batch_count(len(self._packed_rows(self._entry_order())), self.batch_size)

    def _assemble_packed(self, rows: List[List[int]], dtypes: Dict) -> Batch:
        L, B = self.max_sequence_length, self.batch_size
        counts = np.fromiter((len(members) for members in rows), np.int64, len(rows))
        members = np.fromiter((entry for row in rows for entry in row), np.int64, int(counts.sum()))
        row_of = np.repeat(np.arange(len(rows)), counts)  # each segment's batch row
        first_of_row = np.cumsum(counts) - counts  # each row's first segment
        seg_number = np.arange(len(members)) - np.repeat(first_of_row, counts) + 1
        spans = self._entries[members]  # (dataset row, start, stop)
        data_rows, stops = spans[:, 0], spans[:, 2]
        take = np.minimum(stops - spans[:, 1], L)
        # recency truncation as in the unpacked batcher: the last `take` events
        seg_start = stops - take
        widths = _slot_widths(take, L, self.bucket_boundaries)
        ends = np.cumsum(widths)
        offsets = ends - widths - np.repeat(ends[first_of_row] - widths[first_of_row], counts)
        overflow = np.flatnonzero(offsets + take > L)
        if len(overflow):
            # first-fit packed the bucketed widths; a real length cannot exceed its bucket
            at = overflow[0]
            msg = f"packed row overflow: offset {offsets[at]} + {take[at]} > {L}"
            raise RuntimeError(msg)
        segment_ids = np.zeros((B, L), np.int32)
        token_row = np.repeat(row_of, take)
        within = np.arange(int(take.sum())) - np.repeat(np.cumsum(take) - take, take)
        segment_ids[token_row, np.repeat(offsets, take) + within] = np.repeat(seg_number, take)
        batch: Batch = {}
        for name in self._seq_names:
            arr = np.full((B, L), self._schema[name].padding_value, dtype=dtypes[name])
            if name in self._flat:
                flat, flat_offsets = self._flat[name]
                # a secondary feature may be shorter than the item sequence
                # that defined the window: clamp to its own row length
                row_len = flat_offsets[data_rows + 1] - flat_offsets[data_rows]
                lo, hi = np.minimum(seg_start, row_len), np.minimum(stops, row_len)
                count = hi - lo
                within = np.arange(int(count.sum())) - np.repeat(np.cumsum(count) - count, count)
                source = np.repeat(flat_offsets[data_rows] + lo, count) + within
                arr[np.repeat(row_of, count), np.repeat(offsets, count) + within] = flat[source]
            else:
                for b, row, lo, hi, offset, width in zip(row_of, data_rows, seg_start, stops, offsets, take):
                    seq = np.asarray(self.dataset.get_sequence(int(row), name)).reshape(-1)
                    seg = seq[min(lo, len(seq)) : min(hi, len(seq))][-width:]
                    arr[b, offset : offset + len(seg)] = seg
            batch[name] = arr
            batch[f"{name}_mask"] = segment_ids > 0
        for name in self._scalar_names:
            # a packed row holds several queries: scalar features take the
            # first segment's value (consumers should not rely on them)
            column = np.asarray(
                [np.asarray(self.dataset.get_sequence(int(row), name)).reshape(-1)[0] for row in data_rows[first_of_row]]
            )
            if len(column) == 0:
                column = np.zeros(0, np.int64)
            if len(column) < B:  # pad the final short batch to the fixed shape
                fill = column[:1] if len(column) else np.zeros(1, column.dtype)
                column = np.concatenate([column, np.repeat(fill, B - len(column))])
            batch[name] = column
        batch["segment_ids"] = segment_ids
        valid = np.zeros(B, bool)
        valid[: len(rows)] = True
        batch["valid"] = valid
        return batch

    def __iter__(self) -> Iterator[Batch]:  # type: ignore[override]
        dtypes = {name: self._dtype(name) for name in self._seq_names}
        rows = self._packed_rows(self._entry_order())
        for start in range(0, len(rows), self.batch_size):
            span = self.tracer.span("batch_build") if self.tracer is not None else contextlib.nullcontext()
            with span:
                batch = self._assemble_packed(rows[start : start + self.batch_size], dtypes)
            yield batch

    def packing_summary(self) -> Dict[str, float]:
        """Epoch-level packing figures: ``padding_fraction`` (the share of the
        ``[B, L]`` token grid that is padding), ``rows`` (packed rows),
        ``segments_per_row`` and the unpacked batcher's padding fraction for
        the same entries."""
        order = self._entry_order()
        entries = self._entries[order]
        lengths = np.minimum(entries[:, 2] - entries[:, 1], self.max_sequence_length)
        rows = self._packed_rows(order)
        grid = uniform_batch_count(len(rows), self.batch_size) * self.batch_size * self.max_sequence_length
        real = int(lengths.sum())
        unpacked_grid = uniform_batch_count(len(entries), self.batch_size) * self.batch_size * self.max_sequence_length
        return {
            "rows": float(len(rows)),
            "segments_per_row": float(len(entries)) / max(len(rows), 1),
            "padding_fraction": 1.0 - real / grid if grid else 0.0,
            "unpacked_padding_fraction": 1.0 - real / unpacked_grid if unpacked_grid else 0.0,
        }
