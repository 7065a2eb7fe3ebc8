"""Fixed-shape batches from per-query sequences, on the host.

Counterpart of ``replay_tpu/data/nn/iterator.py``, batch for batch: every
batch is ``[batch_size, max_sequence_length]``, left-padded, the last short
batch padded with repeats of its first row and flagged by a ``valid`` row
mask (which zeroes their loss and metric terms); long histories expand into
windows for training; shuffling folds the epoch into the seed through
:class:`~replay_tpu_torch.data.nn.partitioning.Partitioning`. Batches are
numpy dicts: the trainer copies them to the card (``to_device``, or the
device feed of ``fit(scan_chunk=...)``). The ragged gather is the numpy one
of :mod:`replay_tpu_torch.data.nn.ragged`.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from replay_tpu_torch.data.batching import uniform_batch_count
from replay_tpu_torch.data.nn.partitioning import Partitioning
from replay_tpu_torch.data.nn.ragged import gather_pad_spans
from replay_tpu_torch.data.nn.sequential_dataset import SequentialDataset

# id-set padding of validation batches (MetricsBuilder's contract: any negative)
DEFAULT_GROUND_TRUTH_PADDING_VALUE = -1
DEFAULT_TRAIN_PADDING_VALUE = -1

Batch = Dict[str, np.ndarray]


def _windows(length: int, max_len: int, stride: Optional[int]) -> List[Tuple[int, int]]:
    """(start, stop) windows covering a sequence; the last window always ends
    at the sequence end (recency matters for next-item training)."""
    if length <= max_len:
        return [(0, length)]
    stride = stride or max_len
    stops = list(range(max_len, length, stride)) + [length]
    return [(stop - max_len, stop) for stop in stops]


@dataclass
class SequenceBatcher:
    """Iterates fixed-shape raw batches ``{feature: [B, L], feature_mask: [B, L]}``.

    The output feeds the transform pipelines (:mod:`replay_tpu_torch.nn.transform`)
    unchanged; masks are emitted per feature under ``<name>_mask``, scalar
    features as ``[B]`` and the rows' query ids as ``query_id``.

    :param windows: expand sequences longer than ``max_sequence_length`` into
        several windows (training); when False only the last
        ``max_sequence_length`` events are kept (inference).
    :param partitioning: replica-sharding seam; defaults to one replica.
    :param bucket_boundaries: optional ascending lengths: each entry lands in
        the smallest bucket holding it and every batch is padded only to its
        bucket's length. Incompatible with ``fit(scan_chunk=...)``
        (:attr:`scan_compatible`).
    :param tracer: optional :class:`replay_tpu_torch.obs.Tracer`: every batch
        assembly is recorded as a ``batch_build`` span.
    """

    dataset: SequentialDataset
    batch_size: int
    max_sequence_length: int
    windows: bool = False
    window_stride: Optional[int] = None
    shuffle: bool = False
    seed: int = 0
    partitioning: Optional[Partitioning] = None
    epoch: int = field(default=0)
    bucket_boundaries: Optional[Sequence[int]] = None
    tracer: Optional[Any] = None

    def __post_init__(self) -> None:
        if self.bucket_boundaries and self.partitioning is not None and self.partitioning.replicas.num_replicas > 1:
            msg = (
                "bucket_boundaries cannot be combined with multi-replica "
                "partitioning: hosts would emit differing batch shapes/counts. "
                "Use fixed-shape batches for multi-host training."
            )
            raise ValueError(msg)
        self._schema = self.dataset.schema
        self._seq_names = [f.name for f in self._schema.all_features if f.is_seq]
        self._scalar_names = [f.name for f in self._schema.all_features if not f.is_seq]
        index: List[Tuple[int, int, int]] = []  # (row, start, stop)
        for row in range(len(self.dataset)):
            length = self.dataset.get_sequence_length(row)
            spans = (
                _windows(length, self.max_sequence_length, self.window_stride)
                if self.windows
                else [(max(0, length - self.max_sequence_length), length)]
            )
            index.extend((row, start, stop) for start, stop in spans)
        self._entries = np.asarray(index, dtype=np.int64).reshape(-1, 3)
        # each sequence feature as one flat array and its row offsets, the
        # layout of the ragged gather
        self._flat: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
        for name in self._seq_names:
            sequences = [np.asarray(self.dataset.get_sequence(row, name)).reshape(-1) for row in range(len(self.dataset))]
            lengths = np.array([len(s) for s in sequences], np.int64)
            offsets = np.concatenate([[0], np.cumsum(lengths)])
            flat = np.concatenate(sequences) if sequences else np.zeros(0, np.int64)
            if np.issubdtype(flat.dtype, np.integer):
                flat = np.ascontiguousarray(flat, np.int64)
            elif np.issubdtype(flat.dtype, np.floating):
                flat = np.ascontiguousarray(flat, np.float64)
            else:
                continue  # another dtype: gathered row by row
            self._flat[name] = (flat, offsets)
        self._query_ids = self.dataset.query_ids

    def _buckets(self) -> List[int]:
        # boundaries above max_sequence_length would out-grow positional tables
        boundaries = sorted(b for b in set(self.bucket_boundaries or ()) if b < self.max_sequence_length)
        boundaries.append(self.max_sequence_length)
        return boundaries

    def _bucket_ids(self, entries: np.ndarray, boundaries: List[int]) -> np.ndarray:
        lengths = np.minimum(entries[:, 2] - entries[:, 1], self.max_sequence_length)
        return np.searchsorted(np.asarray(boundaries), lengths, side="left")

    def __len__(self) -> int:
        """Number of fixed-size batches for this replica (ceil)."""
        part = self.partitioning or Partitioning()
        order = part.generate(len(self._entries), self.epoch)
        if not self.bucket_boundaries:
            return uniform_batch_count(len(order), self.batch_size)
        counts = np.bincount(self._bucket_ids(self._entries[order], self._buckets()))
        return int(sum(uniform_batch_count(int(n), self.batch_size) for n in counts if n))

    def set_epoch(self, epoch: int) -> None:
        """Advance the shuffle epoch (folds into the partitioning seed)."""
        self.epoch = epoch

    @property
    def scan_compatible(self) -> bool:
        """Whether every batch shares one ``[B, L]`` shape, which
        ``Trainer.fit(scan_chunk=...)`` needs to stack K batches."""
        return not self.bucket_boundaries

    def _entry_order(self) -> np.ndarray:
        part = self.partitioning or Partitioning(shuffle=self.shuffle, seed=self.seed)
        if self.shuffle and not part.shuffle:
            # honour shuffle=True when an unshuffled partitioning was given
            part = Partitioning(part.replicas, shuffle=True, seed=self.seed)
        return part.generate(len(self._entries), self.epoch)

    def _dtype(self, name: str):
        sample = self.dataset.get_sequence(0, name) if len(self.dataset) else np.zeros(0)
        return np.int32 if np.issubdtype(np.asarray(sample).dtype, np.integer) else np.float32

    def _make_batch(self, chunk: np.ndarray, L: int, dtypes: Dict) -> Batch:
        span = self.tracer.span("batch_build") if self.tracer is not None else contextlib.nullcontext()
        with span:
            return self._assemble_batch(chunk, L, dtypes)

    def _assemble_batch(self, chunk: np.ndarray, L: int, dtypes: Dict) -> Batch:
        n_real = len(chunk)
        if n_real < self.batch_size:  # pad the final batch by repeating its first row
            chunk = np.concatenate([chunk, np.full(self.batch_size - n_real, chunk[0], dtype=chunk.dtype)])
        batch: Batch = {}
        spans = self._entries[chunk]  # [B, 3] (row, start, stop)
        for name in self._seq_names:
            pad = self._schema[name].padding_value
            if name in self._flat:
                flat, offsets = self._flat[name]
                # a secondary feature may be shorter than the item sequence
                # that defined the window: clamp to its own row length
                row_len = offsets[spans[:, 0] + 1] - offsets[spans[:, 0]]
                stops = np.minimum(spans[:, 2], row_len)
                starts = np.minimum(spans[:, 1], stops)
                arr, mask = gather_pad_spans(flat, offsets, spans[:, 0], starts, stops, L, pad)
                batch[name] = arr.astype(dtypes[name], copy=False)
            else:
                arr = np.full((self.batch_size, L), pad, dtype=dtypes[name])
                mask = np.zeros((self.batch_size, L), dtype=bool)
                for b, (row, start, stop) in enumerate(spans.tolist()):
                    seq = self.dataset.get_sequence(row, name)[start:stop][-L:]
                    arr[b, L - len(seq) :] = seq
                    mask[b, L - len(seq) :] = True
                batch[name] = arr
            batch[f"{name}_mask"] = np.asarray(mask, bool)
        for name in self._scalar_names:
            batch[name] = np.asarray(
                [np.asarray(self.dataset.get_sequence(row, name)).reshape(-1)[0] for row in spans[:, 0].tolist()]
            )
        batch["query_id"] = np.asarray([self._query_ids[row] for row in spans[:, 0].tolist()])
        valid = np.zeros(self.batch_size, dtype=bool)
        valid[:n_real] = True
        batch["valid"] = valid
        return batch

    def __iter__(self) -> Iterator[Batch]:
        order = self._entry_order()
        dtypes = {name: self._dtype(name) for name in self._seq_names}
        if not self.bucket_boundaries:
            for chunk_start in range(0, len(order), self.batch_size):
                yield self._make_batch(order[chunk_start : chunk_start + self.batch_size], self.max_sequence_length, dtypes)
            return
        # length-bucketed: every batch pads only to its bucket's length
        boundaries = self._buckets()
        bucket_ids = self._bucket_ids(self._entries[order], boundaries)
        queues: Dict[int, list] = {bucket: [] for bucket in boundaries}
        for entry, bucket_id in zip(order, bucket_ids):
            bucket = boundaries[bucket_id]
            queues[bucket].append(entry)
            if len(queues[bucket]) == self.batch_size:
                yield self._make_batch(np.asarray(queues[bucket]), bucket, dtypes)
                queues[bucket] = []
        for bucket in boundaries:  # flush the short tails (padded, valid-masked)
            if queues[bucket]:
                yield self._make_batch(np.asarray(queues[bucket]), bucket, dtypes)


class TransformedBatches:
    """Re-iterable transform view over a batcher that forwards its streaming
    protocol (``set_epoch`` / ``supports_cursor`` / ``cursor_for`` /
    ``restore_cursor`` / ``scan_compatible``), so that ``Trainer.fit`` still
    sees the batcher's epoch hook through a transform pipeline::

        fit(TransformedBatches(batcher, Compose(pipeline)), ...)

    The transform must be a deterministic ``batch -> batch`` callable: a
    resume re-applies it to the same raw batches.
    """

    def __init__(self, source, transform) -> None:
        self.source = source
        self.transform = transform

    def __iter__(self):
        for batch in self.source:
            yield self.transform(batch)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.source, "set_epoch"):
            self.source.set_epoch(epoch)

    @property
    def supports_cursor(self) -> bool:
        return bool(getattr(self.source, "supports_cursor", False))

    def cursor_for(self, batches_emitted: int):
        return self.source.cursor_for(batches_emitted)

    def restore_cursor(self, cursor) -> None:
        self.source.restore_cursor(cursor)

    @property
    def scan_compatible(self) -> bool:
        return bool(getattr(self.source, "scan_compatible", True))


def validation_batches(
    train: SequentialDataset,
    ground_truth: SequentialDataset,
    batch_size: int,
    max_sequence_length: int,
    partitioning: Optional[Partitioning] = None,
) -> Iterator[Batch]:
    """Batches for ``Trainer.validate``: input histories from ``train`` plus
    the padded ``ground_truth`` and ``train`` id sets (−1 padding,
    MetricsBuilder's contract), for the queries present in both splits."""
    train_common, gt_common = SequentialDataset.keep_common_query_ids(train, ground_truth)
    item_col = train_common.item_id_column
    gt_max = max((gt_common.get_sequence_length(i) for i in range(len(gt_common))), default=1)
    train_max = max((train_common.get_sequence_length(i) for i in range(len(train_common))), default=1)
    batcher = SequenceBatcher(
        train_common, batch_size=batch_size, max_sequence_length=max_sequence_length,
        windows=False, partitioning=partitioning,
    )
    for batch in batcher:
        n = len(batch["query_id"])
        gt = np.full((n, gt_max), DEFAULT_GROUND_TRUTH_PADDING_VALUE, dtype=np.int64)
        seen = np.full((n, train_max), DEFAULT_TRAIN_PADDING_VALUE, dtype=np.int64)
        for b, query_id in enumerate(batch["query_id"]):
            if not batch["valid"][b]:
                continue
            gt_seq = gt_common.get_sequence_by_query_id(query_id, item_col)
            gt[b, : len(gt_seq)] = gt_seq
            seen_seq = train_common.get_sequence_by_query_id(query_id, item_col)
            seen[b, : len(seen_seq)] = seen_seq
        batch["ground_truth"] = gt
        batch["train"] = seen
        yield batch
