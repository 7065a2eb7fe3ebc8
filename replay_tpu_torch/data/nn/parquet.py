"""Streaming parquet input for out-of-core training.

Counterpart of ``replay_tpu/data/nn/parquet.py``, batch for batch and cursor
for cursor: slabs of rows stream through pyarrow, each slab's rows are
sharded by the :class:`Partitioning` seam the in-memory batcher uses, and
ragged list columns are gathered into the fixed left-padded ``[batch,
max_len]`` layout with ``<name>_mask`` masks
(:mod:`replay_tpu_torch.data.nn.ragged`). Every emitted batch has exactly
``batch_size`` rows (the final short batch is padded and flagged through
``valid``), so one captured program serves the whole epoch.

``shard="row_groups"`` plans the epoch from parquet footers only (file paths,
per-row-group row and byte counts) and deals whole row groups to replicas
round-robin (:meth:`Partitioning.shard_items`), so each replica reads a
disjoint byte range. ``memory_budget_bytes`` splits oversized groups into
sub-slabs, ``read_ahead`` overlaps the next slab's file reads with batch
assembly on a background thread (:func:`~replay_tpu_torch.data.nn.prefetch.prefetch`),
and every batch boundary records a :class:`StreamCursor`, a JSON (epoch,
slab, row offset, carry) record that ``Trainer.fit`` writes into its
checkpoints and ``fit(resume=True)`` seeks back to. A cursor written by
either package restores in the other.

pyarrow is imported inside the functions that read or write parquet only:
importing the port never loads it.

Metadata: ``{column: {"shape": L, "padding": v}}`` marks list columns;
scalar columns need no entry.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np

from replay_tpu_torch.data.nn.partitioning import Partitioning, ReplicasInfo
from replay_tpu_torch.data.nn.ragged import gather_pad, gather_pad_2d

logger = logging.getLogger("replay_tpu_torch")

Batch = Dict[str, np.ndarray]

# cursor history retention: bounded so an unattended fit can't grow without
# limit, generous enough to cover any sane read-ahead (prefetch depth + scan
# chunk buffering put the producer at most a few dozen batches past the step
# the trainer checkpoints)
_CURSOR_HISTORY = 1024


@dataclass(frozen=True)
class StreamCursor:
    """A resumable position in a row-group-sharded parquet stream.

    Recorded at every BATCH boundary; fully describes the state needed to
    continue the epoch bit-for-bit without rescanning what came before:

    * ``slab``: index into this replica's deterministic slab sequence (the
      epoch plan is a pure function of (source metadata, seed, epoch,
      replica)); slabs before it are skipped WITHOUT reading.
    * ``rows``: rows of the current slab's (deterministically shuffled) order
      already consumed — the one slab that is re-read and fast-forwarded.
    * ``carry``: the < batch_size leftover rows that preceded the current
      slab (cross-slab re-chunking state), serialized as plain JSON.
    * ``batches``: batches emitted so far this epoch — must line up with the
      trainer's ``step_in_epoch`` checkpoint position.
    """

    epoch: int
    slab: int
    rows: int
    batches: int
    carry: Optional[Dict[str, Any]] = None
    # shape/dtype spec of an emitted batch — set on cursors past the first
    # batch so a resume that finds no real batches left (landing among the
    # tail's valid=False alignment batches) can rebuild them (zero-filled)
    # without any pre-preemption history
    pad_spec: Optional[Dict[str, Any]] = None
    # the plan fingerprint (replica layout, seed, shuffle, batch size): the
    # slab sequence is only meaningful under the SAME plan — restoring a
    # cursor under a changed replica count / seed would silently re-train
    # consumed row groups and skip unseen ones, so mismatches fail loudly
    # (an INTENDED replica-count change goes through :meth:`rehash` instead)
    plan: Optional[Dict[str, Any]] = None
    # elastic-resume marker (:meth:`rehash`): ``{"old_plan": ..., "batches":
    # B}`` — the pre-migration plan and the globally aligned batch ordinal the
    # migration starts from. Set on a rehashed cursor and on every cursor
    # recorded while iterating the migrated epoch; the batcher rebuilds the
    # migration work list from it deterministically on every restore.
    migration: Optional[Dict[str, Any]] = None

    def to_metadata(self) -> Dict[str, Any]:
        """Pure-JSON form (the checkpoint sidecar is a JSON document)."""
        return {
            "epoch": int(self.epoch),
            "slab": int(self.slab),
            "rows": int(self.rows),
            "batches": int(self.batches),
            "carry": self.carry,
            "pad_spec": self.pad_spec,
            "plan": self.plan,
            "migration": self.migration,
        }

    @classmethod
    def from_metadata(cls, record: Dict[str, Any]) -> "StreamCursor":
        return cls(
            epoch=int(record["epoch"]),
            slab=int(record["slab"]),
            rows=int(record["rows"]),
            batches=int(record["batches"]),
            carry=record.get("carry"),
            pad_spec=record.get("pad_spec"),
            plan=record.get("plan"),
            migration=record.get("migration"),
        )

    def rehash(self, new_replica_count: int) -> "StreamCursor":
        """Migrate this mid-epoch position onto ``new_replica_count`` replicas.

        The elastic-resume entrypoint: where :meth:`ParquetBatcher.
        restore_cursor` REFUSES a changed replica layout (restoring a
        one-replica slab sequence on a different layout would silently replay
        consumed row groups and skip unseen ones), a rehashed cursor is a
        sanctioned, loudly-logged migration. It works because the stream's
        step-alignment invariant makes every replica's position at a global
        checkpoint arithmetically recomputable: all replicas sit at the same
        batch ordinal ``B``, so old replica *r* has consumed exactly
        ``min(B * batch_size, its_total_rows)`` rows of its deterministic
        (plan-replayable) slab stream. The batcher rebuilds every old
        replica's remainder from footer metadata alone, pools the remaining
        (sub-)slabs — with a skip offset on the one partially consumed slab
        per old replica — and deals them round-robin to the new layout, with
        an exactly-once coverage audit (consumed rows never re-emitted,
        unseen rows all assigned — :meth:`ParquetBatcher.migration_coverage`).

        Every NEW replica restores the SAME rehashed cursor (it is
        replica-id-agnostic); each batcher then takes its own share of the
        migration work list. Chained rehashes are refused — finish (or
        restart) the migrated epoch first.
        """
        new = int(new_replica_count)
        if new < 1:
            msg = f"new_replica_count must be >= 1, got {new}"
            raise ValueError(msg)
        if self.migration is not None:
            msg = (
                "cursor already carries a migration (rehash-of-rehash): finish "
                "the migrated epoch (or restart it) before rehashing again"
            )
            raise ValueError(msg)
        if self.plan is None:
            msg = "cursor carries no plan fingerprint; cannot rehash"
            raise ValueError(msg)
        return StreamCursor(
            epoch=self.epoch,
            slab=0,
            rows=0,
            batches=self.batches,
            carry=None,  # positions are recomputed arithmetically from B
            pad_spec=self.pad_spec,
            # replica_id None = any replica of the new layout may restore this
            plan={**self.plan, "num_replicas": new, "replica_id": None},
            migration={"old_plan": dict(self.plan), "batches": int(self.batches)},
        )


def _serialize_carry(carry: Optional[Batch]) -> Optional[Dict[str, Any]]:
    if carry is None:
        return None
    out: Dict[str, Any] = {}
    for name, value in carry.items():
        arr = np.asarray(value)
        out[name] = {
            "dtype": arr.dtype.str,
            "shape": list(arr.shape),
            "values": arr.reshape(-1).tolist(),
        }
    return out


def _deserialize_carry(record: Optional[Dict[str, Any]]) -> Optional[Batch]:
    if record is None:
        return None
    out: Batch = {}
    for name, entry in record.items():
        out[name] = np.asarray(entry["values"], dtype=np.dtype(entry["dtype"])).reshape(
            entry["shape"]
        )
    return out


def _batch_spec(batch: Batch) -> Dict[str, Any]:
    """JSON shape/dtype spec of a batch (no values)."""
    return {
        name: {"dtype": np.asarray(v).dtype.str, "shape": list(np.asarray(v).shape)}
        for name, v in batch.items()
        if name != "valid"
    }


def _zero_batch(spec: Dict[str, Any], batch_size: int) -> Batch:
    """A deterministic all-masked alignment batch from a shape spec: zero
    content, ``valid`` all False — identical whether built by an uninterrupted
    run or a resumed one."""
    out: Batch = {
        name: np.zeros(entry["shape"], dtype=np.dtype(entry["dtype"]))
        for name, entry in spec.items()
    }
    out["valid"] = np.zeros(batch_size, bool)
    return out


@dataclass(frozen=True)
class _Slab:
    """One planned read unit: a contiguous row range of one row group."""

    file_index: int
    group: int
    start: int  # row offset within the group
    rows: int
    order_seed: int  # global sub-slab index — seeds the within-slab shuffle


@dataclass
class ParquetBatcher:
    """Iterate fixed-shape batches from a parquet file/directory.

    :param source: path to a parquet file or dataset directory.
    :param metadata: list-column spec ``{name: {"shape": int, "padding": int}}``.
    :param partition_size: rows per streamed slab (default 2**20);
        shuffling happens within a slab, sharding across replicas per slab.
        ``shard="rows"`` only — row-group mode streams whole row groups.
    :param shard: ``"rows"`` (legacy: every replica scans every slab and takes
        a strided row slice) or ``"row_groups"`` (each replica reads a DISJOINT
        round-robin share of the row groups — the multi-host streaming mode,
        resumable via :meth:`cursor_for`).
    :param memory_budget_bytes: row-group mode only — split groups whose
        uncompressed footprint (from footer metadata) exceeds this into
        sub-slabs, bounding the resident working set; the knob that makes
        datasets ≫ host RAM stream.
    :param read_ahead: row-group mode only — slabs to read ahead on a
        background thread (host file I/O overlaps batch assembly, which in
        turn feeds the trainer's DevicePrefetcher for the full
        disk → host → device overlap chain). 0 = synchronous reads.
    """

    source: str
    batch_size: int
    metadata: Dict[str, Dict[str, int]] = field(default_factory=dict)
    columns: Optional[list] = None
    partition_size: int = 1 << 20
    shuffle: bool = False
    seed: int = 0
    partitioning: Optional[Partitioning] = None
    epoch: int = 0
    shard: str = "rows"
    memory_budget_bytes: Optional[int] = None
    read_ahead: int = 0

    def __post_init__(self) -> None:
        if self.shard not in ("rows", "row_groups"):
            msg = f"shard must be 'rows' or 'row_groups', got {self.shard!r}"
            raise ValueError(msg)
        if self.read_ahead < 0:
            msg = "read_ahead must be >= 0"
            raise ValueError(msg)
        # batch-boundary cursor history for the resumable stream: ordinal
        # (batches emitted this epoch) -> StreamCursor. Written by __iter__
        # (possibly on a prefetch thread), read by Trainer.save_mid_epoch.
        self._cursor_lock = threading.Lock()
        self._cursor_history: Dict[int, StreamCursor] = {}
        self._pending_cursor: Optional[StreamCursor] = None

    # -- cursor API (row-group mode) ------------------------------------- #
    @property
    def supports_cursor(self) -> bool:
        """Whether this batcher records resumable stream positions (the
        trainer persists them into the checkpoint sidecar when True)."""
        return self.shard == "row_groups"

    def cursor_for(self, batches_emitted: int) -> StreamCursor:
        """The stream position after ``batches_emitted`` batches of the
        current epoch — safe to call while a prefetch thread reads ahead
        (cursors are recorded when batches are PRODUCED, so every consumed
        batch's boundary is present)."""
        if not self.supports_cursor:
            msg = "cursor_for requires shard='row_groups'"
            raise ValueError(msg)
        with self._cursor_lock:
            cursor = self._cursor_history.get(batches_emitted)
        if cursor is None:
            msg = (
                f"no cursor recorded for batch ordinal {batches_emitted} "
                f"(epoch {self.epoch}); the stream has either not reached it "
                f"or its history entry aged out (retention {_CURSOR_HISTORY})"
            )
            raise KeyError(msg)
        return cursor

    def restore_cursor(self, cursor) -> None:
        """Arm the NEXT iteration to resume from ``cursor`` (one-shot).

        Accepts a :class:`StreamCursor` or its ``to_metadata()`` JSON dict
        (the checkpoint-sidecar form). The cursor's epoch must match the
        batcher's current epoch — ``Trainer.fit`` calls ``set_epoch`` before
        iterating, so a stale cursor fails loudly instead of silently
        replaying the wrong slab order.
        """
        if not self.supports_cursor:
            msg = "restore_cursor requires shard='row_groups'"
            raise ValueError(msg)
        if isinstance(cursor, dict):
            cursor = StreamCursor.from_metadata(cursor)
        signature = self._plan_signature()
        if cursor.migration is not None:
            # elastic resume (StreamCursor.rehash): the plan must match on
            # everything EXCEPT replica identity — a fresh rehashed cursor is
            # replica-id-agnostic (replica_id None), a cursor recorded DURING
            # a migrated epoch pins the replica it was recorded on
            ignore = (
                ("replica_id",)
                if (cursor.plan or {}).get("replica_id") is None
                else ()
            )
            theirs = {k: v for k, v in (cursor.plan or {}).items() if k not in ignore}
            mine = {k: v for k, v in signature.items() if k not in ignore}
            if theirs != mine:
                msg = (
                    "rehashed stream cursor targets a different plan "
                    f"(cursor {cursor.plan} vs batcher {signature}): rehash "
                    "changes ONLY the replica count — seed, shuffle, batch "
                    "size and memory budget must match the recording run, and "
                    "the batcher's replica layout must match the rehash target."
                )
                raise ValueError(msg)
            old_plan = cursor.migration.get("old_plan") or {}
            logger.warning(
                "elastic resume: migrating row-group plan from %s to %s "
                "replicas at batch ordinal %s (epoch %s); consumed groups are "
                "never re-emitted, unseen groups are re-dealt round-robin "
                "(coverage audited when iteration starts)",
                old_plan.get("num_replicas"),
                signature["num_replicas"],
                cursor.migration.get("batches"),
                cursor.epoch,
            )
        elif cursor.plan is not None and cursor.plan != signature:
            msg = (
                "stream cursor was recorded under a different epoch plan "
                f"(cursor {cursor.plan} vs batcher {signature}): "
                "its slab sequence would replay/skip the wrong row groups. "
                "Resume with the SAME replica layout, seed, shuffle and "
                "batch size, restart the epoch, or — for an intended replica-"
                "count change — migrate with StreamCursor.rehash(new_count)."
            )
            raise ValueError(msg)
        self._pending_cursor = cursor
        if cursor.epoch == self.epoch:
            # the restored position is queryable immediately (cursor_for of
            # the resume point), before the first batch is pulled
            self._record_cursor(cursor)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        with self._cursor_lock:
            self._cursor_history.clear()
        if self.supports_cursor:
            # the epoch-start position exists before any batch is pulled
            self._record_cursor(StreamCursor(epoch=epoch, slab=0, rows=0, batches=0))

    def _plan_signature(self) -> Dict[str, Any]:
        """The config half of the epoch plan (no I/O): a cursor is only
        replayable under an identical signature."""
        part = self.partitioning or Partitioning(shuffle=self.shuffle, seed=self.seed)
        shuffled = bool(self.shuffle or part.shuffle)
        return {
            "num_replicas": int(part.replicas.num_replicas),
            "replica_id": int(part.replicas.replica_id),
            "seed": int(part.seed if part.shuffle else self.seed),
            "shuffle": shuffled,
            "batch_size": int(self.batch_size),
            "memory_budget_bytes": self.memory_budget_bytes,
        }

    def _record_cursor(self, cursor: StreamCursor) -> None:
        if cursor.plan is None:
            import dataclasses

            cursor = dataclasses.replace(cursor, plan=self._plan_signature())
        with self._cursor_lock:
            self._cursor_history[cursor.batches] = cursor
            if len(self._cursor_history) > _CURSOR_HISTORY:
                for stale in sorted(self._cursor_history)[
                    : len(self._cursor_history) - _CURSOR_HISTORY
                ]:
                    del self._cursor_history[stale]

    # -- source plumbing --------------------------------------------------- #
    def _filesystem(self):
        """The arrow filesystem of a URI source (``dataset.files`` paths are
        relative to it — every footer/row-group read must go through it), or
        None for plain local paths."""
        if "://" in str(self.source):
            from pyarrow.fs import FileSystem

            filesystem, _ = FileSystem.from_uri(str(self.source))
            return filesystem
        return None

    def _dataset(self):
        import pyarrow.dataset as ds

        if "://" in str(self.source):
            # remote/URI sources (s3://, gs://, hdfs://, file://) resolve
            # through arrow's filesystem registry
            from pyarrow.fs import FileSystem

            filesystem, path = FileSystem.from_uri(str(self.source))
            return ds.dataset(path, format="parquet", filesystem=filesystem)
        return ds.dataset(self.source, format="parquet")

    def _slabs(self):
        dataset = self._dataset()
        names = self.columns or dataset.schema.names
        yield from dataset.to_batches(columns=names, batch_size=self.partition_size)

    def _materialize(self, slab, order: np.ndarray) -> Batch:
        """Gather ``order`` rows of a slab into fixed numpy tensors."""
        import pyarrow as pa

        out: Batch = {}
        for name in slab.schema.names:
            column = slab.column(name)
            if isinstance(column.type, (pa.ListType, pa.LargeListType)):
                spec = self.metadata.get(name)
                if spec is None:
                    msg = f"List column '{name}' needs a metadata entry with its shape."
                    raise ValueError(msg)
                combined = column.combine_chunks() if isinstance(column, pa.ChunkedArray) else column
                offsets = np.asarray(combined.offsets, np.int64)
                inner = combined.values
                shape = spec["shape"]
                if isinstance(inner.type, (pa.ListType, pa.LargeListType)):
                    # list-of-list (Array2D): per-step feature vectors of a
                    # fixed width
                    if not isinstance(shape, (list, tuple)) or len(shape) != 2:
                        msg = (
                            f"2-D list column '{name}' needs metadata shape [L, D], "
                            f"got {shape!r}."
                        )
                        raise ValueError(msg)
                    length, width = int(shape[0]), int(shape[1])
                    inner_offsets = np.asarray(inner.offsets, np.int64)
                    widths = np.diff(inner_offsets)
                    if len(widths) and not (widths == width).all():
                        observed = np.unique(widths[widths != width])[:3]
                        msg = (
                            f"2-D column '{name}' declares inner width {width} but "
                            f"the data has widths {observed.tolist()}…"
                        )
                        raise ValueError(msg)
                    tensor, mask = gather_pad_2d(
                        np.asarray(inner.values),
                        offsets,
                        order,
                        length,
                        width,
                        spec.get("padding", 0),
                    )
                else:
                    if isinstance(shape, (list, tuple)):
                        if len(shape) != 1:
                            msg = (
                                f"1-D list column '{name}' has metadata shape "
                                f"{shape!r}; expected a scalar length or [L]."
                            )
                            raise ValueError(msg)
                        shape = shape[0]
                    tensor, mask = gather_pad(
                        np.asarray(inner),  # keeps int vs float dtype
                        offsets,
                        order,
                        int(shape),
                        spec.get("padding", 0),
                    )
                out[name] = tensor
                out[f"{name}_mask"] = mask
            else:
                out[name] = np.asarray(column)[order]
        return out

    # -- epoch planning (row-group mode) ----------------------------------- #
    def _group_table(self) -> List[Tuple[str, int, int, int]]:
        """(path, group_index, num_rows, uncompressed_bytes) for every row
        group of the source, in sorted-path order — read from parquet FOOTERS
        only, so planning an epoch over a TB-scale dataset touches no data."""
        import pyarrow.parquet as pq

        dataset = self._dataset()
        files = sorted(dataset.files) if getattr(dataset, "files", None) else [str(self.source)]
        filesystem = self._filesystem()
        table: List[Tuple[str, int, int, int]] = []
        for path in files:
            meta = pq.ParquetFile(path, filesystem=filesystem).metadata
            for g in range(meta.num_row_groups):
                group = meta.row_group(g)
                table.append((path, g, group.num_rows, group.total_byte_size))
        return table

    def _effective_partitioning(self) -> Partitioning:
        part = self.partitioning or Partitioning(shuffle=self.shuffle, seed=self.seed)
        if self.shuffle and not part.shuffle:
            part = Partitioning(part.replicas, shuffle=True, seed=self.seed)
        return part

    def _slabs_for(
        self,
        groups: List[Tuple[str, int, int, int]],
        part: Partitioning,
        epoch: int,
        replica_id: Optional[int] = None,
    ) -> Tuple[List[_Slab], List[str]]:
        """One replica's deterministic slab sequence under ``part`` — the
        replayable half of the epoch plan, parameterized so an elastic
        migration can reconstruct ANY replica's stream of ANY (old) layout
        from footer metadata alone."""
        mine = part.shard_items(len(groups), epoch=epoch, replica_id=replica_id)
        slabs: List[_Slab] = []
        paths: List[str] = []
        for seq, index in enumerate(mine):
            path, g, rows, nbytes = groups[index]
            budget = self.memory_budget_bytes
            per_slab = rows
            if budget and rows:
                # sub-slab size from FOOTER byte counts: the resident working
                # set stays bounded no matter how large a group was written
                row_bytes = max(1, nbytes // rows)
                per_slab = max(1, min(rows, budget // row_bytes))
            start = 0
            sub = 0
            while start < rows:
                take = min(per_slab, rows - start)
                slabs.append(
                    _Slab(
                        file_index=seq,
                        group=g,
                        start=start,
                        rows=take,
                        # fold the GLOBAL group index + sub-slab into the
                        # shuffle seed so every slab shuffles differently and
                        # identically across runs
                        order_seed=int(index) * 4096 + sub,
                    )
                )
                paths.append(path)  # slabs and paths zip by position
                start += take
                sub += 1
        return slabs, paths

    def _plan(self, epoch: int):
        """The epoch plan: THIS replica's slab sequence + the globally aligned
        batch count. Pure function of (footer metadata, seed, epoch, replica)
        — both sides of a preemption compute the identical plan."""
        part = self._effective_partitioning()
        groups = self._group_table()
        replicas = part.replicas
        if groups and len(groups) < replicas.num_replicas:
            msg = (
                f"shard='row_groups' needs at least one row group per replica: "
                f"{len(groups)} group(s) for {replicas.num_replicas} replicas. "
                "Write smaller row groups "
                "(write_sequence_parquet(rows_per_chunk=...))."
            )
            raise ValueError(msg)
        # alignment: every replica must emit the same number of batches (the
        # collective-friendly invariant) — compute each replica's row total
        # from the shared plan and pad the short ones with valid=False batches
        max_batches = 0
        for replica in range(replicas.num_replicas):
            assigned = part.shard_items(len(groups), epoch=epoch, replica_id=replica)
            rows = int(sum(groups[i][2] for i in assigned))
            max_batches = max(max_batches, -(-rows // self.batch_size))
        slabs, paths = self._slabs_for(groups, part, epoch)
        return slabs, paths, max_batches

    # -- elastic migration (StreamCursor.rehash) -------------------------- #
    def _migration_work(
        self, epoch: int, migration: Dict[str, Any]
    ) -> Tuple[List[Tuple[_Slab, str, int]], Dict[str, Any]]:
        """The GLOBAL migration work list + coverage audit.

        Replays every OLD replica's deterministic slab stream (footer
        metadata only, no data reads) and cuts it at the rows that replica
        had consumed by the aligned batch ordinal ``B`` — ``min(B *
        batch_size, its total rows)``, exact because rows are emitted in
        stream order and short replicas pad with valid=False alignment
        batches AFTER their data ends. The remainder — whole unread
        (sub-)slabs plus at most one partially consumed slab per old replica,
        carried with its skip offset into the slab's deterministic shuffled
        order — is the work list, in a deterministic global order every new
        replica computes identically.
        """
        old_plan = dict(migration["old_plan"])
        batches = int(migration["batches"])
        batch_size = int(old_plan["batch_size"])
        groups = self._group_table()
        old_part = Partitioning(
            ReplicasInfo(int(old_plan["num_replicas"]), 0),
            shuffle=bool(old_plan["shuffle"]),
            seed=int(old_plan["seed"]),
        )
        work: List[Tuple[_Slab, str, int]] = []
        total_rows = sum(g[2] for g in groups)
        consumed_rows = 0
        partial_slabs = 0
        for replica in range(int(old_plan["num_replicas"])):
            slabs_r, paths_r = self._slabs_for(groups, old_part, epoch, replica)
            replica_rows = sum(s.rows for s in slabs_r)
            consumed = min(batches * batch_size, replica_rows)
            consumed_rows += consumed
            acc = 0
            for slab, path in zip(slabs_r, paths_r):
                if acc + slab.rows <= consumed:
                    acc += slab.rows  # fully consumed: never re-read
                    continue
                skip = max(0, consumed - acc)
                if skip:
                    partial_slabs += 1
                work.append((slab, path, skip))
                acc += slab.rows
        assigned_rows = sum(slab.rows - skip for slab, _, skip in work)
        audit = {
            "total_rows": int(total_rows),
            "consumed_rows": int(consumed_rows),
            "assigned_rows": int(assigned_rows),
            "work_slabs": len(work),
            "partially_consumed_slabs": int(partial_slabs),
            "old_replicas": int(old_plan["num_replicas"]),
            "batches": batches,
        }
        if consumed_rows + assigned_rows != total_rows:
            msg = (
                "elastic migration coverage audit failed: consumed "
                f"{consumed_rows} + assigned {assigned_rows} != total "
                f"{total_rows} rows ({audit})"
            )
            raise RuntimeError(msg)
        return work, audit

    def migration_coverage(self, cursor) -> Dict[str, Any]:
        """The exactly-once coverage audit of a rehashed cursor against THIS
        batcher's layout: per-new-replica assigned row counts plus the global
        consumed/assigned/total accounting (``consumed + assigned == total``
        is hard-asserted — a failure means the migration would re-read or
        drop rows). Pure footer arithmetic; reads no data."""
        if isinstance(cursor, dict):
            cursor = StreamCursor.from_metadata(cursor)
        if cursor.migration is None:
            msg = "migration_coverage needs a rehashed cursor (StreamCursor.rehash)"
            raise ValueError(msg)
        work, audit = self._migration_work(cursor.epoch, cursor.migration)
        part = self._effective_partitioning()
        per_replica: Dict[int, int] = {}
        for replica in range(part.replicas.num_replicas):
            share = part.shard_items(len(work), epoch=cursor.epoch, replica_id=replica)
            per_replica[replica] = int(
                sum(work[i][0].rows - work[i][2] for i in share)
            )
        audit["assigned_rows_per_replica"] = per_replica
        audit["new_replicas"] = int(part.replicas.num_replicas)
        if sum(per_replica.values()) != audit["assigned_rows"]:
            msg = f"migration deal dropped/duplicated work items: {audit}"
            raise RuntimeError(msg)
        return audit

    def _migration_plan(
        self, epoch: int, migration: Dict[str, Any]
    ) -> Tuple[List[Tuple[_Slab, str, int]], int, int]:
        """THIS new replica's share of the migration work list, the batch
        ordinal the migrated stream starts at, and the migrated epoch's
        globally aligned total batch count."""
        work, audit = self._migration_work(epoch, migration)
        part = self._effective_partitioning()
        base = int(migration["batches"])
        remaining_max = 0
        for replica in range(part.replicas.num_replicas):
            share = part.shard_items(len(work), epoch=epoch, replica_id=replica)
            rows = int(sum(work[i][0].rows - work[i][2] for i in share))
            remaining_max = max(remaining_max, -(-rows // self.batch_size))
        mine = part.shard_items(len(work), epoch=epoch)
        items = [work[i] for i in mine]
        logger.warning(
            "elastic resume: migration plan for replica %s/%s — %s of %s "
            "work slabs, %s rows to emit from ordinal %s (audit: %s)",
            part.replicas.replica_id,
            part.replicas.num_replicas,
            len(items),
            len(work),
            sum(slab.rows - skip for slab, _, skip in items),
            base,
            audit,
        )
        return items, base, base + remaining_max

    def _read_slab(self, path: str, slab: _Slab):
        """One bounded read: the slab's row range of its row group.

        Sub-slabs (a ``memory_budget_bytes`` split) stream the group through
        ``iter_batches`` in slab-sized record batches instead of
        materializing the whole group and slicing — the resident set stays
        ~2× the slab no matter how large the group was written. Rows before
        ``slab.start`` are decoded-and-dropped (parquet offers no intra-group
        row seek), so prefer writing ``rows_per_chunk`` ≤ the budget at
        encode time; the budget split is the safety net for datasets written
        with oversized groups.
        """
        import pyarrow as pa
        import pyarrow.parquet as pq

        handle = pq.ParquetFile(path, filesystem=self._filesystem())
        names = self.columns or handle.schema_arrow.names
        full_rows = handle.metadata.row_group(slab.group).num_rows
        if slab.start == 0 and slab.rows == full_rows:
            return handle.read_row_group(slab.group, columns=names)
        pieces = []
        skipped = 0
        collected = 0
        for record_batch in handle.iter_batches(
            batch_size=max(slab.rows, 1), row_groups=[slab.group], columns=names
        ):
            if skipped < slab.start:
                drop = min(slab.start - skipped, record_batch.num_rows)
                skipped += drop
                record_batch = record_batch.slice(drop)
                if record_batch.num_rows == 0:
                    continue
            take = min(slab.rows - collected, record_batch.num_rows)
            pieces.append(record_batch.slice(0, take))
            collected += take
            if collected == slab.rows:
                break
        return pa.Table.from_batches(pieces)

    def _slab_order(self, slab: _Slab, epoch: int) -> np.ndarray:
        if not self.shuffle:
            return np.arange(slab.rows, dtype=np.int64)
        rng = np.random.default_rng((self.seed, epoch, slab.order_seed))
        return rng.permutation(slab.rows).astype(np.int64)

    # -- iteration ---------------------------------------------------------- #
    def __iter__(self) -> Iterator[Batch]:
        if self.shard == "row_groups":
            return self._iter_row_groups()
        return self._iter_rows()

    def _iter_rows(self) -> Iterator[Batch]:
        """Legacy mode: every replica scans every slab, strided row split."""
        part = self.partitioning or Partitioning(shuffle=self.shuffle, seed=self.seed)
        if self.shuffle and not part.shuffle:
            part = Partitioning(part.replicas, shuffle=True, seed=self.seed)
        carry: Optional[Batch] = None
        for slab_index, slab in enumerate(self._slabs()):
            # fold the slab index into the epoch so each slab shuffles differently
            order = part.generate(slab.num_rows, epoch=self.epoch * 100003 + slab_index)
            batch = self._materialize(slab, order)
            if carry is not None:
                batch = {k: np.concatenate([carry[k], batch[k]]) for k in batch}
                carry = None
            n = next(iter(batch.values())).shape[0]
            full_end = (n // self.batch_size) * self.batch_size
            for start in range(0, full_end, self.batch_size):
                chunk = {k: v[start : start + self.batch_size] for k, v in batch.items()}
                chunk["valid"] = np.ones(self.batch_size, bool)
                yield chunk
            if full_end < n:
                carry = {k: v[full_end:] for k, v in batch.items()}
        if carry is not None:
            n = next(iter(carry.values())).shape[0]
            pad = self.batch_size - n
            chunk = {
                k: np.concatenate([v, np.repeat(v[:1], pad, axis=0)]) for k, v in carry.items()
            }
            valid = np.zeros(self.batch_size, bool)
            valid[:n] = True
            chunk["valid"] = valid
            yield chunk

    def _iter_row_groups(self) -> Iterator[Batch]:
        """Shard-aware streaming: disjoint row-group shares per replica,
        bounded sub-slab reads, optional read-ahead, cursor recording, and
        valid=False alignment batches so every replica steps the same count.

        Iterates WORK ITEMS — ``(slab, path, base_skip)`` triples. A normal
        epoch's items are the replica's planned slabs with ``base_skip`` 0; a
        migrated epoch's (:meth:`StreamCursor.rehash`) are this replica's
        share of the global migration work list, where ``base_skip`` drops the
        rows an OLD replica already emitted from a partially consumed slab's
        deterministic order. Cursor ``slab``/``rows`` index the item list and
        the post-``base_skip`` stream, so mid-epoch resume works identically
        in both modes.
        """
        epoch = self.epoch
        start_cursor, self._pending_cursor = self._pending_cursor, None
        migration = start_cursor.migration if start_cursor is not None else None
        if migration is not None:
            items, base_emitted, max_batches = self._migration_plan(epoch, migration)
        else:
            slabs, paths, max_batches = self._plan(epoch)
            items = [(slab, path, 0) for slab, path in zip(slabs, paths)]
            base_emitted = 0
        first_item, skip_rows, emitted = 0, 0, base_emitted
        carry: Optional[Batch] = None
        pad_spec: Optional[Dict[str, Any]] = None
        if start_cursor is not None:
            if start_cursor.epoch != epoch:
                msg = (
                    f"stream cursor is for epoch {start_cursor.epoch} but the "
                    f"batcher is at epoch {epoch}; call set_epoch first"
                )
                raise ValueError(msg)
            first_item = start_cursor.slab
            skip_rows = start_cursor.rows
            emitted = start_cursor.batches
            carry = _deserialize_carry(start_cursor.carry)
            pad_spec = start_cursor.pad_spec
        self._record_cursor(
            StreamCursor(
                epoch=epoch,
                slab=first_item,
                rows=skip_rows,
                batches=emitted,
                carry=_serialize_carry(carry),
                pad_spec=pad_spec,
                migration=migration,
            )
        )

        def reads() -> Iterator[Tuple[int, Any]]:
            for index in range(first_item, len(items)):
                yield index, self._read_slab(items[index][1], items[index][0])

        source: Iterator[Tuple[int, Any]] = reads()
        if self.read_ahead:
            from replay_tpu_torch.data.nn.prefetch import prefetch as _prefetch

            source = _prefetch(source, depth=self.read_ahead)
        try:
            for index, table in source:
                slab, _, base_skip = items[index]
                order = self._slab_order(slab, epoch)
                block = self._materialize(table, order)
                consumed = 0
                drop = base_skip + (skip_rows if index == first_item else 0)
                if drop:
                    # resume mid-slab (and/or migration skip): drop what an
                    # earlier run already emitted from this slab's
                    # deterministic order
                    block = {k: v[drop:] for k, v in block.items()}
                    consumed = skip_rows if index == first_item else 0
                carry_before = carry
                if carry_before is not None:
                    stream = {
                        k: np.concatenate([carry_before[k], block[k]]) for k in block
                    }
                else:
                    stream = block
                carry_rows = (
                    next(iter(carry_before.values())).shape[0] if carry_before else 0
                )
                n = next(iter(stream.values())).shape[0] if stream else 0
                full_end = (n // self.batch_size) * self.batch_size
                for start in range(0, full_end, self.batch_size):
                    chunk = {
                        k: v[start : start + self.batch_size] for k, v in stream.items()
                    }
                    chunk["valid"] = np.ones(self.batch_size, bool)
                    if pad_spec is None:
                        pad_spec = _batch_spec(chunk)
                    emitted += 1
                    # position after this batch: rows of THIS slab consumed =
                    # batch end minus what the (< batch_size) carry contributed
                    # — a batch boundary can never land INSIDE the carry.
                    # pad_spec rides EVERY cursor so a resume that finds no
                    # real batches left can still build the alignment tail.
                    self._record_cursor(
                        StreamCursor(
                            epoch=epoch,
                            slab=index,
                            rows=consumed + start + self.batch_size - carry_rows,
                            batches=emitted,
                            pad_spec=pad_spec,
                            migration=migration,
                        )
                    )
                    yield chunk
                carry = (
                    {k: v[full_end:] for k, v in stream.items()} if full_end < n else None
                )
                # boundary state entering the next slab: resume skips this
                # slab entirely instead of re-reading and dropping all of it
                self._record_cursor(
                    StreamCursor(
                        epoch=epoch,
                        slab=index + 1,
                        rows=0,
                        batches=emitted,
                        carry=_serialize_carry(carry),
                        pad_spec=pad_spec,
                        migration=migration,
                    )
                )
        finally:
            if hasattr(source, "close"):
                source.close()
        if carry is not None:
            n = next(iter(carry.values())).shape[0]
            pad = self.batch_size - n
            chunk = {
                k: np.concatenate([v, np.repeat(v[:1], pad, axis=0)])
                for k, v in carry.items()
            }
            valid = np.zeros(self.batch_size, bool)
            valid[:n] = True
            chunk["valid"] = valid
            if pad_spec is None:
                pad_spec = _batch_spec(chunk)
            emitted += 1
            self._record_cursor(
                StreamCursor(
                    epoch=epoch, slab=len(items), rows=0, batches=emitted,
                    pad_spec=pad_spec, migration=migration,
                )
            )
            yield chunk
        # alignment batches: replicas whose round-robin share came up short
        # emit fully-masked zero batches so all hosts take the same step count
        # (deterministic from the shape spec alone — a resumed run landing
        # here rebuilds them bit-for-bit from the cursor's pad_spec)
        while emitted < max_batches:
            if pad_spec is None:
                msg = (
                    "row-group shard produced no batches for this replica but "
                    f"{max_batches} are needed for step alignment; the dataset "
                    "is too small for this replica count"
                )
                raise ValueError(msg)
            chunk = _zero_batch(pad_spec, self.batch_size)
            emitted += 1
            self._record_cursor(
                StreamCursor(
                    epoch=epoch, slab=len(items), rows=0, batches=emitted,
                    pad_spec=pad_spec, migration=migration,
                )
            )
            yield chunk


def write_sequence_parquet(
    path: str,
    sequential_dataset,
    extra_columns: Optional[dict] = None,
    rows_per_chunk: int = 4096,
):
    """SequentialDataset → parquet with list columns (the encode-once step that
    feeds ParquetBatcher), from the port's numpy ``SequentialDataset``.

    Streams ``rows_per_chunk``-row tables through ``pyarrow.parquet.
    ParquetWriter`` instead of materializing the whole dataset as python
    lists, so the encode step itself is out-of-core; each chunk lands as one
    row group, which is exactly the granularity ``shard="row_groups"``
    deals out to replicas and ``StreamCursor`` seeks over.
    """
    import pyarrow as pa
    import pyarrow.parquet as pq

    if rows_per_chunk < 1:
        msg = "rows_per_chunk must be >= 1"
        raise ValueError(msg)
    schema = sequential_dataset.schema
    names = list(schema)
    extra = {name: list(values) for name, values in (extra_columns or {}).items()}
    total = len(sequential_dataset)
    for name, values in extra.items():
        if len(values) != total:
            msg = (
                f"extra column '{name}' has {len(values)} values for "
                f"{total} dataset rows"
            )
            raise ValueError(msg)
    writer: Optional[pq.ParquetWriter] = None
    try:
        for start in range(0, total, rows_per_chunk):
            stop = min(start + rows_per_chunk, total)
            frame: Dict[str, Any] = {
                sequential_dataset.query_id_column: [
                    sequential_dataset.get_query_id(i) for i in range(start, stop)
                ]
            }
            for name in names:
                frame[name] = [
                    np.asarray(sequential_dataset.get_sequence(i, name)).tolist()
                    for i in range(start, stop)
                ]
            for name, values in extra.items():
                frame[name] = values[start:stop]
            table = pa.table(frame)
            if writer is None:
                writer = pq.ParquetWriter(path, table.schema)
            writer.write_table(table, row_group_size=rows_per_chunk)
        if writer is None:  # empty dataset: still leave a valid (0-row) file
            frame = {sequential_dataset.query_id_column: []}
            for name in names:
                frame[name] = pa.array([], pa.list_(pa.int64()))
            table = pa.table(frame)
            writer = pq.ParquetWriter(path, table.schema)
            writer.write_table(table)
    finally:
        if writer is not None:
            writer.close()
