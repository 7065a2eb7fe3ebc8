"""The black box: an mmap-backed flight recorder that survives SIGKILL.

Every other sink in :mod:`replay_tpu_torch.obs` is process-resident at exactly the
wrong moment: ``trace.json`` is written at fit end, the
:class:`~replay_tpu_torch.obs.metrics.MetricsRegistry` evaporates unless a scraper
happened to hit ``/metrics`` first, and a supervisor's only forensic record of
a dead worker is an in-memory stderr tail. This module is the sink that is
still there after ``kill -9``:

* :class:`FlightRecorder` — a fixed-width-record ring buffer in an mmap'd
  file. A write is an O(1) in-place store into slot ``(seqno - 1) % capacity``
  (no append, no rotation, no allocation on the hot path); each record carries
  its own seqno and a CRC32 over the framed bytes. The process never calls
  ``msync`` per record: dirty pages live in the OS page cache, which outlives
  the process — SIGKILL, an OOM kill, a segfault all leave the last
  ``capacity`` records readable. Only machine death (power loss before
  writeback) loses the tail; :meth:`FlightRecorder.flush` exists for callers
  that want a durability point (close does one).

* :func:`read_flight` — the post-mortem reader. It never trusts a byte: a
  slot is ``empty`` only when ALL its bytes are zero (a preallocated slot the
  writer never reached); anything else must frame-parse AND pass CRC AND
  decode as JSON to be returned. The one record a SIGKILL can tear — the
  in-progress store — fails CRC and is surfaced as ``torn_tail=True`` on the
  returned :class:`FlightLog`, never as an exception and never as a corrupt
  record in ``records``.

* :class:`BlackboxLogger` — the bridge. It is a
  :class:`~replay_tpu_torch.obs.events.RunLogger`, so attaching it to the existing
  event fan-out (``Trainer.fit(flight_path=...)``,
  ``ScoringService(flight_path=...)``, a ``loggers=`` list) IS the
  instrumentation: train steps, anomalies, health
  fetches, serve batches, shed/breaker/degrade, heartbeats and
  swap/promotion events all flow through ``log_event`` already; this sink
  just packs each one into a flight record. No new Trainer or ScoringService
  hooks exist for it.

Record framing (little-endian, ``RECORD_HEADER = "<QIHd"``)::

    [ seqno u64 | crc u32 | length u16 | time f64 | payload[length] | zeros ]

``crc = crc32(pack("<QHd", seqno, length, time) + payload)`` — the seqno is
inside the checksum so a stale slot from a previous lap can never be
mis-attributed to the current one. Payloads are compact JSON; the encoder
whittles oversized events (drop the bulkiest values first, always keep the
event name) so a record ALWAYS fits its fixed width — the black box records
that something happened even when it cannot record everything about it.

File layout: a 64-byte header (magic, version, record size, capacity, writer
pid, start time) followed by ``capacity`` record slots, preallocated via
``ftruncate`` so the file size is fixed on day one — a short file is itself
evidence of a torn/truncated ring. Reopening an existing ring resumes after
its highest valid seqno: a respawned process appends to the evidence, it
never clobbers a dead predecessor's.

Copied from ``replay_tpu/obs/blackbox.py`` (host-only, stdlib only), byte
layout and all: a ring that either package writes, the other reads.
"""

from __future__ import annotations

import dataclasses
import json
import mmap
import os
import struct
import threading
import time
import zlib
from typing import Any, Dict, List, Mapping, Optional

__all__ = [
    "FLIGHT_PATH_ENV",
    "FlightLog",
    "FlightRecorder",
    "BlackboxLogger",
    "read_flight",
]

#: Env var through which a launcher hands a worker its ring path
#: (``launch_workers(run_dir=...)`` sets it; ``Trainer.fit`` resolves it).
FLIGHT_PATH_ENV = "REPLAY_TPU_FLIGHT_PATH"

MAGIC = b"RPTFLYRC"
VERSION = 1
HEADER = struct.Struct("<8sIIIId")  # magic, version, record_size, capacity, pid, start_unix
HEADER_SIZE = 64  # fixed; HEADER.size padded with zeros
RECORD_HEADER = struct.Struct("<QIHd")  # seqno, crc, length, time
DEFAULT_RECORD_SIZE = 256
DEFAULT_CAPACITY = 2048
_CRC_PREFIX = struct.Struct("<QHd")  # the framed fields under the checksum


def _crc(seqno: int, length: int, when: float, payload: bytes) -> int:
    return zlib.crc32(_CRC_PREFIX.pack(seqno, length, when) + payload) & 0xFFFFFFFF


def _encode_payload(record: Mapping[str, Any], max_len: int) -> bytes:
    """``record`` as compact JSON that fits ``max_len`` bytes.

    Oversized records are whittled, not refused: drop the bulkiest values
    first (the event name and step are kept to the end), then fall back to
    the event name alone — a flight record must always land."""
    items = dict(record)
    encoded = json.dumps(items, separators=(",", ":"), default=str).encode()
    if len(encoded) <= max_len:
        return encoded
    keep_last = ("event", "step", "epoch")
    droppable = sorted(
        (k for k in items if k not in keep_last),
        key=lambda k: len(json.dumps(items[k], default=str)),
        reverse=True,
    )
    for key in droppable:
        del items[key]
        encoded = json.dumps(items, separators=(",", ":"), default=str).encode()
        if len(encoded) <= max_len:
            return encoded
    minimal = {"event": str(record.get("event", "?"))[:64]}
    return json.dumps(minimal, separators=(",", ":")).encode()[:max_len]


class FlightRecorder:
    """Write side of the black box: O(1) in-place ring stores over mmap.

    >>> rec = FlightRecorder("/tmp/doctest.ring", capacity=8)
    >>> rec.record({"event": "on_train_step", "step": 1})
    1
    >>> rec.close()
    """

    def __init__(
        self,
        path: str,
        capacity: int = DEFAULT_CAPACITY,
        record_size: int = DEFAULT_RECORD_SIZE,
    ) -> None:
        if capacity < 1:
            msg = f"capacity must be >= 1, got {capacity}"
            raise ValueError(msg)
        if record_size < RECORD_HEADER.size + 16:
            msg = f"record_size {record_size} leaves no payload room"
            raise ValueError(msg)
        self.path = str(path)
        self._lock = threading.Lock()
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        resumed = self._try_resume()
        if resumed is None:
            self.capacity = int(capacity)
            self.record_size = int(record_size)
            self._seqno = 0
            size = HEADER_SIZE + self.capacity * self.record_size
            with open(self.path, "wb") as fh:
                header = HEADER.pack(
                    MAGIC, VERSION, self.record_size, self.capacity,
                    os.getpid(), time.time(),
                )
                fh.write(header.ljust(HEADER_SIZE, b"\0"))
                fh.truncate(size)
        self._file = open(self.path, "r+b")  # noqa: SIM115 — held for the mmap's life
        self._mm = mmap.mmap(self._file.fileno(), 0)
        self._payload_max = self.record_size - RECORD_HEADER.size

    def _try_resume(self) -> Optional[bool]:
        """Adopt an existing valid ring at :attr:`path` (continue after its
        highest surviving seqno — never clobber a dead process's evidence);
        ``None`` when absent or unusable (then recreated)."""
        try:
            log = read_flight(self.path)
        except (OSError, ValueError):
            return None
        self.capacity = log.capacity
        self.record_size = log.record_size
        self._seqno = log.last_seqno
        return True

    @property
    def last_seqno(self) -> int:
        return self._seqno

    def record(self, record: Mapping[str, Any], when: Optional[float] = None) -> int:
        """Store one record; returns its seqno. O(1): one encode, one CRC,
        one in-place slice store — no syscall beyond the page fault."""
        when = time.time() if when is None else float(when)
        payload = _encode_payload(record, self._payload_max)
        with self._lock:
            if self._mm.closed:  # late event after close: drop, don't raise
                return self._seqno
            self._seqno += 1
            seqno = self._seqno
            frame = RECORD_HEADER.pack(
                seqno, _crc(seqno, len(payload), when, payload), len(payload), when
            )
            offset = HEADER_SIZE + ((seqno - 1) % self.capacity) * self.record_size
            slot = (frame + payload).ljust(self.record_size, b"\0")
            self._mm[offset : offset + self.record_size] = slot
        return seqno

    def flush(self) -> None:
        """A durability point (``msync``): survives machine death up to here.
        Not called per record — the page cache already survives SIGKILL."""
        with self._lock:
            if not self._mm.closed:
                self._mm.flush()

    def close(self) -> None:
        with self._lock:
            if self._mm.closed:
                return
            self._mm.flush()
            self._mm.close()
            self._file.close()

    def __enter__(self) -> "FlightRecorder":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()


@dataclasses.dataclass
class FlightLog:
    """What :func:`read_flight` recovered from a ring.

    ``records`` hold only CRC-verified, JSON-decoded payloads in seqno order
    (each dict gains ``seqno`` and ``t``). ``torn_tail`` is True when any
    written slot failed verification — for a ring whose writer died mid-store
    that is exactly the one in-progress record — or when the file itself was
    truncated below its preallocated size. ``dropped`` counts the rejected
    slots."""

    path: str
    capacity: int
    record_size: int
    writer_pid: int
    start_unix: float
    records: List[Dict[str, Any]]
    last_seqno: int
    torn_tail: bool
    dropped: int
    truncated: bool

    @property
    def recovered(self) -> int:
        return len(self.records)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "path": self.path,
            "capacity": self.capacity,
            "writer_pid": self.writer_pid,
            "start_unix": self.start_unix,
            "recovered": self.recovered,
            "last_seqno": self.last_seqno,
            "torn_tail": self.torn_tail,
            "dropped": self.dropped,
            "truncated": self.truncated,
        }


def read_flight(path: str) -> FlightLog:
    """Recover every verifiable record from a flight ring.

    Raises only for a file that is not a flight ring at all (missing,
    unreadable, bad magic/header — the loud-CLI contract every other
    malformed artifact gets). Damage INSIDE a valid ring — the torn final
    record of a SIGKILLed writer, fuzzed bytes, a truncated tail — never
    raises and never leaks a corrupt record: bad slots are dropped and
    reported via ``torn_tail`` / ``dropped``."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if len(raw) < HEADER.size:
        msg = f"{path}: too short to be a flight ring ({len(raw)} bytes)"
        raise ValueError(msg)
    magic, version, record_size, capacity, pid, start_unix = HEADER.unpack_from(raw)
    if magic != MAGIC:
        msg = f"{path}: not a flight ring (bad magic {magic!r})"
        raise ValueError(msg)
    if version != VERSION:
        msg = f"{path}: flight ring version {version} (reader speaks {VERSION})"
        raise ValueError(msg)
    if record_size < RECORD_HEADER.size + 1 or capacity < 1:
        msg = f"{path}: nonsense ring geometry ({capacity}×{record_size})"
        raise ValueError(msg)

    expected = HEADER_SIZE + capacity * record_size
    truncated = len(raw) < expected
    payload_max = record_size - RECORD_HEADER.size
    by_seqno: Dict[int, Dict[str, Any]] = {}
    dropped = 0
    for slot in range(capacity):
        offset = HEADER_SIZE + slot * record_size
        chunk = raw[offset : offset + record_size]
        if not chunk:
            break  # truncated before this slot: nothing was ever here to judge
        padded = chunk.ljust(record_size, b"\0")
        if padded == b"\0" * record_size:
            continue  # genuinely empty: the writer never reached this slot
        seqno, crc, length, when = RECORD_HEADER.unpack_from(padded)
        payload = padded[RECORD_HEADER.size : RECORD_HEADER.size + length]
        if (
            seqno == 0
            or length > payload_max
            or len(chunk) < RECORD_HEADER.size + length  # frame ran past the cut
            or _crc(seqno, length, when, payload) != crc
        ):
            dropped += 1
            continue
        try:
            decoded = json.loads(payload.decode())
        except (ValueError, UnicodeDecodeError):
            dropped += 1
            continue
        if not isinstance(decoded, dict):
            dropped += 1
            continue
        decoded["seqno"] = seqno
        decoded["t"] = when
        # two valid frames claiming one seqno cannot happen from this writer;
        # if fuzzing manufactures one, keep the first deterministic winner
        by_seqno.setdefault(seqno, decoded)
    records = [by_seqno[s] for s in sorted(by_seqno)]
    return FlightLog(
        path=str(path),
        capacity=capacity,
        record_size=record_size,
        writer_pid=pid,
        start_unix=start_unix,
        records=records,
        last_seqno=max(by_seqno) if by_seqno else 0,
        torn_tail=dropped > 0 or truncated,
        dropped=dropped,
        truncated=truncated,
    )


# -- the RunLogger bridge ---------------------------------------------------- #
# Per-family payload fields worth their bytes in a 256-byte record. Everything
# else a payload carries is kept only if the record still fits (the encoder
# whittles largest-first), so a fat on_fit_end summary degrades gracefully to
# its scalars while a lean on_train_step keeps everything.
_PRIORITY_FIELDS = (
    "loss", "grad_norm", "samples_per_second", "lr",
    "reason", "signal", "preempted", "exhausted",
    "kind", "rows", "fill", "queue_wait_ms", "lane", "served_by",
    "from", "to", "state", "live", "queued", "error_rate",
    "generation", "fraction", "decision", "replica", "status",
    "process_index", "step_in_epoch", "mid_epoch", "count",
)


class BlackboxLogger:
    """A :class:`~replay_tpu_torch.obs.events.RunLogger` sink over a flight ring.

    Attaching it to an existing event fan-out is the whole integration: every
    family the trainer and the scoring service already emit (train step,
    anomaly, health, serve batch, shed/breaker/degrade, heartbeat,
    swap/promotion, SLO) arrives at :meth:`log_event` and becomes one fixed-
    width flight record. Scalars ride along; bulky payloads (telemetry
    summaries, compile reports) are whittled to fit — the black box's job is
    the last N seconds of WHAT HAPPENED, not the full artifact."""

    def __init__(
        self,
        path: str,
        capacity: int = DEFAULT_CAPACITY,
        record_size: int = DEFAULT_RECORD_SIZE,
        meta: Optional[Mapping[str, Any]] = None,
    ) -> None:
        self.recorder = FlightRecorder(path, capacity=capacity, record_size=record_size)
        if meta:
            self.recorder.record({"event": "flight_open", **dict(meta)})

    @property
    def path(self) -> str:
        return self.recorder.path

    def log_event(self, event) -> None:
        payload = event.payload or {}
        record: Dict[str, Any] = {"event": event.event}
        if event.step is not None:
            record["step"] = event.step
        if event.epoch is not None:
            record["epoch"] = event.epoch
        for key in _PRIORITY_FIELDS:
            if key in payload:
                record[key] = _scalar(payload[key])
        for key, value in payload.items():
            if key not in record:
                record[key] = _scalar(value)
        self.recorder.record(record, when=event.time)

    def close(self) -> None:
        self.recorder.close()

    def __enter__(self) -> "BlackboxLogger":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()


def _scalar(value: Any) -> Any:
    """Payload values for the ring: scalars pass (numpy and torch zero-dim scalars
    coerce through ``float()``), containers shrink to a stable short form —
    never multi-KB blobs."""
    if value is None or isinstance(value, (int, float, bool, str)):
        return value
    if isinstance(value, Mapping):
        return f"<{len(value)} keys>"
    if isinstance(value, (list, tuple, set)):
        return f"<{len(value)} items>"
    try:
        return float(value)
    except (TypeError, ValueError):
        return str(value)[:64]
