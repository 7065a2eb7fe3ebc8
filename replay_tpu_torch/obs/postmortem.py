"""Post-mortem reconstruction: what was every process doing when it died?

Copied from ``replay_tpu/obs/postmortem.py`` (stdlib only), over the port's
flight rings (byte-compatible with the JAX package's) and event shards.

The forensic half of the black box (:mod:`replay_tpu_torch.obs.blackbox`). A
SIGKILLed fleet leaves four kinds of evidence behind, none of them complete
on its own:

* **flight rings** — each process's last N events, written right up to the
  kill (``read_flight`` tolerates the torn final record);
* **event shards** — the survivors' ``events.jsonl`` / ``events.p<i>.jsonl``
  streams, possibly ending mid-line where a writer died (the tolerant loader
  here skips the torn line and counts it, where :func:`report.load_events`
  would refuse the whole shard);
* **worker meta** — ``workers/rank<i>/meta.json`` written by
  ``launch_workers(run_dir=...)``: the authoritative ``killed_by`` signal,
  returncode and whether the launcher had to reap a wedged survivor;
* **checkpoint sidecars** — ``step_<n>.json`` files naming the last state
  that durably landed.

:func:`build_postmortem` merges them into per-process "last known activity"
timelines: the final flight record, the final event-shard line, the last
checkpoint, the death declaration — and the GAP between the final flight
record and the death declaration, which is exactly the window the run has no
story for. ``python -m replay_tpu_torch.obs.report <run_dir> --postmortem`` renders
it and writes ``postmortem.json`` next to the evidence. Damage is data here:
torn tails and unreadable rings are REPORTED, never raised — a post-mortem
tool that crashes on the corruption it exists to explain is useless.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["build_postmortem", "render_postmortem", "discover_rings"]

_RANK_DIR = re.compile(r"rank(\d+)$")
_SERVER_RING = re.compile(r"flight\.s(\d+)\.ring$")


def discover_rings(run_dir: str) -> List[str]:
    """Every flight ring under a run directory, in stable order: the run
    root's own rings (``flight*.ring``, covering ``flight.ring`` and the
    fleet's ``flight.s<i>.ring``), then each worker rank's."""
    root = glob.escape(run_dir)
    rings = sorted(glob.glob(os.path.join(root, "flight*.ring")))
    rings += sorted(
        glob.glob(os.path.join(root, "workers", "rank*", "flight*.ring"))
    )
    return rings


def _load_events_tolerant(path: str) -> Tuple[List[Dict[str, Any]], int]:
    """Records from an events stream, skipping damaged lines.

    A shard whose writer was SIGKILLed mid-``write`` ends in a torn line;
    the strict :func:`report.load_events` raises on it (correct for a report
    over a healthy run), a post-mortem reads through it. Returns
    ``(records, skipped_line_count)``."""
    records: List[Dict[str, Any]] = []
    skipped = 0
    try:
        with open(path) as fh:
            text = fh.read()
    except OSError:
        return [], 0
    for line in text.splitlines():
        if not line.strip():
            continue
        try:
            record = json.loads(line)
        except ValueError:
            skipped += 1
            continue
        if isinstance(record, dict):
            records.append(record)
        else:
            skipped += 1
    return records, skipped


def _ring_process_key(path: str, flight: Optional[Any]) -> str:
    """A stable per-process label for a ring: the worker rank or fleet
    replica index baked into its path wins; else the recorded
    ``process_index``/role of its ``flight_open`` record; else the writer
    pid."""
    rank = _RANK_DIR.search(os.path.dirname(path))
    if rank:
        return f"rank{rank.group(1)}"
    server = _SERVER_RING.search(os.path.basename(path))
    if server:
        return f"s{server.group(1)}"
    if flight is not None and flight.records:
        first = flight.records[0]
        if first.get("event") == "flight_open":
            if "process_index" in first:
                try:
                    return f"rank{int(first['process_index'])}"
                except (TypeError, ValueError):
                    pass
            if first.get("role"):
                return f"{first['role']}:{flight.writer_pid}"
    pid = flight.writer_pid if flight is not None else "unknown"
    return f"pid{pid}"


def _checkpoint_sidecars(run_dir: str) -> List[Dict[str, Any]]:
    """Every ``step_<n>.json`` checkpoint sidecar under the run dir (root or
    one subdirectory deep — the common ``<run_dir>/ckpt/`` layout), newest
    step last."""
    found = []
    patterns = [
        os.path.join(glob.escape(run_dir), "step_*.json"),
        os.path.join(glob.escape(run_dir), "*", "step_*.json"),
    ]
    for pattern in patterns:
        for path in glob.glob(pattern):
            name = os.path.basename(path)
            match = re.match(r"step_(\d+)\.json$", name)
            if not match:
                continue
            entry: Dict[str, Any] = {
                "path": path,
                "step": int(match.group(1)),
                "saved_unix": os.path.getmtime(path),
            }
            try:
                with open(path) as fh:
                    meta = json.load(fh)
                if isinstance(meta, dict):
                    for key in ("epoch", "mid_epoch", "preempted", "step_in_epoch"):
                        if key in meta:
                            entry[key] = meta[key]
            except (OSError, ValueError):
                entry["unreadable"] = True
            found.append(entry)
    return sorted(found, key=lambda e: e["step"])


def _worker_meta(run_dir: str) -> Dict[str, Dict[str, Any]]:
    """``workers/rank<i>/meta.json`` death declarations, keyed ``rank<i>``.
    ``declared_unix`` is the meta file's mtime — the moment the launcher
    finished the post-exit harvest, the closest thing a SIGKILL leaves to a
    time of death on record."""
    declarations: Dict[str, Dict[str, Any]] = {}
    for path in sorted(
        glob.glob(os.path.join(glob.escape(run_dir), "workers", "rank*", "meta.json"))
    ):
        rank = _RANK_DIR.search(os.path.dirname(path))
        if not rank:
            continue
        try:
            with open(path) as fh:
                meta = json.load(fh)
        except (OSError, ValueError):
            meta = {"unreadable": True}
        meta["declared_unix"] = os.path.getmtime(path)
        meta["path"] = path
        declarations[f"rank{rank.group(1)}"] = meta
    return declarations


def build_postmortem(run_dir: str) -> Dict[str, Any]:
    """Merge a run directory's rings, event shards, worker meta and
    checkpoint sidecars into per-process last-known-activity timelines.

    Never raises for damage inside the evidence (torn rings, torn shard
    lines, unreadable sidecars) — damage is recorded in the result. Raises
    only for a ``run_dir`` that does not exist."""
    from .blackbox import read_flight
    from .report import _collect_event_files

    if not os.path.isdir(run_dir):
        msg = f"{run_dir}: not a run directory"
        raise FileNotFoundError(msg)

    processes: Dict[str, Dict[str, Any]] = {}

    def proc(key: str) -> Dict[str, Any]:
        return processes.setdefault(key, {})

    # -- flight rings ------------------------------------------------------- #
    rings_out: List[Dict[str, Any]] = []
    for path in discover_rings(run_dir):
        try:
            flight = read_flight(path)
        except (OSError, ValueError) as exc:
            rings_out.append(
                {"path": path, "readable": False, "error": repr(exc)}
            )
            continue
        key = _ring_process_key(path, flight)
        entry = {
            "path": path,
            "readable": True,
            "process": key,
            "writer_pid": flight.writer_pid,
            "last_seqno": flight.last_seqno,
            "records_recovered": flight.recovered,
            "torn_tail": flight.torn_tail,
            "dropped": flight.dropped,
        }
        rings_out.append(entry)
        timeline = proc(key)
        timeline["ring"] = path
        timeline["flight_records_recovered"] = flight.recovered
        timeline["torn_tail"] = flight.torn_tail
        if flight.records:
            last = flight.records[-1]
            timeline["last_flight_record"] = {
                k: last.get(k) for k in ("seqno", "t", "event", "step", "epoch")
                if k in last
            }

    # -- event shards (tolerant) -------------------------------------------- #
    shards_out: List[Dict[str, Any]] = []
    try:
        shard_files = _collect_event_files(run_dir)
    except OSError:
        shard_files = []
    for path, index in shard_files:
        records, skipped = _load_events_tolerant(path)
        shards_out.append(
            {
                "path": path,
                "process_index": index,
                "records": len(records),
                "skipped_lines": skipped,
            }
        )
        if not records:
            continue
        key = f"rank{index}"
        timeline = proc(key)
        last = records[-1]
        candidate = {
            k: last.get(k) for k in ("event", "time", "step", "epoch") if k in last
        }
        prior = timeline.get("last_shard_event")
        if prior is None or candidate.get("time", 0) >= prior.get("time", 0):
            timeline["last_shard_event"] = candidate
        if skipped:
            timeline["shard_torn_lines"] = timeline.get("shard_torn_lines", 0) + skipped

    # -- death declarations and checkpoints --------------------------------- #
    for key, meta in _worker_meta(run_dir).items():
        proc(key)["death"] = meta
    checkpoints = _checkpoint_sidecars(run_dir)

    # -- the gap ------------------------------------------------------------ #
    for key, timeline in processes.items():
        death = timeline.get("death")
        last_flight = timeline.get("last_flight_record")
        if death and last_flight and "t" in last_flight:
            timeline["gap_s"] = round(
                max(0.0, death["declared_unix"] - last_flight["t"]), 3
            )
        dead = bool(death) and (
            death.get("returncode") != 0 or death.get("reaped")
        )
        timeline["dead"] = dead or bool(
            death is None and timeline.get("torn_tail")
        )

    return {
        "run_dir": run_dir,
        "processes": processes,
        "rings": rings_out,
        "event_shards": shards_out,
        "checkpoints": checkpoints,
        "torn_tails": sum(1 for r in rings_out if r.get("torn_tail")),
        "unreadable_rings": sum(1 for r in rings_out if not r.get("readable")),
    }


def _fmt_record(record: Optional[Dict[str, Any]]) -> str:
    if not record:
        return "none"
    parts = [str(record.get("event", "?"))]
    if record.get("step") is not None:
        parts.append(f"step={record['step']}")
    if record.get("seqno") is not None:
        parts.append(f"seqno={record['seqno']}")
    when = record.get("t", record.get("time"))
    if when is not None:
        parts.append(f"t={when:.3f}")
    return " ".join(parts)


def render_postmortem(post: Dict[str, Any]) -> str:
    lines = [f"post-mortem: {post['run_dir']}"]
    lines.append(
        f"  rings: {len(post['rings'])} "
        f"(torn tails: {post['torn_tails']}, unreadable: {post['unreadable_rings']})"
    )
    if post["checkpoints"]:
        last_ckpt = post["checkpoints"][-1]
        lines.append(
            f"  last checkpoint: step {last_ckpt['step']}"
            + (" (preempted save)" if last_ckpt.get("preempted") else "")
        )
    for key in sorted(post["processes"]):
        timeline = post["processes"][key]
        status = "DEAD" if timeline.get("dead") else "survived"
        lines.append(f"  {key}: {status}")
        if "flight_records_recovered" in timeline:
            lines.append(
                f"    flight ring: {timeline['flight_records_recovered']} records"
                + (" + torn tail" if timeline.get("torn_tail") else "")
            )
        if timeline.get("last_flight_record"):
            lines.append(
                f"    last flight record: {_fmt_record(timeline['last_flight_record'])}"
            )
        if timeline.get("last_shard_event"):
            lines.append(
                f"    last shard event:   {_fmt_record(timeline['last_shard_event'])}"
            )
        if timeline.get("shard_torn_lines"):
            lines.append(
                f"    shard torn lines:   {timeline['shard_torn_lines']}"
            )
        death = timeline.get("death")
        if death:
            how = (
                f"signal {death['killed_by']}"
                if death.get("killed_by")
                else f"returncode {death.get('returncode')}"
            )
            reaped = " (reaped by launcher)" if death.get("reaped") else ""
            lines.append(f"    death declared:     {how}{reaped}")
        if "gap_s" in timeline:
            lines.append(
                f"    unaccounted gap:    {timeline['gap_s']:.3f}s between final "
                "flight record and death declaration"
            )
    return "\n".join(lines)
