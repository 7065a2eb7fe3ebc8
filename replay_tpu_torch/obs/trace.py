"""Host-side span tracing + goodput accounting.

Copied from ``replay_tpu/obs/trace.py`` (host-only: no array framework, no
numpy): the spans, the Chrome-trace export and the goodput fractions the
scoring service records. The serving fleet's
``merge_traces`` (per-shard traces onto one time axis, one labeled track
each) and ``tail_attribution`` (the per-hop latency mix of the slowest
requests) are copied too.

* :class:`Tracer` records nestable spans via ``with tracer.span(name):``.
  Thread-safe (per-thread nesting stacks, one lock on the event list), so the
  serve worker's spans coexist with the client threads'. Disabled tracers
  return a shared null context — near-zero overhead, safe to leave the
  instrumentation in hot paths.
* Exports Chrome trace-event JSON (:meth:`Tracer.save` → ``trace.json``),
  loadable in Perfetto / ``chrome://tracing`` next to a ``torch.profiler``
  device trace.
* :meth:`Tracer.summary` aggregates per-name **inclusive** and **exclusive**
  (self) time; :func:`goodput_breakdown` turns an exclusive-time snapshot
  diff into fractions of the wall clock that sum to 1.0.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple

__all__ = [
    "GOODPUT_SPANS",
    "REQUEST_HOP_SPANS",
    "SERVE_GOODPUT_SPANS",
    "TraceContext",
    "Tracer",
    "goodput_breakdown",
    "lifecycle_span",
    "merge_traces",
    "tail_attribution",
    "traced_iterator",
]

# the phases of the goodput breakdown, in display order. "other" (derived) is
# everything the instrumentation did not attribute: python loop overhead,
# event emission, metric host work between steps. "batch_build" is the
# batcher's assembly work (SequenceBatcher(tracer=...)): when the batcher runs
# on the consuming thread its spans nest inside data_wait — listing it here
# keeps that time counted as input time rather than leaking into "other".
# "h2d" covers device placement; under fit(scan_chunk=...) the device feed
# records it on the FEEDER thread, so it appears in trace.json but drops out
# of the fit thread's fractions — the drop is the overlap the feed bought
# (obs.report renders the across-thread total next to the in-loop share).
GOODPUT_SPANS = (
    "data_wait",
    "batch_build",
    "h2d",
    "compile",
    "train_step",
    "validation",
    "checkpoint",
    "recovery",
)

# the serving pipeline's phases (replay_tpu_torch.serve): a request waits in the
# micro-batcher queue ("queue_wait", recorded cross-thread via
# :func:`lifecycle_span`), its batch is assembled ("batch_build", shared with
# the training batcher), scored on device ("score"), and — on the fused
# candidate->rank path — retrieved ("retrieve") and re-ranked ("rerank").
# ``goodput_breakdown(..., spans=SERVE_GOODPUT_SPANS)`` folds a serve worker's
# wall clock into fractions summing to 1.0, same contract as training.
SERVE_GOODPUT_SPANS = (
    "queue_wait",
    "batch_build",
    "score",
    "retrieve",
    "rerank",
)

# one fleet request's hops, in timeline order: the router's hash lookup
# ("route"), its hedge/backoff waits, then the replica-side serving phases.
# These are the rows of the report's "tail attribution" section — every span
# recorded with a ``trace_id`` (or batch-level ``trace_ids``) arg under one of
# these names is attributed to that request; the residual inside the
# root "request" span is "other" (dispatch handoffs, future resolution,
# device-queue time the host spans do not cover).
REQUEST_HOP_SPANS = (
    "route",
    "queue_wait",
    "batch_build",
    "score",
    "retrieve",
    "rerank",
    "backoff_wait",
    "hedge_wait",
)

# the spans that make up the stepping pipeline: the denominator of the
# input-starvation metric (time the step loop spent waiting on the batcher
# as a fraction of the loop's total productive+waiting time)
_STEP_PIPELINE = ("data_wait", "batch_build", "h2d", "compile", "train_step")

# the numerator: total input-side wait (blocking on the iterator + the batch
# assembly that happened inside that wait)
_INPUT_SPANS = ("data_wait", "batch_build")

_NULL_CONTEXT = contextlib.nullcontext()

# trace ids are minted per process: a short random-ish prefix (pid + coarse
# wall clock, fixed at import) plus a monotone sequence — unique across the
# fleet's processes without any coordination, and cheap (no uuid4 per request)
_TRACE_SEQ = itertools.count(1)
_TRACE_PREFIX = f"{os.getpid():x}{int(time.time() * 1e3) & 0xFFFFFF:06x}"


class TraceContext:
    """One request's distributed-trace identity: ``trace_id`` + parent span.

    Deliberately pure-JSON (:meth:`to_json` / :meth:`from_json` round-trip a
    plain dict of strings) so the context survives a future socket boundary
    between router and replica processes (ROADMAP item 9) unchanged — today it
    rides in-process through ``ScoringService.submit(_trace=...)``. Minted at
    fleet admission (:meth:`mint`); every hop records its span with
    ``trace_id=...`` in the span args, which is what lets
    :func:`merge_traces` + Perfetto render one hedged-and-failed-over request
    as a single connected timeline across router and replica tracks, and what
    :func:`tail_attribution` groups by.

    Tracing off = no context: the fleet mints only when its tracer is
    enabled, so the disabled hot path allocates nothing (``trace is None``
    everywhere).
    """

    __slots__ = ("trace_id", "parent_span")

    def __init__(self, trace_id: str, parent_span: Optional[str] = None) -> None:
        self.trace_id = str(trace_id)
        self.parent_span = parent_span

    @classmethod
    def mint(cls) -> "TraceContext":
        """A fresh root context (no parent span) — fleet admission."""
        return cls(f"t-{_TRACE_PREFIX}-{next(_TRACE_SEQ):06x}")

    def child(self, parent_span: str) -> "TraceContext":
        """The same trace, one hop deeper (``parent_span`` names the hop that
        forwarded it — e.g. ``"route"`` on the replica-bound context)."""
        return TraceContext(self.trace_id, parent_span=str(parent_span))

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"trace_id": self.trace_id}
        if self.parent_span is not None:
            out["parent_span"] = self.parent_span
        return out

    @classmethod
    def from_json(cls, payload: Optional[Mapping[str, Any]]) -> Optional["TraceContext"]:
        if not payload or "trace_id" not in payload:
            return None
        return cls(payload["trace_id"], parent_span=payload.get("parent_span"))

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"TraceContext({self.trace_id!r}, parent_span={self.parent_span!r})"


class _Span:
    """One live span: a reusable-context-manager-shaped frame.

    Returned by :meth:`Tracer.span`; keeps a reference to its recorded event
    dict after exit so :meth:`Tracer.carve` can re-attribute part of its self
    time (the compile-inside-first-step case).
    """

    __slots__ = ("_tracer", "name", "args", "start", "child_seconds", "record")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]) -> None:
        self._tracer = tracer
        self.name = name
        self.args = args
        self.start = 0.0
        self.child_seconds = 0.0
        self.record: Optional[Dict[str, Any]] = None

    def __enter__(self) -> "_Span":
        self._tracer._push(self)
        self.start = self._tracer._clock()
        return self

    def __exit__(self, *exc_info) -> None:
        end = self._tracer._clock()
        self._tracer._pop(self, end)


class Tracer:
    """Collects host-side spans; exports Chrome trace JSON and summaries.

    :param enabled: ``False`` turns every :meth:`span` into a shared null
        context manager — the instrumentation stays in place at near-zero cost.
    """

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = bool(enabled)
        self._clock = time.perf_counter
        self._t0 = self._clock()
        self._wall0 = time.time()
        self._lock = threading.Lock()
        self._events: List[Dict[str, Any]] = []
        self._local = threading.local()

    # -- span recording ----------------------------------------------------- #
    def _stack(self) -> List[_Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = []
            self._local.stack = stack
        return stack

    def _push(self, span: _Span) -> None:
        self._stack().append(span)

    def _pop(self, span: _Span, end: float) -> None:
        stack = self._stack()
        # tolerate misnesting (a span closed out of order) instead of raising
        # from telemetry code: drop frames down to (and including) this span
        while stack:
            frame = stack.pop()
            if frame is span:
                break
        duration = max(end - span.start, 0.0)
        record = {
            "name": span.name,
            "tid": threading.get_ident(),
            "start": span.start - self._t0,
            "dur": duration,
            "self": max(duration - span.child_seconds, 0.0),
            "args": span.args,
        }
        span.record = record
        if stack:
            stack[-1].child_seconds += duration
        with self._lock:
            self._events.append(record)

    def span(self, name: str, **args: Any):
        """Context manager timing the enclosed block as span ``name``.

        Nested spans subtract from the parent's exclusive ("self") time, so
        summary totals over sibling categories never double-count.
        """
        if not self.enabled:
            return _NULL_CONTEXT
        return _Span(self, name, args)

    def add_span(
        self, name: str, start_seconds: float, duration_seconds: float, **args: Any
    ) -> None:
        """Record a synthetic span measured outside ``with`` blocks (``start``
        relative to the tracer's epoch, i.e. another span's ``record['start']``)."""
        if not self.enabled:
            return
        duration = max(float(duration_seconds), 0.0)
        with self._lock:
            self._events.append(
                {
                    "name": name,
                    "tid": threading.get_ident(),
                    "start": float(start_seconds),
                    "dur": duration,
                    "self": duration,
                    "args": args,
                }
            )

    def carve(self, span: _Span, name: str, seconds: float, **args: Any) -> None:
        """Re-attribute ``seconds`` of a finished span's self time to ``name``.

        The carved span is recorded nested at the parent's start (Chrome trace
        renders it inside), and the parent's exclusive time shrinks by the
        same amount — used to split compile wall-time out of the step that
        triggered the (re)trace.
        """
        if not self.enabled or span is None or span.record is None:
            return
        seconds = max(min(float(seconds), span.record["self"]), 0.0)
        if seconds <= 0.0:
            return
        with self._lock:
            span.record["self"] -= seconds
            self._events.append(
                {
                    "name": name,
                    "tid": span.record["tid"],
                    "start": span.record["start"],
                    "dur": seconds,
                    "self": seconds,
                    "args": args,
                }
            )

    # -- aggregation -------------------------------------------------------- #
    def now(self) -> float:
        """Epoch-relative timestamp (seconds since this tracer was created) —
        the time base of every recorded span's ``start``. Take one on the
        producing thread and hand it to :func:`lifecycle_span` on the consuming
        thread to time a phase whose begin/end straddle threads."""
        return self._clock() - self._t0

    def wall_seconds(self) -> float:
        """Seconds since this tracer was created."""
        return self._clock() - self._t0

    def summary(self, only_current_thread: bool = False) -> Dict[str, Dict[str, float]]:
        """``{name: {count, seconds, self_seconds}}`` over recorded spans
        (``seconds`` inclusive of children, ``self_seconds`` exclusive).

        ``only_current_thread`` restricts to spans recorded on the calling
        thread — what a wall-clock decomposition of THAT thread's time may
        count (work on other threads, e.g. a prefetch worker's
        ``batch_build``, overlaps it rather than consuming it).
        """
        tid = threading.get_ident() if only_current_thread else None
        with self._lock:
            events = list(self._events)
        out: Dict[str, Dict[str, float]] = {}
        for event in events:
            if tid is not None and event["tid"] != tid:
                continue
            entry = out.setdefault(
                event["name"], {"count": 0, "seconds": 0.0, "self_seconds": 0.0}
            )
            entry["count"] += 1
            entry["seconds"] += event["dur"]
            entry["self_seconds"] += event["self"]
        return out

    def snapshot(self, only_current_thread: bool = False) -> Dict[str, float]:
        """Per-name exclusive-seconds totals — diff two snapshots to window a
        breakdown over an epoch (see :func:`goodput_breakdown`)."""
        return {
            name: entry["self_seconds"]
            for name, entry in self.summary(only_current_thread).items()
        }

    # -- export ------------------------------------------------------------- #
    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (the ``chrome://tracing`` / Perfetto format):
        complete events (``ph="X"``) with microsecond ``ts``/``dur``."""
        with self._lock:
            events = list(self._events)
        pid = os.getpid()
        trace_events = []
        for event in sorted(events, key=lambda e: e["start"]):
            record = {
                "name": event["name"],
                "cat": "host",
                "ph": "X",
                "ts": round(event["start"] * 1e6, 3),
                "dur": round(event["dur"] * 1e6, 3),
                "pid": pid,
                "tid": event["tid"],
            }
            if event["args"]:
                record["args"] = {str(k): v for k, v in event["args"].items()}
            trace_events.append(record)
        return {
            "traceEvents": trace_events,
            "displayTimeUnit": "ms",
            "otherData": {"trace_epoch_unix": self._wall0},
        }

    def save(self, path: str) -> str:
        """Write ``trace.json`` (Chrome trace-event JSON) to ``path``."""
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(self.to_chrome_trace(), fh)
        return path


def traced_iterator(batches: Iterable[Any], tracer: Tracer, name: str = "data_wait") -> Iterator[Any]:
    """Yield from ``batches``, timing every ``next()`` as a ``name`` span.

    This is how the fit loop attributes host input time: the span covers
    exactly the wait for the batcher (prefetch queue pops included), not the
    consumer's work on the yielded batch.
    """
    iterator = iter(batches)
    while True:
        with tracer.span(name):
            try:
                batch = next(iterator)
            except StopIteration:
                return
        yield batch


def lifecycle_span(
    tracer: Tracer, name: str, started_at: float, **args: Any
) -> float:
    """Record a lifecycle phase that began on another thread; returns its
    duration in seconds.

    A request's ``queue_wait``
    starts when the client thread enqueues it (capture ``tracer.now()`` there)
    and ends when the serve worker dequeues it — no single ``with`` block can
    cover both, so the span is recorded synthetically on the consuming thread
    via :meth:`Tracer.add_span`.
    """
    duration = max(tracer.now() - float(started_at), 0.0)
    tracer.add_span(name, float(started_at), duration, **args)
    return duration



def goodput_breakdown(
    span_self_seconds: Mapping[str, float],
    wall_seconds: float,
    spans: Iterable[str] = GOODPUT_SPANS,
) -> Dict[str, Any]:
    """Fold an exclusive-time snapshot (diff) into the goodput record.

    Returns ``{"wall_seconds", "fractions", "input_starvation"}`` where
    ``fractions`` maps every ``spans`` phase (default :data:`GOODPUT_SPANS`;
    pass :data:`SERVE_GOODPUT_SPANS` for a serving worker) plus the derived
    ``other`` to its share of ``wall_seconds`` — summing to 1.0 by
    construction — and ``input_starvation`` is the fraction of the stepping
    pipeline (data_wait + batch_build + h2d + compile + train_step) spent on
    the input side (waiting on the iterator + same-thread batch assembly).
    """
    spans = tuple(spans)
    wall = max(float(wall_seconds), 0.0)
    fractions: Dict[str, float] = {}
    tracked = 0.0
    for name in spans:
        seconds = max(float(span_self_seconds.get(name, 0.0)), 0.0)
        tracked += seconds
        fractions[name] = seconds / wall if wall > 0 else 0.0
    if wall > 0 and tracked > wall:
        # spans from concurrent threads can overlap the window; renormalize so
        # the contract (fractions sum to 1.0) survives
        for name in spans:
            fractions[name] *= wall / tracked
        tracked = wall
    fractions["other"] = (wall - tracked) / wall if wall > 0 else 1.0
    if "train_step" not in spans:
        # a non-training breakdown (e.g. SERVE_GOODPUT_SPANS) has no stepping
        # pipeline to starve — None keeps the metric honest and unrendered
        starvation = None
    else:
        pipeline = sum(
            max(float(span_self_seconds.get(name, 0.0)), 0.0) for name in _STEP_PIPELINE
        )
        input_side = sum(
            max(float(span_self_seconds.get(name, 0.0)), 0.0) for name in _INPUT_SPANS
        )
        starvation = input_side / pipeline if pipeline > 0 else 0.0
    return {
        "wall_seconds": wall,
        "fractions": fractions,
        "input_starvation": starvation,
    }


def merge_traces(
    shards: Mapping[str, Any], path: Optional[str] = None
) -> Dict[str, Any]:
    """Merge per-shard Chrome traces into ONE trace with labeled tracks.

    ``shards`` maps a track label ("router", "r0", ...) to a :class:`Tracer`
    or an already-exported Chrome trace dict. Each shard becomes its own
    process track: a distinct ``pid`` plus a ``process_name`` metadata event
    (``ph="M"``) carrying the label, which is how Perfetto titles the track.
    Shards run on independent ``perf_counter`` epochs; their timestamps are
    aligned onto the EARLIEST shard's epoch via each trace's
    ``otherData.trace_epoch_unix`` (the wall clock at tracer construction), so
    a request's router spans and its replica spans line up on one time axis.

    Returns the merged trace dict; when ``path`` is given also writes it
    there (the fleet's single ``trace.json``).
    """
    chrome: Dict[str, Dict[str, Any]] = {}
    for label, shard in shards.items():
        trace = shard.to_chrome_trace() if hasattr(shard, "to_chrome_trace") else shard
        chrome[str(label)] = trace
    epochs = {
        label: float((trace.get("otherData") or {}).get("trace_epoch_unix") or 0.0)
        for label, trace in chrome.items()
    }
    base_epoch = min(epochs.values()) if epochs else 0.0
    merged: List[Dict[str, Any]] = []
    tracks: Dict[str, int] = {}
    for index, (label, trace) in enumerate(chrome.items()):
        pid = index + 1
        tracks[label] = pid
        offset_us = (epochs[label] - base_epoch) * 1e6
        merged.append(
            {
                "name": "process_name",
                "ph": "M",
                "ts": 0,
                "pid": pid,
                "tid": 0,
                "args": {"name": label},
            }
        )
        for event in trace.get("traceEvents", ()):
            if event.get("ph") == "M":
                continue  # shard-local metadata is superseded by the track label
            record = dict(event)
            record["pid"] = pid
            record["ts"] = round(float(event.get("ts", 0.0)) + offset_us, 3)
            merged.append(record)
    merged.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0.0)))
    out = {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "otherData": {"trace_epoch_unix": base_epoch, "tracks": tracks},
    }
    if path is not None:
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(out, fh)
    return out


def _event_trace_ids(event: Mapping[str, Any]) -> Tuple[str, ...]:
    """The request(s) a trace event belongs to: a scalar ``trace_id`` arg for
    per-request spans, a ``trace_ids`` list for batch-level spans shared by
    every co-riding request (each gets the full batch duration — request-
    centric attribution: "MY batch spent X ms scoring")."""
    args = event.get("args")
    if not args:
        return ()
    trace_id = args.get("trace_id")
    if trace_id:
        return (str(trace_id),)
    trace_ids = args.get("trace_ids")
    if trace_ids:
        return tuple(str(t) for t in trace_ids)
    return ()


def tail_attribution(
    trace_events: Iterable[Mapping[str, Any]],
    quantiles: Sequence[float] = (0.5, 0.99),
    root: str = "request",
    hops: Sequence[str] = REQUEST_HOP_SPANS,
) -> Optional[Dict[str, Any]]:
    """Decompose completed requests' latency into per-hop fractions.

    Groups Chrome trace events by ``trace_id``: each root span (``root``,
    recorded by the fleet router over a request's full submit→answer window)
    defines one completed request's latency; every hop span sharing its
    trace_id contributes its duration. Per request the hop fractions are
    clipped to the root window (concurrent hops — a hedge twin racing the
    primary — can overlap; renormalized like :func:`goodput_breakdown`) and
    the residual is ``other``, so each request's fractions sum to 1.0.

    For each quantile ``q`` the attribution is the MEAN hop mix over the
    slowest ``(1 - q)`` share of requests (nearest-rank tail subset): "what do
    the p99 requests spend their time on", not "what does the p99 request
    spend". Returns ``None`` when no root span carries a trace_id (tracing
    was off or nothing completed).
    """
    roots: Dict[str, float] = {}
    hop_seconds: Dict[str, Dict[str, float]] = {}
    hop_set = set(hops)
    for event in trace_events:
        if event.get("ph") == "M":
            continue
        name = event.get("name")
        ids = _event_trace_ids(event)
        if not ids:
            continue
        dur_s = max(float(event.get("dur") or 0.0), 0.0) / 1e6
        if name == root:
            roots[ids[0]] = max(roots.get(ids[0], 0.0), dur_s)
        elif name in hop_set:
            for tid in ids:
                per_hop = hop_seconds.setdefault(tid, {})
                per_hop[name] = per_hop.get(name, 0.0) + dur_s
    if not roots:
        return None
    per_request: List[Tuple[float, Dict[str, float]]] = []
    for trace_id, total in sorted(roots.items(), key=lambda kv: kv[1]):
        fractions: Dict[str, float] = {}
        tracked = 0.0
        per_hop = hop_seconds.get(trace_id, {})
        for name in hops:
            seconds = min(max(per_hop.get(name, 0.0), 0.0), total) if total > 0 else 0.0
            tracked += seconds
            fractions[name] = seconds / total if total > 0 else 0.0
        if total > 0 and tracked > total:
            for name in hops:
                fractions[name] *= total / tracked
            tracked = total
        fractions["other"] = (total - tracked) / total if total > 0 else 1.0
        per_request.append((total, fractions))
    n = len(per_request)
    out: Dict[str, Any] = {
        "requests": n,
        "hops": list(hops) + ["other"],
        "quantiles": {},
    }
    for q in quantiles:
        start = min(int(float(q) * n), n - 1)
        subset = per_request[start:]
        means: Dict[str, float] = {}
        for name in out["hops"]:
            means[name] = sum(f[name] for _, f in subset) / len(subset)
        # exact residual: the averaged mix must still sum to 1.0 bit-for-bit
        means["other"] = max(1.0 - sum(means[name] for name in hops), 0.0)
        key = f"p{int(round(float(q) * 100)):02d}"
        out["quantiles"][key] = {
            "latency_ms": subset[0][0] * 1e3,
            "n": len(subset),
            "fractions": means,
        }
    return out
