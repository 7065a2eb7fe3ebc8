"""Device-time attribution: parse a ``torch.profiler`` capture into per-scope time.

Counterpart of ``replay_tpu/obs/profile.py``. The JAX module joins a
``jax.profiler`` capture with the ``named_scope`` metadata of the compiled
HLO; the port's scopes are ``torch.profiler.record_function`` ranges with the
same names (``embed`` / ``encoder`` / ``final_norm`` in the models,
``forward`` / ``loss`` / ``health`` / ``health_logits`` in the trainer),
entered through :func:`scope` only while a profile window is open
(:func:`trace`), so a CUDA-graph capture or a ``torch.export`` program built
outside a window is built exactly as without them.

A capture is the Chrome trace-event JSON that ``torch.profiler`` exports
(:func:`latest_capture`, :func:`load_capture`). :func:`attribute_capture`
gives every device event a scope:

1. a kernel (or copy) carries the ``correlation`` id of the runtime call that
   launched it; that call sits on a host thread inside the scope ranges open
   at the time;
2. the backward runs outside those ranges, on autograd's thread: each
   ``autograd::engine::evaluate_function`` range carries the sequence number
   of the forward op it differentiates, and takes that op's scope — the
   counterpart of JAX's ``scope_of`` seeing through ``transpose(jvp(...))``;
3. inside a CUDA-graph replay no host range surrounds a kernel: the kernel at
   position *i* of a replay takes the scope of the kernel at position *i* of
   that program's traced eager warm-up, and only where the two sequences
   have the same kernel names (``graph_kernels``).

Everything else lands in ``unattributed_seconds`` (the optimizer update, a
replay whose names differ), never guessed. On a capture with no device
events (a CPU run) the host's top-level ops stand in for device ops.

The JAX module's ``hlo_module_name`` and ``parse_op_metadata`` read HLO text
and have no counterpart. The trace plumbing that ``chip_smoke.py`` uses
(:func:`device_events`, :func:`profiled_window`, :data:`TRACE_MARGIN_S`,
:data:`TRACE_NAMES`) lives here too.
"""

from __future__ import annotations

import bisect
import contextlib
import glob
import gzip
import json
import os
import re
import socket
import tempfile
import time
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import torch

__all__ = [
    "NAMED_SCOPES",
    "TRACE_MARGIN_S",
    "TRACE_NAMES",
    "attribute_capture",
    "attribute_events",
    "device_events",
    "kernels_by_launch",
    "out_of_range_records",
    "device_op_times",
    "kernel_scopes",
    "latest_capture",
    "load_capture",
    "profiled_window",
    "scope",
    "scope_of",
    "trace",
]

# the scopes the trainer and the model bodies open, in display order
NAMED_SCOPES = (
    "embed",
    "encoder",
    "final_norm",
    "health_logits",
    "health",
    "forward",
    "loss",
)

# each kernel's function name in a profiler trace (the demangled name of its
# __global__ function, templated or not), by the wrapper that counts it
TRACE_NAMES = {
    "flash_attention": r"\battention_forward[<(]",
    "flash_attention_tiled": r"\btiled_forward(_mma|_tf32x3)?[<(]",
    "fused_lse_forward": r"\blse_forward(_tf32)?[<(]",
    "fused_lse_dh": r"\blse_grad_hidden(_tf32)?[<(]",
    "fused_lse_dw": r"\blse_grad_table(_tf32)?[<(]",
}

# The profiler keeps a device event only where it falls inside its capture
# window, whose ends are read on the host clock, and it places device events
# on that clock by a conversion of the device's timestamps. Work that ends
# right at a window's edge can land outside it: a warm trace of 20 serving
# encodes held 39, 24 and 26 of their 40 K4 kernels in one run on an H100.
# So every window opens this long before its first launch and closes this
# long after its last kernel has finished (chip_trace_probe.py takes traces
# with and without it).
TRACE_MARGIN_S = 0.05

# kineto drops a device record whose time, put on the host's clock, falls
# outside its window, and counts it in a log line ("Record counts:
# Out-of-range = N") that an exported trace carries under "INFO" when kineto
# logs at INFO (``KINETO_LOG_LEVEL=1``). That conversion can be off by far
# more than TRACE_MARGIN_S: in one window of a fleet's traffic on an H100 the
# device's clock read 0.37-0.51 s late against the host, and the trace kept
# 40 of 204 K4 kernels with 7,223 records out of range
# (chip_trace_probe.py --fleet-windows).
_OUT_OF_RANGE = re.compile(r"Record counts: Out-of-range = (\d+)")

_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")
_BACKWARD_PREFIX = "autograd::engine::evaluate_function"
_NULL = contextlib.nullcontext()
_SCOPES_ON = False


# --------------------------------------------------------------------------- #
# scopes and the profile window
# --------------------------------------------------------------------------- #
def scope(name: str):
    """A ``record_function`` range named ``name`` while a profile window is
    open; otherwise a shared no-op context (nothing is recorded or built)."""
    return torch.profiler.record_function(name) if _SCOPES_ON else _NULL


@contextlib.contextmanager
def scopes_on():
    """Open the named scopes for the enclosed block."""
    global _SCOPES_ON
    before, _SCOPES_ON = _SCOPES_ON, True
    try:
        yield
    finally:
        _SCOPES_ON = before


def _activities() -> list:
    from torch.profiler import ProfilerActivity

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    return activities


def _settle(margin: float) -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        time.sleep(margin)


@contextlib.contextmanager
def profiled_window(primer=None, margin: float = TRACE_MARGIN_S, with_stack: bool = False):
    """A profiler whose recording starts warm: ``primer()`` (if any) runs as
    its warm-up cycle (traced, then dropped), and the block's work is the one
    active cycle that ``key_averages()`` and ``events()`` read, ``margin``
    seconds inside each end of the window (on the card). ``with_stack``
    records Python function events too. Yields the profiler."""
    from torch.profiler import profile, schedule

    plan = schedule(wait=0, warmup=1, active=1, repeat=1)
    with profile(activities=_activities(), schedule=plan, with_stack=with_stack) as prof:
        if primer is not None:
            primer()
        _settle(margin)
        prof.step()
        _settle(margin)
        yield prof
        _settle(margin)
        prof.step()


class _Window:
    """What :func:`trace` yields: the capture's path once the window closed."""

    path: Optional[str] = None


@contextlib.contextmanager
def trace(profile_dir: str, primer=None, with_stack: bool = False):
    """A profile window: the named scopes open, a :func:`profiled_window`
    recording (warmed by ``primer()`` where one is given; Python function
    events where ``with_stack``), and its Chrome trace written into
    ``profile_dir`` as ``<host>.<pid>.<time_ns>.pt.trace.json`` when the
    block ends (what :func:`replay_tpu_torch.utils.profiling.trace` opens)."""
    os.makedirs(profile_dir, exist_ok=True)
    window = _Window()
    with profiled_window(primer, with_stack=with_stack) as prof:
        with scopes_on():
            yield window
    path = os.path.join(profile_dir, f"{socket.gethostname()}.{os.getpid()}.{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    window.path = path


def device_events(events) -> list:
    """A profiler's ``key_averages()`` kernels and copies: its device events
    with device time, less the profiler's own ``ProfilerStep`` range."""
    from torch.autograd import DeviceType

    return [
        e for e in events
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0 and not e.key.startswith("ProfilerStep")
    ]


def out_of_range_records(path: str) -> Optional[int]:
    """The device records that kineto dropped as out of its window's range,
    read from an exported Chrome trace's log lines; None where the trace
    carries no such line (kineto logged above INFO, or a CPU run)."""
    with open(path) as fh:
        payload = json.load(fh)
    counts = [
        int(found.group(1))
        for level in ("INFO", "WARNING")
        for line in payload.get(level) or ()
        for found in [_OUT_OF_RANGE.search(str(line))]
        if found
    ]
    return sum(counts) if counts else None


def kernels_by_launch(path: str, pattern: str) -> Dict[str, Any]:
    """The kernels whose name matches ``pattern`` in an exported Chrome
    trace, by the launch call of their correlation id: ``kernels`` in all,
    ``graph_launches`` (the count of them in each ``cudaGraphLaunch`` that
    holds one, in the trace's order), ``eager`` (those of any other launch
    call) and ``orphans`` (those whose launch call is not in the trace)."""
    name = re.compile(pattern)
    events = load_capture(path)
    calls = {
        e["args"]["correlation"]: str(e.get("name", "")) for e in events
        if e.get("cat") in _RUNTIME_CATEGORIES and "correlation" in (e.get("args") or {})
    }
    found: Dict[Any, int] = {}
    orphans = 0
    for e in events:
        if e.get("cat") != "kernel" or not name.search(str(e.get("name", ""))):
            continue
        correlation = (e.get("args") or {}).get("correlation")
        if correlation in calls:
            found[correlation] = found.get(correlation, 0) + 1
        else:
            orphans += 1
    graphs = [n for c, n in found.items() if "GraphLaunch" in calls[c]]
    return {
        "kernels": sum(found.values()) + orphans,
        "graph_launches": graphs,
        "eager": sum(n for c, n in found.items() if "GraphLaunch" not in calls[c]),
        "orphans": orphans,
    }


# --------------------------------------------------------------------------- #
# reading a capture
# --------------------------------------------------------------------------- #
def latest_capture(profile_dir: str) -> Optional[str]:
    """Newest ``*.pt.trace.json`` (or ``.json.gz``) under ``profile_dir``, or
    None when nothing was captured."""
    captures = [
        path
        for pattern in ("*.pt.trace.json", "*.pt.trace.json.gz")
        for path in glob.glob(os.path.join(profile_dir, "**", pattern), recursive=True)
    ]
    captures.sort(key=os.path.getmtime)
    return captures[-1] if captures else None


def load_capture(path: str) -> List[Dict[str, Any]]:
    """The ``traceEvents`` list of a (gzipped) Chrome trace-event capture."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        payload = json.load(fh)
    events = payload.get("traceEvents") if isinstance(payload, Mapping) else payload
    if not isinstance(events, list):
        msg = f"{path}: no traceEvents list"
        raise ValueError(msg)
    return [e for e in events if isinstance(e, Mapping)]


def _complete(events: Iterable[Mapping[str, Any]]) -> List[Mapping[str, Any]]:
    out = []
    for event in events:
        duration = event.get("dur", 0)
        if event.get("ph") == "X" and isinstance(duration, (int, float)) and duration >= 0:
            out.append(event)
    return out


def _top_level_host_ops(events: List[Mapping[str, Any]]) -> List[Mapping[str, Any]]:
    """Host ``cpu_op`` events that no other ``cpu_op`` of their thread contains."""
    by_thread: Dict[Any, List[Mapping[str, Any]]] = {}
    for event in events:
        if event.get("cat") == "cpu_op":
            by_thread.setdefault((event.get("pid"), event.get("tid")), []).append(event)
    top = []
    for ops in by_thread.values():
        ops.sort(key=lambda e: (float(e["ts"]), -float(e["dur"])))
        end = float("-inf")
        for op in ops:
            if float(op["ts"]) >= end:
                top.append(op)
                end = float(op["ts"]) + float(op["dur"])
    return top


def device_op_times(events: Iterable[Mapping[str, Any]]) -> Dict[Tuple[str, str], float]:
    """``{(category, name): seconds}`` over a capture's device events
    (kernels, copies, fills); a capture without any (a CPU run) totals its
    host threads' top-level ops instead, under the category ``cpu_op``."""
    complete = _complete(events)
    device = [e for e in complete if e.get("cat") in _DEVICE_CATEGORIES]
    chosen = device if device else _top_level_host_ops(complete)
    totals: Dict[Tuple[str, str], float] = {}
    for event in chosen:
        key = (str(event.get("cat")), str(event.get("name")))
        totals[key] = totals.get(key, 0.0) + float(event["dur"]) / 1e6
    return totals


def scope_of(op_path: str, scopes: Sequence[str] = NAMED_SCOPES) -> Optional[str]:
    """The deepest named scope appearing in a ``/``-separated scope path (the
    ranges open around an op, outermost first); a scope also matches inside
    parentheses, as in the JAX op paths. The rightmost match wins."""
    best: Tuple[int, Optional[str]] = (-1, None)
    for name in scopes:
        pattern = re.compile(r"(?:^|/|\()" + re.escape(name) + r"(?:\)|/|$)")
        last = None
        for match in pattern.finditer(op_path):
            last = match
        if last is not None and last.start() > best[0]:
            best = (last.start(), name)
    return best[1]


class _Scopes:
    """The scope path open at any time on any host thread of a capture: the
    named ranges, and each backward range labelled with the scope path of
    the forward op its sequence number names. Ranges of one thread nest, so
    each thread's ranges form a tree that a lookup climbs."""

    def __init__(self, events: List[Mapping[str, Any]], scopes: Sequence[str]) -> None:
        self._raw: Dict[Any, List[Tuple[float, float, str]]] = {}
        for event in events:
            if event.get("cat") == "user_annotation" and event.get("name") in scopes:
                self._add(event, str(event["name"]))
        self._index()
        # forward ops name their scope path by sequence number; the backward
        # ranges of the same numbers take it
        forward_paths: Dict[int, str] = {}
        backward: List[Tuple[Mapping[str, Any], int]] = []
        for event in events:
            if event.get("cat") != "cpu_op":
                continue
            seq = (event.get("args") or {}).get("Sequence number")
            if seq is None:
                continue
            if str(event.get("name", "")).startswith(_BACKWARD_PREFIX):
                backward.append((event, int(seq)))
            elif int(seq) not in forward_paths:
                path = self.path_at(self._thread(event), float(event["ts"]))
                if path:
                    forward_paths[int(seq)] = path
        for event, seq in backward:
            if seq in forward_paths:
                self._add(event, forward_paths[seq])
        self._index()

    @staticmethod
    def _thread(event: Mapping[str, Any]) -> Any:
        return (event.get("pid"), event.get("tid"))

    def _add(self, event: Mapping[str, Any], label: str) -> None:
        start = float(event["ts"])
        self._raw.setdefault(self._thread(event), []).append((start, start + float(event["dur"]), label))

    def _index(self) -> None:
        """Per thread: the ranges by start, each with its enclosing range."""
        self._trees: Dict[Any, Tuple[List[float], List[Tuple[float, float, str]], List[int]]] = {}
        for thread, intervals in self._raw.items():
            intervals.sort(key=lambda item: (item[0], -item[1]))
            parents: List[int] = []
            stack: List[int] = []
            for i, (start, _, _) in enumerate(intervals):
                while stack and intervals[stack[-1]][1] < start:
                    stack.pop()
                parents.append(stack[-1] if stack else -1)
                stack.append(i)
            self._trees[thread] = ([item[0] for item in intervals], intervals, parents)

    def path_at(self, thread: Any, at: float) -> str:
        """The labels of the ranges open at ``at`` on ``thread``, outermost first."""
        tree = self._trees.get(thread)
        if tree is None:
            return ""
        starts, intervals, parents = tree
        i = bisect.bisect_right(starts, at) - 1
        while i >= 0 and intervals[i][1] < at:
            i = parents[i]
        labels = []
        while i >= 0:
            labels.append(intervals[i][2])
            i = parents[i]
        return "/".join(reversed(labels))


def kernel_scopes(events: Iterable[Mapping[str, Any]], scopes: Sequence[str] = NAMED_SCOPES) -> List[Tuple[str, Optional[str]]]:
    """``[(kernel name, scope)]`` of a capture's kernels in launch order: the
    traced eager warm-up of a graph, for :func:`attribute_events`."""
    complete = _complete(events)
    resolver = _Scopes(complete, scopes)
    launches = {
        (e.get("args") or {}).get("correlation"): e for e in complete if e.get("cat") in _RUNTIME_CATEGORIES
    }
    out = []
    for kernel in sorted((e for e in complete if e.get("cat") == "kernel"), key=lambda e: float(e["ts"])):
        launch = launches.get((kernel.get("args") or {}).get("correlation"))
        path = resolver.path_at(_Scopes._thread(launch), float(launch["ts"])) if launch is not None else ""
        out.append((str(kernel.get("name")), scope_of(path, scopes) if path else None))
    return out


def attribute_events(
    events: Iterable[Mapping[str, Any]],
    graph_kernels: Optional[Mapping[str, Sequence[Tuple[str, Optional[str]]]]] = None,
    scopes: Sequence[str] = NAMED_SCOPES,
    kernels: Optional[Mapping[str, str]] = None,
) -> Dict[str, Any]:
    """:func:`attribute_capture` on a loaded event list (see the module
    docstring). ``graph_kernels`` maps a graph program's name to its traced
    eager warm-up (:func:`kernel_scopes` of one step); a replay whose kernel
    names are that sequence, repeated, takes its scopes position by position.
    ``kernels`` maps labels to kernel-name patterns (:data:`TRACE_NAMES`): the
    record then also counts each label's kernels, by scope."""
    complete = _complete(events)
    resolver = _Scopes(complete, scopes)
    device = [e for e in complete if e.get("cat") in _DEVICE_CATEGORIES]
    launches = {
        (e.get("args") or {}).get("correlation"): e for e in complete if e.get("cat") in _RUNTIME_CATEGORIES
    }
    # (event, module, scope) for every timed event
    placed: List[Tuple[Mapping[str, Any], str, Optional[str]]] = []
    unmatched: List[Dict[str, Any]] = []  # replays that matched no warm-up, for the record
    if device:
        replays: Dict[Any, List[Mapping[str, Any]]] = {}
        for event in device:
            correlation = (event.get("args") or {}).get("correlation")
            launch = launches.get(correlation)
            if launch is not None and "GraphLaunch" in str(launch.get("name", "")):
                replays.setdefault(correlation, []).append(event)
                continue
            path = resolver.path_at(_Scopes._thread(launch), float(launch["ts"])) if launch is not None else ""
            placed.append((event, "eager", scope_of(path, scopes) if path else None))
        for replay in replays.values():
            replay.sort(key=lambda e: float(e["ts"]))
            launched = [e for e in replay if e.get("cat") == "kernel"]
            names = [str(e.get("name")) for e in launched]
            module, mapped = "graph", {}
            for program, warmup in (graph_kernels or {}).items():
                step = [name for name, _ in warmup]
                if step and len(names) % len(step) == 0 and names == step * (len(names) // len(step)):
                    module = program
                    mapped = {id(e): warmup[i % len(step)][1] for i, e in enumerate(launched)}
                    break
            else:
                if len(unmatched) < 3:
                    unmatched.append(_first_difference(names, graph_kernels or {}))
            placed.extend((e, module, mapped.get(id(e))) for e in replay)
    else:
        for event in _top_level_host_ops(complete):
            path = resolver.path_at(_Scopes._thread(event), float(event["ts"]))
            placed.append((event, "cpu", scope_of(path, scopes) if path else None))

    total, attributed = 0.0, 0.0
    modules: Dict[str, float] = {}
    scope_seconds: Dict[str, float] = {}
    for event, module, name in placed:
        seconds = float(event["dur"]) / 1e6
        total += seconds
        modules[module] = modules.get(module, 0.0) + seconds
        if name is not None:
            scope_seconds[name] = scope_seconds.get(name, 0.0) + seconds
            attributed += seconds
    ordered = {
        name: {"seconds": scope_seconds[name], "fraction": scope_seconds[name] / total if total > 0 else 0.0}
        for name in (*scopes, *sorted(set(scope_seconds) - set(scopes)))
        if name in scope_seconds
    }
    record = {
        "total_device_seconds": total,
        "modules": modules,
        "scopes": ordered,
        "attributed_seconds": attributed,
        "unattributed_seconds": max(total - attributed, 0.0),
    }
    if unmatched:
        record["unmatched_replays"] = unmatched
    if kernels:
        counted: Dict[str, Dict[str, Any]] = {label: {"count": 0, "scopes": {}} for label in kernels}
        for event, _, name in placed:
            if event.get("cat") != "kernel":
                continue
            for label, pattern in kernels.items():
                if re.search(pattern, str(event.get("name", ""))):
                    entry = counted[label]
                    entry["count"] += 1
                    where = name if name is not None else "unattributed"
                    entry["scopes"][where] = entry["scopes"].get(where, 0) + 1
        record["kernels"] = counted
    return record


def _first_difference(names: List[str], graph_kernels: Mapping[str, Sequence[Tuple[str, Optional[str]]]]) -> Dict[str, Any]:
    """Where a replay's kernel names part from each warm-up's, repeated."""
    out: Dict[str, Any] = {"kernels": len(names)}
    for program, warmup in graph_kernels.items():
        step = [name for name, _ in warmup]
        expected = step * max(1, -(-len(names) // max(len(step), 1)))
        at = next((i for i, (a, b) in enumerate(zip(names, expected)) if a != b), min(len(names), len(expected)))
        out[program] = {
            "warmup_kernels": len(step), "first_difference": at,
            "replayed": names[at][:80] if at < len(names) else None,
            "warmup": expected[at][:80] if at < len(expected) else None,
        }
    return out


def attribute_capture(
    profile_dir: str,
    graph_kernels: Optional[Mapping[str, Sequence[Tuple[str, Optional[str]]]]] = None,
    scopes: Sequence[str] = NAMED_SCOPES,
    kernels: Optional[Mapping[str, str]] = None,
) -> Dict[str, Any]:
    """Per-scope device time of the newest capture under ``profile_dir``.

    :returns: ``{"capture", "total_device_seconds", "modules": {module:
        seconds}, "scopes": {scope: {"seconds", "fraction"}},
        "attributed_seconds", "unattributed_seconds"}``; ``modules`` splits
        the time into ``eager`` launches and each graph program's replays
        (``graph`` where a replay matched no warm-up); fractions are of the
        total device time, and attributed + unattributed == total.
    :raises FileNotFoundError: no capture under ``profile_dir``.
    """
    capture = latest_capture(profile_dir)
    if capture is None:
        msg = f"{profile_dir}: no torch.profiler capture (*.pt.trace.json)"
        raise FileNotFoundError(msg)
    return {"capture": capture, **attribute_events(load_capture(capture), graph_kernels, scopes, kernels)}


def kernel_wrappers() -> list:
    """The kernel wrappers whose launches :data:`TRACE_NAMES` finds in a trace."""
    from replay_tpu_torch.ops.flash_attention import flash_attention
    from replay_tpu_torch.ops.flash_tiled import flash_attention_tiled
    from replay_tpu_torch.ops.fused_ce import fused_lse_dh, fused_lse_dw, fused_lse_forward

    return [flash_attention, flash_attention_tiled, fused_lse_forward, fused_lse_dh, fused_lse_dw]


def launch_counts() -> Dict[str, int]:
    """Each kernel wrapper's launches so far (``ops/counts.py``), by name."""
    return {fn.__name__: fn.launches for fn in kernel_wrappers()}


def traced_kernel_scopes(fn, scopes: Sequence[str] = NAMED_SCOPES) -> List[Tuple[str, Optional[str]]]:
    """Run ``fn()`` twice, the first time as the profiler's warm-up cycle (a
    cold start loses kernels of its window), the second in a profile window
    with the scopes open, and return that run's kernels with their scopes
    (:func:`kernel_scopes`): a graph's eager warm-up, traced so that its
    replays can be attributed."""
    with tempfile.TemporaryDirectory() as directory:
        with trace(directory, primer=fn) as window:
            fn()
        return kernel_scopes(load_capture(window.path), scopes)
