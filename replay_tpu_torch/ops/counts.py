"""Launch counts of the kernel wrappers, through CUDA graphs too.

Every kernel wrapper keeps a plain integer ``launches`` (and, where it has
variants, ``launches_by_variant``), so that a run can show which kernels its
path went through. A wrapper adds to them with :func:`launched` where it
launches its kernel. While a CUDA graph is being captured on the launch's
stream the kernel does not run: the launch is recorded in that capture's list
instead, and :func:`add_recorded` adds the whole list once per replay of the
graph (``nn/graphs.py``). So the counts equal the kernels the card ran, eager
or replayed, as a profiler trace of the same work shows them.

Captures are looked up by stream, not by thread: autograd runs a captured
backward on its own worker thread, on the stream of the forward. A remat
step's recompute (``nn/remat.py``) launches K4 and K5 again inside that
backward: those launches count like any other, so a remat step counts each
attention kernel twice a block.

The ``ctypes`` kernels (K1–K3) are invisible to PyTorch's dispatch-mode
counters (``obs/mfu.py``'s FLOP and byte counts): each reports its costs
with :func:`opaque` instead, and its plain version runs inside
:func:`outside_modes`, so that a program counts the same on the CPU as on
the card.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

Launch = Tuple[Any, Optional[str]]

# the stream handle (an int) of every capture in progress -> its launch list
_RECORDING: Dict[int, List[Launch]] = {}
_LOCK = threading.Lock()
# the counts themselves: several serve workers replay their graphs at once
# (a fleet of services on one card), and ``+=`` on an attribute is a
# read-modify-write that loses updates between threads
_COUNT_LOCK = threading.Lock()
# the open cost sinks of obs/mfu.py::program_costs (any thread: autograd runs
# the backward on a worker thread)
_COST_SINKS: List[List[Dict[str, float]]] = []


def add(wrapper, variant: Optional[str] = None) -> None:
    """Add one launch to ``wrapper``'s counts (and its ``variant``'s)."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        if variant is not None:
            wrapper.launches_by_variant[variant] += 1


def launched(wrapper, stream: int, variant: Optional[str] = None) -> None:
    """One launch of ``wrapper``'s kernel on ``stream`` (its ``cuda_stream``
    handle): counted now, or recorded when that stream is capturing a graph."""
    with _LOCK:
        recorded = _RECORDING.get(stream)
        if recorded is not None:
            recorded.append((wrapper, variant))
            return
    add(wrapper, variant)


def add_recorded(recorded: List[Launch]) -> None:
    """Count the launches a graph captured: called once per replay."""
    for wrapper, variant in recorded:
        add(wrapper, variant)


@contextlib.contextmanager
def recording(stream: int) -> Iterator[List[Launch]]:
    """Record, instead of counting, every launch on ``stream`` while the block
    runs (a graph capture); yields the list."""
    recorded: List[Launch] = []
    with _LOCK:
        if stream in _RECORDING:
            msg = f"stream {stream:#x} is already recording a capture"
            raise RuntimeError(msg)
        _RECORDING[stream] = recorded
    try:
        yield recorded
    finally:
        with _LOCK:
            del _RECORDING[stream]


def opaque(flops: float, nbytes: float) -> None:
    """An opaque kernel call's FLOPs and bytes moved, for every open
    :func:`opaque_costs` sink (nothing when none is open)."""
    if not _COST_SINKS:
        return
    with _LOCK:
        for sink in _COST_SINKS:
            sink.append({"flops": float(flops), "bytes": float(nbytes)})


@contextlib.contextmanager
def opaque_costs() -> Iterator[List[Dict[str, float]]]:
    """Collect the :func:`opaque` reports made while the block runs."""
    sink: List[Dict[str, float]] = []
    with _LOCK:
        _COST_SINKS.append(sink)
    try:
        yield sink
    finally:
        with _LOCK:
            _COST_SINKS.remove(sink)


def outside_modes():
    """Run the block outside every active dispatch mode: an opaque kernel's
    plain version, which a counter must not see op by op."""
    from torch.utils._python_dispatch import _disable_current_modes

    return _disable_current_modes()
