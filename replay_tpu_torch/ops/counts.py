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
backward on its own worker thread, on the stream of the forward.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

Launch = Tuple[Any, Optional[str]]

# the stream handle (an int) of every capture in progress -> its launch list
_RECORDING: Dict[int, List[Launch]] = {}
_LOCK = threading.Lock()


def add(wrapper, variant: Optional[str] = None) -> None:
    """Add one launch to ``wrapper``'s counts (and its ``variant``'s)."""
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
