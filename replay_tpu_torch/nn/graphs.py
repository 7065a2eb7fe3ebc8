"""CUDA graphs: the port's counterpart of a compiled program.

The JAX package compiles each hot path once (an AOT executable per serving
bucket, one ``lax.scan`` program per training chunk) and then dispatches it
whole. Here the counterpart is a CUDA graph: the path's kernels captured once
at fixed shapes and replayed with one launch. :func:`capture` captures one;
:class:`CapturedProgram` keeps a ``program(params, *inputs)`` as one graph per
input shape, with static input buffers and a static copy of the parameters.

Rules the captured code keeps (the kernel wrappers, the model, the loss and
the optimizer): no host copy to the card, no ``.item()`` or other host read of
a device value, no synchronising call. Kernels are built and cuBLAS is set up
by a warm-up run on the capture stream before the capture. A capture that
fails raises; nothing falls back to running eagerly. Kernel launches are
counted once per replay (:mod:`replay_tpu_torch.ops.counts`).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Hashable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from replay_tpu_torch.ops import counts

# one side stream per device for every warm-up and capture, so that cuBLAS
# keeps one workspace for all of them instead of one per capture
_STREAMS: Dict[int, torch.cuda.Stream] = {}
# one capture at a time per process: they share the per-device stream
_CAPTURE_LOCK = threading.Lock()


def capture_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream that warm-ups and captures on ``device`` run on."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _STREAMS:
        _STREAMS[index] = torch.cuda.Stream(device=index)
    return _STREAMS[index]


class Graph:
    """A captured CUDA graph and the kernel launches it holds."""

    def __init__(self, graph: torch.cuda.CUDAGraph, launches: List[counts.Launch]) -> None:
        self.graph = graph
        self.launches = launches

    def replay(self) -> None:
        """Launch the graph on the current stream; its kernels are counted."""
        self.graph.replay()
        counts.add_recorded(self.launches)


def capture(
    fn: Callable[[], Any],
    device: torch.device,
    pool=None,
    warmup: Optional[Callable[[], Any]] = None,
) -> Tuple[Graph, Any]:
    """Run ``warmup`` (``fn`` by default) once on the capture stream, then
    capture ``fn()`` into a graph. Returns the graph and what ``fn`` returned
    during the capture: tensors that every replay writes anew. ``pool`` is a
    memory pool handle shared with graphs that never run at the same time.
    Raises whatever the capture raised."""
    stream = capture_stream(device)
    current = torch.cuda.current_stream(device)
    with _CAPTURE_LOCK:
        stream.wait_stream(current)
        with torch.cuda.stream(stream):
            (warmup or fn)()
        graph = torch.cuda.CUDAGraph()
        with counts.recording(stream.cuda_stream) as launches:
            with torch.cuda.graph(graph, pool=pool, stream=stream, capture_error_mode="thread_local"):
                outputs = fn()
        current.wait_stream(stream)
    return Graph(graph, list(launches)), outputs


def _clone_rows(out, rows: Optional[int]):
    """Clones of ``out``'s tensors (their first ``rows`` rows, or whole)."""
    if isinstance(out, tuple):
        return tuple(_clone_rows(o, rows) for o in out)
    if isinstance(out, dict):
        return {name: _clone_rows(o, rows) for name, o in out.items()}
    return out.clone() if rows is None else out[:rows].clone()


def signature(inputs: Sequence[Any]) -> Tuple[Any, ...]:
    """The shapes and dtypes of ``inputs`` (``None`` where one is absent):
    what a graph is captured for, so part of a key where shapes vary."""
    def one(x):
        if x is None:
            return None
        x = x if isinstance(x, torch.Tensor) else np.asarray(x)
        return tuple(x.shape), str(x.dtype)

    return tuple(one(x) for x in inputs)


def program_for(programs, key: Hashable) -> Callable[..., Any]:
    """``programs[key]``, or ``programs(key)`` where the programs are made
    from their key (one program per kind, its static arguments in the key)."""
    return programs[key] if isinstance(programs, Mapping) else programs(key)


class EagerProgram:
    """:class:`CapturedProgram`'s call, running the program itself: what a
    CPU trainer runs, and on the card the eager reference that each graph is
    held to bit for bit. It captures nothing (no ``keys``, no ``warmups``)."""

    keys: Tuple[Hashable, ...] = ()
    warmups = 0

    def __init__(self, programs) -> None:
        self._programs = programs

    def __call__(self, key: Hashable, params: Mapping[str, torch.Tensor], inputs: Sequence[Any], rows: Optional[int] = None):
        out = program_for(self._programs, key)(params, *inputs)
        return out if rows is None else _clone_rows(out, rows)


def runner(programs, device: torch.device):
    """What runs ``programs`` on ``device``: a :class:`CapturedProgram` (one
    CUDA graph per key) on the card, an :class:`EagerProgram` elsewhere."""
    return CapturedProgram(programs, device) if device.type == "cuda" else EagerProgram(programs)


def _fill(static: torch.Tensor, value) -> None:
    """Copy a host array or a tensor into a static buffer."""
    if isinstance(value, np.ndarray):
        value = torch.from_numpy(value)
    static.copy_(value)


class CapturedProgram:
    """``programs[key](params, *inputs)`` on the card as one CUDA graph per
    key (a bucket: one input shape), the counterpart of the JAX package's AOT
    executable per bucket. ``programs`` is a mapping, or a callable that
    makes a key's program from the key (:func:`program_for`).

    Params stay an argument of every call, as in the JAX package: the graphs
    read a static copy of the installed parameter set, and a call with another
    mapping (a hot swap, a per-call override) copies it in before its replay.
    A mapping is installed by identity: a caller that changes a tensor of an
    installed mapping in place passes a new mapping (``swap_params`` makes one).
    Calls are serialised by one lock, and each call's stream waits for the
    previous call's event, so a replay never sees two parameter sets mixed,
    and returned outputs are clones that the next replay does not touch.
    ``warmups`` counts the eager warm-up runs (one before each capture).
    """

    def __init__(self, programs, device: torch.device) -> None:
        self._programs = programs
        self.device = device
        self._lock = threading.Lock()
        self._graphs: Dict[Hashable, Tuple[Graph, List[Optional[torch.Tensor]], Any]] = {}
        self._params: Optional[Dict[str, torch.Tensor]] = None
        self._installed: Optional[Mapping[str, torch.Tensor]] = None
        self._pool = None
        self._done: Optional[torch.cuda.Event] = None
        self.warmups = 0
        self.replays = 0

    def _install(self, params: Mapping[str, torch.Tensor]) -> None:
        if self._params is None:
            self._params = {name: value.detach().clone() for name, value in params.items()}
        elif params is not self._installed:
            with torch.no_grad():
                for name, value in params.items():
                    self._params[name].copy_(value)
        self._installed = params

    def _capture(self, key: Hashable, inputs: Sequence[Any]) -> None:
        static = [
            None if x is None else torch.as_tensor(x).to(self.device).clone()
            for x in inputs
        ]
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        params, program = self._params, program_for(self._programs, key)

        def run():
            with torch.no_grad():
                return program(params, *static)

        try:
            graph, outputs = capture(run, self.device, self._pool)
        except BaseException:
            # a failed capture leaves its memory pool marked as recording:
            # later captures of this program take a new pool
            self._pool = None
            raise
        self.warmups += 1
        self._graphs[key] = (graph, static, outputs)

    def prepare(self, key: Hashable, params: Mapping[str, torch.Tensor], inputs: Sequence[Any]) -> None:
        """Capture the graph for ``key`` now, from example ``inputs``."""
        with self._lock:
            self._install(params)
            if key not in self._graphs:
                self._capture(key, inputs)

    def __call__(self, key: Hashable, params: Mapping[str, torch.Tensor], inputs: Sequence[Any], rows: Optional[int] = None):
        """Replay ``key``'s graph on ``inputs`` (host arrays or tensors of the
        captured shapes; ``None`` where the program takes none) with ``params``;
        returns clones of the outputs' first ``rows`` rows (of the whole
        outputs, without ``rows``). Captures the graph first if ``key`` has
        none (after :meth:`close`, or a new shape)."""
        with self._lock:
            stream = torch.cuda.current_stream(self.device)
            if self._done is not None:
                stream.wait_event(self._done)
            self._install(params)
            if key not in self._graphs:
                self._capture(key, inputs)
            graph, static, outputs = self._graphs[key]
            for buffer, value in zip(static, inputs):
                if buffer is not None:
                    _fill(buffer, value)
            graph.replay()
            self.replays += 1
            result = _clone_rows(outputs, rows)
            self._done = torch.cuda.Event()
            self._done.record(stream)
            return result

    @property
    def keys(self) -> Tuple[Hashable, ...]:
        return tuple(self._graphs)

    def close(self) -> None:
        """Free the graphs, their pool and the static buffers (a later call captures anew)."""
        with self._lock:
            if self._done is not None:
                self._done.synchronize()
            self._graphs.clear()
            self._params = None
            self._installed = None
            self._pool = None
            self._done = None
