"""Build and load the port's CUDA kernels.

Each kernel source ``replay_tpu_torch/csrc/<name>.cu`` has a plain C interface
(device helpers they share are in ``csrc/*.cuh``).
At first use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``replay_tpu_torch/_build/`` (listed in ``.gitignore``) and loaded
with ``ctypes``. The library's file name carries a hash of the source and the
flags, so an edited source is rebuilt and a stale library is never loaded.

Nothing here runs at import: the CPU tests import every module, and this
machine class has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

if TYPE_CHECKING:
    import torch

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# name -> loaded library: one load per process, reused by every launch
_LIBRARIES: Dict[str, ctypes.CDLL] = {}
# (name, seconds) of every library compiled at its first use in this process,
# in order: obs/collectors.py::CompileTracker counts the ones a program's
# first call built
BUILD_LOG: List[Tuple[str, float]] = []


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the toolkit's usual home."""
    candidates: List[Optional[str]] = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if path and os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    msg = "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA kernels cannot be built"
    raise RuntimeError(msg)


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives once built. The hash covers
    the source and every shared header of ``csrc/`` (``*.cuh``)."""
    digest = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library exists; returns nvcc's report
    (registers, shared memory and spills per kernel, from ``-Xptxas -v``), or ``""``
    when the library was already built."""
    target = library_path(name)
    if target.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    partial = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(partial), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        partial.unlink(missing_ok=True)
        msg = f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}"
        raise RuntimeError(msg)
    os.replace(partial, target)  # atomic: a process building at the same time never loads half a file
    return proc.stdout + proc.stderr


def build_all(names: Sequence[str]) -> Dict[str, Tuple[float, str]]:
    """Compile several sources at once, one nvcc process each, all started
    together; returns ``{name: (seconds, report)}``. Raises the first failure."""

    def timed(name: str) -> Tuple[float, str]:
        start = time.perf_counter()
        report = build(name)
        return time.perf_counter() - start, report

    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        futures = {name: pool.submit(timed, name) for name in names}
        return {name: future.result() for name, future in futures.items()}


def aligned(t: "torch.Tensor") -> "torch.Tensor":
    """``t`` itself when its data starts on a 16-byte boundary, as the kernels'
    16-byte loads need, else an aligned copy (made by the caching allocator, so
    inside a CUDA graph capture it comes from the graph's pool)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _LIBRARIES:
        start = time.perf_counter()
        if build(name):
            BUILD_LOG.append((name, time.perf_counter() - start))
        _LIBRARIES[name] = ctypes.CDLL(str(library_path(name)))
    return _LIBRARIES[name]
