"""Roofline analysis of the port's programs: memory- vs compute-bound.

Counterpart of ``replay_tpu/obs/roofline.py``. :func:`classify`,
:func:`bench_fields` and :func:`of_ceiling` are the JAX module's, copied
unchanged: flops ÷ bytes is the arithmetic intensity, and the ceiling is
min(peak FLOP/s, intensity × peak bandwidth). What is the port's own is the
peak tables (the card's, keyed by ``torch.cuda.get_device_name()``: H100
SXM, HBM3 at 3.35 TB/s; the compute peak is :mod:`.mfu`'s bf16 entry, as in
JAX) and the cost source: :func:`analyze_program` counts a program over one
run (:func:`.mfu.program_costs`: counted FLOPs, an eager per-op bytes count,
allocator memory), where JAX reads XLA's cost and memory analyses. The JAX
record's collective inventory reads HLO and has no counterpart (one card).

Where the running card has no table entry (the CPU),
``REPLAY_TPU_ROOFLINE_ASSUME_KIND`` (or ``REPLAY_TPU_BENCH_ASSUME_KIND``)
classifies against an assumed card and the record carries ``peak_assumed``,
so arithmetic never reads as measurement.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional

import torch

from .mfu import peak_tflops, program_costs

__all__ = [
    "PEAK_HBM_GBPS",
    "analyze_costs",
    "analyze_program",
    "assumed_device_kind",
    "bench_fields",
    "classify",
    "of_ceiling",
    "peak_bandwidth",
]

# peak HBM bandwidth in GB/s per card, keyed like mfu.PEAK_BF16_TFLOPS
# (a substring of torch.cuda.get_device_name(), lower case)
PEAK_HBM_GBPS = {"h100 80gb hbm3": 3350.0, "h100 sxm": 3350.0}


def peak_bandwidth(device_kind: str) -> Optional[float]:
    """Peak HBM GB/s for a device name, or None for names without a table
    entry (CPU hosts, other cards)."""
    kind = (device_kind or "").lower()
    for key, peak in PEAK_HBM_GBPS.items():
        if key in kind:
            return peak
    return None


def assumed_device_kind() -> Optional[str]:
    """The card kind CPU runs classify against (arithmetic, not
    measurement): ``REPLAY_TPU_ROOFLINE_ASSUME_KIND``, falling back to
    ``REPLAY_TPU_BENCH_ASSUME_KIND``."""
    return os.environ.get("REPLAY_TPU_ROOFLINE_ASSUME_KIND") or os.environ.get(
        "REPLAY_TPU_BENCH_ASSUME_KIND"
    )


def classify(
    flops: float,
    bytes_accessed: float,
    device_kind: str,
    allow_assumed: bool = True,
) -> Optional[Dict[str, Any]]:
    """Roofline classification of one program against one chip's peaks.

    ``critical_intensity`` (flops/byte) is where the roofline's slanted and
    flat parts meet: a program below it is ``"memory"``-bound (its ceiling is
    ``intensity × bandwidth``), above it ``"compute"``-bound (ceiling = MXU
    peak). Returns None when neither the real ``device_kind`` nor an assumed
    kind has table entries, or the cost-model inputs are degenerate — an
    unclassifiable program must stay visibly unclassified, not default to a
    bound.
    """
    flops = float(flops or 0.0)
    bytes_accessed = float(bytes_accessed or 0.0)
    if flops <= 0.0 or bytes_accessed <= 0.0:
        return None
    peak_flops = peak_tflops(device_kind)
    peak_gbps = peak_bandwidth(device_kind)
    assumed = None
    if (peak_flops is None or peak_gbps is None) and allow_assumed:
        assumed = assumed_device_kind()
        if assumed:
            peak_flops = peak_tflops(assumed)
            peak_gbps = peak_bandwidth(assumed)
    if not peak_flops or not peak_gbps:
        return None
    intensity = flops / bytes_accessed
    critical = (peak_flops * 1e12) / (peak_gbps * 1e9)
    bandwidth_ceiling_tflops = intensity * peak_gbps * 1e9 / 1e12
    ceiling = min(peak_flops, bandwidth_ceiling_tflops)
    record = {
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "arithmetic_intensity": intensity,
        "critical_intensity": critical,
        "bound": "memory" if intensity < critical else "compute",
        "ceiling_tflops": ceiling,
        "peak_tflops": peak_flops,
        "peak_hbm_gbps": peak_gbps,
        # the bandwidth-side step-time floor: bytes / peak bandwidth (the
        # compute-side floor is flops / peak flops; the max binds)
        "min_step_seconds": max(
            bytes_accessed / (peak_gbps * 1e9), flops / (peak_flops * 1e12)
        ),
    }
    if assumed:
        record["peak_assumed"] = assumed
    return record


def bench_fields(
    static_record: Optional[Mapping[str, Any]],
    tflops_per_sec: Optional[float] = None,
    device_count: int = 1,
) -> Dict[str, Any]:
    """The flat bench-record fields derived from an :func:`analyze_program`
    record — ONE shaping of key names/rounding shared by ``bench.py`` and
    every ``bench_suite.py`` row, so the two harnesses cannot drift:
    ``hbm_peak_bytes``, ``collective_bytes``, ``roofline_bound``,
    ``roofline_ceiling_tflops``, ``arithmetic_intensity``,
    ``roofline_peak_assumed`` and — when the achieved rate is known —
    ``of_roofline_ceiling`` (per chip, like the ceiling tables)."""
    fields: Dict[str, Any] = {}
    if static_record is None:
        return fields
    if static_record.get("hbm_peak_bytes") is not None:
        fields["hbm_peak_bytes"] = static_record["hbm_peak_bytes"]
    if static_record.get("collective_bytes") is not None:
        fields["collective_bytes"] = static_record["collective_bytes"]
    classification = static_record.get("roofline")
    if classification:
        fields["roofline_bound"] = classification["bound"]
        fields["roofline_ceiling_tflops"] = round(classification["ceiling_tflops"], 3)
        fields["arithmetic_intensity"] = round(classification["arithmetic_intensity"], 2)
        if classification.get("peak_assumed"):
            fields["roofline_peak_assumed"] = classification["peak_assumed"]
        if tflops_per_sec is not None and classification.get("ceiling_tflops"):
            fields["of_roofline_ceiling"] = round(
                float(tflops_per_sec)
                / max(int(device_count), 1)
                / classification["ceiling_tflops"],
                4,
            )
    return fields


def of_ceiling(tflops_per_sec: Optional[float], record: Optional[Mapping[str, Any]]) -> Optional[float]:
    """Achieved ÷ roofline-predicted ceiling — the honest MFU for programs
    whose ceiling is the bandwidth roof, not the MXU peak."""
    if record is None or tflops_per_sec is None:
        return None
    ceiling = record.get("ceiling_tflops")
    if not ceiling:
        return None
    return float(tflops_per_sec) / float(ceiling)


def analyze_program(
    fn: Any,
    *args,
    device_kind: Optional[str] = None,
    extra_flops: float = 0.0,
    extra_bytes: float = 0.0,
    mesh_shape: Optional[Mapping[str, int]] = None,
    device: Optional[torch.device] = None,
    **kwargs,
) -> Optional[Dict[str, Any]]:
    """The record of one program, counted over one run of ``fn(*args,
    **kwargs)`` (which must leave the caller's state alone)::

        {"roofline": classify(...) | None, "flops", "bytes_accessed",
         "argument_bytes", "output_bytes", "temp_bytes", "hbm_peak_bytes"}

    ``extra_flops`` / ``extra_bytes`` add work the counters cannot see.
    ``mesh_shape`` is the JAX signature's (one card: unused)."""
    costs = program_costs(fn, *args, device=device, **kwargs)
    return analyze_costs(costs, device_kind=device_kind, extra_flops=extra_flops, extra_bytes=extra_bytes)


def analyze_costs(
    costs: Optional[Mapping[str, Any]],
    device_kind: Optional[str] = None,
    extra_flops: float = 0.0,
    extra_bytes: float = 0.0,
    mesh_shape: Optional[Mapping[str, int]] = None,
) -> Optional[Dict[str, Any]]:
    """:func:`analyze_program` on an already-counted
    :func:`.mfu.program_costs` record. ``device_kind`` defaults to the
    running card's name (empty without one)."""
    if costs is None:
        return None
    if device_kind is None:
        device_kind = torch.cuda.get_device_name() if torch.cuda.is_available() else ""
    flops = (costs.get("flops") or 0.0) + float(extra_flops)
    bytes_accessed = (costs.get("bytes_accessed") or 0.0) + float(extra_bytes)
    record: Dict[str, Any] = {
        "roofline": classify(flops, bytes_accessed, device_kind or ""),
        "flops": flops,
        "bytes_accessed": bytes_accessed,
    }
    memory = costs.get("memory") or {}
    for key in ("argument_bytes", "output_bytes", "temp_bytes"):
        if key in memory:
            record[key] = memory[key]
    if memory:
        # everything the program holds at once: its arguments, its outputs
        # and its temporaries at the peak
        record["hbm_peak_bytes"] = int(
            (memory.get("argument_bytes") or 0) + (memory.get("output_bytes") or 0) + (memory.get("temp_bytes") or 0)
        )
    return record
