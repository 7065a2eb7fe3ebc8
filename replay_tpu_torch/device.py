"""Device resolution for the port's entry points.

``SasRec``, ``CompiledInference.compile`` and ``ScoringEngine`` take
``device="cuda"`` by default: the port is built for the GPU, and running it on
the CPU is something a caller asks for by name (``device="cpu"``, as the tests
do). There is no silent fallback.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        msg = (
            f"device={str(device)!r} but torch sees no CUDA device; pass "
            "device='cpu' to run on the CPU"
        )
        raise RuntimeError(msg)
    return device
