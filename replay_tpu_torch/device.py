"""Device resolution for the port's entry points.

``SasRec``, ``CompiledInference.compile`` and ``ScoringEngine`` take
``device="cuda"`` by default: the port is built for the GPU, and running it on
the CPU is something a caller asks for by name (``device="cpu"``, as the tests
do). There is no silent fallback.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np
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


def to_device(value: Any, device: Optional[torch.device] = None) -> Any:
    """``value`` — a tensor, anything numpy takes, or a dict of them, nested —
    as tensors on ``device`` (where they already are, when it is None)."""
    if isinstance(value, Mapping):
        return {key: to_device(item, device) for key, item in value.items()}
    tensor = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
    return tensor if device is None else tensor.to(device)
