"""Small nn helpers.

Counterpart of ``replay_tpu/nn/utils.py`` (``create_activation``). flax's
``nn.gelu`` is the tanh approximation, torch's ``F.gelu`` defaults to the exact
erf form, so ``"gelu"`` here is ``F.gelu(approximate="tanh")``.

Also the flax default initializers the port's modules copy, drawn from an
explicit ``torch.Generator`` (the numbers differ from ``jax.random``'s; the
distributions are the same).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

_ACTIVATIONS = {
    "relu": F.relu,
    "gelu": partial(F.gelu, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "silu": F.silu,
}

# std of a unit normal truncated at ±2, which lecun_normal divides out
TRUNCATED_STD = 0.87962566103423978


def create_activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """Activation function by name (``relu`` / ``gelu`` / ``sigmoid`` / ``silu``)."""
    if name not in _ACTIVATIONS:
        msg = f"Expected activation one of {sorted(_ACTIVATIONS)}, got {name!r}"
        raise ValueError(msg)
    return _ACTIVATIONS[name]


@torch.no_grad()
def init_dense(dense: nn.Linear, generator: torch.Generator) -> None:
    """flax ``Dense`` defaults: lecun-normal kernel truncated at ±2σ, zero bias."""
    std = math.sqrt(1.0 / dense.in_features) / TRUNCATED_STD
    nn.init.trunc_normal_(dense.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
    if dense.bias is not None:
        nn.init.zeros_(dense.bias)
