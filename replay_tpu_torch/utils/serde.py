"""JSON helpers for ``.replay`` artefacts.

Counterpart of ``replay_tpu/utils/serde.py``: the encoders' ``save`` writes
their labels through :func:`to_plain`.
"""

from __future__ import annotations

import numpy as np


def to_plain(value):
    """numpy scalars and arrays as plain Python; other values pass through."""
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, np.ndarray):
        return value.tolist()
    return value
