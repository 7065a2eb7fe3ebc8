"""JSON helpers for ``.replay`` artefacts.

Counterpart of ``replay_tpu/utils/serde.py``: the encoders' ``save`` writes
their labels through :func:`to_plain`; :func:`json_default` is the
``json.dumps(default=...)`` hook.
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


def json_default(value):
    """``json.dumps(default=...)`` hook: numpy values as plain Python,
    datetimes as ISO 8601 strings; anything else raises a ``TypeError`` that
    names its type (the hook runs only for values JSON cannot take, so
    returning one unchanged would end in a circular-reference error)."""
    import datetime

    if isinstance(value, (np.generic, np.ndarray)):
        return to_plain(value)
    if isinstance(value, (datetime.datetime, datetime.date)):
        return value.isoformat()
    msg = f"Cannot serialize {type(value).__name__} value in a .replay artifact"
    raise TypeError(msg)
