"""Weights carried across between the JAX package and the port.

``flax_to_torch`` maps a JAX model's param tree (``SasRec``, ``Bert4Rec``,
``TwoTower``: nested dicts of arrays, with or without the outer ``"params"``
key) onto the port's ``state_dict``; ``torch_to_flax`` is its inverse, and a
round trip is exact. The port's modules carry the flax names, so a path maps
by swapping ``/`` for ``.`` and renaming the leaf:

* ``Dense.kernel`` ``[in, out]`` → ``Linear.weight`` ``[out, in]`` (transposed;
  a bias-free ``Dense`` has no ``bias`` on either side);
* ``LayerNorm.scale`` → ``weight``;
* ``Embed.embedding`` → ``weight``;
* ``bias`` and raw params (``positional_embedding``, Bert4Rec's
  ``mask_embedding``) carry over as they are.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    flat: Dict[str, np.ndarray] = {}
    for key, value in tree.items():
        path = f"{prefix}{key}"
        if hasattr(value, "items"):
            flat.update(_flatten(value, prefix=f"{path}/"))
        else:
            flat[path] = np.asarray(value)
    return flat


def flax_to_torch(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a flax param tree."""
    if set(params) == {"params"}:
        params = params["params"]
    state: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(params).items():
        *parents, leaf = path.split("/")
        if leaf == "kernel":
            leaf, value = "weight", value.T
        elif leaf in ("scale", "embedding"):
            leaf = "weight"
        state[".".join([*parents, leaf])] = torch.tensor(np.ascontiguousarray(value))
    return state


def torch_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The flax param tree (numpy leaves, no outer ``"params"`` key) for a
    ``state_dict`` of one of the port's models."""
    tree: Dict[str, Any] = {}
    for name, tensor in state_dict.items():
        *parents, leaf = name.split(".")
        value = tensor.detach().cpu().numpy()
        if leaf == "weight":
            if value.ndim == 1:
                leaf = "scale"
            elif parents[-1] == "table":
                leaf = "embedding"
            else:
                leaf, value = "kernel", value.T
        node = tree
        for parent in parents:
            node = node.setdefault(parent, {})
        node[leaf] = np.ascontiguousarray(value)
    return tree
