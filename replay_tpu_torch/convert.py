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

A retrieval index carries across too: ``ivf_state_from_jax`` maps the JAX
``IVFState`` (its arrays read as numpy, its config and scalars) onto the
port's, and ``mips_index_from_jax`` a whole JAX ``MIPSIndex`` (the brute f32
or int8 table, or an IVF state) onto the port's, with no build. Both read the
JAX objects by attribute and never import JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from replay_tpu_torch.device import DeviceLike, resolve_device
from replay_tpu_torch.models.ann import MIPSIndex
from replay_tpu_torch.models.ivf import IVFConfig, IVFState


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


def ivf_state_from_jax(state, device: DeviceLike = "cuda") -> IVFState:
    """The port's :class:`IVFState` for a single-device JAX ``IVFState``: the
    same config, scalars and arrays (bitwise), as tensors on ``device``."""
    if getattr(state, "mesh", None) is not None:
        msg = "a mesh-sharded IVF state is not ported yet: ROADMAP.md queue 1, 'Distributed training' (item 9)"
        raise NotImplementedError(msg)
    device = resolve_device(device)
    config = IVFConfig(**{f.name: getattr(state.config, f.name) for f in dataclasses.fields(IVFConfig)})
    arrays = {
        name: None if getattr(state, name) is None else torch.as_tensor(np.array(getattr(state, name)), device=device)
        for name in IVFState._TENSORS
    }
    return IVFState(
        config=config,
        precision=state.precision,
        num_items=int(state.num_items),
        dim=int(state.dim),
        cmax=int(state.cmax),
        storage_rows=int(state.storage_rows),
        padded_fraction=float(state.padded_fraction),
        **arrays,
    )


def mips_index_from_jax(index, device: DeviceLike = "cuda") -> MIPSIndex:
    """The port's :class:`MIPSIndex` holding a single-device JAX
    ``MIPSIndex``'s state: its host f32 master, and its IVF state or its
    brute table (f32, or int8 values and scales), bitwise."""
    if getattr(index, "mesh", None) is not None:
        msg = "a mesh-sharded index is not ported yet: ROADMAP.md queue 1, 'Distributed training' (item 9)"
        raise NotImplementedError(msg)
    if index.index_mode == "ivf":
        return MIPSIndex.from_state(
            index.host_vectors, index.precision, ivf=ivf_state_from_jax(index._ivf, device), device=device
        )
    quantized = None
    if index.precision == "int8":
        quantized = (np.array(index.item_vectors), np.array(index.item_scales))
    return MIPSIndex.from_state(index.host_vectors, index.precision, quantized=quantized, device=device)
