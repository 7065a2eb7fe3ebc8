"""Weights carried across between the JAX package and the port.

``flax_to_torch`` maps a JAX model's param tree (``SasRec``, ``Bert4Rec``,
``TwoTower``, ``TiSasRec``: nested dicts of arrays, with or without the outer ``"params"``
key) onto the port's ``state_dict``; ``torch_to_flax`` is its inverse, and a
round trip is exact. The port's modules carry the flax names, so a path maps
by swapping ``/`` for ``.`` and renaming the leaf:

* ``Dense.kernel`` ``[in, out]`` → ``Linear.weight`` ``[out, in]`` (transposed;
  a bias-free ``Dense`` has no ``bias`` on either side);
* ``LayerNorm.scale`` and ``RMSNorm.scale`` → ``weight``;
* ``Embed.embedding`` → ``weight`` (the feature tables, list features'
  included, and TiSasRec's ``interval_bias``);
* ``bias`` and raw params (``positional_embedding``, Bert4Rec's
  ``mask_embedding``, the differential attention's ``lambda_*``) carry over
  as they are.

A scanned encoder (``scan_blocks=True``: ``encoder/blocks/block/...``) stacks
every leaf on a leading layer axis; the rules apply per layer, so a stacked
kernel ``[N, in, out]`` becomes a weight ``[N, out, in]``.

Optimizer state carries across with ``opt_state_from_jax``: optax's chain
state (Adam's ``count``, ``mu`` and ``nu`` trees, momentum's ``trace``, a
schedule's ``count``) onto the trainer's links, each moment tree flattened
into one buffer in the order of the port's flat parameter buffer.

A retrieval index carries across too: ``ivf_state_from_jax`` maps the JAX
``IVFState`` (its arrays read as numpy, its config and scalars) onto the
port's, and ``mips_index_from_jax`` a whole JAX ``MIPSIndex`` (the brute f32
or int8 table, or an IVF state) onto the port's, with no build. Both read the
JAX objects by attribute and never import JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Sequence

import numpy as np
import torch

from replay_tpu_torch.device import DeviceLike, resolve_device
from replay_tpu_torch.models.ann import MIPSIndex
from replay_tpu_torch.models.ivf import IVFConfig, IVFState


# the port's modules whose ``weight`` is a flax ``Embed``'s ``embedding``
_EMBED_MODULES = ("table", "interval_bias")


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
            leaf, value = "weight", np.swapaxes(value, -1, -2)
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
            # a scanned stack's leaves carry a leading layer axis
            rank = value.ndim - ("blocks" in parents)
            if rank == 1:
                leaf = "scale"
            elif parents[-1] in _EMBED_MODULES:
                leaf = "embedding"
            else:
                leaf, value = "kernel", np.swapaxes(value, -1, -2)
        node = tree
        for parent in parents:
            node = node.setdefault(parent, {})
        node[leaf] = np.ascontiguousarray(value)
    return tree


def _optax_links(state) -> List[Any]:
    """The per-transformation states of an optax chain state, in order
    (nested chains flattened; each is a NamedTuple, ``EmptyState`` included)."""
    if hasattr(state, "_fields"):
        return [state]
    if isinstance(state, (tuple, list)):
        return [link for part in state for link in _optax_links(part)]
    return [state]


def opt_state_from_jax(
    opt_state, like: Sequence[Mapping[str, torch.Tensor]], names: Sequence[str]
) -> List[Dict[str, torch.Tensor]]:
    """The trainer's optimizer state holding a JAX (optax) one.

    ``like`` is a port state of the same optimizer (``trainer._tx.init``, or
    a ``TrainState.opt_state``): its links give the structure, dtypes and
    device. Each link takes the values of the next optax state with the same
    fields, in chain order: Adam's ``count``, ``mu`` and ``nu``, momentum's
    ``trace``, a schedule's ``count``; links with no state take none.
    ``names`` are the port's parameter names in the order of its flat buffer
    (``TrainState.params``): each moment tree is mapped as ``flax_to_torch``
    maps parameters (a kernel transposed) and concatenated in that order."""
    pending = [link for link in _optax_links(opt_state) if getattr(link, "_fields", ())]
    out: List[Dict[str, torch.Tensor]] = []
    for link in like:
        keys = set(link)
        if not keys:
            out.append({})
            continue
        # the port's link keys are optax's field names
        while pending and set(pending[0]._fields) != keys:
            pending.pop(0)
        if not pending:
            msg = f"the JAX optimizer state has no state with the fields {sorted(keys)} of the port's link"
            raise ValueError(msg)
        source = pending.pop(0)
        carried = {}
        for key, template in link.items():
            value = getattr(source, key)
            if key == "count":
                carried[key] = torch.tensor(np.asarray(value), dtype=template.dtype, device=template.device)
                continue
            tree = flax_to_torch(value)
            carried[key] = torch.cat([tree[name].reshape(-1) for name in names]).to(template.device, template.dtype)
        out.append(carried)
    return out


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
