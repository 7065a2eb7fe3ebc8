"""Item-vocabulary surgery on trained parameters (and optimizer state).

Counterpart of ``replay_tpu/nn/vocabulary.py``: grow, shrink or replace the
item-embedding table of an already-trained model when the catalog changes,
between retrains or during one.

Parameters are a mapping of names to tensors in the order of the trainer's
flat buffer (``model.named_parameters()``, the ``state_dict`` names); each
function returns a new mapping with the table replaced and the others as
they were. An item table is every parameter named
``...embedding_<feature>.table.weight`` (the exact path segment:
``embedding_item`` does not match ``embedding_item_category``). The padding
row stays the last table row (the weight-tying invariant,
``replay_tpu_torch/nn/embedding.py``): growth moves it to the new end and
fills the new rows from the mean of the fitted ones (computed in numpy on
the host, as the JAX package computes it), from a caller's tensor, or from
xavier-normal rows drawn from a ``torch.Generator``. The schema is updated in
place (its cardinality and its default padding value move together).

Optimizer state is the trainer's: a list of dicts, one per link of the
chain, whose 1-D tensors (Adam's ``mu`` and ``nu``, momentum's ``trace``)
are flat buffers laid out as the parameters. :func:`resize_optimizer_state`
applies the same row surgery to each of them: trained rows keep their
moments, cold rows start at zero (a fresh Adam row) and the padding row's
moments move to the new end. A buffer's table rows are read from its own
size (the other parameters' sizes taken from the layout), so a buffer left
at the old size is caught and named (:func:`validate_optimizer_state`).
Surgery is exact: the same on the card as on the CPU, bit for bit.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from replay_tpu_torch.data.nn.schema import TensorSchema

Params = Mapping[str, torch.Tensor]
OptState = List[Dict[str, torch.Tensor]]


def _find_table_path(params: Params, feature_name: str) -> List[Tuple[str, torch.Tensor]]:
    """Every ``...embedding_<feature>.table.weight`` entry of ``params``."""
    marker = f"embedding_{feature_name}"
    matches = [
        (name, value) for name, value in params.items() if marker in name.split(".") and name.endswith(".table.weight")
    ]
    if not matches:
        msg = f"No embedding table found for feature '{feature_name}'."
        raise ValueError(msg)
    return matches


def _moment_buffers(opt_state: Sequence[Mapping[str, torch.Tensor]]) -> List[Tuple[str, int, str, torch.Tensor]]:
    """``(path, link, key, buffer)`` for every flat moment buffer (the 1-D
    tensors; step counts are scalars)."""
    return [
        (f"opt_state[{index}][{key!r}]", index, key, value)
        for index, link in enumerate(opt_state)
        for key, value in link.items()
        if value.dim() == 1
    ]


def _table_rows(buffer: torch.Tensor, layout: Params, tables: Sequence[str]) -> Optional[int]:
    """The rows of each item table that ``buffer`` holds, from its size and
    the other parameters' sizes in ``layout`` (``None`` if they do not divide)."""
    others = sum(value.numel() for name, value in layout.items() if name not in tables)
    width = sum(layout[name].shape[1] for name in tables)
    rows, rest = divmod(buffer.numel() - others, width)
    return rows if rest == 0 and rows >= 0 else None


def resize_optimizer_state(
    opt_state: Sequence[Mapping[str, torch.Tensor]],
    feature_name: str,
    old_cardinality: int,
    new_cardinality: int,
    layout: Params,
) -> Tuple[OptState, int]:
    """Resize every flat moment buffer of ``opt_state`` for a table grown or
    shrunk from ``old_cardinality`` to ``new_cardinality`` (+1 padding row).

    ``layout`` names the parameters of the flat buffer in order (the params
    mapping, before or after the table's resize: only the other parameters'
    sizes and the tables' widths are read). Existing rows keep their
    moments, cold rows get zeros, the padding row's moments move to the new
    last row. A buffer whose table rows are not ``old_cardinality + 1``
    raises, naming it: params and optimizer state out of sync.

    Returns ``(opt_state, resized)``, a new state (step counts copied) and
    the number of (buffer, table) pairs resized; a momentum-free optimizer
    (plain SGD) has no buffers, and returns count 0."""
    tables = [name for name, _ in _find_table_path(layout, feature_name)]
    new_state: OptState = [{key: value.clone() for key, value in link.items()} for link in opt_state]
    resized = 0
    for path, index, key, buffer in _moment_buffers(opt_state):
        rows = _table_rows(buffer, layout, tables)
        if rows != old_cardinality + 1:
            msg = (
                f"Optimizer-state leaf at {path} holds {rows} rows of the item table "
                f"{tables[0]!r} ({buffer.numel()} values); the params table says "
                f"{old_cardinality}+1 — params and optimizer state are out of sync "
                "(was the table resized without its moments?)."
            )
            raise ValueError(msg)
        pieces, offset = [], 0
        for name, value in layout.items():
            if name not in tables:
                pieces.append(buffer[offset : offset + value.numel()])
                offset += value.numel()
                continue
            dim = value.shape[1]
            table = buffer[offset : offset + rows * dim].view(rows, dim)
            offset += rows * dim
            items, padding_row = table[:old_cardinality], table[old_cardinality:]
            if new_cardinality <= old_cardinality:
                new_items = items[:new_cardinality]
            else:
                cold = torch.zeros((new_cardinality - old_cardinality, dim), dtype=table.dtype, device=table.device)
                new_items = torch.cat([items, cold])
            pieces.append(torch.cat([new_items, padding_row]).reshape(-1))
            resized += 1
        new_state[index][key] = torch.cat(pieces)
    return new_state, resized


def validate_optimizer_state(params: Params, opt_state: Sequence[Mapping[str, torch.Tensor]], schema: TensorSchema) -> None:
    """Reject a ``(params, opt_state)`` pair whose item-table shapes drifted
    apart: the guard a resumed or continued fit runs before training, so a
    catalog grown without its moments fails here, naming the table, instead
    of training on moments that no longer line up with the rows. Schemas
    without an ITEM_ID feature, and models without an item table, pass."""
    feature_name = schema.item_id_feature_name
    if feature_name is None:
        return
    try:
        found = _find_table_path(params, feature_name)
    except ValueError:
        return  # no item table in this model's params (nothing to check)
    table_shape = tuple(found[0][1].shape)
    tables = [name for name, _ in found]
    total = sum(value.numel() for value in params.values())
    for path, _, _, buffer in _moment_buffers(opt_state):
        if buffer.numel() != total:
            rows = _table_rows(buffer, params, tables)
            shape = (rows, table_shape[1]) if rows is not None else f"({buffer.numel()} values)"
            msg = (
                f"Optimizer-state leaf at {path} has shape {shape} for the item table but the "
                f"item table 'embedding_{feature_name}' is {table_shape} — the "
                "catalog was resized without its optimizer moments. Resize "
                "both together (Trainer.resize_vocabulary(carry_opt_state=True) "
                "or vocabulary.resize_optimizer_state) before fitting."
            )
            raise ValueError(msg)


def _rows(values, table: torch.Tensor) -> torch.Tensor:
    """``values`` (an array or a tensor) as rows of ``table``'s dtype and device."""
    if isinstance(values, torch.Tensor):
        return values.detach().to(device=table.device, dtype=table.dtype)
    return torch.as_tensor(np.asarray(values)).to(device=table.device, dtype=table.dtype)


def resize_item_embeddings(
    params: Params,
    schema: TensorSchema,
    new_cardinality: int,
    init_tensor=None,
    opt_state: Optional[Sequence[Mapping[str, torch.Tensor]]] = None,
):
    """Grow (or shrink) the item table to ``new_cardinality`` (+1 padding row).

    Existing item rows are kept; new rows come from ``init_tensor`` when
    given (``[new_items, E]`` for the appended rows or ``[new_cardinality, E]``
    for a full replacement), else from the mean of the existing rows. The
    schema's ITEM_ID cardinality (and its default padding value) is updated.

    With ``opt_state`` the optimizer's moment buffers are resized in lockstep
    (:func:`resize_optimizer_state`) and ``(params, opt_state)`` is returned;
    without it, the resized ``params`` alone."""
    feature_name = schema.item_id_feature_name
    if feature_name is None:
        msg = "Schema has no ITEM_ID feature."
        raise ValueError(msg)
    old_cardinality = schema[feature_name].cardinality
    replaced: Dict[str, torch.Tensor] = {}
    for name, table in _find_table_path(params, feature_name):
        table = table.detach()
        rows, dim = table.shape
        if rows != old_cardinality + 1:
            msg = (
                f"Item table at {name!r} has {rows} rows; the "
                f"schema says {old_cardinality}+1 — params and schema are out of "
                "sync (was resize applied twice to the same state?)."
            )
            raise ValueError(msg)
        items, padding_row = table[:old_cardinality], table[old_cardinality:]
        if init_tensor is not None and len(init_tensor) == new_cardinality:
            new_items = _rows(init_tensor, table)
        elif new_cardinality <= old_cardinality:
            if init_tensor is not None:
                msg = (
                    f"init_tensor has {len(init_tensor)} rows; a shrink to "
                    f"{new_cardinality} items accepts only a full [new_cardinality, E] table."
                )
                raise ValueError(msg)
            new_items = items[:new_cardinality]
        else:
            if init_tensor is not None:
                extra = _rows(init_tensor, table)
            else:
                mean = items.cpu().numpy().mean(axis=0, keepdims=True)
                extra = _rows(np.tile(mean, (new_cardinality - old_cardinality, 1)), table)
            if len(extra) != new_cardinality - old_cardinality:
                msg = (
                    f"init_tensor has {len(extra)} rows; expected "
                    f"{new_cardinality - old_cardinality} appended or {new_cardinality} total."
                )
                raise ValueError(msg)
            new_items = torch.cat([items, extra])
        replaced[name] = torch.cat([new_items, padding_row])  # padding stays LAST
    new_params = {name: replaced.get(name, value) for name, value in params.items()}
    schema[feature_name]._set_cardinality(new_cardinality)
    # the padding default re-resolves to the new cardinality (last-row invariant)
    schema[feature_name]._padding_value = None
    if opt_state is not None:
        opt_state, _ = resize_optimizer_state(opt_state, feature_name, old_cardinality, new_cardinality, params)
        return new_params, opt_state
    return new_params


def append_item_embeddings(params: Params, schema: TensorSchema, new_rows) -> Dict[str, torch.Tensor]:
    """Append ``[K, E]`` rows for K new catalog items."""
    feature_name = schema.item_id_feature_name
    if not isinstance(new_rows, torch.Tensor):
        new_rows = np.atleast_2d(np.asarray(new_rows))
    elif new_rows.dim() < 2:
        new_rows = new_rows.reshape(1, -1)
    return resize_item_embeddings(params, schema, schema[feature_name].cardinality + len(new_rows), new_rows)


def set_item_embeddings(params: Params, schema: TensorSchema, table) -> Dict[str, torch.Tensor]:
    """Replace the whole item table with ``[num_items, E]`` rows."""
    return resize_item_embeddings(params, schema, len(table), table)


# the reference's name for it
set_item_embeddings_by_tensor = set_item_embeddings


def set_item_embeddings_by_size(
    params: Params,
    schema: TensorSchema,
    new_cardinality: int,
    rng: Optional[torch.Generator] = None,
    opt_state: Optional[Sequence[Mapping[str, torch.Tensor]]] = None,
):
    """Grow to ``new_cardinality`` with xavier-normal rows for the new items
    (the reference's expansion recipe: keep the fitted rows, ``xavier_normal_``
    the rest). The reference draws the whole ``(new_cardinality + 1, E)``
    table and copies the fitted rows back, so the new rows' std is the whole
    table's, ``sqrt(2 / ((new_cardinality + 1) + E))``. The rows are drawn in
    f32 on the CPU from ``rng`` (a CPU ``torch.Generator``; default: seed 0),
    so a resize gives the same rows on every device."""
    feature_name = schema.item_id_feature_name
    if feature_name is None:
        msg = "Schema has no ITEM_ID feature."
        raise ValueError(msg)
    old_cardinality = schema[feature_name].cardinality
    if new_cardinality <= old_cardinality:
        msg = "New vocabulary size must be greater than already fitted"
        raise ValueError(msg)
    dim = _find_table_path(params, feature_name)[0][1].shape[1]
    std = float(np.sqrt(2.0 / ((new_cardinality + 1) + dim)))
    generator = rng if rng is not None else torch.Generator().manual_seed(0)
    fresh = torch.randn((new_cardinality - old_cardinality, dim), generator=generator, dtype=torch.float32) * std
    return resize_item_embeddings(params, schema, new_cardinality, fresh, opt_state=opt_state)


def get_item_embeddings(params: Params, schema: TensorSchema) -> torch.Tensor:
    """The fitted item rows ``[cardinality, E]``, padding row excluded."""
    feature_name = schema.item_id_feature_name
    if feature_name is None:
        msg = "Schema has no ITEM_ID feature."
        raise ValueError(msg)
    table = _find_table_path(params, feature_name)[0][1]
    return table.detach()[: schema[feature_name].cardinality]
