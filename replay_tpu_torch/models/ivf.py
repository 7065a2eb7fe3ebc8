"""Device-resident IVF: sub-linear MIPS retrieval for catalogs past a sweep.

Counterpart of ``replay_tpu/models/ivf.py`` (single device). A clustered
inverted-file index whose search has one shape per ``(Q, k)``:

Build (deterministic, seeded; every stage's seconds in
``IVFState.build_seconds``):
  * k-means over a host-sampled subset of the table on the device, in chunks
    of ``_ASSIGN_CHUNK`` rows, a fixed iteration count, L2 assignment by
    ``argmax(x·c − |c|²/2)``; empty cells keep their centroid. Cluster sums
    are one product of a one-hot ``[nlist, chunk]`` matrix with the chunk —
    a fixed summation order, where ``index_add_`` on CUDA adds floats by
    atomics in whatever order they land. Same seed → bitwise-same index.
  * the whole table assigned to its top-2 cells on the device (chunked), then
    a host spill pass that moves rows beyond ``cell_cap_factor × mean`` to
    their runner-up cell (vectorised: each pass's cells are independent, so
    the JAX loop over overflowing cells and this one give the same cells).
  * cells padded to a bucket ladder of widths (multiples of 8, ~1.25× steps)
    in one flat ``[S, E]`` cell-major storage with per-cell ``starts`` /
    ``lengths`` and ``storage_ids`` (−1 on padding) plus a CMAX tail guard,
    so every probe reads the same ``[CMAX]`` row window. The layout is
    computed on the host from the cells; the rows are gathered on the device.

Search: centroid scan ``q @ centroidsᵀ`` → top-``nprobe`` cells → per probe
one fixed-width gather of CMAX rows and their scores (padded rows masked to
−inf by the true cell length) → ``[Q, nprobe·CMAX]`` → one final top-k. Both
top-k cuts keep ``jax.lax.top_k``'s order (``models/ann.py::top_k``). Scores
select candidates; the serving pipeline re-scores them at f32
(``MIPSIndex.exact_rescore``).

Precision rungs: ``f32`` (raw rows), ``int8`` (per-row symmetric int8 +
f32 scales, ``serve/quant.py``), ``int8+pq`` (``pq_subspaces`` uint8 codes
a row against per-subspace 256-entry f32 codebooks trained on residuals
``x − c(x)``; a score is ``q·c(x) + Σ_m LUT_m[code_m]``).

Products run in f32; with TF32 enabled for matmuls
(``torch.backends.cuda.matmul.allow_tf32``) the probed set drifts from the
reference's. The mesh-sharded layout waits for ROADMAP.md queue 1 item 9.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

_ASSIGN_CHUNK = 8192
_PQ_ENTRIES = 256


def default_nlist(num_items: int, n_shards: int = 1) -> int:
    """Power-of-two cell count ≈ 2·√I, clamped to [n_shards·8, I // 4]."""
    target = max(8 * n_shards, int(2 * np.sqrt(max(num_items, 1))))
    nlist = 1 << int(np.ceil(np.log2(target)))
    upper = max(8 * n_shards, num_items // 4)
    while nlist > upper and nlist > 8 * n_shards:
        nlist //= 2
    return int(nlist)


def ladder_width(n: int) -> int:
    """Smallest bucket-ladder width ≥ n: multiples of 8 growing ~1.25×."""
    if n <= 0:
        return 0
    w = 8
    while w < n:
        w = max(w + 8, int(w * 1.25) // 8 * 8)
    return w


@dataclasses.dataclass(frozen=True)
class IVFConfig:
    nlist: int
    nprobe: int = 32
    build_iters: int = 10
    build_sample: int = 131072
    pq_subspaces: int = 8
    cell_cap_factor: float = 1.6
    seed: int = 0


@dataclasses.dataclass
class IVFState:
    """The index's tensors, all on one device, and its build stats."""

    config: IVFConfig
    precision: str
    num_items: int
    dim: int
    centroids: torch.Tensor  # [nlist, E] f32
    storage: Optional[torch.Tensor]  # [S, E] f32|int8 cell-major rows (None for pq)
    row_scales: Optional[torch.Tensor]  # [S] f32 (int8 rung only)
    codes: Optional[torch.Tensor]  # [S, M] uint8 (pq rung only)
    codebooks: Optional[torch.Tensor]  # [M, 256, E/M] f32 (pq rung only)
    storage_ids: torch.Tensor  # [S] int32 item ids, -1 on padding
    starts: torch.Tensor  # [nlist] int32
    lengths: torch.Tensor  # [nlist] int32 true cell sizes
    cmax: int  # widest ladder width = the static gather shape
    storage_rows: int  # S
    padded_fraction: float
    build_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

    _TENSORS = ("centroids", "storage", "row_scales", "codes", "codebooks", "storage_ids", "starts", "lengths")

    @property
    def device(self) -> torch.device:
        return self.centroids.device

    def to(self, device) -> "IVFState":
        """The same state with every tensor copied to ``device``."""
        moved = {
            name: None if getattr(self, name) is None else getattr(self, name).to(device) for name in self._TENSORS
        }
        return dataclasses.replace(self, **moved)

    def tensors(self) -> Dict[str, torch.Tensor]:
        """The state's tensors by name (those the rung has)."""
        return {name: getattr(self, name) for name in self._TENSORS if getattr(self, name) is not None}


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def _cell_sums(block: torch.Tensor, cells: torch.Tensor, count: int) -> torch.Tensor:
    """``[count, E]`` sums of ``block``'s rows by cell, in a fixed order: a
    one-hot ``[count, rows]`` matrix times the block."""
    onehot = torch.zeros(count, block.shape[0], dtype=block.dtype, device=block.device)
    onehot[cells, torch.arange(block.shape[0], device=block.device)] = 1.0
    return onehot @ block


def _kmeans_centroids(sample: np.ndarray, nlist: int, iters: int, seed: int, device) -> torch.Tensor:
    """Fixed-iteration chunked k-means on the device; ``[nlist, E]`` f32.
    Rows past the last whole chunk take no part, as in the reference."""
    rows = sample.shape[0]
    chunk = min(_ASSIGN_CHUNK, rows)
    rows_eff = (rows // chunk) * chunk
    rng = np.random.default_rng(seed)
    init = sample[rng.choice(rows, nlist, replace=False)]
    blocks = torch.as_tensor(sample[:rows_eff], device=device).split(chunk)
    cent = torch.as_tensor(init, device=device)
    for _ in range(iters):
        halfsq = 0.5 * torch.sum(cent * cent, dim=1)
        sums = torch.zeros_like(cent)
        counts = torch.zeros(nlist, dtype=torch.float32, device=device)
        for block in blocks:
            assigned = torch.argmax(block @ cent.T - halfsq[None, :], dim=1)
            sums += _cell_sums(block, assigned, nlist)
            counts += torch.bincount(assigned, minlength=nlist).float()
        # empty cells keep their previous centroid (deterministic, no resample)
        cent = torch.where(counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], cent)
    return cent


def _assign_top2(table: torch.Tensor, centroids: torch.Tensor) -> np.ndarray:
    """``[I, 2]`` best and runner-up cell per row (L2), chunked on the
    table's device. Two argmaxes, each the lowest index among equal
    scores: ``jax.lax.top_k(·, 2)``'s order."""
    halfsq = 0.5 * torch.sum(centroids * centroids, dim=1)
    out = torch.empty(table.shape[0], 2, dtype=torch.int64, device=table.device)
    for start in range(0, table.shape[0], _ASSIGN_CHUNK):
        scores = table[start : start + _ASSIGN_CHUNK] @ centroids.T - halfsq[None, :]
        best = torch.argmax(scores, dim=1)
        out[start : start + _ASSIGN_CHUNK, 0] = best
        scores.scatter_(1, best[:, None], -torch.inf)
        out[start : start + _ASSIGN_CHUNK, 1] = torch.argmax(scores, dim=1)
    return out.cpu().numpy()


def _spill_overflow(top2: np.ndarray, nlist: int, cap: int) -> np.ndarray:
    """Deterministic spill passes: rows beyond ``cap`` in their best cell
    (the last ones in row order) move to their runner-up. Only rows still in
    their top-1 cell can move, so the loop terminates.

    Within a pass the overflowing cells are independent: a row moves only out
    of its top-1 cell, and rows moving into a cell are not movable there, so
    every overflowing cell's movable rows and excess are those at the start of
    the pass. The reference visits the cells one by one; this moves them all
    at once, to the same cells."""
    cells = top2[:, 0].copy()
    for _ in range(4):
        counts = np.bincount(cells, minlength=nlist)
        over = counts > cap
        if not over.any():
            break
        movable = np.nonzero(over[cells] & (cells == top2[:, 0]))[0]  # row order
        cell_of = cells[movable]
        grouped = movable[np.argsort(cell_of, kind="stable")]
        group_cells = cells[grouped]
        ends = np.cumsum(np.bincount(group_cells, minlength=nlist))
        from_end = ends[group_cells] - 1 - np.arange(len(grouped))  # 0 = the last movable row of its cell
        spill = grouped[from_end < (counts - cap)[group_cells]]
        if not len(spill):
            break
        cells[spill] = top2[spill, 1]
    return cells


def _train_pq(residuals: np.ndarray, subspaces: int, iters: int, seed: int, device) -> torch.Tensor:
    """Per-subspace 256-entry codebooks over residual rows → ``[M, 256, E/M]``
    (full-batch k-means per subspace; the sums by the one-hot product, in
    chunks)."""
    rows, dim = residuals.shape
    if rows < _PQ_ENTRIES:
        msg = f"int8+pq needs >= 256 training rows, got {rows}"
        raise ValueError(msg)
    sub = dim // subspaces
    parts = residuals.reshape(rows, subspaces, sub).transpose(1, 0, 2)  # [M, T, sub]
    rng = np.random.default_rng(seed + 1)
    init = parts[:, rng.choice(rows, _PQ_ENTRIES, replace=False), :]  # [M, 256, sub]
    xs = torch.as_tensor(np.ascontiguousarray(parts), device=device)
    cent = torch.as_tensor(np.ascontiguousarray(init), device=device)
    entries = torch.arange(_PQ_ENTRIES, device=device)
    for _ in range(iters):
        halfsq = 0.5 * torch.sum(cent * cent, dim=2)  # [M, 256]
        sums = torch.zeros_like(cent)
        counts = torch.zeros(subspaces, _PQ_ENTRIES, dtype=torch.float32, device=device)
        for block in xs.split(_ASSIGN_CHUNK, dim=1):  # [M, c, sub]
            assigned = torch.argmax(block @ cent.transpose(1, 2) - halfsq[:, None, :], dim=2)  # [M, c]
            onehot = (assigned[:, None, :] == entries[None, :, None]).float()  # [M, 256, c]
            sums += onehot @ block
            counts += onehot.sum(dim=2)
        cent = torch.where(counts[:, :, None] > 0, sums / torch.clamp(counts, min=1.0)[:, :, None], cent)
    return cent


def _encode_pq(residuals: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """uint8 codes ``[R, M]``: the nearest codebook entry per subspace, chunked."""
    subspaces = int(codebooks.shape[0])
    sub = residuals.shape[1] // subspaces
    halfsq = 0.5 * torch.sum(codebooks * codebooks, dim=2)  # [M, 256]
    out = torch.empty(residuals.shape[0], subspaces, dtype=torch.uint8, device=residuals.device)
    for start in range(0, residuals.shape[0], _ASSIGN_CHUNK):
        parts = residuals[start : start + _ASSIGN_CHUNK].reshape(-1, subspaces, sub)
        scores = torch.einsum("cms,mks->cmk", parts, codebooks) - halfsq[None, :, :]
        out[start : start + _ASSIGN_CHUNK] = torch.argmax(scores, dim=2).to(torch.uint8)
    return out


def _layout(cells: np.ndarray, nlist: int):
    """The cell-major layout on the bucket ladder: per-cell ``starts`` and
    widths, ``storage_ids`` (−1 on padding), CMAX, the row count with the
    tail guard, and each storage row's cell (tail-guard rows: cell 0)."""
    num_items = len(cells)
    counts = np.bincount(cells, minlength=nlist)
    order = np.argsort(cells, kind="stable")  # by cell, rows in row order
    sizes, inverse = np.unique(counts, return_inverse=True)
    widths = np.array([ladder_width(int(c)) for c in sizes], np.int64)[inverse]
    cmax = int(widths.max())
    storage_rows = int(widths.sum()) + cmax  # CMAX tail guard
    starts = np.concatenate([[0], np.cumsum(widths)[:-1]]).astype(np.int64)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    positions = np.repeat(starts, counts) + np.arange(num_items) - np.repeat(first, counts)
    storage_ids = np.full(storage_rows, -1, np.int32)
    storage_ids[positions] = order
    cell_ids = np.zeros(storage_rows, np.int64)
    cell_ids[: int(widths.sum())] = np.repeat(np.arange(nlist), widths)
    return counts, starts.astype(np.int32), storage_ids, cmax, storage_rows, cell_ids


class _Stages:
    """Seconds per build stage; each stage ends with the device idle."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.seconds: Dict[str, float] = {}
        self._last = time.perf_counter()

    def done(self, name: str) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.seconds[name] = now - self._last
        self._last = now


def build_ivf(host_vectors: np.ndarray, precision: str, config: IVFConfig, device) -> IVFState:
    """Train and lay out the index on ``device``. Deterministic: the same
    inputs and seed give bitwise the same centroids, layout and codes."""
    device = torch.device(device)
    num_items, dim = host_vectors.shape
    nlist, nprobe = config.nlist, config.nprobe
    if not 0 < nlist <= num_items:
        msg = f"ivf nlist={nlist} must be in [1, num_items={num_items}]"
        raise ValueError(msg)
    if not 0 < nprobe <= nlist:
        msg = f"ivf nprobe={nprobe} must be in [1, nlist={nlist}]"
        raise ValueError(msg)
    if precision == "int8+pq" and dim % config.pq_subspaces != 0:
        msg = f"pq_subspaces={config.pq_subspaces} must divide dim={dim}"
        raise ValueError(msg)

    stages = _Stages(device)
    table = np.asarray(host_vectors, np.float32)
    rng = np.random.default_rng(config.seed)
    sample_rows = min(config.build_sample, num_items)
    sample = table[rng.choice(num_items, sample_rows, replace=False)]
    stages.done("sample")
    centroids = _kmeans_centroids(sample, nlist, config.build_iters, config.seed, device)
    stages.done("kmeans")
    table_dev = torch.as_tensor(table, device=device)
    stages.done("upload")
    top2 = _assign_top2(table_dev, centroids)
    stages.done("assign")
    cap = max(1, int(np.ceil(config.cell_cap_factor * num_items / nlist)))
    cells = _spill_overflow(top2, nlist, cap)
    stages.done("spill")

    codebooks = None
    cent_np = centroids.cpu().numpy()
    if precision == "int8+pq":
        # residuals of a fresh sample against their assigned centroid
        sample_idx = rng.choice(num_items, sample_rows, replace=False)
        residual_sample = table[sample_idx] - cent_np[cells[sample_idx]]
        codebooks = _train_pq(residual_sample, config.pq_subspaces, config.build_iters, config.seed, device)
        stages.done("pq_train")

    counts, starts, storage_ids, cmax, storage_rows, cell_ids = _layout(cells, nlist)
    padded_fraction = float(1.0 - num_items / max(storage_rows, 1))
    stages.done("layout")

    sids = torch.as_tensor(storage_ids, device=device)
    padding = (sids < 0)[:, None]
    rows = table_dev[sids.clamp(min=0).long()].masked_fill_(padding, 0.0)  # [S, E]
    del table_dev
    storage = row_scales = codes = None
    if precision == "int8+pq":
        residual_rows = (rows - centroids[torch.as_tensor(cell_ids, device=device)]).masked_fill_(padding, 0.0)
        del rows
        codes = _encode_pq(residual_rows, codebooks)
    elif precision == "int8":
        from replay_tpu_torch.serve.quant import quantize_embeddings

        quantized = quantize_embeddings(rows.cpu().numpy())
        del rows
        storage = torch.as_tensor(quantized.values, device=device)
        row_scales = torch.as_tensor(quantized.scales, device=device)
    else:
        storage = rows
    stages.done("storage")

    return IVFState(
        config=config,
        precision=precision,
        num_items=num_items,
        dim=dim,
        centroids=centroids,
        storage=storage,
        row_scales=row_scales,
        codes=codes,
        codebooks=codebooks,
        storage_ids=sids,
        starts=torch.as_tensor(starts, device=device),
        lengths=torch.as_tensor(counts.astype(np.int32), device=device),
        cmax=cmax,
        storage_rows=storage_rows,
        padded_fraction=padded_fraction,
        build_seconds=stages.seconds,
    )


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def _probe_scores(
    state: IVFState, queries: torch.Tensor, cscores: torch.Tensor, probes: torch.Tensor, lut: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``[Q, nprobe·CMAX]`` scores and the ``[Q, nprobe]`` start rows: one
    fixed-width gather of CMAX rows per probe, padded rows at −inf."""
    offsets = torch.arange(state.cmax, device=queries.device)
    starts = state.starts.long()
    lengths = state.lengths.long()
    scores, sts = [], []
    for p in range(probes.shape[1]):
        cell = probes[:, p]  # [Q]
        st = starts[cell]
        window = st[:, None] + offsets[None, :]  # [Q, CMAX]
        if state.codes is not None:
            block = state.codes[window].long()  # [Q, CMAX, M]
            subspaces = block.shape[2]
            entries = torch.arange(subspaces, device=queries.device) * _PQ_ENTRIES
            flat = lut.reshape(lut.shape[0], -1)  # [Q, M·256]
            picked = flat.gather(1, (block + entries).reshape(block.shape[0], -1)).reshape(block.shape)
            score = cscores.gather(1, cell[:, None]) + torch.sum(picked, dim=-1)  # q·c + Σ_m LUT
        else:
            rows = state.storage[window]  # [Q, CMAX, E]
            if state.row_scales is not None:
                score = torch.einsum("qe,qce->qc", queries, rows.to(queries.dtype)) * state.row_scales[window]
            else:
                score = torch.einsum("qe,qce->qc", queries, rows)
        valid = offsets[None, :] < lengths[cell][:, None]
        scores.append(torch.where(valid, score, -torch.inf))
        sts.append(st)
    return torch.stack(scores, dim=1).reshape(queries.shape[0], -1), torch.stack(sts, dim=1)


def _resolve_ids(storage_ids: torch.Tensor, sts: torch.Tensor, positions: torch.Tensor, cmax: int) -> torch.Tensor:
    """Flat top-k positions → (probe, offset) → storage row → item id."""
    start = sts.gather(1, positions // cmax)
    return storage_ids[start + positions % cmax].long()


def _query_lut(state: IVFState, queries: torch.Tensor) -> torch.Tensor:
    """``[Q, M, 256]`` additive LUT: ``q_m ·`` codebook ``m``'s entries."""
    subspaces = int(state.codebooks.shape[0])
    parts = queries.reshape(queries.shape[0], subspaces, state.dim // subspaces)
    return torch.einsum("qms,mks->qmk", parts, state.codebooks)


def make_search_fn(state: IVFState, k: int) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """The fixed-``nprobe`` search for ``[Q, E]`` f32 query batches on the
    state's device: (scores ``[Q, k]``, int64 item ids ``[Q, k]``)."""
    from replay_tpu_torch.models.ann import top_k

    nprobe = state.config.nprobe
    if k > nprobe * state.cmax:
        msg = (
            f"k={k} exceeds the probed candidate pool "
            f"(nprobe={nprobe} x cmax={state.cmax}); raise nprobe"
        )
        raise ValueError(msg)

    def search(queries: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cscores = queries @ state.centroids.T  # [Q, nlist]
        _, probes = top_k(cscores, nprobe)
        lut = _query_lut(state, queries) if state.codes is not None else None
        scores, sts = _probe_scores(state, queries, cscores, probes, lut)
        values, positions = top_k(scores, k)
        return values, _resolve_ids(state.storage_ids, sts, positions, state.cmax)

    return search


# ---------------------------------------------------------------------------
# byte accounting (the built index and the projection share one formula)
# ---------------------------------------------------------------------------


def ivf_bytes(
    num_items: int,
    dim: int,
    nlist: int,
    precision: str,
    pq_subspaces: int = 8,
    padded_fraction: float = 0.10,
) -> dict:
    """Byte breakdown of an IVF index, for a built index and for a projection."""
    rows = int(round(num_items / max(1.0 - padded_fraction, 1e-6)))
    if precision == "int8+pq":
        cell_bytes = rows * pq_subspaces
        codebook_bytes = pq_subspaces * 256 * (dim // pq_subspaces) * 4
        scale_bytes = 0
    elif precision == "int8":
        cell_bytes = rows * dim
        codebook_bytes = 0
        scale_bytes = rows * 4
    else:
        cell_bytes = rows * dim * 4
        codebook_bytes = 0
        scale_bytes = 0
    centroid_bytes = nlist * dim * 4
    id_bytes = rows * 4
    total = cell_bytes + centroid_bytes + codebook_bytes + scale_bytes + id_bytes
    return {
        "precision": precision,
        "cell_bytes": int(cell_bytes),
        "centroid_bytes": int(centroid_bytes),
        "codebook_bytes": int(codebook_bytes),
        "scale_bytes": int(scale_bytes),
        "id_bytes": int(id_bytes),
        "total_bytes": int(total),
    }


def brute_bytes(num_items: int, dim: int, precision: str) -> dict:
    """Byte cost of the exact sweep's device table at the same rung."""
    itemsize = 1 if precision.startswith("int8") else 4
    payload = num_items * dim * itemsize
    scale_bytes = num_items * 4 if precision.startswith("int8") else 0
    return {
        "precision": precision,
        "table_bytes": int(payload),
        "scale_bytes": int(scale_bytes),
        "total_bytes": int(payload + scale_bytes),
    }
