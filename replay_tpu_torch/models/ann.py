"""MIPS retrieval on the device: the brute-force sweep (f32 or int8) and the IVF index.

Counterpart of ``replay_tpu/models/ann.py::MIPSIndex`` on one device:

* ``index="brute"``, ``precision="f32"`` — the exact ``[Q, E] × [E, I]``
  scores (one f32 product on the card) and a top-k.
* ``precision="int8"`` — the table per-row symmetrically quantized
  (``serve/quant.py``): int8 ``[I, E]`` rows and f32 ``[I]`` scales on the
  device, scores ``(q @ W_int8ᵀ.float()) * scale``. torch writes the f32
  up-cast of the whole table before each product (XLA fuses it into the
  product's read): ``I × E × 4`` bytes of scratch per search.
* ``index="ivf"`` with ``precision`` ∈ {``f32``, ``int8``, ``int8+pq``} —
  ``models/ivf.py``.

Every top-k keeps ``jax.lax.top_k``'s order: descending, and among equal
scores the lower item id first (:func:`top_k`). ``torch.topk`` alone gives no
order among ties on CUDA, and ties are real: a catalog can hold equal rows,
and a saturated re-rank maps many scores to exactly 1.0.

For an approximate index (int8 or IVF) the f32 master stays on the host
(``host_vectors``) and :meth:`MIPSIndex.exact_rescore` gathers the
candidates' rows from it: the device holds only the index. Not ported yet:
the mesh-sharded table (``mesh=``, ROADMAP.md queue 1 item 9, "Distributed
training"). ``search_hlo`` (an XLA artefact) has no counterpart;
``ANNMixin`` comes with the classical models that use it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from replay_tpu_torch.device import DeviceLike, resolve_device
from replay_tpu_torch.models.ivf import IVFConfig, build_ivf, default_nlist, ivf_bytes, make_search_fn

_LOW32 = 0xFFFFFFFF


def top_k(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: the ``k`` largest ``values`` in
    descending order, the lower index first among equal values.

    Each f32 value maps to an int32 key in the total order XLA sorts by
    (negative floats flip their magnitude bits, so -0.0 ranks below +0.0 and
    NaN above +inf), shifted up 32 bits above the complement of its index:
    every key is distinct, so ``torch.topk`` over them has one answer on any
    device. Returns ``(values, int64 indices)``."""
    if values.shape[-1] >= 2**31:
        msg = f"top_k supports fewer than 2**31 columns, got {values.shape[-1]}"
        raise ValueError(msg)
    scores = values.float()
    bits = scores.view(torch.int32).to(torch.int64)
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)
    index = torch.arange(scores.shape[-1], device=scores.device, dtype=torch.int64)
    keys = ordered * (1 << 32) + (_LOW32 - index)
    top = torch.topk(keys, k, dim=-1).values
    positions = _LOW32 - (top & _LOW32)
    return values.gather(-1, positions), positions


def _as_tensor(values, device: torch.device, dtype=None) -> torch.Tensor:
    if isinstance(values, torch.Tensor):
        return values.detach().to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(values), dtype=dtype, device=device)


class MIPSIndex:
    """Maximum-inner-product top-k over a catalog held on the device.

    :param item_vectors: ``[I, E]`` item table (host array or tensor). Its f32
        master copy stays on the host as ``host_vectors``, as in the JAX index.
    :param precision: ``"f32"`` or ``"int8"``; with ``index="ivf"`` also
        ``"int8+pq"``.
    :param index: ``"brute"`` (a sweep of the whole table) or ``"ivf"``
        (``nlist`` cells, ``nprobe`` probed a search; ``nlist=None`` takes
        ``models/ivf.py::default_nlist``).
    :param device: where the index lives and the search runs; ``"cuda"``
        unless the caller asks for the CPU.
    """

    def __init__(
        self,
        item_vectors,
        mesh=None,
        axis_name: str = "data",
        precision: str = "f32",
        index: str = "brute",
        nlist: Optional[int] = None,
        nprobe: int = 32,
        build_iters: int = 10,
        build_sample: int = 131072,
        pq_subspaces: int = 8,
        seed: int = 0,
        device: DeviceLike = "cuda",
    ) -> None:
        if index not in ("brute", "ivf"):
            msg = f"MIPSIndex index must be 'brute' or 'ivf', got {index!r}"
            raise ValueError(msg)
        if index == "ivf":
            if precision not in ("f32", "int8", "int8+pq"):
                msg = (
                    "MIPSIndex(index='ivf') precision must be 'f32', 'int8' or "
                    f"'int8+pq', got {precision!r}"
                )
                raise ValueError(msg)
        elif precision not in ("f32", "int8"):
            msg = f"MIPSIndex precision must be 'f32' or 'int8', got {precision!r}"
            raise ValueError(msg)
        if mesh is not None:
            msg = "MIPSIndex(mesh=...) is not ported yet: ROADMAP.md queue 1, 'Distributed training' (item 9)"
            raise NotImplementedError(msg)
        self._setup(item_vectors, precision, index, device)
        if index == "ivf":
            if nlist is None:
                nlist = default_nlist(self.num_items)
            config = IVFConfig(
                nlist=int(nlist),
                nprobe=int(nprobe),
                build_iters=int(build_iters),
                build_sample=int(build_sample),
                pq_subspaces=int(pq_subspaces),
                seed=int(seed),
            )
            self._set_ivf(build_ivf(self.host_vectors, precision, config, self.device))
        elif precision == "int8":
            from replay_tpu_torch.serve.quant import quantize_embeddings

            quantized = quantize_embeddings(self.host_vectors)
            self._set_int8(quantized.values, quantized.scales)
        else:
            self._set_f32()

    def _setup(self, item_vectors, precision: str, index: str, device: DeviceLike) -> None:
        self.device = resolve_device(device)
        if isinstance(item_vectors, torch.Tensor):
            item_vectors = item_vectors.detach().cpu().numpy()
        self.host_vectors = np.asarray(item_vectors)  # unpadded f32 master copy
        self.num_items, self.dim = self.host_vectors.shape
        self.precision = precision
        self.index_mode = index
        self._ivf = None
        self._search_cache = {}
        self.item_vectors = self.item_scales = None

    def _set_f32(self) -> None:
        self.item_vectors = torch.tensor(self.host_vectors, device=self.device)
        self._payload_nbytes = int(self.num_items * self.dim * self.host_vectors.dtype.itemsize)

    def _set_ivf(self, state) -> None:
        self._ivf = state
        self._payload_nbytes = self._ivf_bytes()["cell_bytes"]

    def _set_int8(self, values, scales) -> None:
        self.item_vectors = _as_tensor(values, self.device, torch.int8)  # int8 [I, E]
        self.item_scales = _as_tensor(scales, self.device, torch.float32)  # f32 [I]
        self._payload_nbytes = int(self.item_vectors.numel() + 4 * self.item_scales.numel())

    @classmethod
    def from_state(cls, item_vectors, precision: str, ivf=None, quantized=None, device: DeviceLike = "cuda"):
        """An index over ``item_vectors`` (the f32 master) from a state built
        elsewhere, with no build: ``ivf`` an
        :class:`~replay_tpu_torch.models.ivf.IVFState` (moved to ``device``),
        or ``quantized`` the ``(values, scales)`` of a brute int8 table.
        ``convert.py::mips_index_from_jax`` carries a JAX index across so."""
        index = cls.__new__(cls)
        index._setup(item_vectors, precision, "ivf" if ivf is not None else "brute", device)
        if ivf is not None:
            index._set_ivf(ivf.to(index.device))
        elif precision == "int8":
            index._set_int8(*quantized)
        else:
            index._set_f32()
        return index

    @property
    def ivf_state(self):
        """The IVF index's :class:`~replay_tpu_torch.models.ivf.IVFState`
        (None for the brute sweep)."""
        return self._ivf

    @property
    def is_approximate(self) -> bool:
        """True when the sweep only SELECTS candidates (IVF probing and/or a
        quantized table): the pipeline's cue to insert ``exact_rescore``
        before ranking. Only the brute f32 sweep scores exactly."""
        return self.index_mode == "ivf" or self.precision != "f32"

    def _ivf_bytes(self) -> dict:
        state = self._ivf
        return ivf_bytes(
            self.num_items,
            self.dim,
            state.config.nlist,
            self.precision,
            pq_subspaces=state.config.pq_subspaces,
            padded_fraction=state.padded_fraction,
        )

    def index_stats(self) -> dict:
        """Build and search geometry."""
        if self.index_mode != "ivf":
            return {"index": "brute", "num_items": self.num_items, "dim": self.dim}
        state = self._ivf
        return {
            "index": "ivf",
            "num_items": self.num_items,
            "dim": self.dim,
            "nlist": state.config.nlist,
            "nprobe": state.config.nprobe,
            "cmax": state.cmax,
            "padded_fraction": round(state.padded_fraction, 4),
            "scanned_fraction": round(state.config.nprobe * state.cmax / max(self.num_items, 1), 4),
            "n_shards": 1,
        }

    def table_bytes(self) -> dict:
        """Logical payload bytes of the device catalog (unpadded rows); IVF
        adds its breakdown (centroid, cell, codebook, scale and id bytes) by
        the formula that prices a projection."""
        f32_bytes = int(self.num_items * self.dim * 4)
        out = {
            "precision": self.precision,
            "payload_bytes": int(self._payload_nbytes),
            "f32_bytes": f32_bytes,
            "bytes_ratio": self._payload_nbytes / max(f32_bytes, 1),
        }
        if self.index_mode == "ivf":
            out.update(self._ivf_bytes())
            out["payload_bytes"] = out["total_bytes"]
            out["bytes_ratio"] = out["total_bytes"] / max(f32_bytes, 1)
        return out

    def table_shard_bytes(self) -> int:
        """Payload bytes of the device table (padded rows included), one shard:
        for IVF the cell payload (rows for f32/int8, uint8 codes for pq)."""
        if self.index_mode == "ivf":
            state = self._ivf
            if self.precision == "int8+pq":
                return state.storage_rows * state.config.pq_subspaces
            itemsize = 1 if self.precision == "int8" else 4
            return state.storage_rows * self.dim * itemsize
        itemsize = 1 if self.precision == "int8" else 4
        return int(self.item_vectors.shape[0]) * self.dim * itemsize

    def _queries(self, query_vectors) -> torch.Tensor:
        return _as_tensor(query_vectors, self.device, torch.float32)

    def exact_rescore(self, query_vectors, candidate_ids) -> torch.Tensor:
        """Full-precision scores of already-retrieved candidates: ``[Q, E]``
        queries × ``[Q, C]`` candidate ids → ``[Q, C]`` f32 inner products,
        on the device. An approximate index gathers the candidates' rows from
        the host f32 master (``C × E × 4`` bytes a query), as the JAX index
        does; the brute f32 index from its device table, which holds the same
        values."""
        queries = self._queries(query_vectors)
        if self.is_approximate:
            ids = candidate_ids.cpu().numpy() if isinstance(candidate_ids, torch.Tensor) else np.asarray(candidate_ids)
            rows = _as_tensor(self.host_vectors[ids], self.device, torch.float32)  # [Q, C, E]
        else:
            rows = self.item_vectors[_as_tensor(candidate_ids, self.device, torch.long)].float()
        return torch.einsum("qe,qce->qc", queries, rows)

    def _search_fn(self, k: int):
        if k not in self._search_cache:
            if self.index_mode == "ivf":
                search = make_search_fn(self._ivf, k)
            elif self.precision == "int8":

                def search(queries):
                    # the f32 up-cast of the whole int8 table is written here
                    scores = (queries @ self.item_vectors.T.to(queries.dtype)) * self.item_scales[None, :]
                    return top_k(scores, k)

            else:

                def search(queries):
                    return top_k(queries @ self.item_vectors.T, k)

            self._search_cache[k] = search
        return self._search_cache[k]

    def search_jax(self, query_vectors, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scores [Q, k], int64 item ids [Q, k]) as tensors on the device — the
        fused serving path's stage, no host round trip. The JAX name is kept:
        it is the device search of the reference."""
        if k > self.num_items:
            msg = f"k={k} exceeds the catalog size {self.num_items}"
            raise ValueError(msg)
        return self._search_fn(k)(self._queries(query_vectors))

    def search(self, query_vectors, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(scores [Q, k], int32 item ids [Q, k]) host arrays of the highest
        inner products."""
        values, indices = self.search_jax(query_vectors, k)
        return values.cpu().numpy(), indices.to(torch.int32).cpu().numpy()
