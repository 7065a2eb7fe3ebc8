"""Exact MIPS retrieval: the brute-force f32 scan over the item table.

Counterpart of ``replay_tpu/models/ann.py::MIPSIndex`` (brute force, f32). The
``[Q, E] × [E, I]`` scores are one product on the card (cuBLAS, f32) followed
by a top-k whose order is ``jax.lax.top_k``'s: descending, and among equal
scores the lower item id first (:func:`top_k`). ``torch.topk`` alone gives no
order among ties on CUDA, and ties are real: a catalog can hold equal rows,
and a saturated re-rank maps many scores to exactly 1.0.

Not ported yet, each raising ``NotImplementedError`` that names its ROADMAP.md
item: the int8 table (``precision="int8"``) and the IVF index
(``index="ivf"``) — queue 1, "Retrieval"; the mesh-sharded table (``mesh=``) —
queue 1, "Distributed training". ``search_hlo`` (an XLA artefact) has no
counterpart; ``index_stats`` and ``table_shard_bytes`` come with IVF and the
mesh, ``ANNMixin`` with the classical models that use it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from replay_tpu_torch.device import DeviceLike, resolve_device

_LOW32 = 0xFFFFFFFF
_RETRIEVAL = "ROADMAP.md queue 1, 'Retrieval'"


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


class MIPSIndex:
    """Exact maximum-inner-product top-k over a catalog held on the device.

    :param item_vectors: ``[I, E]`` item table (host array or tensor). Its f32
        master copy stays on the host as ``host_vectors``, as in the JAX index.
    :param device: where the table lives and the scan runs; ``"cuda"`` unless
        the caller asks for the CPU.
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
            msg = f"MIPSIndex(index='ivf') is not ported yet: {_RETRIEVAL} (IVF)"
            raise NotImplementedError(msg)
        if precision not in ("f32", "int8"):
            msg = f"MIPSIndex precision must be 'f32' or 'int8', got {precision!r}"
            raise ValueError(msg)
        if precision == "int8":
            msg = f"MIPSIndex(precision='int8') is not ported yet: {_RETRIEVAL} (int8, serve/quant.py)"
            raise NotImplementedError(msg)
        if mesh is not None:
            msg = "MIPSIndex(mesh=...) is not ported yet: ROADMAP.md queue 1, 'Distributed training'"
            raise NotImplementedError(msg)
        self.device = resolve_device(device)
        if isinstance(item_vectors, torch.Tensor):
            item_vectors = item_vectors.detach().cpu().numpy()
        self.host_vectors = np.asarray(item_vectors)  # unpadded f32 master copy
        self.num_items, self.dim = self.host_vectors.shape
        self.precision = precision
        self.index_mode = index
        self.item_vectors = torch.tensor(self.host_vectors, device=self.device)
        self._payload_nbytes = int(self.num_items * self.dim * self.host_vectors.dtype.itemsize)

    @property
    def is_approximate(self) -> bool:
        """True when the sweep only SELECTS candidates (IVF probing and/or a
        quantized table); only the brute f32 sweep, the one ported, scores
        exactly."""
        return self.index_mode == "ivf" or self.precision != "f32"

    def table_bytes(self) -> dict:
        """Logical payload bytes of the device catalog."""
        f32_bytes = int(self.num_items * self.dim * 4)
        return {
            "precision": self.precision,
            "payload_bytes": int(self._payload_nbytes),
            "f32_bytes": f32_bytes,
            "bytes_ratio": self._payload_nbytes / max(f32_bytes, 1),
        }

    def _queries(self, query_vectors) -> torch.Tensor:
        if isinstance(query_vectors, torch.Tensor):
            return query_vectors.detach().to(device=self.device, dtype=torch.float32)
        return torch.as_tensor(np.asarray(query_vectors), dtype=torch.float32, device=self.device)

    def exact_rescore(self, query_vectors, candidate_ids) -> torch.Tensor:
        """Full-precision scores of already-retrieved candidates: ``[Q, E]``
        queries × ``[Q, C]`` candidate ids → ``[Q, C]`` f32 inner products
        against the table's rows, on the device."""
        queries = self._queries(query_vectors)
        ids = candidate_ids if isinstance(candidate_ids, torch.Tensor) else torch.as_tensor(np.asarray(candidate_ids))
        ids = ids.to(device=self.device, dtype=torch.long)
        rows = self.item_vectors[ids].float()  # [Q, C, E]
        return torch.einsum("qe,qce->qc", queries, rows)

    def search_jax(self, query_vectors, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(scores [Q, k], int64 item ids [Q, k]) as tensors on the device — the
        fused serving path's stage, no host round trip. The JAX name is kept:
        it is the device search of the reference."""
        if k > self.num_items:
            msg = f"k={k} exceeds the catalog size {self.num_items}"
            raise ValueError(msg)
        scores = self._queries(query_vectors) @ self.item_vectors.T
        return top_k(scores, k)

    def search(self, query_vectors, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """(scores [Q, k], int32 item ids [Q, k]) host arrays of the highest
        inner products."""
        values, indices = self.search_jax(query_vectors, k)
        return values.cpu().numpy(), indices.to(torch.int32).cpu().numpy()
