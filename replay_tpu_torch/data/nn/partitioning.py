"""Input-sharding seam: which rows of an epoch this replica reads.

Counterpart of ``replay_tpu/data/nn/partitioning.py``, with the same numpy
draws (``default_rng((seed, epoch))``), so an epoch's order is the JAX
package's, row for row. A replica is one data-loading process; every replica
reads a disjoint strided slice of the (padded, optionally shuffled) index
space, so the union covers each row once per epoch. ``ReplicasInfo.from_jax``
is not copied: the port's distributed training is ``ROADMAP.md`` queue 1,
item 9, and until then the layout is given by hand (one replica by default).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class ReplicasInfo:
    """Identity of one data-loading replica in the global layout."""

    num_replicas: int = 1
    replica_id: int = 0

    @property
    def curr_replica(self) -> int:
        return self.replica_id

    def __post_init__(self) -> None:
        if not 0 <= self.replica_id < self.num_replicas:
            msg = f"replica_id {self.replica_id} out of range [0, {self.num_replicas})"
            raise ValueError(msg)


@dataclass
class Partitioning:
    """Deterministic strided partition of ``n`` row indices for one replica.

    The index space is padded by wrap-around to a multiple of ``num_replicas``
    (every replica yields the same number of rows, so all take the same
    number of steps), optionally permuted with a seed that folds in the
    epoch, then strided ``replica_id::num_replicas``.
    """

    replicas: ReplicasInfo = None
    shuffle: bool = False
    seed: int = 0

    def __post_init__(self) -> None:
        if self.replicas is None:
            self.replicas = ReplicasInfo()

    def generate_raw_indices(self, n: int, epoch: int = 0) -> np.ndarray:
        """The padded (and optionally shuffled) global index order."""
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        num = self.replicas.num_replicas
        padded_len = -(-n // num) * num
        indices = np.arange(padded_len, dtype=np.int64) % n  # wrap-around padding
        if self.shuffle:
            rng = np.random.default_rng((self.seed, epoch))
            indices = indices[rng.permutation(padded_len)]
        return indices

    def replica_indices(self, raw_indices: np.ndarray) -> np.ndarray:
        """This replica's strided slice of a global order."""
        return raw_indices[self.replicas.replica_id :: self.replicas.num_replicas]

    def generate(self, n: int, epoch: int = 0) -> np.ndarray:
        return self.replica_indices(self.generate_raw_indices(n, epoch))

    def shard_items(self, n: int, epoch: int = 0, replica_id: Optional[int] = None) -> np.ndarray:
        """Round-robin share of ``n`` indivisible containers (parquet row
        groups) for one replica, with no wrap-around padding: the union over
        replicas covers every container once per epoch, and the shuffled
        order folds in ``epoch`` as :meth:`generate_raw_indices` does."""
        if n == 0:
            return np.zeros(0, dtype=np.int64)
        order = np.arange(n, dtype=np.int64)
        if self.shuffle:
            rng = np.random.default_rng((self.seed, epoch, 0x9E3779B9))
            order = order[rng.permutation(n)]
        replica = self.replicas.replica_id if replica_id is None else replica_id
        if not 0 <= replica < self.replicas.num_replicas:
            msg = f"replica_id {replica} out of range [0, {self.replicas.num_replicas})"
            raise ValueError(msg)
        return order[replica :: self.replicas.num_replicas]
