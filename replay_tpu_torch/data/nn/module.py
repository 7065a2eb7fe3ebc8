"""Per-split data wiring: sources, metadata and transform pipelines in one object.

Counterpart of ``replay_tpu/data/nn/module.py``: a plain factory whose
``batches(split, epoch)`` yields transformed fixed-shape batches from a
:class:`~replay_tpu_torch.data.nn.parquet.ParquetBatcher` per split, ready for
``Trainer.fit``/``validate``/``predict_top_k``
(``fit(module.train_batches, ...)`` plugs straight in).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch

from replay_tpu_torch.data.nn.parquet import ParquetBatcher
from replay_tpu_torch.data.nn.partitioning import Partitioning

SPLITS = ("train", "validate", "test", "predict")


def epoch_generator(seed: int, epoch: int) -> torch.Generator:
    """A CPU generator seeded from ``(seed, epoch)`` (numpy's ``SeedSequence``
    mixes the pair): the same pair always gives the same draws."""
    mixed = np.random.SeedSequence((int(seed), int(epoch))).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(mixed) & (2**63 - 1))


@dataclass
class DataModule:
    """Everything the trainer needs to pull batches for every split.

    :param sources: split → parquet file or dataset path (any subset of
        train/validate/test/predict; several validation streams as
        ``validate``, ``validate_2``, … — each key is its own stream).
    :param metadata: list-column spec ``{column: {"shape": L, "padding": v}}``
        shared by all splits.
    :param transforms: split → transform pipeline (defaults to identity).

    A pipeline with stochastic transforms (``needs_rng``) gets one
    ``torch.Generator`` per epoch, seeded from ``(seed, epoch)``, which
    :class:`~replay_tpu_torch.nn.transform.transforms.Compose` draws from
    batch after batch: the masks repeat for the same seed and epoch. The JAX
    module folds the epoch into a ``jax.random`` key instead, so its masks
    cannot equal these; deterministic pipelines give the JAX batches.
    """

    sources: Dict[str, str]
    batch_size: int
    metadata: Dict[str, Dict[str, int]] = field(default_factory=dict)
    transforms: Dict[str, Sequence] = field(default_factory=dict)
    partition_size: int = 1 << 20
    shuffle_train: bool = True
    seed: int = 0
    partitioning: Optional[Partitioning] = None

    def __post_init__(self) -> None:
        from replay_tpu_torch.nn.transform.transforms import Compose

        self._pipelines = {split: Compose(list(pipeline)) for split, pipeline in self.transforms.items()}

    def _batcher(self, split: str, epoch: int) -> ParquetBatcher:
        if split not in self.sources:
            msg = f"No source configured for split '{split}' (have {sorted(self.sources)})"
            raise KeyError(msg)
        batcher = ParquetBatcher(
            self.sources[split],
            batch_size=self.batch_size,
            metadata=self.metadata,
            partition_size=self.partition_size,
            shuffle=self.shuffle_train and split == "train",
            seed=self.seed,
            partitioning=self.partitioning,
        )
        batcher.set_epoch(epoch)
        return batcher

    def batches(self, split: str, epoch: int = 0) -> Iterator[dict]:
        """Transformed fixed-shape batches of one split."""
        pipeline = self._pipelines.get(split) or self._pipelines.get(
            split.split("_")[0]  # validate_2 falls back to the validate pipeline
        )
        generator = epoch_generator(self.seed, epoch) if pipeline is not None and pipeline.needs_rng else None
        for batch in self._batcher(split, epoch):
            if pipeline is None:
                yield batch
            elif generator is not None:
                yield pipeline(batch, generator)
            else:
                yield pipeline(batch)

    # Trainer-shaped entry points -------------------------------------------- #
    def train_batches(self, epoch: int = 0) -> Iterator[dict]:
        return self.batches("train", epoch)

    def val_batches(self) -> Iterator[dict]:
        return self.batches("validate")

    def test_batches(self) -> Iterator[dict]:
        return self.batches("test")

    def predict_batches(self) -> Iterator[dict]:
        return self.batches("predict")
