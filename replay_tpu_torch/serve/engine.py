"""Scoring engine: the fixed-shape programs behind the service.

Counterpart of ``replay_tpu/serve/engine.py::ScoringEngine``. Two program
families, both built at construction:

* **encode lanes** — one :class:`~replay_tpu_torch.nn.compiled.CompiledInference`
  per LENGTH bucket, each in ``dynamic_batch_size`` mode. A request is routed to
  the smallest length bucket holding its window; because the positional table is
  tail-anchored and padded keys get exact-zero attention weight, a narrow-bucket
  encode scores the same as the window right-aligned at full length.
* **hidden scorers** — per batch bucket, scoring CACHED last-position hidden
  states against the catalog (or the fixed slate): the pure-cache-hit lane,
  which skips the transformer.

``outputs="hidden"`` (retrieval mode) drops the catalog logits from the encode
programs. On the card every program is one CUDA graph per bucket, captured at
construction (:mod:`replay_tpu_torch.nn.graphs`); on the CPU the programs run
eagerly. Results stay on the device; each call synchronises with it, so that
a device fault surfaces inside the call and its accounting. :meth:`close`
frees the graphs and their memory.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from replay_tpu_torch.device import DeviceLike, resolve_device
from replay_tpu_torch.nn.graphs import CapturedProgram
from replay_tpu_torch.nn.compiled import (
    CompiledInference,
    Params,
    as_device_tensor,
    bind,
    pad_rows,
    params_mismatch,
    to_device_params,
)


def _smallest_covering(sorted_sizes: Sequence[int], n: int) -> int:
    for size in sorted_sizes:
        if size >= n:
            return size
    msg = f"{n} exceeds the largest compiled size {max(sorted_sizes)}"
    raise ValueError(msg)


class ScoringEngine:
    """Routes ``[n, L]`` windows / ``[n, E]`` cached states to fixed-shape buckets."""

    def __init__(
        self,
        model,
        params: Params,
        max_sequence_length: Optional[int] = None,
        length_buckets: Optional[Sequence[int]] = None,
        batch_buckets: Sequence[int] = (1, 8, 64),
        candidates: Optional[np.ndarray] = None,
        feature_name: str = "item_id",
        outputs: str = "both",
        device: DeviceLike = "cuda",
    ) -> None:
        self.device = resolve_device(device)
        if outputs not in ("both", "hidden"):
            msg = "ScoringEngine outputs must be 'both' or 'hidden'"
            raise ValueError(msg)
        self.params = to_device_params(params, self.device)
        self.max_sequence_length = int(
            max_sequence_length
            if max_sequence_length is not None
            else model.max_sequence_length
        )
        lengths = sorted(set(length_buckets or (self.max_sequence_length,)))
        if lengths[-1] != self.max_sequence_length:
            msg = (
                f"length_buckets must top out at max_sequence_length "
                f"{self.max_sequence_length}, got {lengths}"
            )
            raise ValueError(msg)
        self.length_buckets: Tuple[int, ...] = tuple(lengths)
        self.batch_buckets: Tuple[int, ...] = tuple(sorted(set(batch_buckets)))
        self.outputs = outputs
        self.candidates = (
            np.asarray(candidates, np.int32) if candidates is not None else None
        )
        if self.candidates is not None and outputs == "hidden":
            msg = "a fixed candidate slate needs scoring outputs; use outputs='both'"
            raise ValueError(msg)
        self._candidates_on_device = (
            as_device_tensor(self.candidates, torch.int32, self.device)
            if self.candidates is not None
            else None
        )
        self.embedding_dim = int(model.embedding_dim)

        candidates_count = len(self.candidates) if self.candidates is not None else None
        self._encoders: Dict[int, CompiledInference] = {
            length: CompiledInference.compile(
                model,
                self.params,
                max_sequence_length=length,
                mode="dynamic_batch_size",
                dynamic_buckets=self.batch_buckets,
                candidates_count=candidates_count,
                feature_name=feature_name,
                outputs=outputs,
                device=self.device,
            )
            for length in self.length_buckets
        }

        # hidden scorers (skipped in retrieval mode: cached states go straight
        # to the retrieval index, no catalog-wide product exists to build)
        self._hidden_scorer: Optional[Any] = None
        self._hidden_graphs: Optional[CapturedProgram] = None
        if outputs == "both":
            self._hidden_scorer = bind(
                model, lambda model, hidden, cands: model.get_logits(hidden, candidates_to_score=cands)
            )
            if self.device.type == "cuda":
                self._hidden_graphs = CapturedProgram(
                    dict.fromkeys(self.batch_buckets, self._hidden_scorer), self.device
                )
                for bucket in self.batch_buckets:
                    example = torch.zeros((bucket, self.embedding_dim), dtype=torch.float32, device=self.device)
                    self._hidden_graphs.prepare(bucket, self.params, (example, self._candidates_on_device))

        # accounting
        self.encode_calls = 0
        self.encode_rows = 0
        self.encode_slots = 0
        self.hit_calls = 0
        self.hit_rows = 0
        self.hit_slots = 0
        self.encode_failures = 0
        self.hit_failures = 0

    # -- routing ------------------------------------------------------------ #
    def route_length(self, length: int) -> int:
        """Smallest length bucket holding a ``length``-event window."""
        return _smallest_covering(self.length_buckets, max(int(length), 1))

    def batch_bucket(self, rows: int) -> int:
        return _smallest_covering(self.batch_buckets, rows)

    # -- hot swap ----------------------------------------------------------- #
    def validate_params(self, params: Params) -> Optional[str]:
        """Why ``params`` can NOT hot-swap into this engine's programs (key/
        shape/dtype mismatch — e.g. a grown item table), or ``None``."""
        return params_mismatch(self.params, params)

    def swap_params(self, params: Params) -> None:
        """Install a new same-shape parameter set into EVERY program —
        encoders and hidden scorers. Raises ``ValueError`` naming the
        offending leaf when the shapes changed; build a fresh engine for that."""
        mismatch = self.validate_params(params)
        if mismatch is not None:
            msg = (
                f"params cannot hot-swap into the serving executables: "
                f"{mismatch}. A changed catalog shape needs freshly compiled "
                "executables (a new ScoringEngine), not a swap."
            )
            raise ValueError(msg)
        self.params = to_device_params(params, self.device)
        for compiled in self._encoders.values():
            compiled.swap_params(self.params)

    def _synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- execution (serve-worker thread) ------------------------------------ #
    def encode(self, length_bucket: int, item_ids, padding_mask, params: Optional[Params] = None):
        """Run the length bucket's program on ``[n, L_bucket]`` windows.

        Returns ``(logits, hidden)`` in ``"both"`` mode (logits over the
        catalog or the fixed slate) or ``(None, hidden)`` in retrieval mode;
        both cut to the real row count, on the device. ``params`` overrides the
        bound parameter set for this call."""
        compiled = self._encoders[length_bucket]
        rows = item_ids.shape[0]
        try:
            out = compiled(
                item_ids, padding_mask, candidates=self._candidates_on_device, params=params
            )
            self._synchronize()
        except Exception:
            # failed calls are counted but not credited as served rows/slots
            self.encode_failures += 1
            raise
        self.encode_calls += 1
        self.encode_rows += rows
        self.encode_slots += self.batch_bucket(rows)
        if self.outputs == "both":
            return out
        return None, out

    def score_hidden(self, hidden, params: Optional[Params] = None):
        """Score cached ``[n, E]`` hidden states (the pure-hit lane), padded up
        to the nearest batch bucket; result on the device, cut to ``n``."""
        if self._hidden_scorer is None:
            msg = "retrieval-mode engine has no hidden scorer (use the pipeline)"
            raise ValueError(msg)
        hidden = as_device_tensor(hidden, torch.float32, self.device)
        rows = hidden.shape[0]
        bucket = self.batch_bucket(rows)
        params = self.params if params is None else params
        try:
            if self._hidden_graphs is not None:
                logits = self._hidden_graphs(
                    bucket, params, (pad_rows(hidden, bucket), self._candidates_on_device), rows=rows
                )
            else:
                logits = self._hidden_scorer(params, pad_rows(hidden, bucket), self._candidates_on_device)[:rows]
            self._synchronize()
        except Exception:
            self.hit_failures += 1
            raise
        self.hit_calls += 1
        self.hit_rows += rows
        self.hit_slots += bucket
        return logits

    def record_ranked_batch(self, rows: int, bucket: int) -> None:
        """Account a retrieval-mode pure-hit batch that bypassed the scorers."""
        self.hit_calls += 1
        self.hit_rows += rows
        self.hit_slots += bucket

    def graph_counts(self) -> Dict[str, Dict[str, int]]:
        """By lane (``encode``, ``hit``), on the card: the captured graphs,
        their replays, and the eager warm-up runs before the captures (each
        launches every kernel of its program once); zeros on the CPU."""
        lanes = {"encode": [e.graphs for e in self._encoders.values()], "hit": [self._hidden_graphs]}
        return {
            lane: {
                "graphs": sum(len(g.keys) for g in sets if g is not None),
                "replays": sum(g.replays for g in sets if g is not None),
                "warmups": sum(g.warmups for g in sets if g is not None),
            }
            for lane, sets in lanes.items()
        }

    def close(self) -> None:
        """Free every program's graphs and memory pools (a later call captures anew)."""
        for encoder in self._encoders.values():
            encoder.close()
        if self._hidden_graphs is not None:
            self._hidden_graphs.close()

    def stats(self) -> Dict[str, float]:
        slots = self.encode_slots + self.hit_slots
        rows = self.encode_rows + self.hit_rows
        return {
            "encode_calls": self.encode_calls,
            "encode_rows": self.encode_rows,
            "hit_calls": self.hit_calls,
            "hit_rows": self.hit_rows,
            "encode_failures": self.encode_failures,
            "hit_failures": self.hit_failures,
            "batch_fill_ratio": rows / slots if slots else 0.0,
        }
