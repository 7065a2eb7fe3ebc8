"""Fused candidate→rank: MIPS retrieval + re-rank + top-k on the device.

Counterpart of ``replay_tpu/serve/pipeline.py::CandidatePipeline``. Instead of
materializing a ``[B, |catalog|]`` score matrix per micro-batch, the encoder's
last-hidden states query the MIPS index (``models/ann.py``) for the top-C
candidates, a re-rank applies the two-stage scenario's logistic weights
(``sigmoid(v·w₀ + w₁)`` over the one retrieval-score feature), and the final
top-k cut happens on the device. The stages stay on the device between each
other; per micro-batch the host sees only the final ``[B, k]`` scores and ids,
one copy each.

Both top-k cuts keep ``jax.lax.top_k``'s order (``models/ann.py::top_k``):
the re-rank's sigmoid saturates to exactly 1.0 in f32, and among those ties
the candidate retrieved first (higher retrieval score, then lower id) wins.

With the dot-product weight-tying head (no bias), MIPS scores over the
item-embedding table are the full-catalog logits: retrieval only skips items
that cannot reach the top-C.

An approximate index (int8 table or IVF, ``MIPSIndex.is_approximate``) only
selects the C candidates: a ``rescore`` stage replaces their scores by exact
f32 inner products against the host f32 master (``MIPSIndex.exact_rescore``)
before the re-rank, so the final scores are those of the f32 pipeline
wherever the approximate sweep found the same candidates.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import numpy as np
import torch

from replay_tpu_torch.models.ann import MIPSIndex, top_k


class CandidatePipeline:
    """MIPS top-C retrieval → logistic re-rank → top-k, fused per micro-batch.

    :param index: the catalog's :class:`MIPSIndex` — for SASRec-style
        weight-tying models, built over ``model.get_item_weights()`` so
        retrieval scores ARE the model's logits.
    :param num_candidates: C, the retrieval cut feeding the re-ranker.
    :param top_k: k, the response cut (``k <= C``).
    :param reranker_weights: optional ``[2]`` array (retrieval-score weight,
        bias — ``LogisticReranker.serving_weights`` trained on one score
        feature). ``None`` ranks by raw retrieval score.
    """

    def __init__(
        self,
        index: MIPSIndex,
        num_candidates: int = 100,
        top_k: int = 10,
        reranker_weights: Optional[np.ndarray] = None,
    ) -> None:
        if num_candidates > index.num_items:
            msg = (
                f"num_candidates={num_candidates} exceeds the catalog "
                f"({index.num_items} items)"
            )
            raise ValueError(msg)
        if top_k > num_candidates:
            msg = f"top_k={top_k} exceeds num_candidates={num_candidates}"
            raise ValueError(msg)
        self.index = index
        self.num_candidates = int(num_candidates)
        self.top_k = int(top_k)
        self.reranker_weights = (
            np.asarray(reranker_weights, np.float32)
            if reranker_weights is not None
            else None
        )
        if self.reranker_weights is not None and self.reranker_weights.shape != (2,):
            msg = (
                "serve re-rank uses ONE feature (the retrieval score): "
                f"weights must be [2] (weight, bias), got {self.reranker_weights.shape}"
            )
            raise ValueError(msg)
        # the two weights as f32 scalars on the device, as jnp.asarray keeps them
        self._weights = (
            torch.as_tensor(self.reranker_weights, device=index.device)
            if self.reranker_weights is not None
            else None
        )

    def _rerank(self, values: torch.Tensor, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        # LogisticReranker.decision_function over the single retrieval-score
        # feature; sigmoid is monotone but applied anyway so response scores
        # equal host predict_proba
        if self._weights is None:
            ranking = values
        else:
            ranking = torch.sigmoid(values * self._weights[0] + self._weights[1])
        top_scores, positions = top_k(ranking, self.top_k)
        return top_scores, ids.gather(1, positions)

    def rank(self, hidden, tracer=None, span_args=None) -> Tuple[np.ndarray, np.ndarray]:
        """``[B, E]`` query states (host array or tensor) → (scores ``[B, k]``,
        int32 item ids ``[B, k]``) host arrays.

        The device stages are traced as ``retrieve`` / ``rescore`` /
        ``rerank`` spans when a tracer is supplied (``rescore`` only for an
        approximate index); ``span_args`` merges extra args into each span.
        The ``rerank`` span ends after the one copy of the results to the
        host, so it holds the wait for the device."""
        span = tracer.span if tracer is not None else (lambda *_a, **_k: contextlib.nullcontext())
        extra = span_args or {}
        rows = int(hidden.shape[0])
        with span("retrieve", rows=rows, k=self.num_candidates, **extra):
            values, ids = self.index.search_jax(hidden, self.num_candidates)
        if self.index.is_approximate:
            # the approximate sweep only chose WHICH C rows to score; their
            # ranking scores are exact f32
            with span("rescore", rows=rows, k=self.num_candidates, **extra):
                values = self.index.exact_rescore(hidden, ids)
        with span("rerank", rows=rows, k=self.top_k, **extra):
            scores, items = self._rerank(values, ids)
            scores = scores.cpu().numpy()
            items = items.to(torch.int32).cpu().numpy()
        return scores, items

    def stats(self) -> dict:
        return {
            "num_candidates": self.num_candidates,
            "top_k": self.top_k,
            "index_precision": self.index.precision,
            "index_mode": self.index.index_mode,
        }
