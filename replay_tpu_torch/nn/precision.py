"""The precision ladder: mixed-precision policies for training.

Counterpart of ``replay_tpu/nn/precision.py`` on torch dtypes.

* **bf16 rung** — bfloat16 activations and compute, float32 master parameters
  and optimizer state, float32 loss and metric accumulation. bf16 shares f32's
  exponent range, so the policy needs no loss scaling (no ``GradScaler``).
  Gradients are taken with respect to the f32 parameters, so the optimizer
  state and the non-finite sentinel's arithmetic stay f32.
* **f32 rung** — the identity policy; applying it never changes a model.

The policy is applied through the model's ``dtype`` (the compute dtype of
:class:`~replay_tpu_torch.nn.sequential.sasrec.SasRec` and its layers):
:meth:`Precision.apply_to_model` returns a clone with ``dtype=compute_dtype``
and the same f32 weights. The trainer also wraps the loss's
``logits_callback`` so candidate-shaped logits (a bf16 × bf16 product) are
up-cast to ``accum_dtype``; full-catalog logits already promote to f32
through the f32 item table, and ``CEFused``'s kernels accumulate in f32.

Parity is gated, never assumed: :func:`fit_parity_record` compares an f32 and
a reduced-precision fit of the same data and seed at a relative threshold on
the final metric and keeps both loss curves. bf16-vs-f32 parity is a tolerance
claim, never a bitwise one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import torch

__all__ = [
    "PARITY_REL_TOL",
    "Precision",
    "fit_parity_record",
]

# the relative tolerance on the gated eval metric, the JAX package's: its
# cross-framework parity gate runs at 10% relative on the final ndcg@10
PARITY_REL_TOL = 0.10


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclass(frozen=True)
class Precision:
    """One rung of the precision ladder: compute/param/accumulation dtypes.

    ``compute_dtype`` becomes the model's ``dtype`` (activations, attention,
    FFN); ``param_dtype`` is the master-parameter dtype (always f32 here, so
    optimizer moments stay f32 too); ``accum_dtype`` is what loss terms and
    epoch metrics accumulate in. Resolve by name via :meth:`resolve`
    (``Trainer(precision="bf16")``) or construct directly. ``None`` dtype
    fields default to float32.
    """

    name: str = "f32"
    compute_dtype: Any = None
    param_dtype: Any = None
    accum_dtype: Any = None

    def __post_init__(self) -> None:
        for attr in ("compute_dtype", "param_dtype", "accum_dtype"):
            if getattr(self, attr) is None:
                object.__setattr__(self, attr, torch.float32)

    @classmethod
    def f32(cls) -> "Precision":
        return cls(name="f32")

    @classmethod
    def bf16(cls) -> "Precision":
        return cls(name="bf16", compute_dtype=torch.bfloat16)

    @classmethod
    def resolve(cls, spec: Any) -> Optional["Precision"]:
        """``None`` | ``"f32"`` | ``"bf16"`` | a :class:`Precision` → policy.

        ``None`` stays ``None`` (the trainer then touches nothing)."""
        if spec is None or isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            by_name = {"f32": cls.f32, "float32": cls.f32, "bf16": cls.bf16, "bfloat16": cls.bf16}
            if spec.lower() in by_name:
                return by_name[spec.lower()]()
            msg = (
                f"Unknown precision {spec!r}; use one of "
                f"{sorted(set(by_name))} or pass a Precision instance"
            )
            raise ValueError(msg)
        msg = f"precision must be None, a name string or a Precision, got {type(spec).__name__}"
        raise TypeError(msg)

    # -- model application -------------------------------------------------- #
    @property
    def is_identity(self) -> bool:
        return self.compute_dtype == torch.float32 and self.param_dtype == torch.float32

    def apply_to_model(self, model: Any) -> Any:
        """``model`` cloned with its compute ``dtype`` set to this rung.

        The identity rung returns the model unchanged. A non-identity rung
        applied to a model without a ``dtype`` is an error here, not a silent
        f32 run."""
        if self.is_identity:
            return model
        if not hasattr(model, "dtype"):
            msg = (
                f"Precision('{self.name}') needs a compute-dtype knob, but "
                f"{type(model).__name__} defines no `dtype` field. Add one "
                "(the SasRec convention: activations in `dtype`, params in "
                "float32) or drop the precision policy."
            )
            raise ValueError(msg)
        if model.dtype == self.compute_dtype:
            return model
        return model.clone(dtype=self.compute_dtype)

    # -- loss-side accumulation --------------------------------------------- #
    @property
    def casts_logits(self) -> bool:
        """Whether loss-consumed logits need an explicit up-cast: candidate-
        shaped logits are a narrow × narrow product under a narrow compute
        dtype and would otherwise stay narrow."""
        return self.compute_dtype != self.accum_dtype

    def wrap_logits_callback(self, callback: Callable) -> Callable:
        """``logits_callback`` → the same callback with outputs cast to
        ``accum_dtype`` (a no-op for logits that are already f32)."""
        accum = self.accum_dtype

        def cast_logits(*args, **kwargs):
            return callback(*args, **kwargs).to(accum)

        return cast_logits

    def describe(self) -> Dict[str, str]:
        """Flat record for events and bench rows."""
        return {
            "precision": self.name,
            "compute_dtype": _dtype_name(self.compute_dtype),
            "param_dtype": _dtype_name(self.param_dtype),
            "accum_dtype": _dtype_name(self.accum_dtype),
        }


def _metric_series(history: Sequence[Mapping[str, Any]], metric: str):
    return [
        float(record[metric])
        for record in history
        if metric in record and isinstance(record[metric], (int, float))
    ]


def fit_parity_record(
    baseline_history: Sequence[Mapping[str, Any]],
    candidate_history: Sequence[Mapping[str, Any]],
    metric: str = "ndcg@10",
    rel_tol: float = PARITY_REL_TOL,
    baseline_name: str = "f32",
    candidate_name: str = "bf16",
) -> Dict[str, Any]:
    """The fit-parity gate record: candidate vs baseline ``Trainer.history``.

    Same data, same seed, two precisions: the gate passes when the final
    ``metric`` value agrees within ``rel_tol`` relative and both values are
    finite. Loss curves (``train_loss`` per epoch) ride along, never gated.
    Raises ``KeyError`` when the metric never appears (a gate that passes on
    a missing metric would be worse than no gate).
    """
    base_series = _metric_series(baseline_history, metric)
    cand_series = _metric_series(candidate_history, metric)
    if not base_series or not cand_series:
        msg = (
            f"fit_parity_record: metric {metric!r} absent from "
            f"{'baseline' if not base_series else 'candidate'} history"
        )
        raise KeyError(msg)
    base_final, cand_final = base_series[-1], cand_series[-1]
    finite = math.isfinite(base_final) and math.isfinite(cand_final)
    denom = max(abs(base_final), 1e-12)
    rel_gap = abs(cand_final - base_final) / denom
    return {
        "metric": metric,
        baseline_name: base_final,
        candidate_name: cand_final,
        "rel_gap": rel_gap,
        "tolerance": rel_tol,
        "passed": bool(finite and rel_gap <= rel_tol),
        f"loss_curve_{baseline_name}": _metric_series(baseline_history, "train_loss"),
        f"loss_curve_{candidate_name}": _metric_series(candidate_history, "train_loss"),
    }
