"""Fixed-shape inference programs.

Counterpart of ``replay_tpu/nn/compiled.py::CompiledInference``. The JAX package
compiles one XLA executable per batch bucket; PyTorch runs eagerly, so here a
bucket is a fixed input shape: every call is padded up to its bucket (repeating
row 0) and cut back, which keeps a row's scores independent of how full its
batch was. Capturing each bucket as a CUDA graph is later work, as are
``serialize``/``deserialize`` and ``roofline``.

Params travel as an ARGUMENT of every call, a ``state_dict``-shaped mapping
applied with ``torch.func.functional_call``, never folded into the model. That
keeps :meth:`CompiledInference.swap_params` and the per-call ``params`` override
the JAX engine's hot-swap seam: any mapping of the same keys, shapes and dtypes
runs through the same program.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from replay_tpu_torch.device import DeviceLike, resolve_device

MODES = ("batch", "one_query", "dynamic_batch_size")
OUTPUTS = ("logits", "hidden", "both")

Params = Mapping[str, torch.Tensor]


def params_mismatch(template: Params, params: Params) -> Optional[str]:
    """First incompatibility between ``params`` and the mapping a program was
    built with — ``None`` when a hot swap is legal. The returned string names
    the offending leaf, in the JAX package's wording."""
    missing = sorted(set(template) - set(params))
    if missing:
        return f"missing leaf {missing[0]!r}"
    extra = sorted(set(params) - set(template))
    if extra:
        return f"unexpected leaf {extra[0]!r}"
    for path in sorted(template):
        old, new = template[path], params[path]
        if tuple(old.shape) != tuple(new.shape):
            return (
                f"leaf {path!r} has shape {tuple(new.shape)}; the compiled "
                f"program expects {tuple(old.shape)}"
            )
        if old.dtype != new.dtype:
            return (
                f"leaf {path!r} has dtype {_dtype_name(new.dtype)}; the "
                f"compiled program expects {_dtype_name(old.dtype)}"
            )
    return None


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def to_device_params(params: Params, device: torch.device) -> Dict[str, torch.Tensor]:
    """``params`` as a plain dict of detached tensors on ``device``."""
    return {name: value.detach().to(device) for name, value in params.items()}


def as_device_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A host array or any tensor as a ``dtype`` tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` padded to ``rows`` rows by repeating row 0."""
    if x.shape[0] >= rows:
        return x
    return torch.cat([x, x[:1].expand(rows - x.shape[0], *x.shape[1:])])


class _Program(nn.Module):
    """``model`` behind one ``forward``, so ``functional_call`` can bind params
    to any of its methods (``functional_call`` only calls ``forward``)."""

    def __init__(self, model: nn.Module, run: Callable[..., Any]) -> None:
        super().__init__()
        self.model = model
        self._run = run

    def forward(self, *args):
        return self._run(self.model, *args)


def bind(model: nn.Module, run: Callable[..., Any]) -> Callable[..., Any]:
    """``(params, *args) -> run(model, *args)`` with ``model``'s weights taken from ``params``."""
    program = _Program(model, run)

    def call(params: Params, *args):
        with torch.no_grad():
            return functional_call(
                program, {f"model.{name}": value for name, value in params.items()}, args,
                strict=True,
            )

    return call


class CompiledInference:
    """Fixed-shape ``forward_inference`` programs for serving.

    ``_compiled`` maps batch-bucket size → a callable ``(params, item_ids,
    padding_mask, candidates_or_None) -> outputs``.
    """

    def __init__(
        self,
        compiled_by_batch: Dict[int, Any],
        max_sequence_length: int,
        mode: str,
        outputs: str = "logits",
        candidates_count: Optional[int] = None,
        params: Optional[Params] = None,
        device: DeviceLike = "cuda",
    ):
        self._compiled = compiled_by_batch
        self.max_sequence_length = max_sequence_length
        self.mode = mode
        self.outputs = outputs
        self._candidates_count = candidates_count
        self._params = params
        self.device = resolve_device(device)

    @property
    def buckets(self) -> Tuple[int, ...]:
        """The batch-bucket sizes, ascending."""
        return tuple(sorted(self._compiled))

    @classmethod
    def compile(
        cls,
        model,
        params: Params,
        max_sequence_length: int,
        batch_size: int = 512,
        mode: str = "batch",
        candidates_count: Optional[int] = None,
        feature_name: str = "item_id",
        dynamic_buckets: Sequence[int] = (1, 8, 64, 512),
        outputs: str = "logits",
        device: DeviceLike = "cuda",
    ) -> "CompiledInference":
        """Fixed-shape programs for the model's ``forward_inference``.

        ``batch``: one bucket at ``batch_size``; ``one_query``: batch 1;
        ``dynamic_batch_size``: one bucket per size of ``dynamic_buckets``.
        ``outputs`` selects what each call returns: ``"logits"``
        (forward_inference scores), ``"hidden"`` (last-position encoder state,
        no scoring head), or ``"both"``.
        """
        device = resolve_device(device)
        if mode not in MODES:
            msg = f"mode must be one of {MODES}"
            raise ValueError(msg)
        if outputs not in OUTPUTS:
            msg = f"outputs must be one of {OUTPUTS}"
            raise ValueError(msg)
        if outputs == "hidden" and candidates_count:
            msg = "outputs='hidden' computes no scores; candidates_count is meaningless"
            raise ValueError(msg)
        sizes = {
            "batch": [batch_size],
            "one_query": [1],
            "dynamic_batch_size": sorted(dynamic_buckets),
        }[mode]
        mismatch = params_mismatch(model.state_dict(), params)
        if mismatch is not None:
            msg = f"params do not fit the model: {mismatch}"
            raise ValueError(msg)

        def forward(model, item_ids, padding_mask, candidates):
            if outputs == "logits":
                return model.forward_inference(
                    {feature_name: item_ids}, padding_mask, candidates_to_score=candidates
                )
            # the same ops forward_inference runs, split so the last-position
            # hidden state is an output (the serve cache's state)
            last = model({feature_name: item_ids}, padding_mask)[:, -1, :]
            if outputs == "hidden":
                return last
            return model.get_logits(last, candidates_to_score=candidates), last

        program = bind(model, forward)
        return cls(
            {size: program for size in sizes},
            max_sequence_length,
            mode,
            outputs=outputs,
            candidates_count=candidates_count,
            params=to_device_params(params, device),
            device=device,
        )

    # -- hot swap ----------------------------------------------------------- #
    def validate_params(self, params: Params) -> Optional[str]:
        """Why ``params`` can NOT hot-swap into these programs, or ``None``."""
        if self._params is None:
            return "instance holds no bound params (routing-only?)"
        return params_mismatch(self._params, params)

    def swap_params(self, params: Params) -> None:
        """Install ``params`` as the bound parameter set. A mismatch — e.g. a
        grown item table — raises naming the offending leaf."""
        mismatch = self.validate_params(params)
        if mismatch is not None:
            msg = (
                f"params cannot hot-swap into the compiled executables: "
                f"{mismatch}. A changed catalog shape needs a recompile "
                "(CompiledInference.compile with the new params)."
            )
            raise ValueError(msg)
        self._params = to_device_params(params, self.device)

    # -- execution ---------------------------------------------------------- #
    def _bucket_for(self, batch: int) -> int:
        for size in sorted(self._compiled):
            if size >= batch:
                return size
        msg = f"Batch {batch} exceeds the largest compiled bucket {max(self._compiled)}"
        raise ValueError(msg)

    def __call__(self, item_ids, padding_mask, candidates=None, params: Optional[Params] = None):
        """Score [B, L] sequences; pads the batch up to its bucket.

        Returns logits, hidden, or ``(logits, hidden)`` per the ``outputs``
        mode, on the device, cut back to the request's row count. ``params``
        overrides the bound parameter set for THIS call (same keys, shapes and
        dtypes required; they must already be on the device)."""
        item_ids = as_device_tensor(item_ids, torch.int32, self.device)
        padding_mask = as_device_tensor(padding_mask, torch.bool, self.device)
        batch = item_ids.shape[0]
        if item_ids.shape[1] != self.max_sequence_length:
            msg = (
                f"Sequence length {item_ids.shape[1]} != compiled "
                f"{self.max_sequence_length}"
            )
            raise ValueError(msg)
        bucket = self._bucket_for(batch)
        item_ids, padding_mask = pad_rows(item_ids, bucket), pad_rows(padding_mask, bucket)
        if candidates is not None and not self._candidates_count:
            msg = (
                "Model was compiled without candidates_count; candidate scoring "
                "needs compile(..., candidates_count=K)."
            )
            raise ValueError(msg)
        if self._candidates_count and candidates is None:
            msg = f"Compiled for {self._candidates_count} candidates; none given."
            raise ValueError(msg)
        if self._candidates_count:
            candidates = as_device_tensor(candidates, torch.int32, self.device)
            if tuple(candidates.shape) != (self._candidates_count,):
                msg = (
                    f"candidates shape {tuple(candidates.shape)} != compiled "
                    f"({self._candidates_count},)"
                )
                raise ValueError(msg)
        out = self._compiled[bucket](
            self._params if params is None else params, item_ids, padding_mask, candidates
        )
        if self.outputs == "both":
            logits, hidden = out
            return logits[:batch], hidden[:batch]
        return out[:batch]
