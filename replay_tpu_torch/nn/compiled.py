"""Fixed-shape inference programs, captured as CUDA graphs on the card.

Counterpart of ``replay_tpu/nn/compiled.py::CompiledInference``. The JAX package
compiles one XLA executable per batch bucket; here a bucket is a fixed input
shape: every call is padded up to its bucket (repeating row 0) and cut back,
which keeps a row's scores independent of how full its batch was. On the card
each bucket's program is one CUDA graph (:mod:`replay_tpu_torch.nn.graphs`),
captured at ``compile`` after a warm-up run, replayed by every call and
launched as one unit; on ``device="cpu"`` the bucket runs the bound program
eagerly. A failed capture raises: nothing falls back to eager on the card.

Params travel as an ARGUMENT of every call, a ``state_dict``-shaped mapping
applied with ``torch.func.functional_call``, never folded into the model. That
keeps :meth:`CompiledInference.swap_params` and the per-call ``params`` override
the JAX engine's hot-swap seam: any mapping of the same keys, shapes and dtypes
runs through the same program, and through the same graphs (which read a
static copy of the installed set, refreshed when another set is passed).

:meth:`CompiledInference.serialize` / :meth:`CompiledInference.deserialize`
round-trip the whole instance in the JAX package's layout: a magic, a JSON
header (mode, ``max_sequence_length``, outputs, ``candidates_count``, buckets,
and the device type the programs were traced on), the params as npz, and one
blob per bucket: a ``torch.export`` program saved with ``torch.export.save``
that takes the params as arguments (folding them in as constants would let the
compiler reassociate and break bitwise parity with the live programs). Loading
one needs neither the model code nor a checkpoint, only the operators that
``replay_tpu_torch.ops`` registers (the attention kernels K4 and K5 are
``replay_tpu_torch::`` operators, so a loaded program launches them).
"""

from __future__ import annotations

import io
import json
import struct
import threading
import weakref
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from replay_tpu_torch.device import DeviceLike, resolve_device
from replay_tpu_torch.nn.graphs import CapturedProgram

MODES = ("batch", "one_query", "dynamic_batch_size")
OUTPUTS = ("logits", "hidden", "both")

_MAGIC = b"RTCI\x01"

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


def _pad_input(x, dtype: torch.dtype, np_dtype, rows: int, device: torch.device):
    """``x`` padded to ``rows`` rows by repeating row 0: a host array stays on
    the host (one copy to the card later, into a graph's static buffer), a
    tensor goes to ``device``."""
    if isinstance(x, torch.Tensor):
        return pad_rows(as_device_tensor(x, dtype, device), rows)
    x = np.asarray(x, np_dtype)
    if x.shape[0] < rows:
        x = np.concatenate([x, np.repeat(x[:1], rows - x.shape[0], 0)])
    return x


class _Program(nn.Module):
    """``model`` behind one ``forward``, so ``functional_call`` can bind params
    to any of its methods (``functional_call`` only calls ``forward``)."""

    def __init__(self, model: nn.Module, run: Callable[..., Any]) -> None:
        super().__init__()
        self.model = model
        self._run = run

    def forward(self, *args):
        return self._run(self.model, *args)


# one lock per model: ``functional_call`` swaps the module's parameters for
# the length of the call, so two threads binding one model at once (the serve
# workers of services that share it) would each run on the other's weights
_BIND_LOCKS: "weakref.WeakKeyDictionary[nn.Module, threading.RLock]" = weakref.WeakKeyDictionary()
_BIND_LOCKS_GUARD = threading.Lock()


def _bind_lock(model: nn.Module) -> threading.RLock:
    with _BIND_LOCKS_GUARD:
        lock = _BIND_LOCKS.get(model)
        if lock is None:
            lock = _BIND_LOCKS[model] = threading.RLock()
        return lock


def bind(model: nn.Module, run: Callable[..., Any]) -> Callable[..., Any]:
    """``(params, *args) -> run(model, *args)`` with ``model``'s weights taken
    from ``params``: the eager program, which each CUDA graph captures. Calls
    on one model are serialised across threads (a CUDA graph's replay binds
    nothing and is not)."""
    program = _Program(model, run)
    lock = _bind_lock(model)

    def call(params: Params, *args):
        with lock, torch.no_grad():
            return functional_call(
                program, {f"model.{name}": value for name, value in params.items()}, args,
                strict=True,
            )

    return call


def inference_program(outputs: str, feature_name: str = "item_id") -> Callable[..., Any]:
    """``run(model, item_ids, padding_mask, candidates)`` for an ``outputs``
    mode: ``forward_inference`` scores, the last-position hidden state, or
    both. What :meth:`CompiledInference.compile` binds per bucket."""

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

    return forward


class _Exported(nn.Module):
    """A parameter-free module around a program, for ``torch.export``: the
    params are its first argument, so the exported graph takes them as inputs."""

    def __init__(self, program: Callable[..., Any]) -> None:
        super().__init__()
        self._program = program

    def forward(self, params, item_ids, padding_mask, *candidates):
        return self._program(params, item_ids, padding_mask, candidates[0] if candidates else None)


def _example_inputs(size: int, length: int, candidates_count: Optional[int], device: torch.device):
    """Bucket-shaped inputs for a warm-up, a capture or an export: item 0 in
    every full window, candidates 0 .. K-1."""
    ids = torch.zeros((size, length), dtype=torch.int32, device=device)
    mask = torch.ones((size, length), dtype=torch.bool, device=device)
    cands = torch.arange(candidates_count, dtype=torch.int32, device=device) if candidates_count else None
    return ids, mask, cands


def _export_bucket(program, params: Params, size: int, length: int, candidates_count, device) -> bytes:
    """One bucket's program as ``torch.export.save`` bytes, params as inputs."""
    ids, mask, cands = _example_inputs(size, length, candidates_count, device)
    args = (dict(params), ids, mask) + ((cands,) if cands is not None else ())
    with torch.no_grad():
        exported = torch.export.export(_Exported(program), args, strict=False)
    # torch.export.save would store the example inputs, a copy of the params
    # in every bucket's blob; the params travel once, in the payload's npz
    exported.example_inputs = None
    buffer = io.BytesIO()
    torch.export.save(exported, buffer)
    return buffer.getvalue()


def _load_bucket(blob: bytes) -> Callable[..., Any]:
    """A program ``(params, item_ids, padding_mask, candidates_or_None)`` from
    one bucket's blob."""
    module = torch.export.load(io.BytesIO(blob)).module()

    def call(params, item_ids, padding_mask, candidates):
        args = (dict(params), item_ids, padding_mask) + ((candidates,) if candidates is not None else ())
        with torch.no_grad():
            return module(*args)

    return call


def _payload(header: Dict[str, Any], params: Params, blobs: Sequence[bytes]) -> bytes:
    """The serialized layout: magic, header, params npz, one blob per bucket,
    each section behind its little-endian u32 length."""
    header_bytes = json.dumps(header).encode()
    params_buffer = io.BytesIO()
    np.savez(params_buffer, **{name: _to_numpy(value) for name, value in params.items()})
    buffer = io.BytesIO()
    buffer.write(_MAGIC)
    for section in (header_bytes, params_buffer.getvalue(), *blobs):
        buffer.write(struct.pack("<I", len(section)))
        buffer.write(section)
    return buffer.getvalue()


def _to_numpy(value: torch.Tensor) -> np.ndarray:
    """A tensor as numpy; bf16, which numpy lacks, as its raw uint16 bits."""
    value = value.detach().cpu()
    if value.dtype == torch.bfloat16:
        return value.view(torch.int16).numpy().view(np.uint16)
    return value.numpy()


def _from_numpy(value: np.ndarray, dtype: str, device: torch.device) -> torch.Tensor:
    tensor = torch.from_numpy(np.ascontiguousarray(value))
    if dtype == "bfloat16":
        tensor = tensor.view(torch.int16).view(torch.bfloat16)
    return tensor.to(device)


def _read_sections(payload: bytes):
    view = memoryview(payload)
    if bytes(view[: len(_MAGIC)]) != _MAGIC:
        msg = "Not a CompiledInference payload (bad magic)"
        raise ValueError(msg)
    offset = len(_MAGIC)
    while offset < len(view):
        (size,) = struct.unpack_from("<I", view, offset)
        offset += 4
        yield bytes(view[offset : offset + size])
        offset += size


class CompiledInference:
    """Fixed-shape ``forward_inference`` programs for serving.

    ``_compiled`` maps batch-bucket size → a callable ``(params, item_ids,
    padding_mask, candidates_or_None) -> outputs`` (the eager program; on the
    card each bucket also has a captured graph of it). Values may be ``None``
    for routing-only instances (bucket-selection tests).
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
        # live instances export a bucket on demand; deserialized ones keep
        # their blobs, so that serialize() stays total
        self._export_bucket: Optional[Callable[[int], bytes]] = None
        self._raw_blobs: Optional[Dict[int, bytes]] = None
        self._graphs: Optional[CapturedProgram] = None

    @property
    def buckets(self) -> Tuple[int, ...]:
        """The batch-bucket sizes, ascending."""
        return tuple(sorted(self._compiled))

    @property
    def graphs(self) -> Optional[CapturedProgram]:
        """The buckets' captured graphs on the card (``None`` on the CPU)."""
        return self._graphs

    def roofline(self) -> Dict[int, Any]:
        """The roofline record of every bucket's program
        (:func:`replay_tpu_torch.obs.roofline.analyze_program`): one eager
        call at the bucket's shape with counted FLOPs (K4 and K5 through their
        formulas), an eager bytes count, the allocator's memory on the card,
        and memory- vs compute-bound against the card's peaks. Deserialized
        instances too; buckets without a program are left out."""
        from replay_tpu_torch.obs.roofline import analyze_program

        records: Dict[int, Any] = {}
        for size in self.buckets:
            program = self._compiled[size]
            if program is None:
                continue
            ids, mask, cands = _example_inputs(size, self.max_sequence_length, self._candidates_count, self.device)
            with torch.no_grad():
                record = analyze_program(program, self._params, ids, mask, cands, device=self.device)
            if record is not None:
                records[int(size)] = record
        return records

    def _capture_buckets(self) -> None:
        """One CUDA graph per bucket, each after a warm-up run (card only)."""
        if self.device.type != "cuda":
            return
        self._graphs = CapturedProgram(self._compiled, self.device)
        for size in self.buckets:
            example = _example_inputs(size, self.max_sequence_length, self._candidates_count, self.device)
            self._graphs.prepare(size, self._params, example)

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
        no scoring head), or ``"both"``. On the card each bucket is captured
        as a CUDA graph here.
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

        program = bind(model, inference_program(outputs, feature_name))
        out = cls(
            {size: program for size in sizes},
            max_sequence_length,
            mode,
            outputs=outputs,
            candidates_count=candidates_count,
            params=to_device_params(params, device),
            device=device,
        )
        out._export_bucket = lambda size: _export_bucket(
            program, out._params, size, max_sequence_length, candidates_count, device
        )
        out._capture_buckets()
        return out

    # -- persistence -------------------------------------------------------- #
    def serialize(self) -> bytes:
        """The whole instance as bytes: a JSON header (mode, shapes, outputs,
        candidate count, bucket list, device type), the bound params (npz),
        and one ``torch.export`` program per bucket. :meth:`deserialize` needs
        neither the model code nor the checkpoint; the params stay program
        arguments, so the round-tripped scores are bit-identical."""
        if self._export_bucket is None and self._raw_blobs is None:
            msg = "This instance holds no executables to serialize (routing-only?)"
            raise ValueError(msg)
        header = {
            "mode": self.mode,
            "max_sequence_length": int(self.max_sequence_length),
            "outputs": self.outputs,
            "candidates_count": self._candidates_count,
            "buckets": [int(b) for b in self.buckets],
            "device": self.device.type,
            "dtypes": {name: _dtype_name(value.dtype) for name, value in self._params.items()},
        }
        blobs = [
            self._raw_blobs[size] if self._raw_blobs is not None else self._export_bucket(size)
            for size in self.buckets
        ]
        return _payload(header, self._params, blobs)

    @classmethod
    def deserialize(cls, payload: bytes, device: DeviceLike = "cuda") -> "CompiledInference":
        """Rebuild a fresh :class:`CompiledInference` from :meth:`serialize`
        bytes, on ``device``, which must be of the type the programs were
        traced on; on the card its buckets are captured as graphs, as
        ``compile`` does. Scores are identical to the live instance's."""
        device = resolve_device(device)
        header_bytes, params_bytes, *blobs = _read_sections(payload)
        header = json.loads(header_bytes)
        if header["device"] != device.type:
            msg = f"the payload's programs were traced on {header['device']}, not {device.type}"
            raise ValueError(msg)
        with np.load(io.BytesIO(params_bytes)) as archive:
            params = {
                name: _from_numpy(archive[name], header["dtypes"][name], device) for name in archive.files
            }
        buckets = header["buckets"]
        if len(blobs) != len(buckets):
            msg = f"payload holds {len(blobs)} programs for {len(buckets)} buckets"
            raise ValueError(msg)
        out = cls(
            {size: _load_bucket(blob) for size, blob in zip(buckets, blobs)},
            header["max_sequence_length"],
            header["mode"],
            outputs=header["outputs"],
            candidates_count=header["candidates_count"],
            params=params,
            device=device,
        )
        out._raw_blobs = dict(zip(buckets, blobs))
        out._capture_buckets()
        return out

    # -- hot swap ----------------------------------------------------------- #
    def validate_params(self, params: Params) -> Optional[str]:
        """Why ``params`` can NOT hot-swap into these programs, or ``None``."""
        if self._params is None:
            return "instance holds no bound params (routing-only?)"
        return params_mismatch(self._params, params)

    def swap_params(self, params: Params) -> None:
        """Install ``params`` as the bound parameter set — no recompile, no
        recapture. A mismatch — e.g. a grown item table — raises naming the
        offending leaf."""
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
        mode, on the device, cut back to the request's row count: tensors of
        this call's own, which later calls do not overwrite. ``params``
        overrides the bound parameter set for THIS call (same keys, shapes and
        dtypes required; they must already be on the device)."""
        if not isinstance(item_ids, torch.Tensor):
            item_ids = np.asarray(item_ids, np.int32)
        batch = item_ids.shape[0]
        if item_ids.shape[1] != self.max_sequence_length:
            msg = (
                f"Sequence length {item_ids.shape[1]} != compiled "
                f"{self.max_sequence_length}"
            )
            raise ValueError(msg)
        bucket = self._bucket_for(batch)
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
        params = self._params if params is None else params
        if self._graphs is not None:
            ids = _pad_input(item_ids, torch.int32, np.int32, bucket, self.device)
            mask = _pad_input(padding_mask, torch.bool, bool, bucket, self.device)
            return self._graphs(bucket, params, (ids, mask, candidates), rows=batch)
        item_ids = pad_rows(as_device_tensor(item_ids, torch.int32, self.device), bucket)
        padding_mask = pad_rows(as_device_tensor(padding_mask, torch.bool, self.device), bucket)
        out = self._compiled[bucket](params, item_ids, padding_mask, candidates)
        if self.outputs == "both":
            logits, hidden = out
            return logits[:batch], hidden[:batch]
        return out[:batch]

    def close(self) -> None:
        """Free the buckets' graphs and their memory pools (the card's
        counterpart of dropping the executables); a later call captures anew."""
        if self._graphs is not None:
            self._graphs.close()


def export_inference(
    model, params: Params, max_sequence_length: int, batch_size: int, feature_name: str = "item_id",
    device: DeviceLike = "cuda",
) -> bytes:
    """``forward_inference`` at one shape as bytes: logits only, the params as
    program arguments, in :meth:`CompiledInference.serialize`'s layout (one
    ``batch`` bucket of ``batch_size``), traced on ``device``."""
    device = resolve_device(device)
    mismatch = params_mismatch(model.state_dict(), params)
    if mismatch is not None:
        msg = f"params do not fit the model: {mismatch}"
        raise ValueError(msg)
    params = to_device_params(params, device)
    program = bind(model, inference_program("logits", feature_name))
    header = {
        "mode": "batch", "max_sequence_length": int(max_sequence_length), "outputs": "logits",
        "candidates_count": None, "buckets": [int(batch_size)], "device": device.type,
        "dtypes": {name: _dtype_name(value.dtype) for name, value in params.items()},
    }
    blob = _export_bucket(program, params, batch_size, max_sequence_length, None, device)
    return _payload(header, params, [blob])


def import_inference(payload: bytes, device: DeviceLike = "cuda"):
    """Load :func:`export_inference` bytes into a callable
    ``(item_ids, padding_mask) -> logits`` on ``device`` (on the card, a
    captured graph)."""
    served = CompiledInference.deserialize(payload, device=device)
    return lambda item_ids, padding_mask: served(item_ids, padding_mask)
