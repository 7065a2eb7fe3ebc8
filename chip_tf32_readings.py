#!/usr/bin/env python3
"""The split-TF32 error of the port's TF32 kernels, read on one NVIDIA GPU.

    python3 chip_tf32_readings.py

``replay_tpu_torch/csrc/tensor_core.cuh`` splits each f32 operand x into hi,
x rounded to TF32, and lo, ``x - hi`` in TF32. This script builds the two
sources with TF32 kernels (``fused_ce``, ``flash_tiled``) twice from copies of
``csrc/``, with lo cut toward zero and with lo rounded to nearest, and under
each rule reads every TF32 kernel's error:

* K1, K2 and K3 (``tf32``) against their plain versions at the widths
  ``chip_smoke.py`` runs them (the ``bench.py`` width in f32, the long-sequence
  width on bf16 and on f32 hidden states), held as ``chip_smoke.py`` holds them;
* K5 (``tf32x3``, f32, causal) against its plain version and against a float64
  reference at L = 1,024, 4,096, 8,192 and 16,384;
* the precision probes of ``tests/_torch/tf32_probes.py`` (K1, K2, K3, K5), as
  the share of each one's limit;
* the bf16 long-sequence trainer's losses against the unfused trainer's, and
  the f32 trainer's against the unfused one with ``CE`` (20 steps each).

Then, under the rule the sources state, K3 on its ``simt`` variant against the
plain version and against ``tf32`` at the long-sequence bf16 width, and the
bf16 trainers once with K3 and once with K1–K3 forced onto ``simt`` by a hook
of this script (the wrappers' own rule is not touched). One JSON line per
reading, then the card's name and power limit. Exits non-zero without a GPU.
"""

from __future__ import annotations

import contextlib
import functools
import json
import shutil
import sys
from pathlib import Path

import torch

import chip_smoke as cs

# the two rules for lo, as tensor_core.cuh's tf32_parts states them
LO_RULES = {
    "cut": "lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;",
    "round": "lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xffffe000u;",
}
TF32_SOURCES = ("fused_ce", "flash_tiled")
# K5 f32 causal shapes (B, H, L, D): the long-sequence width, bench_suite.py's
# attention_long, and two longer rows
K5_SHAPES = ((32, 2, 1024, 64), (4, 4, 4096, 64), (1, 4, 8192, 64), (1, 2, 16384, 64))
PROBES = Path(__file__).resolve().parent / "tests" / "_torch"


def emit(kind: str, **fields) -> None:
    print(json.dumps({"reading": kind, **fields}), flush=True)


@contextlib.contextmanager
def built_with(rule: str):
    """The kernels built from a copy of ``csrc/`` whose lo rule is ``rule``,
    loaded in place of the repo's for the duration."""
    from replay_tpu_torch.ops import build

    saved = build.CSRC_DIR, build.BUILD_DIR, dict(build._LIBRARIES)
    root = build.BUILD_DIR / f"lo_{rule}"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(build.CSRC_DIR, root / "csrc")
    header = root / "csrc" / "tensor_core.cuh"
    text = header.read_text()
    present = [name for name, line in LO_RULES.items() if line in text]
    if len(present) != 1:
        raise AssertionError(f"tensor_core.cuh states {present} of the lo rules {list(LO_RULES)}")
    header.write_text(text.replace(LO_RULES[present[0]], LO_RULES[rule]))
    build.CSRC_DIR, build.BUILD_DIR, build._LIBRARIES = root / "csrc", root / "_build", {}
    try:
        for name, (seconds, _) in build.build_all(TF32_SOURCES).items():
            emit("build", rule=rule, kernel=name, seconds=seconds)
        yield
    finally:
        build.CSRC_DIR, build.BUILD_DIR, build._LIBRARIES = saved


@contextlib.contextmanager
def forced_simt(fc, names):
    """The wrappers ``names`` of ``fc`` on their simt variant whatever E is:
    each call runs with the module's variant rule answering "simt"."""
    rule, saved = fc._variant, {name: getattr(fc, name) for name in names}

    def simt(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            fc._variant = lambda dim: "simt"
            try:
                return fn(*args, **kwargs)
            finally:
                fc._variant = rule

        return run

    for name in names:
        setattr(fc, name, simt(saved[name]))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(fc, name, fn)


def fused_errors(fc, device) -> dict:
    """K1 abs, K2 and K3 over max |plain|, at chip_smoke.py's path widths."""
    out = {}
    for index, (name, rows, items, num_valid, dtype, dim) in enumerate(cs.FUSED_CASES):
        if name not in ("train_f32", "longseq_bf16_hidden", "longseq_f32"):
            continue
        hidden, table, grad = cs.fused_case(rows, items, dim, dtype, device, 100 + index)
        want_lse = fc.fused_lse_reference(hidden, table)
        want_dh = fc.fused_lse_dh_reference(hidden.float(), table, grad, want_lse)
        want_dw = fc.fused_lse_dw_reference(hidden.float(), table, grad, want_lse)
        out[name] = {
            "K1": (fc.fused_lse_forward(hidden, table) - want_lse).abs().max().item(),
            "K2": ((fc.fused_lse_dh(hidden, table, grad, want_lse).float() - want_dh).abs().max() / want_dh.abs().max()).item(),
            "K3": ((fc.fused_lse_dw(hidden, table, grad, want_lse) - want_dw).abs().max() / want_dw.abs().max()).item(),
        }
    return out


def f64_attention(q, k, v) -> torch.Tensor:
    """Causal softmax(q kᵀ / √D) v in float64, a head at a time."""
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    positions = torch.arange(q.shape[2], device=q.device)
    future = positions[None, :] > positions[:, None]
    for b in range(q.shape[0]):
        for h in range(q.shape[1]):
            s = (q[b, h].double() @ k[b, h].double().T) / q.shape[-1] ** 0.5
            s = torch.softmax(s.masked_fill(future, -torch.inf), dim=-1)
            out[b, h] = s @ v[b, h].double()
            del s
    return out


def k5_errors(device) -> dict:
    from replay_tpu_torch.ops import flash_tiled

    out = {}
    for index, (batch, heads, length, dim) in enumerate(K5_SHAPES):
        gen = torch.Generator(device).manual_seed(400 + index)
        q, k, v = (torch.randn(batch, heads, length, dim, device=device, generator=gen) for _ in range(3))
        bias = torch.zeros(batch, length, device=device)
        if flash_tiled._variant(q.dtype, dim) != "tf32x3":
            raise AssertionError("K5 f32 is not on its tf32x3 variant")
        got, _ = flash_tiled._launch(q, k, v, bias, True)
        plain, _ = flash_tiled.flash_attention_tiled_reference(q, k, v, bias, True)
        exact = f64_attention(q, k, v)
        out[f"L={length}"] = {
            "vs_plain": (got - plain).abs().max().item(),
            "vs_f64": (got.double() - exact).abs().max().item(),
            "plain_vs_f64": (plain.double() - exact).abs().max().item(),
            "limit": cs.KERNEL_TOL[torch.float32],
        }
        del q, k, v, got, plain, exact
        torch.cuda.empty_cache()
    return out


def probe_shares(fc, device) -> dict:
    """Each probe's kernel error against its plain version over its limit."""
    sys.path.insert(0, str(PROBES))
    import tf32_probes as tp
    from replay_tpu_torch.ops import flash_tiled

    q, k, v, padding = (torch.tensor(t, device=device) for t in tp.k5_probe())
    bias = flash_tiled.padding_mask_bias(padding)
    k5 = (flash_tiled._launch(q, k, v, bias, False)[0] - flash_tiled.flash_attention_tiled_reference(q, k, v, bias, False)[0])
    h, w, g = (torch.tensor(t, device=device) for t in tp.k3_probe())
    lse = fc.fused_lse_reference(h, w)
    want = fc.fused_lse_dw_reference(h, w, g, lse)
    k3 = (fc.fused_lse_dw(h, w, g, lse) - want).abs().max() / (tp.K3_LIMIT * want.abs().max())
    h, w, g = (torch.tensor(t, device=device) for t in tp.lse_probe())
    lse = fc.fused_lse_reference(h, w)
    want = fc.fused_lse_dh_reference(h, w, g, lse)
    return {
        "K5": k5.abs().max().item() / tp.K5_LIMIT,
        "K3": k3.item(),
        "K1": (fc.fused_lse_forward(h, w) - lse).abs().max().item() / tp.K1_LIMIT,
        "K2": ((fc.fused_lse_dh(h, w, g, lse) - want).abs().max() / (tp.K2_LIMIT * want.abs().max())).item(),
    }


def loss_rel_err(a, b) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def trainer_readings(device, bf16_only: bool = False) -> dict:
    """The bf16 tiled trainer's losses against the bf16 unfused one's (limit
    ``LONGSEQ_LOSS_RTOL``), and the f32 tiled trainer's against the f32
    unfused one with ``CE`` (limit ``TRAIN_LOSS_RTOL``), 20 steps from the
    same weights."""
    from replay_tpu_torch.nn.loss import CE, CEFused
    from replay_tpu_torch.nn.sequential.sasrec import SasRec
    from replay_tpu_torch.nn.train import Trainer

    schema, width, optimizer, tiled_model, initial, tiled, plain = cs.longseq_setup(device)
    batch = cs.next_item_batch(cs.LONG_BATCH, cs.LONG_LEN)
    out = {"bf16": loss_rel_err(cs.trained_losses(tiled, batch, initial)[1], cs.trained_losses(plain, batch, initial)[1])}
    if not bf16_only:
        f32_tiled = Trainer(tiled_model.clone(), CEFused(), optimizer=optimizer, precision="f32", device=device)
        f32_plain = Trainer(SasRec(schema, use_flash=False, **width), CE(), optimizer=optimizer, precision="f32", device=device)
        out["f32"] = loss_rel_err(
            cs.trained_losses(f32_tiled, batch, initial)[1], cs.trained_losses(f32_plain, batch, initial)[1]
        )
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_tf32_readings: torch sees no CUDA device; this script runs only on the GPU", file=sys.stderr)
        return 2
    from replay_tpu_torch.ops import fused_ce as fc

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = cs.nvidia_smi_line()
    emit("env", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda)
    limits = {"K1": cs.FUSED_TOL["K1"], "K2": cs.FUSED_TOL["K2"], "K3": cs.FUSED_TOL["K3"],
              "K2_bf16_dh": cs.FUSED_TOL_BF16_DH, "bf16_loss": cs.LONGSEQ_LOSS_RTOL, "f32_loss": cs.TRAIN_LOSS_RTOL}
    for rule in LO_RULES:
        with built_with(rule):
            emit("fused", rule=rule, errors=fused_errors(fc, device), limits=limits)
            emit("k5_tf32x3", rule=rule, errors=k5_errors(device))
            emit("probes", rule=rule, share_of_limit=probe_shares(fc, device))
            emit("trainers", rule=rule, loss_rel_err=trainer_readings(device), limits=limits)
            if rule == source_rule():
                simt_readings(fc, device)
    print(card, flush=True)
    return 0


def source_rule() -> str:
    """The lo rule the repo's tensor_core.cuh states."""
    from replay_tpu_torch.ops import build

    text = (build.PACKAGE_DIR / "csrc" / "tensor_core.cuh").read_text()
    return next(name for name, line in LO_RULES.items() if line in text)


def simt_readings(fc, device) -> None:
    """K3 simt against the plain version and against tf32 at the long-sequence
    bf16 width, and the bf16 trainers with K3, then K1-K3, on simt."""
    name, rows, items, _, dtype, dim = cs.FUSED_CASES[3]
    hidden, table, grad = cs.fused_case(rows, items, dim, dtype, device, 103)
    lse = fc.fused_lse_reference(hidden, table)
    want = fc.fused_lse_dw_reference(hidden.float(), table, grad, lse)
    tf32 = fc.fused_lse_dw(hidden, table, grad, lse)
    with forced_simt(fc, ("fused_lse_dw",)):
        simt = fc.fused_lse_dw(hidden, table, grad, lse)
    scale = want.abs().max()
    emit(
        "k3_variants", case=name, tf32_vs_plain=((tf32 - want).abs().max() / scale).item(),
        simt_vs_plain=((simt - want).abs().max() / scale).item(), tf32_vs_simt=((tf32 - simt).abs().max() / scale).item(),
        limit=cs.FUSED_TOL["K3"],
    )
    for names in (("fused_lse_dw",), ("fused_lse_forward", "fused_lse_dh", "fused_lse_dw")):
        before = dict(fc.fused_lse_dw.launches_by_variant)
        with forced_simt(fc, names):
            reading = trainer_readings(device, bf16_only=True)
        ran = {key: fc.fused_lse_dw.launches_by_variant[key] - before[key] for key in before}
        if ran["tf32"]:
            raise AssertionError(f"the hook left K3 on tf32: {ran}")
        emit("trainers_simt", simt=list(names), loss_rel_err=reading, limit=cs.LONGSEQ_LOSS_RTOL)


if __name__ == "__main__":
    sys.exit(main())
