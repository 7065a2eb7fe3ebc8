"""The rules the PyTorch port keeps.

* ``replay_tpu_torch``, ``chip_smoke.py``, ``chip_tf32_readings.py``, ``chip_trace_probe.py``
  and the worker scripts the tests launch (``WORKERS``) import nothing of JAX,
  flax, optax or the JAX package, at run time or in their sources, and no
  pandas (the GPU machine has none).
* Entry points run on the GPU unless the caller asks for the CPU by name.
* Kernel wrappers never fall back: the plain version runs only for tensors that
  all lie on the CPU; anything else launches the kernel or raises, and a kernel
  that fails to build raises.
"""

import ast
import inspect
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import replay_tpu_torch
from replay_tpu_torch.data import FeatureHint, FeatureType
from replay_tpu_torch.data.nn import TensorFeatureInfo, TensorSchema
from replay_tpu_torch.nn.compiled import CompiledInference
from replay_tpu_torch.nn.sequential import Bert4Rec, TwoTower
from replay_tpu_torch.nn.sequential.sasrec import SasRec, TiSasRec
from replay_tpu_torch.ops import build
from replay_tpu_torch.nn.loss import CE
from replay_tpu_torch.nn.train import Trainer
from replay_tpu_torch.ops import flash_attention as flash_module
from replay_tpu_torch.ops import flash_tiled as tiled_module
from replay_tpu_torch.ops import fused_ce as fused_module
from replay_tpu_torch.ops.flash_attention import flash_attention
from replay_tpu_torch.models import MIPSIndex
from replay_tpu_torch.serve import ScoringEngine, ScoringService

REPO = Path(__file__).resolve().parents[2]  # tests/_torch/ -> the repo
PORT = REPO / "replay_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "replay_tpu", "pandas")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


# the port-only scripts the tests launch as worker processes
WORKERS = (
    "tests/_torch/mesh_worker_torch.py", "tests/_torch/shard_lse_worker_torch.py", "tests/_torch/flight_kill_worker_torch.py",
)


def _sources():
    return (
        sorted(PORT.rglob("*.py"))
        + [REPO / name for name in ("chip_smoke.py", "chip_tf32_readings.py", "chip_trace_probe.py")]
        + [REPO / name for name in WORKERS]
    )


def test_importing_the_port_loads_no_jax():
    names = [m.name for m in pkgutil.walk_packages(replay_tpu_torch.__path__, "replay_tpu_torch.")]
    assert {
        "replay_tpu_torch.serve.engine", "replay_tpu_torch.nn.train", "replay_tpu_torch.ops.fused_ce",
        "replay_tpu_torch.ops.flash_tiled", "replay_tpu_torch.nn.precision", "replay_tpu_torch.nn.graphs",
        "replay_tpu_torch.nn.compiled", "replay_tpu_torch.ops.counts", "replay_tpu_torch.data.nn.prefetch",
        "replay_tpu_torch.nn.vocabulary", "replay_tpu_torch.nn.loss.bce", "replay_tpu_torch.nn.loss.sce",
        "replay_tpu_torch.nn.loss.login_ce", "replay_tpu_torch.nn.loss.logout_ce",
        "replay_tpu_torch.serve.fleet", "replay_tpu_torch.serve.remote", "replay_tpu_torch.serve.router",
        "replay_tpu_torch.obs.quality", "replay_tpu_torch.obs.report", "replay_tpu_torch.obs.federate",
        "replay_tpu_torch.obs.postmortem",
    } <= set(names)
    code = (
        "import importlib, sys\n"
        f"for name in {['replay_tpu_torch', *names]!r}:\n"
        "    importlib.import_module(name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120, check=False
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_importing_the_port_loads_no_pyarrow():
    """pyarrow is the parquet stream's, imported where it reads or writes a
    file: importing every module of the port leaves it unloaded."""
    names = [m.name for m in pkgutil.walk_packages(replay_tpu_torch.__path__, "replay_tpu_torch.")]
    assert "replay_tpu_torch.data.nn.parquet" in names
    code = (
        "import importlib, sys\n"
        f"for name in {['replay_tpu_torch', *names]!r}:\n"
        "    importlib.import_module(name)\n"
        "sys.exit(1 if 'pyarrow' in sys.modules else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120, check=False)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_pyarrow_is_imported_only_inside_functions(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    inside = {
        id(node)
        for function in ast.walk(tree)
        if isinstance(function, (ast.FunctionDef, ast.AsyncFunctionDef))
        for node in ast.walk(function)
    }
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            modules = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            modules = [node.module]
        else:
            continue
        if any(m.split(".")[0] == "pyarrow" for m in modules):
            assert id(node) in inside, f"{path}:{node.lineno} imports pyarrow at module level"


@pytest.mark.parametrize(
    "subpackage, modules",
    [
        ("obs", ("events", "trace", "collectors", "health", "profile", "mfu", "roofline", "metrics", "exporter", "slo", "blackbox")),
        ("models", ("ann", "ivf")), ("serve", ("service", "batcher", "pipeline", "promote", "quant")),
        ("nn.transform", ("transforms", "template")), ("nn.sequential.bert4rec", ("model",)),
        ("nn", ("embedding", "agg", "attention", "ffn", "remat", "train")),
        ("nn.sequential.sasrec", ("model", "transformer", "ti_model")),
        ("nn.sequential.twotower", ("model", "reader")),
        ("utils", ("checkpoint", "faults", "types", "serde", "profiling")),
        ("metrics", ("builder", "base", "descriptors", "ranking", "beyond_accuracy", "ncis", "offline_metrics")),
        ("data.nn", ("iterator", "partitioning", "ragged", "sequential_dataset", "prefetch", "sequence_tokenizer")),
        ("data.nn", ("packing", "parquet", "module", "schema_builder")),
        ("data", ("dataset", "dataset_label_encoder", "schema")),
        ("preprocessing", ("label_encoder",)),
        ("splitters", ("base", "strategies")),
        ("parallel", ("distributed", "launch", "sharding", "sharded_ce", "ring", "introspect", "mesh")),
        ("serve", ("errors", "router", "fleet", "remote")),
        ("obs", ("quality", "federate", "report", "postmortem")),
    ],
)
def test_the_rules_reach_every_subpackage(subpackage, modules):
    """The walk above and the source scan below cover the service slice's,
    the model slice's, the training lifecycle's, the data front end's, the
    offline metrics' and the serving fleet's subpackages by name, so that a
    move cannot drop them silently."""
    walked = {m.name for m in pkgutil.walk_packages(replay_tpu_torch.__path__, "replay_tpu_torch.")}
    scanned = {str(p.relative_to(REPO)) for p in _sources()}
    folder = subpackage.replace(".", "/")
    for module in modules:
        assert f"replay_tpu_torch.{subpackage}.{module}" in walked
        assert f"replay_tpu_torch/{folder}/{module}.py" in scanned
    assert f"replay_tpu_torch/{folder}/__init__.py" in scanned


def test_the_import_rule_scans_the_port_and_chip_smoke():
    """The files the import rule below reads: every module of the port and
    the smoke script, so that a wrong root cannot make it pass on nothing."""
    scanned = {str(p.relative_to(REPO)) for p in _sources()}
    assert (REPO / "chip_smoke.py").is_file() and "chip_smoke.py" in scanned
    assert all((REPO / name).is_file() and name in scanned for name in WORKERS)
    assert {
        "replay_tpu_torch/__init__.py", "replay_tpu_torch/ops/fused_ce.py", "replay_tpu_torch/ops/build.py",
        "replay_tpu_torch/nn/train.py", "replay_tpu_torch/serve/engine.py", "replay_tpu_torch/nn/graphs.py",
        "replay_tpu_torch/nn/compiled.py", "replay_tpu_torch/ops/counts.py", "replay_tpu_torch/data/nn/prefetch.py",
    } <= scanned
    assert len(scanned) > 30


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_no_source_imports_jax_or_the_jax_package(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            modules = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            modules = [node.module]
        else:
            continue
        assert not any(_forbidden(m) for m in modules), f"{path}:{node.lineno} imports {modules}"


def _schema():
    return TensorSchema(
        TensorFeatureInfo(
            "item_id", FeatureType.CATEGORICAL, is_seq=True,
            feature_hint=FeatureHint.ITEM_ID, cardinality=20, embedding_dim=8,
        )
    )


def test_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    model = SasRec(_schema(), embedding_dim=8, num_blocks=1, max_sequence_length=4, device="cpu")
    params = model.state_dict()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "SasRec": lambda **kw: SasRec(_schema(), embedding_dim=8, num_blocks=1, max_sequence_length=4, **kw),
        "CompiledInference.compile": lambda **kw: CompiledInference.compile(model, params, 4, **kw),
        "ScoringEngine": lambda **kw: ScoringEngine(model, params, **kw),
        "ScoringService": lambda **kw: ScoringService(model, params, **kw),
        "MIPSIndex": lambda **kw: MIPSIndex(np.zeros((20, 8), np.float32), **kw),
        "Trainer": lambda **kw: Trainer(model, CE(), **kw),
        "Bert4Rec": lambda **kw: Bert4Rec(_schema(), embedding_dim=8, num_blocks=1, max_sequence_length=4, **kw),
        "TwoTower": lambda **kw: TwoTower(_schema(), embedding_dim=8, num_blocks=1, max_sequence_length=4, **kw),
        "TiSasRec": lambda **kw: TiSasRec(_schema(), embedding_dim=8, num_blocks=1, max_sequence_length=4, **kw),
    }
    for name, call in calls.items():
        for kwargs in ({}, {"device": "cuda"}):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call(**kwargs)
        assert call(device="cpu") is not None, name


def _qkv_bias():
    rng = np.random.default_rng(0)
    q = torch.tensor(rng.normal(size=(2, 1, 4, 8)).astype(np.float32))
    return q, q.clone(), q.clone(), torch.zeros(2, 1, 4, 4)


@pytest.mark.parametrize("misplaced", ["bias", "q", "all"])
def test_kernel_wrapper_never_falls_back_to_the_plain_version(misplaced):
    """Tensors not all on the CPU take the kernel path, whose checks refuse a
    non-CUDA device, instead of quietly running the plain version."""
    q, k, v, bias = _qkv_bias()
    if misplaced == "bias":
        bias = bias.to("meta")
    elif misplaced == "q":
        q = q.to("meta")
    else:
        q, k, v, bias = (t.to("meta") for t in (q, k, v, bias))
    before = flash_attention.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        flash_attention(q, k, v, bias)
    assert flash_attention.launches == before


def _rows_table():
    rng = np.random.default_rng(1)
    hidden = torch.tensor(rng.normal(size=(6, 8)).astype(np.float32))
    return hidden, torch.tensor(rng.normal(size=(5, 8)).astype(np.float32)), torch.zeros(6), torch.zeros(6)


@pytest.mark.parametrize("kernel", ["fused_lse_forward", "fused_lse_dh", "fused_lse_dw"])
@pytest.mark.parametrize("misplaced", ["table", "hidden", "all"])
def test_fused_ce_wrappers_never_fall_back_to_the_plain_version(kernel, misplaced):
    hidden, table, grad, lse = _rows_table()
    if misplaced == "table":
        table = table.to("meta")
    elif misplaced == "hidden":
        hidden = hidden.to("meta")
    else:
        hidden, table, grad, lse = (t.to("meta") for t in (hidden, table, grad, lse))
    wrapper = getattr(fused_module, kernel)
    args = (hidden, table) if kernel == "fused_lse_forward" else (hidden, table, grad, lse)
    before = wrapper.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        wrapper(*args)
    assert wrapper.launches == before


@pytest.mark.parametrize("misplaced", ["bias", "q", "all"])
def test_tiled_wrapper_never_falls_back_to_the_plain_version(misplaced):
    """K5: tensors not all on the CPU take the kernel path, whose checks refuse a
    non-CUDA device, instead of quietly running the plain version."""
    q, k, v, _ = _qkv_bias()
    bias = torch.zeros(2, 4)
    if misplaced == "bias":
        bias = bias.to("meta")
    elif misplaced == "q":
        q = q.to("meta")
    else:
        q, k, v, bias = (t.to("meta") for t in (q, k, v, bias))
    before = tiled_module.flash_attention_tiled.launches
    with pytest.raises(ValueError, match="one CUDA device"):
        tiled_module.flash_attention_tiled(q, k, v, bias)
    assert tiled_module.flash_attention_tiled.launches == before


FUSED_CE_LAUNCHERS = (
    fused_module.fused_lse, fused_module.fused_lse_forward, fused_module.fused_lse_dh, fused_module.fused_lse_dw,
)


@pytest.mark.parametrize(
    "fn",
    (
        flash_module.flash_attention, flash_module._launch, flash_module._forward, *FUSED_CE_LAUNCHERS,
        tiled_module.flash_attention_tiled, tiled_module._launch, tiled_module._forward,
    ),
    ids=lambda fn: f"{fn.__module__.rsplit('.', 1)[-1]}.{fn.__name__}",
)
def test_kernel_wrapper_has_no_fallback_branch(fn):
    tree = ast.parse(inspect.getsource(fn))
    assert not any(isinstance(node, ast.Try) for node in ast.walk(tree)), fn.__name__


def test_fused_ce_raises_when_its_build_fails(tmp_path, monkeypatch):
    """A CUDA tensor reaches build.load, and a failed nvcc raises there."""
    (tmp_path / "fused_ce.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_LIBRARIES", {})
    monkeypatch.setattr(build, "find_nvcc", lambda: shutil.which("false") or "/bin/false")
    monkeypatch.setattr(fused_module, "_check", lambda *tensors: None)  # as if on the card
    hidden, table, _, _ = _rows_table()
    before = fused_module.fused_lse_forward.launches
    with pytest.raises(RuntimeError, match="nvcc failed on fused_ce.cu"):
        fused_module.fused_lse_forward(hidden.to("meta"), table.to("meta"))
    assert fused_module.fused_lse_forward.launches == before
    assert not list((tmp_path / "_build").glob("*.so"))


def test_flash_tiled_raises_when_its_build_fails(tmp_path, monkeypatch):
    """K5: a CUDA tensor reaches build.load, and a failed nvcc raises there."""
    (tmp_path / "flash_tiled.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "_LIBRARIES", {})
    monkeypatch.setattr(build, "find_nvcc", lambda: shutil.which("false") or "/bin/false")
    monkeypatch.setattr(tiled_module, "_check", lambda *tensors: None)  # as if on the card
    q, k, v, _ = _qkv_bias()
    before = tiled_module.flash_attention_tiled.launches
    with pytest.raises(RuntimeError, match="nvcc failed on flash_tiled.cu"):
        tiled_module.flash_attention_tiled(q.to("meta"), k.to("meta"), v.to("meta"), torch.zeros(2, 4, device="meta"))
    assert tiled_module.flash_attention_tiled.launches == before
    assert not list((tmp_path / "_build").glob("*.so"))


def test_a_failed_kernel_build_raises(tmp_path, monkeypatch):
    (tmp_path / "broken.cu").write_text("this is not CUDA\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(build, "find_nvcc", lambda: shutil.which("false") or "/bin/false")
    with pytest.raises(RuntimeError, match="nvcc failed on broken.cu"):
        build.load("broken")
    assert not list((tmp_path / "_build").glob("*.so"))


def test_build_names_the_library_by_source_and_flags(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    (tmp_path / "k.cu").write_text("// one\n")
    first = build.library_path("k")
    (tmp_path / "k.cu").write_text("// two\n")
    assert build.library_path("k") != first
    assert first.parent == build.BUILD_DIR and first.name.startswith("libk-")


def test_chip_smoke_refuses_to_run_without_a_gpu(tmp_path):
    """No CUDA device, or a directory holding only the script: non-zero exit and no result line."""
    script = REPO / "chip_smoke.py"
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(script.read_text())
    for path, cwd, visible in ((script, REPO, ""), (alone, tmp_path, "0")):
        proc = subprocess.run(
            [sys.executable, str(path)], cwd=cwd, capture_output=True, text=True, timeout=120,
            check=False, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": visible},
        )
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout


def test_the_lifecycle_modules_keep_the_device_rules(tmp_path):
    """The batcher stays on the host (numpy batches, which the trainer
    copies to its device), and a checkpoint restores onto its template's
    device: a CPU trainer's state stays on the CPU, and the dropout stream
    is a CPU byte tensor whatever the device."""
    from replay_tpu_torch.data.nn import SequenceBatcher, SequentialDataset

    data = SequentialDataset(_schema(), "user_id", "item_id", {"user_id": [1, 2], "item_id": [[1, 2, 3], [4]]})
    batch = next(iter(SequenceBatcher(data, batch_size=2, max_sequence_length=4)))
    assert all(isinstance(value, np.ndarray) for value in batch.values())
    trainer = Trainer(SasRec(_schema(), embedding_dim=8, num_blocks=1, max_sequence_length=4, device="cpu"), CE(), device="cpu")
    state = trainer.init_state(None)
    trainer.save_checkpoint(str(tmp_path / "ckpt"), state)
    restored = trainer.restore_checkpoint(str(tmp_path / "ckpt"), None)
    assert restored.flat_params.device.type == "cpu" and restored.rng.dtype == torch.uint8
