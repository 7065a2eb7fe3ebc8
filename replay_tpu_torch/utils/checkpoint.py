"""Checkpoints: a training state's tensors on disk, and step-managed directories.

Counterpart of ``replay_tpu/utils/checkpoint.py``, with its layout: a
checkpoint is the state's leaves stored as one ``.npz`` (``leaf_0``,
``leaf_1``, ...) plus a JSON sidecar. The leaves of a
:class:`~replay_tpu_torch.nn.train.TrainState` come in a fixed order: ``step``,
``flat_params``, each optimizer link's tensors (the chain's order, each
link's keys in order), ``bad_steps``, ``rng``. Restoration fills a template
of the same structure (the state a fresh ``init_state`` gives), leaf by leaf,
checking shapes and dtypes, and puts each tensor on the template's device.

Crash consistency: every file is written to a ``.tmp`` sibling, fsynced and
renamed into place, so a kill mid-save leaves a stray temp file, never a
half-written visible one. The JSON sidecar lands last and is the commit
marker: :class:`CheckpointManager` treats a payload without a readable
sidecar as an aborted save and skips it on resume. The JAX package's orbax
backend (sharded multi-host saves) is not ported: ``npz`` is the only one.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

logger = logging.getLogger("replay_tpu_torch")


def _atomic_replace(path: Path, write) -> None:
    """Write via ``write(fh)`` into ``<path>.tmp``, fsync, then rename into
    place: readers only ever see an absent or a complete file."""
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as fh:
        write(fh)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _check_backend(backend: Optional[str]) -> None:
    if backend == "orbax":
        msg = "checkpoint backend 'orbax' is not ported yet: ROADMAP.md queue 1, item 9, 'Distributed training'"
        raise NotImplementedError(msg)
    if backend not in (None, "npz"):
        msg = f"Unknown checkpoint backend: {backend}"
        raise ValueError(msg)


def _is_state(tree: Any) -> bool:
    return all(hasattr(tree, name) for name in ("step", "flat_params", "opt_state", "bad_steps", "rng"))


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves of a training state, a mapping, a list or tuple, in order."""
    if _is_state(tree):
        links = [value for link in tree.opt_state for value in link.values()]
        return [tree.step, tree.flat_params, *links, tree.bad_steps, tree.rng]
    if isinstance(tree, dict):
        return [leaf for value in tree.values() for leaf in tree_leaves(value)]
    if isinstance(tree, (list, tuple)):
        return [leaf for value in tree for leaf in tree_leaves(value)]
    return [tree]


def _unflatten(template: Any, leaves: List[Any]) -> Any:
    """``template``'s structure with the next leaves taken from ``leaves``."""
    if _is_state(template):
        step = leaves.pop(0)
        flat_params = leaves.pop(0)
        opt_state = [{key: leaves.pop(0) for key in link} for link in template.opt_state]
        bad_steps, rng = leaves.pop(0), leaves.pop(0)
        return type(template)(
            step=int(step), flat_params=flat_params, params={}, opt_state=opt_state, bad_steps=bad_steps, rng=rng
        )
    if isinstance(template, dict):
        return {key: _unflatten(value, leaves) for key, value in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(value, leaves) for value in template)
    return leaves.pop(0)


def _host(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _dtype_name(leaf: Any) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return np.asarray(leaf).dtype.name


def save_pytree(path: str, tree: Any, metadata: Optional[dict] = None, backend: Optional[str] = None) -> None:
    """Write ``tree``'s leaves to ``<path>.npz`` and ``metadata`` (with
    ``num_leaves`` and ``backend``) to ``<path>.json``, the sidecar last."""
    _check_backend(backend)
    target = Path(path)
    target.parent.mkdir(parents=True, exist_ok=True)
    leaves = tree_leaves(tree)
    arrays = {f"leaf_{i}": _host(leaf) for i, leaf in enumerate(leaves)}
    _atomic_replace(target.with_suffix(".npz"), lambda fh: np.savez(fh, **arrays))
    # reserved keys win over caller metadata: restore routes on "backend"
    meta = {**(metadata or {}), "num_leaves": len(leaves), "backend": "npz"}
    _atomic_replace(target.with_suffix(".json"), lambda fh: fh.write(json.dumps(meta).encode()))


def restore_pytree(path: str, template: Any) -> Any:
    """Rebuild ``save_pytree`` output in ``template``'s structure: leaf count,
    shapes and dtypes are checked against the template's, and every tensor
    lands on its template leaf's device."""
    target = Path(path)
    with np.load(str(target.with_suffix(".npz"))) as payload:
        leaves = [payload[f"leaf_{i}"] for i in range(len(payload.files))]
    template_leaves = tree_leaves(template)
    if len(leaves) != len(template_leaves):
        msg = (
            f"Checkpoint has {len(leaves)} leaves, template expects "
            f"{len(template_leaves)} — incompatible model/optimizer config."
        )
        raise ValueError(msg)
    placed = []
    for i, (saved, expected) in enumerate(zip(leaves, template_leaves)):
        if tuple(saved.shape) != tuple(np.shape(expected)):
            msg = f"Leaf {i} shape {tuple(saved.shape)} does not match template {tuple(np.shape(expected))}."
            raise ValueError(msg)
        if saved.dtype.name != _dtype_name(expected):
            msg = (
                f"Leaf {i} dtype {saved.dtype} does not match template {_dtype_name(expected)} — "
                "checkpoint saved from a different-precision config."
            )
            raise ValueError(msg)
        if isinstance(expected, torch.Tensor):
            placed.append(torch.from_numpy(np.array(saved)).to(expected.device))
        else:
            placed.append(saved[()] if saved.ndim == 0 else saved)
    return _unflatten(template, placed)


def load_metadata(path: str) -> dict:
    return json.loads(Path(path).with_suffix(".json").read_text())


class CheckpointManager:
    """Step-numbered checkpoints with keep-last-k retention and metric history.

    Layout: ``<directory>/step_<n>.npz/.json``, ``history.json`` (the per-epoch
    records of ``Trainer.history``, surviving restarts), ``best.json`` (the
    monitored winner, kept through rotation) and ``proc_meta/`` (per-process
    sidecars). The port trains on one process, so ``process_index`` is 0
    unless given.
    """

    def __init__(self, directory: str, max_to_keep: int = 3, backend: Optional[str] = None) -> None:
        _check_backend(backend)
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.backend = backend
        # steps whose files failed the last integrity scan (see valid_steps)
        self.skipped_steps: List[int] = []

    def _step_path(self, step: int) -> Path:
        return self.directory / f"step_{step}"

    def _proc_meta_path(self, step: int, process_index: int) -> Path:
        # a subdirectory: all_steps() globs step_*.json in the root
        return self.directory / "proc_meta" / f"step_{step}.proc{process_index}.json"

    def _delete_step(self, step: int) -> None:
        self._step_path(step).with_suffix(".npz").unlink(missing_ok=True)
        self._step_path(step).with_suffix(".json").unlink(missing_ok=True)
        for proc_file in (self.directory / "proc_meta").glob(f"step_{step}.proc*.json"):
            proc_file.unlink(missing_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(int(p.stem.split("_")[1]) for p in self.directory.glob("step_*.json"))

    def metadata(self, step: int) -> dict:
        """The JSON metadata saved alongside checkpoint ``step``."""
        return load_metadata(str(self._step_path(step)))

    def process_metadata(self, step: int, process_index: Optional[int] = None) -> dict:
        """This process's private sidecar for ``step`` (``{}`` when absent or
        unreadable): where a streaming batcher's cursor rides."""
        try:
            return json.loads(self._proc_meta_path(step, process_index or 0).read_text())
        except (OSError, ValueError):
            return {}

    # -- integrity --------------------------------------------------------- #
    def _payload_ok(self, step: int) -> bool:
        """A cheap probe: the npz must open as a zip archive (a truncated
        file has no central directory and fails at once)."""
        npz = self._step_path(step).with_suffix(".npz")
        if not npz.exists():
            return False
        try:
            zipfile.ZipFile(npz).close()
            return True
        except (zipfile.BadZipFile, OSError):
            return False

    def _step_valid(self, step: int) -> bool:
        try:
            meta = self.metadata(step)
        except (OSError, ValueError):  # missing or unparseable sidecar
            return False
        return isinstance(meta, dict) and self._payload_ok(step)

    def valid_steps(self) -> List[int]:
        """``all_steps()`` less incomplete or corrupt entries, which are
        reported (a warning and :attr:`skipped_steps`) and skipped, so that a
        save cut by a preemption never breaks the next ``resume=True``."""
        good: List[int] = []
        bad: List[int] = []
        for step in self.all_steps():
            (good if self._step_valid(step) else bad).append(step)
        if bad:
            logger.warning("skipping incomplete/corrupt checkpoint step(s) %s in %s", bad, self.directory)
        self.skipped_steps = bad
        return good

    def latest_step(self) -> Optional[int]:
        steps = self.valid_steps()
        return steps[-1] if steps else None

    def save(
        self,
        step: int,
        state: Any,
        history: Optional[List[Dict[str, float]]] = None,
        metadata: Optional[dict] = None,
        process_metadata: Optional[dict] = None,
    ) -> None:
        if process_metadata is not None:
            # before the shared sidecar, which is the commit marker
            path = self._proc_meta_path(step, 0)
            path.parent.mkdir(parents=True, exist_ok=True)
            _atomic_replace(path, lambda fh: fh.write(json.dumps(process_metadata).encode()))
        save_pytree(str(self._step_path(step)), state, {"step": step, **(metadata or {})}, backend=self.backend)
        if history is not None:
            _atomic_replace(self.directory / "history.json", lambda fh: fh.write(json.dumps(history).encode()))
        protected = self.best_step()
        for old in self.all_steps()[: -self.max_to_keep]:
            if old == protected:  # the monitored winner survives rotation
                continue
            self._delete_step(old)

    # -- monitored-best tracking ------------------------------------------- #
    def mark_best(self, step: int) -> None:
        """Record ``step`` as the monitored winner (survives rotation)."""
        _atomic_replace(self.directory / "best.json", lambda fh: fh.write(json.dumps({"step": step}).encode()))

    def best_step(self) -> Optional[int]:
        path = self.directory / "best.json"
        if not path.exists():
            return None
        step = json.loads(path.read_text())["step"]
        # a best.json pointing at a deleted or corrupt step is stale, not fatal
        return step if self._step_valid(step) else None

    def restore_best(self, template: Any) -> Any:
        """Restore the monitored-best checkpoint (else the latest)."""
        return self.restore(template, step=self.best_step())

    def restore(self, template: Any, step: Optional[int] = None) -> Any:
        """Restore checkpoint ``step`` (default: the latest valid one). A
        corrupt sidecar, a leaf-count mismatch or a truncated payload raise a
        ``ValueError`` naming the step."""
        step = step if step is not None else self.latest_step()
        if step is None:
            msg = f"No checkpoints found in {self.directory}"
            raise FileNotFoundError(msg)
        path = self._step_path(step)
        try:
            meta = load_metadata(str(path))
        except FileNotFoundError:
            msg = f"Checkpoint step_{step} not found in {self.directory}"
            raise FileNotFoundError(msg) from None
        except (OSError, ValueError) as exc:
            msg = (
                f"Checkpoint step_{step} in {self.directory} has an unreadable "
                f"metadata sidecar ({exc}) — the save was likely interrupted; "
                "delete the step files or restore an earlier step."
            )
            raise ValueError(msg) from exc
        num_leaves = meta.get("num_leaves") if isinstance(meta, dict) else None
        expected = len(tree_leaves(template))
        if num_leaves is not None and num_leaves != expected:
            msg = (
                f"Checkpoint step_{step} records num_leaves={num_leaves} but the "
                f"template has {expected} leaves — saved from an incompatible "
                "model/optimizer config."
            )
            raise ValueError(msg)
        try:
            return restore_pytree(str(path), template)
        except (zipfile.BadZipFile, EOFError, KeyError, OSError) as exc:
            msg = (
                f"Checkpoint step_{step} in {self.directory} is corrupt or "
                f"incomplete ({type(exc).__name__}: {exc}); delete it or "
                "restore an earlier step."
            )
            raise ValueError(msg) from exc

    def history(self) -> List[Dict[str, float]]:
        path = self.directory / "history.json"
        return json.loads(path.read_text()) if path.exists() else []

    def delete(self) -> None:
        shutil.rmtree(self.directory, ignore_errors=True)
