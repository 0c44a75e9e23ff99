"""Checkpoint handle: a directory of files, wherever it lives (port of
``ray_tpu/train/checkpoint.py``).

Role-equivalent of ray: python/ray/train/_checkpoint.py:56 (Checkpoint) and
the storage layer (train/_internal/storage.py:349), collapsed to a
filesystem-path abstraction: a cluster mounts shared storage (NFS, a
fuse mount), so "upload" is a directory copy and restore is a path.

Model and optimizer state go through ``from_state_dict`` /
``to_state_dict`` (torch); `from_dict` / `to_dict` cover small
python-object checkpoints (pickle).  Importing this module loads no torch.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import shutil
import tempfile
import uuid
from typing import Any, Dict, Optional

_DICT_FILE = "_dict_checkpoint.pkl"
_STATE_FILE = "state_dict.pt"
# Metrics persisted beside the state by Session.report(); read back by the
# trainer when a gang restart rescans storage that ran ahead of the driver.
_METRICS_FILE = "_report_metrics.pkl"


def _ckpt_round(path: str) -> Optional[int]:
    """Report round parsed from a trainer-issued
    ``checkpoint_{round}_rank{rank}`` dir name; None for foreign names
    (user-made, resume_from, or default uuid-suffixed ``persist()`` dirs
    — the rank segment is required so an all-digit uuid prefix can't
    masquerade as a round)."""
    parts = os.path.basename(path.rstrip("/")).split("_")
    if (
        len(parts) >= 3
        and parts[0] == "checkpoint"
        and parts[2].startswith("rank")
    ):
        try:
            return int(parts[1])
        except ValueError:
            return None
    return None


def _atomic_write(path: str, blob: bytes) -> None:
    """tmp + fsync + rename (same shape as workflow/storage.py): durable
    files must never be readable half-written."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _write_metrics_sidecar(ckpt_path: str, metrics: Dict[str, Any]) -> None:
    """Best-effort: written AFTER persist() returns, so its presence also
    marks the checkpoint directory as completely persisted.  Serialized
    before any file exists and moved in atomically — a pickling error or
    mid-write crash must not leave a truncated sidecar that wins the
    completeness tie-break while being unreadable."""
    try:
        _atomic_write(
            os.path.join(ckpt_path, _METRICS_FILE),
            pickle.dumps(dict(metrics)),
        )
    except Exception:
        pass  # unpicklable metrics must not fail report()


def _read_metrics_sidecar(ckpt_path: str) -> Optional[Dict[str, Any]]:
    p = os.path.join(ckpt_path, _METRICS_FILE)
    if not os.path.exists(p):
        return None
    try:
        with open(p, "rb") as f:
            return pickle.load(f)
    except Exception:
        return None


def _fill(template: Any, loaded: Any, where: str, torch) -> Any:
    """``loaded`` copied into ``template``'s tensors in place, structure
    checked on the way (``Checkpoint.to_state_dict``)."""
    if isinstance(template, torch.Tensor):
        if not isinstance(loaded, torch.Tensor):
            raise ValueError(f"{where}: a tensor in the template, {type(loaded).__name__} saved")
        if loaded.shape != template.shape or loaded.dtype != template.dtype:
            raise ValueError(
                f"{where}: saved {tuple(loaded.shape)} {loaded.dtype}, template "
                f"{tuple(template.shape)} {template.dtype}"
            )
        template.copy_(loaded)
        return template
    if isinstance(template, dict):
        if not isinstance(loaded, dict) or set(loaded) != set(template):
            raise ValueError(f"{where}: keys differ from the template's")
        for k in template:
            template[k] = _fill(template[k], loaded[k], f"{where}[{k!r}]", torch)
        return template
    if isinstance(template, (list, tuple)):
        if not isinstance(loaded, (list, tuple)) or len(loaded) != len(template):
            raise ValueError(f"{where}: length differs from the template's")
        out = [_fill(t, v, f"{where}[{i}]", torch) for i, (t, v) in enumerate(zip(template, loaded))]
        if isinstance(template, list):
            template[:] = out
            return template
        return type(template)(out)
    return loaded


class Checkpoint:
    """Handle to a checkpoint directory.

    ``_temp=True`` marks a scratch directory owned by this handle:
    ``persist()`` *moves* it into run storage instead of copying, so
    per-step ``from_dict`` checkpoints don't accumulate in /tmp.
    """

    def __init__(self, path: str, _temp: bool = False):
        self.path = os.path.abspath(path)
        self._temp = _temp

    # -- constructors ----------------------------------------------------
    @classmethod
    def from_directory(cls, path: str) -> "Checkpoint":
        return cls(path)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        d = tempfile.mkdtemp(prefix="rt_ckpt_")
        # atomic even inside the fresh scratch dir: persist() may later
        # shutil.move() it across filesystems (copy, not rename), and
        # recovery must never see a truncated pickle win a completeness
        # tie-break
        _atomic_write(os.path.join(d, _DICT_FILE), pickle.dumps(data))
        return cls(d, _temp=True)

    # -- accessors -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        p = os.path.join(self.path, _DICT_FILE)
        if not os.path.exists(p):
            raise ValueError(
                f"checkpoint at {self.path} was not created with from_dict"
            )
        with open(p, "rb") as f:
            return pickle.load(f)

    def to_directory(self, path: Optional[str] = None) -> str:
        """Copy the checkpoint into ``path`` (or a fresh temp dir)."""
        dest = path or tempfile.mkdtemp(prefix="rt_ckpt_")
        os.makedirs(dest, exist_ok=True)
        shutil.copytree(self.path, dest, dirs_exist_ok=True)
        return dest

    @contextlib.contextmanager
    def as_directory(self):
        """Local read access without copying (path is already local/mounted)."""
        yield self.path

    def persist(self, storage_dir: str, name: Optional[str] = None) -> "Checkpoint":
        """Move/copy into run storage and return the durable handle.

        Scratch checkpoints (from_dict) are moved; user-owned directories
        are copied.
        """
        name = name or f"checkpoint_{uuid.uuid4().hex[:8]}"
        dest = os.path.join(storage_dir, name)
        if os.path.abspath(self.path) == os.path.abspath(dest):
            return self
        os.makedirs(storage_dir, exist_ok=True)
        if self._temp and not os.path.exists(dest):
            shutil.move(self.path, dest)
        else:
            shutil.copytree(self.path, dest, dirs_exist_ok=True)
            if self._temp:
                shutil.rmtree(self.path, ignore_errors=True)
        return Checkpoint(dest)

    # -- torch state dicts ------------------------------------------------
    @classmethod
    def from_state_dict(cls, state_dict: Any) -> "Checkpoint":
        """Save a state dict (a model's, an optimizer's, or a dict of
        them; tensors on any device, nested dicts, lists and plain values)
        as one ``torch.save`` file, written atomically.

        ``torch.distributed.checkpoint`` restores only into a template in
        torch 2.11 (its template-free load is private) and flattens an
        optimizer state's integer keys into strings, so the file is a
        plain ``torch.save``; the sharded state of a multi-GPU mesh will
        need the distributed format."""
        import torch

        d = tempfile.mkdtemp(prefix="rt_ckpt_")
        path = os.path.join(d, _STATE_FILE)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            torch.save(state_dict, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        return cls(d, _temp=True)

    def to_state_dict(self, template: Any = None) -> Any:
        """Load a state dict saved by ``from_state_dict``.

        Without ``template`` every tensor comes back on the CPU, bit for
        bit.  With one (a structure of the same keys, such as
        ``model.state_dict()``), each of its tensors is filled in place on
        its own device and the template is returned; a key, shape or dtype
        that differs raises ``ValueError``."""
        import torch

        path = os.path.join(self.path, _STATE_FILE)
        if not os.path.exists(path):
            raise ValueError(
                f"checkpoint at {self.path} was not created with from_state_dict"
            )
        loaded = torch.load(path, map_location="cpu", weights_only=True,
                            mmap=template is not None)
        if template is None:
            return loaded
        with torch.no_grad():
            return _fill(template, loaded, "state_dict", torch)

    def __repr__(self):
        return f"Checkpoint({self.path})"

    def __reduce__(self):
        return (Checkpoint, (self.path,))
