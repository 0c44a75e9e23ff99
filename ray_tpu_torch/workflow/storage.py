"""Durable workflow storage: one directory per workflow id.

Role-equivalent of ray: python/ray/workflow/workflow_storage.py — step
results and the pickled DAG live as files; writes are atomic
(tmp + rename) so a crash mid-checkpoint never leaves a half step that
resume would trust.

No device storage lands on disk: every strided ``torch.Tensor`` in the
DAG or a step's output is written as a CPU tensor (the object store's
reduction, ``common/serialization.py``), so that ``resume`` and
``get_output`` load in a process without a card.

Layout::

    <root>/<workflow_id>/
        dag.pkl            cloudpickled FunctionNode graph
        meta.json          {status, created_at, finished_at, error}
        steps/<step_id>.pkl   checkpointed step outputs
"""

from __future__ import annotations

import io
import json
import os
import pickle
import sys
import time
from typing import Any, List, Optional

import cloudpickle

from ray_tpu_torch.common.config import cfg
from ray_tpu_torch.common.serialization import _reduce_tensor

RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
CANCELED = "CANCELED"


class _HostPickler(cloudpickle.CloudPickler):
    """cloudpickle, with every strided tensor reduced to host bytes: a
    CUDA tensor pickled by torch's own reducer would keep its device."""

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")
        if (torch is not None and type(obj) is torch.Tensor
                and obj.layout == torch.strided and not obj.is_quantized):
            return _reduce_tensor(obj, torch)
        return super().reducer_override(obj)


def _dumps(obj: Any) -> bytes:
    buf = io.BytesIO()
    _HostPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    return buf.getvalue()


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class WorkflowStorage:
    def __init__(self, workflow_id: str, root: Optional[str] = None):
        self.workflow_id = workflow_id
        self.root = root or cfg.workflow_storage
        self.dir = os.path.join(self.root, workflow_id)
        self.steps_dir = os.path.join(self.dir, "steps")
        # NOTE: directories are created lazily by the write paths —
        # read-only queries of unknown ids must not pollute the root.

    # -- dag -----------------------------------------------------------

    def save_dag(self, node) -> None:
        os.makedirs(self.dir, exist_ok=True)
        _atomic_write(
            os.path.join(self.dir, "dag.pkl"), _dumps(node)
        )

    def load_dag(self):
        with open(os.path.join(self.dir, "dag.pkl"), "rb") as f:
            return pickle.loads(f.read())

    # -- meta ----------------------------------------------------------

    def save_meta(self, **updates) -> dict:
        meta = self.load_meta() or {
            "workflow_id": self.workflow_id,
            "created_at": time.time(),
        }
        meta.update(updates)
        os.makedirs(self.dir, exist_ok=True)
        _atomic_write(
            os.path.join(self.dir, "meta.json"),
            json.dumps(meta).encode(),
        )
        return meta

    def load_meta(self) -> Optional[dict]:
        try:
            with open(os.path.join(self.dir, "meta.json")) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    # -- steps ---------------------------------------------------------

    def _step_path(self, step_id: str) -> str:
        return os.path.join(self.steps_dir, step_id + ".pkl")

    def has_step(self, step_id: str) -> bool:
        return os.path.exists(self._step_path(step_id))

    def save_step(self, step_id: str, value: Any) -> None:
        os.makedirs(self.steps_dir, exist_ok=True)
        _atomic_write(self._step_path(step_id), _dumps(value))

    def load_step(self, step_id: str) -> Any:
        with open(self._step_path(step_id), "rb") as f:
            return pickle.loads(f.read())

    def completed_steps(self) -> List[str]:
        try:
            return sorted(
                f[:-4]
                for f in os.listdir(self.steps_dir)
                if f.endswith(".pkl")
            )
        except FileNotFoundError:
            return []

    def delete(self) -> None:
        import shutil

        shutil.rmtree(self.dir, ignore_errors=True)


def list_workflow_ids(root: Optional[str] = None) -> List[str]:
    root = root or cfg.workflow_storage
    try:
        return sorted(
            d
            for d in os.listdir(root)
            if os.path.isdir(os.path.join(root, d))
        )
    except FileNotFoundError:
        return []
