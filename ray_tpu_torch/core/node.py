"""Node bring-up: spawn GCS and raylet processes for a head or worker node.

Role-equivalent of ray: python/ray/_private/node.py:37 and services.py
(start_gcs_server:1432, start_raylet:1496).
"""

from __future__ import annotations

import atexit
import json
import os
import subprocess
import sys
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ray_tpu_torch.common.constants import session_root
from ray_tpu_torch.common.ids import NodeID


def _read_tagged_line(proc: subprocess.Popen, tag: str, timeout: float) -> str:
    """Read lines from proc stdout until `tag=` appears."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            raise RuntimeError(
                f"process exited (code {proc.returncode}) before reporting {tag}"
            )
        line = proc.stdout.readline()
        if not line:
            time.sleep(0.01)
            continue
        line = line.decode() if isinstance(line, bytes) else line
        if line.startswith(tag + "="):
            return line.strip().split("=", 1)[1]
    raise TimeoutError(f"timed out waiting for {tag} from subprocess")


def default_session_dir() -> str:
    return os.path.join(
        session_root(), f"session_{time.strftime('%Y%m%d-%H%M%S')}_{os.getpid()}"
    )


@dataclass
class NodeProcessGroup:
    """Handles to the subprocesses composing one logical node (plus the GCS
    when this is the head)."""

    session_dir: str
    gcs_address: str
    raylet_address: str
    node_id: str
    store_path: str
    gcs_proc: Optional[subprocess.Popen] = None
    raylet_proc: Optional[subprocess.Popen] = None

    def kill(self):
        for proc in (self.raylet_proc, self.gcs_proc):
            if proc is not None and proc.poll() is None:
                proc.terminate()
        for proc in (self.raylet_proc, self.gcs_proc):
            if proc is not None:
                try:
                    proc.wait(timeout=3)
                except subprocess.TimeoutExpired:
                    proc.kill()


def start_gcs(session_dir: str, host: str = "127.0.0.1", port: int = 0) -> tuple:
    os.makedirs(session_dir, exist_ok=True)
    log = open(os.path.join(session_dir, "gcs.log"), "ab")
    proc = subprocess.Popen(
        [
            sys.executable, "-m", "ray_tpu_torch.core.gcs",
            "--host", host, "--port", str(port),
            "--session-dir", session_dir,
        ],
        stdout=subprocess.PIPE,
        stderr=log,
        env=_control_plane_env(),
    )
    log.close()
    address = _read_tagged_line(proc, "GCS_ADDRESS", 30)
    return proc, address


def start_raylet(
    gcs_address: str,
    session_dir: str,
    resources: Dict[str, float],
    labels: Optional[Dict[str, str]] = None,
    host: str = "127.0.0.1",
    store_capacity: int = 0,
    node_id: Optional[str] = None,
    extra_env: Optional[Dict[str, str]] = None,
) -> tuple:
    os.makedirs(session_dir, exist_ok=True)
    log = open(os.path.join(session_dir, "raylet.log"), "ab")
    cmd = [
        sys.executable,
        "-m",
        "ray_tpu_torch.core.raylet",
        "--gcs", gcs_address,
        "--host", host,
        "--resources", json.dumps(resources),
        "--labels", json.dumps(labels or {}),
        "--store-capacity", str(store_capacity),
        "--session-dir", session_dir,
    ]
    if node_id:
        cmd += ["--node-id", node_id]
    env = _control_plane_env()
    if extra_env:
        # node identity for the raylet and its workers
        env.update(extra_env)
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=log, env=env
    )
    log.close()
    address = _read_tagged_line(proc, "RAYLET_ADDRESS", 60)
    nid = _read_tagged_line(proc, "RAYLET_NODE_ID", 10)
    store_path = f"/dev/shm/rt_store_{nid[:12]}"
    return proc, address, nid, store_path


def _pythonpath_with_pkg() -> str:
    """PYTHONPATH that lets subprocesses import ray_tpu_torch even when the driver
    added the repo to sys.path manually."""
    import ray_tpu_torch

    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)))
    existing = os.environ.get("PYTHONPATH", "")
    parts = [pkg_root] + ([existing] if existing else [])
    return os.pathsep.join(parts)


#: The driver's CUDA_VISIBLE_DEVICES, recorded for the raylet: lease index
#: k names the k-th entry of this set (raylet ``_accel_env_for``).  Unset
#: when the driver had none, and then index k is card k.
GPU_SET_ENV = "RT_GPU_VISIBLE_DEVICES"


def _control_plane_env() -> dict:
    """Control-plane processes must never touch a GPU (a CUDA context holds
    memory on every card it sees): the GCS and the raylet, and the workers
    the raylet spawns until a lease binds them, run with
    ``CUDA_VISIBLE_DEVICES=""``.  The driver's own visible set is kept in
    ``RT_GPU_VISIBLE_DEVICES`` so that leases can name its cards."""
    env = dict(os.environ)
    if GPU_SET_ENV not in env and "CUDA_VISIBLE_DEVICES" in env:
        env[GPU_SET_ENV] = env["CUDA_VISIBLE_DEVICES"]
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = _pythonpath_with_pkg()
    return env


def detect_resources(num_cpus=None, num_gpus=None, extra=None) -> Dict[str, float]:
    """The head node's resources.  ``num_gpus=None`` detects the cards
    (accelerators/gpu.py); a count given or detected must not exceed the
    cards that the driver's ``CUDA_VISIBLE_DEVICES`` names, since each
    lease is given one of them."""
    from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager, visible_devices

    res: Dict[str, float] = dict(extra or {})
    res["CPU"] = num_cpus if num_cpus is not None else float(os.cpu_count() or 1)
    if num_gpus is None:
        mgr = GPUAcceleratorManager()
        num_gpus = mgr.num_gpus()
        if num_gpus:
            res.update(mgr.extra_resources())
    visible = visible_devices()
    if num_gpus and visible is not None and len(visible) < num_gpus:
        raise ValueError(
            f"{num_gpus} GPUs asked for, but CUDA_VISIBLE_DEVICES="
            f"{os.environ['CUDA_VISIBLE_DEVICES']!r} names {len(visible)}"
        )
    if num_gpus:
        res["GPU"] = num_gpus
    res.setdefault("memory", float(_total_memory_bytes()))
    return res


def _total_memory_bytes() -> int:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 8 << 30
