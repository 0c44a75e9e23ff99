"""GPU detection for the node's resources.

The counterpart of ``ray_tpu/accelerators/tpu.py``: it gives the raylet the
node's ``GPU`` count and a kind tag resource (``GPU-H100``, as the reference
advertises ``TPU-<gen>``).  It never imports torch and never starts CUDA:
it runs in the driver before the control plane starts, and a process that
initialised CUDA would hold a context on every card.  Cards are assigned to
leases by the raylet (``core/raylet.py`` ``_accel_env_for``).

Detection, in order: the ``gpu_count_override`` knob (``RT_GPU_COUNT_OVERRIDE``),
the driver's ``/proc/driver/nvidia/gpus/*`` entries, ``nvidia-smi``, and
otherwise zero.  A ``CUDA_VISIBLE_DEVICES`` already set limits what is
found to the cards it names.
"""

from __future__ import annotations

import glob
import os
import re
import shutil
import subprocess
from typing import Dict, List, Optional

from ray_tpu_torch.common.config import cfg

GPU_RESOURCE = "GPU"


def visible_devices() -> Optional[List[str]]:
    """The entries of ``CUDA_VISIBLE_DEVICES``, or None when it is unset
    (every card is visible)."""
    v = os.environ.get("CUDA_VISIBLE_DEVICES")
    if v is None:
        return None
    return [x.strip() for x in v.split(",") if x.strip()]


class GPUAcceleratorManager:
    """Detects the node's NVIDIA GPUs and derives its GPU resources."""

    def __init__(self):
        self._count: Optional[int] = None
        self._names: List[str] = []

    def num_gpus(self) -> int:
        if self._count is None:
            self._count = self._detect()
        return self._count

    def _detect(self) -> int:
        if cfg.gpu_count_override >= 0:
            return cfg.gpu_count_override
        self._names = _proc_names() or _smi_names()
        n = len(self._names)
        visible = visible_devices()
        return n if visible is None else min(n, len(visible))

    def kind(self) -> Optional[str]:
        """The kind tag of the first card (``H100`` for an "NVIDIA H100
        80GB HBM3"), or None when nothing was detected."""
        self.num_gpus()
        return _kind_tag(self._names[0]) if self._names else None

    def extra_resources(self) -> Dict[str, float]:
        """``GPU-<kind>``: the kind-tagged card count."""
        n, kind = self.num_gpus(), self.kind()
        return {f"GPU-{kind}": float(n)} if n and kind else {}


def _proc_names() -> List[str]:
    """Model names from the driver's ``/proc`` entries, one per card."""
    names = []
    for d in sorted(glob.glob("/proc/driver/nvidia/gpus/*")):
        model = ""
        try:
            with open(os.path.join(d, "information")) as f:
                for line in f:
                    if line.startswith("Model:"):
                        model = line.split(":", 1)[1].strip()
                        break
        except OSError:
            pass
        names.append(model)
    return names


def _smi_names() -> List[str]:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return []
    try:
        out = subprocess.run(
            [smi, "--query-gpu=name", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20,
        )
    except (OSError, subprocess.TimeoutExpired):
        return []
    if out.returncode != 0:
        return []
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]


def _kind_tag(name: str) -> Optional[str]:
    """"NVIDIA H100 80GB HBM3" -> "H100"; "NVIDIA L40S" -> "L40S"."""
    m = re.search(r"\b([A-Z]+\d+[A-Z]*)\b", name)
    if m:
        return m.group(1)
    tag = name.replace("NVIDIA", "").strip().replace(" ", "-")
    return tag or None
