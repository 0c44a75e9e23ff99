"""Train configuration dataclasses (port of ``ray_tpu/train/config.py``).

Role-equivalent of ray: python/ray/air/config.py (ScalingConfig:103,
RunConfig:617, FailureConfig) and ray: python/ray/train/_checkpoint
CheckpointConfig.  Scaling is expressed in workers (processes) × GPUs per
worker, and maps onto a placement group with one bundle per worker.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

from ray_tpu_torch.common.constants import session_root


@dataclasses.dataclass
class ScalingConfig:
    """How many training workers and what each one holds.

    A worker is one process; with ``use_gpu`` it leases ``gpus_per_worker``
    cards (default 1), which the raylet binds through
    ``CUDA_VISIBLE_DEVICES`` before any of its code runs.  The runtime
    schedules no TPU: a ``"TPU"`` key in ``resources_per_worker`` raises
    here, where the config is made.
    """

    num_workers: int = 1
    use_gpu: bool = False
    gpus_per_worker: Optional[float] = None  # default: one card per worker
    cpus_per_worker: float = 1.0
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"  # workers per reference default

    def __post_init__(self):
        tpu = [k for k in (self.resources_per_worker or {})
               if k == "TPU" or k.startswith("TPU-")]
        if tpu:
            raise ValueError(
                f"resources_per_worker asks for {tpu}: the PyTorch/CUDA "
                "runtime schedules no TPU resource; use use_gpu / "
                "gpus_per_worker instead"
            )

    def bundle(self) -> Dict[str, float]:
        b = dict(self.resources_per_worker or {})
        b["CPU"] = b.get("CPU", self.cpus_per_worker)
        if self.use_gpu:
            b.setdefault("GPU", self.gpus_per_worker or 1)
        return b


@dataclasses.dataclass
class FailureConfig:
    """Gang restart policy: an SPMD group is all-or-nothing, so any worker
    failure restarts the whole group from the latest checkpoint.

    max_failures < 0 means retry forever.
    """

    max_failures: int = 0


@dataclasses.dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None  # None = keep all
    checkpoint_frequency: int = 0  # informational; loops decide when


@dataclasses.dataclass
class RunConfig:
    name: Optional[str] = None
    # default: ``results`` under the runtime's session root in the temp dir
    storage_path: Optional[str] = None
    failure_config: Optional[FailureConfig] = None
    checkpoint_config: Optional[CheckpointConfig] = None

    def resolved_storage_path(self) -> str:
        return self.storage_path or os.path.join(session_root(), "results")
