"""Training backends: per-framework process-group setup on the worker gang
(port of ``ray_tpu/train/backend.py``).

Role-equivalent of ray: python/ray/train/backend.py:32,16 (Backend/
BackendConfig) and train/torch/config.py:153,112 (_TorchBackend.on_start →
dist.init_process_group).  The reference wires ``jax.distributed``; here
worker 0 hosts the ``torch.distributed`` store (MASTER_ADDR / MASTER_PORT),
every worker learns its RANK and the WORLD_SIZE, and the group runs NCCL on
a worker whose lease holds a card and gloo on one whose lease holds none.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import TYPE_CHECKING, Dict, List, Optional

if TYPE_CHECKING:
    from ray_tpu_torch.train.worker_group import WorkerGroup


@dataclasses.dataclass
class BackendConfig:
    @property
    def backend_cls(self):
        return Backend


class Backend:
    """Hooks around the worker gang's lifecycle."""

    def on_start(self, worker_group: "WorkerGroup", backend_config: BackendConfig):
        pass

    def on_training_start(
        self, worker_group: "WorkerGroup", backend_config: BackendConfig
    ):
        pass

    def on_shutdown(self, worker_group: "WorkerGroup", backend_config: BackendConfig):
        pass


@dataclasses.dataclass
class TorchConfig(BackendConfig):
    """Configuration of the ``torch.distributed`` gang.

    ``master_port``: the port worker 0 binds for the group's store; 0
    (default) asks worker 0 for a free port at gang start, re-picked on
    every gang (re)start, so restarts never trip over TIME_WAIT and
    concurrent gangs on one host never collide.  ``init_distributed``: run
    ``torch.distributed.init_process_group`` on each worker at training
    start (False leaves each worker on its own, as single-worker runs and
    most CPU tests want).
    """

    master_port: int = 0
    init_distributed: bool = False

    @property
    def backend_cls(self):
        return TorchBackend


# Bounds the group's formation and its collectives, as the reference bounds
# its gang's initialisation.
_GROUP_TIMEOUT_S = 300.0
# This process's group formation (``process_group_facts``): the group is
# process-global in torch.distributed, and so are the facts of its making.
_GROUP_FACTS: Optional[dict] = None


def _torch_distributed_init() -> dict:
    """Join the gang's process group from the env ``on_start`` published:
    NCCL where this worker's lease holds a card (the raylet binds
    ``CUDA_VISIBLE_DEVICES`` from the lease, ``""`` for a lease without
    GPUs), gloo where it holds none.  A worker leased a card on which CUDA
    is unavailable raises rather than forming gloo.  An all_reduce of ones
    proves the group formed; returns what the driver checks and the seconds
    each part took."""
    global _GROUP_FACTS
    t0 = time.time()
    import torch
    import torch.distributed as dist

    t_import = time.time()
    visible = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    cuda = bool(visible)
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(
            f"this worker's lease holds a card (CUDA_VISIBLE_DEVICES="
            f"{visible!r}) but CUDA is unavailable: NCCL cannot form"
        )
    backend = "nccl" if cuda else "gloo"
    kwargs = {}
    if cuda:
        # an eager NCCL communicator on the leased card, made here rather
        # than at the loop's first collective
        kwargs["device_id"] = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(
        backend=backend,
        init_method="env://",
        world_size=int(os.environ["WORLD_SIZE"]),
        rank=int(os.environ["RANK"]),
        timeout=datetime.timedelta(seconds=_GROUP_TIMEOUT_S),
        **kwargs,
    )
    one = torch.ones((), device="cuda" if cuda else "cpu")
    dist.all_reduce(one)
    _GROUP_FACTS = {
        "backend": dist.get_backend(),
        "world_size": dist.get_world_size(),
        "rank": dist.get_rank(),
        "all_reduce": float(one),
        "import_s": t_import - t0,
        "init_s": time.time() - t_import,
        "at": time.time(),
    }
    return dict(_GROUP_FACTS)


def process_group_facts() -> Optional[dict]:
    """How this worker's process group was formed by ``TorchBackend``: its
    backend, world size and rank, the all_reduce of ones that proved it,
    and the seconds of the torch import and of ``init_process_group``
    (None where this process formed none)."""
    return None if _GROUP_FACTS is None else dict(_GROUP_FACTS)


def _torch_distributed_shutdown() -> bool:
    global _GROUP_FACTS
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _GROUP_FACTS = None
    return True


def _find_free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


class TorchBackend(Backend):
    def on_start(self, worker_group: "WorkerGroup", backend_config: TorchConfig):
        """Publish the process group's env to every worker.

        (ray: _TorchBackend picks MASTER_ADDR/PORT from worker 0 —
        train/torch/config.py:94-112.)  Resolved fresh per gang start: a
        restarted gang must not inherit a dead store's port.
        """
        master = worker_group.workers[0]
        port = backend_config.master_port
        if not port:
            import ray_tpu_torch

            port = ray_tpu_torch.get(
                master.actor.execute.remote(_find_free_port), timeout=60
            )
        n = len(worker_group.workers)
        envs: List[Dict[str, str]] = []
        for w in worker_group.workers:
            envs.append(
                {
                    "MASTER_ADDR": master.ip,
                    "MASTER_PORT": str(port),
                    "RANK": str(w.rank),
                    "WORLD_SIZE": str(n),
                    "LOCAL_RANK": str(w.local_rank),
                    "NODE_RANK": str(w.node_rank),
                }
            )
        worker_group.set_envs(envs)

    def on_training_start(
        self, worker_group: "WorkerGroup", backend_config: TorchConfig
    ):
        if not backend_config.init_distributed:
            return
        n = len(worker_group.workers)
        import ray_tpu_torch
        from ray_tpu_torch.core.errors import ActorDiedError, GetTimeoutError, TaskError
        from ray_tpu_torch.train.backend_executor import TrainWorkerGroupError

        try:
            facts = ray_tpu_torch.get(
                [w.actor.execute.remote(_torch_distributed_init)
                 for w in worker_group.workers],
                timeout=_GROUP_TIMEOUT_S + 60,
            )
        except (ActorDiedError, GetTimeoutError, TaskError) as e:
            # a gang failure, so that the trainer tears the gang down and
            # its FailureConfig decides
            raise TrainWorkerGroupError(
                f"torch.distributed gang did not form: {e}"
            ) from e
        if not all(f["world_size"] == n and f["all_reduce"] == n for f in facts):
            # surface as a gang failure so the trainer's teardown +
            # FailureConfig restart policy run (a bare RuntimeError would
            # escape fit()'s retry loop and leak the worker group)
            raise TrainWorkerGroupError(
                f"torch.distributed gang formed with a wrong world size "
                f"(expected {n}): {facts}"
            )

    def on_shutdown(self, worker_group: "WorkerGroup", backend_config: TorchConfig):
        if not backend_config.init_distributed:
            return
        import ray_tpu_torch

        ray_tpu_torch.get(
            [w.actor.execute.remote(_torch_distributed_shutdown)
             for w in worker_group.workers],
            timeout=60,
        )
