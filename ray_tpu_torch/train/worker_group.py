"""Gang of training worker actors inside a placement group (port of
``ray_tpu/train/worker_group.py``).

Role-equivalent of ray: python/ray/train/_internal/worker_group.py:102
(WorkerGroup, RayTrainWorker:19).  Workers are created via a placement
group so the gang reserves its hosts and cards atomically; each worker is
a process that owns its cards for its lifetime (the raylet binds
``CUDA_VISIBLE_DEVICES`` when it leases the worker).  Nothing here touches
CUDA: a worker's loop binds its card after the lease, in its own thread.
"""

from __future__ import annotations

import os
import socket
import threading
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.session import (
    TrainContext,
    TrainSession,
    init_session,
    shutdown_session,
)
from ray_tpu_torch.util import PlacementGroupSchedulingStrategy, placement_group


def actor_node_info() -> dict:
    """Topology facts WorkerGroup needs from any gang actor class —
    shared by TrainWorkerActor and the pipeline stage actors."""
    from ray_tpu_torch.core.runtime import get_runtime

    ctx = ray_tpu_torch.get_runtime_context()
    # the raylet address host is this node's reachable IP (loopback in
    # single-host tests, the real interface on a pod)
    ip = get_runtime().raylet_address.rsplit(":", 1)[0]
    return {
        "node_id": ctx.node_id,
        "hostname": socket.gethostname(),
        "ip": ip,
        "pid": os.getpid(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES", ""),
    }


@ray_tpu_torch.remote
class TrainWorkerActor:
    """One training worker process (ray: RayTrainWorker analogue)."""

    def __init__(self):
        self._session: Optional[TrainSession] = None
        self._thread: Optional[threading.Thread] = None

    # -- topology discovery ---------------------------------------------
    def node_info(self) -> dict:
        return actor_node_info()

    def set_env(self, env: Dict[str, str]) -> bool:
        os.environ.update(env)
        return True

    def execute(self, fn: Callable, *args, **kwargs):
        """Run an arbitrary function in the worker (setup hooks etc.)."""
        return fn(*args, **kwargs)

    # -- training loop lifecycle ----------------------------------------
    def start_training(
        self,
        train_fn: Callable,
        config: Dict[str, Any],
        context: TrainContext,
        latest_checkpoint: Optional[Checkpoint],
        dataset_shards: Optional[Dict[str, Any]] = None,
        start_round: int = 0,
    ) -> bool:
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("training loop already running on this worker")
        session = TrainSession(
            context, latest_checkpoint=latest_checkpoint, train_config=config,
            dataset_shards=dataset_shards, start_round=start_round,
        )
        self._session = session
        init_session(session)

        def run():
            try:
                session.result = train_fn(config)
            except BaseException as e:  # noqa: BLE001 — reported to driver
                session.error = e
            finally:
                session.finished.set()

        self._thread = threading.Thread(
            target=run, name="train-loop", daemon=True
        )
        self._thread.start()
        return True

    def next_report(self, timeout: float = 300.0) -> Optional[dict]:
        """Blocks until the loop reports, finishes (None), or errors (raises)."""
        assert self._session is not None
        return self._session.next_report(timeout)

    def finished(self) -> bool:
        return self._session is not None and self._session.finished.is_set()

    def get_result(self):
        assert self._session is not None
        self._thread.join()
        if self._session.error is not None:
            raise self._session.error
        return self._session.result

    def shutdown_training(self) -> bool:
        shutdown_session()
        return True


@dataclass
class WorkerMeta:
    actor: Any
    node_id: str
    ip: str
    rank: int
    local_rank: int
    node_rank: int


class WorkerGroup:
    """N gang actors placed atomically via one placement group.

    ``actor_cls`` defaults to TrainWorkerActor (the data-parallel train
    path); the MPMD pipeline passes its stage actor class — any
    ``@ray_tpu_torch.remote`` class exposing ``node_info()`` rides the same
    reservation + rank-assignment machinery.  ``actor_options`` merges
    into each actor's ``.options()`` (max_restarts, max_task_retries,
    on_drain, ...).
    """

    def __init__(
        self,
        num_workers: int,
        bundle: Dict[str, float],
        placement_strategy: str = "PACK",
        actor_cls=None,
        actor_options: Optional[Dict[str, Any]] = None,
    ):
        self.num_workers = num_workers
        self._actor_cls = actor_cls if actor_cls is not None else TrainWorkerActor
        self._pg = placement_group(
            [dict(bundle) for _ in range(num_workers)],
            strategy=placement_strategy,
        )
        if not self._pg.wait(timeout_seconds=120):
            from ray_tpu_torch.util import remove_placement_group

            remove_placement_group(self._pg)
            raise TimeoutError(
                f"could not reserve {num_workers} x {bundle} within 120s"
            )
        self.workers: List[WorkerMeta] = []
        # The actor's lease carries the whole bundle: the raylet binds card
        # visibility (CUDA_VISIBLE_DEVICES) from lease resources, so the
        # worker process must own its cards through its own demand.
        extra = {k: v for k, v in bundle.items() if k != "CPU"}
        actors = []
        for i in range(num_workers):
            opts = {
                "num_cpus": bundle.get("CPU", 0),
                "resources": extra or None,
                "scheduling_strategy": PlacementGroupSchedulingStrategy(
                    placement_group=self._pg,
                    placement_group_bundle_index=i,
                ),
            }
            # merge, not collide: an explicit actor_options key (e.g.
            # num_cpus) overrides the bundle-derived default
            opts.update(actor_options or {})
            actors.append(self._actor_cls.options(**opts).remote())
        # No wall-clock bound: actor startup length is unbounded under load
        # and liveness is tracked by the core (a dead worker surfaces as
        # ActorDiedError on this get).
        infos = ray_tpu_torch.get([a.node_info.remote() for a in actors])
        # Rank assignment: group workers by node; node_rank by first
        # appearance; worker 0 of node 0 hosts the process group's store
        # (MASTER_ADDR / MASTER_PORT).
        node_order: List[str] = []
        local_counts: Dict[str, int] = {}
        for i, (a, info) in enumerate(zip(actors, infos)):
            nid = info["node_id"]
            if nid not in node_order:
                node_order.append(nid)
            local_rank = local_counts.get(nid, 0)
            local_counts[nid] = local_rank + 1
            self.workers.append(
                WorkerMeta(
                    actor=a,
                    node_id=nid,
                    ip=info["ip"],
                    rank=i,
                    local_rank=local_rank,
                    node_rank=node_order.index(nid),
                )
            )

    @property
    def placement_group(self):
        return self._pg

    def execute(self, fn: Callable, *args, **kwargs) -> List[Any]:
        """Run ``fn`` on every worker, gathered (no fixed deadline — worker
        death fails the get; a slow CUDA or NCCL init is legal)."""
        return ray_tpu_torch.get(
            [w.actor.execute.remote(fn, *args, **kwargs) for w in self.workers]
        )

    def set_envs(self, envs: List[Dict[str, str]]):
        ray_tpu_torch.get(
            [
                w.actor.set_env.remote(env)
                for w, env in zip(self.workers, envs)
            ],
            timeout=120,
        )

    def shutdown(self):
        from ray_tpu_torch.util import remove_placement_group

        for w in self.workers:
            try:
                ray_tpu_torch.kill(w.actor)
            except Exception:
                pass
        remove_placement_group(self._pg)
        self.workers = []
