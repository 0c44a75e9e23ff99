"""Drives the worker gang through a training run (port of
``ray_tpu/train/backend_executor.py``).

Role-equivalent of ray: python/ray/train/_internal/backend_executor.py:66
(BackendExecutor — start:124, start_training:436) plus the report-polling
loop of train/trainer.py:31 (TrainingIterator).

Report flow: each round, one report is taken from EVERY worker (soft
barrier, like the reference); rank-0's metrics win; any worker's
checkpoint is persisted to run storage.  Worker failure surfaces as
TrainWorkerGroupError for the trainer's gang-restart policy.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.errors import ActorDiedError, GetTimeoutError, TaskError
from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.train.checkpoint import Checkpoint, _ckpt_round
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.session import TrainContext
from ray_tpu_torch.train.worker_group import WorkerGroup


class TrainWorkerGroupError(RuntimeError):
    """A worker died or errored; the gang must restart."""


class BackendExecutor:
    def __init__(
        self,
        backend_config: BackendConfig,
        scaling_config: ScalingConfig,
        run_config: RunConfig,
    ):
        self.backend_config = backend_config
        self.backend = backend_config.backend_cls()
        self.scaling = scaling_config
        self.run_config = run_config
        self.worker_group: Optional[WorkerGroup] = None
        self.experiment_name = run_config.name or "train_run"
        self.trial_dir = os.path.join(
            run_config.resolved_storage_path(), self.experiment_name
        )

    # -- lifecycle -------------------------------------------------------
    def start(self):
        self.worker_group = WorkerGroup(
            self.scaling.num_workers,
            self.scaling.bundle(),
            placement_strategy=self.scaling.placement_strategy,
        )
        self.backend.on_start(self.worker_group, self.backend_config)

    def shutdown(self):
        if self.worker_group is not None:
            try:
                self.backend.on_shutdown(self.worker_group, self.backend_config)
            except Exception:
                pass
            self.worker_group.shutdown()
            self.worker_group = None

    # -- training --------------------------------------------------------
    def start_training(
        self,
        train_fn: Callable[[Dict[str, Any]], Any],
        config: Dict[str, Any],
        latest_checkpoint: Optional[Checkpoint],
        datasets: Optional[Dict[str, Any]] = None,
    ):
        os.makedirs(self.trial_dir, exist_ok=True)
        # Computed ONCE, before any worker starts: every rank numbers its
        # reports from past the highest round already persisted in this
        # trial dir, so rounds stay monotonic across gang restarts and
        # consistent across ranks (see TrainSession.__init__).
        # Unreadable trial storage must surface (silently falling back to
        # round 0 would re-issue numbers an earlier attempt persisted and
        # corrupt the newest-round rescan ordering) — but as a gang error,
        # so fit()'s handler still tears the already-started workers down.
        start_round = 0
        try:
            listing = os.listdir(self.trial_dir)
        except OSError as e:
            raise TrainWorkerGroupError(
                f"trial storage unreadable: {e}"
            ) from e
        for d in listing:
            r = _ckpt_round(d)
            if r is not None and r >= start_round:
                start_round = r + 1
        self.backend.on_training_start(self.worker_group, self.backend_config)
        wg = self.worker_group
        node_count = len({w.node_id for w in wg.workers})
        local_sizes: Dict[str, int] = {}
        for w in wg.workers:
            local_sizes[w.node_id] = local_sizes.get(w.node_id, 0) + 1
        # `datasets=` ingest: each named dataset is streaming_split across
        # the gang; worker w receives split[w.rank] and reads it with
        # train.get_dataset_shard(name) (reference:
        # data_parallel_trainer.py:52-111 + dataset.py streaming_split).
        # equal=True: SPMD loops iterate in lockstep, so every worker must
        # see the same number of batches.
        shard_table: Dict[str, list] = {}
        for name, ds in (datasets or {}).items():
            shard_table[name] = ds.streaming_split(
                len(wg.workers), equal=len(wg.workers) > 1
            )
        starts = []
        for w in wg.workers:
            ctx = TrainContext(
                world_size=len(wg.workers),
                world_rank=w.rank,
                local_rank=w.local_rank,
                local_world_size=local_sizes[w.node_id],
                node_rank=w.node_rank,
                experiment_name=self.experiment_name,
                trial_dir=self.trial_dir,
            )
            shards = {
                name: splits[w.rank] for name, splits in shard_table.items()
            }
            starts.append(
                w.actor.start_training.remote(
                    train_fn, config, ctx, latest_checkpoint, shards,
                    start_round,
                )
            )
        try:
            ray_tpu_torch.get(starts)
        except (ActorDiedError, TaskError) as e:
            raise TrainWorkerGroupError(f"worker failed to start: {e}") from e

    def next_reports(self, poll_s: float = 10.0) -> Optional[List[dict]]:
        """One report from every worker, or None when all loops finished.

        Liveness-based: each worker is polled in ``poll_s`` slices with no
        overall deadline — a loop stuck in its first kernel build for minutes
        is healthy, while a dead worker fails the poll call itself with
        ActorDiedError (raised here as TrainWorkerGroupError).
        """
        wg = self.worker_group
        reports: List[Optional[dict]] = [None] * len(wg.workers)
        have: List[bool] = [False] * len(wg.workers)
        try:
            while not all(have):
                pend = [i for i in range(len(wg.workers)) if not have[i]]
                polled = ray_tpu_torch.get(
                    [
                        wg.workers[i].actor.next_report.remote(timeout=poll_s)
                        for i in pend
                    ]
                )
                for i, r in zip(pend, polled):
                    if isinstance(r, dict) and r.get("pending"):
                        continue
                    reports[i] = r
                    have[i] = True
        except ActorDiedError as e:
            raise TrainWorkerGroupError(f"worker died mid-training: {e}") from e
        except TaskError as e:
            raise TrainWorkerGroupError(f"training loop failed: {e}") from e
        except GetTimeoutError as e:
            raise TrainWorkerGroupError(f"workers unresponsive: {e}") from e
        done = [r is None for r in reports]
        if all(done):
            return None
        if any(done):
            raise TrainWorkerGroupError(
                "training loops finished out of step: some workers reported "
                "while others already returned — SPMD loops must report the "
                "same number of times"
            )
        return reports

    def finish(self) -> List[Any]:
        wg = self.worker_group
        try:
            return ray_tpu_torch.get(
                [w.actor.get_result.remote() for w in wg.workers]
            )
        except (ActorDiedError, TaskError, GetTimeoutError) as e:
            raise TrainWorkerGroupError(str(e)) from e
