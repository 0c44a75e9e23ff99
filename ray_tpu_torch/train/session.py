"""Per-worker training session: the worker↔driver reporting channel (port
of ``ray_tpu/train/session.py``).

Role-equivalent of ray: python/ray/train/_internal/session.py:110
(_TrainSession, report:402) and train/context.py:80 (TrainContext).

The user's ``train_loop_per_worker`` runs on a thread inside the train
worker actor; ``report()`` enqueues (metrics, checkpoint) and, like the
reference, acts as a soft barrier — the driver consumes one report per
round from every worker before continuing, keeping SPMD workers in step.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint, _write_metrics_sidecar

_session_lock = threading.Lock()
_session: Optional["TrainSession"] = None


@dataclasses.dataclass
class TrainContext:
    world_size: int
    world_rank: int
    local_rank: int
    local_world_size: int
    node_rank: int
    experiment_name: str
    trial_dir: str

    def get_world_size(self) -> int:
        return self.world_size

    def get_world_rank(self) -> int:
        return self.world_rank

    def get_local_rank(self) -> int:
        return self.local_rank

    def get_local_world_size(self) -> int:
        return self.local_world_size

    def get_node_rank(self) -> int:
        return self.node_rank

    def get_experiment_name(self) -> str:
        return self.experiment_name

    def get_trial_dir(self) -> str:
        return self.trial_dir


class TrainSession:
    def __init__(
        self,
        context: TrainContext,
        latest_checkpoint: Optional[Checkpoint] = None,
        train_config: Optional[Dict[str, Any]] = None,
        dataset_shards: Optional[Dict[str, Any]] = None,
        start_round: int = 0,
    ):
        self.context = context
        self.train_config = train_config or {}
        self.latest_checkpoint = latest_checkpoint
        self.dataset_shards = dataset_shards or {}
        self.reports: "queue.Queue" = queue.Queue()
        self.finished = threading.Event()
        self.error: Optional[BaseException] = None
        self.result: Any = None
        # Rounds stay monotonic ACROSS gang restarts into the same trial
        # dir: a fresh attempt must not re-issue round numbers an earlier
        # attempt already persisted, or the trainer's newest-round rescan
        # would prefer a stale pre-restart checkpoint.  The driver computes
        # the start round ONCE before dispatching the gang (a per-worker
        # directory scan here would race with fast peers' first persists
        # and desynchronize round numbers across ranks).
        self._report_idx = start_round

    # -- worker-side API -------------------------------------------------
    def report(
        self, metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None
    ):
        """Persist the checkpoint, enqueue the report, and block until the
        driver consumes it.

        Durability is worker-side (reference semantics: the worker uploads
        via its StorageContext, train/_internal/storage.py:349): the
        checkpoint hits run storage BEFORE report() returns, so a crash at
        any later point can never lose it.  The post-enqueue block is the
        pacing barrier — the loop cannot sprint ahead of the driver.
        """
        if checkpoint is not None:
            checkpoint = checkpoint.persist(
                self.context.trial_dir,
                name=(
                    f"checkpoint_{self._report_idx:06d}"
                    f"_rank{self.context.world_rank:05d}"
                ),
            )
            self.latest_checkpoint = checkpoint
            # Metrics sidecar: a gang restart can rescan a checkpoint the
            # driver never saw the report for (this worker is acked for
            # round k, a peer dies in the same round, and this worker
            # persists round k+1 before the teardown lands).  Persisting
            # the metrics beside the state lets the trainer keep
            # Result.metrics consistent with Result.checkpoint.
            _write_metrics_sidecar(checkpoint.path, metrics)
        self._report_idx += 1
        self.reports.put({"metrics": dict(metrics), "checkpoint": checkpoint})
        self.reports.join()

    def get_checkpoint(self) -> Optional[Checkpoint]:
        return self.latest_checkpoint

    # -- executor-side API ----------------------------------------------
    def next_report(self, timeout: float) -> Optional[dict]:
        """Next report, None if the loop finished (raising its error), or
        the sentinel ``{"pending": True}`` if nothing arrived within
        ``timeout``.

        The sentinel (not an exception) is deliberate: how long a loop may
        go without reporting is unbounded — the first report sits behind an
        kernel build that can take minutes — so the driver polls in short
        slices and relies on actor liveness (worker death fails the poll
        call itself) rather than any fixed report deadline."""
        while True:
            try:
                item = self.reports.get(timeout=min(timeout, 0.2))
                self.reports.task_done()  # unblocks the reporting loop
                return item
            except queue.Empty:
                if self.finished.is_set() and self.reports.empty():
                    if self.error is not None:
                        raise self.error
                    return None
                timeout -= 0.2
                if timeout <= 0:
                    return {"pending": True}


def init_session(session: TrainSession) -> None:
    global _session
    with _session_lock:
        _session = session


def shutdown_session() -> None:
    global _session
    with _session_lock:
        _session = None


def get_session() -> TrainSession:
    if _session is None:
        raise RuntimeError(
            "No training session active; this API must be called from inside "
            "a train_loop_per_worker"
        )
    return _session


# -- module-level user API (ray: train/_internal/session.py:666+) ---------


def report(metrics: Dict[str, Any], checkpoint: Optional[Checkpoint] = None):
    get_session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return get_session().get_checkpoint()


def get_context() -> TrainContext:
    return get_session().context


def get_dataset_shard(name: str = "train"):
    """This worker's DataIterator for the trainer's `datasets[name]`
    (reference: ray.train.get_dataset_shard, fed by streaming_split in
    data_parallel_trainer.py:52-111)."""
    shards = get_session().dataset_shards
    if name not in shards:
        raise KeyError(
            f"no dataset shard {name!r}: pass datasets={{{name!r}: ds}} to "
            f"TorchTrainer (available: {sorted(shards)})"
        )
    return shards[name]
