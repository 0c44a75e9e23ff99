"""TorchTrainer: fit() a train_loop_per_worker across a worker gang (port of
``ray_tpu/train/trainer.py``, whose ``JaxTrainer`` it replaces; upstream
Ray's name).

Role-equivalent of ray: python/ray/train/data_parallel_trainer.py:25
(DataParallelTrainer — training_loop:428) + base_trainer.py:567 (fit).
The reference routes fit() through a Tune trial; here the trainer runs
the gang directly and tune-lite wraps *it* (the layering inverted on
purpose — the SPMD gang is the primitive, HPO is a consumer).

Gang failure policy: any worker death restarts the WHOLE group from the
latest persisted checkpoint (FailureConfig.max_failures), matching SPMD
reality — a process group cannot lose one participant.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.train.backend import BackendConfig, TorchConfig
from ray_tpu_torch.train.backend_executor import (
    BackendExecutor,
    TrainWorkerGroupError,
)
from ray_tpu_torch.train.checkpoint import (
    _METRICS_FILE,
    Checkpoint,
    _ckpt_round,
    _read_metrics_sidecar,
)
from ray_tpu_torch.train.config import FailureConfig, RunConfig, ScalingConfig


@dataclasses.dataclass
class Result:
    """Outcome of a run (ray: python/ray/air/result.py Result)."""

    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint]
    path: str
    metrics_dataframe: Optional[List[Dict[str, Any]]] = None
    error: Optional[BaseException] = None


class TorchTrainer:
    def __init__(
        self,
        train_loop_per_worker: Callable[[Dict[str, Any]], Any],
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        backend_config: Optional[BackendConfig] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        datasets: Optional[Dict[str, Any]] = None,
    ):
        self._train_fn = train_loop_per_worker
        self._config = dict(train_loop_config or {})
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.backend_config = backend_config or TorchConfig()
        self._resume_from = resume_from_checkpoint
        # Data ingest (reference: data_parallel_trainer.py:52-111
        # `datasets=` → per-worker streaming_split shards surfaced in the
        # loop via train.get_dataset_shard)
        self._datasets = dict(datasets or {})

    def fit(self) -> Result:
        failure = self.run_config.failure_config or FailureConfig()
        failures_left = failure.max_failures
        latest_checkpoint = self._resume_from
        history: List[Dict[str, Any]] = []
        last_metrics: Dict[str, Any] = {}
        executor = BackendExecutor(
            self.backend_config, self.scaling_config, self.run_config
        )
        while True:
            try:
                executor.start()
                executor.start_training(
                    self._train_fn, self._config, latest_checkpoint,
                    datasets=self._datasets,
                )
                while True:
                    reports = executor.next_reports()
                    if reports is None:
                        break
                    # rank 0's metrics are canonical (reference semantics)
                    last_metrics = reports[0]["metrics"]
                    last_metrics.setdefault("_timestamp", time.time())
                    history.append(dict(last_metrics))
                    # checkpoints were already persisted worker-side;
                    # just track the newest handle
                    ckpt = next(
                        (
                            r["checkpoint"]
                            for r in reports
                            if r["checkpoint"] is not None
                        ),
                        None,
                    )
                    if ckpt is not None:
                        latest_checkpoint = ckpt
                        self._prune_checkpoints(executor.trial_dir)
                executor.finish()
                executor.shutdown()
                return Result(
                    metrics=last_metrics,
                    checkpoint=latest_checkpoint,
                    path=executor.trial_dir,
                    metrics_dataframe=history,
                )
            except (TrainWorkerGroupError, TimeoutError) as e:
                # TimeoutError covers placement-group reservation failure;
                # the executor maps worker/get failures (incl. driver-side
                # get timeouts) to TrainWorkerGroupError.  Either way the
                # gang is torn down before deciding to retry or surface.
                executor.shutdown()
                # shutdown() returns before worker processes finish their
                # short exit grace, during which a survivor may still be
                # completing its final persist — wait for the trial dir
                # listing to go quiescent before rescanning.
                def _snapshot() -> Optional[List]:
                    # dir names AND their sidecar presence: a survivor's
                    # final act is the sidecar write inside an already-
                    # listed dir, which a name-only listing can't see
                    try:
                        td = executor.trial_dir
                        if not os.path.isdir(td):
                            return []
                        return sorted(
                            (
                                d,
                                os.path.exists(
                                    os.path.join(td, d, _METRICS_FILE)
                                ),
                            )
                            for d in os.listdir(td)
                        )
                    except OSError:
                        return None

                prev = None
                for _ in range(8):
                    cur = _snapshot()
                    if cur is None or cur == prev:
                        break
                    prev = cur
                    time.sleep(0.25)
                # Workers persist checkpoints before report() returns, so
                # storage may be ahead of the last handle the driver saw —
                # rescan and take the newest.  When it IS ahead, also adopt
                # its metrics sidecar so metrics match the checkpoint: this
                # holds for BOTH the retry (the resumed loop starts past
                # that step and may report nothing new) and the terminal
                # Result below (its checkpoint must be the newest too).
                rescanned = self._latest_persisted(executor.trial_dir)
                if rescanned is not None:
                    # `seen` counts only checkpoints of THIS trial: a
                    # resume_from_checkpoint handle into some other run's
                    # dir may parse to an arbitrary round and must not
                    # suppress sidecar adoption here.
                    seen = None
                    if latest_checkpoint is not None and os.path.realpath(
                        os.path.dirname(latest_checkpoint.path)
                    ) == os.path.realpath(executor.trial_dir):
                        seen = _ckpt_round(latest_checkpoint.path)
                    found = _ckpt_round(rescanned.path)
                    if found is not None and (seen is None or found > seen):
                        side = _read_metrics_sidecar(rescanned.path)
                        if side is not None:
                            last_metrics = side
                            last_metrics.setdefault(
                                "_timestamp", time.time()
                            )
                            history.append(dict(last_metrics))
                    # Never move the resume point backwards OR sideways:
                    # the verified-round fallback can return an older
                    # round than the driver consumed (newest sidecar write
                    # failed), and at equal rounds the rescan may have
                    # picked a different rank's partial dir — the driver's
                    # known-good handle wins unless storage is strictly
                    # newer.
                    if seen is None or (found is not None and found > seen):
                        latest_checkpoint = rescanned
                if failures_left == 0:
                    return Result(
                        metrics=last_metrics,
                        checkpoint=latest_checkpoint,
                        path=executor.trial_dir,
                        metrics_dataframe=history,
                        error=e,
                    )
                if failures_left > 0:
                    failures_left -= 1

    def _latest_persisted(self, trial_dir: str) -> Optional[Checkpoint]:
        if not os.path.isdir(trial_dir):
            return None
        ckpts = sorted(
            d for d in os.listdir(trial_dir) if d.startswith("checkpoint_")
        )
        if not ckpts:
            return None
        rounds = [_ckpt_round(d) for d in ckpts]
        top = max((r for r in rounds if r is not None), default=None)
        if top is None:
            return Checkpoint(os.path.join(trial_dir, ckpts[-1]))
        # Newest VERIFIED round wins: the metrics sidecar is written after
        # persist() completes, so it marks a directory as fully persisted
        # (a rank that died mid-persist leaves none).  A sole partial dir
        # in the top round must not shadow a complete earlier round, so
        # fall back across rounds to the newest one holding a verified
        # dir; if no round has any sidecar (pre-sidecar dirs, write
        # failures), take the newest round as-is.  Within a round prefer
        # verified dirs, then the LOWEST rank (rank 0's metrics are
        # canonical; same-round dirs sort by rank).
        def verified(d: str) -> bool:
            return os.path.exists(os.path.join(trial_dir, d, _METRICS_FILE))

        by_round: Dict[int, List[str]] = {}
        for d, r in zip(ckpts, rounds):
            if r is not None:
                by_round.setdefault(r, []).append(d)
        pick_round = top
        for r in sorted(by_round, reverse=True):
            if any(verified(d) for d in by_round[r]):
                pick_round = r
                break
        cands = sorted(
            by_round[pick_round], key=lambda d: (0 if verified(d) else 1, d)
        )
        return Checkpoint(os.path.join(trial_dir, cands[0]))

    def _prune_checkpoints(self, trial_dir: str):
        import shutil

        cc = self.run_config.checkpoint_config
        if cc is None or cc.num_to_keep is None:
            return
        ckpts = sorted(
            d for d in os.listdir(trial_dir) if d.startswith("checkpoint_")
        )
        for stale in ckpts[: -cc.num_to_keep]:
            shutil.rmtree(os.path.join(trial_dir, stale), ignore_errors=True)
