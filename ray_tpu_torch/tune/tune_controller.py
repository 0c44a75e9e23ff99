"""The trial event loop (port of ``ray_tpu/tune/tune_controller.py``).

Role-equivalent of ray: python/ray/tune/execution/tune_controller.py:68
(TuneController) + trial.py.  Trials run as single worker actors reusing
the Train session machinery (report/get_checkpoint are the same API in
both libraries, like the reference).  The loop multiplexes outstanding
next_report calls with ray_tpu_torch.wait, feeds results to the scheduler, and
kills trials it stops early.

The port's seams: a trial's resources reach the runtime's lease, so a
``{"GPU": n}`` trial is bound ``n`` cards through ``CUDA_VISIBLE_DEVICES``
before any of its code runs, and trials beyond the node's cards queue on
the lease (``max_concurrent`` 0 launches them all; the runtime runs them
in turn).  A finished or stopped trial is killed, which hands its cards
back to the raylet before the GCS grants the next queued lease.  Trial
directories default to the session root's ``results`` (``RunConfig``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core.errors import ActorDiedError, TaskError
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.train.session import TrainContext
from ray_tpu_torch.train.worker_group import TrainWorkerActor
from ray_tpu_torch.tune.schedulers import CONTINUE, RESTART, STOP, FIFOScheduler

PENDING = "PENDING"
RUNNING = "RUNNING"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


@dataclasses.dataclass
class Trial:
    trial_id: str
    config: Dict[str, Any]
    resources: Dict[str, float]
    status: str = PENDING
    results: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    checkpoint: Optional[Checkpoint] = None
    error: Optional[str] = None
    early_stopped: bool = False
    actor: Any = None
    num_failures: int = 0  # crashes absorbed so far (FailureConfig)

    @property
    def last_result(self) -> Dict[str, Any]:
        return self.results[-1] if self.results else {}


class TuneController:
    def __init__(
        self,
        trainable: Callable[[Dict[str, Any]], Any],
        trials: List[Trial],
        *,
        scheduler=None,
        max_concurrent: int = 0,
        experiment_dir: Optional[str] = None,
        experiment_name: str = "tune",
        searcher=None,
        trial_factory: Optional[Callable[[Dict[str, Any]], Trial]] = None,
        max_failures: int = 0,
    ):
        self.trainable = trainable
        self.trials = trials
        self.scheduler = scheduler or FIFOScheduler()
        self.max_concurrent = max_concurrent  # 0 = unlimited
        # trial-level fault tolerance (reference: FailureConfig.max_failures,
        # python/ray/air/config.py:399-409): a crashed trial is relaunched
        # from its latest checkpoint up to this many times; < 0 = forever
        self.max_failures = max_failures
        self.experiment_dir = experiment_dir or os.path.join(
            RunConfig().resolved_storage_path(), experiment_name
        )
        self.experiment_name = experiment_name
        # sequential search (TPE etc.): trials are created on demand from
        # searcher.suggest() instead of all up front (reference:
        # tune/search/search_generator.py)
        self.searcher = searcher
        self.trial_factory = trial_factory
        self._search_exhausted = searcher is None

    # -- trial lifecycle -------------------------------------------------
    def _launch(self, trial: Trial, from_checkpoint: Optional[Checkpoint] = None):
        res = dict(trial.resources)
        extra = {k: v for k, v in res.items() if k != "CPU"}
        trial.actor = TrainWorkerActor.options(
            num_cpus=res.get("CPU", 1), resources=extra or None
        ).remote()
        ctx = TrainContext(
            world_size=1,
            world_rank=0,
            local_rank=0,
            local_world_size=1,
            node_rank=0,
            experiment_name=self.experiment_name,
            trial_dir=f"{self.experiment_dir}/{trial.trial_id}",
        )
        # dropped ref is safe: the run loop tracks this trial through
        # next_report refs on the same actor — a failed start kills the
        # actor and surfaces as an errored report there (rtflow RT202
        # audit: next_report refs live in the local `outstanding` dict
        # and every path pops them before re-arming)
        # rtlint: disable-next=RT105
        trial.actor.start_training.remote(
            self.trainable, trial.config, ctx, from_checkpoint
        )
        trial.status = RUNNING

    def _finalize(self, trial: Trial, status: str, error: Optional[str] = None):
        trial.status = status
        trial.error = error
        if trial.actor is not None:
            try:
                ray_tpu_torch.kill(trial.actor)
            except Exception:
                pass
            trial.actor = None
        if self.searcher is not None:
            try:
                self.searcher.on_trial_complete(
                    trial.trial_id, trial.last_result or None
                )
            except Exception:
                pass

    # -- the loop --------------------------------------------------------
    def run(self) -> List[Trial]:
        try:
            return self._run_inner()
        except BaseException:
            # don't leak live trial actors past an unexpected controller
            # failure (e.g. a scheduler bug)
            for t in self.trials:
                if t.status == RUNNING:
                    self._finalize(t, ERROR, "tune controller failed")
            raise

    def _run_inner(self) -> List[Trial]:
        # population-based schedulers exchange checkpoints between trials
        if hasattr(self.scheduler, "set_trials"):
            self.scheduler.set_trials(self.trials)
        pending = [t for t in self.trials if t.status == PENDING]
        outstanding: Dict[Any, Trial] = {}  # next_report ref -> trial

        def top_up():
            """Pull new trials from the searcher up to free capacity.

            Never pulls while running == max_concurrent: sequential
            searchers (TPE) condition each suggestion on completed
            results, so consuming suggestions early skews the search and
            holds a pending trial beyond the concurrency cap.  With
            unlimited concurrency we feed one trial per loop pass.
            """
            if self._search_exhausted:
                return
            while (len(pending) < capacity()
                   if self.max_concurrent > 0 else not pending):
                tid = f"{self.experiment_name}_{len(self.trials):05d}"
                cfg = self.searcher.suggest(tid)
                if cfg is None:
                    self._search_exhausted = True
                    return
                trial = self.trial_factory(tid, cfg)
                self.trials.append(trial)
                pending.append(trial)

        def capacity() -> int:
            running = sum(1 for t in self.trials if t.status == RUNNING)
            if self.max_concurrent <= 0:
                return len(pending)
            return max(0, self.max_concurrent - running)

        top_up()
        while pending or outstanding or not self._search_exhausted:
            top_up()
            for _ in range(min(capacity(), len(pending))):
                trial = pending.pop(0)
                self._launch(trial)
                ref = trial.actor.next_report.remote(timeout=30.0)
                outstanding[ref] = trial
            if not outstanding:
                time.sleep(0.05)
                continue
            ready, _ = ray_tpu_torch.wait(
                list(outstanding.keys()), num_returns=1, timeout=5.0
            )
            for ref in ready:
                trial = outstanding.pop(ref)
                try:
                    report = ray_tpu_torch.get(ref, timeout=60)
                except (TaskError, ActorDiedError) as e:
                    if (
                        self.max_failures < 0
                        or trial.num_failures < self.max_failures
                    ):
                        # restore: relaunch from the trial's latest
                        # checkpoint (possibly on a different node) and
                        # keep polling — the trainable resumes via
                        # session.get_checkpoint(), like gang restart
                        trial.num_failures += 1
                        if trial.actor is not None:
                            try:
                                ray_tpu_torch.kill(trial.actor)
                            except Exception:
                                pass
                            trial.actor = None
                        self._launch(trial, from_checkpoint=trial.checkpoint)
                        nref = trial.actor.next_report.remote(timeout=30.0)
                        outstanding[nref] = trial
                    else:
                        self._finalize(trial, ERROR, str(e))
                    continue
                if report is None:  # loop finished cleanly
                    self._finalize(trial, TERMINATED)
                    continue
                if report.get("pending"):
                    # nothing reported inside the poll slice (legal: e.g. a
                    # long compile) — re-poll; trial liveness is carried by
                    # the actor call itself, not a report deadline
                    nref = trial.actor.next_report.remote(timeout=30.0)
                    outstanding[nref] = trial
                    continue
                result = report["metrics"]
                result.setdefault("training_iteration", len(trial.results) + 1)
                result.setdefault("_timestamp", time.time())
                trial.results.append(result)
                if report["checkpoint"] is not None:
                    trial.checkpoint = report["checkpoint"]
                decision = self.scheduler.on_trial_result(
                    trial.trial_id, result
                )
                if decision == STOP:
                    trial.early_stopped = True
                    self._finalize(trial, TERMINATED)
                elif decision == RESTART:
                    # exploit/explore (PBT): the scheduler already swapped
                    # trial.config/checkpoint; relaunch from that state
                    if trial.actor is not None:
                        try:
                            ray_tpu_torch.kill(trial.actor)
                        except Exception:
                            pass
                        trial.actor = None
                    self._launch(trial, from_checkpoint=trial.checkpoint)
                    nref = trial.actor.next_report.remote(timeout=30.0)
                    outstanding[nref] = trial
                else:
                    assert decision == CONTINUE
                    nref = trial.actor.next_report.remote(timeout=30.0)
                    outstanding[nref] = trial
        return self.trials
