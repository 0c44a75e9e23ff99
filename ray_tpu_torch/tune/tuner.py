"""Tuner: the user-facing experiment API (port of ``ray_tpu/tune/tuner.py``).

Role-equivalent of ray: python/ray/tune/tuner.py:44 (Tuner) +
result_grid.py (ResultGrid).  `Tuner(fn_or_trainer, param_space=...,
tune_config=...).fit()` resolves the search space into trials, runs them
through the TuneController, and returns a ResultGrid.

A TorchTrainer can be passed as the trainable (reference: Train delegates
its run loop to Tune, base_trainer.py:567-612; here the layering is
inverted — each trial drives a whole gang via trainer.fit()).  The trial
actor leases no card: the nested trainer's workers do, and the trial
reports once, the trainer's final metrics and checkpoint, with the trial
process's own ``CUDA_VISIBLE_DEVICES`` beside them
(``trial_cuda_visible_devices``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict, List, Optional, Union

from ray_tpu_torch.core.remote_function import _build_resources
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.trainer import Result, TorchTrainer
from ray_tpu_torch.tune.schedulers import FIFOScheduler
from ray_tpu_torch.tune.search import generate_variants
from ray_tpu_torch.tune.tune_controller import ERROR, Trial, TuneController


@dataclasses.dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int = 0  # 0 = unlimited
    scheduler: Any = None
    search_alg: Any = None  # a tune.search.Searcher (e.g. TPESearcher)
    seed: Optional[int] = None


class ResultGrid:
    def __init__(
        self,
        results: List[Result],
        trials: List[Trial],
        default_metric: Optional[str] = None,
        default_mode: str = "max",
    ):
        self._results = results
        self._trials = trials
        self._default_metric = default_metric
        self._default_mode = default_mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    @property
    def errors(self) -> List[BaseException]:
        return [r.error for r in self._results if r.error is not None]

    def get_best_result(
        self, metric: Optional[str] = None, mode: Optional[str] = None
    ) -> Result:
        metric = metric or self._default_metric
        mode = mode or self._default_mode
        if metric is None:
            raise ValueError(
                "no metric: pass metric= here or set TuneConfig.metric"
            )
        candidates = [
            r
            for r in self._results
            if r.error is None and metric in (r.metrics or {})
        ]
        if not candidates:
            raise ValueError(f"no trial reported metric {metric!r}")
        key = lambda r: r.metrics[metric]  # noqa: E731
        return max(candidates, key=key) if mode == "max" else min(
            candidates, key=key
        )

    def get_dataframe(self) -> List[Dict[str, Any]]:
        return [dict(r.metrics, _trial=i) for i, r in enumerate(self._results)]


def with_resources(
    trainable: Callable, resources: Dict[str, float]
) -> Callable:
    """Attach a per-trial resource demand (ray: tune.with_resources)."""
    trainable.__tune_resources__ = dict(resources)
    return trainable


class Tuner:
    def __init__(
        self,
        trainable: Union[Callable[[Dict[str, Any]], Any], TorchTrainer],
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config=None,  # train.RunConfig
    ):
        from ray_tpu_torch.train.config import RunConfig

        resources = getattr(trainable, "__tune_resources__", {})
        try:
            # the runtime's own check, here where the experiment is made
            _build_resources(resources=dict(resources))
        except ValueError as e:
            raise ValueError(
                f"trial resources {resources}: {e} "
                '(tune.with_resources(fn, {"GPU": n}))'
            ) from e
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()

    def _resolve_trainable(self) -> Callable[[Dict[str, Any]], Any]:
        if isinstance(self.trainable, TorchTrainer):
            trainer = self.trainable

            def run_trainer_trial(config: Dict[str, Any]):
                from ray_tpu_torch.train import session as train_session
                from ray_tpu_torch.train.trainer import TorchTrainer as _TT

                merged = dict(trainer._config)
                merged.update(config.get("train_loop_config", config))
                sess = train_session.get_session()
                trial_trainer = _TT(
                    trainer._train_fn,
                    train_loop_config=merged,
                    scaling_config=trainer.scaling_config,
                    run_config=dataclasses.replace(
                        trainer.run_config,
                        name=sess.context.experiment_name
                        + "/"
                        + os.path.basename(sess.context.trial_dir),
                    ),
                    backend_config=trainer.backend_config,
                )
                r = trial_trainer.fit()
                if r.error is not None:
                    raise r.error
                metrics = dict(r.metrics, trial_cuda_visible_devices=(
                    os.environ.get("CUDA_VISIBLE_DEVICES", "")))
                sess.report(metrics, checkpoint=r.checkpoint)
                return metrics

            return run_trainer_trial
        return self.trainable

    def fit(self) -> ResultGrid:
        tc = self.tune_config
        if tc.search_alg is not None:
            # set_search_properties role: a searcher constructed without a
            # space/metric inherits the Tuner's (explicit settings win)
            if not getattr(tc.search_alg, "space", None) and self.param_space:
                if hasattr(tc.search_alg, "set_space"):
                    tc.search_alg.set_space(self.param_space)
                else:
                    tc.search_alg.space = self.param_space
            if getattr(tc.search_alg, "metric", None) is None:
                tc.search_alg.metric = tc.metric
            if getattr(tc.search_alg, "mode", None) is None:
                tc.search_alg.mode = tc.mode
            configs = []  # trials come from the searcher, one at a time
        else:
            configs = generate_variants(
                self.param_space, num_samples=tc.num_samples, seed=tc.seed
            )
        name = self.run_config.name or "tune_run"
        exp_dir = os.path.join(self.run_config.resolved_storage_path(), name)
        scheduler = tc.scheduler or FIFOScheduler()
        # reference pattern: metric/mode set on TuneConfig propagate into a
        # scheduler constructed without them (set_search_properties); an
        # explicit scheduler setting always wins
        if getattr(scheduler, "metric", "") is None:
            if tc.metric is None:
                raise ValueError(
                    "scheduler needs a metric: set it on the scheduler or "
                    "in TuneConfig(metric=...)"
                )
            scheduler.metric = tc.metric
        if getattr(scheduler, "mode", "") is None:
            scheduler.mode = tc.mode
        resources = getattr(self.trainable, "__tune_resources__", {"CPU": 1})
        trials = [
            Trial(
                trial_id=f"{name}_{i:05d}",
                config=cfg,
                resources=dict(resources),
            )
            for i, cfg in enumerate(configs)
        ]
        searcher = tc.search_alg
        trial_factory = None
        if searcher is not None:
            searcher.set_search_properties(tc.metric, tc.mode)
            if getattr(searcher, "metric", None) is None:
                # without a metric the searcher would silently drop every
                # completed-trial observation and degrade to random search
                raise ValueError(
                    "search_alg needs a metric: set it on the searcher or "
                    "in TuneConfig(metric=...)"
                )
            if getattr(searcher, "max_trials", None) is None:
                searcher.max_trials = tc.num_samples

            def trial_factory(tid, cfg):
                return Trial(trial_id=tid, config=cfg,
                             resources=dict(resources))

        fc = self.run_config.failure_config
        controller = TuneController(
            self._resolve_trainable(),
            trials,
            scheduler=scheduler,
            max_concurrent=tc.max_concurrent_trials,
            experiment_dir=exp_dir,
            experiment_name=name,
            searcher=searcher,
            trial_factory=trial_factory,
            max_failures=fc.max_failures if fc is not None else 0,
        )
        controller.run()
        trials = controller.trials
        results = [
            Result(
                metrics=t.last_result,
                checkpoint=t.checkpoint,
                path=os.path.join(exp_dir, t.trial_id),
                metrics_dataframe=t.results,
                error=RuntimeError(t.error) if t.status == ERROR else None,
            )
            for t in trials
        ]
        return ResultGrid(
            results, trials, default_metric=tc.metric, default_mode=tc.mode
        )
