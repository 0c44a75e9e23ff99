"""Trial schedulers: decide per-result whether a trial lives on (port of
``ray_tpu/tune/schedulers.py``, unchanged: the port makes the reference's
decisions, PBT's gate on a population that has not all reported included).

Role-equivalent of ray: python/ray/tune/schedulers/ — FIFOScheduler
(trial_scheduler.py), ASHA (async_hyperband.py AsyncHyperBandScheduler):
asynchronous successive halving with geometric rungs, and PBT (pbt.py
PopulationBasedTraining): exploit/explore — bottom-quantile trials clone
a top-quantile trial's checkpoint and mutate its hyperparameters, then
RESTART from that state.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"
RESTART = "RESTART"  # relaunch the trial from trial.checkpoint + new config


class FIFOScheduler:
    def on_trial_result(self, trial_id: str, result: dict) -> str:
        return CONTINUE


class ASHAScheduler:
    def __init__(
        self,
        metric: str = None,
        mode: str = None,  # None = inherit from TuneConfig (default "max")
        time_attr: str = "training_iteration",
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: int = 4,
    ):
        assert mode in (None, "min", "max")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        # rung value -> list of recorded scores (sign-normalized: higher=better)
        self._rungs: Dict[int, List[float]] = {}
        # trial -> highest rung already evaluated (each rung checked once)
        self._trial_rung: Dict[str, int] = {}
        rung = grace_period
        self._rung_levels: List[int] = []
        while rung < max_t:
            self._rung_levels.append(rung)
            rung *= reduction_factor

    def _score(self, result: dict) -> float:
        v = float(result[self.metric])
        return v if (self.mode or "max") == "max" else -v

    def on_trial_result(self, trial_id: str, result: dict) -> str:
        t = int(result.get(self.time_attr, 0))
        if t >= self.max_t:
            return STOP  # budget exhausted (scheduler-complete, not failure)
        # Evaluate at the highest rung <= t not yet checked for this trial:
        # reports need not land exactly on rung values (reference ASHA
        # cull-checks at the highest milestone <= t).
        done_rung = self._trial_rung.get(trial_id, 0)
        eligible = [r for r in self._rung_levels if done_rung < r <= t]
        if not eligible:
            return CONTINUE
        rung = max(eligible)
        self._trial_rung[trial_id] = rung
        scores = self._rungs.setdefault(rung, [])
        score = self._score(result)
        scores.append(score)
        # top 1/rf quantile survives: k = ceil(n / rf)
        k = max(1, (len(scores) + self.rf - 1) // self.rf)
        cutoff = sorted(scores, reverse=True)[k - 1]
        return STOP if score < cutoff else CONTINUE


class PopulationBasedTraining:
    """PBT (ray: python/ray/tune/schedulers/pbt.py PopulationBasedTraining).

    Every ``perturbation_interval`` iterations a trial is ranked against
    the population's latest scores.  A bottom-quantile trial *exploits*
    (adopts a random top-quantile trial's checkpoint and config) and
    *explores* (mutates hyperparameters: resample with probability
    ``resample_probability``, else perturb by x1.2 / x0.8, matching the
    reference's _explore), then signals RESTART so the controller
    relaunches it from the adopted checkpoint.

    ``hyperparam_mutations`` maps config keys to either a list of
    choices or a callable returning a sample.
    """

    def __init__(
        self,
        metric: Optional[str] = None,
        mode: Optional[str] = None,  # None = inherit from TuneConfig
        time_attr: str = "training_iteration",
        perturbation_interval: int = 4,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        hyperparam_mutations: Optional[Dict[str, Any]] = None,
        seed: Optional[int] = None,
    ):
        assert mode in (None, "min", "max")
        assert 0.0 < quantile_fraction <= 0.5
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.interval = perturbation_interval
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self.mutations = hyperparam_mutations or {}
        self._rng = random.Random(seed)
        self._trials: Dict[str, Any] = {}
        self._scores: Dict[str, float] = {}  # latest sign-normalized score
        self._last_perturb: Dict[str, int] = {}
        self.num_perturbations = 0

    def set_trials(self, trials: List[Any]) -> None:
        """Controller hands us the population (for checkpoint exchange)."""
        self._trials = {t.trial_id: t for t in trials}

    def _score(self, result: dict) -> float:
        v = float(result[self.metric])
        return v if (self.mode or "max") == "max" else -v

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(config)
        for key, spec in self.mutations.items():
            if key not in out:
                continue
            if self._rng.random() < self.resample_prob or not isinstance(
                out[key], (int, float)
            ):
                if callable(spec):
                    out[key] = spec()
                else:
                    out[key] = self._rng.choice(list(spec))
            else:
                factor = 1.2 if self._rng.random() > 0.5 else 0.8
                out[key] = type(out[key])(out[key] * factor)
        return out

    def on_trial_result(self, trial_id: str, result: dict) -> str:
        t = int(result.get(self.time_attr, 0))
        self._scores[trial_id] = self._score(result)
        if t - self._last_perturb.get(trial_id, 0) < self.interval:
            return CONTINUE
        self._last_perturb[trial_id] = t
        n = len(self._scores)
        # rank only once the whole population has reported — early in the
        # run a 2-of-N comparison would mark the second reporter "bottom
        # quantile" spuriously
        if n < 2 or (self._trials and n < len(self._trials)):
            return CONTINUE
        ranked = sorted(
            self._scores.items(), key=lambda kv: kv[1], reverse=True
        )
        k = max(1, int(n * self.quantile))
        top = [tid for tid, _ in ranked[:k]]
        bottom = {tid for tid, _ in ranked[-k:]}
        if trial_id not in bottom or trial_id in top:
            return CONTINUE
        src_id = self._rng.choice(top)
        src = self._trials.get(src_id)
        me = self._trials.get(trial_id)
        if src is None or me is None or src.checkpoint is None:
            return CONTINUE  # nothing to exploit yet
        me.checkpoint = src.checkpoint
        me.config = self._explore(dict(src.config))
        self.num_perturbations += 1
        return RESTART


class PB2(PopulationBasedTraining):
    """Population Based Bandits (ray: python/ray/tune/schedulers/pb2.py).

    PBT's exploit step with a MODEL-BASED explore: instead of random
    x1.2/x0.8 perturbation, a Gaussian process is fit to
    (time, hyperparams) -> score-improvement observations from the whole
    population, and the new config maximizes the GP's UCB
    (mu + kappa * sigma) within ``hyperparam_bounds``.  Sample-efficient
    where PBT's random walk thrashes — the paper's claim, and why the
    reference ships both.

    The GP uses an RBF kernel with fixed hyperparameters on normalized
    data (the reference fits them via GPy, unavailable here; at
    population scale — tens of points — fixed length-scales behave
    comparably).  ``hyperparam_bounds`` maps config keys to (low, high);
    values stay floats (cast back to int when the incumbent was int).
    """

    def __init__(
        self,
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        time_attr: str = "training_iteration",
        perturbation_interval: int = 4,
        quantile_fraction: float = 0.25,
        hyperparam_bounds: Optional[Dict[str, Any]] = None,
        ucb_kappa: float = 2.0,
        candidates: int = 256,
        seed: Optional[int] = None,
    ):
        assert hyperparam_bounds, "PB2 requires hyperparam_bounds"
        super().__init__(
            metric=metric,
            mode=mode,
            time_attr=time_attr,
            perturbation_interval=perturbation_interval,
            quantile_fraction=quantile_fraction,
            hyperparam_mutations={},  # explore is GP-driven
            seed=seed,
        )
        self.bounds = {
            k: (float(lo), float(hi))
            for k, (lo, hi) in hyperparam_bounds.items()
        }
        self.kappa = ucb_kappa
        self.candidates = candidates
        self.max_observations = 500  # GP fit is O(n^3): keep recent rows
        # observations: rows of (t, hp_1..hp_d) -> score improvement
        self._X: List[List[float]] = []
        self._y: List[float] = []
        self._prev_score: Dict[str, float] = {}
        self._trial_hps: Dict[str, List[float]] = {}
        self._current_t: float = 0.0

    # -- data collection --------------------------------------------------
    def on_trial_result(self, trial_id: str, result: dict) -> str:
        t = float(result.get(self.time_attr, 0))
        self._current_t = t
        score = self._score(result)
        trial = self._trials.get(trial_id)
        if trial is not None:
            hps = [
                float(trial.config.get(k, lo))
                for k, (lo, _hi) in self.bounds.items()
            ]
            prev = self._prev_score.get(trial_id)
            if prev is not None:
                self._X.append([t, *self._trial_hps.get(trial_id, hps)])
                self._y.append(score - prev)
                if len(self._y) > self.max_observations:
                    # bound the GP fit (O(n^3)): recent rows carry the
                    # relevant time context anyway
                    del self._X[0], self._y[0]
            self._trial_hps[trial_id] = hps
        self._prev_score[trial_id] = score
        decision = super().on_trial_result(trial_id, result)
        if decision == RESTART:
            # the next report's score jump comes from the CLONED
            # checkpoint, not from this trial's old hyperparams — it
            # must not enter the GP as an observation for them
            self._prev_score.pop(trial_id, None)
            self._trial_hps.pop(trial_id, None)
        return decision

    # -- GP-UCB explore ---------------------------------------------------
    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        import numpy as np

        out = dict(config)
        keys = list(self.bounds)
        lo = np.array([self.bounds[k][0] for k in keys])
        hi = np.array([self.bounds[k][1] for k in keys])
        rng = np.random.default_rng(self._rng.randrange(2 ** 31))
        if len(self._y) < 4:  # cold start: uniform resample
            pick = lo + rng.random(len(keys)) * (hi - lo)
        else:
            X = np.asarray(self._X, float)
            y = np.asarray(self._y, float)
            # normalize inputs to [0,1]^d (incl. the time column) and
            # standardize outputs — fixed-kernel GPs need this
            xmin, xmax = X.min(0), X.max(0)
            span = np.where(xmax > xmin, xmax - xmin, 1.0)
            Xn = (X - xmin) / span
            ystd = y.std() or 1.0
            yn = (y - y.mean()) / ystd
            cand = np.empty((self.candidates, X.shape[1]))
            cand[:, 0] = self._current_t  # context: NOW
            cand[:, 1:] = lo + rng.random(
                (self.candidates, len(keys))
            ) * (hi - lo)
            candn = (cand - xmin) / span
            mu, sigma = _gp_posterior(Xn, yn, candn)
            pick = cand[int(np.argmax(mu + self.kappa * sigma)), 1:]
        for k, v in zip(keys, pick):
            if isinstance(out.get(k), int):
                v = int(round(v))
            out[k] = v
        return out


def _gp_posterior(X, y, Xq, lengthscale: float = 0.3,
                  noise: float = 1e-2):
    """RBF-kernel GP posterior mean/std at query points (numpy only).

    Fixed hyperparameters on normalized data (see PB2 docstring).
    """
    import numpy as np

    def k(a, b):
        d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / lengthscale ** 2)

    K = k(X, X) + noise * np.eye(len(X))
    L = np.linalg.cholesky(K)
    alpha = np.linalg.solve(L.T, np.linalg.solve(L, y))
    Ks = k(X, Xq)
    mu = Ks.T @ alpha
    v = np.linalg.solve(L, Ks)
    var = np.clip(1.0 - (v ** 2).sum(0), 1e-12, None)
    return mu, np.sqrt(var)


class AsyncHyperBandScheduler:
    """Multi-bracket asynchronous HyperBand.

    Role-equivalent of ray: python/ray/tune/schedulers/async_hyperband.py
    (AsyncHyperBandScheduler with brackets > 1; the repo's ASHAScheduler
    is the single-bracket special case).  Trials are assigned round-robin
    to `brackets` ASHA instances whose grace periods grow geometrically
    (grace, grace*rf, grace*rf^2, ...), hedging the early-culling
    aggressiveness against slow starters.  Pair with TPESearcher for the
    BOHB pairing (schedulers cull, searcher models; ray: tune/schedulers/
    hb_bohb.py + search/bohb/).
    """

    def __init__(
        self,
        metric: str = None,
        mode: str = None,
        time_attr: str = "training_iteration",
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: int = 4,
        brackets: int = 3,
    ):
        assert mode in (None, "min", "max")
        self.metric = metric
        self.mode = mode
        self._brackets = []
        for s in range(max(1, brackets)):
            g = grace_period * (reduction_factor ** s)
            if g >= max_t:
                break
            b = ASHAScheduler(
                metric=metric, mode=mode, time_attr=time_attr, max_t=max_t,
                grace_period=g, reduction_factor=reduction_factor,
            )
            self._brackets.append(b)
        if not self._brackets:
            self._brackets.append(
                ASHAScheduler(metric=metric, mode=mode, time_attr=time_attr,
                              max_t=max_t, grace_period=grace_period,
                              reduction_factor=reduction_factor)
            )
        self._assignment: Dict[str, int] = {}
        self._next = 0

    def __setattr__(self, name, value):
        # metric/mode set late by the Tuner propagate into the brackets
        super().__setattr__(name, value)
        if name in ("metric", "mode") and getattr(self, "_brackets", None):
            for b in self._brackets:
                setattr(b, name, value)

    def on_trial_result(self, trial_id: str, result: dict) -> str:
        i = self._assignment.get(trial_id)
        if i is None:
            i = self._assignment[trial_id] = self._next % len(self._brackets)
            self._next += 1
        return self._brackets[i].on_trial_result(trial_id, result)


class MedianStoppingRule:
    """Stop a trial whose running-average falls below the median of the
    other trials' running averages at the same step.

    Role-equivalent of ray: python/ray/tune/schedulers/median_stopping_rule.py
    (MedianStoppingRule): per-trial mean over reported scores so far,
    compared against the median of completed means after a grace period.
    """

    def __init__(
        self,
        metric: str = None,
        mode: str = None,
        time_attr: str = "training_iteration",
        grace_period: int = 4,
        min_samples_required: int = 3,
    ):
        assert mode in (None, "min", "max")
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self._sums: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}

    def _score(self, result: dict) -> float:
        v = float(result[self.metric])
        return v if (self.mode or "max") == "max" else -v

    def on_trial_result(self, trial_id: str, result: dict) -> str:
        s = self._score(result)
        self._sums[trial_id] = self._sums.get(trial_id, 0.0) + s
        self._counts[trial_id] = self._counts.get(trial_id, 0) + 1
        t = int(result.get(self.time_attr, self._counts[trial_id]))
        if t < self.grace_period:
            return CONTINUE
        means = [
            self._sums[tid] / self._counts[tid]
            for tid in self._sums
            if tid != trial_id
        ]
        if len(means) < self.min_samples:
            return CONTINUE
        means.sort()
        median = means[len(means) // 2]
        my_mean = self._sums[trial_id] / self._counts[trial_id]
        return STOP if my_mean < median else CONTINUE


class HyperBandForBOHB(AsyncHyperBandScheduler):
    """BOHB's bandit half (reference: ray.tune.schedulers.HyperBandForBOHB):
    async HyperBand whose trials are proposed by TuneBOHB's density
    model instead of random sampling.  Functionally the async-bracket
    variant is what the reference's implementation reduces to on this
    stack (trial proposals already arrive sequentially from the
    searcher, so no bracket-filling coordination is needed)."""


