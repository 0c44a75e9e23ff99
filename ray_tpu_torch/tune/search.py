"""Search spaces and the basic variant generator (port of
``ray_tpu/tune/search.py``, unchanged).

Role-equivalent of ray: python/ray/tune/search/ (sample.py domains,
basic_variant.py BasicVariantGenerator): grid_search cross-products,
random distributions for sampled dimensions, num_samples repetitions.
"""

from __future__ import annotations

import itertools
import random
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional


# -- domains ---------------------------------------------------------------


@dataclass
class Domain:
    sampler: Callable[[random.Random], Any]
    # metadata for model-based searchers (TPE): how to model this leaf
    kind: str = "opaque"  # uniform | loguniform | randint | choice | opaque
    low: float = 0.0
    high: float = 0.0
    options: Optional[List[Any]] = None

    def sample(self, rng: random.Random) -> Any:
        return self.sampler(rng)


def uniform(low: float, high: float) -> Domain:
    return Domain(lambda rng: rng.uniform(low, high), kind="uniform",
                  low=low, high=high)


def loguniform(low: float, high: float) -> Domain:
    import math

    lo, hi = math.log(low), math.log(high)
    return Domain(
        lambda rng: math.exp(rng.uniform(lo, hi)),
        kind="loguniform", low=low, high=high,
    )


def randint(low: int, high: int) -> Domain:
    """Uniform integer in [low, high) (reference semantics)."""
    return Domain(lambda rng: rng.randrange(low, high), kind="randint",
                  low=low, high=high)


def choice(options: List[Any]) -> Domain:
    opts = list(options)
    return Domain(lambda rng: rng.choice(opts), kind="choice", options=opts)


def sample_from(fn: Callable[[Dict[str, Any]], Any]) -> Domain:
    """Sample from a callable receiving the partially-resolved config."""
    d = Domain(None)  # type: ignore[arg-type]
    d.needs_config = fn  # type: ignore[attr-defined]
    return d


def grid_search(values: List[Any]) -> Dict[str, List[Any]]:
    return {"grid_search": list(values)}


# -- variant generation ----------------------------------------------------


def _walk(space: Any, path=()):
    """Yield (path, spec) for every grid/domain leaf in a nested dict."""
    if isinstance(space, dict):
        if set(space.keys()) == {"grid_search"}:
            yield path, space
            return
        for k, v in space.items():
            yield from _walk(v, path + (k,))
    elif isinstance(space, Domain):
        yield path, space


def _set_path(cfg: dict, path, value):
    node = cfg
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


def _contains_domain(value) -> bool:
    if isinstance(value, Domain):
        return True
    if isinstance(value, dict):
        return any(_contains_domain(v) for v in value.values())
    if isinstance(value, (list, tuple)):
        return any(_contains_domain(v) for v in value)
    return False


def _deep_copy_plain(space):
    if isinstance(space, dict):
        return {k: _deep_copy_plain(v) for k, v in space.items()}
    return space


def generate_variants(
    param_space: Dict[str, Any],
    num_samples: int = 1,
    seed: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """Resolve the space: full grid cross-product × num_samples random draws."""
    rng = random.Random(seed)
    leaves = list(_walk(param_space))
    grid_leaves = [(p, s["grid_search"]) for p, s in leaves if isinstance(s, dict)]
    domain_leaves = [(p, s) for p, s in leaves if isinstance(s, Domain)]

    grids = (
        itertools.product(*[vals for _, vals in grid_leaves])
        if grid_leaves
        else [()]
    )
    samplers = [
        (p, d) for p, d in domain_leaves if getattr(d, "needs_config", None) is None
    ]
    dependent = [
        (p, d) for p, d in domain_leaves if getattr(d, "needs_config", None) is not None
    ]
    configs: List[Dict[str, Any]] = []
    for combo in grids:
        for _ in range(num_samples):
            cfg = _deep_copy_plain(param_space)
            for (path, _), val in zip(grid_leaves, combo):
                _set_path(cfg, path, val)
            for path, dom in samplers:
                _set_path(cfg, path, dom.sample(rng))
            # sample_from callables may reference other sampled values:
            # resolve in passes, deferring ones whose inputs aren't ready
            # (reference: BasicVariantGenerator iterative resolution)
            todo = list(dependent)
            for _pass in range(len(todo) + 1):
                if not todo:
                    break
                deferred, last_err = [], None
                for path, dom in todo:
                    try:
                        val = dom.needs_config(cfg)
                        if _contains_domain(val):
                            # fn read a still-unresolved Domain: not ready
                            deferred.append((path, dom))
                            continue
                        _set_path(cfg, path, val)
                    except Exception as e:  # inputs unresolved yet
                        deferred.append((path, dom))
                        last_err = e
                if len(deferred) == len(todo):
                    raise ValueError(
                        f"could not resolve sample_from at {deferred[0][0]}: "
                        f"circular or invalid reference ({last_err!r})"
                    )
                todo = deferred
            configs.append(cfg)
    return configs


# -- sequential searchers --------------------------------------------------


class Searcher:
    """Sequential config proposer (ray: python/ray/tune/search/searcher.py).

    Unlike `generate_variants` (all configs up front), a Searcher is
    consulted one trial at a time and learns from completed results —
    the hook that model-based search (TPE here; Optuna/HyperOpt/Ax in
    the reference) plugs into.
    """

    metric: Optional[str] = None
    mode: Optional[str] = None

    def set_search_properties(self, metric: Optional[str],
                              mode: Optional[str]) -> None:
        if self.metric is None:
            self.metric = metric
        if self.mode is None:
            self.mode = mode

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]]) -> None:
        pass


class BasicVariantGenerator(Searcher):
    """Random/grid search behind the Searcher interface
    (ray: tune/search/basic_variant.py)."""

    def __init__(self, param_space: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None):
        self._configs = generate_variants(
            param_space, num_samples=num_samples, seed=seed
        )
        self._i = 0

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self._i >= len(self._configs):
            return None
        cfg = self._configs[self._i]
        self._i += 1
        return cfg


def _norm_pdf(x: float, mu: float, sigma: float) -> float:
    import math

    z = (x - mu) / sigma
    return math.exp(-0.5 * z * z) / (sigma * math.sqrt(2 * math.pi))


class TPESearcher(Searcher):
    """Independent Tree-structured Parzen Estimator search.

    Role-equivalent of the reference's OptunaSearch default sampler
    (ray: tune/search/optuna/optuna_search.py; Bergstra et al. 2011):
    per dimension, completed trials are split into a good quantile
    (gamma) and the rest; candidates are drawn from a Parzen mixture
    over the good set and ranked by the density ratio good/bad.
    Dimensions are modeled independently (like Optuna's default);
    `sample_from` leaves resolve after the modeled leaves, as in
    generate_variants.  Combine with AsyncHyperBandScheduler to get the
    BOHB pairing (scheduler culls, searcher models).
    """

    def __init__(
        self,
        param_space: Dict[str, Any],
        metric: Optional[str] = None,
        mode: Optional[str] = None,
        n_startup: int = 10,
        gamma: float = 0.25,
        n_candidates: int = 24,
        max_trials: Optional[int] = None,
        seed: Optional[int] = None,
    ):
        assert mode in (None, "min", "max")
        self.metric = metric
        self.mode = mode
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.max_trials = max_trials
        self._rng = random.Random(seed)
        self.set_space(param_space)
        self._suggested = 0
        # completed observations: list of (dict path->model-space value, score)
        self._obs: List[tuple] = []
        self._pending: Dict[str, Dict[tuple, Any]] = {}

    def set_space(self, param_space: Dict[str, Any]) -> None:
        """(Re)bind the search space — the Tuner injects its param_space
        into a searcher constructed without one (reference:
        set_search_properties)."""
        self.space = param_space
        leaves = list(_walk(param_space))
        # grid leaves are modeled as categoricals; opaque/sample_from
        # leaves stay random
        self._dims: List[tuple] = []
        self._dependent: List[tuple] = []
        for path, spec in leaves:
            if isinstance(spec, dict):  # grid_search
                self._dims.append(
                    (path, Domain(None, kind="choice",
                                  options=list(spec["grid_search"])))
                )
            elif getattr(spec, "needs_config", None) is not None:
                self._dependent.append((path, spec))
            else:
                self._dims.append((path, spec))

    # -- model-space transforms ---------------------------------------

    def _to_model(self, dom: Domain, value: Any) -> float:
        import math

        if dom.kind == "choice":
            try:
                return float(dom.options.index(value))
            except ValueError:
                return 0.0
        if dom.kind == "loguniform":
            return math.log(value)
        return float(value)

    def _from_model(self, dom: Domain, x: float) -> Any:
        import math

        if dom.kind == "choice":
            return dom.options[int(round(x)) % len(dom.options)]
        if dom.kind == "loguniform":
            # exp(log(low)) can land a ulp outside the bounds
            return min(dom.high, max(dom.low, math.exp(x)))
        if dom.kind == "randint":
            return int(min(dom.high - 1, max(dom.low, round(x))))
        return min(dom.high, max(dom.low, x))

    def _bounds(self, dom: Domain) -> tuple:
        import math

        if dom.kind == "loguniform":
            return math.log(dom.low), math.log(dom.high)
        if dom.kind == "choice":
            return 0.0, float(len(dom.options) - 1)
        return float(dom.low), float(dom.high)

    # -- TPE core ------------------------------------------------------

    def _sample_dim(self, path: tuple, dom: Domain) -> Any:
        obs = [(xs[path], score) for xs, score in self._obs if path in xs]
        if dom.kind == "opaque" or len(obs) < self.n_startup:
            if dom.kind == "choice" and dom.sampler is None:
                return self._rng.choice(dom.options)
            return dom.sample(self._rng) if dom.sampler else self._rng.choice(
                dom.options
            )
        obs.sort(key=lambda t: t[1], reverse=True)  # higher = better
        n_good = max(1, int(self.gamma * len(obs)))
        good = [x for x, _ in obs[:n_good]]
        bad = [x for x, _ in obs[n_good:]] or good
        if dom.kind == "choice":
            k = len(dom.options)
            gc = [1.0] * k
            bc = [1.0] * k
            for x in good:
                gc[int(x) % k] += 1
            for x in bad:
                bc[int(x) % k] += 1
            gsum, bsum = sum(gc), sum(bc)
            # draw candidates from the good distribution, rank by ratio
            cand = self._rng.choices(range(k), weights=gc,
                                     k=self.n_candidates)
            best = max(cand, key=lambda i: (gc[i] / gsum) / (bc[i] / bsum))
            return dom.options[best]
        lo, hi = self._bounds(dom)
        width = max(hi - lo, 1e-12)
        sigma = max(width / max(len(good), 1) ** 0.5, 1e-3 * width)

        def density(x: float, centers: List[float]) -> float:
            return sum(_norm_pdf(x, c, sigma) for c in centers) / len(centers)

        best_x, best_ratio = None, -1.0
        for _ in range(self.n_candidates):
            c = self._rng.choice(good)
            x = min(hi, max(lo, self._rng.gauss(c, sigma)))
            ratio = density(x, good) / max(density(x, bad), 1e-12)
            if ratio > best_ratio:
                best_x, best_ratio = x, ratio
        return self._from_model(dom, best_x)

    # -- Searcher interface -------------------------------------------

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if self.max_trials is not None and self._suggested >= self.max_trials:
            return None
        self._suggested += 1
        cfg = _deep_copy_plain(self.space)
        xs: Dict[tuple, Any] = {}
        for path, dom in self._dims:
            val = self._sample_dim(path, dom)
            xs[path] = self._to_model(dom, val)
            _set_path(cfg, path, val)
        for path, dom in self._dependent:
            _set_path(cfg, path, dom.needs_config(cfg))
        self._pending[trial_id] = xs
        return cfg

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]]) -> None:
        xs = self._pending.pop(trial_id, None)
        if xs is None or not result or self.metric not in result:
            return
        v = float(result[self.metric])
        score = v if (self.mode or "max") == "max" else -v
        self._obs.append((xs, score))


class TuneBOHB(TPESearcher):
    """BOHB's model-based half (reference: ray.tune.search.bohb.TuneBOHB,
    built on the BOHB paper's TPE-style KDE sampler).  Pair with
    HyperBandForBOHB: the scheduler runs successive-halving brackets,
    this searcher proposes configs from a density model of completed
    results — together the BOHB algorithm (Falkner et al. 2018).

    Reference-style construction: the space may be omitted and is then
    injected by the Tuner from its ``param_space``."""

    def __init__(self, space=None, metric=None, mode=None, **kw):
        super().__init__(space or {}, metric=metric, mode=mode, **kw)


