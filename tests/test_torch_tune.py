"""The port's Tune library (ray_tpu_torch.tune) against ray_tpu.tune, and on
the port's runtime on the CPU.

Search spaces, searchers and schedulers are the same Python and numpy in
both packages, so the port is held to the reference exactly: the same
variants, the same suggestions, the same decisions (PBT's donor and
explored config, PB2's GP-chosen values and their types) on the same
seeded inputs.  Nothing here needs a tolerance.

The cluster tests share one cluster for the module, ``init(num_cpus=4,
num_gpus=2)``, as the trainer's tests do: two GPUs are declared and none
exists, so a ``{"GPU": 1}`` trial is given a card index through
``CUDA_VISIBLE_DEVICES`` and finds no card.  Trainables travel by value.

- ASHA over four GPU trials: each trial runs as many iterations as the
  reference's ``ASHAScheduler`` decides when replayed on the port's
  recorded results in arrival order.
- A Tuner over a ``TorchTrainer`` (the tiny flash GPT-2 widened to D = 64,
  f32, the head dim the card's kernels take): each trial's losses equal
  the same steps run in process bit for bit (both on one CPU thread), and
  the first loss equals the JAX model's on the same converted weights
  within ``tests/test_torch_train.py``'s f32 loss tolerance, 1e-5.
- PBT with trials made to overlap (a file barrier): the reference's own
  end-to-end test cannot perturb when trials run one after another.

Restarts and long queues of trials on the cards are in
``tests/test_zz_torch_tune.py``.
"""

import contextlib
import itertools
import math
import os
import random
import sys
import time

import cloudpickle
import jax
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu import tune as ref_tune
from ray_tpu.models import gpt2 as jax_gpt2
from ray_tpu.parallel import mesh as jax_mesh
from ray_tpu.tune import schedulers as ref_schedulers
from ray_tpu_torch import train, tune
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.models.convert import gpt2_params_from_jax
from ray_tpu_torch.tune import schedulers as port_schedulers
from ray_tpu_torch.tune.tune_controller import TuneController
from test_torch_runtime import runtime_defaults

LOSS_TOL = 1e-5  # tests/test_torch_train.py TOL[torch.float32]["loss"]
D64 = dict(embed_dim=256, num_heads=4)

# -- search spaces -----------------------------------------------------------

SPACES = {
    "grid": lambda t: {"a": t.grid_search([1, 2, 3]), "b": t.grid_search(["x", "y"])},
    "uniform": lambda t: {"lr": t.uniform(0.0, 1.0), "c": 3},
    "loguniform": lambda t: {"lr": t.loguniform(1e-5, 1e-1)},
    "randint": lambda t: {"n": t.randint(1, 100)},
    "choice": lambda t: {"act": t.choice(["relu", "gelu", "tanh"])},
    "nested": lambda t: {"model": {"width": t.choice([64, 128]),
                                   "opt": {"lr": t.loguniform(1e-4, 1e-2), "wd": t.grid_search([0.0, 0.1])}},
                         "seed": 7},
    "sample_from": lambda t: {"c": t.sample_from(lambda spec: spec["b"] + 1),
                              "a": t.uniform(1.0, 2.0),
                              "b": t.sample_from(lambda spec: spec["a"] * 2)},
}


@pytest.mark.parametrize("space", list(SPACES))
def test_generate_variants_matches_reference(space):
    for seed, num_samples in itertools.product((0, 1, 5), (1, 4)):
        port = tune.search.generate_variants(SPACES[space](tune), num_samples=num_samples, seed=seed)
        ref = ref_tune.search.generate_variants(SPACES[space](ref_tune), num_samples=num_samples, seed=seed)
        assert port == ref, (seed, num_samples)
        assert len(port) >= num_samples


TPE_SPACE = lambda t: {"lr": t.loguniform(1e-4, 1e-1), "x": t.uniform(-2.0, 2.0),  # noqa: E731
                       "n": t.randint(1, 9), "act": t.choice(["relu", "gelu", "tanh"]),
                       "wd": t.grid_search([0.0, 0.1]), "lr2": t.sample_from(lambda s: s["lr"] * 2)}


@pytest.fixture(scope="module", autouse=True)
def _no_jax_mesh():
    """The JAX package keeps a process-wide current mesh, which its own
    tests leave set in the worker that ran them; its flash attention then
    shards over that mesh.  The references here are single-device."""
    jax_mesh.set_current_mesh(None)


def _objective(cfg):
    return -(math.log10(cfg["lr"]) + 2.5) ** 2 - (cfg["x"] - 0.3) ** 2 + 0.1 * cfg["n"] \
        + {"relu": 0.0, "gelu": 0.2, "tanh": -0.3}[cfg["act"]] + cfg["wd"]


def _suggestions(t, kind, seed):
    if kind == "tpe":
        s = t.TPESearcher(TPE_SPACE(t), metric="score", mode="max", n_startup=4, seed=seed)
    else:  # the Tuner's way: the space and the metric arrive after construction
        s = t.TuneBOHB(n_startup=4, seed=seed, max_trials=14)
        s.set_space(TPE_SPACE(t))
        s.set_search_properties("score", "max")
    out = []
    for i in range(18):
        cfg = s.suggest(f"t{i}")
        out.append(cfg)
        if cfg is None:
            break
        # every fifth trial errors and completes without a result
        s.on_trial_complete(f"t{i}", None if i % 5 == 4 else {"score": _objective(cfg)})
    return out


@pytest.mark.parametrize("kind", ["tpe", "bohb"])
def test_searchers_match_reference(kind):
    for seed in (0, 3):
        port, ref = _suggestions(tune, kind, seed), _suggestions(ref_tune, kind, seed)
        assert port == ref, seed
        assert (port[-1] is None) == (kind == "bohb")


# -- schedulers --------------------------------------------------------------


class _FakeTrial:
    def __init__(self, trial_id, config, checkpoint=None):
        self.trial_id = trial_id
        self.config = config
        self.checkpoint = checkpoint


def _mutation_counter():
    """A callable mutation spec whose values depend only on its own calls."""
    it = itertools.count()
    return lambda: 0.25 + 0.05 * next(it)


SCHEDULERS = {
    "asha": lambda m: m.ASHAScheduler(metric="score", mode="max", max_t=12, grace_period=1,
                                      reduction_factor=2),
    "asha-min": lambda m: m.ASHAScheduler(metric="loss", mode="min", max_t=9, grace_period=2,
                                          reduction_factor=3),
    "async-hyperband": lambda m: m.AsyncHyperBandScheduler(metric="score", mode="max", max_t=12,
                                                           grace_period=1, reduction_factor=2, brackets=3),
    "hyperband-bohb": lambda m: m.HyperBandForBOHB(metric="loss", mode="min", max_t=12, grace_period=2,
                                                   reduction_factor=2, brackets=2),
    "median": lambda m: m.MedianStoppingRule(metric="score", mode="max", grace_period=3,
                                             min_samples_required=2),
    "pbt": lambda m: m.PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=2, quantile_fraction=0.25,
        hyperparam_mutations={"lr": [0.1, 0.5, 1.0, 2.0], "momentum": _mutation_counter()}, seed=3),
    "pbt-resample": lambda m: m.PopulationBasedTraining(
        metric="loss", mode="min", perturbation_interval=3, quantile_fraction=0.5,
        resample_probability=0.6, hyperparam_mutations={"lr": [0.1, 0.5, 1.0, 2.0],
                                                        "momentum": _mutation_counter()}, seed=4),
    "pb2": lambda m: m.PB2(metric="score", mode="max", perturbation_interval=2,
                           hyperparam_bounds={"lr": (0.01, 2.0), "batch": (8, 128)}, seed=3),
}


def _drive(m, name, seed, n_trials=6, steps=12):
    """Feeds a scheduler of package ``m`` a seeded stream of results, as the
    controller would: trials report in a random interleaving, a stopped
    trial reports no more, and a restarted one resumes from the score saved
    in the checkpoint it was handed.  Returns every decision with the
    trial's checkpoint and config (values and types) after it."""
    sched = SCHEDULERS[name](m)
    rng = random.Random(seed)
    trials = [_FakeTrial(f"t{i}", {"lr": [0.1, 0.5, 1.0, 2.0][i % 4], "momentum": 0.9,
                                   "batch": 16 * (i + 1)}) for i in range(n_trials)]
    if hasattr(sched, "set_trials"):
        sched.set_trials(trials)
    it = {t.trial_id: 0 for t in trials}
    score = {t.trial_id: 0.0 for t in trials}
    saved = {}
    live, log = list(trials), []
    while live:
        t = rng.choice(live)
        it[t.trial_id] += 1
        score[t.trial_id] += t.config["lr"] * (0.5 + rng.random()) - 0.01 * t.config["batch"] / 16
        t.checkpoint = f"{t.trial_id}@{it[t.trial_id]}"
        saved[t.checkpoint] = score[t.trial_id]
        result = {"score": score[t.trial_id], "loss": -score[t.trial_id],
                  "training_iteration": it[t.trial_id]}
        decision = sched.on_trial_result(t.trial_id, result)
        log.append((t.trial_id, it[t.trial_id], decision, t.checkpoint,
                    sorted((k, type(v).__name__, v) for k, v in t.config.items())))
        if decision == m.RESTART:
            score[t.trial_id] = saved[t.checkpoint]
        if decision == m.STOP or it[t.trial_id] == steps:
            live.remove(t)
    return log, getattr(sched, "num_perturbations", None)


@pytest.mark.parametrize("name", list(SCHEDULERS))
def test_scheduler_decisions_match_reference(name):
    kinds = set()
    for seed in (0, 1, 2):
        port, ref = _drive(port_schedulers, name, seed), _drive(ref_schedulers, name, seed)
        assert port == ref, seed
        kinds |= {d for _, _, d, _, _ in port[0]}
    # each stream reaches the decisions its scheduler exists for
    want = {"RESTART", "CONTINUE"} if name.startswith(("pbt", "pb2")) else {"STOP", "CONTINUE"}
    assert want <= kinds, kinds


def test_pb2_keeps_int_hyperparameters_int():
    """PB2's explored ``batch`` (int in the config) stays an int, its
    ``lr`` a float (numpy's, as in the reference), both within bounds."""
    log, n = _drive(port_schedulers, "pb2", 0)
    restarted = [cfg for _, _, d, _, cfg in log if d == "RESTART"]
    assert n == len(restarted) > 0
    for cfg in restarted:
        c = {k: (ty, v) for k, ty, v in cfg}
        assert c["batch"][0] == "int" and 8 <= c["batch"][1] <= 128
        assert c["lr"][0] == "float64" and 0.01 <= c["lr"][1] <= 2.0


# -- seams -------------------------------------------------------------------


def test_tpu_key_raises_where_the_tuner_is_made():
    def fn(config):
        pass

    for res in ({"TPU": 1}, {"CPU": 1, "TPU-v5e-8-head": 1}):
        with pytest.raises(ValueError, match='"GPU"'):
            tune.Tuner(tune.with_resources(fn, res))
    tune.Tuner(tune.with_resources(fn, {"CPU": 1, "GPU": 1}))


def test_trial_dirs_default_under_the_session_root():
    from ray_tpu_torch.common.constants import session_root

    c = TuneController(lambda cfg: None, [], experiment_name="exp")
    assert c.experiment_dir == os.path.join(session_root(), "results", "exp")
    assert not c.experiment_dir.startswith("/tmp/ray_tpu_results")


# -- on the port's runtime ---------------------------------------------------


@contextlib.contextmanager
def _functions_by_value(module):
    cloudpickle.register_pickle_by_value(module)
    try:
        yield
    finally:
        cloudpickle.unregister_pickle_by_value(module)


@pytest.fixture(scope="module")
def cluster():
    with runtime_defaults():
        rt.init(num_cpus=4, num_gpus=2, log_to_driver=False)
        try:
            with _functions_by_value(sys.modules[__name__]):
                yield
        finally:
            rt.shutdown()


ASHA_LRS = [3e-4, 1e-3, 3e-3, 1e-2]
ASHA = dict(max_t=8, grace_period=2, reduction_factor=2)


def _synthetic_loss(lr, i):
    return 1.0 / (i + 1) + 1e4 * (lr - 3e-3) ** 2 + 1e-3 * i * (lr > 5e-3)


def _asha_trainable(config):
    from ray_tpu_torch import tune as port_tune

    for i in range(ASHA["max_t"]):
        port_tune.report({"loss": _synthetic_loss(config["lr"], i), "t": time.time(),
                          "visible": os.environ.get("CUDA_VISIBLE_DEVICES"), "pid": os.getpid()})
        time.sleep(0.02)


def _replayed_iterations(sched, results):
    """Per trial: how many results a controller driven by ``sched`` takes
    before its first STOP, results fed in arrival order."""
    ran = {}
    for tid, res in sorted(results, key=lambda r: r[1]["_timestamp"]):
        if ran.get(tid, (0, False))[1]:
            continue
        n = ran.get(tid, (0, False))[0] + 1
        ran[tid] = (n, sched.on_trial_result(tid, dict(res)) == "STOP")
    return {tid: n for tid, (n, _) in ran.items()}


def _overlap(a, b):
    return a[0] < b[1] and b[0] < a[1]


@pytest.mark.usefixtures("cluster")
class TestOnCluster:
    def test_asha_gpu_trials_match_the_reference_replay(self, tmp_path):
        """Four {"GPU": 1} trials under ASHA on two declared cards: each is
        bound a card; trials whose reports overlap in time hold different
        cards; each ran as many iterations as the reference's ASHA decides
        on the same results; trial dirs lie under the run's storage."""
        grid = tune.Tuner(
            tune.with_resources(_asha_trainable, {"GPU": 1}),
            param_space={"lr": tune.grid_search(ASHA_LRS)},
            tune_config=tune.TuneConfig(metric="loss", mode="min", scheduler=tune.ASHAScheduler(**ASHA)),
            run_config=train.RunConfig(name="asha", storage_path=str(tmp_path)),
        ).fit()
        assert not grid.errors
        results = [(r.path, m) for r in grid for m in r.metrics_dataframe]
        ran = {r.path: len(r.metrics_dataframe) for r in grid}
        replay = _replayed_iterations(ref_schedulers.ASHAScheduler(metric="loss", mode="min", **ASHA), results)
        assert ran == replay
        assert max(ran.values()) == ASHA["max_t"] and min(ran.values()) < ASHA["max_t"]
        spans = {}
        for r in grid:
            assert os.path.dirname(r.path) == str(tmp_path / "asha")
            assert {m["visible"] for m in r.metrics_dataframe} <= {"0", "1"}
            assert len({m["visible"] for m in r.metrics_dataframe}) == 1
            spans[r.path] = (r.metrics_dataframe[0]["t"], r.metrics_dataframe[-1]["t"],
                             r.metrics_dataframe[0]["visible"])
        for a, b in itertools.combinations(spans.values(), 2):
            assert not _overlap(a, b) or a[2] != b[2], (a, b)

    def test_tuner_over_torch_trainer(self, tmp_path):
        """Two grid points of a TorchTrainer: the trial actor is leased no
        card and the trainer's worker one; each trial reports once, its
        losses bit-equal to the same steps in process and its first loss
        the JAX model's within LOSS_TOL; the best result's checkpoint holds
        the trial's weights."""
        np_params, tokens = _d64_params(), _tokens()
        base = {"state": _d64_state(np_params), "tokens": torch.from_numpy(tokens).long(), "steps": 2}
        trainer = train.TorchTrainer(
            _trainer_loop, train_loop_config=base,
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
            run_config=train.RunConfig(storage_path=str(tmp_path / "trainer")))
        grid = tune.Tuner(
            trainer, param_space={"train_loop_config": {"lr": tune.grid_search([3e-4, 1e-3])}},
            tune_config=tune.TuneConfig(metric="loss", mode="min"),
            run_config=train.RunConfig(name="over_trainer", storage_path=str(tmp_path)),
        ).fit()
        assert not grid.errors and len(grid) == 2
        jcfg = _d64_jax_config()
        jax_loss = float(jax.jit(lambda p, b: jax_gpt2.loss_fn(p, b, jcfg))(np_params, {"tokens": tokens}))
        for r, lr in zip(grid, (3e-4, 1e-3)):
            assert len(r.metrics_dataframe) == 1
            m = r.metrics
            assert m["trial_cuda_visible_devices"] == "" and m["visible"] in ("0", "1")
            want, _ = _tiny_steps({**base, "lr": lr})
            assert m["losses"] == want, (lr, m["losses"], want)
            assert abs(m["losses"][0] - jax_loss) <= LOSS_TOL
        best = grid.get_best_result(metric="loss", mode="min")
        assert best.metrics["loss"] == min(r.metrics["loss"] for r in grid)
        restored = best.checkpoint.to_state_dict()["model"]
        assert _state_sum(restored) == best.metrics["weights_sum"]

    def test_pbt_with_overlapping_trials(self, tmp_path):
        """The reference's PBT end-to-end run with its trials made to
        overlap: each waits at a file barrier until all four have entered.
        PBT perturbs, the lowest final score is above 10, and an exploited
        trial resumed from its donor's checkpoint."""
        barrier = tmp_path / "barrier"
        barrier.mkdir()
        pbt = tune.PopulationBasedTraining(
            perturbation_interval=4, quantile_fraction=0.25, resample_probability=0.0,
            hyperparam_mutations={"rate": [1.0, 5.0]}, seed=7)
        grid = tune.Tuner(
            _pbt_trainable,
            param_space={"rate": tune.grid_search([5.0, 4.0, 3.0, 0.01]), "barrier": str(barrier)},
            tune_config=tune.TuneConfig(metric="score", mode="max", scheduler=pbt),
            run_config=train.RunConfig(name="pbt", storage_path=str(tmp_path)),
        ).fit()
        assert not grid.errors
        assert all(m["barrier_met"] for r in grid for m in r.metrics_dataframe if "barrier_met" in m)
        assert pbt.num_perturbations >= 1, "PBT never perturbed"
        scores = sorted(r.metrics["score"] for r in grid)
        assert scores[0] > 10, scores
        trial_dirs = {r.path for r in grid}
        resumed = [(r.path, m) for r in grid for m in r.metrics_dataframe if m.get("resumed_from")]
        assert resumed
        for path, m in resumed:
            donor = os.path.dirname(m["resumed_from"])
            assert donor in trial_dirs and donor != path, (path, m["resumed_from"])
            assert m["score"] == m["resumed_score"] + m["rate"]


# -- the trainables ------------------------------------------------------------


def _d64_jax_config():
    return jax_gpt2.GPTConfig.tiny(attention_impl="flash", dtype=jax.numpy.float32, **D64)


def _d64_params():
    """The D = 64 tiny flash GPT-2's weights in the reference's pytree,
    drawn with numpy (norms near 1, biases near 0, all perturbed)."""
    shapes = jax.eval_shape(lambda: jax_gpt2.init(jax.random.key(0), _d64_jax_config()))
    rng = np.random.default_rng(0)

    def draw(path, s):
        base = 1.0 if "scale" in jax.tree_util.keystr(path) else 0.0
        return (base + rng.standard_normal(s.shape) * 0.02).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _d64_config():
    return gpt2.GPTConfig.tiny(attention_impl="flash", dtype=torch.float32, **D64)


def _d64_state(np_params):
    return gpt2_params_from_jax(np_params, _d64_config(), device="cpu").state_dict()


def _tokens():
    return np.random.default_rng(1).integers(0, 256, (2, 129), dtype=np.int32)


def _state_sum(state):
    return sum(float(v.double().sum()) for _, v in sorted(state.items()))


def _tiny_steps(config):
    """``config["steps"]`` AdamW(lr, weight decay 0.1) steps of the D = 64
    tiny flash GPT-2 from ``config["state"]`` on one CPU thread; the
    losses and the model."""
    from ray_tpu_torch.models import gpt2 as port_gpt2
    from ray_tpu_torch.parallel import spmd as port_spmd

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model = port_gpt2.GPT2(port_gpt2.GPTConfig.tiny(attention_impl="flash", dtype=torch.float32,
                                                        embed_dim=256, num_heads=4), "cpu")
        model.load_state_dict(config["state"])
        step = port_spmd.compile_train_step(
            port_gpt2.loss_fn, port_spmd.adamw(model.parameters(), config["lr"], weight_decay=0.1))
        state, losses = port_spmd.TrainState(0, model), []
        for _ in range(config["steps"]):
            state, metrics = step(state, {"tokens": config["tokens"]})
            losses.append(metrics["loss"].item())
        return losses, model
    finally:
        torch.set_num_threads(threads)


def _trainer_loop(config):
    from ray_tpu_torch import train as tr

    losses, model = _tiny_steps(config)
    state = model.state_dict()
    tr.report({"loss": losses[-1], "losses": losses, "weights_sum": _state_sum(state),
               "visible": os.environ.get("CUDA_VISIBLE_DEVICES")},
              checkpoint=tr.Checkpoint.from_state_dict({"model": state}))


def _pbt_trainable(config):
    """The reference's PBT trainable: the score grows by ``rate`` an
    iteration and is carried in the checkpoint; first it waits (60 s at
    most, and says whether it waited out) at a file barrier until the four
    trials have entered."""
    from ray_tpu_torch import train as tr

    sess = tr.session.get_session()
    score, resumed = 0.0, None
    ck = sess.get_checkpoint()
    if ck is not None:
        score, resumed = float(ck.to_dict()["score"]), ck.path
    open(os.path.join(config["barrier"], str(os.getpid())), "w").close()
    deadline = time.time() + 60
    while len(os.listdir(config["barrier"])) < 4 and time.time() < deadline:
        time.sleep(0.02)
    met = len(os.listdir(config["barrier"])) >= 4
    for i in range(32):
        extra = {"resumed_from": resumed, "resumed_score": score} if i == 0 and resumed else {}
        score += float(config["rate"])
        sess.report({"score": score, "rate": float(config["rate"]), "barrier_met": met, **extra},
                    checkpoint=tr.Checkpoint.from_dict({"score": score}))
