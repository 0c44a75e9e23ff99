"""The port's RLlib on its runtime, on the CPU: learning, checkpoints, the
LearnerGroup over actors, multi-agent PPO, the offline algorithms and the
dry run's pass 8.

Marked slow: every algorithm starts its own env-runner actors, each with a
torch import of its own, and learns for up to tens of iterations; the dry
run's pass spawns gloo ranks.  Run with
``python -m pytest tests/test_zz_torch_rllib.py -m slow``.  Learners run
with ``learners(..., device="cpu")`` at the reference's own test settings
(``tests/test_rllib*.py``); the fast parity tests are
``test_torch_rllib.py``.
"""

import sys

import cloudpickle
import jax
import numpy as np
import optax
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.rllib import core as jax_core
from ray_tpu.rllib import ppo as jax_ppo
from ray_tpu_torch import dryrun
from ray_tpu_torch.models import catalog
from ray_tpu_torch.models.convert import rl_params_to_jax, rl_state_from_jax
from ray_tpu_torch.parallel.launch import run_ranks
from ray_tpu_torch.rllib import (
    APPOConfig,
    BCConfig,
    CQLConfig,
    DQNConfig,
    IMPALAConfig,
    LearnerGroup,
    MARWILConfig,
    MLPModuleConfig,
    MultiAgentEnv,
    MultiAgentPPOConfig,
    PPOConfig,
    PPOLearner,
    SACConfig,
    core,
    record_episodes,
)
from ray_tpu_torch.rllib.connectors import FlattenObs, Pipeline
from ray_tpu_torch.rllib.ppo import ppo_loss
from test_torch_runtime import runtime_defaults

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def cluster():
    """Env callables of this module travel to the runners by value."""
    with runtime_defaults():
        rt.init(num_cpus=4, log_to_driver=False)
        cloudpickle.register_pickle_by_value(sys.modules[__name__])
        try:
            yield
        finally:
            cloudpickle.unregister_pickle_by_value(sys.modules[__name__])
            rt.shutdown()


def _learn(config, iterations, goal):
    """Train up to ``iterations`` times or until the mean return reaches
    ``goal``; (first finite mean, best mean, last result)."""
    algo = config.learners(0, device="cpu").build()
    first, best, result = None, -np.inf, {}
    try:
        for _ in range(iterations):
            result = algo.train()
            r = result["episode_return_mean"]
            if not np.isnan(r):
                first = r if first is None else first
                best = max(best, r)
            if best >= goal:
                break
    finally:
        algo.stop()
    return first, best, result


@pytest.mark.usefixtures("cluster")
class TestLearning:
    def test_ppo_cartpole_learns(self):
        first, best, _ = _learn(
            PPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=8, rollout_fragment_length=64)
            .training(lr=3e-3, num_epochs=6, minibatch_size=256, entropy_coeff=0.01), 15, 80)
        assert first is not None and best >= 80, (first, best)

    def test_dqn_cartpole_learns(self):
        _, best, _ = _learn(
            DQNConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=1, num_envs_per_env_runner=8, rollout_fragment_length=32)
            .training(lr=1e-3, train_batch_size=64, learning_starts=500, target_update_freq=250,
                      epsilon_decay_steps=4000, updates_per_env_step=0.5), 40, 80)
        assert best >= 80, best

    def test_impala_cartpole_improves(self):
        first, best, result = _learn(
            IMPALAConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4, rollout_fragment_length=32)
            .training(lr=5e-3, entropy_coeff=0.005, updates_per_iteration=8), 20, 80.01)
        assert first is not None and best > max(45.0, first * 1.3), (first, best)
        assert result["fragments_consumed"] == 8

    def test_appo_cartpole_improves(self):
        first, best, result = _learn(
            APPOConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=2, num_envs_per_env_runner=4, rollout_fragment_length=32)
            .training(lr=5e-3, entropy_coeff=0.003, updates_per_iteration=8, clip_param=0.3), 20, 80.01)
        assert first is not None and best > max(45.0, first * 1.3), (first, best)
        assert 0.2 < result["mean_ratio"] < 5.0

    def test_sac_cartpole_improves(self):
        first, best, result = _learn(
            SACConfig().environment("CartPole-v1")
            .env_runners(num_env_runners=1, num_envs_per_env_runner=4, rollout_fragment_length=32)
            .training(lr=5e-3, alpha_lr=1e-2, learning_starts=256, train_batch_size=256,
                      target_entropy_scale=0.3, updates_per_env_step=0.5, tau=0.02), 40, 80.01)
        assert first is not None and best > max(45.0, first * 1.3), (first, best)
        assert 0.0 < result.get("alpha", 1.0) < 100.0


@pytest.mark.usefixtures("cluster")
class TestEvaluationAndCheckpoints:
    def test_evaluate_reports_separately(self):
        algo = (PPOConfig().environment("CartPole-v1")
                .env_runners(num_env_runners=1, num_envs_per_env_runner=4, rollout_fragment_length=32)
                .training(lr=3e-3, num_epochs=3, minibatch_size=128)
                .evaluation(evaluation_interval=2, evaluation_duration=6, evaluation_num_env_runners=1)
                .learners(0, device="cpu").build())
        try:
            assert "evaluation" not in algo.train()
            r2 = algo.train()
            ev = r2["evaluation"]
            assert ev["num_episodes"] >= 6 and np.isfinite(ev["episode_return_mean"])
            assert ev["episode_return_min"] <= ev["episode_return_max"] and ev["episode_len_mean"] > 0
            assert ev["episode_return_mean"] != r2["episode_return_mean"]
            assert algo.evaluate()["num_episodes"] >= 6
        finally:
            algo.stop()

    @pytest.mark.parametrize("make", [
        lambda: PPOConfig().env_runners(num_env_runners=1, num_envs_per_env_runner=2, rollout_fragment_length=16),
        lambda: DQNConfig().env_runners(num_env_runners=1, num_envs_per_env_runner=2, rollout_fragment_length=8)
        .training(learning_starts=16),
        lambda: IMPALAConfig().env_runners(num_env_runners=1, num_envs_per_env_runner=2, rollout_fragment_length=16)
        .training(updates_per_iteration=2),
        lambda: SACConfig().env_runners(num_env_runners=1, num_envs_per_env_runner=2, rollout_fragment_length=16)
        .training(learning_starts=32, train_batch_size=32),
    ], ids=["ppo", "dqn", "impala", "sac"])
    def test_save_restore(self, make, tmp_path):
        """The checkpoint holds CPU tensors; a fresh algorithm restores its
        weights (and PPO's Adam state) and its iteration count goes on."""
        config = make().environment("CartPole-v1").learners(0, device="cpu")
        algo = config.build()
        algo.train()
        path = algo.save(str(tmp_path / "ckpt"))
        it, state = algo.iteration, algo.get_state()
        algo.stop()
        key = "weights" if "weights" in state else "params"  # DQN's name, as the reference's
        assert all(t.device.type == "cpu" for t in state[key].values())
        algo2 = config.build()
        try:
            algo2.restore(path)
            assert algo2.iteration == it
            restored = algo2.get_state()
            assert all(torch.equal(restored[key][k], v) for k, v in state[key].items())
            if "opt_state" in state:
                for i, s in state["opt_state"]["state"].items():
                    assert all(torch.equal(v, restored["opt_state"]["state"][i][k]) for k, v in s.items())
            assert algo2.train()["training_iteration"] == it + 1
        finally:
            algo2.stop()


@pytest.mark.usefixtures("cluster")
class TestLearnerGroup:
    def _batch(self):
        rng = np.random.default_rng(1)
        n = 64
        return {"obs": rng.normal(size=(n, 4)).astype(np.float32),
                "actions": rng.integers(0, 2, n).astype(np.int32),
                "logp": np.full(n, -0.693, np.float32),
                "advantages": rng.normal(size=n).astype(np.float32),
                "returns": rng.normal(size=n).astype(np.float32)}

    def test_two_learner_update_matches_single(self):
        """The averaged-gradient step of 2 learner actors equals one local
        learner's step on the whole batch."""
        mc, cfg = MLPModuleConfig(obs_dim=4, num_actions=2), PPOConfig(lr=1e-2, seed=5, learner_device="cpu")
        local = PPOLearner(cfg, mc)
        grads, _ = local.compute_grads(self._batch())
        local.apply_grads(grads)
        group = LearnerGroup(lambda: PPOLearner(cfg, mc), num_learners=2, device="cpu")
        try:
            group.update(self._batch())
            got = group.get_weights()
        finally:
            group.stop()
        for k, v in local.get_weights().items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=1e-5, rtol=1e-5, err_msg=k)

    @pytest.mark.parametrize("wire", [None, "bf16", "int8"])
    def test_weight_wire_keeps_replicas_bit_identical(self, wire):
        mc, cfg = MLPModuleConfig(obs_dim=4, num_actions=2), PPOConfig(lr=1e-2, seed=5, learner_device="cpu")
        group = LearnerGroup(lambda: PPOLearner(cfg, mc), num_learners=2, weight_wire_dtype=wire, device="cpu")
        try:
            group.update(self._batch())
            rng = np.random.default_rng(2)
            group.set_weights({k: torch.from_numpy(rng.normal(size=v.shape).astype(np.float32))
                               for k, v in group.get_weights().items()})
            a, b = group.foreach_learner("get_weights")
            assert all(torch.equal(a[k], b[k]) for k in a)
        finally:
            group.stop()


class TwoLeverTeam(MultiAgentEnv):
    """The reference test's env: two agents each pull the lever that pays
    this round (obs a one-hot of 2), 16 steps; random play averages 16."""

    possible_agents = ["a0", "a1"]
    num_actions = 2

    def __init__(self):
        self._rng, self._t, self._good = np.random.default_rng(0), 0, 0

    def _obs(self):
        one_hot = np.zeros(2, np.float32)
        one_hot[self._good] = 1.0
        return {a: one_hot.copy() for a in self.possible_agents}

    def reset(self, *, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t, self._good = 0, int(self._rng.integers(0, 2))
        return self._obs(), {}

    def step(self, action_dict):
        rew = {a: float(action_dict[a] == self._good) for a in self.possible_agents}
        self._t += 1
        self._good = int(self._rng.integers(0, 2))
        done = self._t >= 16
        term = {a: done for a in self.possible_agents}
        term["__all__"] = done
        return self._obs(), rew, term, {"__all__": False}, {}


@pytest.mark.usefixtures("cluster")
class TestMultiAgent:
    def test_two_policies_learn(self):
        first, best, result = _learn(
            MultiAgentPPOConfig().environment(TwoLeverTeam).env_runners(num_env_runners=2)
            .training(lr=5e-3, entropy_coeff=0.001, num_epochs=4, minibatch_size=64,
                      episodes_per_runner_sample=4)
            .multi_agent(policies=("left", "right"),
                         policy_mapping_fn=lambda aid: "left" if aid == "a0" else "right"), 25, 28.01)
        assert first is not None and best > 24, (first, best)
        assert any(k.startswith("left/") for k in result) and any(k.startswith("right/") for k in result)

    def test_checkpoint_roundtrip(self, tmp_path):
        algo = (MultiAgentPPOConfig().environment(TwoLeverTeam).env_runners(num_env_runners=1)
                .training(episodes_per_runner_sample=2).multi_agent(policies=("p0",))
                .learners(0, device="cpu").build())
        try:
            algo.train()
            path = algo.save(str(tmp_path / "ckpt"))
            state = algo.get_state()
            algo.train()
            algo.restore(path)
            now = algo.learners["p0"].get_weights()
            assert all(torch.equal(now[k], v) for k, v in state["params"]["p0"].items())
        finally:
            algo.stop()


def cartpole_expert(obs):
    return 1 if (obs[2] + 0.5 * obs[3]) > 0 else 0


def _mixed_dataset(tmp_path):
    rng = np.random.default_rng(7)
    path = str(tmp_path / "mixed.jsonl")
    assert record_episodes("CartPole-v1", cartpole_expert, num_episodes=30, path=path)["mean_return"] > 80
    record_episodes("CartPole-v1", lambda obs: int(rng.integers(2)), num_episodes=10, path=path, seed=10_000)
    return path


@pytest.mark.usefixtures("cluster")
class TestOffline:
    def test_bc_clones_expert(self, tmp_path):
        path = str(tmp_path / "expert.jsonl")
        assert record_episodes("CartPole-v1", cartpole_expert, num_episodes=40, path=path)["mean_return"] > 80
        algo = (BCConfig().environment("CartPole-v1").env_runners(num_env_runners=1, num_envs_per_env_runner=4)
                .training(lr=3e-3, updates_per_iteration=120, evaluation_num_steps=250)
                .offline_data([path]).learners(0, device="cpu").build())
        try:
            for _ in range(4):
                last = algo.train()
            assert last["bc_loss"] < 0.45 and last["episode_return_mean"] > 60, last
        finally:
            algo.stop()

    def test_marwil_learns_from_mixed_data(self, tmp_path):
        algo = (MARWILConfig().environment("CartPole-v1").env_runners(num_env_runners=1, num_envs_per_env_runner=4)
                .training(lr=3e-3, beta=2.0, updates_per_iteration=250, evaluation_num_steps=250)
                .offline_data([_mixed_dataset(tmp_path)]).learners(0, device="cpu").build())
        try:
            for _ in range(6):
                last = algo.train()
            assert np.isfinite(last["total_loss"]) and last["adv_sq_moving_avg"] > 0
            assert last["episode_return_mean"] > 50, last
        finally:
            algo.stop()

    def test_cql_learns_from_mixed_data(self, tmp_path):
        algo = (CQLConfig().environment("CartPole-v1").env_runners(num_env_runners=1, num_envs_per_env_runner=4)
                .training(lr=1e-3, cql_alpha=1.0, updates_per_iteration=200, evaluation_num_steps=250)
                .offline_data([_mixed_dataset(tmp_path)]).learners(0, device="cpu").build())
        try:
            for _ in range(4):
                last = algo.train()
            assert np.isfinite(last["total_loss"]) and last["episode_return_mean"] > 50, last
        finally:
            algo.stop()


def make_image_env():
    """The reference test's synthetic image env: obs (8, 8, 1), reward for
    action 1, 10 steps."""
    import gymnasium as gym

    class ImgEnv(gym.Env):
        observation_space = gym.spaces.Box(0, 1, (8, 8, 1), np.float32)
        action_space = gym.spaces.Discrete(2)

        def __init__(self):
            self._t = 0

        def reset(self, *, seed=None, options=None):
            self._t = 0
            return np.zeros((8, 8, 1), np.float32), {}

        def step(self, action):
            self._t += 1
            return np.full((8, 8, 1), self._t / 10.0, np.float32), float(action), self._t >= 10, False, {}

    return ImgEnv()


@pytest.mark.usefixtures("cluster")
class TestCatalogInAlgorithms:
    def test_ppo_builds_cnn_for_image_env(self):
        algo = (PPOConfig().environment(make_image_env)
                .env_runners(num_env_runners=1, num_envs_per_env_runner=2, rollout_fragment_length=10)
                .training(model_config={"conv_filters": ((4, 3, 2),), "hidden": (16,)},
                          num_epochs=1, minibatch_size=10)
                .learners(0, device="cpu").build())
        try:
            assert isinstance(algo.module_config, catalog.CNNModuleConfig)
            assert np.isfinite(algo.train()["policy_loss"])
        finally:
            algo.stop()

    def test_flatten_connector_forces_mlp(self):
        algo = (DQNConfig().environment(make_image_env)
                .env_runners(num_env_runners=1, num_envs_per_env_runner=2)
                .connectors(env_to_module=lambda: Pipeline([FlattenObs()]))
                .training(hidden=(16,), learning_starts=10, train_batch_size=8)
                .learners(0, device="cpu").build())
        try:
            assert isinstance(algo.module_config, core.MLPModuleConfig)
            assert algo.module_config.obs_dim == 64
            algo.train()
        finally:
            algo.stop()


# -- the dry run's pass 8 ---------------------------------------------------------

def _reference_pass8(batch):
    """The reference's pass 8 on one device: the seed-11 weights, the PPO
    loss of the whole batch and one optax.adam(3e-4) step."""
    cfg = jax_ppo.PPOConfig(hidden=(32, 32))
    mc = jax_core.MLPModuleConfig(4, 2, (32, 32))
    params = jax_core.module_init(jax.random.key(11), mc)
    opt = optax.adam(3e-4)
    (loss, _), grads = jax.value_and_grad(
        lambda p: jax_ppo.ppo_loss(p, batch, cfg, forward_fn=jax_core.get_forward(mc)), has_aux=True)(params)
    updates, _ = opt.update(grads, opt.init(params), params)
    return jax.tree.map(np.asarray, params), float(loss), jax.tree.map(np.asarray, optax.apply_updates(params, updates))


def _seeded_batch(n):
    rng = np.random.default_rng(3)
    B = 4 * n
    return {"obs": torch.from_numpy(rng.normal(size=(B, 4)).astype(np.float32)),
            "actions": torch.from_numpy(rng.integers(0, 2, B)),
            "logp": torch.from_numpy((np.log(0.5) + 0.2 * rng.normal(size=B)).astype(np.float32)),
            "advantages": torch.from_numpy(rng.normal(size=B).astype(np.float32)),
            "returns": torch.from_numpy(rng.normal(size=B).astype(np.float32))}


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_pass8_matches_reference_and_one_rank(n):
    """On the reference's zero batch, from the reference's seed-11 weights,
    every rank's loss is the reference's pass-8 loss; on a seeded batch the
    ranks' dp update equals the reference's single-device step and the
    port's own one-rank update on the whole batch (1e-6)."""
    jax_batch = {k: v.numpy() for k, v in dryrun.rl_batch(n).items()}
    init, want_loss, _ = _reference_pass8(jax_batch)
    weights = rl_state_from_jax(init)
    outs = run_ranks(dryrun.rllib_dp_update, n, n, "cpu", weights, None, backend="gloo", timeout=300)
    for loss, _ in outs:
        np.testing.assert_allclose(loss, want_loss, rtol=1e-6)

    batch = _seeded_batch(n)
    _, want_loss, want_params = _reference_pass8({k: v.numpy() for k, v in batch.items()})
    outs = run_ranks(dryrun.rllib_dp_update, n, n, "cpu", weights, batch, backend="gloo", timeout=300)
    module = core.module_init(MLPModuleConfig(4, 2, (32, 32)), None, "cpu")
    module.load_state_dict(weights)
    opt = torch.optim.Adam(module.parameters(), lr=3e-4)
    loss, _ = ppo_loss(module, {k: v.long() if k == "actions" else v for k, v in batch.items()},
                       PPOConfig(hidden=(32, 32)))
    loss.backward()
    opt.step()
    single = module.state_dict()
    for loss_n, got in outs:
        assert all(torch.equal(got[k], outs[0][1][k]) for k in got)  # replicas agree bit for bit
        np.testing.assert_allclose(loss_n, loss.item(), rtol=1e-6)
        np.testing.assert_allclose(loss_n, want_loss, rtol=1e-6)
        for k in single:
            np.testing.assert_allclose(got[k].numpy(), single[k].numpy(), atol=1e-6, err_msg=k)
    back = rl_params_to_jax(module)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want_params)):
        np.testing.assert_allclose(a, b, atol=1e-6)
