"""DQN: double Q-learning with a replay buffer and target network (port
of ``ray_tpu/rllib/dqn.py``; ``ReplayBuffer`` copied).

Role-equivalent of ray: rllib/algorithms/dqn/dqn.py (DQNConfig:87,
DQN.training_step — sample → store → replay → TD update → target sync)
on the shared Algorithm / LearnerGroup / EnvRunnerGroup stack.  The
module is the same MLP as PPO with the logits head read as Q-values
(core.sample_actions_epsilon), so the two algorithms exercise one
RLModule path the way the reference's RLModule API intends.  A replayed
minibatch moves to the learner's device at each update.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.rllib import core
from ray_tpu_torch.rllib.algorithm import (
    Algorithm,
    AlgorithmConfig,
    build_module_config,
    probe_env_spaces,
)
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup
from ray_tpu_torch.rllib.learner_group import Learner, LearnerGroup


@dataclasses.dataclass
class DQNConfig(AlgorithmConfig):
    # training
    lr: float = 1e-3
    gamma: float = 0.99
    buffer_size: int = 50_000
    learning_starts: int = 500
    train_batch_size: int = 64
    target_update_freq: int = 200  # gradient steps between target syncs
    updates_per_env_step: float = 1.0
    double_q: bool = True
    grad_clip: float = 10.0
    hidden: tuple = (64, 64)
    # exploration: linear ε decay over decay_steps env steps
    epsilon_initial: float = 1.0
    epsilon_final: float = 0.05
    epsilon_decay_steps: int = 5_000
    # replay algos use short fragments by default (field override, so an
    # explicit user value survives the builder chain's dataclasses.replace)
    rollout_fragment_length: int = 16


class ReplayBuffer:
    """Uniform ring buffer of transitions (numpy, host memory).

    ray: rllib/utils/replay_buffers/replay_buffer.py role; sampling is
    the learner-facing API.
    """

    def __init__(self, capacity: int, obs_dim: int):
        self.capacity = capacity
        self.obs = np.zeros((capacity, obs_dim), np.float32)
        self.next_obs = np.zeros((capacity, obs_dim), np.float32)
        self.actions = np.zeros((capacity,), np.int32)
        self.rewards = np.zeros((capacity,), np.float32)
        self.dones = np.zeros((capacity,), np.float32)
        self._next = 0
        self.size = 0

    def add_batch(self, obs, actions, rewards, next_obs, dones):
        n = len(actions)
        idx = (self._next + np.arange(n)) % self.capacity
        self.obs[idx] = obs
        self.next_obs[idx] = next_obs
        self.actions[idx] = actions
        self.rewards[idx] = rewards
        self.dones[idx] = dones
        self._next = int((self._next + n) % self.capacity)
        self.size = min(self.size + n, self.capacity)

    def sample(self, rng: np.random.Generator, n: int) -> Dict[str, np.ndarray]:
        idx = rng.integers(0, self.size, size=n)
        return {
            "obs": self.obs[idx],
            "actions": self.actions[idx],
            "rewards": self.rewards[idx],
            "next_obs": self.next_obs[idx],
            "dones": self.dones[idx],
        }


def huber(td):
    return torch.where(td.abs() < 1.0, 0.5 * td ** 2, td.abs() - 0.5).mean()


def td_target(module, target, batch, gamma: float, double_q: bool):
    """r + γ(1 − d)·Q_target(s', a*), a* the argmax of the online Q at s'
    with double-Q, else of the target's; no gradient flows through it."""
    with torch.no_grad():
        q_next_target, _ = target(batch["next_obs"])
        if double_q:
            best = module(batch["next_obs"])[0].argmax(dim=-1)
        else:
            best = q_next_target.argmax(dim=-1)
        q_next = q_next_target.gather(1, best[:, None])[:, 0]
        return batch["rewards"] + gamma * (1.0 - batch["dones"]) * q_next


def dqn_loss(module, target, batch, config: DQNConfig):
    """Huber TD(0) loss of the online Q against the target network."""
    q_all, _ = module(batch["obs"])
    q = q_all.gather(1, batch["actions"][:, None])[:, 0]
    loss = huber(q - td_target(module, target, batch, config.gamma, config.double_q))
    return loss, {"td_loss": loss, "q_mean": q.mean()}


def frozen_copy(module):
    """A copy of ``module`` that takes no gradient (a target network)."""
    target = copy.deepcopy(module)
    target.requires_grad_(False)
    return target


class DQNLearner(Learner):
    """TD(0) double-DQN update; the target network is a frozen copy that
    syncs by copy every target_update_freq steps."""

    def __init__(self, config: DQNConfig, module_config):
        self.config = config
        self.module_config = module_config
        self.device = resolve_device(config.learner_device)
        self.module = core.module_init(
            module_config, torch.Generator().manual_seed(config.seed), self.device
        )
        self.target = frozen_copy(self.module)
        self._init_optimizer(config.lr, config.grad_clip)
        self.grad_steps = 0

    def _loss(self, batch):
        return dqn_loss(self.module, self.target, batch, self.config)

    def update(self, batch) -> Dict[str, float]:
        metrics = super().update(batch)
        self.grad_steps += 1
        if self.grad_steps % self.config.target_update_freq == 0:
            self.sync_target()
        return metrics

    def sync_target(self):
        self.target.load_state_dict(self.module.state_dict())


class DQN(Algorithm):
    def _setup(self, config: DQNConfig):
        spaces = probe_env_spaces(config.env, config.env_to_module)
        self.module_config = build_module_config(config, spaces)
        cfg, mc = config, self.module_config
        self.learner_group = LearnerGroup(
            lambda: DQNLearner(cfg, mc), num_learners=config.num_learners,
            device=config.learner_device,
        )
        # distributed replicas each hold target params; target syncs are
        # step-count-driven so they stay aligned — track centrally
        self._grad_steps = 0
        self.buffer = ReplayBuffer(config.buffer_size, spaces["obs_dim"])
        self.env_runner_group = EnvRunnerGroup(
            config.env,
            self.module_config,
            num_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_runner,
            seed=config.seed,
            env_to_module_fn=config.env_to_module,
        )
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        self._rng = np.random.default_rng(config.seed)

    def _epsilon(self) -> float:
        c = self.config
        frac = min(1.0, self._total_steps / max(1, c.epsilon_decay_steps))
        return c.epsilon_initial + frac * (c.epsilon_final - c.epsilon_initial)

    def training_step(self) -> Dict[str, Any]:
        c = self.config
        eps = self._epsilon()
        t0 = time.monotonic()
        fragments = self.env_runner_group.sample(
            c.rollout_fragment_length, epsilon=eps
        )
        sample_time = time.monotonic() - t0

        steps_this_iter = 0
        for frag in fragments:
            T, B = frag["actions"].shape
            obs = frag["obs"]  # (T, B, D)
            next_obs = np.concatenate(
                [obs[1:], frag["final_obs"][None]], axis=0
            )
            self.buffer.add_batch(
                obs.reshape(T * B, -1),
                frag["actions"].reshape(-1),
                frag["rewards"].reshape(-1),
                next_obs.reshape(T * B, -1),
                frag["dones"].reshape(-1),
            )
            steps_this_iter += T * B
            self._record_returns(frag["episode_returns"])
        self._total_steps += steps_this_iter

        metrics: Dict[str, float] = {}
        num_updates = 0
        t1 = time.monotonic()
        if self.buffer.size >= c.learning_starts:
            num_updates = max(1, int(steps_this_iter * c.updates_per_env_step))
            for _ in range(num_updates):
                batch = self.buffer.sample(self._rng, c.train_batch_size)
                metrics = self.learner_group.update(batch)
                self._grad_steps += 1
                if (
                    not self.learner_group.is_local
                    and self._grad_steps % c.target_update_freq == 0
                ):
                    # distributed replicas never run DQNLearner.update, so
                    # the target copy is driven centrally
                    self.learner_group.foreach_learner("sync_target")
            self.env_runner_group.sync_weights(
                self.learner_group.get_weights()
            )
        learn_time = time.monotonic() - t1
        return {
            "epsilon": eps,
            "replay_buffer_size": self.buffer.size,
            "num_grad_updates": num_updates,
            "env_steps_this_iter": steps_this_iter,
            "time_sample_s": sample_time,
            "time_learn_s": learn_time,
            **metrics,
        }

    def get_state(self) -> Dict[str, Any]:
        return {"weights": self.learner_group.get_weights()}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.learner_group.set_weights(state["weights"])
        self.env_runner_group.sync_weights(self.learner_group.get_weights())


DQNConfig.algo_class = DQN
