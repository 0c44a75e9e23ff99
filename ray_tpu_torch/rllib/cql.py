"""CQL: conservative Q-learning from offline transitions (port of
``ray_tpu/rllib/cql.py``).

Role-equivalent of ray: rllib/algorithms/cql/ (CQLConfig, CQL,
cql_learner's conservative loss) in its DISCRETE form: a double-DQN TD backup over the offline transition dataset plus
the conservative regularizer alpha * E[logsumexp_a Q(s,a) - Q(s,a_data)],
which pushes down out-of-distribution action values so the greedy
policy stays inside the dataset's support.  (The reference builds CQL
on SAC for continuous control; the regularizer — the algorithm's
substance — is identical.)
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

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
from ray_tpu_torch.rllib.dqn import frozen_copy, huber, td_target
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup
from ray_tpu_torch.rllib.learner_group import Learner
from ray_tpu_torch.rllib.offline import TransitionReader


@dataclasses.dataclass
class CQLConfig(AlgorithmConfig):
    lr: float = 3e-4
    gamma: float = 0.99
    cql_alpha: float = 1.0       # conservative-penalty weight
    double_q: bool = True
    target_update_freq: int = 100  # gradient steps between target syncs
    train_batch_size: int = 256
    updates_per_iteration: int = 100
    hidden: tuple = (64, 64)
    input_paths: Optional[Sequence[str]] = None
    evaluation_num_steps: int = 200

    def offline_data(self, input_paths) -> "CQLConfig":
        return dataclasses.replace(self, input_paths=input_paths)


def cql_loss(module, target, batch, config: CQLConfig):
    """Huber TD (double-DQN backup) + cql_alpha × the conservative term."""
    c = config
    q_all, _ = module(batch["obs"])
    q_data = q_all.gather(1, batch["actions"][:, None])[:, 0]
    td_loss = huber(q_data - td_target(module, target, batch, c.gamma, c.double_q))
    # the conservative term: soft-max over ALL actions minus the
    # dataset action's value — OOD actions get pushed down
    cql_term = (torch.logsumexp(q_all, dim=-1) - q_data).mean()
    loss = td_loss + c.cql_alpha * cql_term
    return loss, {
        "td_loss": td_loss,
        "cql_loss": cql_term,
        "total_loss": loss,
        "q_data_mean": q_data.mean(),
    }


class CQLLearner(Learner):
    """TD + conservative penalty; the target network is a frozen copy
    synced every target_update_freq steps (the dqn.py convention)."""

    def __init__(self, config: CQLConfig, module_config):
        self.config = config
        self.module_config = module_config
        self.device = resolve_device(config.learner_device)
        self.module = core.module_init(
            module_config, torch.Generator().manual_seed(config.seed), self.device
        )
        self.target = frozen_copy(self.module)
        self._init_optimizer(config.lr)
        self.grad_steps = 0

    def _loss(self, batch):
        return cql_loss(self.module, self.target, batch, self.config)

    def update(self, batch) -> Dict[str, float]:
        stats = super().update(batch)
        self.grad_steps += 1
        if self.grad_steps % self.config.target_update_freq == 0:
            self.target.load_state_dict(self.module.state_dict())
        return stats


class CQL(Algorithm):
    def _setup(self, config: CQLConfig):
        assert config.input_paths, "CQLConfig.offline_data(paths) is required"
        spaces = probe_env_spaces(config.env, config.env_to_module)
        self.module_config = build_module_config(config, spaces)
        self.reader = TransitionReader(
            config.input_paths, gamma=config.gamma,
            env_to_module_fn=config.env_to_module,
        )
        self.learner = CQLLearner(config, self.module_config)
        self.env_runner_group = EnvRunnerGroup(
            config.env,
            self.module_config,
            num_runners=max(1, config.num_env_runners),
            num_envs_per_runner=config.num_envs_per_runner,
            seed=config.seed,
            env_to_module_fn=config.env_to_module,
        )
        self._np_rng = np.random.default_rng(config.seed)

    def training_step(self) -> Dict[str, Any]:
        c = self.config
        t0 = time.monotonic()
        losses: List[float] = []
        for _ in range(c.updates_per_iteration):
            batch = self.reader.sample(c.train_batch_size, self._np_rng)
            stats = self.learner.update(batch)
            losses.append(float(stats["total_loss"]))
        learn_time = time.monotonic() - t0
        # greedy rollout of the learned Q policy (epsilon 0); unified
        # metric helper — episode-bounded eval is Algorithm.evaluate()
        ep_returns = self._rollout_returns(c.evaluation_num_steps, epsilon=0.0)
        return {
            "total_loss": float(np.mean(losses)),
            "num_offline_samples": len(self.reader),
            "learn_time_s": learn_time,
            "episodes_this_iter": len(ep_returns),
        }

    def get_state(self) -> Dict[str, Any]:
        return {
            "params": self.learner.get_weights(),
            "target_params": core.state_dict_cpu(self.learner.target),
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        self.learner.set_weights(state["params"])
        self.learner.target.load_state_dict(state["target_params"])
        self.env_runner_group.sync_weights(self.learner.get_weights())

    def stop(self) -> None:
        self.env_runner_group.stop()


CQLConfig.algo_class = CQL
