"""MARWIL: monotonic advantage re-weighted imitation learning (port of
``ray_tpu/rllib/marwil.py``).

Role-equivalent of ray: rllib/algorithms/marwil/ (MARWILConfig, MARWIL,
marwil_learner's loss): offline episodes, per-step
discounted returns-to-go, advantages A = R - V(s), and a policy loss
that re-weights behavior cloning by exp(beta * A / c) where c^2 tracks
a moving average of E[A^2] (the paper's normalizer).  ``beta = 0``
degenerates to plain BC, exactly like the reference.  The value head
trains on A^2 in the same update.
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
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup
from ray_tpu_torch.rllib.learner_group import Learner
from ray_tpu_torch.rllib.offline import TransitionReader
from ray_tpu_torch.rllib.ppo import logp_of


@dataclasses.dataclass
class MARWILConfig(AlgorithmConfig):
    lr: float = 1e-3
    gamma: float = 0.99
    beta: float = 1.0            # 0 = plain BC
    vf_coeff: float = 1.0
    moving_average_sqd_adv_norm_update_rate: float = 1e-2
    max_advantage_weight: float = 20.0  # exp-weight clip
    train_batch_size: int = 256
    updates_per_iteration: int = 50
    hidden: tuple = (64, 64)
    input_paths: Optional[Sequence[str]] = None
    evaluation_num_steps: int = 200

    def offline_data(self, input_paths) -> "MARWILConfig":
        return dataclasses.replace(self, input_paths=input_paths)


def marwil_loss(module, batch, config: MARWILConfig):
    """Advantage-weighted NLL + vf_coeff × E[A²]; ``batch["adv_sq_ma"]``
    is c², the normalizer."""
    c = config
    logits, value = module(batch["obs"])
    adv = batch["returns"] - value
    # the exp weight sees advantages as DATA (detached): the policy term
    # must not push V around, the vf term does that
    adv_data = adv.detach()
    norm = torch.sqrt(batch["adv_sq_ma"] + 1e-8)
    weight = torch.clamp(torch.exp(c.beta * adv_data / norm), max=c.max_advantage_weight)
    _, logp_a = logp_of(logits, batch["actions"])
    policy_loss = -(weight * logp_a).mean()
    vf_loss = (adv ** 2).mean()
    loss = policy_loss + c.vf_coeff * vf_loss
    return loss, {
        "policy_loss": policy_loss,
        "vf_loss": vf_loss,
        "total_loss": loss,
        "mean_advantage_sq": (adv_data ** 2).mean(),
        "mean_weight": weight.mean(),
    }


class MARWILLearner(Learner):
    def __init__(self, config: MARWILConfig, module_config):
        self.config = config
        self.module_config = module_config
        self.device = resolve_device(config.learner_device)
        self.module = core.module_init(
            module_config, torch.Generator().manual_seed(config.seed), self.device
        )
        self._init_optimizer(config.lr)
        # c^2: moving average of squared advantages (the normalizer);
        # rides inside the batch, as the reference's jitted loss takes it
        self.adv_sq_ma = 1.0

    def _loss(self, batch):
        return marwil_loss(self.module, batch, self.config)

    def _batch(self, batch):
        return super()._batch(dict(batch, adv_sq_ma=np.float32(self.adv_sq_ma)))

    def update(self, batch) -> Dict[str, float]:
        stats = super().update(batch)
        # paper: c^2 <- c^2 + rate * (E[A^2] - c^2)
        rate = self.config.moving_average_sqd_adv_norm_update_rate
        self.adv_sq_ma += rate * (stats["mean_advantage_sq"] - self.adv_sq_ma)
        return stats


class MARWIL(Algorithm):
    def _setup(self, config: MARWILConfig):
        assert config.input_paths, (
            "MARWILConfig.offline_data(paths) is required"
        )
        spaces = probe_env_spaces(config.env, config.env_to_module)
        self.module_config = build_module_config(config, spaces)
        self.reader = TransitionReader(
            config.input_paths, gamma=config.gamma,
            env_to_module_fn=config.env_to_module,
        )
        self.learner = MARWILLearner(config, self.module_config)
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
        # policy rollout via the unified metric helper — episode-bounded
        # eval is Algorithm.evaluate()
        ep_returns = self._rollout_returns(c.evaluation_num_steps)
        return {
            "total_loss": float(np.mean(losses)),
            "adv_sq_moving_avg": self.learner.adv_sq_ma,
            "num_offline_samples": len(self.reader),
            "learn_time_s": learn_time,
            "episodes_this_iter": len(ep_returns),
        }

    def get_state(self) -> Dict[str, Any]:
        return {
            "params": self.learner.get_weights(),
            "adv_sq_ma": self.learner.adv_sq_ma,
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        self.learner.set_weights(state["params"])
        self.learner.adv_sq_ma = state["adv_sq_ma"]
        self.env_runner_group.sync_weights(self.learner.get_weights())

    def stop(self) -> None:
        self.env_runner_group.stop()


MARWILConfig.algo_class = MARWIL
