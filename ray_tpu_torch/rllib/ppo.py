"""PPO: config, learner, and the algorithm loop (port of
``ray_tpu/rllib/ppo.py``).

Role-equivalent of ray: rllib/algorithms/ppo/ppo.py (PPOConfig:67,
PPO:393, training_step:419) + core/learner/learner.py:104.  The local
learner's update runs the epochs × shuffled minibatches on its device (the
reference's ``lax.scan`` inside one jit): the GAE-advantaged clipped
surrogate + value + entropy loss, clipped by global norm, Adam.  With
``config.learners(n)`` the update runs on a LearnerGroup instead: n
learner actors doing averaged-gradient data parallelism.

Each update's permutation comes from a ``torch.Generator`` seeded from
the wall clock, as the reference seeds its key (``ppo.py:142``): a batch
no larger than one minibatch is the same update under any permutation.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.rllib import core
from ray_tpu_torch.rllib.algorithm import (
    Algorithm,
    AlgorithmConfig,
    build_module_config,
    probe_env_spaces,
)
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup
from ray_tpu_torch.rllib.learner_group import Learner, LearnerGroup, optimizer_state_cpu


@dataclasses.dataclass
class PPOConfig(AlgorithmConfig):
    lr: float = 3e-4
    gamma: float = 0.99
    lambda_: float = 0.95
    clip_param: float = 0.2
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    num_epochs: int = 4
    minibatch_size: int = 128
    grad_clip: float = 0.5
    hidden: tuple = (64, 64)


def logp_of(logits, actions):
    """(log_softmax of the logits, logp of the given actions)."""
    logp_all = F.log_softmax(logits, dim=-1)
    return logp_all, logp_all.gather(-1, actions[..., None])[..., 0]


def entropy_of(logp_all):
    return -(logp_all.exp() * logp_all).sum(-1).mean()


def clipped_surrogate(ratio, adv, clip_param: float):
    return -torch.minimum(
        ratio * adv, torch.clamp(ratio, 1 - clip_param, 1 + clip_param) * adv
    ).mean()


def ppo_loss(module, batch, config: PPOConfig):
    """Clipped-surrogate + value + entropy loss on one minibatch."""
    c = config
    logits, values = module(batch["obs"])
    logp_all, logp = logp_of(logits, batch["actions"])
    ratio = torch.exp(logp - batch["logp"])
    pg = clipped_surrogate(ratio, batch["advantages"], c.clip_param)
    vf = 0.5 * ((values - batch["returns"]) ** 2).mean()
    entropy = entropy_of(logp_all)
    total = pg + c.vf_coeff * vf - c.entropy_coeff * entropy
    return total, {
        "policy_loss": pg,
        "vf_loss": vf,
        "entropy": entropy,
    }


class PPOLearner(Learner):
    """The local whole update (epochs × minibatches) on the learner's
    device; compute_grads/apply_grads serve the LearnerGroup dp path."""

    def __init__(self, config: PPOConfig, module_config):
        self.config = config
        self.module_config = module_config
        self.device = resolve_device(config.learner_device)
        self.module = core.module_init(
            module_config, torch.Generator().manual_seed(config.seed), self.device
        )
        self._init_optimizer(config.lr, config.grad_clip)

    def _loss(self, batch):
        return ppo_loss(self.module, batch, self.config)

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        c = self.config
        batch = self._batch(batch)
        n = batch["obs"].shape[0]
        mb = min(c.minibatch_size, n)
        num_mb = max(1, n // mb)
        g = torch.Generator().manual_seed(int(time.time_ns()) % (1 << 31))
        sums: Dict[str, torch.Tensor] = {}
        for _ in range(c.num_epochs):
            perm = torch.randperm(n, generator=g).to(self.device)
            for i in range(num_mb):
                sel = perm[i * mb:(i + 1) * mb]
                self.optimizer.zero_grad(set_to_none=True)
                loss, metrics = self._loss({k: v[sel] for k, v in batch.items()})
                loss.backward()
                self._apply()
                for k, v in metrics.items():
                    sums[k] = sums[k] + v.detach() if k in sums else v.detach()
        steps = c.num_epochs * num_mb
        return {k: float(v / steps) for k, v in sums.items()}


def compute_gae(
    rewards, values, dones, last_values, gamma: float, lambda_: float
):
    """GAE over a (T, B) fragment with bootstrap values (B,)."""
    T, B = rewards.shape
    adv = np.zeros((T, B), np.float32)
    last_gae = np.zeros(B, np.float32)
    next_value = last_values
    for t in range(T - 1, -1, -1):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last_gae = delta + gamma * lambda_ * nonterminal * last_gae
        adv[t] = last_gae
        next_value = values[t]
    returns = adv + values
    return adv, returns


class PPO(Algorithm):
    """(ray: Algorithm.step:818 / PPO.training_step:419 analogue.)"""

    def _setup(self, config: PPOConfig):
        spaces = probe_env_spaces(config.env, config.env_to_module)
        self.module_config = build_module_config(config, spaces)
        cfg, mc = config, self.module_config
        self.learner_group = LearnerGroup(
            lambda: PPOLearner(cfg, mc), num_learners=config.num_learners,
            device=config.learner_device,
        )
        self.env_runner_group = EnvRunnerGroup(
            config.env,
            self.module_config,
            num_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_runner,
            seed=config.seed,
            env_to_module_fn=config.env_to_module,
        )
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        self._np_rng = np.random.default_rng(config.seed)

    def training_step(self) -> Dict[str, Any]:
        """One training iteration: sample → GAE → update → sync."""
        c = self.config
        t0 = time.monotonic()
        fragments = self.env_runner_group.sample(c.rollout_fragment_length)
        sample_time = time.monotonic() - t0

        obs, acts, logps, advs, rets = [], [], [], [], []
        for frag in fragments:
            adv, ret = compute_gae(
                frag["rewards"], frag["values"], frag["dones"],
                frag["last_values"], c.gamma, c.lambda_,
            )
            T, B = frag["actions"].shape
            obs.append(frag["obs"].reshape(T * B, -1))
            acts.append(frag["actions"].reshape(-1))
            logps.append(frag["logp"].reshape(-1))
            advs.append(adv.reshape(-1))
            rets.append(ret.reshape(-1))
            self._record_returns(frag["episode_returns"])

        adv_flat = np.concatenate(advs)
        adv_flat = (adv_flat - adv_flat.mean()) / (adv_flat.std() + 1e-8)
        batch = {
            "obs": np.concatenate(obs).astype(np.float32),
            "actions": np.concatenate(acts),
            "logp": np.concatenate(logps),
            "advantages": adv_flat,
            "returns": np.concatenate(rets),
        }
        self._total_steps += len(batch["actions"])

        t1 = time.monotonic()
        metrics = self._update(batch)
        learn_time = time.monotonic() - t1
        t2 = time.monotonic()
        self.env_runner_group.sync_weights(self.learner_group.get_weights())
        sync_time = time.monotonic() - t2

        return {
            "env_steps_this_iter": len(batch["actions"]),
            "time_sample_s": sample_time,
            "time_learn_s": learn_time,
            "time_sync_s": sync_time,
            **metrics,
        }

    def _update(self, batch) -> Dict[str, float]:
        if self.learner_group.is_local:
            # the whole update on the local learner's device
            return self.learner_group.update(batch)
        # dp path: epochs × shuffled minibatches, each one averaged-grad
        # step across the learner replicas
        c = self.config
        n = len(batch["actions"])
        mb = min(c.minibatch_size, n)
        num_mb = max(1, n // mb)
        metrics: Dict[str, float] = {}
        for _ in range(c.num_epochs):
            perm = self._np_rng.permutation(n)
            for i in range(num_mb):
                sel = perm[i * mb:(i + 1) * mb]
                metrics = self.learner_group.update(
                    {k: v[sel] for k, v in batch.items()}
                )
        return metrics

    def get_state(self) -> Dict[str, Any]:
        state = {"params": self.learner_group.get_weights()}
        if self.learner_group.is_local:
            state["opt_state"] = optimizer_state_cpu(self.learner_group.local.optimizer)
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        self.learner_group.set_weights(state["params"])
        if self.learner_group.is_local and "opt_state" in state:
            # torch moves each state tensor to its parameter's device
            self.learner_group.local.optimizer.load_state_dict(state["opt_state"])
        self.env_runner_group.sync_weights(self.learner_group.get_weights())


PPOConfig.algo_class = PPO
