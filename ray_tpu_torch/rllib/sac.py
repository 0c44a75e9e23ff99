"""SAC (discrete): twin soft-Q critics, categorical policy, learned
temperature (port of ``ray_tpu/rllib/sac.py``).

Role-equivalent of ray: rllib/algorithms/sac/sac.py (SACConfig, SAC) in
its discrete-action form (Christodoulou 2019, arXiv:1910.07207), on this
stack's replay-based shapes (shared with DQN): sample → store → replay
→ one soft actor-critic update on the learner's device → polyak target
sync.

Discrete SAC computes exact expectations over actions (no
reparameterization): soft state value
V(s) = Σ_a π(a|s)[min(Q1t, Q2t)(s, a) − α log π(a|s)], critic targets
y = r + γ(1−d)V(s'), actor loss E_s Σ_a π(a|s)[α log π(a|s) − minQ(s,a)],
and α is trained toward a target entropy.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.parallel.spmd import adam
from ray_tpu_torch.rllib import core
from ray_tpu_torch.rllib.algorithm import (
    Algorithm,
    AlgorithmConfig,
    build_module_config,
    probe_env_spaces,
)
from ray_tpu_torch.rllib.dqn import ReplayBuffer, frozen_copy
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup
from ray_tpu_torch.rllib.learner_group import Learner, clip_by_global_norm_


@dataclasses.dataclass
class SACConfig(AlgorithmConfig):
    lr: float = 3e-4
    alpha_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.01             # polyak factor for target critics
    buffer_size: int = 50_000
    learning_starts: int = 500
    train_batch_size: int = 128
    updates_per_env_step: float = 1.0
    target_entropy_scale: float = 0.5  # H_target = scale * log(|A|)
    initial_alpha: float = 1.0
    grad_clip: float = 10.0
    hidden: tuple = (64, 64)
    rollout_fragment_length: int = 16


class SACModules(nn.Module):
    """The policy, the twin critics and their polyak targets (three
    independent modules of one family; the value heads of the Q nets are
    unused) and the temperature's ``log_alpha``, under the reference's
    names ``pi``, ``q1``, ``q2``, ``q1_t``, ``q2_t``, ``log_alpha``."""

    def __init__(self, pi, q1, q2, initial_alpha: float):
        super().__init__()
        self.pi, self.q1, self.q2 = pi, q1, q2
        self.q1_t = frozen_copy(q1)
        self.q2_t = frozen_copy(q2)
        self.log_alpha = nn.Parameter(
            torch.log(torch.tensor(initial_alpha, dtype=torch.float32)).to(q1.pi.w.device)
        )

    def trainable(self):
        return [p for m in (self.pi, self.q1, self.q2) for p in m.parameters()]


def sac_init(config: SACConfig, module_config, device) -> SACModules:
    g = torch.Generator().manual_seed(config.seed)
    pi, q1, q2 = (core.module_init(module_config, g, device) for _ in range(3))
    return SACModules(pi, q1, q2, config.initial_alpha)


def sac_loss(m: SACModules, batch, config: SACConfig):
    """Critic + actor loss of discrete SAC at the current temperature."""
    c = config
    alpha = m.log_alpha.detach().exp()
    obs, nobs, a = batch["obs"], batch["next_obs"], batch["actions"]

    # critic targets from the CURRENT policy at s'
    with torch.no_grad():
        nlogp = F.log_softmax(m.pi(nobs)[0], dim=-1)
        minq_t = torch.minimum(m.q1_t(nobs)[0], m.q2_t(nobs)[0])
        v_next = (nlogp.exp() * (minq_t - alpha * nlogp)).sum(-1)
        y = batch["rewards"] + c.gamma * (1.0 - batch["dones"]) * v_next
    q1, q2 = m.q1(obs)[0], m.q2(obs)[0]  # logits heads read as Q values
    q1_sa = q1.gather(1, a[:, None])[:, 0]
    q2_sa = q2.gather(1, a[:, None])[:, 0]
    critic = 0.5 * (((q1_sa - y) ** 2).mean() + ((q2_sa - y) ** 2).mean())

    # actor: expected soft value under π at s (critics frozen)
    logp = F.log_softmax(m.pi(obs)[0], dim=-1)
    probs = logp.exp()
    minq = torch.minimum(q1, q2).detach()
    actor = (probs * (alpha * logp - minq)).sum(-1).mean()
    entropy = -(probs * logp).sum(-1).mean()
    return critic + actor, {
        "critic_loss": critic,
        "actor_loss": actor,
        "entropy": entropy,
        "alpha": alpha,
    }


class SACLearner(Learner):
    """One update: the critic + actor loss through the clipped Adam of
    the three trainable modules, the temperature toward the target
    entropy with its own Adam, then the polyak sync of the targets."""

    def __init__(self, config: SACConfig, module_config):
        self.config = config
        self.module_config = module_config
        self.device = resolve_device(config.learner_device)
        self.module = sac_init(config, module_config, self.device)
        self.grad_clip = config.grad_clip
        self.optimizer = adam(self.module.trainable(), config.lr)
        self.alpha_opt = adam([self.module.log_alpha], config.alpha_lr)
        self.target_entropy = config.target_entropy_scale * float(
            np.log(module_config.num_actions)
        )

    def _loss(self, batch):
        return sac_loss(self.module, batch, self.config)

    def _apply(self):
        grads = [p.grad for p in self.module.trainable() if p.grad is not None]
        clip_by_global_norm_(grads, self.grad_clip)
        self.optimizer.step()

    def update(self, batch) -> Dict[str, float]:
        m, tau = self.module, self.config.tau
        metrics = self._grads(batch)
        self._apply()
        # temperature toward the target entropy: α grows while the
        # policy is below target entropy, shrinks above it (the gradient
        # of log_alpha · sg(entropy − target))
        m.log_alpha.grad = (metrics["entropy"] - self.target_entropy).reshape(())
        self.alpha_opt.step()
        # polyak critic-target sync
        with torch.no_grad():
            for tgt, src in ((m.q1_t, m.q1), (m.q2_t, m.q2)):
                for t, s in zip(tgt.parameters(), src.parameters()):
                    t.copy_((1 - tau) * t + tau * s)
        return {k: float(v) for k, v in metrics.items()}

    def pi_weights(self):
        """The policy's weights, which the env runners sample from."""
        return core.state_dict_cpu(self.module.pi)


class SAC(Algorithm):
    def _setup(self, config: SACConfig):
        spaces = probe_env_spaces(config.env, config.env_to_module)
        self.module_config = build_module_config(config, spaces)
        self.learner = SACLearner(config, self.module_config)
        self.buffer = ReplayBuffer(config.buffer_size, spaces["obs_dim"])
        self._rng = np.random.default_rng(config.seed)
        self.env_runner_group = EnvRunnerGroup(
            config.env,
            self.module_config,
            num_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_runner,
            seed=config.seed,
            env_to_module_fn=config.env_to_module,
        )
        self._sync()

    def _sync(self):
        # runners sample from the categorical policy head
        self.env_runner_group.sync_weights(self.learner.pi_weights())

    def training_step(self) -> Dict[str, Any]:
        c = self.config
        t0 = time.monotonic()
        # on-policy categorical sampling (no epsilon): SAC's exploration
        # is the policy's own entropy, held up by the temperature
        frags = self.env_runner_group.sample(c.rollout_fragment_length)
        env_steps = 0
        for frag in frags:
            T, B = frag["actions"].shape
            obs = frag["obs"]
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
            env_steps += T * B
            self._record_returns(frag["episode_returns"])
        self._total_steps += env_steps
        stats: Dict[str, Any] = {"env_steps": env_steps}
        if self.buffer.size >= c.learning_starts:
            n_updates = max(1, int(env_steps * c.updates_per_env_step))
            metrics: Dict[str, Any] = {}
            for _ in range(n_updates):
                batch = self.buffer.sample(self._rng, c.train_batch_size)
                metrics = self.learner.update(batch)
            stats.update({k: float(v) for k, v in metrics.items()})
            stats["updates"] = n_updates
            self._sync()
        stats["iter_time_s"] = time.monotonic() - t0
        return stats

    def _eval_weights(self):
        # the eval runners run the policy (the reference hands them the
        # whole composite, which its module cannot read)
        return self.learner.pi_weights()

    def get_state(self) -> Dict[str, Any]:
        return {"params": self.learner.get_weights()}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.learner.set_weights(state["params"])
        self._sync()

    def stop(self) -> None:
        self.env_runner_group.stop()


SACConfig.algo_class = SAC
