"""Multi-agent RL: env API, episode collection, and multi-policy PPO
(port of ``ray_tpu/rllib/multi_agent.py``).

Role-equivalent of ray: rllib's multi-agent stack
(rllib/env/multi_agent_env.py MultiAgentEnv,
rllib/env/multi_agent_episode.py:33 MultiAgentEpisode, and the
policies= / policy_mapping_fn= config surface) reduced to the
shapes of this stack: each policy is an independent module with its own
PPOLearner (on the learners' device), a runner actor steps ONE
multi-agent env collecting per-policy episode streams, and GAE runs per
agent stream at episode end — whole episodes per fragment, bootstrapping
0 at true termination and V(s_T) at truncation, with no cross-fragment
value stitching.  The runner's inference runs in torch on the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib import core
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.ppo import PPOConfig, PPOLearner


class MultiAgentEnv:
    """Dict-keyed env contract (ray: MultiAgentEnv).

    reset() -> (obs_dict, info_dict)
    step(action_dict) -> (obs_dict, reward_dict, terminated_dict,
                          truncated_dict, info_dict)
    terminated_dict/truncated_dict carry per-agent flags plus the
    "__all__" episode-end flag.  Only agents present in obs_dict act on
    the next step (agents may come and go mid-episode)."""

    possible_agents: List[str] = []

    def reset(self, *, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, action_dict: Dict[str, Any]):
        raise NotImplementedError


@dataclasses.dataclass
class MultiAgentPPOConfig(PPOConfig):
    #: policy ids; each gets independent params + learner
    policies: tuple = ("default",)
    #: agent_id -> policy id (defaults to everyone on policies[0])
    policy_mapping_fn: Optional[Callable[[str], str]] = None
    episodes_per_runner_sample: int = 4

    def multi_agent(self, *, policies, policy_mapping_fn=None):
        return dataclasses.replace(
            self,
            policies=tuple(policies),
            policy_mapping_fn=policy_mapping_fn,
        )


@ray_tpu_torch.remote
class MultiAgentEnvRunner:
    """Steps one MultiAgentEnv, batching per-step inference per policy
    and emitting per-policy PPO-ready episode batches."""

    def __init__(self, env_fn, module_config, policies, mapping_fn,
                 seed: int, gamma: float, lambda_: float):
        torch.set_num_threads(1)  # one intra-op thread, as env_runner.py's
        self._env = env_fn()
        self._policies = list(policies)
        self._map = mapping_fn or (lambda aid: self._policies[0])
        self._gamma = gamma
        self._lambda = lambda_
        self._modules = {
            p: core.module_init(
                module_config, torch.Generator().manual_seed(seed + i), "cpu"
            )
            for i, p in enumerate(self._policies)
        }
        self._gen = torch.Generator().manual_seed(seed + 10_000)
        self._seed = seed
        self._episode = 0

    def set_weights(self, params_by_policy) -> bool:
        for p, w in params_by_policy.items():
            self._modules[p].load_state_dict(w)
        return True

    def _sample(self, pid, batch):
        with torch.no_grad():
            act, logp, value = core.sample_actions(
                self._modules[pid], torch.from_numpy(batch), self._gen
            )
        return act.numpy(), logp.numpy(), value.numpy()

    def sample(self, num_episodes: int):
        streams: Dict[str, Dict[str, list]] = {
            p: {"obs": [], "actions": [], "logp": [], "advantages": [],
                "returns": []}
            for p in self._policies
        }
        episode_returns = []
        for _ in range(num_episodes):
            self._episode += 1
            obs_d, _ = self._env.reset(seed=self._seed + self._episode)
            # per-agent episode records
            rec: Dict[str, Dict[str, list]] = {}
            # rewards credited to an agent BEFORE its first action
            # (late joiners): deferred onto its first recorded step
            pending_rew: Dict[str, float] = {}
            ep_return = 0.0
            while True:
                agents = list(obs_d)
                # one batched forward PER POLICY over its agents
                actions: Dict[str, int] = {}
                by_policy: Dict[str, list] = {}
                for aid in agents:
                    by_policy.setdefault(self._map(aid), []).append(aid)
                for pid, aids in by_policy.items():
                    batch = np.stack(
                        [np.asarray(obs_d[a], np.float32).ravel()
                         for a in aids]
                    )
                    act, logp, value = self._sample(pid, batch)
                    for j, aid in enumerate(aids):
                        actions[aid] = int(act[j])
                        r = rec.setdefault(aid, {
                            "pid": pid, "obs": [], "actions": [],
                            "logp": [], "values": [], "rewards": [],
                        })
                        r["obs"].append(batch[j])
                        r["actions"].append(int(act[j]))
                        r["logp"].append(float(logp[j]))
                        r["values"].append(float(value[j]))
                        # placeholder keeps rewards aligned with actions
                        # even when the env omits a reward this step;
                        # deferred pre-action rewards land here
                        r["rewards"].append(pending_rew.pop(aid, 0.0))
                obs_d, rew_d, term_d, trunc_d, _ = self._env.step(actions)
                for aid, rew in rew_d.items():
                    ep_return += float(rew)
                    if aid in rec and rec[aid]["rewards"]:
                        # credited to the agent's LAST acted step — also
                        # captures late rewards for agents absent from
                        # this step's obs (e.g. terminal team rewards)
                        rec[aid]["rewards"][-1] += float(rew)
                    else:
                        # reward before the agent's first action (late
                        # joiner): defer to its first step
                        pending_rew[aid] = (
                            pending_rew.get(aid, 0.0) + float(rew)
                        )
                terminated = bool(term_d.get("__all__"))
                truncated = bool(trunc_d.get("__all__"))
                if terminated or truncated:
                    break
            episode_returns.append(ep_return)
            # Truncated (time-limit) episodes bootstrap from V(s_T); true
            # termination bootstraps 0.
            bootstrap: Dict[str, float] = {}
            if truncated and not terminated and obs_d:
                by_policy = {}
                for aid in obs_d:
                    by_policy.setdefault(self._map(aid), []).append(aid)
                for pid, aids in by_policy.items():
                    batch = np.stack(
                        [np.asarray(obs_d[a], np.float32).ravel()
                         for a in aids]
                    )
                    _, _, value = self._sample(pid, batch)
                    for j, aid in enumerate(aids):
                        bootstrap[aid] = float(value[j])
            for aid, r in rec.items():
                T = len(r["actions"])
                if T == 0:
                    continue
                rewards = np.asarray(r["rewards"], np.float32)
                values = np.asarray(r["values"], np.float32)
                adv = np.zeros(T, np.float32)
                last = 0.0
                v_boot = bootstrap.get(aid, 0.0)
                for t in range(T - 1, -1, -1):
                    v_next = values[t + 1] if t + 1 < T else v_boot
                    delta = rewards[t] + self._gamma * v_next - values[t]
                    last = delta + self._gamma * self._lambda * last
                    adv[t] = last
                rets = adv + values
                s = streams[r["pid"]]
                s["obs"].extend(r["obs"])
                s["actions"].extend(r["actions"])
                s["logp"].extend(r["logp"])
                s["advantages"].extend(adv.tolist())
                s["returns"].extend(rets.tolist())
        out = {}
        for pid, s in streams.items():
            if not s["actions"]:
                continue
            adv = np.asarray(s["advantages"], np.float32)
            if adv.std() > 1e-6:
                adv = (adv - adv.mean()) / (adv.std() + 1e-8)
            out[pid] = {
                "obs": np.stack(s["obs"]),
                "actions": np.asarray(s["actions"], np.int32),
                "logp": np.asarray(s["logp"], np.float32),
                "advantages": adv,
                "returns": np.asarray(s["returns"], np.float32),
            }
        return {"batches": out, "episode_returns": episode_returns}


class MultiAgentPPO(Algorithm):
    """One PPOLearner per policy; runners collect per-policy batches."""

    def _setup(self, config: MultiAgentPPOConfig):
        env = config.env() if callable(config.env) else config.env
        obs_d, _ = env.reset(seed=0)
        probe_obs = next(iter(obs_d.values()))
        acts = getattr(env, "num_actions", None)
        if acts is None:
            raise ValueError(
                "MultiAgentEnv must expose `num_actions` (homogeneous "
                "discrete action space)"
            )
        self.module_config = core.MLPModuleConfig(
            obs_dim=int(np.asarray(probe_obs).size),
            num_actions=int(acts),
            hidden=config.hidden,
        )
        self.learners = {
            p: PPOLearner(
                dataclasses.replace(config, seed=config.seed + i),
                self.module_config,
            )
            for i, p in enumerate(config.policies)
        }
        self.runners = [
            MultiAgentEnvRunner.options(num_cpus=0.5).remote(
                config.env, self.module_config, list(config.policies),
                config.policy_mapping_fn, config.seed + 1000 * r,
                config.gamma, config.lambda_,
            )
            for r in range(max(1, config.num_env_runners))
        ]
        self._sync()

    def _sync(self):
        w = {p: lr.get_weights() for p, lr in self.learners.items()}
        ray_tpu_torch.get([r.set_weights.remote(w) for r in self.runners])

    def training_step(self) -> Dict[str, Any]:
        c = self.config
        t0 = time.monotonic()
        results = ray_tpu_torch.get([
            r.sample.remote(c.episodes_per_runner_sample)
            for r in self.runners
        ], timeout=600)
        stats: Dict[str, Any] = {}
        per_policy: Dict[str, List[dict]] = {}
        for res in results:
            self._record_returns(res["episode_returns"])
            for pid, batch in res["batches"].items():
                per_policy.setdefault(pid, []).append(batch)
        steps = 0
        for pid, batches in per_policy.items():
            merged = {
                k: np.concatenate([b[k] for b in batches])
                for k in batches[0]
            }
            steps += len(merged["actions"])
            metrics = self.learners[pid].update(merged)
            for k, v in metrics.items():
                stats[f"{pid}/{k}"] = float(v)
        self._total_steps += steps
        self._sync()
        stats["env_steps"] = steps
        stats["iter_time_s"] = time.monotonic() - t0
        return stats

    def get_state(self) -> Dict[str, Any]:
        return {"params": {p: lr.get_weights() for p, lr in self.learners.items()}}

    def set_state(self, state: Dict[str, Any]) -> None:
        for p, params in state["params"].items():
            self.learners[p].set_weights(params)
        self._sync()

    def stop(self) -> None:
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        self.runners = []


MultiAgentPPOConfig.algo_class = MultiAgentPPO
