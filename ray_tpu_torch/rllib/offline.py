"""Offline RL: episode recording, dataset reading, and behavior cloning
(port of ``ray_tpu/rllib/offline.py``; the recorder and readers copied).

Role-equivalent of ray: rllib/offline/ (JsonWriter/JsonReader,
offline_data.py OfflineData) + rllib/algorithms/bc/ (BCConfig, BC).
Episodes are JSONL — one episode per line with obs/actions/rewards
lists — readable without this framework, like the reference's JSON
sample format.  BC trains the shared MLP RLModule with cross-entropy on
expert actions (the reference's BC loss, rllib/algorithms/bc/bc_learner)
on the learner's device, then evaluates by rolling the learned policy in a
live EnvRunnerGroup — exercising the offline→online loop end to end.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

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
from ray_tpu_torch.rllib.ppo import logp_of

# ---------------------------------------------------------------------------
# Recording + reading
# ---------------------------------------------------------------------------


def record_episodes(
    env_fn,
    policy_fn: Callable[[np.ndarray], int],
    num_episodes: int,
    path: str,
    seed: int = 0,
    max_steps: int = 1000,
) -> Dict[str, float]:
    """Roll `policy_fn` in the env and append one JSONL line per episode
    (ray: rllib/offline/json_writer.py role).  Returns summary stats."""
    import gymnasium as gym

    env = env_fn() if callable(env_fn) else gym.make(env_fn)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    returns = []
    with open(path, "a") as f:
        for ep in range(num_episodes):
            obs, _ = env.reset(seed=seed + ep)
            traj = {"obs": [], "actions": [], "rewards": []}
            for _ in range(max_steps):
                a = int(policy_fn(np.asarray(obs, np.float32)))
                traj["obs"].append(np.asarray(obs, np.float32).tolist())
                traj["actions"].append(a)
                obs, r, term, trunc, _ = env.step(a)
                traj["rewards"].append(float(r))
                if term or trunc:
                    break
            returns.append(sum(traj["rewards"]))
            f.write(json.dumps(traj) + "\n")
    env.close()
    return {
        "episodes": num_episodes,
        "mean_return": float(np.mean(returns)),
    }


def _iter_episodes(paths, env_to_module_fn=None):
    """Yield (obs_array, actions, rewards) per JSONL episode, replaying
    a FRESH connector pipeline per episode when given — exactly the
    transform an online EnvRunner would apply, so offline learners see
    the same input distribution the learned policy will see live.
    Shared by both readers (episode-shaped and transition-shaped)."""
    if isinstance(paths, (str, os.PathLike)):
        paths = [paths]
    for p in paths:
        with open(str(p)) as f:
            for line in f:
                if not line.strip():
                    continue
                ep = json.loads(line)
                ep_obs = np.asarray(ep["obs"], np.float32)
                if env_to_module_fn is not None:
                    pipeline = env_to_module_fn()
                    ep_obs = np.concatenate(
                        [pipeline(step[None, ...]) for step in ep_obs]
                    )
                yield ep_obs, ep["actions"], ep.get("rewards", [])


class JsonEpisodeReader:
    """Read JSONL episode files into flat (obs, action) arrays
    (ray: rllib/offline/json_reader.py JsonReader)."""

    def __init__(self, paths: Sequence[str], env_to_module_fn=None):
        if isinstance(paths, (str, os.PathLike)):
            paths = [paths]
        self.paths = [str(p) for p in paths]
        obs, acts = [], []
        self.num_episodes = 0
        self.mean_return = 0.0
        total_ret = 0.0
        for ep_obs, actions, rewards in _iter_episodes(
            self.paths, env_to_module_fn
        ):
            obs.append(ep_obs)
            acts.extend(actions)
            total_ret += sum(rewards)
            self.num_episodes += 1
        if not obs:
            raise ValueError(f"no episodes found in {self.paths}")
        self.obs = np.concatenate(obs).astype(np.float32)
        self.actions = np.asarray(acts, np.int32)
        self.mean_return = total_ret / max(self.num_episodes, 1)

    def __len__(self) -> int:
        return len(self.actions)

    def iter_batches(self, batch_size: int, rng: np.random.Generator,
                     ) -> Iterator[Dict[str, np.ndarray]]:
        idx = rng.permutation(len(self.actions))
        for i in range(0, len(idx) - batch_size + 1, batch_size):
            sel = idx[i:i + batch_size]
            yield {"obs": self.obs[sel], "actions": self.actions[sel]}


class TransitionReader:
    """Read JSONL episodes into flat (s, a, r, s', done, return-to-go)
    transition arrays — the sample shape value-based offline learners
    (CQL) and advantage-weighted ones (MARWIL) train on (ray:
    rllib/offline/json_reader.py transition batches role).

    Episodes may record one trailing terminal obs (len(obs) ==
    len(actions)+1); it becomes the last step's ``next_obs``.  Without
    it, the last ``next_obs`` repeats its own obs with done=1 — the done
    mask kills the bootstrap, so the value never matters.  Zero-step
    episodes are skipped.  ``returns`` are discounted returns-to-go.
    """

    def __init__(self, paths: Sequence[str], gamma: float = 0.99,
                 env_to_module_fn=None):
        obs_l, act_l, rew_l, nxt_l, done_l, ret_l = [], [], [], [], [], []
        self.num_episodes = 0
        for o, actions, rewards in _iter_episodes(paths, env_to_module_fn):
            r = np.asarray(rewards, np.float32)
            T = len(r)
            if len(actions) != T:
                raise ValueError(
                    f"episode shape mismatch: {len(actions)} actions, "
                    f"{T} rewards (expected equal)"
                )
            if T == 0:
                continue  # zero-step episode: no transitions to learn from
            if len(o) == len(actions) + 1:
                # terminal-obs format: the trailing obs is the real s_T —
                # use it for next_obs instead of repeating s_{T-1}
                nxt = o[1:]
                o = o[: len(actions)]
            elif len(o) == len(actions):
                nxt = np.concatenate([o[1:], o[-1:]])
            else:
                raise ValueError(
                    f"episode shape mismatch: {len(o)} obs, "
                    f"{len(actions)} actions (expected equal, or one "
                    "trailing terminal obs)"
                )
            ret = np.zeros(T, np.float32)
            acc = 0.0
            for t in range(T - 1, -1, -1):
                acc = r[t] + gamma * acc
                ret[t] = acc
            done = np.zeros(T, np.float32)
            done[-1] = 1.0
            obs_l.append(o)
            nxt_l.append(nxt)
            act_l.extend(actions)
            rew_l.append(r)
            done_l.append(done)
            ret_l.append(ret)
            self.num_episodes += 1
        if not obs_l:
            raise ValueError(f"no episodes found in {paths!r}")
        self.obs = np.concatenate(obs_l)
        self.actions = np.asarray(act_l, np.int32)
        self.rewards = np.concatenate(rew_l)
        self.next_obs = np.concatenate(nxt_l)
        self.dones = np.concatenate(done_l)
        self.returns = np.concatenate(ret_l)

    def __len__(self) -> int:
        return len(self.actions)

    def sample(self, batch_size: int, rng: np.random.Generator,
               ) -> Dict[str, np.ndarray]:
        sel = rng.integers(0, len(self.actions), size=batch_size)
        return {
            "obs": self.obs[sel],
            "actions": self.actions[sel],
            "rewards": self.rewards[sel],
            "next_obs": self.next_obs[sel],
            "dones": self.dones[sel],
            "returns": self.returns[sel],
        }


# ---------------------------------------------------------------------------
# Behavior cloning
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BCConfig(AlgorithmConfig):
    lr: float = 1e-3
    train_batch_size: int = 256
    updates_per_iteration: int = 50
    hidden: tuple = (64, 64)
    input_paths: Optional[Sequence[str]] = None
    # rollout evaluation of the cloned policy each iteration
    evaluation_num_steps: int = 200

    def offline_data(self, input_paths) -> "BCConfig":
        return dataclasses.replace(self, input_paths=input_paths)


def bc_loss(module, batch):
    """Negative log-likelihood of the recorded actions."""
    logits, _ = module(batch["obs"])
    _, logp = logp_of(logits, batch["actions"])
    nll = -logp
    return nll.mean(), {"bc_loss": nll.mean()}


class BCLearner(Learner):
    def __init__(self, config: BCConfig, module_config):
        self.config = config
        self.module_config = module_config
        self.device = resolve_device(config.learner_device)
        self.module = core.module_init(
            module_config, torch.Generator().manual_seed(config.seed), self.device
        )
        self._init_optimizer(config.lr)

    def _loss(self, batch):
        return bc_loss(self.module, batch)


class BC(Algorithm):
    def _setup(self, config: BCConfig):
        assert config.input_paths, "BCConfig.offline_data(paths) is required"
        spaces = probe_env_spaces(config.env, config.env_to_module)
        self.module_config = build_module_config(config, spaces)
        self.reader = JsonEpisodeReader(
            config.input_paths, env_to_module_fn=config.env_to_module
        )
        if len(self.reader) < config.train_batch_size:
            raise ValueError(
                f"offline dataset has {len(self.reader)} samples, fewer "
                f"than train_batch_size={config.train_batch_size}; record "
                "more episodes or lower train_batch_size"
            )
        self.learner = BCLearner(config, self.module_config)
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
        batches = self.reader.iter_batches(c.train_batch_size, self._np_rng)
        for _ in range(c.updates_per_iteration):
            try:
                batch = next(batches)
            except StopIteration:
                batches = self.reader.iter_batches(
                    c.train_batch_size, self._np_rng
                )
                batch = next(batches)
            stats = self.learner.update(batch)
            losses.append(float(stats["bc_loss"]))
        learn_time = time.monotonic() - t0
        # evaluation rollout with the cloned weights
        self.env_runner_group.sync_weights(self.learner.get_weights())
        frags = self.env_runner_group.sample(c.evaluation_num_steps)
        ep_returns = np.concatenate(
            [f["episode_returns"] for f in frags]
        ) if frags else np.zeros(0)
        self._record_returns(ep_returns)
        return {
            "bc_loss": float(np.mean(losses)),
            "num_offline_samples": len(self.reader),
            "dataset_mean_return": self.reader.mean_return,
            "learn_time_s": learn_time,
            "episodes_this_iter": len(ep_returns),
        }

    def get_state(self) -> Dict[str, Any]:
        return {"params": self.learner.get_weights()}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.learner.set_weights(state["params"])
        self.env_runner_group.sync_weights(self.learner.get_weights())

    def stop(self) -> None:
        self.env_runner_group.stop()


BCConfig.algo_class = BC
