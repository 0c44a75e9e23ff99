"""Algorithm base: the shared train-loop skeleton every algo plugs into
(port of ``ray_tpu/rllib/algorithm.py``).

Role-equivalent of ray: rllib/algorithms/algorithm.py:200 (Algorithm,
train:818) + algorithm_config.py (AlgorithmConfig builder chain): a
subclass provides `_setup` (learners + runners) and `training_step` (one
iteration); the base owns iteration bookkeeping, metric aggregation, and
checkpointing.

The learners run on ``config.learner_device`` (``"cuda"`` unless
``learners(..., device="cpu")`` asks for the CPU; no fallback), the env
runners on the CPU.  A checkpoint holds CPU tensors, so it restores on a
host without a card and onto any learner device.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time
from typing import Any, Dict, List, Optional

import numpy as np


@dataclasses.dataclass
class AlgorithmConfig:
    """Builder-style config (subclasses add their hyperparameters)."""

    env: Optional[Any] = None  # gym env id or callable returning an env
    num_env_runners: int = 2
    num_envs_per_runner: int = 4
    rollout_fragment_length: int = 64
    num_learners: int = 0  # 0 = in-process learner; >=2 = LearnerGroup dp
    # the learners' device; a group of n >= 2 on "cuda" leases a card each
    learner_device: str = "cuda"
    seed: int = 0
    # factory returning a connectors.Pipeline — one fresh (stateful)
    # instance per EnvRunner (ray: config.env_runners(
    # env_to_module_connector=...))
    env_to_module: Optional[Any] = None
    # extra model-catalog options (conv_filters, hidden, ...); the
    # catalog picks CNN vs MLP from the (post-connector) obs shape
    model_config: Optional[dict] = None
    # -- evaluation (ray: rllib/algorithms/algorithm.py:954 evaluate() +
    # evaluation_interval / evaluation_duration on AlgorithmConfig) --
    # every N train() iterations a SEPARATE EnvRunnerGroup rolls the
    # current weights greedily; None/0 disables periodic evaluation
    # (evaluate() can still be called directly)
    evaluation_interval: Optional[int] = None
    evaluation_duration: int = 10  # episodes per evaluation
    evaluation_num_env_runners: int = 1
    evaluation_greedy: bool = True  # argmax actions (else sample policy)

    algo_class = None  # set by subclasses

    def environment(self, env):
        return dataclasses.replace(self, env=env)

    def connectors(self, env_to_module=None):
        return dataclasses.replace(self, env_to_module=env_to_module)

    def env_runners(
        self, num_env_runners=None, num_envs_per_env_runner=None,
        rollout_fragment_length=None,
    ):
        out = self
        if num_env_runners is not None:
            out = dataclasses.replace(out, num_env_runners=num_env_runners)
        if num_envs_per_env_runner is not None:
            out = dataclasses.replace(
                out, num_envs_per_runner=num_envs_per_env_runner
            )
        if rollout_fragment_length is not None:
            out = dataclasses.replace(
                out, rollout_fragment_length=rollout_fragment_length
            )
        return out

    def training(self, **kw):
        return dataclasses.replace(self, **kw)

    def learners(self, num_learners: int, device: Optional[str] = None):
        out = dataclasses.replace(self, num_learners=num_learners)
        if device is not None:
            out = dataclasses.replace(out, learner_device=device)
        return out

    def evaluation(
        self,
        evaluation_interval=None,
        evaluation_duration=None,
        evaluation_num_env_runners=None,
        evaluation_greedy=None,
    ):
        out = self
        if evaluation_interval is not None:
            out = dataclasses.replace(
                out, evaluation_interval=evaluation_interval
            )
        if evaluation_duration is not None:
            out = dataclasses.replace(
                out, evaluation_duration=evaluation_duration
            )
        if evaluation_num_env_runners is not None:
            out = dataclasses.replace(
                out, evaluation_num_env_runners=evaluation_num_env_runners
            )
        if evaluation_greedy is not None:
            out = dataclasses.replace(out, evaluation_greedy=evaluation_greedy)
        return out

    def build(self) -> "Algorithm":
        assert self.algo_class is not None, "config has no algo_class"
        return self.algo_class(self)


def probe_env_spaces(env, env_to_module_fn=None) -> Dict[str, int]:
    """Spin the env up once to read its spaces (ray: Algorithm._get_env_id
    + spaces inference in env_runner setup).  With an env→module
    connector pipeline, obs_dim is the module-side dim AFTER transforms
    (frame stacking widens it, flattening collapses it)."""
    if callable(env):
        probe = env()
    else:
        import gymnasium as gym

        probe = gym.make(env)
    obs_shape = probe.observation_space.shape
    if env_to_module_fn is not None:
        from ray_tpu_torch.rllib.connectors import obs_shape_after

        # the pipeline's OUTPUT shape drives catalog dispatch: a
        # normalize-only pipeline keeps image rank (CNN), FlattenObs
        # collapses it (MLP)
        obs_shape = obs_shape_after(env_to_module_fn(), obs_shape)
    obs_dim = int(np.prod(obs_shape))
    spaces = {
        "obs_dim": obs_dim,
        "obs_shape": tuple(obs_shape),
        "num_actions": int(probe.action_space.n),
    }
    probe.close()
    return spaces


def build_module_config(config, spaces: Dict[str, Any]):
    """Catalog dispatch shared by every algorithm's _setup: rank-3 obs
    (no flattening connector) → CNN family, else MLP
    (ray: rllib/models/catalog.py get_model_v2 role)."""
    from ray_tpu_torch.models.catalog import get_module_config

    model_config = dict(getattr(config, "model_config", None) or {})
    model_config.setdefault("hidden", config.hidden)
    shape = spaces["obs_shape"]
    if len(shape) not in (1, 3):
        raise ValueError(
            f"module catalog supports rank-1 (MLP) or rank-3 HWC (CNN) "
            f"observations, got shape {shape}; add a FlattenObs "
            "connector (config.connectors) for other ranks"
        )
    return get_module_config(shape, spaces["num_actions"], model_config)


class Algorithm:
    """Iteration loop + checkpoint plumbing shared by every algorithm."""

    def __init__(self, config: AlgorithmConfig):
        from ray_tpu_torch.rllib.learner_group import check_learner_cards

        # refused before any env is probed or any process started
        check_learner_cards(config.num_learners, config.learner_device)
        self.config = config
        self.iteration = 0
        self._total_steps = 0
        self._recent_returns: List[float] = []
        self._setup(config)

    # -- subclass hooks --------------------------------------------------
    def _setup(self, config) -> None:
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def get_state(self) -> Dict[str, Any]:
        raise NotImplementedError

    def set_state(self, state: Dict[str, Any]) -> None:
        raise NotImplementedError

    # -- the loop --------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        t0 = time.monotonic()
        metrics = self.training_step()
        self.iteration += 1
        out = {
            "training_iteration": self.iteration,
            "episode_return_mean": (
                float(np.mean(self._recent_returns))
                if self._recent_returns
                else float("nan")
            ),
            "num_env_steps_sampled_lifetime": self._total_steps,
            "time_total_s": time.monotonic() - t0,
        }
        out.update(metrics)
        interval = getattr(self.config, "evaluation_interval", None)
        if interval and self.iteration % interval == 0:
            out["evaluation"] = self.evaluate()
        return out

    # -- evaluation (ray: Algorithm.evaluate, algorithm.py:954) ----------
    def evaluate(self) -> Dict[str, Any]:
        """Roll the CURRENT weights on a dedicated eval EnvRunnerGroup
        (greedy by default) and report unbiased episode metrics —
        training returns come from an exploring, mid-update policy and
        overstate nothing so much as they understate convergence."""
        c = self.config
        group = self._ensure_eval_group()
        group.sync_weights(self._eval_weights())
        t0 = time.monotonic()
        results = group.evaluate(
            num_episodes=c.evaluation_duration,
            greedy=getattr(c, "evaluation_greedy", True),
        )
        returns = np.concatenate([r["episode_returns"] for r in results])
        lengths = np.concatenate([r["episode_lengths"] for r in results])
        return {
            "episode_return_mean": (
                float(returns.mean()) if len(returns) else float("nan")
            ),
            "episode_return_min": (
                float(returns.min()) if len(returns) else float("nan")
            ),
            "episode_return_max": (
                float(returns.max()) if len(returns) else float("nan")
            ),
            "episode_len_mean": (
                float(lengths.mean()) if len(lengths) else float("nan")
            ),
            "num_episodes": int(len(returns)),
            "time_evaluation_s": time.monotonic() - t0,
        }

    def _ensure_eval_group(self):
        group = getattr(self, "_eval_group", None)
        if group is None:
            from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup

            c = self.config
            if getattr(self, "module_config", None) is None:
                raise RuntimeError(
                    "evaluate() needs self.module_config and config.env "
                    "(set up by single-agent algorithms)"
                )
            group = self._eval_group = EnvRunnerGroup(
                c.env,
                self.module_config,
                num_runners=max(
                    1, getattr(c, "evaluation_num_env_runners", 1)
                ),
                num_envs_per_runner=c.num_envs_per_runner,
                seed=c.seed + 777_000,  # decorrelated from training envs
                env_to_module_fn=c.env_to_module,
            )
        return group

    def _eval_weights(self):
        lg = getattr(self, "learner_group", None)
        if lg is not None:
            return lg.get_weights()
        lr = getattr(self, "learner", None)
        if lr is not None:
            return lr.get_weights()
        raise RuntimeError("no learner_group/learner to take weights from")

    def _rollout_returns(self, num_steps: int, epsilon=None) -> np.ndarray:
        """Shared step-bounded policy rollout on the TRAINING runner
        group, feeding the episode_return_mean metric — the offline
        algos' (CQL/MARWIL) only env contact during training.  Episode-
        bounded, unbiased evaluation is evaluate() on the eval group."""
        self.env_runner_group.sync_weights(self._eval_weights())
        frags = self.env_runner_group.sample(num_steps, epsilon=epsilon)
        ep_returns = (
            np.concatenate([f["episode_returns"] for f in frags])
            if frags
            else np.zeros(0)
        )
        self._record_returns(ep_returns)
        return ep_returns

    def _record_returns(self, episode_returns) -> None:
        self._recent_returns.extend(np.asarray(episode_returns).tolist())
        self._recent_returns = self._recent_returns[-100:]

    # -- checkpointing (ray: Algorithm.save/restore) ---------------------
    def save(self, path: str) -> str:
        os.makedirs(path, exist_ok=True)
        state = dict(
            self.get_state(),
            iteration=self.iteration,
            total_steps=self._total_steps,
        )
        with open(os.path.join(path, "algorithm_state.pkl"), "wb") as f:
            pickle.dump(state, f)
        return path

    def restore(self, path: str) -> None:
        with open(os.path.join(path, "algorithm_state.pkl"), "rb") as f:
            state = pickle.load(f)
        self.iteration = state.pop("iteration")
        self._total_steps = state.pop("total_steps")
        self.set_state(state)

    def stop(self) -> None:
        group = getattr(self, "env_runner_group", None)
        if group is not None:
            group.stop()
        eval_group = getattr(self, "_eval_group", None)
        if eval_group is not None:
            eval_group.stop()
        lg = getattr(self, "learner_group", None)
        if lg is not None:
            lg.stop()
