"""EnvRunner: vectorized gym envs stepping in an actor (port of
``ray_tpu/rllib/env_runner.py``).

Role-equivalent of ray: rllib/env/single_agent_env_runner.py:40
(SingleAgentEnvRunner) + env_runner_group.py:66 (EnvRunnerGroup) +
rollout_ops.py:20 (synchronous_parallel_sample).  CPU actors produce
fixed-length rollout fragments; policy inference runs in torch on the CPU
inside the runner, explicitly (the runner's lease holds no card, and the
raylet gives it ``CUDA_VISIBLE_DEVICES=""``), with weights synced from the
learner each iteration as CPU state dicts.  Sampling draws from a
``torch.Generator`` seeded ``seed + 10_000``, as the reference seeds its
key.  The podracer plane's runner methods (``sample_podracer``,
``set_weights_versioned``, ``join_weight_broadcast``) put each fragment
into the store here and tag it with the learner version of the weights
that sampled it.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib import core


@ray_tpu_torch.remote
class EnvRunnerActor:
    def __init__(self, env_fn, module_config, num_envs: int, seed: int,
                 env_to_module_fn=None):
        import gymnasium as gym

        # the lease holds one CPU: inference on a few rows takes one
        # intra-op thread (more only contend with the other runners)
        torch.set_num_threads(1)
        self._envs = gym.vector.SyncVectorEnv(
            [self._make_env_fn(env_fn, seed + i) for i in range(num_envs)]
        )
        self._num_envs = num_envs
        self._config = module_config
        # the family's module (MLP or catalog CNN), on the CPU
        self._module = core.module_init(
            module_config, torch.Generator().manual_seed(seed), "cpu"
        )
        self._gen = torch.Generator().manual_seed(seed + 10_000)
        # each runner owns its connector pipeline instance so stateful
        # transforms (frame stacks, running normalizers) stay runner-local
        # (ray: per-EnvRunner ConnectorV2 instances)
        self._env_to_module = (
            env_to_module_fn() if env_to_module_fn is not None else None
        )
        self._obs, _ = self._envs.reset(seed=seed)
        self._prev_done = np.zeros(num_envs, bool)
        self._proc = self._process(self._obs)
        # per-env running episode returns for metrics
        self._ep_return = np.zeros(num_envs, np.float64)
        self._completed: List[float] = []
        # podracer-plane bookkeeping: which learner version these params
        # are, and a per-runner fragment counter (the bit-repro key)
        self._policy_version = 0
        self._frag_seq = 0

    def _process(self, obs) -> np.ndarray:
        """Connector-transform a raw obs batch.

        Per-env connector state resets ONE STEP AFTER done: gymnasium
        >= 1.0 vector envs autoreset in NEXT_STEP mode, so the obs
        returned on the done step is still the OLD episode's terminal
        observation — the new episode's first obs arrives on the
        following step, and that is the one that must re-seed stacks."""
        if self._env_to_module is None:
            return obs.astype(np.float32)
        for i in np.nonzero(self._prev_done)[0]:
            self._env_to_module.reset(int(i))
        self._prev_done[:] = False
        return self._env_to_module(obs)

    @staticmethod
    def _make_env_fn(env_fn, seed):
        def make():
            env = env_fn() if callable(env_fn) else None
            if env is None:
                import gymnasium as gym

                env = gym.make(env_fn)
            return env

        return make

    def set_weights(self, params) -> bool:
        self._module.load_state_dict(params)
        return True

    def set_weights_versioned(self, params, policy_version: int) -> int:
        """Put-path weight sync that also stamps the learner version the
        podracer plane tags fragments with."""
        self._module.load_state_dict(params)
        self._policy_version = int(policy_version)
        return self._policy_version

    def get_weights(self):
        return core.state_dict_cpu(self._module)

    def ping(self) -> bool:
        return True

    def evaluate(
        self,
        num_episodes: int,
        greedy: bool = True,
        max_env_steps: int = 200_000,
    ) -> Dict[str, np.ndarray]:
        """Run until ``num_episodes`` episodes complete; greedy takes
        argmax over the module's first head (policy logits or Q-values —
        both maximize correctly), else samples the policy.  Meant for
        DEDICATED eval runners (ray: evaluation EnvRunnerGroup,
        algorithm.py:954): it advances this runner's env/connector state.
        """
        returns: List[float] = []
        lengths: List[int] = []
        ep_len = np.zeros(self._num_envs, np.int64)
        steps = 0
        while len(returns) < num_episodes and steps < max_env_steps:
            with torch.no_grad():
                obs = torch.from_numpy(self._proc)
                if greedy:
                    head, _ = self._module(obs)
                    action = np.argmax(head.numpy(), axis=-1).astype(np.int32)
                else:
                    a, _, _ = core.sample_actions(self._module, obs, self._gen)
                    action = a.numpy().astype(np.int32)
            self._obs, reward, term, trunc, _ = self._envs.step(action)
            done = np.logical_or(term, trunc)
            self._proc = self._process(self._obs)
            self._prev_done |= done
            self._ep_return += reward
            ep_len += 1
            steps += self._num_envs
            for i in np.nonzero(done)[0]:
                returns.append(float(self._ep_return[i]))
                lengths.append(int(ep_len[i]))
                self._ep_return[i] = 0.0
                ep_len[i] = 0
        return {
            "episode_returns": np.asarray(returns, np.float64),
            "episode_lengths": np.asarray(lengths, np.int64),
        }

    def sample(
        self, num_steps: int, epsilon: Optional[float] = None
    ) -> Dict[str, np.ndarray]:
        """Collect a fragment of num_steps per env; returns flat arrays
        plus bootstrap values for GAE at the fragment boundary.

        epsilon=None samples the categorical policy (on-policy algos);
        a float switches to ε-greedy over Q-values (DQN-family)."""
        B, T = self._num_envs, num_steps
        obs_buf = np.zeros((T, B) + self._proc.shape[1:], np.float32)
        act_buf = np.zeros((T, B), np.int32)
        rew_buf = np.zeros((T, B), np.float32)
        done_buf = np.zeros((T, B), np.float32)
        logp_buf = np.zeros((T, B), np.float32)
        val_buf = np.zeros((T, B), np.float32)

        for t in range(T):
            with torch.no_grad():
                obs = torch.from_numpy(self._proc)
                if epsilon is None:
                    action, logp, value = core.sample_actions(
                        self._module, obs, self._gen
                    )
                else:
                    action, logp, value = core.sample_actions_epsilon(
                        self._module, obs, self._gen, float(epsilon),
                    )
            action = action.numpy().astype(np.int32)
            obs_buf[t] = self._proc
            act_buf[t] = action
            logp_buf[t] = logp.numpy()
            val_buf[t] = value.numpy()
            self._obs, reward, term, trunc, _ = self._envs.step(action)
            done = np.logical_or(term, trunc)
            self._proc = self._process(self._obs)
            # flag AFTER processing: under NEXT_STEP autoreset this obs is
            # the old episode's terminal one; the reset obs arrives next
            # step and _process will re-seed connector state then
            self._prev_done |= done
            rew_buf[t] = reward
            done_buf[t] = done
            self._ep_return += reward
            for i in np.nonzero(done)[0]:
                self._completed.append(float(self._ep_return[i]))
                self._ep_return[i] = 0.0

        # bootstrap value of the next obs (for the unfinished fragment tail)
        with torch.no_grad():
            _, last_val = self._module(torch.from_numpy(self._proc))
        episode_returns = self._completed
        self._completed = []
        return {
            "obs": obs_buf,
            "actions": act_buf,
            "rewards": rew_buf,
            "dones": done_buf,
            "logp": logp_buf,
            "values": val_buf,
            "last_values": last_val.numpy().astype(np.float32),
            # the observation AFTER the final step: replay-buffer algos
            # need next_obs for the fragment tail (module view, i.e.
            # post-connector)
            "final_obs": np.asarray(self._proc, np.float32),
            "episode_returns": np.asarray(episode_returns, np.float64),
        }

    # -- podracer plane --------------------------------------------------
    def sample_podracer(self, num_steps: int, epsilon: Optional[float] = None):
        """Free-running fragment production: sample, put the payload into
        the shm arena HERE (vectored write; inline slab when tiny), and
        return only ``(meta, ref)`` — the driver routes the few-dozen-byte
        meta and forwards the ref to the learner, whose arg-unpack
        resolves it over the direct-shm get path.  Payload bytes never
        transit the driver at any fragment size."""
        frag = self.sample(num_steps, epsilon)
        meta = {
            "runner_index": -1,  # stamped by the driver (stable across
            "seq": self._frag_seq,  # replaces; the actor can't know it)
            "policy_version": self._policy_version,
            "env_steps": int(num_steps * self._num_envs),
            "suspect": False,
            "incarnation": 0,
        }
        self._frag_seq += 1
        return meta, ray_tpu_torch.put(frag)

    def join_weight_broadcast(
        self, group_name: str, root_rank: int = 0,
        wire_dtype: Optional[str] = None,
    ) -> int:
        """Member side of the podracer weight fan-out: one collective
        receive replaces a per-runner put.  The skeleton carries the
        policy version exactly; with a quantized ``wire_dtype`` every
        rank (root included) adopts the same decode, so the fleet ends
        bit-identical."""
        from ray_tpu_torch.util import collective as col

        out = col.broadcast_tree(
            None, src_rank=root_rank, group_name=group_name,
            wire_dtype=wire_dtype,
        )
        self._module.load_state_dict(out["w"])
        self._policy_version = int(out["v"])
        return self._policy_version

    def sync_weights_bcast(
        self, params, group_name: str, root_rank: int = 0,
        wire_dtype: Optional[str] = None,
    ) -> bool:
        """Collective-routed ``EnvRunnerGroup.sync_weights`` leg.  The
        root receives the params with the call (arg-unpack from one shm
        ref) and broadcasts; members pass ``params=None`` and receive.
        Every rank adopts the broadcast result, so a quantized wire still
        leaves all replicas bit-identical."""
        from ray_tpu_torch.util import collective as col

        out = col.broadcast_tree(
            params, src_rank=root_rank, group_name=group_name,
            wire_dtype=wire_dtype,
        )
        self._module.load_state_dict(out)
        return True


class EnvRunnerGroup:
    """N rollout actors + synchronous parallel sampling.

    ``sync_weights`` routes through ``col.broadcast_tree`` over a lazily
    created persistent group (runner 0 = root) — one shm put to the root
    plus one collective instead of N per-actor puts, mirroring the
    LearnerGroup fan-out path.  ``weight_wire_dtype`` opts into the
    block-quantized wire (replicas still bit-identical: every rank,
    root included, adopts the decode).  Any collective failure trips a
    permanent fallback to the legacy put path, so weight sync never
    gets less reliable than it was.
    """

    def __init__(
        self,
        env_fn,
        module_config,
        num_runners: int = 2,
        num_envs_per_runner: int = 4,
        seed: int = 0,
        env_to_module_fn=None,
        weight_wire_dtype: Optional[str] = None,
    ):
        # spawn args kept so a dead runner can be stateless-restarted
        # (podracer replace_runner) with a decorrelated seed
        self._spawn = dict(
            env_fn=env_fn, module_config=module_config,
            num_envs_per_runner=num_envs_per_runner, seed=seed,
            env_to_module_fn=env_to_module_fn,
        )
        self.weight_wire_dtype = weight_wire_dtype
        self._sync_group: Optional[str] = None
        self._col_broken = False
        self.runners = [
            self._spawn_runner(i) for i in range(num_runners)
        ]

    def _spawn_runner(self, index: int, incarnation: int = 0):
        s = self._spawn
        # decorrelate replacement streams from every prior incarnation
        seed = s["seed"] + 1000 * index + 101 * incarnation
        return EnvRunnerActor.options(num_cpus=1).remote(
            s["env_fn"], s["module_config"], s["num_envs_per_runner"],
            seed, s["env_to_module_fn"],
        )

    def replace_runner(self, index: int, incarnation: int = 1):
        """Stateless-restart a dead runner in place (env runners carry no
        state worth migrating — the podracer failure contract)."""
        old = self.runners[index]
        try:
            ray_tpu_torch.kill(old)
        except Exception:
            pass
        self.runners[index] = self._spawn_runner(index, incarnation)
        # the old group membership is poisoned; the podracer runner
        # re-forms its own fan-out group, ours is rebuilt on next sync
        self._drop_sync_group()
        return self.runners[index]

    def sample(
        self, num_steps: int, epsilon: Optional[float] = None
    ) -> List[Dict[str, np.ndarray]]:
        # No fixed deadline: the first sample sits behind the torch import
        # in the runner; a dead runner fails the get with ActorDiedError.
        return ray_tpu_torch.get(
            [r.sample.remote(num_steps, epsilon) for r in self.runners]
        )

    def evaluate(
        self, num_episodes: int, greedy: bool = True
    ) -> List[Dict[str, np.ndarray]]:
        """Split the episode budget across runners (ceil per runner so
        the total is >= num_episodes, like evaluation_duration)."""
        n = len(self.runners)
        per = max(1, -(-num_episodes // n))
        return ray_tpu_torch.get(
            [r.evaluate.remote(per, greedy) for r in self.runners]
        )

    def sync_weights(self, params) -> None:
        if len(self.runners) >= 2 and not self._col_broken:
            try:
                self._sync_weights_collective(params)
                return
            except Exception:
                # poisoned group / op failure: weight sync must never be
                # less reliable than the legacy path — fall back for good
                self._col_broken = True
                self._drop_sync_group()
        ref = ray_tpu_torch.put(params)  # one copy in the store, N borrowers
        ray_tpu_torch.get([r.set_weights.remote(ref) for r in self.runners])

    def _sync_weights_collective(self, params) -> None:
        """One put (to the root) + one broadcast_tree instead of N puts."""
        import uuid

        from ray_tpu_torch.common.config import cfg
        from ray_tpu_torch.util import collective as col

        if self._sync_group is None:
            name = f"env-runner-sync-{uuid.uuid4().hex[:8]}"
            col.create_collective_group(self.runners, group_name=name)
            self._sync_group = name
        ref = ray_tpu_torch.put(params)
        refs = [
            r.sync_weights_bcast.remote(
                ref if i == 0 else None, self._sync_group, 0,
                self.weight_wire_dtype,
            )
            for i, r in enumerate(self.runners)
        ]
        ray_tpu_torch.get(refs, timeout=cfg.collective_op_timeout_s)

    def _drop_sync_group(self):
        if self._sync_group is None:
            return
        name, self._sync_group = self._sync_group, None
        from ray_tpu_torch.util import collective as col

        try:
            col.destroy_collective_group(name, actors=self.runners)
        except Exception:
            pass  # dead members mustn't block the rebuild

    def stop(self):
        self._drop_sync_group()
        for r in self.runners:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        self.runners = []
