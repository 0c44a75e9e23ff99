"""IMPALA: asynchronous actor-learner with V-trace off-policy correction
(port of ``ray_tpu/rllib/impala.py``).

Role-equivalent of ray: rllib/algorithms/impala/ (IMPALAConfig, IMPALA,
vtrace) on this stack's shapes: EnvRunner actors sample continuously
and NEVER gang-block the learner — the algorithm keeps one in-flight
sample per runner, updates on whichever fragment lands first (V-trace
correcting for the policy lag), syncs fresh weights to that runner
only, and immediately relaunches it.  The update (V-trace targets +
policy gradient + value + entropy loss) runs on the learner's device.

V-trace (Espeholt et al. 2018, arXiv:1802.01561): with behavior logp μ
(recorded by the runner at sample time) and target logp π (current
learner policy), truncated importance weights ρ=min(ρ̄, π/μ),
c=min(c̄, π/μ) give corrected value targets

    v_s = V_s + δ_s + γ c_s (v_{s+1} − V_{s+1}),
    δ_s = ρ_s (r_s + γ V_{s+1} − V_s)

computed by a reverse loop over the fragment.

``throughput_mode="podracer"`` moves the learner into the Podracer
plane's learner actor (on its leased card unless the config asks for the
CPU), fed by a free-running CPU fleet (``rllib/podracer/``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

import ray_tpu_torch
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
from ray_tpu_torch.rllib.ppo import entropy_of, logp_of


@dataclasses.dataclass
class IMPALAConfig(AlgorithmConfig):
    lr: float = 5e-4
    gamma: float = 0.99
    vtrace_rho_clip: float = 1.0
    vtrace_c_clip: float = 1.0
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    grad_clip: float = 40.0
    hidden: tuple = (64, 64)
    # how many fragments to consume per training_step call
    updates_per_iteration: int = 4
    # "podracer" routes the loop onto the podracer throughput plane
    # (free-running fleet + central learner actor + collective weight
    # fan-out); None keeps the in-driver loop
    throughput_mode: Optional[str] = None
    podracer_batch_fragments: int = 2
    podracer_max_policy_lag: int = 4
    podracer_weight_sync_period: int = 1
    # None = exact fp32 fan-out; "bf16"/"int8" = block-quantized
    podracer_weight_wire_dtype: Optional[str] = None


def vtrace(behavior_logp, target_logp, rewards, values, dones, last_values,
           gamma: float, rho_clip: float, c_clip: float):
    """V-trace targets + pg advantages over a (T, B) fragment.

    Returns (vs (T, B), pg_adv (T, B)), both functions of the inputs only
    (callers detach as needed).  The reference's reverse ``lax.scan`` is a
    loop over T here."""
    rho = torch.clamp(torch.exp(target_logp - behavior_logp), max=rho_clip)
    c = torch.clamp(torch.exp(target_logp - behavior_logp), max=c_clip)
    nonterminal = 1.0 - dones
    # V_{s+1}: shift values down; bootstrap last_values at the fragment end
    values_next = torch.cat([values[1:], last_values[None, :]], dim=0)
    delta = rho * (rewards + gamma * values_next * nonterminal - values)
    acc = torch.zeros_like(last_values)  # v_{s+1} − V_{s+1}
    vs_minus_v = [None] * delta.shape[0]
    for t in range(delta.shape[0] - 1, -1, -1):
        acc = delta[t] + gamma * c[t] * nonterminal[t] * acc
        vs_minus_v[t] = acc
    vs = values + torch.stack(vs_minus_v)
    vs_next = torch.cat([vs[1:], last_values[None, :]], dim=0)
    pg_adv = rho * (rewards + gamma * vs_next * nonterminal - values)
    return vs, pg_adv


def vtrace_terms(module, batch, config):
    """The forward over a (T, B) batch and its V-trace targets: (logp_all,
    target logp of the taken actions, values, vs, pg_adv), vs and pg_adv
    computed from detached values (the reference's stop_gradient)."""
    c = config
    T, B = batch["actions"].shape
    logits, values = module(batch["obs"].reshape(T * B, -1))
    logits = logits.reshape(T, B, -1)
    values = values.reshape(T, B)
    _, last_values = module(batch["last_obs"])
    logp_all, tgt_logp = logp_of(logits, batch["actions"])
    vs, pg_adv = vtrace(
        batch["logp"], tgt_logp.detach(), batch["rewards"], values.detach(),
        batch["dones"], last_values.detach(),
        c.gamma, c.vtrace_rho_clip, c.vtrace_c_clip,
    )
    return logp_all, tgt_logp, values, vs, pg_adv


def impala_loss(module, batch, config: IMPALAConfig):
    """batch: obs (T,B,F), actions (T,B), logp (T,B, behavior), rewards,
    dones (T,B), last_obs (B,F)."""
    c = config
    logp_all, tgt_logp, values, vs, pg_adv = vtrace_terms(module, batch, c)
    pg = -(tgt_logp * pg_adv).mean()
    vf = 0.5 * ((values - vs) ** 2).mean()
    entropy = entropy_of(logp_all)
    total = pg + c.vf_coeff * vf - c.entropy_coeff * entropy
    return total, {
        "policy_loss": pg,
        "vf_loss": vf,
        "entropy": entropy,
        "mean_rho": torch.exp(tgt_logp.detach() - batch["logp"]).mean(),
    }


class IMPALALearner(Learner):
    def __init__(self, config: IMPALAConfig, module_config):
        self.config = config
        self.module_config = module_config
        self.device = resolve_device(config.learner_device)
        self.module = core.module_init(
            module_config, torch.Generator().manual_seed(config.seed), self.device
        )
        self._init_optimizer(config.lr, config.grad_clip)

    def _loss(self, batch):
        return impala_loss(self.module, batch, self.config)


def impala_batch_from_fragments(frags) -> Dict[str, np.ndarray]:
    """Stack rollout fragments along the env (B) axis into one V-trace
    batch — the podracer learner's batch assembler.  Fragments share T
    (one ``rollout_fragment_length``); B may differ per runner."""
    obs = np.concatenate([f["obs"] for f in frags], axis=1)
    last_obs = np.concatenate(
        [f["final_obs"].reshape(f["obs"].shape[1], -1) for f in frags],
        axis=0,
    )
    return {
        "obs": obs.astype(np.float32),
        "actions": np.concatenate([f["actions"] for f in frags], axis=1),
        "logp": np.concatenate([f["logp"] for f in frags], axis=1),
        "rewards": np.concatenate([f["rewards"] for f in frags], axis=1),
        "dones": np.concatenate([f["dones"] for f in frags], axis=1),
        "last_obs": last_obs,
    }


class IMPALA(Algorithm):
    """Async decoupled actor-learner (ray: impala.py training_step's
    aggregated async sampling, minus the GPU aggregation actors the
    single-learner case doesn't need).

    ``throughput_mode="podracer"`` swaps the in-driver update loop for
    the podracer plane: the learner moves into a dedicated actor fed by
    a free-running fleet over shm fragment refs, with staleness-bounded
    batching (V-trace is exactly the correction that makes the extra
    policy lag sound) and collective weight fan-out."""

    learner_cls = IMPALALearner  # overridden by APPO

    def _setup(self, config: IMPALAConfig):
        self._inflight = {}
        self._podracer = None
        if getattr(config, "throughput_mode", None) == "podracer":
            self._setup_podracer(config)
            return
        spaces = probe_env_spaces(config.env, config.env_to_module)
        self.module_config = build_module_config(config, spaces)
        self.learner = self.learner_cls(config, self.module_config)
        self.env_runner_group = EnvRunnerGroup(
            config.env,
            self.module_config,
            num_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_runner,
            seed=config.seed,
            env_to_module_fn=config.env_to_module,
        )
        self.env_runner_group.sync_weights(self.learner.get_weights())
        # one standing sample per runner — the async pipeline
        self._inflight = {
            r.sample.remote(config.rollout_fragment_length): r
            for r in self.env_runner_group.runners
        }

    def _setup_podracer(self, config: IMPALAConfig):
        import functools

        from ray_tpu_torch.rllib.podracer import (
            PodracerConfig,
            PodracerRunner,
            check_learner_card,
        )

        # refused before any env is probed or any process started
        check_learner_card(config.learner_device)
        spaces = probe_env_spaces(config.env, config.env_to_module)
        self.module_config = build_module_config(config, spaces)
        self.env_runner_group = EnvRunnerGroup(
            config.env,
            self.module_config,
            num_runners=config.num_env_runners,
            num_envs_per_runner=config.num_envs_per_runner,
            seed=config.seed,
            env_to_module_fn=config.env_to_module,
        )
        # the learner lives in the podracer actor, not this process
        self.learner = None
        self._podracer = PodracerRunner(
            self.env_runner_group,
            functools.partial(self.learner_cls, config, self.module_config),
            impala_batch_from_fragments,
            PodracerConfig(
                rollout_fragment_length=config.rollout_fragment_length,
                batch_fragments=config.podracer_batch_fragments,
                max_policy_lag=config.podracer_max_policy_lag,
                weight_sync_period=config.podracer_weight_sync_period,
                weight_wire_dtype=config.podracer_weight_wire_dtype,
                learner_device=config.learner_device,
            ),
        )

    def _eval_weights(self):
        if self._podracer is not None:
            return self._podracer.get_weights()
        return super()._eval_weights()

    def _podracer_training_step(self) -> Dict[str, Any]:
        c = self.config
        t0 = time.monotonic()
        out = self._podracer.run(min_updates=c.updates_per_iteration)
        self._record_returns(np.asarray(out.pop("episode_returns")))
        self._total_steps += int(out["env_steps_sampled"])
        out["iter_time_s"] = time.monotonic() - t0
        return out

    def training_step(self) -> Dict[str, Any]:
        if self._podracer is not None:
            return self._podracer_training_step()
        c = self.config
        stats_acc: Dict[str, float] = {}
        t0 = time.monotonic()
        consumed = 0
        while consumed < c.updates_per_iteration:
            ready, _ = ray_tpu_torch.wait(
                list(self._inflight), num_returns=1, timeout=300.0
            )
            if not ready:
                raise TimeoutError("no IMPALA fragment arrived in 300s")
            ref = ready[0]
            runner = self._inflight.pop(ref)
            frag = ray_tpu_torch.get(ref)
            self._record_returns(frag["episode_returns"])
            T, B = frag["actions"].shape
            stats = self.learner.update(impala_batch_from_fragments([frag]))
            for k, v in stats.items():
                stats_acc[k] = float(v)
            consumed += 1
            self._total_steps += T * B
            # fresh weights to THIS runner only; relaunch immediately —
            # other runners keep sampling under their slightly-stale
            # policies (that lag is exactly what V-trace corrects).  The
            # dropped ref is safe: per-caller actor-call ordering runs
            # set_weights BEFORE the sample.remote below on the same
            # runner, and a set_weights failure surfaces through that
            # tracked sample ref.
            runner.set_weights.remote(ray_tpu_torch.put(self.learner.get_weights()))
            self._inflight[
                runner.sample.remote(c.rollout_fragment_length)
            ] = runner
        stats_acc["fragments_consumed"] = consumed
        stats_acc["iter_time_s"] = time.monotonic() - t0
        return stats_acc

    def get_state(self) -> Dict[str, Any]:
        if self._podracer is not None:
            return {"params": self._podracer.get_weights()}
        return {"params": self.learner.get_weights()}

    def set_state(self, state: Dict[str, Any]) -> None:
        if self._podracer is not None:
            ray_tpu_torch.get(
                self._podracer.learner.set_weights.remote(state["params"]),
                timeout=120.0,
            )
            self._podracer._put_sync_all()
            return
        self.learner.set_weights(state["params"])
        self.env_runner_group.sync_weights(self.learner.get_weights())

    def stop(self) -> None:
        self._inflight.clear()
        if getattr(self, "_podracer", None) is not None:
            self._podracer.stop()
            self._podracer = None
        group = getattr(self, "env_runner_group", None)
        if group is not None:
            group.stop()


IMPALAConfig.algo_class = IMPALA
