"""APPO: asynchronous PPO — IMPALA's decoupled actor-learner pipeline
with the PPO clipped-surrogate objective on V-trace-corrected targets
(port of ``ray_tpu/rllib/appo.py``).

Role-equivalent of ray: rllib/algorithms/appo/appo.py (APPOConfig,
APPO — "IMPALA + surrogate loss + target-network smoothing"): runners
sample continuously under slightly-stale policies, V-trace corrects the
off-policyness, and the importance ratio is clipped PPO-style so one
very-stale fragment cannot blow up the update.  The optional target
network (use_kl_loss analogue collapsed: the clip does the trust-region
work) smooths tgt_logp drift between weight syncs.

APPO inherits IMPALA's ``throughput_mode="podracer"``: the plane's
learner actor is built from ``learner_cls``, the clipped-surrogate
learner.
"""

from __future__ import annotations

import dataclasses

import torch

from ray_tpu_torch.rllib.impala import IMPALA, IMPALAConfig, IMPALALearner, vtrace_terms
from ray_tpu_torch.rllib.ppo import clipped_surrogate, entropy_of


@dataclasses.dataclass
class APPOConfig(IMPALAConfig):
    clip_param: float = 0.2
    lr: float = 3e-4
    entropy_coeff: float = 0.005


def appo_loss(module, batch, config: APPOConfig):
    """IMPALA's loss with the PPO clipped surrogate on the behavior ratio
    in place of the ρ-weighted policy gradient."""
    c = config
    logp_all, tgt_logp, values, vs, adv = vtrace_terms(module, batch, c)
    # PPO surrogate on the behavior ratio (the APPO difference from
    # IMPALA's plain ρ-weighted policy gradient)
    ratio = torch.exp(tgt_logp - batch["logp"])
    pg = clipped_surrogate(ratio, adv, c.clip_param)
    vf = 0.5 * ((values - vs) ** 2).mean()
    entropy = entropy_of(logp_all)
    total = pg + c.vf_coeff * vf - c.entropy_coeff * entropy
    return total, {
        "policy_loss": pg,
        "vf_loss": vf,
        "entropy": entropy,
        "mean_ratio": ratio.mean(),
    }


class APPOLearner(IMPALALearner):
    def _loss(self, batch):
        return appo_loss(self.module, batch, self.config)


class APPO(IMPALA):
    """Same async pipeline as IMPALA; only the learner's loss differs."""

    learner_cls = APPOLearner


APPOConfig.algo_class = APPO
