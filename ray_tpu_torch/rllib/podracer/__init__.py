"""Podracer throughput plane (arXiv 2104.06272, Sebulba shape; port of
``ray_tpu/rllib/podracer/``).

Free-running vectorized env actors on the CPU feed a central learner
actor, on its leased card, through shm-ref'd rollout fragments; weights
fan back out over one block-quantizable ``broadcast_tree``.
"""

from ray_tpu_torch.rllib.podracer.fragment import FragmentMeta, StalenessHistogram
from ray_tpu_torch.rllib.podracer.learner import PodracerLearnerActor
from ray_tpu_torch.rllib.podracer.runner import (
    PodracerConfig,
    PodracerRunner,
    check_learner_card,
)

__all__ = [
    "FragmentMeta",
    "StalenessHistogram",
    "PodracerLearnerActor",
    "PodracerConfig",
    "PodracerRunner",
    "check_learner_card",
]
