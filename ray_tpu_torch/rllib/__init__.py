"""ray_tpu_torch.rllib: reinforcement learning on actor rollouts and torch
learners (port of ``ray_tpu/rllib``).

Role-equivalent of ray: rllib/ — EnvRunner actors sample vectorized gym
envs with CPU inference; learners hold their modules on the card (or the
CPU, when the config asks for it) and update them in process, or as a
data-parallel LearnerGroup of actors.  Algorithms (PPO, DQN, IMPALA, APPO,
SAC, multi-agent PPO, BC, CQL, MARWIL) share the Algorithm/AlgorithmConfig
skeleton.  The Podracer plane (``rllib/podracer/``) runs IMPALA and APPO
with ``throughput_mode="podracer"``: a learner actor on the card fed by a
free-running fleet of CPU env runners.
"""

from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig  # noqa: F401
from ray_tpu_torch.rllib.core import MLPModuleConfig  # noqa: F401
from ray_tpu_torch.rllib.dqn import DQN, DQNConfig, DQNLearner, ReplayBuffer  # noqa: F401
from ray_tpu_torch.rllib.env_runner import EnvRunnerGroup  # noqa: F401
from ray_tpu_torch.rllib.learner_group import Learner, LearnerGroup  # noqa: F401
from ray_tpu_torch.rllib.impala import (  # noqa: F401
    IMPALA,
    IMPALAConfig,
    IMPALALearner,
    vtrace,
)
from ray_tpu_torch.rllib.appo import APPO, APPOConfig  # noqa: F401
from ray_tpu_torch.rllib.multi_agent import (  # noqa: F401
    MultiAgentEnv,
    MultiAgentPPO,
    MultiAgentPPOConfig,
)
from ray_tpu_torch.rllib.sac import SAC, SACConfig  # noqa: F401
from ray_tpu_torch.rllib.offline import (  # noqa: F401
    BC,
    BCConfig,
    JsonEpisodeReader,
    TransitionReader,
    record_episodes,
)
from ray_tpu_torch.rllib.cql import CQL, CQLConfig  # noqa: F401
from ray_tpu_torch.rllib.marwil import MARWIL, MARWILConfig  # noqa: F401
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig, PPOLearner, compute_gae  # noqa: F401
from ray_tpu_torch.rllib import connectors  # noqa: F401

# NOTE: the model catalog (CNN family) lives in ray_tpu_torch.models.catalog
# — imported there, not here, to keep rllib importable from the catalog
# module itself (registration into core.MODULE_FAMILIES happens on catalog
# import, including implicitly when a CNNModuleConfig unpickles inside a
# worker).
