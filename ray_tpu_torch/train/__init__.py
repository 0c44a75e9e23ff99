"""ray_tpu_torch.train: distributed training orchestration for GPU gangs
(port of ``ray_tpu/train/``).

Role-equivalent of ray: python/ray/train/.  Worker-side API (report /
get_checkpoint / get_context) + driver-side TorchTrainer.  Importing it
loads no torch: the driver's control path needs none, and a worker loads
it with the loop it runs.
"""

from ray_tpu_torch.train.backend import (  # noqa: F401
    Backend,
    BackendConfig,
    TorchBackend,
    TorchConfig,
)
from ray_tpu_torch.train.checkpoint import Checkpoint  # noqa: F401
from ray_tpu_torch.train.config import (  # noqa: F401
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.session import (  # noqa: F401
    TrainContext,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    report,
)
from ray_tpu_torch.train.trainer import Result, TorchTrainer  # noqa: F401
