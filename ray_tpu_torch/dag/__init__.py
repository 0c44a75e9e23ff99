"""Compiled DAGs on mutable shm channels (ray: python/ray/dag/ +
src/ray/core_worker/experimental_mutable_object_manager.cc)."""

from ray_tpu_torch.dag.channel import (  # noqa: F401
    Channel,
    ChannelClosedError,
    ChannelTimeoutError,
)
from ray_tpu_torch.dag.compiled_dag import (  # noqa: F401
    CompiledDAG,
    CompiledDAGRef,
    DAGExecutionError,
    InputNode,
    MultiOutputNode,
)

__all__ = [
    "Channel",
    "ChannelClosedError",
    "ChannelTimeoutError",
    "CompiledDAG",
    "CompiledDAGRef",
    "DAGExecutionError",
    "InputNode",
    "MultiOutputNode",
]
