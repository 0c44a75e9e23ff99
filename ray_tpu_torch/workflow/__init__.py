"""Durable workflows (ray: python/ray/workflow/)."""

from ray_tpu_torch.workflow.api import (  # noqa: F401
    WorkflowError,
    WorkflowNotFoundError,
    delete,
    get_output,
    get_status,
    list_all,
    resume,
    run,
    run_async,
)
from ray_tpu_torch.workflow.storage import (  # noqa: F401
    CANCELED,
    FAILED,
    RUNNING,
    SUCCEEDED,
)

__all__ = [
    "run",
    "run_async",
    "resume",
    "get_output",
    "get_status",
    "list_all",
    "delete",
    "WorkflowError",
    "WorkflowNotFoundError",
    "RUNNING",
    "SUCCEEDED",
    "FAILED",
    "CANCELED",
]
