"""User-facing exception types.

Role-equivalent of ray: python/ray/exceptions.py (RayTaskError,
RayActorError, ObjectLostError, ...).
"""

from __future__ import annotations

import traceback


class RayTpuError(Exception):
    """Base for all framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception remotely; re-raised at `get`.

    Carries the remote traceback string so the user sees where it failed.
    """

    def __init__(self, cause_type: str, cause_msg: str, remote_tb: str,
                 task_desc: str = ""):
        self.cause_type = cause_type
        self.cause_msg = cause_msg
        self.remote_tb = remote_tb
        self.task_desc = task_desc
        super().__init__(
            f"{task_desc or 'task'} failed with {cause_type}: {cause_msg}\n"
            f"--- remote traceback ---\n{remote_tb}"
        )

    def __reduce__(self):
        return (
            TaskError,
            (self.cause_type, self.cause_msg, self.remote_tb, self.task_desc),
        )

    @classmethod
    def from_exception(cls, e: Exception, task_desc: str = "") -> "TaskError":
        return cls(
            type(e).__name__,
            str(e),
            "".join(traceback.format_exception(type(e), e, e.__traceback__)),
            task_desc,
        )


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class ActorError(RayTpuError):
    """Actor task cannot run: the actor is dead or dying."""

    def __init__(self, msg: str, actor_id=None):
        super().__init__(msg)
        self.actor_id = actor_id


class ActorDiedError(ActorError):
    pass


class ObjectLostError(RayTpuError):
    """Object's value was lost from the cluster and could not be recovered."""


class GetTimeoutError(RayTpuError, TimeoutError):
    pass


class TaskCancelledError(RayTpuError):
    pass


class RuntimeEnvSetupError(RayTpuError):
    pass


class NodeDiedError(RayTpuError):
    pass


class FencedError(RayTpuError):
    """The sender's node incarnation is stale: the cluster declared that
    node dead (and bumped its incarnation), so RPCs from the old life
    are rejected.  A raylet receiving this must fence itself — kill its
    workers, discard its object copies and spill files, and re-register
    fresh — closing the split-brain window a healed partition opens
    (two live copies of a named actor, stale lease grants
    double-executing tasks)."""


def is_fenced(exc: BaseException) -> bool:
    """True when ``exc`` is a FencedError, locally raised or carried
    inside an rpc.RemoteCallError from a peer's fence check."""
    if isinstance(exc, FencedError):
        return True
    remote = getattr(exc, "remote_exception", None)
    return isinstance(remote, FencedError)
