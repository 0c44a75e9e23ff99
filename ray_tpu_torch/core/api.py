"""Public API: init/shutdown/remote/get/put/wait/kill/cancel.

Role-equivalent of ray: python/ray/_private/worker.py (init:1214, get:2537,
put:2655, wait:2720, remote:3212).
"""

from __future__ import annotations

import atexit
import os
from typing import Any, List, Optional, Sequence, Union

from ray_tpu_torch.common.config import cfg
from ray_tpu_torch.core import node as node_mod
from ray_tpu_torch.core.actor import ActorClass, ActorHandle, get_actor  # noqa: F401
from ray_tpu_torch.core.errors import RayTpuError
from ray_tpu_torch.core.object_ref import ObjectRef  # noqa: F401
from ray_tpu_torch.core.runtime import ObjectRefGenerator  # noqa: F401
from ray_tpu_torch.core.remote_function import RemoteFunction
from ray_tpu_torch.core.runtime import Runtime, get_runtime, set_runtime

_node_group: Optional[node_mod.NodeProcessGroup] = None


def is_initialized() -> bool:
    from ray_tpu_torch.core import runtime as rt_mod

    return rt_mod._global_runtime is not None


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    resources: Optional[dict] = None,
    object_store_bytes: int = 0,
    session_dir: Optional[str] = None,
    labels: Optional[dict] = None,
    log_to_driver: bool = True,
) -> dict:
    """Start (or connect to) a cluster and attach this process as a driver.

    With no address: starts a head node (GCS + raylet) locally, like the
    reference's `ray.init()` standalone mode.  With an address (`host:port`
    of the GCS): connects to the existing cluster and uses a raylet on this
    host.

    ``log_to_driver`` (default True, like the reference): every print /
    stderr write inside tasks and actors of THIS job is streamed back and
    printed here with a ``(pid=..., node=...)`` prefix.
    """
    global _node_group
    if is_initialized():
        raise RayTpuError("ray_tpu_torch.init() called twice; call shutdown() first")

    if address is None:
        sdir = session_dir or node_mod.default_session_dir()
        res = node_mod.detect_resources(num_cpus, num_gpus, resources)
        gcs_proc, gcs_addr = node_mod.start_gcs(sdir)
        try:
            raylet_proc, raylet_addr, node_id, store_path = node_mod.start_raylet(
                gcs_addr, sdir, res, labels=labels,
                store_capacity=object_store_bytes,
            )
        except Exception:
            gcs_proc.terminate()
            raise
        _node_group = node_mod.NodeProcessGroup(
            session_dir=sdir,
            gcs_address=gcs_addr,
            raylet_address=raylet_addr,
            node_id=node_id,
            store_path=store_path,
            gcs_proc=gcs_proc,
            raylet_proc=raylet_proc,
        )
        atexit.register(shutdown)
    else:
        gcs_addr = address
        raylet_addr, node_id, store_path = _find_local_raylet(gcs_addr)

    rt = Runtime(
        gcs_address=gcs_addr,
        node_id=node_id,
        raylet_address=raylet_addr,
        store_path=store_path,
        mode="driver",
    )
    try:
        rt.connect()
    except Exception:
        if _node_group is not None:
            _node_group.kill()
            _node_group = None
        raise
    set_runtime(rt)
    if log_to_driver:
        from ray_tpu_torch.core import log_streaming

        rt.subscribe(
            "worker_logs",
            log_streaming.make_driver_printer(
                rt.job_id.hex() if rt.job_id else None
            ),
        )
    return {
        "gcs_address": gcs_addr,
        "node_id": node_id,
        "session_dir": _node_group.session_dir if _node_group else None,
    }


def _find_local_raylet(gcs_addr: str):
    """Connect to the cluster and locate a raylet on this host."""
    import asyncio

    from ray_tpu_torch.core import rpc

    async def _query():
        conn = await rpc.connect(gcs_addr)
        nodes = await conn.call("get_nodes", {})
        await conn.close()
        return nodes

    nodes = asyncio.run(_query())
    alive = [n for n in nodes if n["alive"]]
    if not alive:
        raise RayTpuError(f"no alive nodes in cluster at {gcs_addr}")
    chosen = alive[0]
    store_path = f"/dev/shm/rt_store_{chosen['node_id'][:12]}"
    if not os.path.exists(store_path):
        raise RayTpuError(
            "no raylet on this host (store arena missing); start one with "
            "cluster_utils or run the driver on a cluster node"
        )
    return chosen["address"], chosen["node_id"], store_path


def shutdown() -> None:
    global _node_group
    from ray_tpu_torch.core import runtime as rt_mod

    if rt_mod._global_runtime is not None:
        rt_mod._global_runtime.shutdown()
    if _node_group is not None:
        _node_group.kill()
        _node_group = None
    try:
        atexit.unregister(shutdown)
    except Exception:
        pass


def remote(*args, **kwargs):
    """Decorator making a function a remote task or a class an actor."""

    def wrap(target):
        import inspect

        if inspect.isclass(target):
            return ActorClass(target, **kwargs)
        return RemoteFunction(target, **kwargs)

    if len(args) == 1 and not kwargs and callable(args[0]):
        return wrap(args[0])
    if args:
        raise TypeError("@remote options must be keyword arguments")
    return wrap


def method(**kwargs):
    """Decorator for actor methods (e.g. num_returns); stored as metadata."""

    def wrap(m):
        m.__rt_method_opts__ = kwargs
        return m

    return wrap


def get(refs, *, timeout: Optional[float] = None):
    return get_runtime().get(refs, timeout=timeout)


def put(value) -> ObjectRef:
    return get_runtime().put(value)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
):
    return get_runtime().wait(
        list(refs), num_returns=num_returns, timeout=timeout,
        fetch_local=fetch_local,
    )


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    get_runtime().kill_actor(actor._actor_id, no_restart=no_restart)


def cancel(ref, *, force: bool = False) -> bool:
    """Cancel the task producing ``ref``: queued tasks are dropped before
    dispatch; running tasks are interrupted on their worker (ray:
    worker.py cancel → CoreWorker::CancelTask).  An ObjectRefGenerator
    cancels its producing generator; the consumer's next() then yields a
    ref raising TaskCancelledError."""
    if isinstance(ref, ObjectRefGenerator):
        return get_runtime().stream_cancel(ref.task_id)
    return get_runtime().cancel(ref)


def available_resources() -> dict:
    return get_runtime().cluster_resources()["available"]


def cluster_resources() -> dict:
    return get_runtime().cluster_resources()["total"]


def nodes() -> list:
    return get_runtime().nodes()


class _RuntimeContext:
    @property
    def job_id(self):
        return get_runtime().job_id

    @property
    def node_id(self):
        return get_runtime().node_id

    @property
    def worker_id(self):
        return get_runtime().worker_id

    @property
    def actor_id(self):
        return get_runtime().actor_id

    def get(self):
        return self


def get_runtime_context() -> _RuntimeContext:
    return _RuntimeContext()


def timeline() -> list:
    """Task lifecycle events recorded by this process: submit events plus
    worker-side execution spans piggybacked on task replies (ray:
    ray.timeline chrome-trace export role)."""
    from ray_tpu_torch.core.runtime import get_runtime

    return get_runtime().timeline()
