"""Actor classes and handles.

Role-equivalent of ray: python/ray/actor.py (ActorClass:563, ActorHandle:1223,
restart options :75-97).
"""

from __future__ import annotations

import weakref
from typing import Any, Dict, Optional

from ray_tpu_torch.common.config import cfg
from ray_tpu_torch.common.ids import ActorID
from ray_tpu_torch.core.remote_function import _build_resources, _strategy_dict
from ray_tpu_torch.core.runtime import get_runtime


class ActorMethod:
    __slots__ = (
        "_handle", "_name", "_num_returns", "_concurrency_group",
        "_skeleton", "_fill_job", "_rt",
    )

    def __init__(self, handle: "ActorHandle", name: str, num_returns: int = 1,
                 concurrency_group: Optional[str] = None):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group
        # cached spec skeleton (see Runtime.make_actor_skeleton), built at
        # first submit and keyed on the runtime instance — `.remote()`
        # then only fills task id + args
        self._skeleton = None
        self._fill_job = False
        self._rt = None

    def __reduce__(self):
        # the cached skeleton holds runtime-bound state — rebuild bare on
        # the receiving side (first submit there re-warms its own cache)
        return (
            ActorMethod,
            (self._handle, self._name, self._num_returns,
             self._concurrency_group),
        )

    def options(self, num_returns: int = 1,
                concurrency_group: Optional[str] = None) -> "ActorMethod":
        return ActorMethod(
            self._handle, self._name, num_returns, concurrency_group
        )

    def bind(self, *args):
        """Lazy DAG binding (ray: python/ray/dag/class_node.py).  Returns
        a ClassMethodNode for `experimental_compile()`."""
        from ray_tpu_torch.dag.compiled_dag import ClassMethodNode

        return ClassMethodNode(self._handle, self._name, args)

    def remote(self, *args, **kwargs):
        rt = get_runtime()
        if self._rt is None or self._rt() is not rt:
            self._skeleton, self._fill_job = rt.make_actor_skeleton(
                self._handle._actor_id, self._name, self._num_returns,
                self._concurrency_group,
            )
            # weakref: the cached skeleton must not pin a shut-down
            # runtime alive across init/shutdown cycles
            self._rt = weakref.ref(rt)
        # bare ObjectRef / list / ObjectRefGenerator — already the
        # caller-facing shape
        return rt.submit_actor_task_from_skeleton(
            self._skeleton, self._fill_job, args, kwargs,
            self._handle._max_task_retries,
        )


class ActorHandle:
    def __init__(self, actor_id: ActorID, max_task_retries: int = 0):
        self._actor_id = actor_id
        self._max_task_retries = max_task_retries

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        # cache on the instance: `handle.method` resolves from __dict__
        # with no allocation on every later lookup, and the cached
        # ActorMethod keeps its spec skeleton warm across calls
        # (pickling is unaffected — __reduce__ carries only the id)
        m = ActorMethod(self, name)
        self.__dict__[name] = m
        return m

    def _apply(self, fn, *args, **kwargs):
        """Run `fn(actor_instance, *args, **kwargs)` inside the actor
        process (reference: ActorHandle.__ray_call__).  Used by compiled
        DAGs to park exec loops on actors; generally useful for
        introspection and weight extraction without touching the user's
        class."""
        return ActorMethod(self, "__rt_apply__").remote(fn, *args, **kwargs)

    def __repr__(self):
        return f"ActorHandle({self._actor_id.hex()[:12]})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._max_task_retries))

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return (
            isinstance(other, ActorHandle) and other._actor_id == self._actor_id
        )


class ActorClass:
    def __init__(self, cls, **default_opts):
        self._cls = cls
        self._opts = default_opts

    def options(self, **opts) -> "ActorClass":
        merged = dict(self._opts)
        merged.update(opts)
        return ActorClass(self._cls, **merged)

    def remote(self, *args, **kwargs) -> ActorHandle:
        o = self._opts
        # actors default to 0 CPU (like the reference) unless asked
        resources = _build_resources(
            o.get("num_cpus", 0), o.get("num_tpus"), o.get("num_gpus"),
            o.get("memory"), o.get("resources"),
        )
        max_task_retries = o.get("max_task_retries", 0)
        actor_id = get_runtime().create_actor(
            self._cls,
            args,
            kwargs,
            name=o.get("name"),
            namespace=o.get("namespace", "default"),
            get_if_exists=o.get("get_if_exists", False),
            resources=resources,
            max_restarts=o.get(
                "max_restarts", cfg.actor_max_restarts_default
            ),
            max_task_retries=max_task_retries,
            detached=(o.get("lifetime") == "detached"),
            strategy=_strategy_dict(o.get("scheduling_strategy")),
            runtime_env=o.get("runtime_env"),
            max_concurrency=o.get("max_concurrency"),
            concurrency_groups=o.get("concurrency_groups"),
            method_groups=self._method_groups(),
            on_drain=o.get("on_drain", "migrate"),
        )
        return ActorHandle(actor_id, max_task_retries)

    def _method_groups(self):
        """Per-method concurrency-group assignments declared with
        @ray_tpu_torch.method(concurrency_group=...)."""
        out = {}
        for name in dir(self._cls):
            if name.startswith("__"):
                continue
            m = getattr(self._cls, name, None)
            opts = getattr(m, "__rt_method_opts__", None)
            if opts and opts.get("concurrency_group"):
                out[name] = opts["concurrency_group"]
        return out

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"actor class {self._cls.__name__} cannot be instantiated directly; "
            "use .remote()"
        )


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    """Look up a named actor (ray: ray.get_actor)."""
    from ray_tpu_torch.core.errors import RayTpuError

    rt = get_runtime()
    info = rt._run(
        rt.gcs.call("get_actor", {"name": name, "namespace": namespace})
    )
    if info is None or info["state"] == "DEAD":
        raise RayTpuError(f"no live actor named {name!r} in namespace {namespace!r}")
    return ActorHandle(ActorID(info["actor_id"]))
