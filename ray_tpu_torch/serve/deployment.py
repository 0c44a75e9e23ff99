"""Deployment definitions.

Role-equivalent of ray: python/ray/serve/deployment.py:87 (Deployment) and
the @serve.deployment decorator (serve/api.py:248).  A deployment is a
replicated callable with scaling policy; `.bind(*args)` produces an
Application ready for serve.run.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple


@dataclasses.dataclass
class AutoscalingConfig:
    """(ray: serve/config.py AutoscalingConfig)."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 3.0
    downscale_delay_s: float = 10.0


@dataclasses.dataclass
class Deployment:
    func_or_class: Any
    name: str
    init_args: Tuple = ()
    init_kwargs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    num_replicas: int = 1
    autoscaling_config: Optional[AutoscalingConfig] = None
    max_ongoing_requests: int = 100
    ray_actor_options: Dict[str, Any] = dataclasses.field(default_factory=dict)
    user_config: Any = None
    # SLO/queueing policy (serve/traffic/config.py TrafficConfig); None
    # keeps the direct pow-2 dispatch path with no admission control
    traffic_config: Any = None

    def __post_init__(self):
        # normalize HERE, not only in the decorator: .options(
        # autoscaling_config={...}) / .options(traffic_config={...})
        # go through dataclasses.replace (the declarative schema's
        # override path too), and a raw dict would crash the
        # controller's `.min_replicas` access resp. make its
        # attribute-based traffic accessors (drain_timeout_s,
        # stats_push_interval_s) silently fall back to defaults.
        # Strict kwargs so a typo'd key raises at definition time.
        if isinstance(self.autoscaling_config, dict):
            self.autoscaling_config = AutoscalingConfig(
                **self.autoscaling_config
            )
        if isinstance(self.traffic_config, dict):
            from ray_tpu_torch.serve.traffic.config import TrafficConfig

            self.traffic_config = TrafficConfig(**self.traffic_config)
        # The replica's resources are checked here, on the caller's side,
        # as a task's are at submit: a TPU request raises (this runtime
        # schedules none), where the controller's reconcile thread would
        # only log it and retry.
        from ray_tpu_torch.core.remote_function import _build_resources

        o = self.ray_actor_options
        _build_resources(o.get("num_cpus", 0.1), o.get("num_tpus"), o.get("num_gpus"),
                         None, o.get("resources"))

    def options(self, **kwargs) -> "Deployment":
        return dataclasses.replace(self, **kwargs)

    def sealed(self) -> "Deployment":
        """This deployment with its callable and init args sealed (see
        :class:`SealedCallable`): what the controller is given."""
        return dataclasses.replace(
            self, init_args=(), init_kwargs={},
            func_or_class=SealedCallable(self.func_or_class, self.init_args, self.init_kwargs),
        )

    def bind(self, *args, **kwargs) -> "Application":
        """Bind init args, producing an Application node.

        Args may themselves be Application objects (other bound
        deployments): that composes a multi-deployment app graph — at
        serve.run each nested Application becomes its own deployment and
        the parent receives a live DeploymentHandle in its place
        (reference: serve/_private/deployment_graph_build.py:65-69).
        """
        return Application(
            dataclasses.replace(self, init_args=args, init_kwargs=kwargs)
        )

    def __call__(self, *a, **k):
        raise RuntimeError(
            "deployments are not called directly; use serve.run + a handle"
        )


class SealedCallable:
    """A deployment's callable and init args, serialized where the
    application is built and opened only in its replicas.

    The controller passes it to each replica it starts without unpickling
    it, so a model's class and its arguments (and the torch they import)
    never load in the control plane, whose actors run without a card.
    (The reference ships the class itself through its controller.)

    It is sealed through the runtime's serializer, so an ObjectRef in the
    args (a ``weights_ref``) is made resolvable cluster-wide as it would
    be in any call; and those refs ride beside the blob as ``refs``, so
    that whoever holds this (the controller, for the deployment's life)
    keeps their objects alive for every later replica start, as the
    reference's controller does by holding the unpickled deployment."""

    __slots__ = ("blob", "refs", "__rt_is_asgi__")

    def __init__(self, func_or_class, init_args, init_kwargs):
        from ray_tpu_torch.common.ids import ObjectID
        from ray_tpu_torch.core.object_ref import ObjectRef
        from ray_tpu_torch.core.runtime import get_runtime

        rt = get_runtime()
        s, nested = rt._serialize_tracked(
            (func_or_class, tuple(init_args), dict(init_kwargs))
        )
        self.blob = s.to_bytes()
        self.refs = tuple(ObjectRef(ObjectID(b), rt.node_id) for b in dict.fromkeys(nested))
        # the one fact about the callable the controller reads
        self.__rt_is_asgi__ = bool(getattr(func_or_class, "__rt_is_asgi__", False))

    def open(self):
        """``(func_or_class, init_args, init_kwargs)``."""
        from ray_tpu_torch.common import serialization

        return serialization.deserialize(self.blob)


@dataclasses.dataclass
class Application:
    """One node of a deployment graph.  ``deployment.init_args`` /
    ``init_kwargs`` may contain further Application nodes; binding the
    SAME Application object into several parents shares one deployment
    (and its replicas), exactly like the reference's DAG build."""

    deployment: Deployment


@dataclasses.dataclass(frozen=True)
class HandleRef:
    """Placeholder left in a deployment's init args where a nested
    Application was bound; the replica resolves it to a DeploymentHandle
    for the named deployment in the same app at construction time."""

    deployment_name: str


def deployment(
    _func_or_class: Optional[Callable] = None,
    *,
    name: Optional[str] = None,
    num_replicas: Optional[int] = None,
    autoscaling_config: Optional[dict] = None,
    max_ongoing_requests: int = 100,
    ray_actor_options: Optional[dict] = None,
    traffic_config: Optional[dict] = None,
):
    """@serve.deployment decorator (ray: serve/api.py:248)."""

    def wrap(target) -> Deployment:
        asc = autoscaling_config
        if isinstance(asc, dict):
            asc = AutoscalingConfig(**asc)
        # traffic_config dicts normalize in Deployment.__post_init__
        tc = traffic_config
        return Deployment(
            func_or_class=target,
            name=name or target.__name__,
            num_replicas=num_replicas or 1,
            autoscaling_config=asc,
            max_ongoing_requests=max_ongoing_requests,
            ray_actor_options=ray_actor_options or {},
            traffic_config=tc,
        )

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap
