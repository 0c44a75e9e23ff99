"""serve public API: run/delete/status/handles/shutdown.

Role-equivalent of ray: python/ray/serve/api.py (serve.run:545,
serve.start:66, serve.delete, serve.status).
"""

from __future__ import annotations

import time
from typing import Optional

import ray_tpu_torch
from ray_tpu_torch.serve.controller import (
    CONTROLLER_NAME,
    get_or_create_controller,
)
from ray_tpu_torch.serve.deployment import Application, Deployment, HandleRef
from ray_tpu_torch.serve.handle import DeploymentHandle

PROXY_NAME = "SERVE_PROXY"
# How long serve.run waits for a deployment's replicas to be constructed
# (a 7B model's replica starts in seconds; its weights may come from a
# slower source).
READY_TIMEOUT_S = 600.0

# Route state lives in the controller (versioned get_routes); the proxy
# polls it.  No driver-local route table — multiple drivers can deploy
# and delete apps without clobbering each other's routes.
_proxy_handle = None


def start(http_port: Optional[int] = None,
          grpc_port: Optional[int] = None):
    """Start the serve control plane (controller, plus HTTP/gRPC
    ingresses for whichever ports are given)."""
    controller = get_or_create_controller()
    ray_tpu_torch.get(controller.ping.remote(), timeout=60)
    if http_port is not None:
        _get_or_create_proxy(http_port)
    if grpc_port is not None:
        from ray_tpu_torch.serve.grpc_proxy import start_grpc_proxy

        start_grpc_proxy(grpc_port)
    return controller


def _get_or_create_proxy(port: int):
    global _proxy_handle
    from ray_tpu_torch.serve.proxy import ProxyActor

    proxy = ProxyActor.options(
        name=PROXY_NAME, get_if_exists=True, lifetime="detached",
        num_cpus=0.1,
    ).remote(port)
    ray_tpu_torch.get(proxy.start.remote(), timeout=60)
    _proxy_handle = proxy
    return proxy


def _flatten_graph(root: Application):
    """DFS over the bind graph: every reachable Application becomes one
    deployment (children before parents), nested Application references
    in init args are replaced by HandleRef placeholders, and name
    collisions (Model.bind('a') + Model.bind('b') → two nodes both
    named "Model") get _1/_2 suffixes — reference semantics
    (serve/_private/deployment_graph_build.py:65-69 + its name dedupe).
    Binding the SAME Application object twice shares one deployment.
    Cycles are rejected (a bind graph is a DAG by construction unless
    args were mutated after bind)."""
    import dataclasses as _dc

    name_counts: dict = {}
    used_names: set = set()
    assigned: dict = {}   # id(Application) -> final deployment name
    keepalive: list = []  # id() is only stable while the object lives
    visiting: set = set()
    order: list = []

    def substitute(v):
        if isinstance(v, Application):
            return HandleRef(visit(v))
        if isinstance(v, list):
            return [substitute(x) for x in v]
        if isinstance(v, tuple):
            return tuple(substitute(x) for x in v)
        if isinstance(v, dict):
            return {k: substitute(x) for k, x in v.items()}
        return v

    def visit(app: Application) -> str:
        key = id(app)
        if key in assigned:
            return assigned[key]
        if key in visiting:
            raise ValueError(
                f"cycle in deployment graph at {app.deployment.name!r}"
            )
        visiting.add(key)
        keepalive.append(app)
        d = app.deployment
        new_args = tuple(substitute(a) for a in d.init_args)
        new_kwargs = {k: substitute(v) for k, v in d.init_kwargs.items()}
        n = name_counts.get(d.name, 0)
        final = d.name if n == 0 else f"{d.name}_{n}"
        # a suffixed name can collide with a deployment GENUINELY named
        # that way (Model + Model + a real "Model_1") — skip forward
        # until free, or deploy_application would silently drop one
        while final in used_names:
            n += 1
            final = f"{d.name}_{n}"
        name_counts[d.name] = n + 1
        used_names.add(final)
        assigned[key] = final
        visiting.discard(key)
        order.append(
            _dc.replace(
                d, name=final, init_args=new_args, init_kwargs=new_kwargs
            )
        )
        return final

    root_name = visit(root)
    return order, root_name


def run(
    target: Application,
    *,
    name: str = "default",
    route_prefix: Optional[str] = "/",
    http_port: Optional[int] = None,
    blocking: bool = False,
) -> DeploymentHandle:
    """Deploy an application — possibly a multi-deployment graph built by
    binding Applications into other deployments' init args — and return
    a handle to its ingress (root) deployment once every replica it
    started has been constructed.

    A replica whose construction raises (a ``device="cuda"`` model on a
    replica without a card, say) makes the application deleted and the
    error raised here, as ray's ``serve.run`` waits for its application
    to run; the reference returns at once and leaves the error to the
    first request while the controller restarts the replica in a loop.

    (ray: serve/api.py:545 serve.run; the graph build is
    serve/_private/deployment_graph_build.py — nested ``m.bind()``
    results become DeploymentHandles injected into the parent replica.)
    """
    if isinstance(target, Deployment):
        target = Application(target)
    if not isinstance(target, Application):
        raise TypeError("serve.run expects Application (deployment.bind(...))")
    controller = get_or_create_controller()
    deployments, root_name = _flatten_graph(target)
    ray_tpu_torch.get(
        controller.deploy_application.remote(
            name, [d.sealed() for d in deployments], root_name
        ),
        timeout=120,
    )
    if route_prefix is not None:
        ray_tpu_torch.get(
            controller.set_route_prefix.remote(route_prefix, name, root_name),
            timeout=60,
        )
        if http_port is not None:
            _get_or_create_proxy(http_port)
    _wait_ready(controller, name, [d.name for d in deployments], READY_TIMEOUT_S)
    return DeploymentHandle(controller, name, root_name)


def _wait_ready(controller, app_name: str, names, timeout_s: float) -> None:
    """Block until every replica of the app's deployments answers a
    health check; on a replica's failure delete the app and raise."""
    deadline = time.monotonic() + timeout_s
    for name in names:
        try:
            actors = ray_tpu_torch.get(
                controller.get_replica_actors.remote(name, app_name), timeout=30
            )
            ray_tpu_torch.get(
                [a.check_health.remote() for a in actors],
                timeout=max(0.0, deadline - time.monotonic()),
            )
        except Exception as e:
            delete(app_name)
            raise RuntimeError(
                f"deployment {name!r} of app {app_name!r} did not start: {e}"
            ) from e


def get_deployment_handle(
    deployment_name: str, app_name: str = "default"
) -> DeploymentHandle:
    return DeploymentHandle(
        get_or_create_controller(), app_name, deployment_name
    )


def get_app_handle(app_name: str = "default") -> DeploymentHandle:
    """Handle to the app's INGRESS deployment (the graph root for a
    composed app — not an arbitrary leaf)."""
    controller = get_or_create_controller()
    root = ray_tpu_torch.get(controller.get_app_root.remote(app_name), timeout=30)
    if root is None:
        raise ValueError(f"no app named {app_name!r}")
    return DeploymentHandle(controller, app_name, root)


def delete(name: str):
    # delete_application also removes the app's HTTP routes; proxies pick
    # the change up on their next versioned poll.
    controller = get_or_create_controller()
    ray_tpu_torch.get(controller.delete_application.remote(name), timeout=60)


def status() -> dict:
    controller = get_or_create_controller()
    return ray_tpu_torch.get(controller.get_status.remote(), timeout=30)


def shutdown():
    """Tear down all serve actors."""
    global _proxy_handle
    from ray_tpu_torch.core.actor import get_actor

    for app in list(status()):
        delete(app)
    _proxy_handle = None
    for actor_name in (PROXY_NAME, CONTROLLER_NAME):
        try:
            ray_tpu_torch.kill(get_actor(actor_name))
        except Exception:
            pass
