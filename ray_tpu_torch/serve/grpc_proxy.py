"""gRPC ingress for Serve.

Role-equivalent of ray: python/ray/serve/_private/proxy.py:534
(gRPCProxy).  A generic aio gRPC server inside an actor: any unary
method path ``/<anything>/<Method>`` routes to the application whose
route prefix matches the ``application`` request metadata (or, absent
that, ``/<Method>``).  Payloads are JSON bytes in/out — schema-free
like the HTTP proxy (the reference requires user protos + serve build;
this keeps the transport pluggable without a codegen step).  Dispatch
rides DeploymentHandle, so gRPC callers get the same pow-2 routing and
replica-death failover as HTTP and handle callers.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Dict

import ray_tpu_torch
from ray_tpu_torch.serve.traffic.config import RequestShedError

logger = logging.getLogger(__name__)

GRPC_PROXY_NAME = "_rt_serve_grpc_proxy"


@ray_tpu_torch.remote
class GrpcProxyActor:
    def __init__(self, port: int = 9000):
        self._port = port
        self._server = None
        self._routes: Dict[str, Any] = {}
        self._routes_version = -1
        self._last_poll = 0.0
        self._last_full_read = 0.0
        self._published_version = None  # serve:routes pubsub bumps
        self._handles: Dict[str, Any] = {}
        self._controller = None

    async def start(self) -> int:
        import grpc

        if self._server is not None:
            return self._port

        # version-bump subscription: same protocol as the HTTP proxy —
        # the per-request poll skips its get_routes read while the
        # published version matches what we already hold
        try:
            from ray_tpu_torch.core.runtime import get_runtime
            from ray_tpu_torch.serve.controller import ROUTES_CHANNEL

            def _on_bump(msg: dict) -> None:
                self._published_version = msg.get("version")

            await get_runtime().subscribe_async(ROUTES_CHANNEL, _on_bump)
        except Exception:
            logger.debug("routes subscription failed; falling back to "
                         "polling", exc_info=True)

        outer = self

        class _Generic(grpc.GenericRpcHandler):
            def service(self, handler_call_details):
                method = handler_call_details.method
                md = dict(handler_call_details.invocation_metadata or ())

                async def unary(request_bytes, context):
                    try:
                        return await outer._dispatch(
                            method, md, request_bytes
                        )
                    except RequestShedError as e:
                        # overload answer: RESOURCE_EXHAUSTED + machine-
                        # readable backoff hint in trailing metadata
                        context.set_trailing_metadata((
                            ("retry-after-s", f"{e.retry_after_s:.3f}"),
                        ))
                        await context.abort(
                            grpc.StatusCode.RESOURCE_EXHAUSTED, str(e)
                        )

                return grpc.unary_unary_rpc_method_handler(
                    unary,
                    request_deserializer=None,  # raw bytes through
                    response_serializer=None,
                )

        self._server = grpc.aio.server()
        self._server.add_generic_rpc_handlers((_Generic(),))
        bound = self._server.add_insecure_port(f"0.0.0.0:{self._port}")
        if bound == 0:  # grpc signals bind failure by returning port 0
            self._server = None
            raise RuntimeError(
                f"gRPC ingress could not bind port {self._port} "
                "(already in use?)"
            )
        await self._server.start()
        self._port = bound
        return bound

    # route state is controller-owned, polled versioned — same protocol
    # as the HTTP proxy (serve/proxy.py _poll_routes)
    def _poll_routes(self, force: bool = False):
        import time

        from ray_tpu_torch.serve.proxy import ROUTE_POLL_S, ROUTE_RECHECK_S

        now = time.monotonic()
        if not force and now - self._last_poll < ROUTE_POLL_S:
            return
        self._last_poll = now
        if (
            not force
            and self._published_version is not None
            and self._published_version == self._routes_version
            and now - self._last_full_read < ROUTE_RECHECK_S
        ):
            return  # subscription says nothing moved: skip the read
        self._last_full_read = now
        if self._controller is None:
            from ray_tpu_torch.serve.controller import get_or_create_controller

            self._controller = get_or_create_controller()
        routes = ray_tpu_torch.get(
            self._controller.get_routes.remote(), timeout=30
        )
        if routes["version"] != self._routes_version:
            self._routes_version = routes["version"]
            new_routes = dict(routes.get("http_routes", {}))
            # drop ONLY handles whose prefix changed target — an
            # unrelated deploy must not discard warm replica routers
            # (same policy as serve/proxy.py)
            for p in list(self._handles):
                if new_routes.get(p) != self._routes.get(p):
                    self._handles.pop(p, None)
            self._routes = new_routes

    def _handle_for(self, prefix: str):
        h = self._handles.get(prefix)
        if h is None:
            from ray_tpu_torch.serve.handle import DeploymentHandle

            app, deployment = self._routes[prefix]
            h = self._handles[prefix] = DeploymentHandle(
                self._controller, app, deployment
            )
            # wire-decoded args can never hold a DeploymentResponse:
            # skip the chained-arg scan in remote()
            h._args_known_plain = True
        return h

    async def _dispatch(self, method: str, metadata: Dict[str, str],
                        request_bytes: bytes) -> bytes:
        import asyncio
        import grpc  # noqa: F401

        route = metadata.get("application") or (
            "/" + method.rsplit("/", 1)[-1]
        )
        if not route.startswith("/"):
            route = "/" + route
        args: tuple = ()
        kwargs: Dict[str, Any] = {}
        if request_bytes:
            try:
                parsed = json.loads(request_bytes)
                if isinstance(parsed, dict):
                    kwargs = parsed
                else:
                    args = (parsed,)
            except (json.JSONDecodeError, UnicodeDecodeError):
                args = (request_bytes,)

        def _route_and_dispatch():
            self._poll_routes()
            prefix = route if route in self._routes else None
            if prefix is None:
                self._poll_routes(force=True)
                prefix = route if route in self._routes else None
            if prefix is None:
                return None
            handle = self._handle_for(prefix)
            # traffic-plane deployments dispatch on the io loop (same
            # policy as the HTTP proxy: the scheduler is loop-bound)
            r = handle._router
            if r._version < 0:
                try:
                    r._refresh(force=True)
                except Exception:
                    pass  # dispatch will surface routing errors
            if handle.traffic_config is not None:
                return ("traffic", handle)
            return handle.remote(*args, **kwargs)

        resp = await asyncio.get_running_loop().run_in_executor(
            None, _route_and_dispatch
        )
        if resp is None:
            raise RuntimeError(f"no serve application at route {route!r}")
        if isinstance(resp, tuple) and resp[0] == "traffic":
            resp = resp[1].remote(*args, **kwargs)
        value = await resp.result_async()
        if isinstance(value, bytes):
            return value
        return json.dumps(value, default=str).encode()

    async def ping(self) -> bool:
        return True


def start_grpc_proxy(port: int = 0) -> int:
    """Start (or reuse) the gRPC ingress; returns the bound port."""
    proxy = GrpcProxyActor.options(
        name=GRPC_PROXY_NAME, get_if_exists=True, lifetime="detached",
        num_cpus=0.1,
    ).remote(port)
    return ray_tpu_torch.get(proxy.start.remote(), timeout=120)
