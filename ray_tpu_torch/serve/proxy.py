"""HTTP proxy: routes external requests to deployment replicas.

Role-equivalent of ray: python/ray/serve/_private/proxy.py:1112
(ProxyActor, HTTPProxy:748).  An aiohttp server inside an actor: request
path /<route_prefix>/... selects the app; JSON bodies become kwargs (or
the raw body is passed under "body"); responses are JSON (dict/list) or
text/bytes passthrough.
"""

from __future__ import annotations

import json
import logging
from typing import Any, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve.traffic.config import RequestShedError

logger = logging.getLogger(__name__)


ROUTE_POLL_S = 1.0
#: with the version-bump subscription live, a full get_routes read only
#: happens when the published version moves — plus this slow safety
#: recheck for a lost publish (GCS restart races)
ROUTE_RECHECK_S = 10.0


@ray_tpu_torch.remote
class ProxyActor:
    def __init__(self, port: int = 8000):
        self._port = port
        self._routes: Dict[str, Any] = {}  # route_prefix -> (app, deployment)
        self._asgi_prefixes: set = set()  # prefixes served via @serve.ingress
        self._routes_version = -1
        self._last_poll = 0.0
        self._last_full_read = 0.0
        # route-table version from the controller's serve:routes pubsub
        # bumps (None until the first publish arrives); lets _poll_routes
        # skip the unbatched get_routes read while nothing changed
        self._published_version: Optional[int] = None
        self._handles: Dict[str, Any] = {}
        self._controller = None
        self._runner = None
        self._site = None
        self._start_task = None

    async def start(self) -> int:
        # memoized: concurrent callers (async actor methods interleave)
        # await ONE bring-up and all receive the resolved bound port —
        # a bare started-flag would hand an ephemeral-port caller 0
        import asyncio

        if self._start_task is None:
            self._start_task = asyncio.get_running_loop().create_task(
                self._do_start()
            )
        return await asyncio.shield(self._start_task)

    async def _do_start(self) -> int:
        from aiohttp import web

        # route-table refresh rides the GCS pubsub plane: the controller
        # publishes version bumps (coalesced into the per-tick BATCH
        # frames like every GCS notify), so the per-request poll below
        # degrades to a no-op while the table is unchanged instead of an
        # unbatched get_routes read per second
        try:
            from ray_tpu_torch.core.runtime import get_runtime
            from ray_tpu_torch.serve.controller import ROUTES_CHANNEL

            def _on_bump(msg: dict) -> None:
                self._published_version = msg.get("version")

            await get_runtime().subscribe_async(ROUTES_CHANNEL, _on_bump)
        except Exception:
            logger.debug("routes subscription failed; falling back to "
                         "polling", exc_info=True)

        app = web.Application()
        app.router.add_route("*", "/{tail:.*}", self._handle)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        self._site = web.TCPSite(self._runner, "0.0.0.0", self._port)
        await self._site.start()
        if self._port == 0:  # ephemeral: resolve the real port
            for server in self._runner.sites:
                self._port = server._server.sockets[0].getsockname()[1]
                break
        return self._port

    # Route state is owned by the controller (like the reference's
    # long-poll config push, serve/_private/long_poll.py); the proxy polls
    # the versioned get_routes instead of accepting driver-pushed
    # snapshots — so concurrent drivers can't clobber each other's routes.
    def _poll_routes(self, force: bool = False):
        import time

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
            # subscription says nothing moved: skip the read entirely
            return
        self._last_full_read = now
        if self._controller is None:
            from ray_tpu_torch.serve.controller import get_or_create_controller

            self._controller = get_or_create_controller()
        routes = ray_tpu_torch.get(self._controller.get_routes.remote(), timeout=30)
        if routes["version"] != self._routes_version:
            self._routes_version = routes["version"]
            new_routes = routes.get("http_routes", {})
            # drop handles for prefixes that changed target
            for p, target in list(self._handles.items()):
                if new_routes.get(p) != self._routes.get(p):
                    self._handles.pop(p, None)
            self._routes = dict(new_routes)
            self._asgi_prefixes = set(routes.get("asgi_prefixes", ()))

    def _handle_for(self, prefix: str):
        from ray_tpu_torch.serve.handle import DeploymentHandle

        h = self._handles.get(prefix)
        if h is None:
            app_name, dep_name = self._routes[prefix]
            h = DeploymentHandle(self._controller, app_name, dep_name)
            # args come from a parsed HTTP body — they can never hold a
            # DeploymentResponse, so remote() skips the chained-arg scan
            h._args_known_plain = True
            self._handles[prefix] = h
        return h

    async def _handle(self, request):
        from aiohttp import web

        path = "/" + request.match_info["tail"]
        if path == "/-/healthz":
            return web.Response(text="ok")
        kwargs: Dict[str, Any] = {}
        args = ()
        # routing modifiers ride the query string (never the body):
        #   ?method=generate   call a named method instead of __call__
        #   ?stream=1          newline-delimited-JSON streaming response
        method_name = request.query.get("method")
        want_stream = request.query.get("stream", "") in ("1", "true")
        if method_name and method_name.startswith("_"):
            # the replica getattr()s the user callable: private/dunder
            # attributes must not be reachable over unauthenticated HTTP
            return web.Response(
                status=403, text="private method names are not routable"
            )
        body = await request.read()
        if body:
            try:
                parsed = json.loads(body)
                if isinstance(parsed, dict):
                    kwargs = parsed
                else:
                    args = (parsed,)
            except (json.JSONDecodeError, UnicodeDecodeError):
                args = (body,)
        elif request.query:
            kwargs = {
                k: v for k, v in request.query.items()
                if k not in ("method", "stream")
            }
        try:
            import asyncio

            def _match():
                for p in sorted(self._routes, key=len, reverse=True):
                    if (
                        path == p
                        or path.startswith(p.rstrip("/") + "/")
                        or p == "/"
                    ):
                        return p
                return None

            # Routing + dispatch block (controller poll, route refresh) —
            # run them on an executor thread.  The (possibly long) replica
            # wait is awaited on the io loop with failover, so slow
            # replicas can't exhaust the executor pool.
            def _route_and_dispatch():
                self._poll_routes()
                prefix = _match()
                if prefix is None:
                    # one forced refresh: the route may have just been added
                    self._poll_routes(force=True)
                    prefix = _match()
                if prefix is None:
                    return None, False
                handle = self._handle_for(prefix)
                if prefix in self._asgi_prefixes:
                    # @serve.ingress deployment: forward the raw request
                    # through the replica's ASGI adapter with the prefix
                    # stripped, so the mounted app's own routing applies
                    # (ray: serve/api.py:172 ingress semantics)
                    suffix = path[len(prefix.rstrip("/")):] or "/"
                    asgi_req = {
                        "method": request.method,
                        "path": suffix,
                        "query_string": request.query_string,
                        "headers": [
                            (k, v) for k, v in request.headers.items()
                        ],
                        "body": body,
                    }
                    h = handle.options(method_name="__asgi_handle__")
                    return h.remote(asgi_req), True
                if method_name or want_stream:
                    handle = handle.options(
                        method_name=method_name or "__call__",
                        stream=want_stream,
                    )
                # traffic-plane deployments dispatch ON the io loop (the
                # scheduler is loop-bound and admission sheds
                # synchronously); learn the policy here, where blocking
                # on a route refresh is allowed.  Streams and plain
                # deployments keep the direct executor dispatch.
                if not want_stream:
                    r = handle._router
                    if r._version < 0:
                        try:
                            r._refresh(force=True)
                        except Exception:
                            pass  # dispatch will surface routing errors
                    if handle.traffic_config is not None:
                        return ("traffic", handle), False
                return handle.remote(*args, **kwargs), False

            resp, is_asgi = await asyncio.get_running_loop().run_in_executor(
                None, _route_and_dispatch
            )
            if resp is None:
                return web.Response(status=404, text="no route")
            if isinstance(resp, tuple) and resp[0] == "traffic":
                # on-loop dispatch: admission check + EDF enqueue (pure
                # arithmetic + a heap push — nothing here blocks)
                resp = resp[1].remote(*args, **kwargs)
            if is_asgi:
                r = await resp.result_async()
                headers = {
                    k: v for k, v in r.get("headers", [])
                    # aiohttp computes these from the body it writes
                    if k.lower() not in ("content-length",
                                         "transfer-encoding")
                }
                return web.Response(
                    status=r.get("status", 500),
                    headers=headers,
                    body=r.get("body", b""),
                )
            if want_stream:
                # newline-delimited JSON over chunked transfer (the HTTP
                # face of the core streaming-generator transport), fully
                # loop-native: no executor thread parks per stream, so
                # slow token cadences can't exhaust the shared pool.
                # Errors after prepare() must TERMINATE this stream (an
                # error line + eof) — the outer handler's 500 would write
                # a second response into the open chunked body.
                sr = web.StreamResponse(
                    headers={"Content-Type": "application/x-ndjson"}
                )
                await sr.prepare(request)
                try:
                    while True:
                        try:
                            item = await resp._next_async()
                        except StopAsyncIteration:
                            break
                        await sr.write(
                            (json.dumps(item, default=str) + "\n").encode()
                        )
                except Exception as e:  # noqa: BLE001 — ends the stream
                    try:
                        await sr.write((json.dumps(
                            {"error": f"{type(e).__name__}: {e}"}
                        ) + "\n").encode())
                    except Exception:
                        pass  # client already gone
                try:
                    await sr.write_eof()
                except Exception:
                    pass
                return sr
            # result_async carries the pow-2 router's replica-death
            # failover — HTTP clients get the same retry semantics as
            # handle-API callers instead of a bare 500.
            value = await resp.result_async()
        except RequestShedError as e:
            # load shed: fast-fail with the standard overload answer so
            # clients back off instead of retry-storming (Retry-After is
            # whole seconds per RFC 9110)
            import math

            return web.Response(
                status=503,
                headers={
                    "Retry-After": str(max(1, math.ceil(e.retry_after_s)))
                },
                text=str(e),
            )
        except Exception as e:  # noqa: BLE001 — surface as 500
            return web.Response(status=500, text=f"{type(e).__name__}: {e}")
        if isinstance(value, (dict, list)):
            return web.json_response(value)
        if isinstance(value, bytes):
            return web.Response(body=value)
        return web.Response(text=str(value))

    async def ping(self) -> bool:
        return True
