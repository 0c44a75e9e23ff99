"""ASGI ingress: mount an existing ASGI app (FastAPI, Starlette, any
scope/receive/send callable) on a deployment.

Role-equivalent of ray: @serve.ingress (python/ray/serve/api.py:172) —
requests under the deployment's route prefix are dispatched through the
ASGI app with path routing intact, so an existing web app deploys
unmodified.  The transport differs from the reference (which runs
uvicorn inside the replica): here the HTTP proxy ships a compact request
dict over the actor RPC, and the replica drives the ASGI protocol
in-process — one hop, no per-replica HTTP server.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


async def run_asgi_request(asgi_app: Callable, req: Dict[str, Any]) -> dict:
    """Drive one http-scope ASGI exchange; returns {status, headers,
    body} for the proxy to reconstruct the HTTP response."""
    scope = {
        "type": "http",
        "asgi": {"version": "3.0", "spec_version": "2.3"},
        "http_version": "1.1",
        "method": req.get("method", "GET"),
        "scheme": "http",
        "path": req.get("path", "/"),
        "raw_path": req.get("path", "/").encode(),
        "query_string": (req.get("query_string") or "").encode(),
        "root_path": "",
        "headers": [
            (k.lower().encode(), v.encode())
            for k, v in req.get("headers") or []
        ],
        "server": ("ray-tpu-serve", 0),
        "client": ("127.0.0.1", 0),
    }
    body = req.get("body") or b""
    state = {"status": 500, "headers": [], "parts": [], "sent_request": False}

    async def receive():
        if not state["sent_request"]:
            state["sent_request"] = True
            return {"type": "http.request", "body": body, "more_body": False}
        return {"type": "http.disconnect"}

    async def send(message):
        t = message["type"]
        if t == "http.response.start":
            state["status"] = message["status"]
            state["headers"] = [
                (k.decode("latin1"), v.decode("latin1"))
                for k, v in message.get("headers") or []
            ]
        elif t == "http.response.body":
            state["parts"].append(bytes(message.get("body") or b""))

    await asgi_app(scope, receive, send)
    return {
        "status": state["status"],
        "headers": state["headers"],
        "body": b"".join(state["parts"]),
    }


def ingress(asgi_app: Callable):
    """Class decorator: ``@serve.deployment`` + ``@serve.ingress(app)``
    routes every HTTP request under the deployment's prefix through
    ``asgi_app``.  The decorated class's instance state coexists with
    the app (lifecycle, handles in init args, etc.)."""

    def wrap(cls):
        if not isinstance(cls, type):
            raise TypeError(
                "@serve.ingress decorates the deployment CLASS "
                "(apply @serve.deployment above it)"
            )

        async def __asgi_handle__(self, req: Dict[str, Any]) -> dict:
            return await run_asgi_request(type(self).__rt_asgi_app__, req)

        cls.__rt_asgi_app__ = asgi_app
        cls.__rt_is_asgi__ = True
        cls.__asgi_handle__ = __asgi_handle__
        return cls

    return wrap
