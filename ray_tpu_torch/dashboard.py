"""Cluster dashboard: HTTP JSON API + single-page UI over live state.

Role-equivalent of ray: dashboard/head.py:81 + dashboard/modules/
{node,actor,job,metrics,state}/ — collapsed into one aiohttp server fed
directly from the GCS tables through the state API, instead of a head
process + per-node agents + React build.  The UI is a self-contained
HTML page (no build step) polling the JSON endpoints.

Endpoints::

    GET /                       single-page UI
    GET /healthz                liveness probe
    GET /api/summary            cluster summary (ray status analogue)
    GET /api/nodes|actors|tasks|workers|objects|placement_groups
    GET /api/jobs               submitted jobs (job_submission)
    GET /api/metrics            aggregated Counter/Gauge/Histogram points
    GET /api/timeline           chrome-trace events
    GET /api/logs               log files in this node's session dir
    GET /api/logs/{name}?lines=N   tail one log file

Logs are served from the dashboard node's own session dir; in this
repo's single-host test topology every raylet shares the host, so all
worker logs are visible.  (A per-node log RPC is the multi-host
extension point, like the reference's dashboard agents.)

The rows are the port's state rows, so the node pages show each node's
``GPU`` (and ``GPU-<kind>``) total and available, and the actor pages an
actor's ``GPU`` lease.  The renderers are the reference's, byte for byte
but the product name in the page titles.  The server is aiohttp, imported
in the dashboard actor only: importing this module loads neither aiohttp
nor torch.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

import ray_tpu_torch
from ray_tpu_torch.common.constants import session_root

logger = logging.getLogger(__name__)

DASHBOARD_NAME = "_rt_dashboard"

#: (route-kind, nav label) for the per-subsystem HTML pages
_PAGE_KINDS = [
    ("nodes", "Nodes"),
    ("actors", "Actors"),
    ("tasks", "Tasks"),
    ("workers", "Workers"),
    ("objects", "Objects"),
    ("placement_groups", "Placement groups"),
    ("jobs", "Jobs"),
    ("metrics", "Metrics"),
    ("events", "Events"),
    ("logs", "Logs"),
]

_PAGE_CSS = """
 body{font-family:system-ui,sans-serif;margin:1.5rem;background:#fafafa}
 h1{font-size:1.3rem}
 table{border-collapse:collapse;width:100%;background:#fff}
 th,td{border:1px solid #ddd;padding:4px 8px;font-size:.85rem;text-align:left}
 th{background:#f0f0f0} pre{background:#fff;border:1px solid #ddd;padding:8px}
 nav a{margin-right:.8rem} nav a.active{font-weight:bold}
"""


def _render_table(rows, raw: bool = False) -> str:
    """Server-side twin of the index page's JS table(): union of keys as
    columns, values escaped (``raw=True`` only for server-built trusted
    cells like log links)."""
    import html as _html

    if isinstance(rows, dict):
        rows = [
            {"key": k, "value": v} for k, v in rows.items()
        ]
    if not rows:
        return "<i>none</i>"
    if not isinstance(rows, list) or not isinstance(rows[0], dict):
        return f"<pre>{_html.escape(json.dumps(rows, default=str, indent=1))}</pre>"
    cols = []
    for r in rows:
        for k in r:
            if k not in cols:
                cols.append(k)

    def cell(v):
        s = json.dumps(v, default=str) if isinstance(
            v, (dict, list)
        ) else ("" if v is None else str(v))
        return s if raw else _html.escape(s)

    out = ["<table><tr>"]
    out += [f"<th>{_html.escape(str(c))}</th>" for c in cols]
    out.append("</tr>")
    for r in rows:
        out.append("<tr>")
        out += [f"<td>{cell(r.get(c))}</td>" for c in cols]
        out.append("</tr>")
    out.append("</table>")
    return "".join(out)


def _render_page(title: str, active: str, content: str,
                 api: str = "", client_refresh: bool = False) -> str:
    """Page skeleton: shared nav + server-rendered content; when ``api``
    is set and refresh requested, the content re-renders client-side
    from the same JSON endpoint every 5 s."""
    import html as _html

    # NOTE: the class attr is built outside the f-string — a backslash
    # escape inside an f-string expression is a syntax error before 3.12
    active_attr = ' class="active"'
    nav = "".join(
        f'<a href="/{k}"{active_attr if k == active else ""}>'
        f"{label}</a>"
        for k, label in _PAGE_KINDS
    )
    refresh = ""
    if api and client_refresh:
        refresh = f"""<script>
{_TABLE_JS}
setInterval(async()=>{{
  try{{const r=await fetch('{api}');
      document.getElementById('content').innerHTML=table(await r.json());
  }}catch(e){{}}
}},5000);
</script>"""
    return f"""<!doctype html>
<html><head><meta charset="utf-8">
<title>ray_tpu_torch — {_html.escape(title)}</title>
<style>{_PAGE_CSS}</style></head><body>
<h1>ray_tpu_torch — {_html.escape(title)}</h1>
<nav><a href="/">Overview</a>{nav}</nav>
<div id="content">{content}</div>
{refresh}</body></html>"""


_TABLE_JS = """
function esc(s){const d=document.createElement('div');d.textContent=s;return d.innerHTML}
function table(rows){
  if(rows && !Array.isArray(rows)) rows=Object.entries(rows).map(([key,value])=>({key,value}));
  if(!rows || !rows.length) return '<i>none</i>';
  const cols=[...new Set(rows.flatMap(r=>Object.keys(r)))];
  let h='<table><tr>'+cols.map(c=>'<th>'+esc(c)+'</th>').join('')+'</tr>';
  for(const r of rows) h+='<tr>'+cols.map(c=>'<td>'+
    esc(typeof r[c]==='object'&&r[c]!==null?JSON.stringify(r[c]):String(r[c]??''))+'</td>').join('')+'</tr>';
  return h+'</table>';
}
"""


_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>ray_tpu_torch dashboard</title>
<style>
 body{font-family:system-ui,sans-serif;margin:1.5rem;background:#fafafa}
 h1{font-size:1.3rem} h2{font-size:1.05rem;margin-top:1.4rem}
 table{border-collapse:collapse;width:100%;background:#fff}
 th,td{border:1px solid #ddd;padding:4px 8px;font-size:.85rem;text-align:left}
 th{background:#f0f0f0} pre{background:#fff;border:1px solid #ddd;padding:8px}
 .pill{display:inline-block;padding:0 6px;border-radius:8px;background:#e8f0fe}
</style></head><body>
<h1>ray_tpu_torch dashboard</h1>
<nav>{NAV}</nav>
<div id="summary"></div>
<h2>Nodes</h2><div id="nodes"></div>
<h2>Actors</h2><div id="actors"></div>
<h2>Placement groups</h2><div id="placement_groups"></div>
<h2>Jobs</h2><div id="jobs"></div>
<h2>Metrics</h2><div id="metrics"></div>
<script>
function table(rows){
  if(!rows || !rows.length) return '<i>none</i>';
  const cols=[...new Set(rows.flatMap(r=>Object.keys(r)))];
  let h='<table><tr>'+cols.map(c=>'<th>'+c+'</th>').join('')+'</tr>';
  for(const r of rows) h+='<tr>'+cols.map(c=>'<td>'+
    (typeof r[c]==='object'?JSON.stringify(r[c]):String(r[c]??''))+'</td>').join('')+'</tr>';
  return h+'</table>';
}
async function refresh(){
  for(const name of ['nodes','actors','placement_groups','jobs','metrics']){
    try{const r=await fetch('/api/'+name);
        document.getElementById(name).innerHTML=table(await r.json());}catch(e){}
  }
  try{const s=await(await fetch('/api/summary')).json();
      document.getElementById('summary').innerHTML='<pre>'+JSON.stringify(s,null,1)+'</pre>';}catch(e){}
}
refresh(); setInterval(refresh, 5000);
</script></body></html>"""

# one source of truth for the page list: the index nav is generated from
# _PAGE_KINDS exactly like every subsystem page's nav
_HTML = _HTML.replace(
    "{NAV}",
    "".join(
        f'<a href="/{k}">{label}</a>' for k, label in _PAGE_KINDS
    ),
)


def render_prometheus(metrics: list) -> str:
    """GCS metric aggregate → Prometheus text exposition format.

    Series keys are json-encoded sorted tag pairs with optional
    ``|le=...`` / ``|sum`` histogram suffixes; gauges are prefixed
    ``reporter|`` (kept as a `reporter` label so per-process values stay
    distinct under aggregation)."""
    import json as _json
    import re

    def sanitize(name: str) -> str:
        return re.sub(r"[^a-zA-Z0-9_:]", "_", name)

    def labels(tags_json: str, extra: dict) -> str:
        try:
            pairs = dict(tuple(p) for p in _json.loads(tags_json))
        except Exception:
            pairs = {}
        pairs.update(extra)
        if not pairs:
            return ""
        def esc(v) -> str:
            return (
                str(v)
                .replace("\\", "\\\\")
                .replace("\n", "\\n")
                .replace('"', '\\"')
            )

        inner = ",".join(
            f'{sanitize(k)}="{esc(v)}"' for k, v in sorted(pairs.items())
        )
        return "{" + inner + "}"

    out = []
    for m in metrics:
        name = sanitize(m["name"])
        mtype = m["type"]
        if m.get("description"):
            desc = (
                str(m["description"])
                .replace("\\", "\\\\")
                .replace("\n", "\\n")
            )
            out.append(f"# HELP {name} {desc}")
        out.append(f"# TYPE {name} {mtype}")
        for key, value in sorted(m["series"].items()):
            extra = {}
            if mtype == "gauge" and "|" in key:
                reporter, key = key.split("|", 1)
                extra["reporter"] = reporter
            if mtype == "histogram":
                # suffixes are APPENDED after the json tags, so the LAST
                # '|' is the real separator (a '|' inside a tag value
                # must not split the key)
                tags_json, _, suffix = key.rpartition("|")
                if suffix.startswith("le="):
                    le = suffix[3:]
                    out.append(
                        f"{name}_bucket"
                        f"{labels(tags_json, {**extra, 'le': le})} {value}"
                    )
                elif suffix == "sum":
                    out.append(
                        f"{name}_sum{labels(tags_json, extra)} {value}"
                    )
                continue
            out.append(f"{name}{labels(key, extra)} {value}")
    # histogram _count = the +Inf bucket, emitted in a second pass
    for m in metrics:
        if m["type"] != "histogram":
            continue
        name = sanitize(m["name"])
        for key, value in sorted(m["series"].items()):
            if key.endswith("|le=+Inf"):
                tags_json = key.rsplit("|", 1)[0]
                out.append(f"{name}_count{labels(tags_json, {})} {value}")
    return "\n".join(out) + "\n"


@ray_tpu_torch.remote
class DashboardActor:
    """Serves the dashboard; runs as a detached actor on the cluster."""

    def __init__(self, port: int = 8265, host: str = "127.0.0.1"):
        # localhost by default: the dashboard serves cluster state and log
        # file contents with no auth, so a network bind must be explicit
        # (matches the reference dashboard's default).
        self._port = port
        self._host = host
        self._runner = None

    async def start(self) -> int:
        from aiohttp import web

        if self._runner is not None:  # idempotent under get_if_exists reuse
            return self._port
        app = web.Application()
        app.router.add_get("/", self._index)
        app.router.add_get("/healthz", self._healthz)
        app.router.add_get("/api/summary", self._summary)
        for name in ("nodes", "actors", "tasks", "workers", "objects",
                     "placement_groups"):
            app.router.add_get(f"/api/{name}", self._make_list(name))
        app.router.add_get("/api/jobs", self._jobs)
        # REST job API (reference: dashboard/modules/job/job_head.py:273-380
        # JobHead) — external tooling/CI submits without the Python SDK;
        # thin handlers over the GCS job-manager RPCs
        app.router.add_post("/api/jobs/", self._job_submit)
        app.router.add_get("/api/jobs/{submission_id}", self._job_info)
        app.router.add_get(
            "/api/jobs/{submission_id}/logs", self._job_logs
        )
        app.router.add_post(
            "/api/jobs/{submission_id}/stop", self._job_stop
        )
        app.router.add_delete("/api/jobs/{submission_id}", self._job_delete)
        app.router.add_get("/api/metrics", self._metrics)
        app.router.add_get("/metrics", self._metrics_prometheus)
        app.router.add_get("/api/profile/stacks", self._profile_stacks)
        app.router.add_get("/api/events", self._events)
        app.router.add_get("/api/timeline", self._timeline)
        app.router.add_get("/api/logs", self._logs_index)
        app.router.add_get("/api/logs/{name}", self._logs_tail)
        # per-subsystem HTML pages (reference role: the dashboard UI's
        # pages — cluster/actors/jobs/..., here server-rendered tables).
        # /metrics stays the Prometheus endpoint for scrapers; browsers
        # get the HTML page via Accept-header negotiation there.
        for kind, label in _PAGE_KINDS:
            if kind == "metrics":
                continue
            app.router.add_get(
                f"/{kind}", self._make_html_page(kind, label)
            )
        app.router.add_get("/logs/{name}", self._log_page)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self._host, self._port)
        await site.start()
        if self._port == 0:  # ephemeral: report the bound port
            for server in self._runner.sites:
                sock = server._server.sockets[0]
                self._port = sock.getsockname()[1]
                break
        return self._port

    def ping(self) -> bool:
        return True

    # -- handlers ------------------------------------------------------

    async def _index(self, req):
        from aiohttp import web

        return web.Response(text=_HTML, content_type="text/html")

    async def _healthz(self, req):
        from aiohttp import web

        return web.json_response({"ok": True})

    def _json(self, payload):
        from aiohttp import web

        return web.Response(
            text=json.dumps(payload, default=str),
            content_type="application/json",
        )

    async def _offload(self, fn):
        # state calls block on runtime._run, which posts to THIS actor's
        # event loop — run them in an executor thread or they deadlock
        import asyncio

        return await asyncio.get_running_loop().run_in_executor(None, fn)

    async def _summary(self, req):
        from ray_tpu_torch.util import state

        return self._json(await self._offload(state.summarize))

    def _make_list(self, name):
        async def handler(req):
            from ray_tpu_torch.util import state

            fn = getattr(state, f"list_{name}")
            return self._json(await self._offload(fn))

        return handler

    async def _jobs(self, req):
        return self._json(await self._page_rows("jobs"))

    # -- REST job API (ray: dashboard/modules/job/job_head.py:273-380) --

    def _gcs_call(self, method, payload):
        from ray_tpu_torch.core.runtime import get_runtime

        def call():
            rt = get_runtime()
            return rt._run(rt.gcs.call(method, payload))

        return self._offload(call)

    async def _job_submit(self, req):
        from aiohttp import web

        try:
            body = await req.json()
        except Exception:
            return web.json_response(
                {"error": "body must be JSON"}, status=400
            )
        if not body.get("entrypoint"):
            return web.json_response(
                {"error": "entrypoint is required"}, status=400
            )
        payload = {
            "entrypoint": body["entrypoint"],
            "submission_id": body.get("submission_id"),
            "runtime_env": body.get("runtime_env"),
            "metadata": body.get("metadata", {}),
        }
        try:
            reply = await self._gcs_call("submit_job", payload)
        except Exception as e:  # duplicate id, bad runtime env, ...
            return web.json_response({"error": str(e)}, status=400)
        return web.json_response(
            {"submission_id": reply["submission_id"]}
        )

    async def _job_info(self, req):
        from aiohttp import web

        try:
            info = await self._gcs_call(
                "get_job_info",
                {"submission_id": req.match_info["submission_id"]},
            )
        except Exception:  # GCS raises for unknown submission ids
            return web.json_response({"error": "no such job"}, status=404)
        return self._json(info)

    async def _job_logs(self, req):
        from aiohttp import web

        try:
            logs = await self._gcs_call(
                "get_job_logs",
                {"submission_id": req.match_info["submission_id"]},
            )
        except Exception:
            return web.json_response({"error": "no such job"}, status=404)
        return web.json_response({"logs": logs})

    async def _job_stop(self, req):
        from aiohttp import web

        ok = await self._gcs_call(
            "stop_job", {"submission_id": req.match_info["submission_id"]}
        )
        if not ok:
            return web.json_response({"error": "no such job"}, status=404)
        return web.json_response({"stopped": True})

    async def _job_delete(self, req):
        from aiohttp import web

        try:
            ok = await self._gcs_call(
                "delete_job",
                {"submission_id": req.match_info["submission_id"]},
            )
        except Exception as e:  # still RUNNING
            return web.json_response({"error": str(e)}, status=400)
        if not ok:
            return web.json_response({"error": "no such job"}, status=404)
        return web.json_response({"deleted": True})

    async def _metrics(self, req):
        return self._json(await self._page_rows("metrics"))

    async def _metrics_prometheus(self, req):
        """Prometheus text exposition of the GCS metric aggregate
        (reference role: the per-node metrics agent's /metrics endpoint,
        ray: dashboard/modules/reporter — here one scrape target for the
        cluster, point `prometheus.yml` at /metrics).  Browsers (Accept:
        text/html) get the HTML metrics page at the same path; scrapers
        negotiate text/plain."""
        if "text/html" in req.headers.get("Accept", ""):
            return await self._make_html_page("metrics", "Metrics")(req)
        from aiohttp import web

        from ray_tpu_torch.util import state

        metrics = await self._offload(state.get_metrics)
        return web.Response(
            text=render_prometheus(metrics),
            content_type="text/plain",
            charset="utf-8",
        )

    async def _profile_stacks(self, req):
        """GET /api/profile/stacks?worker=<hex> — on-demand per-thread
        stacks of a live worker (py-spy role)."""
        from ray_tpu_torch.util import state

        worker = req.query.get("worker", "")
        if not worker:
            return self._json({"error": "pass ?worker=<hex worker id>"})
        try:
            return self._json(
                await self._offload(lambda: state.worker_stacks(worker))
            )
        except Exception as e:  # noqa: BLE001 — surfaced to the caller
            return self._json({"error": repr(e)})

    async def _events(self, req):
        from ray_tpu_torch.util import events

        sev = req.query.get("severity")

        def call():
            return events.list_events(severity=sev)

        return self._json(await self._offload(call))

    async def _timeline(self, req):
        return self._json(await self._offload(ray_tpu_torch.timeline))

    def _session_dir(self) -> str:
        return os.environ.get("RT_SESSION_DIR", session_root())

    async def _logs_index(self, req):
        return self._json(await self._page_rows("logs"))

    async def _logs_tail(self, req):
        from aiohttp import web

        name = req.match_info["name"]
        if "/" in name or ".." in name or not name.endswith(".log"):
            return web.Response(status=400, text="bad log name")
        path = os.path.join(self._session_dir(), name)
        if not os.path.exists(path):
            return web.Response(status=404, text="no such log")
        lines = int(req.query.get("lines", "200"))
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - 256 * 1024))
            tail = f.read().decode("utf-8", "replace").splitlines()[-lines:]
        return web.Response(text="\n".join(tail), content_type="text/plain")

    # -- HTML pages ------------------------------------------------------
    # Server-rendered first paint (the data is IN the HTML — no JS
    # needed to see live state), then a fetch-refresh keeps it current.
    # Function parity with the reference dashboard's pages
    # (ray: dashboard/client/src/pages/ — cluster/actors/jobs/...), not
    # framework parity: tables over the same JSON the API serves.

    async def _page_rows(self, kind: str):
        """ONE rows provider per subsystem, consumed by both the JSON
        API handlers and the HTML pages — the two surfaces must never
        diverge on what the data is."""
        from ray_tpu_torch.core.runtime import get_runtime
        from ray_tpu_torch.util import events as events_mod
        from ray_tpu_torch.util import state

        if kind == "jobs":
            def call():
                rt = get_runtime()
                return rt._run(rt.gcs.call("list_jobs", {}))
        elif kind == "events":
            def call():
                return events_mod.list_events()
        elif kind == "metrics":
            def call():
                return state.get_metrics()
        elif kind == "logs":
            d = self._session_dir()

            def call():
                try:
                    return [
                        {
                            "name": f,
                            "size": os.path.getsize(os.path.join(d, f)),
                        }
                        for f in sorted(os.listdir(d))
                        if f.endswith(".log")
                    ]
                except FileNotFoundError:
                    return []
        else:
            fn = getattr(state, f"list_{kind}")

            def call():
                return fn()
        return await self._offload(call)

    def _make_html_page(self, kind: str, title: str):
        async def handler(req):
            from aiohttp import web

            try:
                rows = await self._page_rows(kind)
            except Exception as e:  # noqa: BLE001 — page must render
                rows = [{"error": repr(e)}]
            raw_html = kind == "logs"
            if raw_html:
                rows = [
                    {**r, "name": f'<a href="/logs/{r["name"]}">'
                                  f'{r["name"]}</a>'}
                    for r in rows
                ]
            page = _render_page(
                title, kind, _render_table(rows, raw=raw_html),
                api=f"/api/{kind}",
                client_refresh=not raw_html,
            )
            return web.Response(text=page, content_type="text/html")

        return handler

    async def _log_page(self, req):
        from aiohttp import web

        import html as _html

        name = req.match_info["name"]
        if "/" in name or ".." in name or not name.endswith(".log"):
            return web.Response(status=400, text="bad log name")
        path = os.path.join(self._session_dir(), name)
        if not os.path.exists(path):
            return web.Response(status=404, text="no such log")
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - 256 * 1024))
            tail = f.read().decode("utf-8", "replace").splitlines()[-500:]
        body = (
            f"<pre id=\"log\">{_html.escape(chr(10).join(tail))}</pre>"
            f"<script>setInterval(async()=>{{"
            f"const r=await fetch('/api/logs/{name}?lines=500');"
            f"document.getElementById('log').textContent=await r.text();"
            f"}},3000)</script>"
        )
        return web.Response(
            text=_render_page(f"log: {name}", "logs", body),
            content_type="text/html",
        )


def start_dashboard(port: int = 8265, host: str = "127.0.0.1") -> str:
    """Start (or reuse) the cluster dashboard; returns its URL.

    ``host`` is the bind address on whichever node hosts the dashboard
    actor.  The localhost default is safe (no auth on the endpoints);
    multi-node operators who need remote access pass ``host="0.0.0.0"``
    explicitly and front it themselves.
    """
    actor = DashboardActor.options(
        name=DASHBOARD_NAME, get_if_exists=True, lifetime="detached",
        num_cpus=0.1,
    ).remote(port, host)
    bound = ray_tpu_torch.get(actor.start.remote(), timeout=120)
    display = "127.0.0.1" if host in ("0.0.0.0", "127.0.0.1") else host
    return f"http://{display}:{bound}"


def stop_dashboard() -> None:
    try:
        actor = ray_tpu_torch.get_actor(DASHBOARD_NAME)
        ray_tpu_torch.kill(actor)
    except Exception:
        pass
