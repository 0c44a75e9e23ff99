"""The port's dashboard over HTTP, on the CPU: the 18 cases of the JAX
package's ``tests/test_dashboard.py`` (ray: dashboard/head.py + modules)
against ``ray_tpu_torch.dashboard`` on a runtime of 4 CPUs and one
declared card (``RT_GPU_COUNT_OVERRIDE=1``), and the node and actor
pages of a GPU lease.

Marked ``slow`` (``test_zz_*``): the dashboard runs in a detached actor.
"""

import json
import os
import time
import urllib.error
import urllib.request

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.dashboard import start_dashboard, stop_dashboard
from test_torch_runtime import runtime_defaults

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def dash_url():
    with runtime_defaults():
        os.environ["RT_GPU_COUNT_OVERRIDE"] = "1"
        saved = os.environ.pop("CUDA_VISIBLE_DEVICES", None)
        try:
            rt.init(num_cpus=4, num_gpus=1, log_to_driver=False)
            url = start_dashboard(port=0)
            yield url
            stop_dashboard()
            rt.shutdown()
        finally:
            os.environ.pop("RT_GPU_COUNT_OVERRIDE", None)
            if saved is not None:
                os.environ["CUDA_VISIBLE_DEVICES"] = saved


def _get(url, as_json=True):
    with urllib.request.urlopen(url, timeout=30) as r:
        body = r.read().decode()
    return json.loads(body) if as_json else body


def _req(url, method, payload=None, timeout=60):
    """curl-shaped helper: returns (status, parsed-JSON body)."""
    data = json.dumps(payload).encode() if payload is not None else None
    req = urllib.request.Request(
        url, data=data, method=method,
        headers={"Content-Type": "application/json"} if data else {},
    )
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode())


class TestDashboard:
    def test_healthz_and_index(self, dash_url):
        assert _get(f"{dash_url}/healthz") == {"ok": True}
        page = _get(f"{dash_url}/", as_json=False)
        assert "ray_tpu_torch dashboard" in page

    def test_summary_and_nodes(self, dash_url):
        s = _get(f"{dash_url}/api/summary")
        assert s["nodes_alive"] >= 1
        nodes = _get(f"{dash_url}/api/nodes")
        assert any(n["alive"] for n in nodes)

    def test_actors_listing_sees_new_actor(self, dash_url):
        @rt.remote
        class Marker:
            def ping(self):
                return 1

        a = Marker.options(name="dash-marker").remote()
        rt.get(a.ping.remote(), timeout=60)
        actors = _get(f"{dash_url}/api/actors")
        assert any(row.get("name") == "dash-marker" for row in actors)
        rt.kill(a)

    def test_metrics_endpoint(self, dash_url):
        rows = _get(f"{dash_url}/api/metrics")
        assert isinstance(rows, list)

    def test_logs_index_and_tail(self, dash_url):
        files = _get(f"{dash_url}/api/logs")
        assert any(f["name"].endswith(".log") for f in files)
        name = files[0]["name"]
        txt = _get(f"{dash_url}/api/logs/{name}?lines=5", as_json=False)
        assert isinstance(txt, str)

    def test_logs_path_traversal_refused(self, dash_url):
        with pytest.raises(Exception):
            _get(f"{dash_url}/api/logs/..%2Fetc%2Fpasswd", as_json=False)

    def test_placement_groups_endpoint(self, dash_url):
        rows = _get(f"{dash_url}/api/placement_groups")
        assert isinstance(rows, list)


class TestHtmlPages:
    """Every subsystem page server-renders LIVE data — the first paint
    carries real cluster state in the HTML, no JS required (reference
    role: dashboard/client/src/pages/, function parity as SSR tables)."""

    def test_every_page_renders(self, dash_url):
        for kind in ("nodes", "actors", "tasks", "workers", "objects",
                     "placement_groups", "jobs", "events", "logs"):
            page = _get(f"{dash_url}/{kind}", as_json=False)
            assert "<nav>" in page and "<h1>ray_tpu_torch — " in page, kind
            assert "error" not in page.split("<nav>")[0].lower(), kind

    def test_metrics_path_content_negotiates(self, dash_url):
        # browsers get the HTML page; scrapers keep the Prometheus text
        req = urllib.request.Request(
            f"{dash_url}/metrics", headers={"Accept": "text/html"}
        )
        with urllib.request.urlopen(req, timeout=30) as r:
            assert "<nav>" in r.read().decode()
        plain = _get(f"{dash_url}/metrics", as_json=False)
        assert "<nav>" not in plain

    def test_nodes_page_shows_live_node(self, dash_url):
        nodes = _get(f"{dash_url}/api/nodes")
        page = _get(f"{dash_url}/nodes", as_json=False)
        # the registered node's id appears in the server-rendered table
        assert any(
            str(n.get("node_id", ""))[:12] in page for n in nodes
        )
        assert "<table>" in page

    def test_actors_page_shows_named_actor(self, dash_url):
        @rt.remote
        class PageMarker:
            def ping(self):
                return 1

        a = PageMarker.options(name="html-page-marker").remote()
        rt.get(a.ping.remote(), timeout=60)
        page = _get(f"{dash_url}/actors", as_json=False)
        assert "html-page-marker" in page
        rt.kill(a)

    def test_pg_page_shows_live_pg(self, dash_url):
        from ray_tpu_torch.util import placement_group, remove_placement_group

        pg = placement_group([{"CPU": 0.1}], strategy="PACK")
        pg.wait(timeout_seconds=60)
        page = _get(f"{dash_url}/placement_groups", as_json=False)
        assert "PACK" in page
        remove_placement_group(pg)

    def test_logs_page_links_to_tail_view(self, dash_url):
        page = _get(f"{dash_url}/logs", as_json=False)
        assert 'href="/logs/' in page
        logs = _get(f"{dash_url}/api/logs")
        name = logs[0]["name"]
        tail = _get(f"{dash_url}/logs/{name}", as_json=False)
        assert "<pre" in tail and name in tail

    def test_events_page_shows_reported_event(self, dash_url):
        from ray_tpu_torch.util import events

        events.report(
            "INFO", "dashboard-html-probe", "page render check"
        )
        page = _get(f"{dash_url}/events", as_json=False)
        assert "dashboard-html-probe" in page

    def test_page_content_is_escaped(self, dash_url):
        @rt.remote
        class Xss:
            def ping(self):
                return 1

        a = Xss.options(name="<script>alert(1)</script>").remote()
        rt.get(a.ping.remote(), timeout=60)
        page = _get(f"{dash_url}/actors", as_json=False)
        assert "<script>alert(1)</script>" not in page
        assert "&lt;script&gt;" in page
        rt.kill(a)


class TestRestJobApi:
    """REST job endpoints (ray: dashboard/modules/job/job_head.py:273-380):
    submit over HTTP, poll to SUCCEEDED, fetch logs, stop, delete —
    external tooling needs no Python SDK."""

    def test_submit_poll_logs_delete(self, dash_url):
        status, body = _req(
            f"{dash_url}/api/jobs/", "POST",
            {"entrypoint": "echo rest-job-hello && echo done"},
        )
        assert status == 200, body
        sub_id = body["submission_id"]

        deadline = time.monotonic() + 60
        info = None
        while time.monotonic() < deadline:
            status, info = _req(f"{dash_url}/api/jobs/{sub_id}", "GET")
            assert status == 200
            if info["status"] in ("SUCCEEDED", "FAILED", "STOPPED"):
                break
            time.sleep(0.3)
        assert info["status"] == "SUCCEEDED", info

        status, logs = _req(f"{dash_url}/api/jobs/{sub_id}/logs", "GET")
        assert status == 200
        assert "rest-job-hello" in logs["logs"]

        status, body = _req(f"{dash_url}/api/jobs/{sub_id}", "DELETE")
        assert status == 200 and body["deleted"]
        status, _ = _req(f"{dash_url}/api/jobs/{sub_id}", "GET")
        assert status == 404

    def test_stop_running_job(self, dash_url):
        status, body = _req(
            f"{dash_url}/api/jobs/", "POST",
            {"entrypoint": "sleep 600", "submission_id": "rest-sleeper"},
        )
        assert status == 200
        # deleting a RUNNING job is refused
        status, body = _req(f"{dash_url}/api/jobs/rest-sleeper", "DELETE")
        assert status == 400
        status, body = _req(
            f"{dash_url}/api/jobs/rest-sleeper/stop", "POST"
        )
        assert status == 200 and body["stopped"]
        status, info = _req(f"{dash_url}/api/jobs/rest-sleeper", "GET")
        assert info["status"] == "STOPPED"
        status, _ = _req(f"{dash_url}/api/jobs/rest-sleeper", "DELETE")
        assert status == 200

    def test_validation_and_404s(self, dash_url):
        status, body = _req(f"{dash_url}/api/jobs/", "POST", {})
        assert status == 400
        assert "entrypoint" in body["error"]
        assert _req(f"{dash_url}/api/jobs/nope", "GET")[0] == 404
        assert _req(f"{dash_url}/api/jobs/nope/logs", "GET")[0] == 404
        assert _req(f"{dash_url}/api/jobs/nope/stop", "POST")[0] == 404
        assert _req(f"{dash_url}/api/jobs/nope", "DELETE")[0] == 404


class TestGpuLease:
    """The node and actor pages of a one-card lease: the node shows its
    card in use while an actor holds it, the actor its ``GPU``."""

    def test_node_and_actor_pages_show_a_gpu_lease(self, dash_url):
        @rt.remote(num_gpus=1, num_cpus=0)
        class CardHolder:
            def card(self):
                return os.environ.get("CUDA_VISIBLE_DEVICES")

        (node,) = _get(f"{dash_url}/api/nodes")
        assert node["resources_total"]["GPU"] == node["resources_available"]["GPU"] == 1.0
        a = CardHolder.options(name="gpu-lease-marker").remote()
        assert rt.get(a.card.remote(), timeout=60) == "0"
        (node,) = _get(f"{dash_url}/api/nodes")
        # a resource fully in use drops out of the available row
        assert node["resources_total"]["GPU"] == 1.0 and "GPU" not in node["resources_available"]
        page = _get(f"{dash_url}/nodes", as_json=False)
        assert page.count("&quot;GPU&quot;: 1.0") == 1
        row = next(r for r in _get(f"{dash_url}/api/actors") if r.get("name") == "gpu-lease-marker")
        assert row["resources"].get("GPU") == 1
        page = _get(f"{dash_url}/actors", as_json=False)
        assert "gpu-lease-marker" in page and "&quot;GPU&quot;: 1" in page
        summary = _get(f"{dash_url}/api/summary")
        assert summary["resources_total"]["GPU"] == 1.0 and "GPU" not in summary["resources_available"]
        rt.kill(a)
