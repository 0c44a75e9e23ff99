"""The port's operator surface against the JAX package's, on the CPU, with
no process started: the dashboard's renderers (``render_prometheus``,
``_render_table``, ``_render_page``), the autoscaler's planning, the
launcher's config validation, the KubeRay provider's requests against the
reference's fake API server, the CLI's parser, the version and where the
CLI and the launcher keep their records.

Whatever starts a GCS, a raylet or a job is in the slow
``tests/test_zz_torch_{jobs,dashboard,autoscaler}.py``.
"""

import argparse
import os
import subprocess
import sys
import urllib.request

import pytest
import yaml

import ray_tpu._version
import ray_tpu_torch
import ray_tpu_torch._version
import test_k8s_provider as ref_k8s_test
from ray_tpu import dashboard as ref_dashboard
from ray_tpu import scripts as ref_scripts
from ray_tpu.autoscaler import autoscaler as ref_autoscaler
from ray_tpu.autoscaler import k8s_provider as ref_k8s
from ray_tpu.autoscaler import launcher as ref_launcher
from ray_tpu.autoscaler import node_provider as ref_node_provider
from ray_tpu_torch import dashboard, scripts
from ray_tpu_torch.autoscaler import autoscaler, k8s_provider, launcher, node_provider
from ray_tpu_torch.common import config as port_config
from ray_tpu_torch.common.constants import session_root
from test_torch_runtime import runtime_defaults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {
    "ref": (ref_autoscaler, ref_node_provider, ref_k8s),
    "port": (autoscaler, node_provider, k8s_provider),
}


def test_version_agrees_with_the_reference():
    assert ray_tpu_torch.__version__ == ray_tpu_torch._version.version == ray_tpu._version.version


# ---- dashboard renderers ----------------------------------------------------

_METRICS = [
    {"name": "tasks_total", "type": "counter", "description": "tasks run\nby a \\ worker",
     "series": {'[["node", "n1"]]': 7.0, '[["node", "n\\"2"]]': 3.0, "[]": 1.0}},
    {"name": "store.bytes-used", "type": "gauge", "description": "",
     "series": {'raylet-1|[["node", "n1"]]': 1024.0, "raylet-2|[]": 2048.0, "[]": 5.0}},
    {"name": "lat_s", "type": "histogram",
     "series": {'[["op", "a|b"]]|le=0.1': 2.0, '[["op", "a|b"]]|le=+Inf': 5.0,
                '[["op", "a|b"]]|sum': 1.25, "[]|le=+Inf": 1.0, "[]|sum": 0.5, "not json|le=1": 9.0}},
    {"name": "gpu_util", "type": "gauge", "series": {"w|[[\"GPU\", \"0\"]]": 0.5}},
]


def test_render_prometheus_is_the_references():
    got = dashboard.render_prometheus(_METRICS)
    assert got == ref_dashboard.render_prometheus(_METRICS)
    assert 'tasks_total{node="n\\"2"} 3.0' in got and "lat_s_count{" in got
    assert dashboard.render_prometheus([]) == ref_dashboard.render_prometheus([]) == "\n"


_ROWS = {
    "none": [],
    "dict": {"GPU": 1.0, "CPU": 4.0, "nested": {"a": [1, 2]}},
    "nodes": [{"node_id": "ab" * 14, "alive": True, "resources_total": {"CPU": 2.0, "GPU": 1.0},
               "resources_available": {"CPU": 2.0, "GPU": 0.0}, "labels": {}},
              {"node_id": "cd" * 14, "alive": False, "extra": None}],
    "escaped": [{"name": "<script>alert(1)</script>", "resources": {"GPU": 1}}],
    "scalars": [1, "two", None],
}


@pytest.mark.parametrize("raw", [False, True])
@pytest.mark.parametrize("rows", sorted(_ROWS))
def test_render_table_is_the_references(rows, raw):
    assert dashboard._render_table(_ROWS[rows], raw=raw) == ref_dashboard._render_table(_ROWS[rows], raw=raw)


@pytest.mark.parametrize("refresh", [False, True])
@pytest.mark.parametrize("kind", [k for k, _ in dashboard._PAGE_KINDS])
def test_render_page_is_the_references_but_the_name(kind, refresh):
    """Each page and the index, the product name in their titles aside;
    the node page of a GPU lease shows it."""
    content = dashboard._render_table(_ROWS["nodes"])
    args = (f"{kind} <&>", kind, content)
    got = dashboard._render_page(*args, api=f"/api/{kind}", client_refresh=refresh)
    want = ref_dashboard._render_page(*args, api=f"/api/{kind}", client_refresh=refresh)
    assert got != want and got.replace("ray_tpu_torch — ", "ray_tpu — ") == want
    assert "<h1>ray_tpu_torch — " in got and "&quot;GPU&quot;: 0.0" in got
    assert dashboard._HTML.replace("ray_tpu_torch dashboard", "ray_tpu dashboard") == ref_dashboard._HTML
    assert dashboard._PAGE_KINDS == ref_dashboard._PAGE_KINDS


# ---- autoscaler planning ----------------------------------------------------

def _mk(pkg, extra_types=()):
    a_mod, np_mod, _ = PACKAGES[pkg]
    provider = np_mod.LocalSubprocessProvider("127.0.0.1:1", "/nonexistent")
    cfg = a_mod.AutoscalerConfig(node_types=[
        a_mod.NodeTypeConfig("small", {"CPU": 2}, max_workers=4),
        a_mod.NodeTypeConfig("slice4", {"CPU": 4, "slice4": 1}, max_workers=2),
        *(a_mod.NodeTypeConfig(*t) for t in extra_types),
    ])
    return a_mod.Autoscaler("127.0.0.1:1", provider, cfg)


def _state(nodes=(), leases=(), bundles=()):
    """tests/test_autoscaler.py TestPlanning._state."""
    return {
        "nodes": [{"node_id": f"n{i}", "alive": True, "idle": False, "labels": {},
                   "resources_total": t, "resources_available": a} for i, (t, a) in enumerate(nodes)],
        "pending_leases": [{"demand": d, "strategy": {}} for d in leases],
        "pending_pg_bundles": [{"pg_id": "x", "strategy": "STRICT_PACK", "bundles": bs} for bs in bundles],
    }


GPU_TYPES = (("gpu1", {"CPU": 2, "GPU": 1}, 0, 1), ("gpu2", {"CPU": 4, "GPU": 2}, 0, 1))
# (state, extra node types, the reference's plan): the seven cases of
# tests/test_autoscaler.py:60-96, then one-card leases against GPU types.
PLANS = {
    "no-demand": (_state(nodes=[({"CPU": 2}, {"CPU": 2})]), (), []),
    "existing-capacity": (_state(nodes=[({"CPU": 4}, {"CPU": 4})], leases=[{"CPU": 2}]), (), []),
    "smallest-fitting": (_state(leases=[{"CPU": 1}]), (), ["small"]),
    "strict-pack": (_state(bundles=[[{"CPU": 4}]]), (), ["slice4"]),
    "bin-packing": (_state(leases=[{"CPU": 1}, {"CPU": 1}]), (), ["small"]),
    "max-workers": (_state(bundles=[[{"CPU": 4}], [{"CPU": 4}], [{"CPU": 4}]]), (), ["slice4", "slice4"]),
    "infeasible": (_state(leases=[{"CPU": 64}]), (), []),
    "gpu-lease": (_state(nodes=[({"CPU": 2}, {"CPU": 2})], leases=[{"GPU": 1, "CPU": 1}]), GPU_TYPES, ["gpu1"]),
    "gpu-max-workers": (_state(leases=[{"GPU": 1}, {"GPU": 1}, {"GPU": 1}]), GPU_TYPES, ["gpu1", "gpu2"]),
    "gpu-too-many": (_state(leases=[{"GPU": 3}]), GPU_TYPES, []),
}


@pytest.mark.parametrize("case", list(PLANS))
def test_plans_equal_the_references(case):
    st, types, want = PLANS[case]
    plans = {}
    for pkg in PACKAGES:
        a = _mk(pkg, types)
        unmet = a._unmet_demands(st)
        plans[pkg] = ([u.to_dict() for u in unmet], a._plan_launches(unmet, st))
    assert plans["port"] == plans["ref"]
    assert plans["port"][1] == want


def test_node_types_refuse_a_tpu():
    with pytest.raises(ValueError, match="no TPU"):
        autoscaler.NodeTypeConfig("v5e", {"CPU": 8, "TPU": 4})
    with pytest.raises(ValueError, match="no TPU"):
        autoscaler.NodeTypeConfig("v5e", {"TPU-v5e": 4})


def test_split_cards_gives_a_node_its_own():
    """A GPU node type's node is given cards of the host not taken, as
    ``Cluster.add_node`` gives them; a type without CPU gets none."""
    assert node_provider.split_cards({"CPU": 2, "GPU": 1, "side": 1}, ["0", "1"], ["0"]) == (
        {"CPU": 2.0, "GPU": 1.0, "side": 1}, ["1"])
    assert node_provider.split_cards({"GPU": 2}, ["3", "5"], []) == ({"GPU": 2.0}, ["3", "5"])
    assert node_provider.split_cards({"CPU": 1}, [], []) == ({"CPU": 1.0}, [])
    for bad in ({"GPU": 1}, {"GPU": 0.5}, {"TPU": 1}):
        with pytest.raises(ValueError):
            node_provider.split_cards(bad, ["0"], ["0"])


# ---- launcher -----------------------------------------------------------------

_TYPES = {"t": {"resources": {"CPU": 1}}}
CONFIGS = {
    "local": {"cluster_name": "x", "provider": {"type": "local"},
              "available_node_types": {"gpu1": {"resources": {"CPU": 2, "GPU": 1}, "min_workers": 0,
                                                "max_workers": 2, "labels": {"k": "v"}}}},
    "kuberay": {"cluster_name": "x", "provider": {"type": "kuberay", "namespace": "ml"},
                "available_node_types": _TYPES},
    "bad-type": {"cluster_name": "x", "provider": {"type": "nope"}, "available_node_types": {}},
    "gce-missing": {"cluster_name": "x", "provider": {"type": "gce_tpu"}, "available_node_types": _TYPES},
    "min-over-max": {"cluster_name": "x", "provider": {"type": "local"},
                     "available_node_types": {"t": {"resources": {"CPU": 1}, "min_workers": 5,
                                                    "max_workers": 2}}},
    "no-resources": {"cluster_name": "x", "provider": {"type": "local"}, "available_node_types": {"t": {}}},
    "no-name": {"provider": {"type": "local"}, "available_node_types": _TYPES},
    "not-a-mapping": ["cluster_name", "x"],
    "no-provider-type": {"cluster_name": "x", "provider": None, "available_node_types": _TYPES},
}
GCE_OK = {"cluster_name": "x", "provider": {"type": "gce_tpu", "project_id": "p", "zone": "z"},
          "available_node_types": _TYPES}


def _load(mod, cfg, path):
    path.write_text(yaml.safe_dump(cfg))
    try:
        return mod.load_cluster_config(str(path))
    except mod.ClusterConfigError as e:
        return type(e).__name__


@pytest.mark.parametrize("case", list(CONFIGS))
def test_config_validation_equals_the_references(case, tmp_path):
    """tests/test_cluster_launcher.py:233 and more: the same configs are
    accepted, with the same node types, and the same refused."""
    got = _load(launcher, CONFIGS[case], tmp_path / "c.yaml")
    assert got == _load(ref_launcher, CONFIGS[case], tmp_path / "c.yaml")
    if isinstance(got, dict):
        port = [vars(t) for t in launcher.node_type_configs(got)]
        assert port == [vars(t) for t in ref_launcher.node_type_configs(got)]


def test_gce_tpu_is_refused(tmp_path):
    """The reference provisions TPU slices for this config; the port has
    no TPU to schedule and names the item that decides its counterpart."""
    path = tmp_path / "c.yaml"
    assert isinstance(_load(ref_launcher, GCE_OK, path), dict)
    path.write_text(yaml.safe_dump(GCE_OK))
    with pytest.raises(launcher.ClusterConfigError, match="ROADMAP A4"):
        launcher.load_cluster_config(str(path))


def test_records_live_under_the_session_root(monkeypatch, tmp_path):
    """The CLI's session file and the launcher's cluster records are the
    port's own, under its session root, never the reference's paths."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    assert scripts._session_file() == os.path.join(session_root(), "latest_cli_session.json")
    assert launcher._state_path("c") == os.path.join(session_root(), "clusters", "c.json")
    assert session_root().startswith(str(tmp_path))
    assert scripts._session_file() != ref_scripts._SESSION_FILE


# ---- KubeRay provider against the reference's fake API server ----------------

def _initial(mods, prov, state):
    return [(n.node_type, n.node_id_hex, n.provider_id) for n in prov.non_terminated_nodes()]


def _scale_up(mods, prov, state):
    pn = prov.create_node("v5e-4", {"GPU": 4}, {})
    return pn.meta, [(n.node_type, n.provider_id, n.meta) for n in prov.non_terminated_nodes()]


def _scale_down(mods, prov, state):
    prov.create_node("v5e-4", {"GPU": 4}, {})
    prov.create_node("v5e-4", {"GPU": 4}, {})
    nodes = [n for n in prov.non_terminated_nodes() if n.node_type == "v5e-4"]
    prov.terminate_node(nodes[0])
    return nodes[0].provider_id, [n.provider_id for n in prov.non_terminated_nodes()]


def _pending(mods, prov, state):
    state.reconcile = lambda: None  # the operator makes no pods
    prov.create_node("v5e-4", {"GPU": 4}, {})
    return [(n.node_type, n.provider_id, n.meta) for n in prov.non_terminated_nodes()]


def _unknown_and_404(mods, prov, state):
    with pytest.raises(KeyError) as k:
        prov.create_node("no-such-group", {}, {})
    with pytest.raises(mods[2].KubeApiError) as e:
        prov.api.get("/apis/ray-tpu.io/v1/namespaces/ml/rtclusters/other")
    return str(k.value), e.value.status


def _conflicts(mods, prov, state):
    state.conflicts_to_serve = 2
    prov.create_node("v5e-4", {"GPU": 4}, {})
    return state.cr["spec"]["workerGroups"]


def _autoscaler_drives(mods, prov, state):
    import asyncio

    a_mod = mods[0]

    class StubGcs:
        async def call(self, m, p):
            return {"nodes": [], "pending_leases": [{"demand": {"GPU": 4.0}}], "pending_pg_bundles": []}

    a = a_mod.Autoscaler("unused", prov, a_mod.AutoscalerConfig(node_types=[
        a_mod.NodeTypeConfig("v5e-4", {"CPU": 4, "GPU": 4}, 0, 4),
        a_mod.NodeTypeConfig("cpu-small", {"CPU": 4}, 1, 4)]))
    a.gcs = StubGcs()
    out = []
    for _ in range(2):
        asyncio.run(a.reconcile())
        out.append([n.provider_id for n in prov.non_terminated_nodes() if n.node_type == "v5e-4"])
    return out


# the seven cases of tests/test_k8s_provider.py, in its order
K8S_CASES = {f.__name__.strip("_"): f for f in (_initial, _scale_up, _scale_down, _pending, _unknown_and_404,
                                                  _conflicts, _autoscaler_drives)}


def _run_k8s(pkg, case, monkeypatch):
    """One case against a fresh reference fake server; every request as
    it left the client: method, path, the headers that matter, body bytes."""
    mods = PACKAGES[pkg]
    sent = []
    real = urllib.request.urlopen
    server = ref_k8s_test.kube_server.__wrapped__()
    state, _, url = next(server)

    def recording(req, *a, **k):
        hdrs = {h: req.get_header(h) for h in ("Authorization", "Accept", "Content-type")}
        sent.append((req.get_method(), req.full_url[len(url):], hdrs, req.data))
        return real(req, *a, **k)

    monkeypatch.setattr(urllib.request, "urlopen", recording)
    try:
        api = mods[2].RestKubeApi(base_url=url, token_fn=lambda: ref_k8s_test.TOKEN)
        prov = mods[2].KubeRayProvider(api, ref_k8s_test.NS, ref_k8s_test.NAME)
        return K8S_CASES[case](mods, prov, state), sent
    finally:
        monkeypatch.setattr(urllib.request, "urlopen", real)
        next(server, None)


@pytest.mark.parametrize("case", list(K8S_CASES))
def test_k8s_requests_equal_the_references(case, monkeypatch):
    got, got_sent = _run_k8s("port", case, monkeypatch)
    want, want_sent = _run_k8s("ref", case, monkeypatch)
    assert got_sent == want_sent and got == want
    assert got_sent and all(s[2]["Authorization"] == f"Bearer {ref_k8s_test.TOKEN}" for s in got_sent)
    if case == "conflicts":
        patches = [s for s in got_sent if s[0] == "PATCH"]
        assert len(patches) == 3 and {g["name"]: g["replicas"] for g in got} == {"v5e-4": 1, "cpu-small": 1}
    if case == "autoscaler_drives":
        assert [len(x) for x in got] == [1, 1]
    assert k8s_provider.GROUP == ref_k8s.GROUP and k8s_provider.cr_path("a", "b") == ref_k8s.cr_path("a", "b")


# ---- CLI --------------------------------------------------------------------

class _Parsed(Exception):
    pass


def _options(main, monkeypatch):
    """Each subcommand's option strings and positionals, from the parser
    a CLI's main() builds."""
    grabbed = {}

    def grab(self, *a, **k):
        grabbed["parser"] = self
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Parsed):
        main(["status"])
    monkeypatch.undo()
    (sub,) = [a for a in grabbed["parser"]._actions if isinstance(a, argparse._SubParsersAction)]
    return {name: sorted(o for act in p._actions for o in (act.option_strings or [act.dest]))
            for name, p in sub.choices.items()}


def test_cli_has_the_references_commands(monkeypatch):
    port = _options(scripts.main, monkeypatch)
    ref = _options(ref_scripts.main, monkeypatch)
    assert port.keys() == ref.keys()
    assert {k for k in port if port[k] != ref[k]} == {"start"}
    assert set(port["start"]) - set(ref["start"]) == {"--num-gpus"}
    assert set(ref["start"]) <= set(port["start"])


def test_cli_help_and_tpu_refusal():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    top = subprocess.run([sys.executable, "-m", "ray_tpu_torch", "--help"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=60)
    start = subprocess.run([sys.executable, "-m", "ray_tpu_torch", "start", "--help"], cwd=REPO, env=env,
                           capture_output=True, text=True, timeout=60)
    assert top.returncode == start.returncode == 0, top.stderr + start.stderr
    for cmd in ("start", "stop", "up", "down", "status", "list", "metrics", "stacks", "memory", "events",
                "timeline"):
        assert cmd in top.stdout
    assert "usage: ray_tpu_torch" in top.stdout
    assert "--num-gpus" in start.stdout and "--num-tpus" not in start.stdout
    with pytest.raises(ValueError, match="no TPU"):
        scripts.main(["start", "--head", "--num-tpus", "1"])


def test_start_records_the_nodes_cards(monkeypatch):
    """``start --num-gpus N`` names the host's first N cards where the GCS
    and the raylet read them; a set already named is kept."""
    with runtime_defaults():
        monkeypatch.setenv("RT_GPU_COUNT_OVERRIDE", "2")
        monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "3,5")
        monkeypatch.delenv("RT_GPU_VISIBLE_DEVICES", raising=False)
        port_config.cfg.reset()
        scripts._record_cards(1)
        assert os.environ["RT_GPU_VISIBLE_DEVICES"] == "3"
        scripts._record_cards(2)
        assert os.environ["RT_GPU_VISIBLE_DEVICES"] == "3"
        monkeypatch.delenv("RT_GPU_VISIBLE_DEVICES")
        scripts._record_cards(3)  # more declared than the host has
        assert "RT_GPU_VISIBLE_DEVICES" not in os.environ
        monkeypatch.undo()
