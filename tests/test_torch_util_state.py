"""The port's cluster APIs against the JAX package's, on the CPU: events
(``util/events.py``), the state API (``util/state.py``), the distributed
queue (``util/queue.py``), the client (``util/client.py``), and the card
split of ``cluster_utils`` as a pure function.

Both packages run here side by side, each as a one-node ``Cluster`` (4
CPUs) with this process attached by ``util.client.connect``: every case
makes the same calls in both, and the rows must carry the same keys, the
values the same where the two clusters share them, and the queue the same
outcomes, call by call.  The multi-node tests are in
``tests/test_zz_torch_cluster.py``.
"""

import concurrent.futures
import os
import sys
import threading
import time

import cloudpickle
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import cluster_utils as ref_cluster_utils
from ray_tpu.util import client as ref_client
from ray_tpu.util import events as ref_events
from ray_tpu.util import queue as ref_queue
from ray_tpu.util import state as ref_state
from ray_tpu_torch import cluster_utils
from ray_tpu_torch.util import client, events, queue, state
from test_torch_runtime import runtime_defaults

PACKAGES = {
    "ref": (ray_tpu, ref_cluster_utils, ref_client, ref_events, ref_state, ref_queue),
    "port": (ray_tpu_torch, cluster_utils, client, events, state, queue),
}


@pytest.fixture(scope="module")
def clusters():
    """A one-node cluster of each package, this process attached to both."""
    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    out = {}
    with runtime_defaults():
        try:
            for name, (_, cu, cl, *_) in PACKAGES.items():
                c = cu.Cluster(initialize_head=True, head_node_args={"num_cpus": 4})
                out[name] = (c, cl.connect(c.address))
            yield out
        finally:
            for c, ctx in out.values():
                ctx.disconnect()
                c.shutdown()
            cloudpickle.unregister_pickle_by_value(module)


def each(fn):
    """``fn(package modules)`` for both packages, the two at once (the
    reference's from a second thread)."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ref = pool.submit(fn, *PACKAGES["ref"])
        port = fn(*PACKAGES["port"])
        return {"ref": ref.result(timeout=300), "port": port}


def test_client_connect(clusters):
    for name, (c, ctx) in clusters.items():
        rt = PACKAGES[name][0]
        assert ctx.address == c.address and ctx.info["gcs_address"] == c.address
        assert repr(ctx) == f"ClientContext(address={c.address!r})"
        assert [n["node_id"] for n in rt.nodes() if n["alive"]] == [c.head_node.node_id]
    assert sorted(clusters["port"][1].info) == sorted(clusters["ref"][1].info)


def test_events(clusters):
    def run(rt, cu, cl, ev, st, q):
        ev.report("INFO", "test", "hello", run=1)
        ev.report("ERROR", "test", "boom", code=7)
        ev.report("WARNING", "test", "warn-only-probe")
        rows = ev.list_events()
        boom = [r for r in rows if r["message"] == "boom"][0]
        warn = ev.list_events(severity="WARNING")
        with pytest.raises(ValueError):
            ev.report("LOUD", "test", "nope")
        assert st.list_events is ev.list_events
        return (sorted(boom), boom["severity"], boom["code"], boom["ts"] > 0,
                {r["severity"] for r in warn}, [r["message"] for r in warn if r["source"] == "test"])

    got = each(run)
    assert got["port"] == got["ref"]
    assert got["port"][0] == ["code", "message", "severity", "source", "ts"]


class Probe:
    def ping(self):
        return 1


def _sleeper(release):
    """Runs until the file ``release`` exists (at most 60 s)."""
    deadline = time.monotonic() + 60
    while not os.path.exists(release) and time.monotonic() < deadline:
        time.sleep(0.02)
    return release


def test_state_rows_and_summary(clusters, tmp_path):
    """The same keys in every row kind, the same filters, the same
    summary; node rows carry the port's resources (no TPU)."""
    def run(rt, cu, cl, ev, st, q):
        actor = rt.remote(num_cpus=0.5)(Probe).remote()
        rt.get(actor.ping.remote(), timeout=120)
        ref = rt.put(list(range(1000)))
        release = str(tmp_path / rt.__name__)
        task = rt.remote(num_cpus=0.5)(_sleeper).remote(release)
        deadline, running = time.monotonic() + 60, []
        while not running and time.monotonic() < deadline:
            running = st.list_tasks([("name", "!=", "nothing")])
            time.sleep(0.05)
        busy = [w for w in st.list_workers() if w["num_running_tasks"] > 0]
        stacks = st.worker_stacks(busy[0]["worker_id"])
        open(release, "w").close()
        rt.get(task, timeout=60)
        nodes = st.list_nodes()
        alive = st.list_actors([("state", "=", "ALIVE")])
        with pytest.raises(ValueError, match="unsupported filter op"):
            st.list_nodes([("alive", ">", 0)])
        summary = st.summarize()
        objects = st.list_objects()
        rt.kill(actor)
        del ref
        return {
            "node_keys": sorted(nodes[0]), "node_alive": [n["alive"] for n in nodes],
            "cpu": nodes[0]["resources_total"]["CPU"],
            "actor_keys": sorted(alive[0]), "n_alive": len(alive),
            "task_keys": sorted(running[0]), "task_name": running[0]["name"].rsplit(".", 1)[-1],
            "worker_keys": sorted(busy[0]), "stack_keys": sorted(stacks),
            "stack_names_task": any("_sleeper" in s for s in stacks["stacks"].values()),
            "object_keys": sorted(objects[0]) if objects else None,
            "summary_keys": sorted(summary), "nodes_alive": summary["nodes_alive"],
            "actors_alive": summary["actors_alive"], "pending_leases": summary["pending_leases"],
            "no_tpu": "TPU" not in nodes[0]["resources_total"],
        }

    got = each(run)
    assert got["port"] == got["ref"]
    assert got["port"]["task_name"] == "_sleeper" and got["port"]["stack_names_task"]
    assert got["port"]["cpu"] == 4.0 and got["port"]["nodes_alive"] == 1 and got["port"]["no_tpu"]


def _queue_outcomes(rt, q):
    """One fixed call sequence on a queue of 2, each call's outcome."""
    out = []

    def step(fn, *args, **kw):
        try:
            out.append(("ok", fn(*args, **kw)))
        except (q.Empty, q.Full, ValueError) as e:
            out.append((type(e).__name__, None))

    qq = q.Queue(maxsize=2)
    step(qq.put, 1)
    step(qq.put, 2)
    step(qq.full)
    step(qq.put_nowait, 3)
    step(qq.put, 3, timeout=0.2)
    step(qq.put, 3, timeout=-1)
    step(qq.get)
    step(qq.get_nowait)
    step(qq.get_nowait)
    step(qq.get, timeout=0.2)
    step(qq.empty)
    step(qq.put_nowait_batch, [1, 2, 3])
    step(qq.put_nowait_batch, [4, 5])
    step(qq.get_nowait_batch, 3)
    step(qq.get_nowait_batch, 2)
    step(qq.qsize)
    # a blocked get is woken by a put from another thread
    got = []
    t = threading.Thread(target=lambda: got.append(qq.get(timeout=30)))
    t.start()
    time.sleep(0.3)
    step(qq.put, "late")
    t.join(timeout=60)
    out.append(("thread", got))
    qq.shutdown()
    return out


def test_queue_matches_the_reference(clusters):
    got = each(lambda rt, cu, cl, ev, st, q: _queue_outcomes(rt, q))
    assert got["port"] == got["ref"]
    assert [k for k, _ in got["port"]].count("Full") == 3 and [k for k, _ in got["port"]].count("Empty") == 3


def _put_tensor(qq, seed):
    qq.put(torch.randn(64, 64, generator=torch.Generator().manual_seed(seed)).to(torch.bfloat16))


def test_queue_carries_a_tensor(clusters):
    qq = queue.Queue()
    try:
        ray_tpu_torch.get(ray_tpu_torch.remote(num_cpus=0.5)(_put_tensor).remote(qq, 3), timeout=120)
        got = qq.get(timeout=60)
    finally:
        qq.shutdown()
    want = torch.randn(64, 64, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    assert got.device.type == "cpu" and got.dtype == torch.bfloat16 and torch.equal(got, want)


# -- cluster_utils: the card split, no process started ------------------------


def test_node_resources_split_cards():
    res, gpus = cluster_utils.node_resources(2, 1, {"side": 1.0}, ["0", "1"], [])
    assert res == {"side": 1.0, "CPU": 2.0, "GPU": 1.0} and gpus == ["0"]
    assert cluster_utils.node_resources(1, 1, None, ["0", "1"], ["0"])[1] == ["1"]
    assert cluster_utils.node_resources(1, 2, None, ["3", "5", "6"], ["5"]) == (
        {"CPU": 1.0, "GPU": 2.0}, ["3", "6"])
    res, gpus = cluster_utils.node_resources(2, 0, None, [], [])
    assert res == {"CPU": 2.0} and gpus == []


@pytest.mark.parametrize("kwargs,match", [
    (dict(num_gpus=1, host=["0"], taken=["0"]), "0 of its 1 card"),
    (dict(num_gpus=2, host=["0"], taken=[]), "1 of its 1 card"),
    (dict(num_gpus=0.5, host=["0"], taken=[]), "whole number"),
    (dict(num_gpus=0, host=[], taken=[], num_tpus=1), "ask for num_gpus"),
    (dict(num_gpus=0, host=[], taken=[], resources={"TPU": 4.0}), "ask for num_gpus"),
    (dict(num_gpus=0, host=[], taken=[], resources={"TPU-v4": 1.0}), "ask for num_gpus"),
    (dict(num_gpus=0, host=["0"], taken=[], resources={"GPU": 1.0}), "as num_gpus"),
], ids=["taken", "too-many", "fraction", "num_tpus", "tpu-key", "tpu-kind", "gpu-key"])
def test_node_resources_refuses(kwargs, match):
    resources = kwargs.pop("resources", None)
    with pytest.raises(ValueError, match=match):
        cluster_utils.node_resources(1, resources=resources, **kwargs)


@pytest.mark.parametrize("env,want", [
    ({"RT_GPU_COUNT_OVERRIDE": "2"}, ["0", "1"]),
    ({"RT_GPU_COUNT_OVERRIDE": "2", "CUDA_VISIBLE_DEVICES": "3,5"}, ["3", "5"]),
    ({"RT_GPU_COUNT_OVERRIDE": "3", "CUDA_VISIBLE_DEVICES": "4"}, ["4"]),
    ({"RT_GPU_COUNT_OVERRIDE": "0"}, []),
], ids=["count", "visible", "visible-fewer", "none"])
def test_host_gpus(monkeypatch, env, want):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    with runtime_defaults():
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert cluster_utils.host_gpus() == want
