"""The port's autoscaler on real raylets, on the CPU: the JAX package's
scale-up-then-idle-drain case (``tests/test_autoscaler.py:112``), the
launcher's ``up``/``status``/``down`` lifecycle with the ``local``
provider (``tests/test_cluster_launcher.py:157`` uses the TPU-slice
provider, which the port refuses), and a one-GPU node type under
``RT_GPU_COUNT_OVERRIDE=1``: a pending one-card task launches a node whose
lease sees the node's card, and the idle node is drained and removed.

Marked ``slow`` (``test_zz_*``): every case starts raylets.
"""

import asyncio
import os
import sys
import time

import cloudpickle
import pytest
import yaml

import ray_tpu_torch as rt
from ray_tpu_torch.autoscaler import Autoscaler, AutoscalerConfig, LocalSubprocessProvider, NodeTypeConfig
from ray_tpu_torch.autoscaler import launcher
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core import rpc
from ray_tpu_torch.util import state
from test_torch_runtime import runtime_defaults

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def by_value():
    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    yield
    cloudpickle.unregister_pickle_by_value(module)


def _mk(cluster, types, **kw):
    provider = LocalSubprocessProvider(cluster.gcs_address, cluster.session_dir)
    return Autoscaler(cluster.gcs_address, provider, AutoscalerConfig(node_types=types, **kw)), provider


def _drive(autoscaler, cluster, predicate, timeout):
    """Reconcile passes until ``predicate()`` holds (True) or the time is
    up (False), as the reference's test drives them."""
    async def go():
        autoscaler.gcs = rpc.ReconnectingConnection(cluster.gcs_address, name="autoscaler->gcs")
        deadline = time.monotonic() + timeout
        try:
            while time.monotonic() < deadline:
                await autoscaler.reconcile()
                if predicate():
                    return True
                await asyncio.sleep(0.2)
            return False
        finally:
            await autoscaler.gcs.close()

    return asyncio.run(go())


@pytest.fixture()
def scaling_cluster(by_value, monkeypatch):
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    with runtime_defaults():
        os.environ["RT_GPU_COUNT_OVERRIDE"] = "1"
        cluster = Cluster(initialize_head=True, connect=True, head_node_args={"num_cpus": 1})
        try:
            yield cluster
        finally:
            rt.shutdown()
            cluster.shutdown()
            os.environ.pop("RT_GPU_COUNT_OVERRIDE", None)


def test_pending_pg_triggers_scale_up_then_idle_drain(scaling_cluster):
    from ray_tpu_torch.util import placement_group, remove_placement_group

    autoscaler, provider = _mk(scaling_cluster, [
        NodeTypeConfig("small", {"CPU": 2}, max_workers=4),
        NodeTypeConfig("slice4", {"CPU": 4, "slice4": 1}, max_workers=2)],
        idle_timeout_s=2.0, interval_s=0.2)
    try:
        # a STRICT_PACK PG for an absent node shape -> scale up
        pg = placement_group([{"CPU": 4}], strategy="STRICT_PACK")
        assert not pg.wait(timeout_seconds=1)  # head has only 1 CPU
        assert _drive(autoscaler, scaling_cluster, lambda: len(provider.non_terminated_nodes()) >= 1, 30), \
            "autoscaler never launched a node"
        assert pg.wait(timeout_seconds=30), "PG never placed on the new node"
        assert provider.non_terminated_nodes()[0].node_type == "slice4"
        # remove the PG -> the node goes idle -> drained after timeout
        remove_placement_group(pg)
        assert _drive(autoscaler, scaling_cluster, lambda: len(provider.non_terminated_nodes()) == 0, 30), \
            "idle node never drained"
    finally:
        provider.shutdown()


def _card():
    return (os.environ.get("CUDA_VISIBLE_DEVICES"), os.environ.get("RT_GPU_VISIBLE_DEVICES"),
            rt.get_runtime_context().node_id)


def test_one_gpu_node_type_scales_up_for_a_pending_task_then_drains(scaling_cluster):
    """Without an autoscaler a one-card task on a cluster without cards is
    refused at once, as in the reference; once the autoscaler has reported
    its GPU node type the task pends, a node with the host's card is
    launched, the task's lease sees that card, and the idle node is
    drained and removed."""
    autoscaler, provider = _mk(scaling_cluster, [NodeTypeConfig("gpu1", {"CPU": 1, "GPU": 1}, 0, 1)],
                               idle_timeout_s=2.0, interval_s=0.2)
    task = rt.remote(num_gpus=1)(_card)
    try:
        with pytest.raises(rt.TaskError, match="infeasible"):
            rt.get(task.remote(), timeout=30)
        assert _drive(autoscaler, scaling_cluster, lambda: True, 10)  # one pass: the types reported
        ref = task.remote()
        deadline = time.monotonic() + 30
        while not state.summarize()["pending_leases"] and time.monotonic() < deadline:
            time.sleep(0.1)
        assert state.summarize()["pending_leases"] == 1 and not provider.non_terminated_nodes()
        assert _drive(autoscaler, scaling_cluster, lambda: len(provider.non_terminated_nodes()) >= 1, 30), \
            "autoscaler never launched the GPU node"
        (node,) = provider.non_terminated_nodes()
        assert node.node_type == "gpu1" and node.meta["gpus"] == ["0"]
        assert rt.get(ref, timeout=60) == ("0", "0", node.node_id_hex)
        row = {n["node_id"]: n for n in state.list_nodes()}[node.node_id_hex]
        assert row["resources_total"]["GPU"] == 1.0
        assert row["labels"]["ray_tpu_torch.node_type"] == "gpu1"
        assert _drive(autoscaler, scaling_cluster, lambda: not provider.non_terminated_nodes(), 30), \
            "idle GPU node never drained"
        assert state.summarize()["pending_leases"] == 0
        assert not any(n["alive"] for n in state.list_nodes() if n["node_id"] == node.node_id_hex)
    finally:
        provider.shutdown()


def _pid_alive(pid: int) -> bool:
    try:
        os.waitpid(pid, os.WNOHANG)  # reap our own zombie child
    except ChildProcessError:
        pass
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(") ", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, IndexError):
        return False


def test_up_status_down_lifecycle(tmp_path):
    """``up`` starts the head, the monitor and min_workers nodes of the
    ``local`` provider; ``status`` sees them labelled; a second ``up`` is
    refused; ``down`` stops the nodes, the monitor and the head and drops
    the record."""
    name = f"launcher-e2e-{os.getpid()}"
    cfg = {
        "cluster_name": name,
        "provider": {"type": "local"},
        "head": {"resources": {"CPU": 2}},
        "available_node_types": {"cpu1": {"resources": {"CPU": 1}, "min_workers": 1, "max_workers": 2}},
        "autoscaler_interval_s": 0.2,
        "idle_timeout_s": 3600,
    }
    path = tmp_path / "cluster.yaml"
    path.write_text(yaml.safe_dump(cfg))
    with runtime_defaults():
        state_rec = launcher.up(str(path), wait_min_workers_s=120.0)
        try:
            assert launcher.load_state(name) is not None
            nodes = [n for n in launcher._query_nodes(state_rec["gcs_address"]) if n["alive"]]
            heads = [n for n in nodes if n["labels"].get("ray_tpu_torch.head")]
            workers = [n for n in nodes if n["labels"].get("ray_tpu_torch.node_type") == "cpu1"]
            assert len(heads) == 1 and len(workers) == 1
            assert heads[0]["resources_total"]["CPU"] == 2.0 and workers[0]["resources_total"]["CPU"] == 1.0
            with pytest.raises(launcher.ClusterConfigError, match="already up"):
                launcher.up(str(path))
        finally:
            stats = launcher.down(str(path))
    assert stats["provider_nodes"] >= 1 and stats["processes"] == 3
    deadline = time.monotonic() + 15
    pids = [state_rec[k] for k in ("monitor_pid", "gcs_pid", "raylet_pid")]
    while any(_pid_alive(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.2)
    assert not any(_pid_alive(p) for p in pids)
    assert launcher.load_state(name) is None
