"""The port's multi-raylet ``Cluster`` (``ray_tpu_torch.cluster_utils``)
on the CPU: the JAX package's ``tests/test_cluster_utils.py`` (multi-node
scheduling, object transfer, custom resources, node death, actor restart,
store cleanup) on the port's runtime, and the card split: two nodes given
one each of two declared cards, whose tasks see disjoint
``CUDA_VISIBLE_DEVICES``.

Marked ``slow`` (past the tier-1 window, ``test_zz_*``): every case starts
raylets and waits on node deaths.  The pure card-split cases are in
``tests/test_torch_util_state.py``.
"""

import os
import sys
import time

import cloudpickle
import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.util import NodeAffinitySchedulingStrategy
from test_torch_runtime import runtime_defaults

pytestmark = pytest.mark.slow


@pytest.fixture(scope="module")
def by_value():
    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    yield
    cloudpickle.unregister_pickle_by_value(module)


@pytest.fixture(scope="class")
def cluster(by_value):
    with runtime_defaults():
        c = Cluster(initialize_head=True, head_node_args={"num_cpus": 2})
        try:
            c.add_node(num_cpus=2, resources={"side": 2.0})
            c.connect()
            c.wait_for_nodes()
            yield c
        finally:
            rt.shutdown()
            c.shutdown()


def _where(t):
    time.sleep(t)
    return rt.get_runtime_context().node_id


class TestMultiNode:
    def test_cluster_resources(self, cluster):
        assert rt.cluster_resources()["CPU"] == 4.0
        assert "GPU" not in rt.cluster_resources()

    def test_tasks_use_both_nodes(self, cluster):
        # 4 concurrent 1-CPU tasks need both 2-CPU nodes
        refs = [rt.remote(_where).remote(1.0) for _ in range(4)]
        assert len(set(rt.get(refs, timeout=120))) == 2

    def test_object_transfer_across_nodes(self, cluster):
        produce = rt.remote(resources={"side": 1})(lambda: np.arange(1 << 18, dtype=np.float32))
        consume = rt.remote(num_cpus=1)(lambda arr: float(arr.sum()))
        total = rt.get(consume.remote(produce.remote()), timeout=120)
        assert total == float(np.arange(1 << 18, dtype=np.float32).sum())

    def test_custom_resource_placement(self, cluster):
        side_node = rt.get(rt.remote(resources={"side": 1})(_where).remote(0), timeout=60)
        by_id = {n["node_id"]: n for n in rt.nodes()}
        assert by_id[side_node]["resources_total"].get("side") == 2.0


class Pinned:
    def node(self):
        return rt.get_runtime_context().node_id


class TestNodeFailure:
    def test_node_death_detected_and_actor_restarts(self, cluster):
        doomed = cluster.add_node(num_cpus=2, resources={"doomed": 1.0})
        cluster.wait_for_nodes()
        a = rt.remote(Pinned).options(resources={"doomed": 0.5}, max_restarts=1,
                                      max_task_retries=-1).remote()
        assert rt.get(a.node.remote(), timeout=60) == doomed.node_id
        cluster.remove_node(doomed)
        deadline = time.time() + 30
        while time.time() < deadline and len([n for n in rt.nodes() if n["alive"]]) != 2:
            time.sleep(0.2)
        assert len([n for n in rt.nodes() if n["alive"]]) == 2

    def test_unpinned_actor_restarts_on_survivor(self, cluster):
        doomed = cluster.add_node(num_cpus=2, resources={"spot2": 1.0})
        cluster.wait_for_nodes()
        a = rt.remote(Pinned).options(
            num_cpus=1, max_restarts=2, max_task_retries=-1,
            scheduling_strategy=NodeAffinitySchedulingStrategy(node_id=doomed.node_id, soft=True),
        ).remote()
        assert rt.get(a.node.remote(), timeout=60) == doomed.node_id
        cluster.remove_node(doomed)
        assert rt.get(a.node.remote(), timeout=90) != doomed.node_id

    def test_store_file_cleanup_on_remove(self, cluster):
        n = cluster.add_node(num_cpus=1)
        cluster.wait_for_nodes()
        assert os.path.exists(n.store_path)
        cluster.remove_node(n)
        deadline = time.time() + 30
        while time.time() < deadline and os.path.exists(n.store_path):
            time.sleep(0.2)
        assert not os.path.exists(n.store_path)


def _card(t):
    time.sleep(t)
    return os.environ.get("CUDA_VISIBLE_DEVICES"), rt.get_runtime_context().node_id


def test_two_nodes_two_cards(by_value, monkeypatch):
    """Two declared cards on this host (no CUDA here): each GPU node gets
    its own, leases on the two nodes at once see disjoint cards, a third
    GPU node is refused, and a removed node's card goes to the next."""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    with runtime_defaults():
        os.environ["RT_GPU_COUNT_OVERRIDE"] = "2"
        c = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
        try:
            n1 = c.add_node(num_cpus=1, num_gpus=1)
            n2 = c.add_node(num_cpus=1, num_gpus=1)
            assert (n1.gpus, n2.gpus) == (["0"], ["1"])
            assert n1.resources == n2.resources == {"CPU": 1.0, "GPU": 1.0}
            with pytest.raises(ValueError, match="0 of its 2 card"):
                c.add_node(num_cpus=1, num_gpus=1)
            with pytest.raises(ValueError, match="ask for num_gpus"):
                c.add_node(num_cpus=1, num_tpus=1)
            c.connect()
            c.wait_for_nodes()
            assert rt.cluster_resources()["GPU"] == 2.0
            # both leases held at once: the two tasks overlap by 2 s
            got = rt.get([rt.remote(num_gpus=1, num_cpus=0)(_card).remote(2.0) for _ in range(2)],
                         timeout=120)
            assert sorted(got) == sorted([("0", n1.node_id), ("1", n2.node_id)])
            assert rt.get(rt.remote(num_gpus=0)(_card).remote(0), timeout=60)[0] == ""
            c.remove_node(n1)
            n3 = c.add_node(num_cpus=1, num_gpus=1)
            assert n3.gpus == ["0"]
            c.wait_for_nodes()
            got = rt.get([rt.remote(num_gpus=1, num_cpus=0)(_card).remote(1.0) for _ in range(2)],
                         timeout=120)
            assert sorted(got) == sorted([("0", n3.node_id), ("1", n2.node_id)])
        finally:
            rt.shutdown()
            c.shutdown()
            os.environ.pop("RT_GPU_COUNT_OVERRIDE", None)


def _hold(t):
    time.sleep(t)
    return os.getpid()


def _queued_lease_handover(monkeypatch, graceful, get_timeout):
    from ray_tpu_torch.util import events, state

    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    with runtime_defaults():
        os.environ["RT_GPU_COUNT_OVERRIDE"] = "1"
        c = Cluster(initialize_head=True, head_node_args={"num_cpus": 1})
        try:
            gpu = c.add_node(num_cpus=1, num_gpus=1)
            c.connect()
            c.wait_for_nodes()
            holder = rt.remote(num_gpus=1, max_retries=0)(_hold).remote(120.0)
            deadline = time.monotonic() + 60
            while state.summarize()["resources_available"].get("GPU", 0.0) and time.monotonic() < deadline:
                time.sleep(0.1)
            queued = rt.remote(num_gpus=1)(_card).remote(0)
            assert not rt.wait([queued], timeout=1.0)[0]
            c.remove_node(gpu, allow_graceful=graceful)
            with pytest.raises(rt.RayTpuError) as e:
                rt.get(holder, timeout=60)
            assert not isinstance(e.value, rt.GetTimeoutError)
            assert any(ev.get("node_id") == gpu.node_id and "node died" in ev["message"]
                       for ev in events.list_events())
            assert not rt.wait([queued], timeout=1.0)[0] and state.summarize()["pending_leases"] >= 1
            new = c.add_node(num_cpus=1, num_gpus=1)
            assert new.gpus == gpu.gpus == ["0"]
            assert rt.get(queued, timeout=get_timeout) == ("0", new.node_id)
        finally:
            rt.shutdown()
            c.shutdown()
            os.environ.pop("RT_GPU_COUNT_OVERRIDE", None)


def test_queued_gpu_lease_survives_a_hard_node_kill(by_value, monkeypatch):
    """[cluster]'s hand-over on the CPU, with one declared card: while a
    task holds the card a second GPU task queues; the node is killed hard
    (its death an event, the holder's error at get()); the queued task
    still pends, and runs on the next node given the same card."""
    _queued_lease_handover(monkeypatch, graceful=False, get_timeout=120)


def test_queued_gpu_lease_survives_a_graceful_node_removal(by_value, monkeypatch):
    """The same hand-over through a graceful removal (SIGTERM): the raylet
    tells the GCS it is leaving before it stops its workers, so the queued
    lease is not granted to the dying node and runs on the next one within
    the 60-s get().  The reference stops its workers first, and the GCS can
    grant the queued lease on the dying raylet, where it neither runs nor
    fails: its get() runs past 60 s (ROADMAP C4)."""
    _queued_lease_handover(monkeypatch, graceful=True, get_timeout=60)
