"""The port's compiled DAGs at length, on the CPU: the JAX package's
throughput and pipelined-in-flight tests (``tests/test_dag.py``) on the
port's runtime, and a stage actor's death while its DAG runs.

Marked ``slow`` (past the tier-1 window, ``test_zz_*``): the throughput
test times 3 x 200 iterations of each path, and the death waits on the
loop's liveness check.  The parity cases are in ``tests/test_torch_dag.py``.
"""

import os
import sys
import time

import cloudpickle
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.dag import InputNode
from test_torch_runtime import runtime_defaults

pytestmark = pytest.mark.slow


class Adder:
    def __init__(self, delta):
        self.delta = delta

    def add(self, x):
        return x + self.delta

    def slow_add(self, x):
        time.sleep(0.05)
        return x + self.delta

    def pid(self):
        return os.getpid()


@pytest.fixture(scope="module")
def cluster():
    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    with runtime_defaults():
        rt.init(num_cpus=4, log_to_driver=False)
        try:
            yield rt.remote(num_cpus=0.5)(Adder)
        finally:
            rt.shutdown()
            cloudpickle.unregister_pickle_by_value(module)


def test_pipelined_inflight(cluster):
    """Four executions in flight through two 50 ms stages: each stage works
    on its own item at once, so the four finish in well under the 400 ms
    that one after another would take, and in order."""
    a, b = cluster.remote(1), cluster.remote(10)
    with InputNode() as inp:
        dag = b.slow_add.bind(a.slow_add.bind(inp)).experimental_compile()
    try:
        dag.execute(0).get(timeout=60)
        t0 = time.perf_counter()
        refs = [dag.execute(i) for i in range(4)]
        assert [r.get(timeout=60) for r in refs] == [i + 11 for i in range(4)]
        assert time.perf_counter() - t0 < 0.4
    finally:
        dag.teardown()


def test_throughput_beats_actor_calls(cluster):
    """Channel round trips keep pace with task submission (the JAX
    package's bound: within 2.5x of the actor call, median of 3 blocks of
    200 iterations each)."""
    a = cluster.remote(0)
    rt.get(a.add.remote(0), timeout=60)
    with InputNode() as inp:
        dag = a.add.bind(inp).experimental_compile()
    n, dag_ts = 200, []
    try:
        dag.execute(0).get(timeout=60)
        for _ in range(3):
            t0 = time.perf_counter()
            for i in range(n):
                dag.execute(i).get(timeout=60)
            dag_ts.append(time.perf_counter() - t0)
    finally:
        dag.teardown()
    call_ts = []
    rt.get(a.add.remote(0), timeout=60)
    for _ in range(3):
        t0 = time.perf_counter()
        for i in range(n):
            rt.get(a.add.remote(i), timeout=60)
        call_ts.append(time.perf_counter() - t0)
    assert sorted(dag_ts)[1] < sorted(call_ts)[1] * 2.5, (dag_ts, call_ts)


def test_stage_actor_death_reaches_get(cluster):
    """The second stage's actor dies while the DAG runs: get() raises the
    loop's error through the liveness check (the JAX package's check never
    fires, and its get() would wait out its timeout), and teardown still
    ends the surviving loop and frees its actor."""
    a, b = cluster.remote(1), cluster.remote(10)
    with InputNode() as inp:
        dag = b.add.bind(a.add.bind(inp)).experimental_compile()
    assert dag.execute(1).get(timeout=60) == 12
    rt.kill(b)
    t0 = time.perf_counter()
    with pytest.raises(rt.ActorDiedError, match="died while running __rt_apply__"):
        dag.execute(2).get(timeout=60)
    assert time.perf_counter() - t0 < 30
    dag.teardown(timeout=10)
    assert rt.get(a.add.remote(5), timeout=60) == 6
