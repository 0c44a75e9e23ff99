"""The port's durable workflows at length, on the CPU: resume after a
failure and ``run_async`` (the JAX package's ``tests/test_workflow.py``
cases), each against the reference's outcome on the same graph.

Marked ``slow`` (past the tier-1 window, ``test_zz_*``): the failing
graph runs twice in each package.  The parity cases are in
``tests/test_torch_workflow.py``.
"""

import os
import sys

import cloudpickle
import pytest

import ray_tpu
import ray_tpu.workflow as ref_wf
import ray_tpu_torch
import ray_tpu_torch.workflow as port_wf
from test_torch_runtime import runtime_defaults

pytestmark = pytest.mark.slow

PACKAGES = {"ref": (ray_tpu, ref_wf), "port": (ray_tpu_torch, port_wf)}


def const(x):
    return x


def add(a, b):
    return a + b


def counted(tag, x, markers):
    """Counts its runs in a marker file."""
    path = os.path.join(markers, tag)
    n = int(open(path).read()) if os.path.exists(path) else 0
    with open(path, "w") as f:
        f.write(str(n + 1))
    return x


def flaky(x, markers):
    """Fails on its first run."""
    flag = os.path.join(markers, "flaky_ok")
    if not os.path.exists(flag):
        with open(flag, "w") as f:
            f.write("armed")
        raise RuntimeError("first attempt dies")
    return x + 100


@pytest.fixture(scope="module")
def clusters():
    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    with runtime_defaults():
        ray_tpu.init(num_cpus=4, num_tpus=0, log_to_driver=False)
        try:
            # one declared card (none is here): GPU steps lease it in turn
            ray_tpu_torch.init(num_cpus=4, num_gpus=1, log_to_driver=False)
            try:
                yield
            finally:
                ray_tpu_torch.shutdown()
        finally:
            ray_tpu.shutdown()
            cloudpickle.unregister_pickle_by_value(module)


def gather(*xs):
    return list(xs)


def card_window(x, t):
    """A GPU step: the card it was given and when it held it."""
    import time

    t0 = time.time()
    time.sleep(t)
    return os.environ.get("CUDA_VISIBLE_DEVICES"), t0, time.time(), x


def test_gpu_steps_of_one_wave_queue_on_the_card(clusters, tmp_path):
    """Two num_gpus=1 steps in one wave: the raylet gives the one card to
    one lease at a time, so they run one after the other, both on card 0,
    and a CPU step sees no card."""
    step = ray_tpu_torch.remote(num_gpus=1, num_cpus=0)(card_window)
    cpu = ray_tpu_torch.remote(num_gpus=0)(card_window)
    root = ray_tpu_torch.remote(gather).bind(step.bind(1, 1.0), step.bind(2, 1.0), cpu.bind(3, 0.0))
    (c1, s1, e1, x1), (c2, s2, e2, x2), (c3, *_, x3) = port_wf.run(root, storage=str(tmp_path))
    assert (c1, c2, c3, x1, x2, x3) == ("0", "0", "", 1, 2, 3)
    assert e1 <= s2 or e2 <= s1, "two one-GPU steps held the one card at once"


def test_resume_skips_completed_steps(clusters, tmp_path):
    """A step fails on the first run; resume reruns only that step, in both
    packages, with the same statuses, output and checkpointed steps."""
    got = {}
    for name, (rt, wf) in PACKAGES.items():
        markers, root = str(tmp_path / name / "markers"), str(tmp_path / name / "wfs")
        os.makedirs(markers)
        a = rt.remote(max_retries=0)(counted).bind("a", 7, markers)
        root_node = rt.remote(max_retries=0)(flaky).bind(a, markers)
        with pytest.raises(Exception, match="first attempt dies"):
            wf.run(root_node, workflow_id="flaky-wf", storage=root)
        status = wf.get_status("flaky-wf", storage=root)
        out = wf.resume("flaky-wf", storage=root)
        steps = sorted(os.listdir(os.path.join(root, "flaky-wf", "steps")))
        got[name] = (status, out, open(os.path.join(markers, "a")).read(), steps,
                     wf.get_status("flaky-wf", storage=root), wf.get_output("flaky-wf", storage=root))
    assert got["port"] == got["ref"] == (
        "FAILED", 107, "1", ["0000_counted.pkl", "0001_flaky.pkl"], "SUCCEEDED", 107)


def test_run_async(clusters, tmp_path):
    got = {}
    for name, (rt, wf) in PACKAGES.items():
        fut = wf.run_async(rt.remote(add).bind(rt.remote(const).bind(1), rt.remote(const).bind(2)),
                           workflow_id="async", storage=str(tmp_path / name))
        got[name] = (fut.workflow_id, fut.result(timeout=120),
                     wf.get_status("async", storage=str(tmp_path / name)))
    assert got["port"] == got["ref"] == ("async", 3, "SUCCEEDED")
