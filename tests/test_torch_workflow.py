"""The port's durable workflows (``ray_tpu_torch.workflow``) against the
JAX package's (``ray_tpu.workflow``), on the CPU.

Both runtimes run in this process, side by side (one module-scoped cluster
each, 4 CPUs).  Every case runs the same graph of the same functions in
both packages, each into a storage root of its own: the outputs must be
equal (exact), the step ids the same, the files on disk laid out alike
(``dag.pkl``, ``meta.json``, ``steps/<id>.pkl``) and the statuses equal.
Tensors reach the port's storage as CPU tensors, through the object
store's reduction (``common/serialization.py``), so that no device storage
is ever written.  Resume after a failure and ``run_async`` are in
``tests/test_zz_torch_workflow.py``.
"""

import json
import os
import pickle
import pickletools
import sys

import cloudpickle
import pytest
import torch

import ray_tpu
import ray_tpu.workflow as ref_wf
import ray_tpu_torch
import ray_tpu_torch.workflow as port_wf
from ray_tpu.workflow.dag import step_ids as ref_step_ids
from ray_tpu_torch.workflow import storage as port_storage
from ray_tpu_torch.workflow.dag import FunctionNode, step_ids
from test_torch_runtime import runtime_defaults

PACKAGES = {"ref": (ray_tpu, ref_wf), "port": (ray_tpu_torch, port_wf)}


def const(x):
    return x


def add(a, b):
    return a + b


def mul(a, b):
    return a * b


def lin(x, m=1, c=0):
    return x * m + c


def scale(t, k):
    return t * k


def diamond(rt):
    fns = {f.__name__: rt.remote(f) for f in (const, add, mul)}
    a = fns["const"].bind(2)
    return fns["add"].bind(fns["mul"].bind(a, 3), fns["mul"].bind(a, 5))


def kwargs_consts(rt):
    return rt.remote(lin).bind(rt.remote(const).bind(10), m=3, c=4)


@pytest.fixture(scope="module")
def clusters():
    module = sys.modules[__name__]
    cloudpickle.register_pickle_by_value(module)
    with runtime_defaults():
        ray_tpu.init(num_cpus=4, num_tpus=0, log_to_driver=False)
        try:
            ray_tpu_torch.init(num_cpus=4, log_to_driver=False)
            try:
                yield
            finally:
                ray_tpu_torch.shutdown()
        finally:
            ray_tpu.shutdown()
            cloudpickle.unregister_pickle_by_value(module)


def roots(tmp_path):
    return {name: str(tmp_path / name) for name in PACKAGES}


def layout(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_bind_gives_function_nodes():
    node = ray_tpu_torch.remote(num_gpus=1)(add).bind(1, b=2)
    assert isinstance(node, FunctionNode) and node.args == (1,) and node.kwargs == {"b": 2}
    assert node.name == "add" and node.remote_fn._opts == {"num_gpus": 1}


def test_step_ids_equal_the_reference():
    """The same graph shape gives the same ids: topo index + name."""
    for build in (diamond, kwargs_consts):
        ref, port = build(ray_tpu), build(ray_tpu_torch)
        assert [sid for sid, _ in step_ids(port)] == [sid for sid, _ in ref_step_ids(ref)]
    assert [sid for sid, _ in step_ids(diamond(ray_tpu_torch))] == [
        "0000_const", "0001_mul", "0002_mul", "0003_add"]


@pytest.mark.parametrize("build,want", [(diamond, 16), (kwargs_consts, 34)], ids=["diamond", "kwargs"])
def test_outputs_layout_and_meta_equal(clusters, tmp_path, build, want):
    root = roots(tmp_path)
    out, metas = {}, {}
    for name, (rt, wf) in PACKAGES.items():
        out[name] = wf.run(build(rt), workflow_id="w", storage=root[name])
        assert wf.get_status("w", storage=root[name]) == wf.SUCCEEDED
        assert wf.get_output("w", storage=root[name]) == out[name]
        with open(os.path.join(root[name], "w", "meta.json")) as f:
            metas[name] = json.load(f)
    assert out["port"] == out["ref"] == want
    assert layout(root["port"]) == layout(root["ref"])
    assert "w/dag.pkl" in layout(root["port"]) and "w/meta.json" in layout(root["port"])
    assert sorted(metas["port"]) == sorted(metas["ref"])
    assert metas["port"]["status"] == metas["ref"]["status"] == "SUCCEEDED"
    sids = [sid for sid, _ in step_ids(build(ray_tpu_torch))]
    assert port_storage.WorkflowStorage("w", root["port"]).completed_steps() == sorted(sids)


def test_failed_run_meta_equal(clusters, tmp_path):
    """A failing step: both record FAILED with the error, neither has the
    root's output, and a second run under the same id is refused."""
    root = roots(tmp_path)
    metas = {}
    for name, (rt, wf) in PACKAGES.items():
        bad = rt.remote(max_retries=0)(add).bind(rt.remote(const).bind(1), "not-a-number")
        with pytest.raises(Exception):
            wf.run(bad, workflow_id="bad", storage=root[name])
        with pytest.raises(wf.WorkflowError):
            wf.get_output("bad", storage=root[name])
        with pytest.raises(wf.WorkflowError, match="already exists"):
            wf.run(bad, workflow_id="bad", storage=root[name])
        with pytest.raises(wf.WorkflowNotFoundError):
            wf.get_status("nope", storage=root[name])
        with open(os.path.join(root[name], "bad", "meta.json")) as f:
            metas[name] = json.load(f)
    assert metas["port"]["status"] == metas["ref"]["status"] == "FAILED"
    assert sorted(metas["port"]) == sorted(metas["ref"])
    assert "TypeError" in metas["port"]["error"] and "TypeError" in metas["ref"]["error"]
    assert layout(root["port"]) == layout(root["ref"])


def test_list_and_delete(clusters, tmp_path):
    root = roots(tmp_path)
    ids = {}
    for name, (rt, wf) in PACKAGES.items():
        wf.run(rt.remote(const).bind(1), workflow_id="keep", storage=root[name])
        wf.run(rt.remote(const).bind(2), workflow_id="drop", storage=root[name])
        before = sorted(m["workflow_id"] for m in wf.list_all(storage=root[name]))
        wf.delete("drop", storage=root[name])
        ids[name] = (before, sorted(m["workflow_id"] for m in wf.list_all(storage=root[name])))
    assert ids["port"] == ids["ref"] == (["drop", "keep"], ["keep"])


def _tensor_devices(path):
    """Every tensor's device in a pickle file, and the restore functions
    it names."""
    with open(path, "rb") as f:
        data = f.read()
    found = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            found.append(x.device.type)
        elif isinstance(x, dict):
            [walk(v) for v in x.values()]
        elif isinstance(x, (list, tuple)):
            [walk(v) for v in x]
        elif isinstance(x, FunctionNode):
            [walk(v) for v in list(x.args) + list(x.kwargs.values())]

    walk(pickle.loads(data))
    names = [arg for op, arg, _ in pickletools.genops(data) if op.name in ("SHORT_BINUNICODE", "BINUNICODE")]
    return found, names


def test_tensors_stored_as_cpu_tensors(clusters, tmp_path):
    """Tensors bound into the DAG and returned by steps land in ``dag.pkl``
    and the step files through the store's tensor reduction (the path that
    copies a CUDA tensor to the host), and load back equal."""
    root = str(tmp_path / "port")
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    p = torch.nn.Parameter(torch.ones(3, 4))
    node = ray_tpu_torch.remote(scale).bind(ray_tpu_torch.remote(add).bind(t, p.detach()), 2.0)
    out = port_wf.run(node, workflow_id="t", storage=root)
    assert torch.equal(out, (t + 1) * 2)
    wdir = os.path.join(root, "t")
    for path in [os.path.join(wdir, "dag.pkl")] + [
            os.path.join(wdir, "steps", f) for f in sorted(os.listdir(os.path.join(wdir, "steps")))]:
        devices, names = _tensor_devices(path)
        assert devices and set(devices) == {"cpu"}, path
        assert "_restore_tensor" in names and "_rebuild_tensor_v2" not in names, path
    st = port_storage.WorkflowStorage("p", root)
    st.save_step("param", {"w": p})
    back = st.load_step("param")["w"]
    assert isinstance(back, torch.nn.Parameter) and back.requires_grad and torch.equal(back, p)
    assert "_restore_tensor" in _tensor_devices(st._step_path("param"))[1]
