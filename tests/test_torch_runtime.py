"""The port's single-node runtime (ray_tpu_torch.core and its copies of
common/, _native/ and util/) against the JAX package's, and on a cluster.

Parity needs no reference cluster: the serializer, the resource validation
and the config table are held against ``ray_tpu``'s directly.  The cluster
tests start one cluster for the module, ``init(num_cpus=2, num_gpus=2)``:
two GPUs are declared and none exists, so the lease seam is checked by the
``CUDA_VISIBLE_DEVICES`` each worker is given, not by a card.
"""

import contextlib
import itertools
import os
import pickle
import pickletools
import subprocess
import sys
import tempfile
import time

import cloudpickle
import jax
import ml_dtypes
import numpy as np
import psutil
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.common import config as ref_config
from ray_tpu.common import resources as ref_resources
from ray_tpu.common import serialization as ref_ser
from ray_tpu.models import gpt2 as jax_gpt2
from ray_tpu.parallel import mesh as jax_mesh
from ray_tpu_torch.common import config as port_config
from ray_tpu_torch.common.constants import session_root
from ray_tpu_torch.common import resources as port_resources
from ray_tpu_torch.common import serialization as port_ser
from ray_tpu_torch.core import api as port_api
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.models.convert import gpt2_params_from_jax

# Port-only env that would change what a cluster sees: cleared around each.
_GPU_ENV = ("CUDA_VISIBLE_DEVICES", "RT_GPU_VISIBLE_DEVICES", "RT_GPU_COUNT_OVERRIDE")


@pytest.fixture(scope="module", autouse=True)
def _no_jax_mesh():
    """The JAX package keeps a process-wide current mesh, which its own
    tests leave set in the worker that ran them; its flash attention then
    shards over that mesh.  The references here are single-device."""
    jax_mesh.set_current_mesh(None)


def _inherited_env():
    """The env this module's clusters do not inherit: the GPU variables,
    and every ``RT_*`` setting another test file left in this process.
    The port's config reads the same ``RT_*`` names as the reference's:
    the JAX package's ``bench.py``, which ``tests/test_taskplane_batching.py``
    imports, sets ``RT_MAX_TASKS_IN_FLIGHT_PER_WORKER=10`` for good, and a
    client so set pipelines a class's tasks onto one lease instead of
    asking for a lease a task."""
    return sorted({*_GPU_ENV, *(k for k in os.environ if k.startswith("RT_"))})


@contextlib.contextmanager
def runtime_defaults():
    """The port's config at its defaults while a cluster runs: the
    inherited env is removed and the driver's cached config values are
    dropped, before and after (then the env comes back)."""
    saved = {k: os.environ.pop(k) for k in _inherited_env() if k in os.environ}
    port_config.cfg.reset()
    try:
        yield
    finally:
        os.environ.update(saved)
        port_config.cfg.reset()


def _numpy_objects():
    rng = np.random.default_rng(0)
    return {
        "f32-oob": rng.standard_normal((256, 128)).astype(np.float32),
        "i32-small": rng.integers(0, 100, (7, 5), dtype=np.int32),
        "bf16-oob": rng.standard_normal((256, 256)).astype(ml_dtypes.bfloat16),
        "bf16-small": rng.standard_normal((4, 4)).astype(ml_dtypes.bfloat16),
        "nested": {"a": [rng.standard_normal(20000), b"x" * 70000], "b": ("s", 3)},
    }


def _ops(meta):
    """The meta pickle's opcodes and arguments, with the module path of a
    restore function taken relative to its package and frame lengths
    dropped: those are the only bytes a package rename changes."""
    out = []
    for op, arg, _ in pickletools.genops(bytes(meta)):
        if op.name == "FRAME":
            continue
        if isinstance(arg, str) and arg.startswith(("ray_tpu_torch.", "ray_tpu.")):
            arg = arg.split(".", 1)[1]
        out.append((op.name, arg))
    return out


@pytest.mark.parametrize("name", list(_numpy_objects()))
def test_serialization_matches_reference(name):
    obj = _numpy_objects()[name]
    port, ref = port_ser.serialize(obj), ref_ser.serialize(obj)
    if not name.startswith("bf16-oob"):
        assert bytes(port.meta) == bytes(ref.meta)
    assert _ops(port.meta) == _ops(ref.meta)
    assert [bytes(b) for b in port.buffers] == [bytes(b) for b in ref.buffers]
    back = port_ser.deserialize(port.to_bytes())
    assert pickle.dumps(back) == pickle.dumps(ref_ser.deserialize(ref.to_bytes()))


@pytest.mark.parametrize("case", ["bf16-4MiB", "f8-strided", "grad-small"])
def test_tensor_round_trip(case):
    """A 4 MiB bf16 CPU tensor travels out of band and comes back bit for
    bit; a non-contiguous float8 tensor is made contiguous first; a small
    tensor that requires grad travels in the meta and is a leaf again."""
    g = torch.Generator().manual_seed(0)
    if case == "bf16-4MiB":
        t = torch.randn(1024, 2048, generator=g).to(torch.bfloat16)
    elif case == "f8-strided":
        t = torch.randn(512, 512, generator=g).to(torch.float8_e4m3fn).t()
    else:
        t = torch.randn(8, 8, generator=g, requires_grad=True) * 2
    s = port_ser.serialize({"t": t})
    back = port_ser.deserialize(s.to_bytes())["t"]
    assert back.dtype == t.dtype and back.shape == t.shape and back.is_contiguous()
    assert torch.equal(back.detach().view(torch.uint8), t.detach().contiguous().view(torch.uint8))
    if case == "grad-small":
        assert not s.buffers and back.requires_grad and back.grad_fn is None
    else:
        assert [b.nbytes for b in s.buffers] == [t.numel() * t.element_size()]
        assert len(s.meta) < 1024


RESOURCE_TABLE = [
    {"CPU": 1}, {"GPU": 0.5}, {"GPU": 2}, {"GPU": 1.5}, {"TPU": 2.5},
    {"CPU": -1}, {"memory": 1e9, "custom": 0.25}, {"GPU": 0},
]


@pytest.mark.parametrize("res", RESOURCE_TABLE, ids=str)
def test_validate_task_resources_matches_reference(res):
    def verdict(mod):
        try:
            mod.validate_task_resources(res)
        except ValueError as e:
            return str(e)
        return "ok"

    assert verdict(port_resources) == verdict(ref_resources)


def test_config_defaults_match_reference():
    """Equal defaults, apart from the accelerator knobs (the TPU ones become
    ``gpu_count_override``) and the session root in path defaults: the
    reference's fixed /tmp/ray_tpu, the port's ray_tpu_torch in the temp
    dir."""
    renamed_ref = {"tpu_chips_override", "tpu_topology_override"}
    renamed_port = {"gpu_count_override"}
    root = session_root()
    assert root == os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
    ref = {k: d for k, (_, d) in ref_config._Config._DEFS.items() if k not in renamed_ref}
    port = {k: d for k, (_, d) in port_config._Config._DEFS.items() if k not in renamed_port}
    port = {k: d.replace(root, "/tmp/ray_tpu") if isinstance(d, str) else d
            for k, d in port.items()}
    assert port == ref
    assert port_config._Config._DEFS["gpu_count_override"] == (int, -1)
    assert renamed_ref <= set(ref_config._Config._DEFS)


def test_session_root_follows_tmpdir(tmp_path):
    """Every path the runtime writes outside its checkout lies in the temp
    dir the process was given: sessions, runtime-env extracts, workflows."""
    code = ("from ray_tpu_torch.core import node, runtime_env; "
            "from ray_tpu_torch.common.config import cfg; "
            "print(node.default_session_dir()); print(runtime_env._extract_dir('ab')); "
            "print(cfg.workflow_storage)")
    env = {**os.environ, "TMPDIR": str(tmp_path),
           "PYTHONPATH": port_api.node_mod._pythonpath_with_pkg()}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=60, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    paths = out.stdout.split()
    assert len(paths) == 3
    assert all(p.startswith(os.path.join(str(tmp_path), "ray_tpu_torch", "")) for p in paths), paths


def test_spill_file_round_trips_in_slices(monkeypatch, tmp_path):
    """The raylet writes a spill file and reads it back into the arena in
    slices, so that a transfer of many GB lets its event loop run; an
    object whose size ends inside, on and past a slice's edge comes back
    whole, and a truncated file fails and leaves no entry."""
    from ray_tpu_torch._native import store as port_store
    from ray_tpu_torch.core import raylet as port_raylet

    monkeypatch.setattr(port_raylet, "_IO_SLICE_BYTES", 1000)
    store = port_store.ShmStore(f"/dev/shm/rt_test_spill_{os.getpid()}", 64 << 20, create=True)
    try:
        rng = np.random.default_rng(0)
        for i, n in enumerate((1, 999, 1000, 2501, 4000)):
            data = rng.integers(0, 256, n, dtype=np.uint8)
            path = str(tmp_path / f"{i}.obj")
            port_raylet.Raylet._write_file(path, memoryview(data))
            oid = bytes([i + 1] * 16)
            assert port_raylet.Raylet._read_into_store(store, oid, path) == n
            pin = store.get(oid)
            try:
                assert bytes(pin.view) == data.tobytes()
            finally:
                pin.release()
        path = str(tmp_path / "short.obj")
        port_raylet.Raylet._write_file(path, b"x" * 2500)
        monkeypatch.setattr(os, "fstat", lambda fd, _f=os.fstat: os.stat_result(
            (*_f(fd)[:6], 3000, *_f(fd)[7:])))
        with pytest.raises(OSError, match="ends at 2500 of 3000"):
            port_raylet.Raylet._read_into_store(store, bytes([99] * 16), path)
        monkeypatch.undo()
        assert not store.contains(bytes([99] * 16))
    finally:
        store.destroy()


def _port_children():
    return [p for p in psutil.Process().children(recursive=True)
            if any("ray_tpu_torch" in a for a in _cmdline(p))]


def _cmdline(p):
    try:
        return p.cmdline()
    except psutil.Error:
        return []


def _no_port_children_left(timeout=10.0):
    deadline = time.monotonic() + timeout
    while _port_children() and time.monotonic() < deadline:
        time.sleep(0.1)
    return not _port_children()


@contextlib.contextmanager
def _functions_by_value():
    """Workers cannot import this test module: its functions travel by
    value while a cluster is up."""
    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    try:
        yield
    finally:
        cloudpickle.unregister_pickle_by_value(sys.modules[__name__])


@pytest.fixture
def gpu_env(monkeypatch):
    """The runtime's defaults (``runtime_defaults``) for a cluster's
    lifetime; the test sets the GPU env it wants through the monkeypatch."""
    with runtime_defaults():
        yield monkeypatch
        monkeypatch.undo()  # before the inherited env comes back


@pytest.fixture(scope="class")
def cluster():
    with runtime_defaults():
        rt.init(num_cpus=2, num_gpus=2, log_to_driver=False)
        with _functions_by_value():
            yield
        rt.shutdown()
        assert _no_port_children_left(), [_cmdline(p) for p in _port_children()]


def test_clusters_start_from_the_runtime_defaults(monkeypatch):
    """A pipelining setting left in the env by another file's imports (as
    bench.py leaves RT_MAX_TASKS_IN_FLIGHT_PER_WORKER=10) and already read
    into the driver's config does not reach a cluster of this module, and
    is back once the cluster is gone."""
    monkeypatch.setenv("RT_MAX_TASKS_IN_FLIGHT_PER_WORKER", "10")
    port_config.cfg.reset()
    assert port_config.cfg.max_tasks_in_flight_per_worker == 10
    with runtime_defaults():
        assert "RT_MAX_TASKS_IN_FLIGHT_PER_WORKER" not in os.environ
        assert port_config.cfg.max_tasks_in_flight_per_worker == 1
    assert os.environ["RT_MAX_TASKS_IN_FLIGHT_PER_WORKER"] == "10"
    monkeypatch.delenv("RT_MAX_TASKS_IN_FLIGHT_PER_WORKER")
    port_config.cfg.reset()


# The barrier's wait: long enough for any worker start under load, and
# inside the tests' 120-s get.
BARRIER_S = 90


def _hold(seconds, barrier=None, n=2):
    """Holds a lease for ``seconds``.  With a ``barrier`` dir, it first
    waits (BARRIER_S at most) until ``n`` worker processes have entered, so
    the leases that pass it were held at once, however slowly workers
    start.  Returns the cards, the times it started and ended, and whether
    it met the barrier."""
    t0 = time.time()
    met = True
    if barrier is not None:
        open(os.path.join(barrier, str(os.getpid())), "w").close()
        deadline = time.time() + BARRIER_S
        while len(os.listdir(barrier)) < n and time.time() < deadline:
            time.sleep(0.02)
        met = len(os.listdir(barrier)) >= n
    time.sleep(seconds)
    return os.environ.get("CUDA_VISIBLE_DEVICES"), t0, time.time(), met


def _check_leases(holds, n_cards):
    """What the raylet guarantees, whatever order the holds started in:
    holds whose (t0, t1) intervals overlap hold different cards, and never
    more holds overlap than the node has cards."""
    for a, b in itertools.combinations(holds, 2):
        if a[1] < b[2] and b[1] < a[2]:
            assert a[0] != b[0], (a, b)
    for a in holds:
        assert sum(b[1] <= a[1] < b[2] for b in holds) <= n_cards, holds


def _worker_facts():
    with open("/proc/self/cmdline", "rb") as f:
        argv = f.read().split(b"\0")
    foreign = sorted(m for m in sys.modules if m.split(".")[0] in ("ray_tpu", "jax"))
    return [a.decode() for a in argv if a], foreign, os.environ.get("CUDA_VISIBLE_DEVICES")


def _tiny_forward(state, tokens):
    import torch as th

    from ray_tpu_torch.models import gpt2 as port_gpt2

    cfg = port_gpt2.GPTConfig.tiny(attention_impl="flash")
    model = port_gpt2.GPT2(cfg, "cpu")
    model.load_state_dict(state)
    with th.inference_mode():
        return model(tokens)


@pytest.mark.usefixtures("cluster")
class TestOnCluster:
    def test_task_actor_and_error(self):
        @rt.remote
        def add(a, b):
            return a + b

        @rt.remote
        class Counter:
            def __init__(self, start):
                self.n = start

            def inc(self, by):
                self.n += by
                return self.n

        @rt.remote
        def boom():
            raise KeyError("missing")

        assert rt.get(add.remote(2, 3)) == 5
        c = Counter.remote(10)
        assert rt.get([c.inc.remote(1) for _ in range(3)]) == [11, 12, 13]
        with pytest.raises(rt.TaskError, match="KeyError"):
            rt.get(boom.remote())
        rt.kill(c)

    def test_put_get_tensor(self):
        t = torch.randn(1024, 2048, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
        ref = rt.put(t)
        assert torch.equal(rt.get(ref).view(torch.int16), t.view(torch.int16))

        @rt.remote
        def checksum(x):
            return x.float().sum().item(), x.dtype, tuple(x.shape)

        assert rt.get(checksum.remote(ref)) == (t.float().sum().item(), t.dtype, tuple(t.shape))

    def test_gpu_leases(self, tmp_path):
        """Two concurrent one-GPU leases see cards 0 and 1 (the barrier
        shows two were held at once); a third waits for a card (they ask for
        no CPU, so only cards limit them): no two held at once share a card
        and never three are held; a lease without GPUs sees none, and more
        GPUs than the node has fail at once as infeasible."""
        hold = rt.remote(num_gpus=1, num_cpus=0)(_hold)
        out = rt.get([hold.remote(1.0, str(tmp_path)) for _ in range(3)], timeout=120)
        assert all(r[3] for r in out), f"the barrier was not met: {out}"
        assert {r[0] for r in out} == {"0", "1"}, out
        _check_leases(out, 2)
        assert rt.get(rt.remote(num_gpus=0)(_hold).remote(0))[0] == ""
        with pytest.raises(rt.TaskError, match="infeasible"):
            rt.get(rt.remote(num_gpus=3)(_hold).remote(0), timeout=30)
        with pytest.raises(ValueError, match="no TPU"):
            rt.remote(num_tpus=1)(_hold).remote(0)

    def test_wait_timeout_zero_returns_resolved_refs(self):
        """``wait(refs, timeout=0)`` reports every ref already resolved (a
        put and a finished task's result) as ready, and a running one as
        not, as Ray does.  The reference's ``wait`` leaves on the spent
        deadline before it looks, and returns none of them ready
        (ROADMAP C5)."""
        done = rt.remote(_hold).remote(0)
        rt.get(done)
        put = rt.put({"resolved": True})
        running = rt.remote(_hold).remote(30)
        ready, not_ready = rt.wait([done, put, running], num_returns=3, timeout=0)
        assert ready == [done, put] and not_ready == [running]
        assert rt.wait([put, done], timeout=0) == ([put], [done])
        rt.cancel(running, force=True)

    def test_process_boundary(self):
        group = port_api._node_group
        assert group.session_dir.startswith(os.path.join(session_root(), "session_"))
        for proc, module in ((group.gcs_proc, "ray_tpu_torch.core.gcs"),
                             (group.raylet_proc, "ray_tpu_torch.core.raylet")):
            assert module in psutil.Process(proc.pid).cmdline()
            assert psutil.Process(proc.pid).environ().get("CUDA_VISIBLE_DEVICES") == ""
        facts = rt.remote(_worker_facts)
        for res in ({}, {"num_gpus": 1}):
            argv, foreign, _ = rt.get(facts.options(**res).remote())
            assert "ray_tpu_torch.core.worker_main" in argv
            assert foreign == []

    def test_gpt2_forward_in_worker(self):
        """The tiny GPT-2 (flash config, D = 16: the flash kernels' plain
        versions on the CPU) from the reference's seeded weights, in a
        worker and in the driver: the same bits."""
        cfg = gpt2.GPTConfig.tiny(attention_impl="flash")
        jcfg = jax_gpt2.GPTConfig.tiny(attention_impl="flash")
        params = jax.tree.map(np.asarray, jax_gpt2.init(jax.random.key(0), jcfg))
        model = gpt2_params_from_jax(params, cfg, device="cpu")
        tokens = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 128))).long()
        with torch.inference_mode():
            want = model(tokens)
        got = rt.get(rt.remote(_tiny_forward).remote(model.state_dict(), tokens))
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_leases_name_the_drivers_cards(gpu_env, tmp_path):
    """With the driver's CUDA_VISIBLE_DEVICES="3,5" and the override at 2,
    lease k is given the k-th card of that set; asking for more GPUs than
    the set names is refused before anything starts."""
    gpu_env.setenv("CUDA_VISIBLE_DEVICES", "3,5")
    gpu_env.setenv("RT_GPU_COUNT_OVERRIDE", "2")
    with pytest.raises(ValueError, match="names 2"):
        rt.init(num_cpus=1, num_gpus=3)
    assert not rt.is_initialized()
    rt.init(num_cpus=1, log_to_driver=False)
    try:
        assert rt.cluster_resources()["GPU"] == 2
        hold = rt.remote(num_gpus=1, num_cpus=0)(_hold)
        with _functions_by_value():
            seen = rt.get([hold.remote(0.5, str(tmp_path)) for _ in range(2)], timeout=120)
        assert all(r[3] for r in seen), f"the barrier was not met: {seen}"
        assert {r[0] for r in seen} == {"3", "5"}
        _check_leases(seen, 2)
    finally:
        rt.shutdown()
    assert _no_port_children_left()


_FAKE_TORCH = '''
import os

class cuda:
    calls = []

    @staticmethod
    def is_initialized():
        return False

    @staticmethod
    def is_available():
        return True

    @staticmethod
    def set_device(i):
        cuda.calls.append((i, os.environ["CUDA_VISIBLE_DEVICES"]))
'''


def test_worker_binds_leased_card_on_torch_import(tmp_path):
    """A GPU lease sets CUDA_VISIBLE_DEVICES before torch is imported, and
    card 0 of the set becomes the current device once it is (a stand-in
    torch records the call: the binding must not wait for a task to ask)."""
    (tmp_path / "torch").mkdir()
    (tmp_path / "torch" / "__init__.py").write_text(_FAKE_TORCH)
    code = ("import sys; from ray_tpu_torch.core import worker_main as wm; "
            "wm._bind_cuda({'CUDA_VISIBLE_DEVICES': '5'}); assert 'torch' not in sys.modules; "
            "import torch; print(torch.cuda.calls)")
    env = {**os.environ, "PYTHONPATH": f"{tmp_path}{os.pathsep}{port_api.node_mod._pythonpath_with_pkg()}"}
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[(0, '5')]"


def test_worker_refuses_a_second_card_set(monkeypatch):
    """Where CUDA already initialised under one set, binding to another
    raises instead of running on the wrong card; the same set binds."""
    from types import SimpleNamespace

    from ray_tpu_torch.core import worker_main

    calls = []
    fake = SimpleNamespace(cuda=SimpleNamespace(
        is_initialized=lambda: True, is_available=lambda: True, set_device=calls.append))
    monkeypatch.setitem(sys.modules, "torch", fake)
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    with pytest.raises(RuntimeError, match="already initialised"):
        worker_main._bind_cuda({"CUDA_VISIBLE_DEVICES": "1"})
    assert os.environ["CUDA_VISIBLE_DEVICES"] == "0" and calls == []
    worker_main._bind_cuda({"CUDA_VISIBLE_DEVICES": "0"})
    assert calls == [0]
