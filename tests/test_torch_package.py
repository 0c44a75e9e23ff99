"""Boundaries of the PyTorch/CUDA port (ray_tpu_torch): it imports nothing
of JAX or of the JAX package, and its entry points do not fall back to the
CPU when no CUDA device is present."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "ray_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py", REPO / "step_probe.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "ray_tpu")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


# A module path of the reference inside a string: ``"-m", "ray_tpu.core.gcs"``
# would start the reference's processes, which no import walk sees.
_REFERENCE_MODULE = re.compile(r"(?<![\w/.])ray_tpu\.[A-Za-z_]")


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_reference_module_strings(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [
        (node.lineno, node.value[:80])
        for node in ast.walk(tree)
        if isinstance(node, ast.Constant) and isinstance(node.value, str)
        and _REFERENCE_MODULE.search(node.value)
    ]
    assert not bad, f"{path.name} names reference modules in strings: {bad}"


# Not the control plane: the LLM engine, and the NCCL gang backend, which is
# loaded only by a group that asks for it, in a process of a torch gang.
DATA_PLANE = ("ray_tpu_torch/serve/llm.py", "ray_tpu_torch/util/collective/nccl_backend.py")
CONTROL_PLANE = sorted(
    p for d in ("common", "_native", "accelerators", "util/collective", "serve", "serve/traffic", "autoscaler")
    for p in (REPO / "ray_tpu_torch" / d).glob("*.py")
    if p.relative_to(REPO).as_posix() not in DATA_PLANE
) + [REPO / "ray_tpu_torch" / "core" / f for f in ("gcs.py", "raylet.py", "node.py")] + [
    REPO / "ray_tpu_torch" / f for f in ("scripts.py", "__main__.py", "_version.py", "job_submission.py",
                                         "dashboard.py")]


@pytest.mark.parametrize("path", CONTROL_PLANE, ids=lambda p: str(p.relative_to(REPO)))
def test_control_plane_imports_no_torch(path):
    """The GCS, the raylet, the runtime collectives, the serve control
    plane (controller, proxies, handles, replicas; all of serve but the LLM
    engine's ``llm.py``) and what they import stay free of torch at every
    level, function bodies included: torch enters a process only through
    user code, the serializer's ``sys.modules`` lookup and a worker's GPU
    binding."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in names if m.split(".")[0] in ("torch", "jax", "jaxlib")]


def test_control_plane_import_loads_no_torch_or_jax():
    code = ("import sys, ray_tpu_torch, ray_tpu_torch.core.gcs, ray_tpu_torch.core.raylet; "
            "print(sorted(m for m in ('torch', 'jax') if m in sys.modules))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_serve_and_collective_import_loads_no_torch_or_jax():
    """Serve's control actors run on leases without a card: importing the
    serve package and the runtime collectives must not load torch."""
    code = ("import sys, ray_tpu_torch.serve, ray_tpu_torch.serve.controller, "
            "ray_tpu_torch.serve.proxy, ray_tpu_torch.serve.grpc_proxy, "
            "ray_tpu_torch.util.collective, ray_tpu_torch.util.collective.rpc_backend; "
            "print(sorted(m for m in ('torch', 'jax', 'aiohttp', 'grpc') if m in sys.modules))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_train_import_loads_no_torch_or_jax():
    """The Train library's driver side (trainer, executor, worker group,
    session, checkpoint handle, configs) needs no torch: a worker loads it
    with the loop it runs, the backend's process group and a state-dict
    checkpoint inside the functions that use them."""
    code = ("import sys, ray_tpu_torch.train, ray_tpu_torch.train.backend_executor; "
            "print(sorted(m for m in ('torch', 'jax') if m in sys.modules))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_pipeline_schedule_is_torch_free():
    """The 1F1B schedule is pure Python, as the reference's: it imports
    nothing at any level but the standard library, and importing the
    pipeline package and its schedule loads no torch (the package loads
    its other modules when a name of theirs is read)."""
    path = REPO / "ray_tpu_torch" / "train" / "pipeline" / "schedule.py"
    tree = ast.parse(path.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert names == ["__future__", "typing"]
    code = ("import sys, ray_tpu_torch.train.pipeline as p, ray_tpu_torch.train.pipeline.schedule; "
            "assert p.stage_ops(0, 2, 2) == [('F', 0), ('F', 1), ('B', 0), ('B', 1)]; "
            "print(sorted(m for m in ('torch', 'jax') if m in sys.modules))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_tune_import_loads_no_torch_or_jax():
    """The Tune library (searchers, schedulers, the controller, the Tuner)
    needs no torch in the driver or in a trial actor: a trial's loop, or
    the nested trainer's worker, loads it."""
    code = ("import sys, ray_tpu_torch.tune, ray_tpu_torch.tune.tune_controller; "
            "print(sorted(m for m in ('torch', 'jax') if m in sys.modules))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_rllib_import_loads_no_jax_or_reference():
    """The RLlib port and its model catalog load neither JAX nor any module
    of the JAX package (the catalog registers the CNN family into the
    port's ``rllib.core``)."""
    code = ("import sys, ray_tpu_torch.rllib, ray_tpu_torch.models.catalog; "
            "from ray_tpu_torch.rllib import core; from ray_tpu_torch.models import catalog; "
            "assert core.MODULE_FAMILIES[catalog.CNNModuleConfig] is catalog.cnn_init; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'ray_tpu')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_data_import_loads_no_torch_or_jax():
    """The Data library's blocks are Arrow tables: importing it (and the
    stats actor's module, which every stage task loads) loads pyarrow and
    neither torch nor JAX; iter_torch_batches and iter_device_batches load
    torch in the process that reads them."""
    code = ("import sys, ray_tpu_torch.data, ray_tpu_torch.data.stats; "
            "print(sorted(m for m in ('torch', 'jax', 'pandas') if m in sys.modules))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_podracer_import_loads_no_jax_or_reference():
    code = ("import sys, ray_tpu_torch.rllib.podracer; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'ray_tpu')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_dag_workflow_state_cluster_import_loads_no_torch_or_jax():
    """Compiled DAGs, workflows, events, the state API and the Cluster
    harness are control-plane code: importing them loads neither torch nor
    JAX (a workflow's storage reduces tensors through the serializer's
    ``sys.modules`` lookup; the queue's and the client's modules load the
    runtime's API, which is torch-free too)."""
    code = ("import sys, ray_tpu_torch.dag, ray_tpu_torch.workflow, ray_tpu_torch.util.events, "
            "ray_tpu_torch.util.state, ray_tpu_torch.util.queue, ray_tpu_torch.util.client, "
            "ray_tpu_torch.cluster_utils; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'ray_tpu')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_operator_surface_import_loads_no_torch_or_jax():
    """The CLI, job submission, the dashboard and the autoscaler are
    control-plane code: importing them loads neither torch nor JAX nor any
    module of the JAX package, and neither the dashboard's aiohttp nor the
    launcher's PyYAML, which the functions that serve or read load."""
    code = ("import sys, ray_tpu_torch.scripts, ray_tpu_torch.job_submission, ray_tpu_torch.dashboard, "
            "ray_tpu_torch.autoscaler, ray_tpu_torch.autoscaler.launcher, "
            "ray_tpu_torch.autoscaler.k8s_provider, ray_tpu_torch._version; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'jaxlib', 'ray_tpu', 'aiohttp', 'yaml')))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_bind_returns_dag_and_workflow_nodes():
    """``ActorMethod.bind`` gives a compiled-DAG node and
    ``RemoteFunction.bind`` a workflow node, with no runtime started; the
    bound options travel with the node."""
    import ray_tpu_torch
    from ray_tpu_torch.common.ids import ActorID
    from ray_tpu_torch.core.actor import ActorHandle
    from ray_tpu_torch.dag.compiled_dag import ClassMethodNode, InputNode
    from ray_tpu_torch.workflow.dag import FunctionNode

    handle = ActorHandle(ActorID.random())
    with InputNode() as inp:
        node = handle.forward.bind(inp, 3)
    assert isinstance(node, ClassMethodNode) and node.actor is handle
    assert node.method_name == "forward" and node.args == (inp, 3)
    fn = ray_tpu_torch.remote(num_gpus=1)(len)
    step = fn.bind([1, 2], key="k")
    assert isinstance(step, FunctionNode) and step.remote_fn is fn
    assert step.args == ([1, 2],) and step.kwargs == {"key": "k"} and fn._opts["num_gpus"] == 1


def test_port_files_found():
    names = {p.name for p in PORT_FILES}
    assert {"gpt2.py", "llama.py", "llm.py", "flash_attention.py", "chip_smoke.py",
            "vit.py"} <= names
    train = {p.name for p in (REPO / "ray_tpu_torch" / "train").glob("*.py")}
    assert {"__init__.py", "config.py", "checkpoint.py", "session.py", "backend.py",
            "worker_group.py", "backend_executor.py", "trainer.py"} <= train
    tune = {p.relative_to(REPO).as_posix() for p in PORT_FILES if p.parent.name == "tune"}
    assert tune == {f"ray_tpu_torch/tune/{n}.py" for n in
                    ("__init__", "search", "schedulers", "tune_controller", "tuner")}
    runtime = {"api.py", "gcs.py", "raylet.py", "worker_main.py", "node.py", "runtime.py",
               "serialization.py", "config.py", "resources.py", "store.py", "gpu.py",
               "placement_group.py", "actor_pool.py"}
    assert runtime <= names
    pipeline = {p.relative_to(REPO).as_posix() for p in PORT_FILES if p.parent.name == "pipeline"}
    assert pipeline == {f"ray_tpu_torch/train/pipeline/{n}.py" for n in
                        ("__init__", "schedule", "partition", "stage", "driver")}
    assert {"pp.py", "pipeline.py"} <= names
    rllib = {p.relative_to(REPO).as_posix() for p in PORT_FILES if p.parent.name == "rllib"}
    assert rllib == {f"ray_tpu_torch/rllib/{n}.py" for n in
                     ("__init__", "core", "connectors", "learner_group", "algorithm", "env_runner", "ppo",
                      "dqn", "impala", "appo", "sac", "multi_agent", "offline", "cql", "marwil")}
    assert (REPO / "ray_tpu_torch" / "models" / "catalog.py") in PORT_FILES
    podracer = {p.relative_to(REPO).as_posix() for p in PORT_FILES if p.parent.name == "podracer"}
    assert podracer == {f"ray_tpu_torch/rllib/podracer/{n}.py" for n in ("__init__", "fragment", "learner", "runner")}
    data = {p.relative_to(REPO).as_posix() for p in PORT_FILES if p.parent.name == "data"}
    assert data == {f"ray_tpu_torch/data/{n}.py" for n in
                    ("__init__", "block", "datasource", "stats", "dataset", "read_api")}
    slice14 = {"ray_tpu_torch/dag/__init__.py", "ray_tpu_torch/dag/channel.py",
               "ray_tpu_torch/dag/compiled_dag.py", "ray_tpu_torch/workflow/__init__.py",
               "ray_tpu_torch/workflow/api.py", "ray_tpu_torch/workflow/dag.py",
               "ray_tpu_torch/workflow/storage.py", "ray_tpu_torch/util/events.py",
               "ray_tpu_torch/util/state.py", "ray_tpu_torch/util/queue.py",
               "ray_tpu_torch/util/client.py", "ray_tpu_torch/cluster_utils.py"}
    assert slice14 <= {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    operator = {f"ray_tpu_torch/{n}.py" for n in ("scripts", "__main__", "_version", "job_submission",
                                                   "dashboard")}
    autoscaler = {p.relative_to(REPO).as_posix() for p in PORT_FILES if p.parent.name == "autoscaler"}
    assert operator <= {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    assert autoscaler == {f"ray_tpu_torch/autoscaler/{n}.py" for n in
                          ("__init__", "autoscaler", "node_provider", "launcher", "k8s_provider")}
    serving = {"controller.py", "handle.py", "proxy.py", "replica.py", "weights.py",
               "admission.py", "scheduler.py", "collective.py", "rpc_backend.py",
               "quantize.py", "quant.py"}
    assert serving <= names
    assert not (REPO / "ray_tpu_torch" / "util" / "collective" / "jax_backend.py").exists()
    assert (REPO / "ray_tpu_torch" / "_native" / "shm_store.cc").is_file()
    assert (REPO / "ray_tpu_torch" / "_native" / "quant.cc").is_file()
    assert not list((REPO / "ray_tpu_torch" / "_native").glob("*.so"))


def test_entry_raises_without_cuda():
    from ray_tpu_torch.entry import entry

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_model_constructors_default_to_cuda():
    from ray_tpu_torch.models import gpt2, llama
    from ray_tpu_torch.serve.llm import LLMEngine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gpt2.init(gpt2.GPTConfig.tiny())
    assert gpt2.init(gpt2.GPTConfig.tiny(), device="cpu").wte.device.type == "cpu"
    cfg = llama.LlamaConfig.tiny()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        llama.init_cache(cfg, 2, 16)
    model = llama.init(cfg, device="cpu")
    assert llama.init_cache(cfg, 2, 16, device="cpu")["k"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LLMEngine(model)
    assert LLMEngine(model, device="cpu").cache["v"].device.type == "cpu"


def test_library_path_hashes_headers(tmp_path):
    """An edited csrc header gives the library another name, so a source
    that includes it is rebuilt instead of a stale library being loaded."""
    import shutil

    from ray_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    assert sorted(csrc.glob("*.cuh")), "csrc/ has no header to edit"
    before = {n: _build.library_path(n, csrc) for n in _build.all_sources()}
    assert before == {n: _build.library_path(n) for n in before}
    header = sorted(csrc.glob("*.cuh"))[0]
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n, csrc) for n in before}
    assert all(after[n] != before[n] for n in before)
