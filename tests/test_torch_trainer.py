"""The port's Train library (ray_tpu_torch.train) on its runtime, on the CPU.

The trainer's tests share one cluster for the module, ``init(num_cpus=4,
num_gpus=2)``: two GPUs are declared and none exists, so a ``use_gpu``
worker is given a card index through ``CUDA_VISIBLE_DEVICES``, finds no
CUDA device, and fails to form its process group (NCCL does not become
gloo); workers leased no GPU form theirs over gloo.  The loops and their
helpers travel to the workers by value (workers cannot import a test
module).

The fit is held against the JAX package: a one-worker ``TorchTrainer``
trains the tiny GPT-2 (dense attention, f32 compute) from the reference's
numpy-drawn weights, and every loss it reports must equal, within the
training parity tests' f32 tolerance (1e-5 absolute; grad norms 1e-5
relative; ``tests/test_torch_train.py``), the loss of the reference's
``spmd.compile_train_step`` with ``optax.adamw`` run in process from the
same weights and batch.  The gang restart and the cases that start several
gangs are in ``tests/test_zz_torch_trainer.py``.
"""

import contextlib
import os
import sys

import cloudpickle
import jax
import numpy as np
import optax
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.models import gpt2 as jax_gpt2
from ray_tpu.parallel import spmd as jax_spmd
from ray_tpu_torch import train
from ray_tpu_torch.models import gpt2
from ray_tpu_torch.models.convert import gpt2_params_from_jax
from ray_tpu_torch.parallel import spmd
from ray_tpu_torch.train.backend_executor import TrainWorkerGroupError
from ray_tpu_torch.train.worker_group import WorkerGroup

# Port-only env that would change what a cluster sees: cleared around it.
_GPU_ENV = ("CUDA_VISIBLE_DEVICES", "RT_GPU_VISIBLE_DEVICES", "RT_GPU_COUNT_OVERRIDE")
LOSS_TOL = 1e-5  # tests/test_torch_train.py TOL[torch.float32]["loss"]
NORM_RTOL = 1e-5  # the same file's grad-norm tolerance against optax
FIT_STEPS = 4


@contextlib.contextmanager
def functions_by_value(module):
    """Workers cannot import a test module: its functions travel by value
    while a cluster is up."""
    cloudpickle.register_pickle_by_value(module)
    try:
        yield
    finally:
        cloudpickle.unregister_pickle_by_value(module)


@contextlib.contextmanager
def port_cluster(module):
    saved = {k: os.environ.pop(k) for k in _GPU_ENV if k in os.environ}
    try:
        rt.init(num_cpus=4, num_gpus=2, log_to_driver=False)
        try:
            with functions_by_value(module):
                yield
        finally:
            rt.shutdown()
    finally:
        os.environ.update(saved)


@pytest.fixture(scope="module")
def cluster():
    with port_cluster(sys.modules[__name__]):
        yield


def draw_params():
    """The tiny GPT-2's weights in the reference's pytree, drawn with numpy
    (norms near 1, biases near 0, all perturbed)."""
    shapes = jax.eval_shape(lambda: jax_gpt2.init(jax.random.key(0), jax_gpt2.GPTConfig.tiny()))
    rng = np.random.default_rng(0)

    def draw(path, s):
        base = 1.0 if "scale" in jax.tree_util.keystr(path) else 0.0
        return (base + rng.standard_normal(s.shape) * 0.02).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def draw_tokens():
    return np.random.default_rng(1).integers(0, 256, (2, 129), dtype=np.int32)


def loop_config(np_params, tokens, steps, **kw):
    """The GPT-2 loop's config: the converted weights as a CPU state dict,
    the batch, the step count; ``ckpt_at`` (a step after which a
    checkpoint is reported) and ``die_after`` (the last step the driver
    is sure to have from a first attempt that kills its own process) are
    optional."""
    cfg = gpt2.GPTConfig.tiny(dtype=torch.float32)
    state = gpt2_params_from_jax(np_params, cfg, device="cpu").state_dict()
    return {"cfg": cfg, "state": state, "tokens": torch.from_numpy(tokens).long(),
            "steps": steps, **kw}


def gpt2_loop(config):
    """Trains the tiny GPT-2 with ``adamw(3e-4, weight_decay=0.1)``, one
    report a step; resumes from the session's checkpoint (model, optimizer
    and step) where there is one.  With ``die_after``, the first attempt
    kills its own process once the report of the step after it returns:
    the driver asks for that report only after it has received the one of
    ``die_after``, which so cannot die with the process; the later report
    may or may not reach the driver."""
    from ray_tpu_torch import train as tr
    from ray_tpu_torch.models import gpt2 as port_gpt2
    from ray_tpu_torch.parallel import spmd as port_spmd

    model = port_gpt2.GPT2(config["cfg"], "cpu")
    model.load_state_dict(config["state"])
    opt = port_spmd.adamw(model.parameters(), 3e-4, weight_decay=0.1)
    start = 0
    ckpt = tr.get_checkpoint()
    if ckpt is not None:
        saved = ckpt.to_state_dict()
        model.load_state_dict(saved["model"])
        opt.load_state_dict(saved["optim"])
        start = saved["step"] + 1
    step = port_spmd.compile_train_step(port_gpt2.loss_fn, opt)
    state = port_spmd.TrainState(start, model)
    batch = {"tokens": config["tokens"]}
    for i in range(start, config["steps"]):
        state, metrics = step(state, batch)
        ckpt = None
        if i == config.get("ckpt_at") or config.get("ckpt_every"):
            ckpt = tr.Checkpoint.from_state_dict(
                {"model": model.state_dict(), "optim": opt.state_dict(), "step": i})
        tr.report({"step": i, "loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"]), "pid": os.getpid()},
                  checkpoint=ckpt)
        marker = os.path.join(tr.get_context().get_trial_dir(), "killed")
        if "die_after" in config and i == config["die_after"] + 1 and not os.path.exists(marker):
            open(marker, "w").close()
            os._exit(1)
    return state.step


def jax_losses(np_params, tokens, steps):
    """The reference's losses and grad norms: ``spmd.compile_train_step``
    with ``optax.adamw(3e-4, weight_decay=0.1)``, in process."""
    jcfg = jax_gpt2.GPTConfig.tiny(dtype=jax.numpy.float32)
    opt = optax.adamw(3e-4, weight_decay=0.1)
    step = jax_spmd.compile_train_step(lambda p, b: jax_gpt2.loss_fn(p, b, jcfg), opt, donate=False)
    state = jax_spmd.TrainState(0, jax.tree.map(np.asarray, np_params), opt.init(np_params))
    losses, norms = [], []
    for _ in range(steps):
        state, m = step(state, {"tokens": tokens})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return losses, norms


def run_config(tmp_path, name, **kw):
    return train.RunConfig(name=name, storage_path=str(tmp_path), **kw)


@pytest.mark.usefixtures("cluster")
class TestOnCluster:
    def test_fit_matches_jax_train_step(self, tmp_path):
        """The whole slice on the CPU: a one-worker TorchTrainer fits the
        tiny GPT-2 from JAX-converted weights; every reported loss and grad
        norm is the reference's train step's."""
        np_params, tokens = draw_params(), draw_tokens()
        result = train.TorchTrainer(
            gpt2_loop,
            train_loop_config=loop_config(np_params, tokens, FIT_STEPS, ckpt_at=FIT_STEPS - 1),
            run_config=run_config(tmp_path, "fit"),
        ).fit()
        assert result.error is None
        hist = result.metrics_dataframe
        assert [m["step"] for m in hist] == list(range(FIT_STEPS))
        ref_losses, ref_norms = jax_losses(np_params, tokens, FIT_STEPS)
        np.testing.assert_allclose([m["loss"] for m in hist], ref_losses, rtol=0, atol=LOSS_TOL)
        np.testing.assert_allclose([m["grad_norm"] for m in hist], ref_norms, rtol=NORM_RTOL)
        assert hist[-1]["loss"] < hist[0]["loss"]
        saved = result.checkpoint.to_state_dict()
        assert saved["step"] == FIT_STEPS - 1
        assert os.path.dirname(result.checkpoint.path) == result.path == str(tmp_path / "fit")

    def test_num_to_keep_prunes(self, tmp_path):
        """A checkpoint every step, two kept: the newest two rounds."""
        result = train.TorchTrainer(
            gpt2_loop,
            train_loop_config=loop_config(draw_params(), draw_tokens(), 4, ckpt_every=True),
            run_config=run_config(tmp_path, "prune",
                                  checkpoint_config=train.CheckpointConfig(num_to_keep=2)),
        ).fit()
        assert result.error is None
        kept = sorted(d for d in os.listdir(result.path) if d.startswith("checkpoint_"))
        assert kept == ["checkpoint_000002_rank00000", "checkpoint_000003_rank00000"]
        assert os.path.basename(result.checkpoint.path) == kept[-1]
        assert result.checkpoint.to_state_dict()["step"] == 3

    def test_two_worker_gang_forms_over_gloo(self, tmp_path):
        """Two workers leased no GPU: each is bound no card, and the
        process group forms over gloo at world size 2; an all_reduce of the
        ranks gives 1."""
        result = train.TorchTrainer(
            _gang_loop,
            scaling_config=train.ScalingConfig(num_workers=2),
            backend_config=train.TorchConfig(init_distributed=True),
            run_config=run_config(tmp_path, "gang"),
        ).fit()
        assert result.error is None
        m = result.metrics
        assert m["backend"] == "gloo" and m["world_size"] == 2 and m["rank_sum"] == 1
        assert m["facts"]["world_size"] == 2 and m["facts"]["all_reduce"] == 2
        assert m["visible"] == ["", ""]
        assert m["env"] == {"WORLD_SIZE": "2", "RANK": "0", "LOCAL_RANK": "0", "NODE_RANK": "0"}

    def test_gpu_leased_worker_without_cuda_raises(self, tmp_path):
        """A use_gpu worker is bound a card index on a cluster that declares
        GPUs but has no card: CUDA is unavailable there, so the group does
        not form (no gloo in NCCL's place) and fit() returns the gang
        error without running the loop."""
        result = train.TorchTrainer(
            _gang_loop,
            scaling_config=train.ScalingConfig(num_workers=1, use_gpu=True),
            backend_config=train.TorchConfig(init_distributed=True),
            run_config=run_config(tmp_path, "no_cuda"),
        ).fit()
        assert isinstance(result.error, TrainWorkerGroupError)
        assert "CUDA_VISIBLE_DEVICES='0'" in str(result.error) and "NCCL" in str(result.error)
        assert result.metrics_dataframe == []

    def test_placement_group_bundle_binds_a_card(self):
        """A use_gpu bundle's GPU reaches its worker's lease: the raylet
        binds one card index to each worker of the gang, never the same
        one twice; a bundle without GPUs binds none."""
        group = WorkerGroup(2, train.ScalingConfig(num_workers=2, use_gpu=True).bundle())
        try:
            infos = rt.get([w.actor.node_info.remote() for w in group.workers])
            assert sorted(i["cuda_visible_devices"] for i in infos) == ["0", "1"]
        finally:
            group.shutdown()
        group = WorkerGroup(1, train.ScalingConfig(num_workers=1).bundle())
        try:
            info = rt.get(group.workers[0].actor.node_info.remote())
            assert info["cuda_visible_devices"] == ""
        finally:
            group.shutdown()


def _gang_loop(config):
    import torch as th
    import torch.distributed as dist

    from ray_tpu_torch import train as tr
    from ray_tpu_torch.train.backend import process_group_facts

    t = th.tensor([float(tr.get_context().get_world_rank())])
    dist.all_reduce(t)
    visible = [None] * dist.get_world_size()
    dist.all_gather_object(visible, os.environ.get("CUDA_VISIBLE_DEVICES"))
    tr.report({"backend": dist.get_backend(), "world_size": dist.get_world_size(),
               "rank_sum": float(t), "visible": visible, "facts": process_group_facts(),
               "env": {k: os.environ[k] for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "NODE_RANK")}})


def _optimizer_after_steps(model, steps=2):
    opt = spmd.adamw(model.parameters(), 3e-4, weight_decay=0.1)
    for _ in range(steps):
        opt.zero_grad()
        sum(p.square().sum() for p in model.parameters()).backward()
        opt.step()
    return opt


def test_state_dict_round_trips_bit_for_bit(tmp_path):
    """A model's and an AdamW's state dicts (step counts included) come
    back as saved: on the CPU without a template, in place with one."""
    model = gpt2.init(gpt2.GPTConfig.tiny(dtype=torch.bfloat16), torch.Generator().manual_seed(0), "cpu")
    opt = _optimizer_after_steps(model)
    saved = {"model": model.state_dict(), "optim": opt.state_dict(), "step": 7,
             "bf16": torch.randn(3, 5).bfloat16()}
    ckpt = train.Checkpoint.from_state_dict(saved).persist(str(tmp_path), name="c")
    back = ckpt.to_state_dict()
    assert back["step"] == 7 and back["optim"]["param_groups"] == saved["optim"]["param_groups"]
    for k, v in saved["model"].items():
        assert back["model"][k].device.type == "cpu" and torch.equal(back["model"][k], v)
    for i, st in saved["optim"]["state"].items():
        assert set(back["optim"]["state"][i]) == {"step", "exp_avg", "exp_avg_sq"}
        for k, v in st.items():
            assert torch.equal(back["optim"]["state"][i][k], v), (i, k)
    assert back["bf16"].dtype == torch.bfloat16 and torch.equal(back["bf16"], saved["bf16"])

    # In place: a fresh model and an optimizer that took the same steps
    # from other weights get exactly the saved values.
    other = gpt2.init(gpt2.GPTConfig.tiny(dtype=torch.bfloat16), torch.Generator().manual_seed(1), "cpu")
    other_opt = _optimizer_after_steps(other)
    template = {"model": other.state_dict(), "optim": other_opt.state_dict(), "step": 0,
                "bf16": torch.zeros(3, 5, dtype=torch.bfloat16)}
    filled = ckpt.to_state_dict(template)
    assert filled is template and filled["step"] == 7
    for k, v in model.state_dict().items():
        assert torch.equal(other.state_dict()[k], v), k
    for p, q in zip(opt.state.values(), other_opt.state.values()):
        assert all(torch.equal(p[k], q[k]) for k in p)
    with pytest.raises(ValueError, match="template"):
        ckpt.to_state_dict({"model": {}, "optim": {}, "step": 0, "bf16": None})
    with pytest.raises(ValueError, match="from_state_dict"):
        train.Checkpoint.from_dict({"a": 1}).to_state_dict()


def test_optimizer_resumes_from_a_checkpoint_on_the_same_steps(tmp_path):
    """Three AdamW steps straight, against two, a checkpoint, a fresh
    model and optimizer loaded from it, and the third: the same bits."""
    cfg = gpt2.GPTConfig.tiny()
    tokens = torch.from_numpy(draw_tokens()).long()

    def fresh():
        model = gpt2.init(cfg, torch.Generator().manual_seed(0), "cpu")
        opt = spmd.adamw(model.parameters(), 3e-4, weight_decay=0.1)
        return model, opt, spmd.compile_train_step(gpt2.loss_fn, opt)

    model, _, step = fresh()
    state = spmd.TrainState(0, model)
    straight = []
    for _ in range(3):
        state, m = step(state, {"tokens": tokens})
        straight.append(m["loss"].item())
    model, opt, step = fresh()
    state = spmd.TrainState(0, model)
    for _ in range(2):
        state, _ = step(state, {"tokens": tokens})
    ckpt = train.Checkpoint.from_state_dict({"model": model.state_dict(), "optim": opt.state_dict()})
    ckpt = ckpt.persist(str(tmp_path))
    model, opt, step = fresh()
    saved = ckpt.to_state_dict()
    model.load_state_dict(saved["model"])
    opt.load_state_dict(saved["optim"])
    _, m = step(spmd.TrainState(2, model), {"tokens": tokens})
    assert m["loss"].item() == straight[2]


def test_config_seams():
    """use_gpu asks each bundle for one card (or gpus_per_worker); a TPU
    request raises where the config is made; results default under the
    runtime's session root."""
    from ray_tpu_torch.common.constants import session_root

    assert train.ScalingConfig(use_gpu=True).bundle() == {"CPU": 1.0, "GPU": 1}
    assert train.ScalingConfig(use_gpu=True, gpus_per_worker=2).bundle()["GPU"] == 2
    assert "GPU" not in train.ScalingConfig().bundle()
    for res in ({"TPU": 4}, {"TPU-v5e-8-head": 1}):
        with pytest.raises(ValueError, match="no TPU"):
            train.ScalingConfig(resources_per_worker=res)
    assert train.RunConfig().resolved_storage_path() == os.path.join(session_root(), "results")
    assert isinstance(train.TorchTrainer(gpt2_loop).backend_config, train.TorchConfig)
