"""The port's pipeline parallelism (``ray_tpu_torch.models.pp``,
``parallel/pipeline.py``, ``train/pipeline``) against the JAX package, on the
CPU.

Weights are the reference's: drawn with numpy in the shapes of the JAX
``init`` pytree, or the reference runner's own seeded init, carried across
with ``models.convert.pp_params_from_jax``; tokens come from numpy.
Everything is f32, and the tolerance is 1e-5 (absolute for activations,
gradients and parameters, relative for losses), the training parity tests'
f32 bound.  Adam's first steps move a parameter by about lr whatever the
size of its gradient, so a gradient that is zero up to rounding turns both
frameworks' rounding noise into a difference of a few percent of lr: the
optimizer runs at lr 1e-4 where parameters are compared, as in
``test_torch_parallel.py``.

The in-program GPipe step runs in two spawned gloo ranks
(``parallel.launch.run_ranks``; the rank functions are in
``torch_pipeline_ranks.py``) against the reference's on two virtual
devices.  The trainer on the port's runtime, the 4- and 8-rank layouts and
the dry run's pipeline passes are in ``test_zz_torch_pipeline.py``.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_pipeline_ranks as ranks
from ray_tpu.models import gpt2 as jax_gpt2
from ray_tpu.models import llama as jax_llama
from ray_tpu.models import pp as jax_pp
from ray_tpu.parallel import mesh as jax_mesh
from ray_tpu.parallel import pipeline as jax_pipeline
from ray_tpu.train import pipeline as jax_tp
from ray_tpu.train.pipeline import driver as jax_driver
from ray_tpu.train.pipeline import schedule as jax_schedule
from ray_tpu_torch.models import gpt2, llama, pp
from ray_tpu_torch.models.convert import (
    gpt2_params_from_jax,
    llama_params_from_jax,
    params_to_jax,
    pp_params_from_jax,
    pp_params_to_jax,
)
from ray_tpu_torch.parallel.launch import run_ranks
from ray_tpu_torch.train import pipeline as tp
from ray_tpu_torch.train.pipeline import schedule

TOL = 1e-5
JAX_FAMILIES = {"gpt2": (jax_gpt2, jax_gpt2.GPTConfig), "llama": (jax_llama, jax_llama.LlamaConfig)}
PORT_FAMILIES = {"gpt2": (gpt2.GPTConfig, gpt2_params_from_jax),
                 "llama": (llama.LlamaConfig, llama_params_from_jax)}


def draw_params(kind, seed=0, **cfg):
    """The reference's f32 parameter pytree for ``kind``'s tiny config,
    drawn with numpy: norms near 1, everything else near 0, all perturbed."""
    mod, config_cls = JAX_FAMILIES[kind]
    shapes = jax.eval_shape(lambda: mod.init(jax.random.key(0), config_cls.tiny(**cfg)))
    rng = np.random.default_rng(seed)

    def draw(path, s):
        key = jax.tree_util.keystr(path)
        base = 1.0 if ("scale" in key or "norm" in key) else 0.0
        return (base + rng.standard_normal(s.shape) * 0.02).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def configs(kind, **cfg):
    """(the reference's f32 config, the port's) for ``kind``'s tiny config."""
    return (JAX_FAMILIES[kind][1].tiny(dtype=jnp.float32, **cfg),
            PORT_FAMILIES[kind][0].tiny(dtype=torch.float32, **cfg))


def tokens(shape, vocab=256, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=0, atol=tol, err_msg=what)


# -- the 1F1B schedule (pure Python, copied) -----------------------------------

@pytest.mark.parametrize("n_micro", range(1, 9))
@pytest.mark.parametrize("n_stages", range(1, 6))
def test_schedule_matches_reference(n_stages, n_micro):
    for s in range(n_stages):
        assert schedule.stage_ops(s, n_stages, n_micro) == jax_schedule.stage_ops(s, n_stages, n_micro)
        assert (schedule.inflight_micros(s, n_stages, n_micro)
                == jax_schedule.inflight_micros(s, n_stages, n_micro))
        for kind in "FB":
            for m in range(n_micro):
                assert (schedule.op_dep(s, kind, m, n_stages)
                        == jax_schedule.op_dep(s, kind, m, n_stages))
    assert schedule.submission_order(n_stages, n_micro) == jax_schedule.submission_order(n_stages, n_micro)
    assert schedule.bubble_micro_ops(n_stages) == jax_schedule.bubble_micro_ops(n_stages)


# -- the cut -------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["gpt2", "llama"])
def test_cut_roundtrip_bitwise(kind):
    """from_pp(to_pp(model)) holds every tensor of the model bit for bit,
    and the reference's cut pytree survives the trip into the port's cut and
    back; both cuts hold the same arrays."""
    _, cfg = configs(kind, num_layers=4)
    np_params = draw_params(kind, num_layers=4)
    model = PORT_FAMILIES[kind][1](np_params, cfg, "cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    part = pp.get_partition(kind, cfg)
    cut = part.to_pp(model, 2)
    assert [len(s) for s in cut["stages"]] == [2, 2]
    merged = part.from_pp(cut).state_dict()
    assert merged.keys() == before.keys()
    assert all(torch.equal(merged[k], before[k]) for k in before)
    jax_to_pp = jax_pp.gpt2_to_pp if kind == "gpt2" else jax_pp.llama_to_pp
    np_pp = jax.tree.map(np.asarray, jax_to_pp(np_params, 2))
    back = pp_params_to_jax(pp_params_from_jax(np_pp, part, "cpu"))
    assert jax.tree.structure(back) == jax.tree.structure(np_pp)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_pp)))
    assert all(np.array_equal(a, b) for a, b in
               zip(jax.tree.leaves(pp_params_to_jax(cut)), jax.tree.leaves(np_pp)))
    # the layout: a stage's leaves split on their stage index over pp, the
    # tail's replicated, as the reference's shardings say
    jmesh = jax_mesh.make_mesh(jax_mesh.MeshConfig(dp=-1, pp=2))
    try:
        want = jax_pp.pp_params_sharding(jmesh, np_pp)
    finally:
        jax_mesh.set_current_mesh(None)
    for name, spec in pp.pp_params_sharding(cut).items():
        part_name, *rest = name.split(".")
        leaf = want[part_name][rest[-1]]
        assert tuple(spec) == tuple(leaf.spec), name


def test_indivisible_layers_and_unknown_family_raise():
    _, cfg = configs("gpt2", num_layers=3)
    part = pp.get_partition("gpt2", cfg)
    with pytest.raises(ValueError, match="3 layers not divisible into 2 pipeline stages"):
        part.to_pp(gpt2.GPT2(cfg, device="meta"), 2)
    with pytest.raises(ValueError, match="not divisible"):
        jax_pp.split_stacked({"w": np.zeros((3, 2))}, 2)
    with pytest.raises(ValueError, match=r"unknown pipeline model family 'bert' \(registered: "
                                         r"\['gpt2', 'llama'\]\)"):
        pp.get_partition("bert", cfg)
    with pytest.raises(ValueError, match="unknown pipeline model family 'bert'"):
        jax_pp.get_partition("bert", cfg)


@pytest.mark.parametrize("kind,cfg", [("gpt2", {}), ("llama", {}), ("llama", {"tie_embeddings": True})],
                         ids=["gpt2", "llama", "llama-tied"])
def test_partition_matches_reference(kind, cfg):
    """prelude, a stage's stage_fn and loss_tail, each on the same inputs."""
    jcfg, pcfg = configs(kind, **cfg)
    np_params = draw_params(kind, **cfg)
    jpart = jax_pp.get_partition(kind, jcfg)
    jcut = jax.tree.map(jnp.asarray, jpart.to_pp(np_params, 2))
    part = pp.get_partition(kind, pcfg)
    cut = pp_params_from_jax(jax.tree.map(np.asarray, jcut), part, "cpu")
    toks = tokens((3, 2, 17))
    x, y = toks[..., :-1], toks[..., 1:]
    with torch.no_grad():
        h = part.prelude(cut["tail"], torch.from_numpy(x).long())
        h1 = part.stage_fn(cut["stages"][1], h[0])
        loss = part.loss_tail(cut["tail"], h, torch.from_numpy(y).long())

    @jax.jit
    def reference(c, x, y):
        jh = jpart.prelude(c["tail"], x)
        return (jh, jpart.stage_fn(jax.tree.map(lambda a: a[1], c["stages"]), jh[0]),
                jpart.loss_tail(c["tail"], jh, y))

    jh, jh1, jloss = reference(jcut, x, y)
    close(h, jh, what="prelude")
    close(h1, jh1, what="stage_fn")
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)


# -- the per-stage programs and the local runner --------------------------------

PARITY = dict(n_stages=3, n_micro=4, micro_batch=2, seq_len=32,
              optimizer={"name": "adam", "lr": 1e-4})


@pytest.fixture(scope="module")
def reference_runner():
    """The reference's LocalPipelineRunner for the 3-stage tiny GPT-2,
    started from numpy-drawn weights (in place of its seeded init), those
    weights' cut, and the port's config."""
    jcfg, pcfg = configs("gpt2", num_layers=3, max_seq_len=32)
    np_pp = jax.tree.map(np.asarray, jax_pp.gpt2_to_pp(draw_params("gpt2", num_layers=3, max_seq_len=32),
                                                       3))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_driver, "init_pp_params", lambda config: np_pp)
        runner = jax_tp.LocalPipelineRunner(jax_tp.PipelineConfig(model_config=jcfg, **PARITY))
    return runner, np_pp, tp.PipelineConfig(model_config=pcfg, device="cpu", **PARITY)


def test_stage_programs_grads_match_reference(reference_runner):
    """First, middle and fused last stage: outputs and gradients of the
    port's StagePrograms against the reference's jitted programs, from the
    same weights, tokens and cotangents."""
    runner, np_pp, pc = reference_runner
    part = pp.get_partition("gpt2", pc.model_config)
    cut = pp_params_from_jax(np_pp, part, "cpu")
    progs = [tp.StagePrograms(part, 3, s, pc.optimizer, pc.scale) for s in range(3)]
    jprogs = runner.progs
    jblocks = [jax.tree.map(lambda a, s=s: a[s], np_pp["stages"]) for s in range(3)]
    jtail = np_pp["tail"]
    stages, tail = cut["stages"], cut["tail"]
    toks = tokens((2, 33))
    x, y = toks[:, :-1], toks[:, 1:]
    xt, yt = torch.from_numpy(x).long(), torch.from_numpy(y).long()

    def close_tree(got, want, what):
        for k, v in got.items():  # "i.leaf" is layer i of the stacked leaf
            i, _, leaf = k.partition(".")
            ref = want[leaf][int(i)] if leaf else want[k]
            close(v.detach(), ref, what=f"{what} {k}")

    h0 = progs[0].fwd(stages[0], tail, xt)
    jh0 = jprogs[0].fwd(jblocks[0], jtail, x)
    close(h0, jh0, what="first fwd")
    h1 = progs[1].fwd(stages[1], h0)
    jh1 = jprogs[1].fwd(jblocks[1], jh0)
    close(h1, jh1, what="mid fwd")
    loss, (gb, gt, gh) = progs[2].fwd_loss(stages[2], tail, h1, yt)
    jloss, (jgb, jgt, jgh) = jprogs[2].fwd_loss(jblocks[2], jtail, jh1, y)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL)
    close_tree(gb, jgb, "last g_blocks")
    close_tree(gt, jgt, "last g_tail")
    close(gh, jgh, what="last g_h")
    gb, gh = progs[1].bwd(stages[1], h0, gh)
    jgb, jgh = jprogs[1].bwd(jblocks[1], jh0, jgh)
    close_tree(gb, jgb, "mid g_blocks")
    close(gh, jgh, what="mid g_h")
    gb, gt = progs[0].bwd(stages[0], tail, xt, gh)
    jgb, jgt = jprogs[0].bwd(jblocks[0], jtail, x, jgh)
    close_tree(gb, jgb, "first g_blocks")
    close_tree(gt, jgt, "first g_tail")


def test_local_runner_matches_reference(reference_runner):
    """Three steps of the port's LocalPipelineRunner against the
    reference's from the same weights and synthetic batches: every loss,
    and every parameter gathered after them."""
    runner, np_pp, pc = reference_runner
    port = tp.LocalPipelineRunner(pc, pp_params_from_jax(np_pp, pp.get_partition("gpt2", pc.model_config),
                                                         "cpu"))
    batches = tp.synthetic_batches(pc, 3)
    want = runner.train(batches)
    got = port.train(batches)
    np.testing.assert_allclose(got, want, rtol=TOL)
    assert got[-1] < got[0]
    want_params, got_params = runner.gather_params(), params_to_jax(port.gather_params())
    assert jax.tree.structure(got_params) == jax.tree.structure(want_params)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want_params)[0],
                            jax.tree.leaves(got_params)):
        close(g, w, what=jax.tree_util.keystr(path))


@pytest.mark.parametrize("dp", [1, 2])
def test_pipeline_grads_match_unpipelined(dp):
    """One step of the local runner under SGD at lr 1 moves every parameter
    by its gradient: the 3-stage cut's, summed over microbatches and lanes
    and scaled, equals the gradient of the port's unpipelined loss over the
    whole batch (the tied embedding's two halves summed)."""
    _, cfg = configs("gpt2", num_layers=3, max_seq_len=32, remat=False)
    pc = tp.PipelineConfig(model_config=cfg, n_stages=3, n_micro=2, micro_batch=4, dp=dp, seq_len=32,
                           optimizer={"name": "sgd", "lr": 1.0}, device="cpu")
    model = gpt2_params_from_jax(draw_params("gpt2", num_layers=3, max_seq_len=32), cfg, "cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    (x, y), = tp.synthetic_batches(pc, 1)
    gpt2.loss_fn(model, {"inputs": torch.from_numpy(x.reshape(-1, 32)).long(),
                         "targets": torch.from_numpy(y.reshape(-1, 32)).long()}).backward()
    runner = tp.LocalPipelineRunner(pc, pp.get_partition("gpt2", cfg).to_pp(model, 3))
    runner.run_step(x, y)
    after = runner.gather_params().state_dict()
    for name, p in model.named_parameters():
        close(before[name] - after[name], p.grad, what=name)


# -- the optimizers ------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    {"name": "sgd", "lr": 0.1}, {"name": "sgd", "lr": 0.1, "momentum": 0.9},
    {"name": "adam", "lr": 1e-2}, {"name": "adamw", "lr": 1e-2, "weight_decay": 0.1},
], ids=["sgd", "sgd-momentum", "adam", "adamw"])
def test_make_optimizer_matches_optax(spec):
    """Three updates from the same parameters and gradients, against the
    reference's optax transform from the same spec."""
    rng = np.random.default_rng(0)
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in (("w", (4, 3)), ("b", (3,)))}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    module = torch.nn.ParameterDict({k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                                     for k, v in params.items()})
    opt = tp.make_optimizer(spec)(module.parameters())
    jopt = jax_tp.make_optimizer(spec)
    jparams = dict(params)
    state = jopt.init(jparams)
    for g in grads:
        for k, p in module.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
        updates, state = jopt.update(g, state, jparams)
        jparams = optax.apply_updates(jparams, updates)
    for k, p in module.items():
        close(p.detach(), jparams[k], tol=1e-6, what=k)
    with pytest.raises(ValueError, match="unknown optimizer 'lamb'"):
        tp.make_optimizer({"name": "lamb"})


def test_pipeline_config_validation():
    _, cfg = configs("gpt2")
    with pytest.raises(ValueError, match="micro_batch 3 must divide over dp 2"):
        tp.PipelineConfig(model_config=cfg, micro_batch=3, dp=2)
    with pytest.raises(ValueError, match="handoff must be 'p2p' or 'driver'"):
        tp.PipelineConfig(model_config=cfg, handoff="ring")
    with pytest.raises(ValueError, match="device must be 'cuda' or 'cpu'"):
        tp.PipelineConfig(model_config=cfg, device="tpu")
    pc = tp.PipelineConfig(model_config=cfg, n_micro=3, micro_batch=4, dp=2, seq_len=16)
    assert (pc.device, pc.handoff, pc.lane_mb, pc.scale, pc.tokens_per_step()) == ("cuda", "p2p", 2, 1 / 6,
                                                                                   192)
    assert pc.stage_spec(1, 0)["device"] == "cuda"
    with pytest.raises(ValueError, match="MPMD pipeline needs n_stages >= 2"):
        tp.StagePrograms(pp.get_partition("gpt2", cfg), 1, 0, pc.optimizer, pc.scale)


# -- the in-program GPipe step over two gloo ranks -----------------------------

WIDTH = 16


def gpipe_case(n, steps=3, lr=1e-2, n_micro=4, mb=2):
    """Pass 3's stages (tanh(x @ w + b), width 16) and data, drawn with numpy."""
    rng = np.random.default_rng(n)
    draw = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    return dict(w=draw(n, WIDTH, WIDTH) * np.float32(0.5), b=np.zeros((n, WIDTH), np.float32),
                x=draw(n_micro, mb, WIDTH), y=draw(n_micro, mb, WIDTH), lr=lr, steps=steps)


def jax_gpipe(case, n):
    """The reference's GPipe steps on n virtual devices: losses and params."""
    mesh = jax_pipeline.make_pp_mesh(n, devices=jax.devices()[:n])
    params = jax.device_put({"w": case["w"], "b": case["b"]}, jax_pipeline.stage_sharding(mesh))
    opt = optax.adam(case["lr"])
    state = opt.init(params)
    step = jax_pipeline.pipeline_train_step(
        lambda p, x: jnp.tanh(x @ p["w"] + p["b"]), lambda o, y: ((o - y) ** 2).mean(), opt, mesh,
        n_micro=case["x"].shape[0])
    losses = []
    for _ in range(case["steps"]):
        params, state, loss = step(params, state, case["x"], case["y"])
        losses.append(float(loss))
    return losses, jax.tree.map(np.asarray, params)


GPIPE2 = gpipe_case(2)


@pytest.fixture(scope="module", autouse=True)
def _two_ranks_started():
    """The two gloo ranks start with the module's first test, in a thread
    that waits on them, so that their start overlaps the JAX compiles."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        yield pool.submit(run_ranks, ranks.jobs, 2, 2, [("gpipe_steps", GPIPE2), ("too_few_ranks", 3)],
                          backend="gloo", timeout=300)


@pytest.fixture(scope="module")
def two_ranks(_two_ranks_started):
    return _two_ranks_started.result()


def test_two_rank_gpipe_matches_reference(two_ranks):
    """Pass 3 at two stages: each step's loss and the updated stacked
    parameters against the reference's GPipe step on two virtual devices."""
    got = two_ranks[0][0]
    want_losses, want_params = jax_gpipe(GPIPE2, 2)
    np.testing.assert_allclose(got["losses"], want_losses, rtol=TOL)
    for k in ("w", "b"):
        close(got["params"][k], want_params[k], what=k)


def test_two_rank_gpipe_grads_match_sequential(two_ranks):
    """The first step's gradients, each rank its stage's slice, against
    the sequential model's (the stages run one after another on the whole
    batch) taken by the reference."""
    c = GPIPE2

    def seq_loss(p):
        h = c["x"].reshape(-1, WIDTH)
        for i in range(2):
            h = jnp.tanh(h @ p["w"][i] + p["b"][i])
        return ((h.reshape(c["y"].shape) - c["y"]) ** 2).mean()

    want = jax.jit(jax.grad(seq_loss))({"w": c["w"], "b": c["b"]})
    for rank in range(2):
        for k in ("w", "b"):
            close(two_ranks[rank][0]["grads"][k][0], want[k][rank], what=f"rank {rank} {k}")


def test_pp_mesh_refuses_too_few_ranks(two_ranks):
    assert two_ranks[0][1] == two_ranks[1][1] == "pipeline needs 3 ranks, have 2"
    with pytest.raises(ValueError, match="pipeline needs 1000 devices, have 8"):
        jax_pipeline.make_pp_mesh(1000)
