"""The port's SPMD layer (``ray_tpu_torch/parallel``) against the JAX package.

The rule tables, specs and mesh shapes are pure Python and are held equal
to the reference's, spec for spec.  The sharded step runs in spawned gloo
ranks on the CPU (``parallel.launch.run_ranks``), one process a rank; the
reference's runs in this process on 2 of the 8 virtual CPU devices, at the
same mesh, from the same weights (drawn with numpy in the shapes of the JAX
``init`` pytree) and the same batch.  Everything is f32.

Tolerances: the loss and the gradient norm to 1e-5 relative; the
parameters after the update to 1e-5 absolute, elementwise (lr 1e-4: Adam
moves a parameter by about lr whatever its gradient's size, so a gradient
that is zero up to rounding, as the attention's key bias's is, turns both
frameworks' rounding noise into a difference of up to a few percent of lr).
The slow multi-rank cases (8 ranks, ring attention, experts, ViT, Llama
decoding, multislice, the dry run) are in ``test_zz_torch_parallel.py``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from torch.distributed.tensor import Replicate, Shard

import torch_parallel_ranks as ranks
from ray_tpu.models import gpt2 as jax_gpt2
from ray_tpu.models import llama as jax_llama
from ray_tpu.models import vit as jax_vit
from ray_tpu.parallel import mesh as jax_mesh
from ray_tpu.parallel import sharding as jax_sharding
from ray_tpu.parallel import spmd as jax_spmd
from ray_tpu_torch.models import gpt2, llama, vit
from ray_tpu_torch.parallel import mesh as mesh_mod
from ray_tpu_torch.parallel import sharding, spmd
from ray_tpu_torch.parallel.launch import run_ranks

JAX_MODELS = {"gpt2": jax_gpt2, "vit": jax_vit, "llama": jax_llama}
JAX_CONFIGS = {"gpt2": jax_gpt2.GPTConfig, "vit": jax_vit.ViTConfig, "llama": jax_llama.LlamaConfig}
TOL = 1e-5
LR = 1e-4


def draw_params(kind, **cfg):
    """The reference's parameter pytree for ``kind``'s tiny config, drawn
    with numpy: norms near 1, everything else near 0, all perturbed."""
    mod = JAX_MODELS[kind]
    jcfg = JAX_CONFIGS[kind].tiny(**cfg)
    shapes = jax.eval_shape(lambda: mod.init(jax.random.key(0), jcfg))
    rng = np.random.default_rng(0)

    def draw(path, s):
        key = jax.tree_util.keystr(path)
        base = 1.0 if ("scale" in key or "norm" in key) else 0.0
        return (base + rng.standard_normal(s.shape) * 0.02).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def jax_leaf(tree, name):
    """The reference's array for the port's parameter ``name``: block i of
    a stacked leaf for ``blocks.i.leaf``."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return np.asarray(tree["blocks"][parts[2]][int(parts[1])])
    return np.asarray(tree[name])


def jax_steps(case, n):
    """The reference's sharded steps for a ``torch_parallel_ranks`` case on
    n virtual devices (its config is ``jax_cfg`` where the case gives one):
    each step's (loss, gradient norm) and the params."""
    mod = JAX_MODELS[case["kind"]]
    cfg = JAX_CONFIGS[case["kind"]].tiny(dtype=jnp.float32, **case.get("jax_cfg", case.get("cfg", {})))
    mc = jax_mesh.MeshConfig(**case["mesh"])
    devices = jax.devices()[:n]
    if case.get("slices"):
        mesh = jax_mesh.make_multislice_mesh(case["slices"], mc, devices=devices)
    else:
        mesh = jax_mesh.make_mesh(mc, devices=devices)
    try:
        opt = optax.adamw(case["lr"])
        state = jax_spmd.sharded_init(mesh, lambda _: case["np_params"], jax.random.key(0),
                                      mod.param_logical_axes(cfg), opt)
        step = jax_spmd.compile_train_step(lambda p, b: mod.loss_fn(p, b, cfg), opt, donate=False)
        batch = jax_spmd.shard_batch(mesh, case["batch"], shard_seq=case.get("shard_seq", False))
        metrics = []
        with jax.set_mesh(mesh):
            for _ in range(case.get("steps", 1)):
                state, m = step(state, batch)
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
        return metrics, jax.tree.map(np.asarray, state.params)
    finally:
        jax_mesh.set_current_mesh(None)
        jax_sharding.set_active_rules(jax_sharding.DEFAULT_RULES)


def assert_step_matches(got, case, n):
    want_metrics, want_params = jax_steps(case, n)
    assert got["layout"] == []
    np.testing.assert_allclose(got["metrics"], want_metrics, rtol=TOL, atol=0)
    start = {name: jax_leaf(case["np_params"], name) for name in got["params"]}
    for name, value in got["params"].items():
        assert not np.array_equal(value, start[name]), f"{name} did not move"
        np.testing.assert_allclose(value, jax_leaf(want_params, name), rtol=0, atol=TOL, err_msg=name)


def gpt2_batch(B=4, S=32, seed=1, split=False):
    tokens = np.random.default_rng(seed).integers(0, 256, (B, S + 1)).astype(np.int32)
    if split:
        return {"inputs": tokens[:, :-1].copy(), "targets": tokens[:, 1:].copy()}
    return {"tokens": tokens}


# -- pure Python: meshes, specs, placements ----------------------------------

@pytest.mark.parametrize("kw,n", [
    ({}, 8), ({"tp": 2}, 8), ({"dp": 2, "fsdp": 2, "tp": 2}, 8), ({"dp": 1, "fsdp": -1, "tp": 2}, 4),
    ({"dp": 1}, 1), ({"tp": 3}, 8), ({"fsdp": -1}, 8), ({"dp": 2}, 4), ({"dp": 2, "sp": 2}, 4),
])
def test_mesh_config_resolve(kw, n):
    def resolve(mod):
        try:
            mc = mod.MeshConfig(**kw).resolve(n)
        except ValueError as e:
            return str(e)
        return mc.shape, mc.describe()

    assert resolve(mesh_mod) == resolve(jax_mesh)


def _all_specs():
    """Every parameter spec of every ported model, and the activations'."""
    specs = {("batch", "seq", "embed"), ("batch", "heads", "seq", None), ("batch", "seq", "heads", None),
             ("batch", "seq", "mlp"), ("batch", "seq", "vocab"), ("batch", "expert", None, "embed"),
             ("batch", "expert", None, "mlp"), ("batch", None, "vocab"), (None, None)}
    for logical in (gpt2.param_logical_axes(gpt2.GPTConfig.tiny()),
                    gpt2.param_logical_axes(gpt2.GPTConfig.tiny(num_experts=4)),
                    llama.param_logical_axes(llama.LlamaConfig.tiny()),
                    vit.param_logical_axes(vit.ViTConfig.tiny())):
        specs.update(logical.values())
    return sorted(specs, key=str)


@pytest.mark.parametrize("table", ["DEFAULT_RULES", "MULTISLICE_RULES"])
def test_logical_to_spec_matches_jax(table):
    assert getattr(sharding, table) == getattr(jax_sharding, table)
    for spec in _all_specs():
        got = sharding.logical_to_spec(spec, getattr(sharding, table))
        want = jax_sharding.logical_to_spec(spec, getattr(jax_sharding, table))
        assert tuple(got) == tuple(want), spec


def _mesh(**sizes):
    """A mesh of these axis sizes with a stand-in for torch's DeviceMesh
    (placements and the divisibility check read only the names)."""
    shape = {a: sizes.get(a, 1) for a in mesh_mod.AXIS_ORDER}
    names = tuple(a for a in mesh_mod.AXIS_ORDER if shape[a] > 1)
    return mesh_mod.Mesh(shape, types.SimpleNamespace(mesh_dim_names=names))


def test_spec_placements():
    mesh = _mesh(dp=2, fsdp=2, tp=2)
    spec = lambda logical: sharding.logical_to_spec(logical, sharding.DEFAULT_RULES)
    assert mesh.torch_axes == ("dp", "fsdp", "tp")
    # a dim named by several axes is sharded on each, outer axis first
    assert sharding.spec_placements(mesh, spec(("batch", "seq", "embed"))) == (Shard(0), Shard(0), Replicate())
    assert sharding.spec_placements(mesh, spec(("vocab", "embed"))) == (Replicate(), Shard(1), Shard(0))
    assert sharding.spec_placements(mesh, spec(("kv", None))) == (Replicate(),) * 3
    # axes of size 1 drop out of the torch mesh
    assert sharding.spec_placements(_mesh(tp=2), spec(("batch", "heads"))) == (Shard(1),)
    with pytest.raises(ValueError, match="out of mesh order"):
        sharding.spec_placements(mesh, sharding.PartitionSpec(("fsdp", "dp")))


def test_divisibility_error_names_the_param():
    """num_experts not divisible by ep fails naming the parameter and the
    axis before anything is sharded, as the reference's pre-check does."""
    cfg = gpt2.GPTConfig.tiny(num_experts=6)
    with pytest.raises(ValueError, match=r"param blocks\.0\.router dim of size 6 .* not divisible by "
                                         r"mesh axis ep of size 4"):
        spmd.shard_module(gpt2.GPT2(cfg, device="cpu"), _mesh(dp=2, ep=4),
                          gpt2.param_logical_axes(cfg))
    jmesh = jax_mesh.make_mesh(jax_mesh.MeshConfig(dp=2, ep=4))
    try:
        jcfg = jax_gpt2.GPTConfig.tiny(num_experts=6)
        with pytest.raises(ValueError, match="dim of size 6 .* not divisible by mesh axis ep of size 4"):
            jax_spmd.sharded_init(jmesh, lambda r: jax_gpt2.init(r, jcfg), jax.random.key(0),
                                  jax_gpt2.param_logical_axes(jcfg))
    finally:
        jax_mesh.set_current_mesh(None)


@pytest.mark.parametrize("kind,kw", [
    ("gpt2", {}), ("gpt2", {"num_experts": 4}), ("llama", {}), ("llama", {"tie_embeddings": True}),
    ("vit", {}),
], ids=["gpt2", "gpt2-moe", "llama", "llama-tied", "vit"])
def test_param_logical_axes_cover_the_params_and_match_jax(kind, kw):
    """Every ``named_parameters`` entry has the reference's spec, less the
    stacked blocks' leading "layers"."""
    port = {"gpt2": (gpt2, gpt2.GPTConfig, gpt2.GPT2), "llama": (llama, llama.LlamaConfig, llama.Llama),
            "vit": (vit, vit.ViTConfig, vit.ViT)}[kind]
    mod, config_cls, model_cls = port
    cfg = config_cls.tiny(**kw)
    jmod = JAX_MODELS[kind]
    jcfg = JAX_CONFIGS[kind].tiny(**kw)
    logical = mod.param_logical_axes(cfg)
    assert set(logical) == {n for n, _ in model_cls(cfg, device="meta").named_parameters()}
    ref = jmod.param_logical_axes(jcfg)
    for name, spec in logical.items():
        parts = name.split(".")
        if parts[0] == "blocks":
            want = ref["blocks"][parts[2]]
            assert want[0] == "layers" and spec == want[1:], name
        else:
            assert spec == ref[name], name


# -- two gloo ranks against the reference on two virtual devices -------------

TWO_RANK_CASES = [dict(kind="gpt2", mesh=m, np_params=draw_params("gpt2"), batch=gpt2_batch(), lr=LR)
                  for m in ({"dp": 2}, {"dp": 1, "fsdp": 2})]


@pytest.fixture(scope="module")
def two_ranks():
    """One process group of two gloo ranks for the tests below."""
    steps, api = run_ranks(ranks.jobs, 2, 2, [("train_steps", TWO_RANK_CASES), ("api_surface", None)],
                           backend="gloo", timeout=300)[0]
    return {"steps": steps, "api": api}


def test_two_rank_steps_match_jax(two_ranks):
    """One step of the f32 tiny GPT-2 at dp = 2 and at fsdp = 2 (where each
    rank holds half of every parameter, so a norm of the local shards would
    show): loss, the global gradient norm and every updated parameter
    against the reference's sharded step at the same mesh, and every
    parameter and AdamW moment laid out as the rules say."""
    for g, case in zip(two_ranks["steps"], TWO_RANK_CASES):
        assert_step_matches(g, case, 2)


def test_constrain_redistributes_a_dtensor_under_a_mesh(two_ranks):
    """The reference's ``constrain``: a DTensor under a mesh is laid out by
    the rules (its values unchanged); a plain tensor, a DTensor outside a
    mesh and one under ``no_constraints`` come back as they went in."""
    api = two_ranks["api"]
    assert api["constrain"] == ("(Shard(dim=1),)", True, (4, 4))
    assert api["no_constraints"] and api["plain"] and api["outside_a_mesh"]


def test_state_shardings_give_sharded_init_layout(two_ranks):
    """``state_shardings`` is the layout ``sharded_init`` gives every
    parameter (and ``layout_errors`` holds moments to), with tp sharding
    some of them."""
    assert two_ranks["api"]["state_shardings"] == []
    assert two_ranks["api"]["sharded_over_tp"] > 0


def test_in_program_backend_reduces_over_a_mesh_axis(two_ranks):
    """The registry's in-program backend (``"device_mesh"``) reduces over
    a mesh axis: ranks holding 1 and 2."""
    assert two_ranks["api"]["in_program"] == {"sum": [3.0] * 3, "mean": [1.5] * 3, "max": [2.0] * 3,
                                              "min": [1.0] * 3}


def test_dryrun_multigpu_defaults_to_cards():
    """The dry run holds a card a rank unless the caller asks for the CPU:
    with fewer cards than ranks it raises, and it names no other device."""
    from unittest import mock

    from ray_tpu_torch.dryrun import dryrun_multigpu

    with mock.patch("torch.cuda.device_count", return_value=1):
        with pytest.raises(RuntimeError, match=r"needs 2 cards, 1 are visible"):
            dryrun_multigpu(2)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        dryrun_multigpu(2, device_type="tpu")


def test_mesh_of_one_is_the_plain_step_bit_for_bit():
    """What the card runs: the mesh path on one rank (every axis of size 1,
    so every collective is the identity) gives the plain step's losses and
    gradient norms bit for bit, three AdamW steps of the bf16 flash tiny
    GPT-2 at head dim 64."""
    cfg = dict(attention_impl="flash", embed_dim=256, num_heads=4)
    case = dict(cfg=cfg, np_params=draw_params("gpt2", **cfg), batch=gpt2_batch(2, 128), lr=3e-4,
                steps=3)
    plain, sharded = run_ranks(ranks.mesh_of_one, 1, 1, case, backend="gloo", timeout=300)[0]
    assert sharded == plain


def test_fsdp_spec_matches_flax_utils():
    """``train/fsdp_utils.fsdp_spec`` picks the reference's dim: the
    largest that divides by the fsdp size, none where no dim does."""
    from ray_tpu.train import flax_utils
    from ray_tpu_torch.train import fsdp_utils

    shapes = [(), (8,), (6,), (12, 8), (3, 12), (4, 4, 16), (5, 7), (64, 256), (2, 2)]
    for sizes in ({"dp": 2, "fsdp": 4}, {"dp": 8}):
        jmesh = jax_mesh.make_mesh(jax_mesh.MeshConfig(**sizes))
        try:
            for shape in shapes:
                got = fsdp_utils.fsdp_spec(shape, _mesh(**sizes))
                assert tuple(got) == tuple(flax_utils.fsdp_spec(shape, jmesh)), (sizes, shape)
        finally:
            jax_mesh.set_current_mesh(None)
