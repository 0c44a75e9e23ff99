"""The port's sharded paths at larger meshes against the JAX package (slow).

Each group of cases runs in one set of spawned gloo ranks on the CPU (8, 4
or 2 processes, ``torch_parallel_ranks.jobs``), once per module; the
reference runs in this process on as many of the 8 virtual CPU devices, at
the same mesh, from the same numpy weights and inputs.  Everything is f32,
held to the tolerances of ``test_torch_parallel.py`` (1e-5: the loss and
gradient norm relative, the updated parameters absolute at lr 1e-4) unless
a case says otherwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_parallel_ranks as ranks
from ray_tpu.models import llama as jax_llama
from ray_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from ray_tpu.parallel import mesh as jax_mesh
from ray_tpu.parallel import sharding as jax_sharding
from ray_tpu_torch.parallel.launch import run_ranks
from test_torch_parallel import LR, assert_step_matches, draw_params, gpt2_batch

pytestmark = pytest.mark.slow

D64 = dict(embed_dim=256, num_heads=4)  # head dim 64, the card kernels'


def _gpt2(mesh, cfg=None, batch=None, **kw):
    cfg = cfg or {}
    kw.setdefault("lr", LR)
    return dict(kind="gpt2", mesh=mesh, cfg=cfg, np_params=draw_params("gpt2", **cfg),
                batch=batch or gpt2_batch(), **kw)


EIGHT = {
    "dp2-fsdp2-tp2": _gpt2({"dp": 2, "fsdp": 2, "tp": 2}, steps=2),
    # the dry run's first pass: ring attention over sp, with fsdp and tp
    "fsdp2-sp2-tp2-ring": _gpt2({"dp": 1, "fsdp": 2, "sp": 2, "tp": 2}, {"attention_impl": "ring"},
                                gpt2_batch(split=True), shard_seq=True),
    "multislice-dcn2-dp2-tp2": _gpt2({"dp": -1, "tp": 2}, slices=2),
}
FOUR = {
    "moe-ep2-tp2": _gpt2({"dp": 1, "ep": 2, "tp": 2}, {"num_experts": 4}),
    "vit-fsdp2-tp2": dict(
        kind="vit", mesh={"dp": 1, "fsdp": 2, "tp": 2}, np_params=draw_params("vit"), lr=LR,
        batch={"images": np.random.default_rng(2).standard_normal((4, 32, 32, 3)).astype(np.float32),
               "labels": np.random.default_rng(3).integers(0, 128, (4,)).astype(np.int32)}),
}
TWO = {
    # tp = 2 splits the (E, 3H, D) qkv weight: each rank must compute with
    # its own q, k and v heads
    "tp2-dense": _gpt2({"dp": 1, "tp": 2}),
    # The reference's sharded flash path cannot run here: its Pallas call
    # under shard_map's replication check needs a vma on its out_shape.  Its
    # dense attention computes the same function, to f32 rounding; Adam
    # scales that rounding by up to 1/eps where a gradient is near 0 (one
    # element of 262144 moved 0.103 lr apart at lr 1e-4), so this case
    # steps at half the lr.
    "tp2-flash-d64": _gpt2({"dp": 1, "tp": 2}, {"attention_impl": "flash", **D64}, gpt2_batch(2, 128),
                           jax_cfg={"attention_impl": "dense", **D64}, lr=LR / 2),
}


def _ring_inputs(D, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((2, 64, 2, D)).astype(np.float32) for _ in range(4))


RING = {f"sp{n}-d{D}": (n, _ring_inputs(D, D + n)) for n in (2, 4) for D in (16, 64)}
_rng = np.random.default_rng(5)
FSDP = dict(mesh={"dp": 2, "fsdp": 2}, lr=1e-2, steps=3,
            x=_rng.standard_normal((16, 8)).astype(np.float32),
            y=_rng.standard_normal((16, 3)).astype(np.float32))
DECODE = dict(mesh={"dp": 1, "tp": 2}, np_params=draw_params("llama"), steps=3,
              prompt=np.random.default_rng(4).integers(0, 256, (2, 5)).astype(np.int32))


@pytest.fixture(scope="module")
def eight():
    out = run_ranks(ranks.train_steps, 8, 8, list(EIGHT.values()), backend="gloo", timeout=600)[0]
    return dict(zip(EIGHT, out))


@pytest.fixture(scope="module")
def four():
    rings = [v for n, v in RING.values() if n == 4]
    train, ring, fsdp = run_ranks(ranks.jobs, 4, 4, [("train_steps", list(FOUR.values())),
                                                      ("ring_blocks", rings), ("fsdp_steps", FSDP)],
                                  backend="gloo", timeout=600)[0]
    return {**dict(zip(FOUR, train)), **dict(zip([k for k, (n, _) in RING.items() if n == 4], ring)),
            "fsdp": fsdp}


@pytest.fixture(scope="module")
def two():
    rings = [v for n, v in RING.values() if n == 2]
    train, ring, decode, coll = run_ranks(
        ranks.jobs, 2, 2, [("train_steps", list(TWO.values())), ("ring_blocks", rings),
                           ("llama_decode", DECODE), ("collectives", None)],
        backend="gloo", timeout=600)[0]
    out = {**dict(zip(TWO, train)), **dict(zip([k for k, (n, _) in RING.items() if n == 2], ring))}
    return {**out, "decode": decode, "collectives": coll}


@pytest.mark.parametrize("name", list(EIGHT))
def test_eight_rank_steps_match_jax(eight, name):
    assert_step_matches(eight[name], EIGHT[name], 8)


@pytest.mark.parametrize("name", list(FOUR))
def test_four_rank_steps_match_jax(four, name):
    assert_step_matches(four[name], FOUR[name], 4)


@pytest.mark.parametrize("name", list(TWO))
def test_tp2_qkv_heads_match_jax(two, name):
    assert_step_matches(two[name], TWO[name], 2)


@pytest.mark.parametrize("name", list(RING))
def test_ring_attention_matches_jax(two, four, name):
    """Forward and gradients of ring attention over sp = n against the
    reference's under ``shard_map``: both keep f32 (m, l, o) accumulators
    and visit the KV blocks in the same order, so they agree to f32
    rounding (held to 1e-5)."""
    n, (q, k, v, do) = RING[name]
    got = (two if n == 2 else four)[name]
    mesh = jax_mesh.make_mesh(jax_mesh.MeshConfig(dp=1, sp=n), devices=jax.devices()[:n])
    try:
        with jax.set_mesh(mesh):
            out, vjp = jax.vjp(jax_ring_attention, *map(jnp.asarray, (q, k, v)))
            want = [out, *vjp(jnp.asarray(do))]
    finally:
        jax_mesh.set_current_mesh(None)
    for g, w, what in zip(got, want, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=what)


def test_llama_tp2_decode_matches_jax(two):
    """tp = 2 Llama serving: a cached prefill and three row-wise decode
    steps give the reference's greedy tokens (and its logits, to 1e-5),
    each rank caching its query heads' num_kv_heads / 2 KV heads."""
    tokens, logits, kv_heads = two["decode"]
    cfg = jax_llama.LlamaConfig.tiny()
    mesh = jax_mesh.make_mesh(jax_mesh.MeshConfig(dp=1, tp=2), devices=jax.devices()[:2])
    try:
        shardings = jax_sharding.tree_shardings(mesh, jax_llama.param_logical_axes(cfg))
        params = jax.device_put(DECODE["np_params"], shardings)
        prompt = jnp.asarray(DECODE["prompt"])
        B, S0 = prompt.shape
        cache = jax_llama.init_cache(cfg, B, S0 + DECODE["steps"] + 1)
        with jax.set_mesh(mesh):
            out, cache = jax_llama.forward_cached(params, prompt, cache, jnp.int32(0), cfg)
            want = [jnp.argmax(out, axis=-1)]
            pos = jnp.full((B,), S0, jnp.int32)
            for _ in range(DECODE["steps"]):
                out, cache = jax_llama.decode_step_rowwise(params, want[-1].astype(jnp.int32), cache,
                                                           pos, cfg)
                want.append(jnp.argmax(out, axis=-1))
                pos = pos + 1
    finally:
        jax_mesh.set_current_mesh(None)
    assert kv_heads == cfg.num_kv_heads // 2
    np.testing.assert_array_equal(tokens, np.stack([np.asarray(w) for w in want], 1))
    np.testing.assert_allclose(logits, np.asarray(out), rtol=1e-5, atol=1e-5)


def test_collectives_values_and_gradients(two):
    """Each in-program collective over two ranks holding (2, 4) blocks of
    1 and 2, read at rank 0; the gradients are shard_map's."""
    got = two["collectives"]
    y, g = got["allreduce"]
    assert (y == 3).all() and (g == 1).all()  # the sum's gradient passes through
    y, g = got["allgather"]
    assert y.shape == (2, 8) and (y[:, :4] == 1).all() and (y[:, 4:] == 2).all()
    np.testing.assert_array_equal(g, np.tile(2 * np.arange(4.0), (2, 1)))  # reduce-scattered
    y, g = got["ring_permute"]
    assert (y == 2).all() and (g == 2).all()  # rank 1 weighed the block it got from rank 0 by 2
    y, g = got["all_to_all"]
    np.testing.assert_array_equal(y, np.array([[0, 1]] * 2 + [[0, 2]] * 2, dtype=np.float32))
    np.testing.assert_array_equal(g, np.array([[0, 1, 4, 6]] * 2, dtype=np.float32))  # rank 1 weighs by 2
    y, g = got["pvary"]
    assert (y == 1).all() and (g == 3).all()  # summed over the ranks
    assert (got["broadcast"] == 2).all()
    np.testing.assert_array_equal(got["reducescatter"], np.full((2, 2), 3.0))


def test_dryrun_multigpu_eight_ranks():
    from ray_tpu_torch.dryrun import dryrun_multigpu

    lines = dryrun_multigpu(8, device_type="cpu")
    assert [line.split(":")[0] for line in lines] == [
        "dryrun_multigpu OK", "dryrun_multigpu MoE OK", "dryrun_multigpu multislice OK",
        "dryrun_multigpu decode OK", "dryrun_multigpu vit OK", "dryrun_multigpu distributed OK"]
    assert "mesh=fsdp=2xsp=2xtp=2 over 8 ranks" in lines[0]


class _GangMember:
    """A runtime actor in a torch.distributed gloo gang with its peers."""

    def __init__(self, rank, n, store):
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=n)
        self.rank, self.n = rank, n

    def ops(self):
        """The nccl backend's ops in a group of the gang's ranks, and its
        setup for groups whose rank or size is not the gang's."""
        import asyncio

        from ray_tpu_torch.util import collective as col
        from ray_tpu_torch.util.collective.nccl_backend import NcclGangBackend
        from ray_tpu_torch.util.collective.types import CollectiveError, GroupSpec

        col.init_collective_group(self.n, self.rank, backend="nccl", group_name="gang")
        x = np.arange(4, dtype=np.float32) + 10 * self.rank
        out = {
            "sum": col.allreduce(x.copy(), "gang"),
            "max": col.allreduce(x.copy(), "gang", op=col.ReduceOp.MAX),
            "gather": col.allgather(x.copy(), "gang"),
            "scatter": col.reducescatter(x.copy(), "gang"),
            "bcast": col.broadcast(x.copy(), 1, "gang"),
            "obj": col.broadcast_object({"from": self.rank}, 1, "gang"),
            "barrier": col.barrier("gang"),
        }
        refused = []
        for call in (lambda: col.allreduce(x.copy(), "gang", wire_dtype="int8"),
                     lambda: col.send(x, 1 - self.rank, "gang"),
                     lambda: asyncio.run(NcclGangBackend(GroupSpec(
                         name="x", world_size=self.n, rank=1 - self.rank, backend="nccl"), None).setup()),
                     lambda: asyncio.run(NcclGangBackend(GroupSpec(
                         name="x", world_size=self.n + 1, rank=self.rank, backend="nccl"), None).setup())):
            try:
                call()
            except CollectiveError as e:
                refused.append(str(e))
        out["refused"] = refused
        col.destroy_collective_group("gang")
        return out


def test_nccl_backend_over_gloo_among_runtime_actors(tmp_path):
    """The "nccl" runtime backend rides its members' torch.distributed gang
    (gloo here: the actors lease no card).  Its ops give the RPC ring's
    results; a group whose ranks are not the gang's, a wire_dtype override
    and send/recv raise, as the reference's gang backend refuses them."""
    import sys

    import cloudpickle

    import ray_tpu_torch as rt
    from test_torch_runtime import runtime_defaults

    cloudpickle.register_pickle_by_value(sys.modules[__name__])
    try:
        with runtime_defaults():
            rt.init(num_cpus=2, log_to_driver=False)
            try:
                member = rt.remote(num_cpus=1)(_GangMember)
                actors = [member.remote(r, 2, str(tmp_path / "store")) for r in range(2)]
                a, b = rt.get([x.ops.remote() for x in actors], timeout=120)
            finally:
                rt.shutdown()
    finally:
        cloudpickle.unregister_pickle_by_value(sys.modules[__name__])
    x0, x1 = np.arange(4, dtype=np.float32), np.arange(4, dtype=np.float32) + 10
    for got in (a, b):
        np.testing.assert_array_equal(got["sum"], x0 + x1)
        np.testing.assert_array_equal(got["max"], x1)
        np.testing.assert_array_equal(np.stack(got["gather"]), np.stack([x0, x1]))
        np.testing.assert_array_equal(got["bcast"], x1)
        assert got["obj"] == {"from": 1} and got["barrier"] is True
        wire, p2p, rank, size = got["refused"]
        assert "use backend='rpc'" in wire and "send/recv" in p2p
        assert "group membership == gang membership" in rank and "membership" in size
    np.testing.assert_array_equal(a["scatter"], (x0 + x1)[:2])
    np.testing.assert_array_equal(b["scatter"], (x0 + x1)[2:])


def test_fsdp_utils_hsdp_matches_one_process(four):
    """``train/fsdp_utils`` on FSDP2 as HSDP over dp = 2 x fsdp = 2, each
    rank on a quarter of the batch, against the same AdamW steps of the
    unsharded MLP on the whole batch in one process: FSDP2 averages the
    ranks' gradients, so the mean loss's gradient is the same up to
    summation order (held to 1e-6).  Each parameter is sharded over fsdp
    on the dim ``fsdp_spec`` picks (its largest that divides), replicated
    over dp."""
    import torch

    from ray_tpu_torch.parallel import spmd

    losses, params, placements = four["fsdp"]
    model = ranks.mlp(0)
    opt = spmd.adamw(model.parameters(), FSDP["lr"])
    batch = {k: torch.from_numpy(FSDP[k]) for k in ("x", "y")}
    want = []
    for _ in range(FSDP["steps"]):
        opt.zero_grad()
        loss = ranks.mlp_loss(model, batch)
        loss.backward()
        opt.step()
        want.append(loss.item())
    np.testing.assert_allclose(losses, want, rtol=1e-6)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(params[name], p.detach().numpy(), rtol=0, atol=1e-6, err_msg=name)
    assert placements["0.weight"] == "(Replicate(), Shard(dim=0))"  # (12, 8): 12 is the largest
    assert placements["2.weight"] == "(Replicate(), Shard(dim=1))"  # (3, 12): 3 does not divide
    assert placements["2.bias"] == "(Replicate(), Shard(dim=0))"  # (3,): padded, not replicated
