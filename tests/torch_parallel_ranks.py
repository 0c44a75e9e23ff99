"""Rank functions for the port's multi-rank parity tests
(``test_torch_parallel.py``, ``test_zz_torch_parallel.py``).

Each runs in every process that ``ray_tpu_torch.parallel.launch.run_ranks``
starts, so this module imports torch and the port only: a spawned rank
imports it by name, and keeps clear of JAX.  Results travel back as numpy.
"""

import torch

from ray_tpu_torch.models import gpt2, llama, vit
from ray_tpu_torch.models.convert import (
    gpt2_params_from_jax,
    llama_params_from_jax,
    vit_params_from_jax,
)
from ray_tpu_torch.ops.ring_attention import ring_attention
from ray_tpu_torch.parallel import mesh as mesh_mod
from ray_tpu_torch.parallel import spmd

MODELS = {
    "gpt2": (gpt2.GPTConfig, gpt2_params_from_jax, gpt2.param_logical_axes, gpt2.loss_fn),
    "vit": (vit.ViTConfig, vit_params_from_jax, vit.param_logical_axes, vit.loss_fn),
}


def make_mesh(case):
    """A case's mesh: ``MeshConfig(**case["mesh"])``, over
    ``case["slices"]`` slices where given."""
    mc = mesh_mod.MeshConfig(**case["mesh"])
    if case.get("slices"):
        return mesh_mod.make_multislice_mesh(case["slices"], mc, device_type="cpu")
    return mesh_mod.make_mesh(mc, device_type="cpu")


def train_steps(rank, n, cases):
    """For each case, ``steps`` sharded AdamW steps of the model ``kind``
    built from the reference's numpy pytree ``np_params``; rank 0 returns
    each step's loss and gradient norm, the parameters after the last step
    (gathered whole) and any layout error."""
    out = []
    for case in cases:
        config_cls, convert, logical_fn, loss_fn = MODELS[case["kind"]]
        cfg = config_cls.tiny(dtype=torch.float32, **case.get("cfg", {}))
        mesh = make_mesh(case)
        logical = logical_fn(cfg)
        state = spmd.sharded_init(mesh, lambda: convert(case["np_params"], cfg, "cpu"), logical)
        opt = spmd.adamw(state.params.parameters(), case["lr"])
        step = spmd.compile_train_step(loss_fn, opt)
        batch = spmd.shard_batch(mesh, {k: torch.from_numpy(v) for k, v in case["batch"].items()},
                                 shard_seq=case.get("shard_seq", False))
        metrics = []
        for _ in range(case.get("steps", 1)):
            state, m = step(state, batch)
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        params = {n: p.full_tensor().detach().numpy() for n, p in state.params.named_parameters()}
        errors = [tuple(map(str, e)) for e in spmd.layout_errors(mesh, state.params, logical, opt)]
        mesh_mod.set_current_mesh(None)
        out.append({"metrics": metrics, "params": params, "layout": errors} if rank == 0 else None)
    return out


def ring_blocks(rank, n, cases):
    """Ring attention over sp = n on each rank's sequence block of the
    case's (B, S, H, D) q, k, v, and its gradients for the cotangent
    ``do``: rank 0 returns the whole output and gradients."""
    mesh = mesh_mod.make_mesh(mesh_mod.MeshConfig(dp=1, sp=n), device_type="cpu")
    out = []
    for q, k, v, do in cases:
        S = q.shape[1] // n
        blk = lambda a: torch.from_numpy(a[:, rank * S:(rank + 1) * S]).clone()
        q_, k_, v_ = (blk(a).requires_grad_() for a in (q, k, v))
        o = ring_attention(q_, k_, v_, mesh=mesh)
        o.backward(blk(do))
        whole = [torch.cat(_gather(t.detach()), dim=1).numpy() for t in (o, q_.grad, k_.grad, v_.grad)]
        out.append(whole if rank == 0 else None)
    mesh_mod.set_current_mesh(None)
    return out


def _gather(t):
    parts = [torch.empty_like(t) for _ in range(torch.distributed.get_world_size())]
    torch.distributed.all_gather(parts, t.contiguous())
    return parts


def llama_decode(rank, n, case):
    """Greedy decoding of the tiny Llama sharded over ``case["mesh"]``: a
    cached prefill of ``prompt`` and ``steps`` row-wise decode steps; rank 0
    returns the tokens and the last logits."""
    cfg = llama.LlamaConfig.tiny(**case.get("cfg", {}))
    mesh = make_mesh(case)
    model = spmd.shard_module(llama_params_from_jax(case["np_params"], cfg, "cpu"), mesh,
                              llama.param_logical_axes(cfg))
    prompt = torch.from_numpy(case["prompt"]).long()
    B, S0 = prompt.shape
    cache = llama.init_cache(cfg, B, S0 + case["steps"] + 1, "cpu", mesh=mesh)
    logits, cache = llama.forward_cached(model, prompt, cache, 0)
    tokens = [logits.argmax(-1)]
    pos = [S0] * B
    for _ in range(case["steps"]):
        logits, cache = llama.decode_step_rowwise(model, tokens[-1], cache, pos)
        tokens.append(logits.argmax(-1))
        pos = [p + 1 for p in pos]
    mesh_mod.set_current_mesh(None)
    kv_heads = cache["k"].shape[3]
    return (torch.stack(tokens, 1).numpy(), logits.numpy(), kv_heads) if rank == 0 else None


def collectives(rank, n, _=None):
    """Each in-program collective's value and gradient over a dp mesh of
    ``n`` ranks, rank r holding the (2, 4) block of value r + 1."""
    from ray_tpu_torch.parallel import collectives as col

    mesh = mesh_mod.make_mesh(mesh_mod.MeshConfig(dp=n), device_type="cpu")
    x = torch.full((2, 4), float(rank + 1), requires_grad=True)
    got = {}
    y = col.allreduce_sum(x, "dp")
    y.sum().backward()
    got["allreduce"] = (y.detach().numpy(), x.grad.numpy().copy())
    x.grad = None
    g = col.allgather(x, "dp", dim=1)
    (g * torch.arange(g.shape[1]).float()).sum().backward()
    got["allgather"] = (g.detach().numpy(), x.grad.numpy().copy())
    x.grad = None
    p = col.ring_permute(x, "dp")
    (p * (rank + 1)).sum().backward()
    got["ring_permute"] = (p.detach().numpy(), x.grad.numpy().copy())
    x.grad = None
    a = col.all_to_all(x * torch.arange(4).float(), "dp", split_dim=1, concat_dim=0)
    (a * (rank + 1)).sum().backward()
    got["all_to_all"] = (a.detach().numpy(), x.grad.numpy().copy())
    x.grad = None
    v = col.pvary(x, "dp")
    (v * (rank + 1)).sum().backward()
    got["pvary"] = (v.detach().numpy(), x.grad.numpy().copy())
    got["broadcast"] = col.broadcast_from(x.detach(), "dp", root=1).numpy()
    got["reducescatter"] = col.reducescatter_sum(x.detach(), "dp", dim=1).numpy()
    mesh_mod.set_current_mesh(None)
    return got


def api_surface(rank, n, _=None):
    """The reference's public API beside the port's own path, over a tp
    mesh of ``n`` ranks: ``constrain`` (a redistribute for a DTensor under
    a mesh, the identity for a plain tensor, outside a mesh and under
    ``no_constraints``), ``state_shardings`` against the layout that
    ``sharded_init`` gives the tiny GPT-2, and the in-program backend's
    reductions, rank r holding the value r + 1."""
    from torch.distributed.tensor import DTensor, Replicate

    from ray_tpu_torch.parallel import sharding
    from ray_tpu_torch.parallel.collectives import MeshInProgramBackend

    mesh = mesh_mod.make_mesh(mesh_mod.MeshConfig(dp=1, tp=n), device_type="cpu")
    full = torch.arange(32.0).reshape(4, 8)
    x = DTensor.from_local(full, mesh.torch_mesh, [Replicate()], run_check=False)
    got = {}
    y = sharding.constrain(x, ("batch", "heads"))
    got["constrain"] = (str(tuple(y.placements)), torch.equal(y.full_tensor(), full),
                        tuple(y.to_local().shape))
    with sharding.no_constraints():
        got["no_constraints"] = sharding.constrain(x, ("batch", "heads")) is x
    got["plain"] = sharding.constrain(full, ("batch", "heads")) is full
    cfg = gpt2.GPTConfig.tiny(dtype=torch.float32)
    logical = gpt2.param_logical_axes(cfg)
    model = spmd.sharded_init(mesh, lambda: gpt2.init(cfg, torch.Generator().manual_seed(0), "cpu"),
                              logical).params
    want = spmd.state_shardings(mesh, logical)
    got["state_shardings"] = sorted(name for name, p in model.named_parameters()
                                    if tuple(p.placements) != want[name])
    got["sharded_over_tp"] = sum(1 for p in model.parameters() if p.placements[0].is_shard())
    v = torch.full((3,), float(rank + 1))
    got["in_program"] = {op: MeshInProgramBackend.allreduce(v, "tp", op).tolist()
                         for op in ("sum", "mean", "max", "min")}
    mesh_mod.set_current_mesh(None)
    got["outside_a_mesh"] = sharding.constrain(x, ("batch", "heads")) is x
    return got


def mlp(seed):
    """A small MLP with a seeded init, every rank the same."""
    torch.manual_seed(seed)
    return torch.nn.Sequential(torch.nn.Linear(8, 12), torch.nn.Tanh(), torch.nn.Linear(12, 3))


def mlp_loss(model, batch):
    return ((model(batch["x"]) - batch["y"]) ** 2).mean()


def fsdp_steps(rank, n, case):
    """``fsdp_utils``' state and step on the MLP over ``case["mesh"]``,
    each rank on its block of the batch (split over dp then fsdp); rank 0
    returns each step's loss and the parameters gathered whole."""
    from ray_tpu_torch.train import fsdp_utils

    mesh = make_mesh(case)
    state = fsdp_utils.create_train_state(mlp(0), lambda p: spmd.adamw(p, case["lr"]), mesh)
    step = fsdp_utils.make_train_step(mlp_loss, state)
    rows = case["x"].shape[0] // n
    batch = {k: torch.from_numpy(case[k][rank * rows:(rank + 1) * rows]) for k in ("x", "y")}
    losses = []
    for _ in range(case["steps"]):
        state, m = step(state, batch)
        losses.append(m["loss"].item())
    params = {k: p.full_tensor().detach().numpy() for k, p in state["params"].named_parameters()}
    placements = {k: str(p.placements) for k, p in state["params"].named_parameters()}
    mesh_mod.set_current_mesh(None)
    return (losses, params, placements) if rank == 0 else None


def mesh_of_one(rank, n, case):
    """``steps`` AdamW steps of the tiny GPT-2, built from the reference's
    numpy pytree, once as a plain module and once through the mesh path on
    a mesh of this one rank: each step's (loss, gradient norm) of both."""
    cfg = gpt2.GPTConfig.tiny(**case["cfg"])
    batch = {k: torch.from_numpy(v) for k, v in case["batch"].items()}
    out = []
    for sharded in (False, True):
        model = gpt2_params_from_jax(case["np_params"], cfg, "cpu")
        if sharded:
            mesh = mesh_mod.make_mesh(mesh_mod.MeshConfig(dp=1), device_type="cpu")
            model = spmd.sharded_init(mesh, lambda: model, gpt2.param_logical_axes(cfg)).params
            b = spmd.shard_batch(mesh, batch)
        else:
            b = batch
        step = spmd.compile_train_step(gpt2.loss_fn, spmd.adamw(model.parameters(), case["lr"]))
        state, metrics = spmd.TrainState(0, model), []
        for _ in range(case["steps"]):
            state, m = step(state, b)
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
        out.append(metrics)
    mesh_mod.set_current_mesh(None)
    return out


def jobs(rank, n, todo):
    """Several of the functions above in one process group: ``todo`` is
    [(function name, its argument)]; returns their results in order."""
    return [globals()[name](rank, n, arg) for name, arg in todo]
