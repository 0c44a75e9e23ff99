"""Rank functions for the port's pipeline parity tests
(``test_torch_pipeline.py``, ``test_zz_torch_pipeline.py``).

Each runs in every process that ``ray_tpu_torch.parallel.launch.run_ranks``
starts, so this module imports torch and the port only: a spawned rank
imports it by name and keeps clear of JAX.  Results travel back as numpy.
"""

import torch

from ray_tpu_torch.models import gpt2, llama, pp
from ray_tpu_torch.models.convert import gpt2_params_from_jax, llama_params_from_jax
from ray_tpu_torch.parallel import mesh as mesh_mod
from ray_tpu_torch.parallel import pipeline as pl
from ray_tpu_torch.parallel import spmd


def tanh_stage(p, x):
    """Pass 3's stage: tanh(x @ w + b)."""
    return torch.tanh(x @ p["w"] + p["b"])


def mse(outs, y):
    return ((outs - y) ** 2).mean()


def gpipe_steps(rank, n, case):
    """Pass 3: ``case["steps"]`` GPipe steps of the tanh stages over a pp
    mesh of ``n`` ranks, the stacked (n, W, W) ``w`` and (n, W) ``b`` laid
    out by ``stage_sharding``, Adam at ``case["lr"]``.  Rank 0 returns the
    losses and the parameters gathered whole; every rank its gradients of
    the first step's loss (its own stage's slice)."""
    from torch.distributed.tensor import distribute_tensor

    mesh = pl.make_pp_mesh(n, device_type="cpu")
    params = {k: torch.nn.Parameter(distribute_tensor(torch.from_numpy(case[k]), mesh.torch_mesh,
                                                      pl.stage_sharding(mesh), src_data_rank=None))
              for k in ("w", "b")}
    opt = spmd.adam(params.values(), case["lr"])
    step = pl.pipeline_train_step(tanh_stage, mse, opt, mesh, n_micro=case["x"].shape[0])
    x, y = torch.from_numpy(case["x"]), torch.from_numpy(case["y"])
    losses, grads = [], None
    for _ in range(case["steps"]):
        losses.append(step(params, x, y).item())
        if grads is None:
            grads = {k: p.grad.to_local().numpy().copy() for k, p in params.items()}
    full = {k: p.full_tensor().detach().numpy() for k, p in params.items()}
    return {"losses": losses, "params": full if rank == 0 else None, "grads": grads}


PARTS = {"gpt2": (gpt2.GPTConfig, gpt2_params_from_jax),
         "llama": (llama.LlamaConfig, llama_params_from_jax)}


def model_pp_steps(rank, n, case):
    """``case["steps"]`` steps of ``{gpt2,llama}_pp_train_step`` over
    ``MeshConfig(**case["mesh"])`` from the reference's numpy pytree
    ``np_params`` (f32), Adam at ``case["lr"]``.  Each rank at dp, fsdp and
    tp coordinate 0 returns its pp index, the losses and its stage's and
    the tail's parameters gathered whole; the others None."""
    config_cls, convert = PARTS[case["kind"]]
    cfg = config_cls.tiny(dtype=torch.float32, **case.get("cfg", {}))
    mesh = mesh_mod.make_mesh(mesh_mod.MeshConfig(**case["mesh"]), device_type="cpu")
    part = pp.get_partition(case["kind"], cfg)
    n_stages = mesh.size("pp")
    params = pp.shard_pp_params(mesh, part.to_pp(convert(case["np_params"], cfg, "cpu"), n_stages),
                                part.param_logical_axes())
    opt = spmd.adam(params.parameters(), case["lr"])
    step_fn = pp.gpt2_pp_train_step if case["kind"] == "gpt2" else pp.llama_pp_train_step
    step = step_fn(cfg, mesh, opt, n_micro=case["x"].shape[0])
    x, y = torch.from_numpy(case["x"]).long(), torch.from_numpy(case["y"]).long()
    losses = [step(params, x, y).item() for _ in range(case["steps"])]

    def whole(module):
        return {k: (p.full_tensor() if isinstance(p, spmd._dtensor()) else p).detach().numpy()
                for k, p in module.named_parameters()}

    stage, tail = whole(params["stages"][0]), whole(params["tail"])
    mesh_mod.set_current_mesh(None)
    if any(mesh.index(a) for a in ("dp", "fsdp", "tp")):
        return None
    return {"pp": mesh.index("pp"), "losses": losses, "stage": stage, "tail": tail}


def too_few_ranks(rank, n, n_stages):
    """make_pp_mesh's error for more stages than ranks."""
    try:
        pl.make_pp_mesh(n_stages, device_type="cpu")
    except ValueError as e:
        return str(e)
    return None


def jobs(rank, n, todo):
    """Several of the functions above in one process group: ``todo`` is
    [(function name, its argument)]; returns their results in order."""
    return [globals()[name](rank, n, arg) for name, arg in todo]
