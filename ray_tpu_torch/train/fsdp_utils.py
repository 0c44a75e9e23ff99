"""FSDP for a user's ``nn.Module`` inside a training loop (port of
``ray_tpu/train/flax_utils.py``).

The reference turns a flax module into a sharded functional train state,
with each parameter's largest dim that divides by the ``fsdp`` size sharded
over ``fsdp`` and everything else replicated.  Here the module stays a
module: :func:`shard_params` applies FSDP2's ``fully_shard`` over the mesh's
data axes as HSDP (replicated over ``dp``, sharded over ``fsdp``), each
parameter sharded on the dim :func:`fsdp_spec` picks.  FSDP2 gathers a
parameter for the forward and backward and reduce-scatters its gradient,
averaged over the data ranks.  A parameter with no such dim is sharded on
its first dim with FSDP2's padding, where the reference replicates it: the
same values, laid out otherwise.

Use inside ``train_loop_per_worker`` on each worker's batch shard::

    state = create_train_state(module, lambda p: spmd.adamw(p, 3e-4), mesh)
    step = make_train_step(loss_fn, state)
    for batch in loader:
        state, metrics = step(state, batch)
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ray_tpu_torch.parallel.mesh import DATA_AXES, DP_AXIS, FSDP_AXIS, Mesh
from ray_tpu_torch.parallel.sharding import PartitionSpec


def fsdp_spec(shape, mesh: Mesh) -> PartitionSpec:
    """Shard the largest dim divisible by the fsdp axis size; replicate
    everything else."""
    n_fsdp = mesh.size(FSDP_AXIS)
    if n_fsdp <= 1 or len(shape) == 0:
        return PartitionSpec()
    dims = sorted(range(len(shape)), key=lambda i: shape[i], reverse=True)
    for d in dims:
        if shape[d] % n_fsdp == 0 and shape[d] >= n_fsdp:
            entry = [None] * len(shape)
            entry[d] = FSDP_AXIS
            return PartitionSpec(*entry)
    return PartitionSpec()


def _fsdp_mesh(mesh: Mesh):
    """FSDP2's (dp, fsdp) mesh over the default group's ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    others = {a: s for a, s in mesh.shape.items() if a not in DATA_AXES and s > 1}
    if others:
        raise ValueError(f"FSDP shards over the data axes only; the mesh also has {others}")
    return init_device_mesh(mesh.device_type, (mesh.size(DP_AXIS), mesh.size(FSDP_AXIS)),
                            mesh_dim_names=(DP_AXIS, FSDP_AXIS))


def shard_params(module: torch.nn.Module, mesh: Optional[Mesh]) -> torch.nn.Module:
    """``fully_shard`` ``module`` over the mesh's data axes (in place;
    returns it); unchanged where there is no mesh."""
    if mesh is None:
        return module
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    def placement(p):
        spec = fsdp_spec(p.shape, mesh)
        return Shard(spec.index(FSDP_AXIS) if FSDP_AXIS in spec else 0)

    fully_shard(module, mesh=_fsdp_mesh(mesh), shard_placement_fn=placement)
    return module


def create_train_state(module: torch.nn.Module,
                       optimizer: Callable[[Any], torch.optim.Optimizer],
                       mesh: Optional[Mesh] = None) -> Dict[str, Any]:
    """Shard ``module`` and build its optimizer over the sharded parameters
    (``optimizer(params)``), whose state is then sharded like them.
    Returns {"params", "optimizer", "step"}."""
    module = shard_params(module, mesh)
    return {"params": module, "optimizer": optimizer(module.parameters()), "step": 0}


def make_train_step(loss_fn: Callable[[torch.nn.Module, Any], torch.Tensor],
                    state: Dict[str, Any]) -> Callable:
    """(state, batch) -> (state, {"loss"}); ``loss_fn(module, batch)`` is
    the mean loss of this rank's batch shard, and the reported loss the
    mean over the data ranks, a 0-d tensor on the device (read it only
    when the value is needed)."""
    optimizer = state["optimizer"]

    def run(st: Dict[str, Any], batch):
        import torch.distributed as dist

        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(st["params"], batch)
        loss.backward()
        optimizer.step()
        loss = loss.detach().clone()
        if dist.is_initialized():
            dist.all_reduce(loss)
            loss /= dist.get_world_size()
        return dict(st, step=st["step"] + 1), {"loss": loss}

    return run
