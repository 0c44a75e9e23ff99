"""Pipeline parallelism: GPipe microbatching over the pp axis of a mesh (port of
``ray_tpu/parallel/pipeline.py``).

In the reference the stages live on the devices of a ``pp`` mesh axis inside
one XLA program: activations move stage to stage with ``lax.ppermute``, and
JAX derives the backward pipeline through the permutes.  Here every rank of
the pp axis is a process that runs its own stage: the schedule is the same
``n_micro + n_stages - 1`` ticks, each tick every rank runs its stage once and
passes the result on with ``collectives.ring_permute``, whose backward sends
the gradient back the way the activation came; autograd derives the rest.

The stage function ``stage_fn(stage_params, x) -> x`` takes this rank's
stage: the one module of a cut model's ``stages`` (``models.pp``), or a tree
of tensors whose leading dim is the local slice of the per-stage stacked
parameters (laid out with :func:`stage_sharding`), which must be 1.

Every ring permute is a collective, and so is its backward: each rank must
run the backward of every permute, in the same order as the others.  Each
rank therefore keeps the activation it receives in its graph even where its
stage does not use it (the first stage reads its microbatch instead, through
the reference's select), and a rank other than the last starts its backward
from its stage outputs with a zero cotangent.  Every rank then runs the
permutes' backwards from the last tick to the first.

Not ported: the reference's ``_check_vma`` opt-out of shard_map's type check
and the canary test that guards it work around a crash of XLA's CPU backend
in jax 0.9; there is no type check to opt out of here.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
from torch import nn

from ray_tpu_torch.parallel.collectives import allreduce_sum, ring_permute
from ray_tpu_torch.parallel.mesh import PP_AXIS, Mesh, _world
from ray_tpu_torch.parallel.sharding import PartitionSpec, spec_placements
from ray_tpu_torch.parallel.spmd import _local, local_param


def make_pp_mesh(n_stages: int, *, device_type: str = "cuda") -> Optional[Mesh]:
    """A one-axis pipeline mesh over the first ``n_stages`` ranks of the
    default process group (``device_type`` "cuda", an NCCL group with a card
    a rank, unless the caller asks for "cpu").  Every rank of the group
    calls it, since its process groups are made collectively; a rank past
    ``n_stages`` takes no part and gets None.  Raises where the group has
    fewer ranks than stages."""
    from torch.distributed.device_mesh import DeviceMesh

    n, rank = _world(device_type)
    if n < n_stages:
        raise ValueError(f"pipeline needs {n_stages} ranks, have {n}")
    torch_mesh = DeviceMesh(device_type, torch.arange(n_stages), mesh_dim_names=(PP_AXIS,))
    if rank >= n_stages:
        return None
    return Mesh({PP_AXIS: n_stages}, torch_mesh, device_type, {PP_AXIS: rank})


def stage_sharding(mesh: Mesh):
    """DTensor placements for per-stage stacked parameters: the leading
    (stage) dim split over pp, so that each rank holds a slice of one."""
    return spec_placements(mesh, PartitionSpec(PP_AXIS))


def _local_stage(stage_params, mesh: Mesh):
    """This rank's stage: the one module of a module list of stages, or the
    tree of its tensors with the local stage dim (of 1) dropped."""
    if isinstance(stage_params, nn.ModuleList):
        if len(stage_params) != 1:
            raise ValueError(
                f"{len(stage_params)} stages on one rank: each rank of the pp mesh holds "
                "exactly one (stages would be silently dropped)")
        return stage_params[0]
    local = {}
    for name, leaf in stage_params.items():
        t = local_param(leaf, mesh, keep=(PP_AXIS,))
        if t.shape[0] != 1:
            raise ValueError(
                f"stage param {name!r} has {t.shape[0]} stages on one rank — the stacked "
                "leading dim must equal the pp mesh size (got a local slice of "
                f"{t.shape[0]}; stages would be silently dropped)")
        local[name] = t[0]
    return local


def pipeline_apply(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,
    x: torch.Tensor,
    *,
    n_micro: int,
    mesh: Mesh,
) -> torch.Tensor:
    """Run the pipelined forward over the mesh's pp axis.

    x: (n_micro, mb, ...) microbatches, on every rank (only stage 0 reads
    them).  Returns this rank's stage outputs of the last ``n_micro`` ticks,
    (n_micro, mb, ...): on the LAST stage, microbatch m's output at index m.
    A stage's output must have its input's shape and dtype.
    """
    idx, n_stages = mesh.index(PP_AXIS), mesh.size(PP_AXIS)
    local = _local_stage(stage_params, mesh)
    first = torch.tensor(idx == 0, device=x.device)
    buf = torch.zeros_like(x[0])
    outputs = []
    for t in range(n_micro + n_stages - 1):
        # stage 0 ingests microbatch t (zeros once none remain); the other
        # stages take what their neighbour sent.  The select keeps ``buf`` in
        # stage 0's graph: its permute's backward runs there too.
        feed = x[t] if t < n_micro else torch.zeros_like(x[0])
        out = stage_fn(local, torch.where(first, feed, buf))
        if t >= n_stages - 1:  # on the last stage: microbatch t - (n_stages - 1)
            outputs.append(out)
        buf = ring_permute(out, PP_AXIS, shift=1, mesh=mesh)
    return torch.stack(outputs)


def _backward_from_last_stage(outs, loss_of: Callable[[torch.Tensor], torch.Tensor], mesh: Mesh):
    """The backward of the reference's ``psum(where(last, loss, 0))``: the
    last stage's loss gets cotangent 1, once; every other rank's outputs a
    zero cotangent, which drives its share of the permutes' backwards.
    Returns the loss, summed over pp (the last stage's, on every rank)."""
    if mesh.index(PP_AXIS) == mesh.size(PP_AXIS) - 1:
        loss = loss_of(outs)
        torch.autograd.backward(loss)
        loss = loss.detach()
    else:
        torch.autograd.backward(outs, torch.zeros_like(outs))
        loss = torch.zeros((), dtype=torch.float32, device=outs.device)
    return allreduce_sum(loss, PP_AXIS, mesh=mesh)


def pipeline_train_step(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    loss_tail: Callable[[torch.Tensor, Any], torch.Tensor],
    optimizer: torch.optim.Optimizer,
    mesh: Mesh,
    *,
    n_micro: int,
):
    """Build ``step(params, x, y) -> loss``: the pipelined forward, backward
    and one update of ``optimizer`` (built over this rank's ``params``).

    params: this rank's stage (see :func:`pipeline_apply`).  ``loss_tail(
    last_stage_outputs (n_micro, mb, ...), y)`` is evaluated on the last
    stage; the returned loss is its value, on every rank.
    """

    def step(params, x, y):
        optimizer.zero_grad(set_to_none=True)
        outs = pipeline_apply(stage_fn, params, x, n_micro=n_micro, mesh=mesh)
        loss = _backward_from_last_stage(outs, lambda o: loss_tail(o, y), mesh)
        optimizer.step()
        return loss

    return step


def _data_rows(mesh: Mesh, a: torch.Tensor) -> torch.Tensor:
    """This rank's rows of microbatches ``a`` (n_micro, mb, ...): the mb dim
    split over the mesh's data axes, outer axis first."""
    n = mesh.size(mesh.data_axes)
    if n == 1:
        return a
    if a.shape[1] % n:
        raise ValueError(f"microbatch of {a.shape[1]} rows does not divide over the data "
                         f"axes {mesh.data_axes} of size {n}")
    r = 0
    for axis in mesh.data_axes:
        r = r * mesh.size(axis) + mesh.index(axis)
    rows = a.shape[1] // n
    return a[:, r * rows:(r + 1) * rows]


def _sum_tail_grads(tail: nn.Module, mesh: Mesh) -> None:
    """Sum the tail's gradients over pp, in place: the reference's
    shard_map transposes the replicated tail into that sum."""
    if mesh.size(PP_AXIS) == 1:
        return
    group = mesh.group(PP_AXIS)
    with torch.no_grad():
        for p in tail.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            dist.all_reduce(_local(p.grad), group=group)


def tailed_pipeline_train_step(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    prelude: Callable[[Any, torch.Tensor], torch.Tensor],
    loss_tail: Callable[[Any, torch.Tensor, torch.Tensor], torch.Tensor],
    optimizer: torch.optim.Optimizer,
    mesh: Mesh,
    *,
    n_micro: int,
):
    """Pipeline step for models with parameters outside the stages
    (embeddings, final norm, head), composed with the mesh's other axes.

    params: ``{"stages": module list holding this rank's stage, "tail":
    the tail}`` (``models.pp.shard_pp_params``), the tail replicated over
    pp.  Manual over pp only: the stage and tail modules take their weights
    through ``spmd.local_param``, so dp, fsdp and tp work as in the
    unpipelined step; each data-parallel rank takes its rows of every
    microbatch.
      prelude(tail, x)        -> activations (n_micro, mb, ...); runs on
                                 every stage, only the first stage's count
      stage_fn(stage, h)      -> h for one stage's layers
      loss_tail(tail, outs, y) -> scalar on the last stage's outputs
    ``step(params, x, y) -> loss`` with x, y (n_micro, mb, S), the same on
    every rank; the tail's gradients are summed over pp before the update,
    so every copy of the tail takes the same one.
    """

    def step(params, x, y):
        optimizer.zero_grad(set_to_none=True)
        tail = params["tail"]
        x, y = _data_rows(mesh, x), _data_rows(mesh, y)
        outs = pipeline_apply(stage_fn, params["stages"], prelude(tail, x), n_micro=n_micro,
                              mesh=mesh)
        loss = _backward_from_last_stage(outs, lambda o: loss_tail(tail, o, y), mesh)
        _sum_tail_grads(tail, mesh)
        optimizer.step()
        return loss

    return step
