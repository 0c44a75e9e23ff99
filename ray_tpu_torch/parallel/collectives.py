"""Collectives over the axes of a mesh (port of
``ray_tpu/parallel/collectives.py``).

In the reference these are XLA ops compiled into a program under
``shard_map``, where the named axes are bound.  Here each runs eagerly over
the process group of this rank's line along a mesh axis (``mesh`` defaults
to the current one); an axis of size 1 makes it the identity.  ``axis`` may
name several axes where the reference takes several (the reductions).

They are differentiable where JAX differentiates the primitive, with the
gradients of shard_map's replication checking: the sum's gradient passes
through unchanged (every rank then holds the same value, and each takes the
loss's gradient once), ``pvary``'s gradient is summed, a gather's gradient
is reduce-scattered and a scatter's gathered, and ``all_to_all`` and
``ring_permute`` send their gradients back the way the values came.
Point-to-point sends carry no autograd of their own, so each is a
``torch.autograd.Function``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import Mesh, current_mesh

AxisName = Union[str, Sequence[str]]


def _mesh(mesh: Optional[Mesh]) -> Mesh:
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None:
        raise RuntimeError("collectives run over a mesh axis: make_mesh first or pass mesh=")
    return mesh


def _groups(mesh: Mesh, axis: AxisName):
    """The process groups of the axes of size > 1 in ``axis``."""
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    return [mesh.group(a) for a in axes if mesh.size(a) > 1]


def _sum(x, groups):
    x = x.clone()
    for g in groups:
        dist.all_reduce(x, group=g)
    return x


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return _sum(x, groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _PVary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.groups), None


def allreduce_sum(x, axis: AxisName, *, mesh: Optional[Mesh] = None):
    """Sum of ``x`` over the ranks of ``axis``."""
    groups = _groups(_mesh(mesh), axis)
    return _AllReduceSum.apply(x, groups) if groups else x


def allreduce_mean(x, axis: AxisName, *, mesh: Optional[Mesh] = None):
    """Mean of ``x`` over the ranks of ``axis``."""
    mesh = _mesh(mesh)
    n = mesh.size(axis)
    return allreduce_sum(x, axis, mesh=mesh) / n if n > 1 else x


def pvary(x, axis: AxisName, *, mesh: Optional[Mesh] = None):
    """``x``, the same on every rank of ``axis``, as an input that each rank
    then uses differently (JAX's ``lax.pvary``): the identity forward, its
    gradient summed over ``axis``.  A block that multiplies a replicated
    activation by its own shard of a weight takes the activation through
    this, so that the activation's gradient collects every shard's part."""
    groups = _groups(_mesh(mesh), axis)
    return _PVary.apply(x, groups) if groups else x


def gather_over(x, group, dim):
    """The blocks of ``x`` from every rank of process group ``group``,
    concatenated along ``dim`` in rank order (no autograd)."""
    n = dist.get_world_size(group)
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def scatter_sum_over(x, group, dim):
    """The sum of ``x`` over process group ``group``, split along ``dim``:
    this rank's block (no autograd)."""
    n = dist.get_world_size(group)
    if dist.get_backend(group) == "gloo":
        # gloo's reduce-scatter is missing from some torch releases
        x = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(x, group=group)
        return x.chunk(n, dim=dim)[dist.get_rank(group)].contiguous()
    parts = x.chunk(n, dim=dim)
    out = torch.empty_like(parts[0], memory_format=torch.contiguous_format)
    dist.reduce_scatter_tensor(out, torch.cat(parts, dim=0), group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return gather_over(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return scatter_sum_over(g, ctx.group, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return scatter_sum_over(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return gather_over(g, ctx.group, ctx.dim), None, None


def allgather(x, axis: str, *, dim: int = 0, tiled: bool = True, mesh: Optional[Mesh] = None):
    """The blocks of ``x`` from every rank of ``axis`` concatenated along
    ``dim`` (``tiled``), or stacked along a new ``dim``."""
    mesh = _mesh(mesh)
    if not tiled:
        x = x.unsqueeze(dim)
    if mesh.size(axis) == 1:
        return x
    return _AllGather.apply(x, mesh.group(axis), dim)


def reducescatter_sum(x, axis: str, *, dim: int = 0, mesh: Optional[Mesh] = None):
    """The sum over the ranks of ``axis``, split along ``dim``: this rank's
    block (the reference's tiled ``psum_scatter``)."""
    mesh = _mesh(mesh)
    if mesh.size(axis) == 1:
        return x
    return _ReduceScatter.apply(x, mesh.group(axis), dim)


def _all_to_all(x, group, split_dim, concat_dim):
    n = dist.get_world_size(group)
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, concat_dim, split_dim)
        return _all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, *ctx.args), None, None, None


def all_to_all(x, axis: str, *, split_dim: int, concat_dim: int, mesh: Optional[Mesh] = None):
    """Split ``x`` along ``split_dim`` into one block per rank of ``axis``,
    send block i to rank i, and concatenate what arrives along
    ``concat_dim`` in rank order (the reference's tiled ``all_to_all``)."""
    mesh = _mesh(mesh)
    if mesh.size(axis) == 1:
        return x
    return _AllToAll.apply(x, mesh.group(axis), split_dim, concat_dim)


def _permute(x, group, shift):
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    x = x.contiguous()
    out = torch.empty_like(x)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, x, dst, group),
                                   dist.P2POp(dist.irecv, out, src, group)])
    for r in reqs:
        r.wait()
    return out


class _RingPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _permute(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group, -ctx.shift), None, None


def ring_permute(x, axis: str, *, shift: int = 1, mesh: Optional[Mesh] = None):
    """Send ``x`` to the neighbour ``shift`` steps ahead on the axis ring
    and return what the neighbour ``shift`` steps behind sent.  Its
    gradient goes the other way round the ring."""
    mesh = _mesh(mesh)
    if mesh.size(axis) == 1:
        return x
    return _RingPermute.apply(x, mesh.group(axis), shift)


def broadcast_from(x, axis: str, *, root: int = 0, mesh: Optional[Mesh] = None):
    """Replicate the value held at ``root`` to all ranks of ``axis``."""
    mesh = _mesh(mesh)
    if mesh.size(axis) == 1:
        return x
    held = x if mesh.index(axis) == root else torch.zeros_like(x)
    return allreduce_sum(held, axis, mesh=mesh)


def barrier(x, axis: AxisName, *, mesh: Optional[Mesh] = None):
    """Rendezvous of the ranks of ``axis``; returns ``x``.  The reference
    threads a 1-element sum through ``x`` so that XLA keeps it; an eager
    collective runs regardless, and ``x`` passes through unchanged."""
    tick = torch.ones((), device=x.device)
    for g in _groups(_mesh(mesh), axis):
        dist.all_reduce(tick, group=g)
    return x


class MeshInProgramBackend:
    """The in-program face of the collective-backend registry (registered
    as ``"device_mesh"``): the same op names as the runtime backends, over
    the axes of a mesh inside the program that every rank runs.
    ``init_collective_group`` refuses it for runtime groups."""

    kind = "in_program"

    @staticmethod
    def allreduce(x, axis: AxisName, op: str = "sum", *, mesh: Optional[Mesh] = None):
        if op == "sum":
            return allreduce_sum(x, axis, mesh=mesh)
        if op == "mean":
            return allreduce_mean(x, axis, mesh=mesh)
        if op in ("max", "min"):
            y = x.detach().clone()
            for g in _groups(_mesh(mesh), axis):
                dist.all_reduce(y, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.MIN, group=g)
            return y
        raise ValueError(f"unsupported in-program reduce op {op!r}")

    @staticmethod
    def allgather(x, axis: str, *, dim: int = 0, tiled: bool = True, mesh: Optional[Mesh] = None):
        return allgather(x, axis, dim=dim, tiled=tiled, mesh=mesh)

    @staticmethod
    def reducescatter(x, axis: str, *, dim: int = 0, mesh: Optional[Mesh] = None):
        return reducescatter_sum(x, axis, dim=dim, mesh=mesh)

    @staticmethod
    def broadcast(x, axis: str, *, root: int = 0, mesh: Optional[Mesh] = None):
        return broadcast_from(x, axis, root=root, mesh=mesh)

    @staticmethod
    def barrier(x, axis: AxisName, *, mesh: Optional[Mesh] = None):
        return barrier(x, axis, mesh=mesh)

    @staticmethod
    def all_to_all(x, axis: str, *, split_dim: int, concat_dim: int, mesh: Optional[Mesh] = None):
        return all_to_all(x, axis, split_dim=split_dim, concat_dim=concat_dim, mesh=mesh)

    @staticmethod
    def ring_permute(x, axis: str, *, shift: int = 1, mesh: Optional[Mesh] = None):
        return ring_permute(x, axis, shift=shift, mesh=mesh)
