"""Sharded training over a mesh (port of ``ray_tpu/parallel/spmd.py``).

The reference lays parameters and optimizer state out by the logical-axis
rule table and jits the whole step into one program; XLA inserts the
gradient reductions (all-reduce over dp, reduce-scatter over fsdp) and the
per-layer gathers.  Here nothing is compiled and every rank runs the step
eagerly:

- :func:`sharded_init` builds the model and keeps, of each parameter, this
  rank's shard as a ``DTensor`` laid out by the rule table
  (``tree_shardings``); the optimizer built over those parameters then
  keeps its state sharded the same way (AdamW's moments are made like
  their parameters);
- :func:`shard_batch` keeps this rank's block of the batch: the batch dim
  over the data axes, optionally the sequence over ``sp``;
- the models run on each rank's local blocks, as the reference's kernels
  run under ``shard_map``: each block takes its weights through
  :func:`local_param`, which gathers a parameter over every axis the
  computation does not split (``keep``) and sums its gradient over the
  axes whose ranks see other data, reduce-scattered over fsdp and summed
  over dp and sp; the activations' collectives (tp and ep sums, ring
  attention over sp) are written out in the blocks;
- :func:`compile_train_step` takes the loss (a mean over the whole global
  batch on every rank), its backward, the global gradient norm and one
  optimizer update.

Buffer donation has no torch counterpart: the optimizer updates the
parameters in place, so no second copy of the state is ever made.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.collectives import gather_over, scatter_sum_over
from ray_tpu_torch.parallel.mesh import SP_AXIS, Mesh
from ray_tpu_torch.parallel.sharding import (
    PartitionSpec,
    Rules,
    logical_to_spec,
    spec_placements,
    tree_shardings,
)


class TrainState(NamedTuple):
    """``step``: updates taken so far; ``params``: the model, an
    ``nn.Module``.  The optimizer's state lives in the optimizer that
    :func:`compile_train_step` was given, which updates ``params`` in place
    (the reference donates its old state, so neither keeps it)."""

    step: int
    params: torch.nn.Module


def adamw(params, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> torch.optim.AdamW:
    """``optax.adamw`` as ``torch.optim.AdamW``, with optax's defaults.

    Both decay every parameter (no mask here) by ``learning_rate *
    weight_decay`` of its value before the step and add eps outside the
    square root of the bias-corrected second moment, so one update is the
    same arithmetic.  torch's own default weight decay is 1e-2; optax's,
    kept here, is 1e-4.  Over sharded parameters each moment is a DTensor
    laid out like its parameter, and the update runs torch's multi-tensor
    (foreach) kernels, the default for plain CUDA tensors: left to choose,
    torch steps DTensors one at a time.
    """
    params = list(params)
    sharded = any(isinstance(p, _dtensor()) for p in params) or None
    return torch.optim.AdamW(
        params, lr=learning_rate, betas=(b1, b2), eps=eps, weight_decay=weight_decay,
        foreach=sharded,
    )


def adam(params, learning_rate: float, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> torch.optim.Adam:
    """``optax.adam`` as ``torch.optim.Adam``, with optax's defaults: eps is
    added outside the square root of the bias-corrected second moment, as
    in :func:`adamw`, and DTensor parameters are stepped by the foreach
    kernels."""
    params = list(params)
    sharded = any(isinstance(p, _dtensor()) for p in params) or None
    return torch.optim.Adam(params, lr=learning_rate, betas=(b1, b2), eps=eps, foreach=sharded)


def sgd(params, learning_rate: float, momentum: Optional[float] = None) -> torch.optim.SGD:
    """``optax.sgd`` as ``torch.optim.SGD``: no momentum unless given (its
    trace starts at the first gradient in both), no weight decay."""
    params = list(params)
    sharded = any(isinstance(p, _dtensor()) for p in params) or None
    return torch.optim.SGD(params, lr=learning_rate, momentum=momentum or 0.0, foreach=sharded)


def _dtensor():
    from torch.distributed.tensor import DTensor

    return DTensor


def global_norm(tensors) -> torch.Tensor:
    """L2 norm of all elements of ``tensors`` together, in f32, as
    ``optax.global_norm`` takes it.  Over DTensors it is the norm of the
    whole tensors: each local sum of squares is summed over the mesh axes
    that shard its tensor (the replicated ones hold copies)."""
    DTensor = _dtensor()
    tensors = list(tensors)
    if not any(isinstance(t, DTensor) for t in tensors):
        return torch.sqrt(sum(t.float().square().sum() for t in tensors))
    sums, torch_mesh = {}, None
    for t in tensors:
        torch_mesh = t.device_mesh
        dims = tuple(i for i, pl in enumerate(t.placements) if pl.is_shard())
        sq = t.to_local().float().square().sum()
        sums[dims] = sq if dims not in sums else sums[dims] + sq
    total = None
    for dims, s in sums.items():
        for i in dims:
            dist.all_reduce(s, group=torch_mesh.get_group(i))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _local(x):
    return x.to_local() if isinstance(x, _dtensor()) else x


def compile_train_step(
    loss_fn: Callable[[torch.nn.Module, Any], torch.Tensor],
    optimizer: torch.optim.Optimizer,
):
    """Build ``step(state, batch) -> (state, {"loss", "grad_norm"})``.

    ``loss_fn(params, batch)`` returns a scalar loss; ``optimizer`` holds
    the parameters of ``params``.  One step takes the gradients of the loss,
    their global norm and one optimizer update.  The batch's tensors may be
    DTensors from :func:`shard_batch`: the loss then sees this rank's
    blocks, and a sharded model returns the loss of the whole batch on every
    rank.  The metrics are 0-d tensors on the device, so a caller reads them
    without forcing a synchronisation until it needs the value.
    """

    def step(state: TrainState, batch):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(state.params, {k: _local(v) for k, v in batch.items()})
        loss.backward()
        grads = [p.grad for p in state.params.parameters() if p.grad is not None]
        gnorm = global_norm(grads)
        optimizer.step()
        return (
            TrainState(state.step + 1, state.params),
            {"loss": loss.detach(), "grad_norm": gnorm},
        )

    return step


# -- the mesh ----------------------------------------------------------------

_UNSHARDED = Mesh.unsharded()


def mesh_of(module: torch.nn.Module) -> Mesh:
    """The mesh ``module``'s parameters were sharded over by
    :func:`shard_module`, or the unsharded mesh (every axis 1, every
    collective the identity) for a module that holds plain tensors."""
    return module.__dict__.get("_spmd_mesh", _UNSHARDED)


def _gather(t, p, keep):
    """The local block ``t`` of DTensor ``p`` gathered over every mesh dim
    that shards it and is not in ``keep`` (names), innermost dim first: a
    dim sharded by several mesh dims is split by the outer one first."""
    tm = p.device_mesh
    for i in reversed(range(tm.ndim)):
        pl = p.placements[i]
        if pl.is_shard() and tm.mesh_dim_names[i] not in keep and tm.size(i) > 1:
            t = gather_over(t, tm.get_group(i), pl.dim)
    return t


class _LocalParam(torch.autograd.Function):
    """A DTensor parameter's block as the computation uses it (see
    :func:`local_param`): the forward gathers, the backward sums the
    gradient over the ``summed`` mesh dims and keeps this rank's shard of
    it, and hands the parameter a DTensor gradient laid out like it."""

    @staticmethod
    def forward(ctx, p, keep, summed):
        ctx.p_spec = p._spec
        ctx.keep, ctx.summed = keep, summed
        return _gather(p.to_local(), p, keep)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor

        spec = ctx.p_spec
        tm, placements = spec.mesh, spec.placements
        for i, pl in enumerate(placements):  # outermost first: the gather's inverse
            name, n = tm.mesh_dim_names[i], tm.size(i)
            if n == 1 or name in ctx.keep:
                continue
            if name in ctx.summed:
                if pl.is_shard():
                    g = scatter_sum_over(g, tm.get_group(i), pl.dim)
                else:
                    g = g.contiguous()
                    dist.all_reduce(g, group=tm.get_group(i))
            elif pl.is_shard():
                g = g.chunk(n, dim=pl.dim)[tm.get_local_rank(i)]
        # the parameter's own spec: no new DTensorSpec, no autograd wrapper
        return DTensor(g.contiguous(), spec, requires_grad=False), None, None


def local_param(p, mesh: Mesh, keep=(), split=()):
    """The tensor this rank computes with from parameter ``p``.

    A plain tensor is returned as it is.  A DTensor is gathered over every
    mesh axis but those in ``keep``, whose shards the computation uses as
    they lie.  Its gradient is summed over the axes whose ranks compute on
    other data (the data axes and sp) and over ``split``: axes along which
    the caller slices the gathered tensor, each rank using only its slice
    (so each rank's gradient holds only that slice's part); summed over an
    axis that shards ``p``, it is reduce-scattered.  Over the remaining
    axes (tp, ep outside ``keep`` and ``split``) every rank computes the
    same thing, and each keeps its own shard of the gradient.
    """
    if not isinstance(p, _dtensor()):
        return p
    keep = tuple(keep)
    if not torch.is_grad_enabled():
        return _gather(p.to_local(), p, keep)
    summed = tuple(set(mesh.data_axes) | {SP_AXIS} | set(split))
    return _LocalParam.apply(p, keep, summed)


def _check_divisible(mesh: Mesh, name: str, shape, logical, rules: Optional[Rules]):
    """The reference's pre-check: a clear error naming the parameter and
    the axis, before any sharding."""
    spec = logical_to_spec(logical, rules)
    for dim, axis in zip(shape, spec):
        if axis is None:
            continue
        n = mesh.size(axis)
        if n > 1 and dim % n:
            raise ValueError(
                f"param {name} dim of size {dim} (logical axes "
                f"{logical}) is not divisible by mesh axis "
                f"{axis} of size {n}; adjust the model config or "
                "the mesh shape"
            )


def state_shardings(mesh: Mesh, param_logical: Dict[str, tuple],
                    rules: Optional[Rules] = None) -> Dict[str, tuple]:
    """Each parameter's DTensor placements under the rule table; the
    optimizer's moments of a parameter are laid out the same way."""
    return tree_shardings(mesh, param_logical, rules)


def layout_errors(mesh: Mesh, module: torch.nn.Module, param_logical: Dict[str, tuple],
                  optimizer: Optional[torch.optim.Optimizer] = None):
    """Every parameter of ``module``, and every optimizer state of one
    shaped like it, that is not laid out as the active rule table says:
    [(name, its placements, the rules' placements)], empty when all are."""
    want = state_shardings(mesh, param_logical)
    bad = []
    for name, p in module.named_parameters():
        if tuple(p.placements) != want[name]:
            bad.append((name, p.placements, want[name]))
        state = optimizer.state.get(p, {}) if optimizer is not None else {}
        for key, t in state.items():
            if getattr(t, "shape", None) == p.shape and tuple(t.placements) != want[name]:
                bad.append((f"{name}.{key}", t.placements, want[name]))
    return bad


def shard_module(module: torch.nn.Module, mesh: Mesh, param_logical: Dict[str, tuple],
                 rules: Optional[Rules] = None) -> torch.nn.Module:
    """Replace every parameter of ``module`` in place by its DTensor over
    ``mesh``, laid out by ``param_logical`` (``{parameter name: logical
    spec}``, covering ``named_parameters`` exactly) under ``rules``.  Every
    rank holds the same full values (the same seed, or the same
    checkpoint); each keeps its own shard, with no communication."""
    from torch.distributed.tensor import distribute_tensor

    named = dict(module.named_parameters())
    if set(named) != set(param_logical):
        raise ValueError(
            f"param_logical does not cover the module's parameters: missing "
            f"{sorted(set(named) - set(param_logical))}, extra "
            f"{sorted(set(param_logical) - set(named))}"
        )
    for name, p in named.items():
        _check_divisible(mesh, name, p.shape, param_logical[name], rules)
    placements = tree_shardings(mesh, param_logical, rules)
    for name, p in named.items():
        owner_name, _, attr = name.rpartition(".")
        owner = module.get_submodule(owner_name)
        dt = distribute_tensor(p.detach(), mesh.torch_mesh, placements[name], src_data_rank=None)
        setattr(owner, attr, torch.nn.Parameter(dt, requires_grad=p.requires_grad))
    for m in module.modules():
        m.__dict__["_spmd_mesh"] = mesh
    return module


def sharded_init(mesh: Mesh, init_fn: Callable[[], torch.nn.Module],
                 param_logical: Dict[str, tuple], rules: Optional[Rules] = None) -> TrainState:
    """A fresh :class:`TrainState` with the parameters laid out over
    ``mesh``.  ``init_fn()`` builds the full model on the mesh's device and
    must give every rank the same values (a seeded init); each rank keeps
    its shards.  Unlike the reference, which materialises only each
    device's shards, every rank holds the whole model once while it is
    split.  Build the optimizer over ``state.params.parameters()`` after
    this: its state then shards like the parameters."""
    return TrainState(0, shard_module(init_fn(), mesh, param_logical, rules))


def batch_sharding(mesh: Mesh, *, shard_seq: bool = False) -> PartitionSpec:
    """Input batch layout: batch dim over the data axes (dcn, outermost, on
    a multi-slice mesh, then dp and fsdp), optionally seq over sp."""
    data_axes = mesh.data_axes
    if shard_seq:
        return PartitionSpec(data_axes, SP_AXIS)
    return PartitionSpec(data_axes)


def shard_batch(mesh: Mesh, batch, *, shard_seq: bool = False):
    """This rank's block of a host-side batch (a tensor or a dict of them,
    the same on every rank), as DTensors on the mesh's device."""
    from torch.distributed.tensor import distribute_tensor

    spec = batch_sharding(mesh, shard_seq=shard_seq)
    placements = spec_placements(mesh, spec)

    def one(x):
        x = torch.as_tensor(x)
        for dim, axes in enumerate(spec):
            n = mesh.size(axes)
            if x.shape[dim] % n:
                raise ValueError(f"batch dim {dim} of size {x.shape[dim]} is not divisible by "
                                 f"mesh axes {axes} of size {n}")
        return distribute_tensor(x.to(mesh.device_type), mesh.torch_mesh, placements,
                                 src_data_rank=None)

    if isinstance(batch, dict):
        return {k: one(v) for k, v in batch.items()}
    return one(batch)
