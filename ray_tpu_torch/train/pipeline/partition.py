"""Per-stage programs of the MPMD pipeline, built from a ``models.pp``
ModelPartition (port of ``ray_tpu/train/pipeline/partition.py``).

The in-program schedule (``parallel/pipeline.py``) runs the whole step on
every rank of a mesh; here each stage gets its own small set of programs, so
that a stage can live in its own actor process (JaxPP's MPMD shape, arxiv
2412.14374):

- first stage:  fwd(blocks, tail, tokens) -> h
                bwd(blocks, tail, tokens, g_out) -> (g_blocks, g_tail)
- mid stage:    fwd(blocks, h) -> h
                bwd(blocks, h_in, g_out) -> (g_blocks, g_h_in)
- last stage:   fwd_loss(blocks, tail, h_in, targets)
                    -> (loss, (g_blocks, g_tail, g_h_in))
  (forward, loss and the start of the backward fused: 1F1B's last stage
  always runs B right after F for a microbatch, so one program saves a host
  round trip and the activation stash.)

``blocks`` is the stage's module list of blocks and ``tail`` the tail module
(``models.pp``); a gradient tree is a dict of tensors keyed by the module's
``named_parameters`` names, in that order.

The backward recomputes the forward: ``fwd`` runs under ``torch.no_grad()``
and the stash keeps only each microbatch's stage INPUT; ``bwd`` runs the
stage again under ``torch.enable_grad()`` on the detached input and takes
its gradients with ``torch.autograd.grad`` (the reference's ``jax.vjp``).
Stash memory stays O(in-flight microbatches · activation), the 1F1B steady
state, instead of O(layers · activation).

The tied embedding/head tail is replicated on the first and last stages.
Each accumulates its own tail-gradient contribution; at the step's end the
two exchange their RAW sums and both apply ``add(first_side, last_side)`` in
that operand order: with the same optimizer arithmetic on the same inputs
the two tail copies stay equal bit for bit, with no parameter traffic.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, Iterable

import torch
from torch import nn

from ray_tpu_torch.models.pp import ModelPartition, get_partition  # noqa: F401
from ray_tpu_torch.parallel import spmd

Tree = Dict[str, torch.Tensor]


def make_optimizer(spec: dict) -> Callable[[Iterable[nn.Parameter]], torch.optim.Optimizer]:
    """An optimizer factory from a plain-dict spec: ``make_optimizer(spec)(
    params)`` is a torch optimizer over ``params`` with optax's defaults
    and update order (``spmd.sgd``/``adam``/``adamw``); keys past "name"
    and "lr" are optax's keyword names (b1, b2, eps, weight_decay,
    momentum).

    Declarative on purpose: every process (driver, each stage actor, the
    local reference runner) builds the SAME optimizer from the same spec,
    so per-stage optimizer states, the two tail copies' included, evolve
    identically bit for bit.
    """
    kind = spec.get("name", "sgd")
    lr = spec.get("lr", 0.1)
    extra = {k: v for k, v in spec.items() if k not in ("name", "lr")}
    factories = {"sgd": spmd.sgd, "adam": spmd.adam, "adamw": spmd.adamw}
    if kind not in factories:
        raise ValueError(f"unknown optimizer {kind!r} (sgd/adam/adamw)")
    return functools.partial(factories[kind], learning_rate=lr, **extra)


def to_cpu(tree):
    """A tensor, or a dict tree of them, as contiguous CPU tensors: the
    cross-process handoff (the reference's ``to_numpy``).  Copies keep the
    bits; bf16 stays bf16 (no float round trip)."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu").contiguous()
    return {k: to_cpu(v) for k, v in tree.items()}


def to_wire(t: torch.Tensor):
    """A channel-ready view of one handoff tensor: its bytes as a numpy array
    of the same shape, typed by an integer of the element's width (numpy
    has no bf16).  The receiver views them back as the dtype it expects
    (:func:`from_wire`)."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return to_cpu(t).view(ints[t.element_size()]).numpy()


def from_wire(arr, dtype: torch.dtype, device) -> torch.Tensor:
    """The tensor whose bytes :func:`to_wire` sent, as ``dtype`` on ``device``."""
    return torch.from_numpy(arr).view(dtype).to(device)


def _grads(out, g_out, *wrt):
    """Gradients of ``out`` (cotangent ``g_out``; None for a scalar loss)
    with respect to each of ``wrt``: a module (→ a dict over its
    parameters, zeros where unused) or a tensor."""
    groups = [dict(w.named_parameters()) if isinstance(w, nn.Module) else w for w in wrt]
    inputs = [t for g in groups for t in (g.values() if isinstance(g, dict) else (g,))]
    got = iter(torch.autograd.grad(out, inputs, g_out, allow_unused=True))
    res = []
    for g in groups:
        if isinstance(g, dict):
            res.append({k: _zero_if_none(next(got), p) for k, p in g.items()})
        else:
            res.append(_zero_if_none(next(got), g))
    return tuple(res)


def _zero_if_none(grad, like):
    return torch.zeros_like(like) if grad is None else grad


class StagePrograms:
    """The programs of ONE pipeline stage.

    The role follows from (stage_idx, n_stages); ``scale`` is the
    gradient's normalising constant 1/(n_micro·dp), applied once at
    ``apply`` time (each microbatch's loss is a mean, so the summed
    gradients divide by the number of microbatches over all lanes).
    """

    def __init__(self, part: ModelPartition, n_stages: int, stage_idx: int,
                 optimizer_spec: dict, scale: float):
        if n_stages < 2:
            raise ValueError("MPMD pipeline needs n_stages >= 2 "
                             "(single-stage training is the plain path)")
        if not (0 <= stage_idx < n_stages):
            raise ValueError(f"stage_idx {stage_idx} out of range")
        self.part = part
        self.n_stages = n_stages
        self.stage_idx = stage_idx
        self.is_first = stage_idx == 0
        self.is_last = stage_idx == n_stages - 1
        self.optimizer = make_optimizer(optimizer_spec)
        self.scale = scale
        sf, pre = part.stage_fn, part.prelude

        if self.is_first:
            def _fwd(blocks, tail, tokens):
                with torch.no_grad():
                    return sf(blocks, pre(tail, tokens))

            def _bwd(blocks, tail, tokens, g_out):
                with torch.enable_grad():
                    out = sf(blocks, pre(tail, tokens))
                return _grads(out, g_out, blocks, tail)  # (g_blocks, g_tail)

            self.fwd: Callable = _fwd
            self.bwd: Callable = _bwd
        elif not self.is_last:
            def _fwd(blocks, h):
                with torch.no_grad():
                    return sf(blocks, h)

            def _bwd(blocks, h_in, g_out):
                with torch.enable_grad():
                    h = h_in.detach().requires_grad_()
                    out = sf(blocks, h)
                return _grads(out, g_out, blocks, h)  # (g_blocks, g_h_in)

            self.fwd = _fwd
            self.bwd = _bwd
        if self.is_last:
            def _fwd_loss(blocks, tail, h_in, targets):
                with torch.enable_grad():
                    h = h_in.detach().requires_grad_()
                    loss = part.micro_loss(tail, sf(blocks, h), targets)
                return loss.detach(), _grads(loss, None, blocks, tail, h)

            self.fwd_loss = _fwd_loss

    @staticmethod
    def tree_add(a: Tree, b: Tree) -> Tree:
        return {k: a[k] + b[k] for k in a}

    def tree_scale(self, t: Tree) -> Tree:
        """Each leaf times ``scale`` as an f32 scalar, cast back to its dtype."""
        s = torch.tensor(self.scale, dtype=torch.float32)
        return {k: (v * s).to(v.dtype) for k, v in t.items()}

    def init_opt(self, params: nn.Module) -> torch.optim.Optimizer:
        return self.optimizer(params.parameters())

    @staticmethod
    def apply(params: nn.Module, opt: torch.optim.Optimizer, grads: Tree) -> None:
        """One optimizer update of ``params`` (in place) with ``grads``."""
        for name, p in params.named_parameters():
            p.grad = grads[name]
        opt.step()
        opt.zero_grad(set_to_none=True)


def flatten_grads(tree: Tree) -> torch.Tensor:
    """The leaves in their fixed order, concatenated into one f32 vector:
    the wire shape of a stage's dp all-reduce (one collective a stage a
    step instead of one a leaf)."""
    return torch.cat([v.detach().float().reshape(-1) for v in tree.values()])


def unflatten_grads(tree: Tree, flat) -> Tree:
    """Inverse of :func:`flatten_grads` against the same tree's shapes and
    dtypes (``flat`` a tensor or a numpy vector)."""
    flat = torch.as_tensor(flat)
    out, off = {}, 0
    for k, leaf in tree.items():
        n = leaf.numel()
        out[k] = flat[off:off + n].reshape(leaf.shape).to(leaf.device, leaf.dtype)
        off += n
    return out
