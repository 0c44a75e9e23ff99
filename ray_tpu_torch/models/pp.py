"""Pipeline-parallel cut of the transformer families (port of ``ray_tpu/models/pp.py``).

The cut of a model into ``n_stages`` stages is expressed once, as a
:class:`ModelPartition`, and both pipeline schedules consume it:

- the in-program schedule here (``gpt2_pp_train_step`` /
  ``llama_pp_train_step``): each rank of the mesh's pp axis holds one stage,
  driven by ``parallel.pipeline.tailed_pipeline_train_step``; the embedding
  prelude runs on every stage, activations pass stage to stage per
  microbatch, and the final norm, head and cross-entropy run on the last
  stage;
- the MPMD schedule (``ray_tpu_torch.train.pipeline``): each stage is an
  actor that runs its own programs (``train/pipeline/partition.py``) built
  from the same partition, so the two schedules cannot drift on what a stage
  is.

The reference cuts scan-stacked leaves, reshaping each (L, ...) into
(n_stages, L / n_stages, ...).  The port's models hold a module list of
blocks, so the cut gives each stage its run of block modules, and the tail
is a module holding every parameter outside ``blocks``.  A cut model is an
``nn.ModuleDict`` ``{"stages": ModuleList of stages (each a ModuleList of
blocks), "tail": Tail}``; :func:`split_stages` and the tail share the
model's parameters, so cutting and merging copy nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch.models import gpt2 as gpt2_mod
from ray_tpu_torch.models import llama as llama_mod
from ray_tpu_torch.models.common import layernorm, matmul_f32
from ray_tpu_torch.parallel.collectives import allreduce_mean
from ray_tpu_torch.parallel.mesh import PP_AXIS, Mesh
from ray_tpu_torch.parallel.pipeline import tailed_pipeline_train_step
from ray_tpu_torch.parallel.sharding import PartitionSpec
from ray_tpu_torch.parallel.spmd import local_param, mesh_of, shard_module


# -- stage splitting ---------------------------------------------------------


def split_stages(blocks: nn.ModuleList, n_stages: int) -> nn.ModuleList:
    """L blocks → ``n_stages`` module lists of L / n_stages consecutive blocks
    (the same block modules)."""
    L = len(blocks)
    if L % n_stages:
        raise ValueError(f"{L} layers not divisible into {n_stages} pipeline stages")
    per = L // n_stages
    return nn.ModuleList(nn.ModuleList(blocks[s * per:(s + 1) * per]) for s in range(n_stages))


def merge_stages(stages: nn.ModuleList) -> nn.ModuleList:
    """Inverse of :func:`split_stages`."""
    return nn.ModuleList(block for stage in stages for block in stage)


class Tail(nn.Module):
    """A model's parameters outside ``blocks`` (embeddings, final norm, an
    untied head): the model's own parameter objects, under their names."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.config = model.config
        for name, p in model.named_parameters(recurse=False):
            self.register_parameter(name, p)


def _to_pp(model: nn.Module, n_stages: int) -> nn.ModuleDict:
    """The cut: ``{"stages": split_stages(blocks), "tail": Tail(model)}``
    (the reference's ``gpt2_to_pp``/``llama_to_pp``)."""
    return nn.ModuleDict({"stages": split_stages(model.blocks, n_stages), "tail": Tail(model)})


def _from_pp(model_cls):
    """The merge back into a ``model_cls`` holding the cut's parameters (the
    reference's ``gpt2_from_pp``/``llama_from_pp``)."""

    def from_pp(pp_params: nn.ModuleDict) -> nn.Module:
        tail = pp_params["tail"]
        model = model_cls(tail.config, device="meta")
        model.blocks = merge_stages(pp_params["stages"])
        for name, p in tail.named_parameters(recurse=False):
            setattr(model, name, p)
        return model

    return from_pp


def pp_params_sharding(pp_params: nn.ModuleDict) -> Dict[str, PartitionSpec]:
    """Where each parameter of a cut model lives over a mesh, as the
    reference lays it out: a stage's parameters split on their stage index
    over pp (``PartitionSpec("pp")``: the ranks at pp coordinate s hold
    stage s), the tail's replicated (``PartitionSpec()``).  The rule table
    refines both over the other axes (:func:`shard_pp_params`)."""
    return {name: PartitionSpec(PP_AXIS) if name.startswith("stages.") else PartitionSpec()
            for name, _ in pp_params.named_parameters()}


def stage_logical_axes(param_logical: dict, n_blocks: int) -> dict:
    """The logical axes of a stage's parameters (``"{i}.{leaf}"`` for its
    block i) from the model's table (``"blocks.{j}.{leaf}"``)."""
    block = {k[len("blocks.0."):]: v for k, v in param_logical.items() if k.startswith("blocks.0.")}
    return {f"{i}.{k}": v for i in range(n_blocks) for k, v in block.items()}


def tail_logical_axes(param_logical: dict) -> dict:
    """The logical axes of the tail's parameters from the model's table."""
    return {k: v for k, v in param_logical.items() if not k.startswith("blocks.")}


def shard_pp_params(mesh: Mesh, pp_params: nn.ModuleDict, param_logical: Optional[dict] = None,
                    rules=None) -> nn.ModuleDict:
    """This rank's part of the cut model ``pp_params`` (the same full values
    on every rank), as :func:`pp_params_sharding` says: stage
    ``mesh.index("pp")`` alone in ``stages``, and the tail.  With
    ``param_logical`` (the model's ``param_logical_axes``) both are laid out
    over the mesh's other axes by the rule table (``spmd.shard_module``);
    over pp each rank's stage is its own, and the pipeline is manual there,
    as the reference's shard_map is."""
    n = mesh.size(PP_AXIS)
    stages = pp_params["stages"]
    if len(stages) != n:
        raise ValueError(f"{len(stages)} stages for a pp axis of size {n}")
    stage, tail = stages[mesh.index(PP_AXIS)], pp_params["tail"]
    if param_logical is not None:
        shard_module(stage, mesh, stage_logical_axes(param_logical, len(stage)), rules)
        shard_module(tail, mesh, tail_logical_axes(param_logical), rules)
    else:
        for m in (*stage.modules(), *tail.modules()):
            m.__dict__["_spmd_mesh"] = mesh
    return nn.ModuleDict({"stages": nn.ModuleList([stage]), "tail": tail})


# -- the reusable partition --------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelPartition:
    """One model family's pipeline cut, schedule-agnostic.

    ``prelude(tail, tokens) -> h`` embeds microbatches (the FIRST stage's
    under MPMD, on every stage in-program); ``stage_fn(stage_blocks, h) ->
    h`` runs one stage's blocks; ``loss_tail(tail, outs, targets) ->
    scalar`` evaluates the final norm, head and cross-entropy on the LAST
    stage's outputs, ``outs`` (n_micro, mb, S, E) and ``targets`` (n_micro,
    mb, S).  ``to_pp(model, n_stages)`` / ``from_pp(pp_params)`` cut and
    merge a model; ``init(generator, device)`` builds the family's fresh
    model and ``empty(device)`` one with uninitialised parameters (on
    "meta", the layout alone).  The partition carries all knowledge of the
    family, so registering one here is all ``train.pipeline`` needs.
    """

    name: str
    config: Any
    prelude: Callable[[nn.Module, torch.Tensor], torch.Tensor]
    stage_fn: Callable[[nn.ModuleList, torch.Tensor], torch.Tensor]
    loss_tail: Callable[[nn.Module, torch.Tensor, torch.Tensor], torch.Tensor]
    to_pp: Callable[[nn.Module, int], nn.ModuleDict]
    from_pp: Callable[[nn.ModuleDict], nn.Module]
    init: Callable[..., nn.Module]
    empty: Callable[[Any], nn.Module]
    param_logical_axes: Callable[[], dict]

    def micro_loss(self, tail: nn.Module, h: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Per-microbatch loss: ``loss_tail`` over one microbatch (``h`` (mb,
        S, E), ``targets`` (mb, S)), so both schedules share one loss."""
        return self.loss_tail(tail, h[None], targets[None])

    def stage_layout(self, n_stages: int, stage_idx: int, device) -> tuple:
        """Stage ``stage_idx``'s block list and a tail, with uninitialised
        parameters on ``device`` (to be filled with ``load_state_dict``)."""
        pp = self.to_pp(self.empty("meta"), n_stages)
        return pp["stages"][stage_idx].to_empty(device=device), pp["tail"].to_empty(device=device)


def _xent(logits, targets, mesh: Mesh):
    """−mean(target logit − logsumexp) in f32; under a mesh the mean over
    every data-parallel rank's rows."""
    lse = torch.logsumexp(logits, dim=-1)
    tl = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return allreduce_mean(-(tl - lse).mean(), mesh.data_axes, mesh=mesh)


# -- GPT-2 -------------------------------------------------------------------


def gpt2_partition(config: gpt2_mod.GPTConfig) -> ModelPartition:
    """The GPT-2 cut: embedding prelude, block slices, a tied-head
    cross-entropy tail with f32 logits."""
    c = config

    def prelude(tail, tokens):
        mesh = mesh_of(tail)
        x = F.embedding(tokens, local_param(tail.wte, mesh)).to(c.dtype)
        return x + local_param(tail.wpe, mesh).to(c.dtype)[:tokens.shape[-1]]

    def stage_fn(stage_blocks, h):
        for block in stage_blocks:
            h, _aux = block(h)  # like the reference, MoE's aux is dropped
        return h

    def loss_tail(tail, outs, targets):
        mesh = mesh_of(tail)
        x = layernorm(outs, local_param(tail.lnf_scale, mesh), local_param(tail.lnf_bias, mesh))
        # bf16 operands, f32 sums and result (matmul_f32), never a bf16
        # product cast up
        logits = matmul_f32(x, local_param(tail.wte, mesh).to(c.dtype).t())
        return _xent(logits, targets, mesh)

    return ModelPartition(
        name="gpt2", config=c, prelude=prelude, stage_fn=stage_fn, loss_tail=loss_tail,
        to_pp=_to_pp, from_pp=_from_pp(gpt2_mod.GPT2),
        init=lambda generator=None, device="cuda": gpt2_mod.init(c, generator, device),
        empty=lambda device: gpt2_mod.GPT2(c, device),
        param_logical_axes=lambda: gpt2_mod.param_logical_axes(c),
    )


def gpt2_pp_train_step(config: gpt2_mod.GPTConfig, mesh: Mesh, optimizer, *, n_micro: int):
    """Pipelined GPT-2 train step over the mesh's pp axis:
    ``step(pp_params, tokens, targets) -> loss`` with this rank's part of
    the cut model (``shard_pp_params``) and (n_micro, mb, S) microbatches;
    ``optimizer`` holds ``pp_params``' parameters."""
    p = gpt2_partition(config)
    return tailed_pipeline_train_step(p.stage_fn, p.prelude, p.loss_tail, optimizer, mesh,
                                      n_micro=n_micro)


# -- Llama -------------------------------------------------------------------


def llama_partition(config: llama_mod.LlamaConfig) -> ModelPartition:
    """The Llama cut (GQA blocks, RMSNorm tail, tied or untied head)."""
    c = config

    def prelude(tail, tokens):
        return F.embedding(tokens, local_param(tail.tok_embed, mesh_of(tail))).to(c.dtype)

    def stage_fn(stage_blocks, h):
        # every stage rebuilds the positions of its microbatch
        B, S = h.shape[0], h.shape[1]
        positions = torch.arange(S, device=h.device).expand(B, S)
        rope = llama_mod._rope_tables(positions, c.head_dim, c.rope_theta)
        for block in stage_blocks:
            h = block(h, rope)
        return h

    def loss_tail(tail, outs, targets):
        mesh = mesh_of(tail)
        x = llama_mod._rmsnorm(outs, local_param(tail.final_norm, mesh), c.rms_eps)
        head = tail.tok_embed if c.tie_embeddings else tail.lm_head
        logits = matmul_f32(x, local_param(head, mesh).to(c.dtype).t())
        return _xent(logits, targets, mesh)

    return ModelPartition(
        name="llama", config=c, prelude=prelude, stage_fn=stage_fn, loss_tail=loss_tail,
        to_pp=_to_pp, from_pp=_from_pp(llama_mod.Llama),
        init=lambda generator=None, device="cuda": llama_mod.init(c, generator, device),
        empty=lambda device: llama_mod.Llama(c, device),
        param_logical_axes=lambda: llama_mod.param_logical_axes(c),
    )


def llama_pp_train_step(config: llama_mod.LlamaConfig, mesh: Mesh, optimizer, *, n_micro: int):
    """Pipelined Llama train step over the mesh's pp axis."""
    p = llama_partition(config)
    return tailed_pipeline_train_step(p.stage_fn, p.prelude, p.loss_tail, optimizer, mesh,
                                      n_micro=n_micro)


# -- registry (train.pipeline resolves model families by name) ---------------

PARTITIONS: Dict[str, Callable[[Any], ModelPartition]] = {
    "gpt2": gpt2_partition,
    "llama": llama_partition,
}


def get_partition(model: str, config) -> ModelPartition:
    try:
        factory = PARTITIONS[model]
    except KeyError:
        raise ValueError(
            f"unknown pipeline model family {model!r} "
            f"(registered: {sorted(PARTITIONS)})"
        ) from None
    return factory(config)
