"""Weights from the reference package into the port's models.

The reference keeps a model's parameters as a pytree: top-level arrays
(GPT-2: ``wte`` (V, E), ``wpe`` (S, E), ``lnf_scale``/``lnf_bias`` (E,);
Llama: ``tok_embed`` (V, E), ``final_norm`` (E,), ``lm_head`` (V, E) unless
tied; ViT: ``patch_kernel`` (P, E), ``patch_bias``, ``pos_embed`` (N, E),
``lnf_scale``/``lnf_bias``, ``head_kernel`` (E, K), ``head_bias``) and
``blocks``, whose every leaf is stacked over layers with a leading L
(GPT-2 with experts: ``router`` (L, E, X), ``moe_in`` (L, X, E, M) and
``moe_out`` (L, X, M, E) in place of the dense MLP's four leaves).  The port's modules keep the same per-layer shapes, so layer i of each
leaf is copied as it is.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ray_tpu_torch.models.gpt2 import GPT2, GPTConfig
from ray_tpu_torch.models.llama import Llama, LlamaConfig
from ray_tpu_torch.models.vit import ViT, ViTConfig


def _load(model: nn.Module, np_params, top, num_layers: int):
    """Copy the reference pytree ``np_params`` into ``model``: each name in
    ``top`` into the attribute of that name, each stacked block leaf layer
    by layer into ``model.blocks``."""

    def copy(dst: torch.Tensor, src, name: str):
        arr = np.array(src, dtype=np.float32)  # a writable copy
        if arr.shape != tuple(dst.shape):
            raise ValueError(f"{name}: shape {arr.shape}, expected {tuple(dst.shape)}")
        dst.copy_(torch.from_numpy(arr))

    blocks = np_params["blocks"]
    expected = {n for n, _ in model.blocks[0].named_parameters()}
    if set(blocks) != expected:
        raise ValueError(
            f"block params {sorted(blocks)} do not match the port's {sorted(expected)}"
        )
    with torch.no_grad():
        for name in top:
            copy(getattr(model, name), np_params[name], name)
        for name, stacked in blocks.items():
            stacked = np.asarray(stacked, dtype=np.float32)
            if stacked.shape[0] != num_layers:
                raise ValueError(
                    f"blocks.{name}: {stacked.shape[0]} layers, expected {num_layers}"
                )
            for i, blk in enumerate(model.blocks):
                copy(getattr(blk, name), stacked[i], f"blocks.{name}[{i}]")
    return model


def gpt2_params_from_jax(np_params, config: GPTConfig, device="cuda") -> GPT2:
    """A :class:`GPT2` on ``device`` holding ``np_params``: the reference's
    pytree of arrays, each convertible by ``np.asarray`` (numpy arrays, or
    JAX arrays fetched to the host); with ``config.num_experts`` > 0 the
    blocks carry the MoE leaves."""
    return _load(GPT2(config, device), np_params, ("wte", "wpe", "lnf_scale", "lnf_bias"),
                 config.num_layers)


def llama_params_from_jax(np_params, config: LlamaConfig, device="cuda") -> Llama:
    """A :class:`Llama` on ``device`` holding the reference's Llama pytree
    ``np_params`` (arrays convertible by ``np.asarray``)."""
    top = ("tok_embed", "final_norm") + (() if config.tie_embeddings else ("lm_head",))
    return _load(Llama(config, device), np_params, top, config.num_layers)


def vit_params_from_jax(np_params, config: ViTConfig, device="cuda") -> ViT:
    """A :class:`ViT` on ``device`` holding the reference's ViT pytree
    ``np_params`` (arrays convertible by ``np.asarray``): ``blocks`` is
    unstacked into the module list."""
    top = ("patch_kernel", "patch_bias", "pos_embed", "lnf_scale", "lnf_bias",
           "head_kernel", "head_bias")
    return _load(ViT(config, device), np_params, top, config.num_layers)



def _np(t) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()


def _stacked(blocks) -> dict:
    """Every block leaf stacked over ``blocks``, as the reference keeps it."""
    return {name: np.stack([_np(getattr(blk, name)) for blk in blocks])
            for name, _ in blocks[0].named_parameters()}


def params_to_jax(model: nn.Module) -> dict:
    """The way back: ``model``'s parameters as the reference's pytree of f32
    numpy arrays, each top-level parameter under its name and every block
    leaf stacked over layers under ``blocks``."""
    out = {name: _np(p) for name, p in model.named_parameters(recurse=False)}
    out["blocks"] = _stacked(model.blocks)
    return out


_FROM_JAX = {"gpt2": gpt2_params_from_jax, "llama": llama_params_from_jax}


def pp_params_from_jax(np_pp_params, partition, device="cuda") -> nn.ModuleDict:
    """The port's cut (``models.pp``) of the reference's cut pytree
    ``{"stages": leaves (n_stages, L / n_stages, ...), "tail": ...}`` for
    ``partition`` (a ``models.pp.ModelPartition``), on ``device``."""
    stages = np_pp_params["stages"]
    n_stages = {np.shape(v)[0] for v in stages.values()}
    if len(n_stages) != 1:
        raise ValueError(f"stage leaves disagree on the stage count: {sorted(n_stages)}")
    blocks = {k: np.reshape(v, (-1,) + np.shape(v)[2:]) for k, v in stages.items()}
    model = _FROM_JAX[partition.name]({**np_pp_params["tail"], "blocks": blocks}, partition.config,
                                      device)
    return partition.to_pp(model, n_stages.pop())


def pp_params_to_jax(pp_params: nn.ModuleDict) -> dict:
    """The way back from :func:`pp_params_from_jax`: a cut model as the
    reference's cut pytree of f32 numpy arrays."""
    stages = pp_params["stages"]
    blocks = _stacked([blk for stage in stages for blk in stage])
    return {"stages": {k: v.reshape((len(stages), -1) + v.shape[1:]) for k, v in blocks.items()},
            "tail": {name: _np(p) for name, p in pp_params["tail"].named_parameters(recurse=False)}}


# -- RLlib modules (rllib/core.py's MLP, models/catalog.py's CNN, SAC) -------
#
# The reference keeps an RL module as ``{"layers": [{"w", "b"}, ...], "pi":
# {"w", "b"}, "vf": {"w", "b"}}`` (dense ``w`` as (din, dout)), a CNN adding
# ``"conv": [{"w" (k, k, cin, cout) HWIO, "b"}, ...]``, and SAC's learner the
# composite ``{"pi", "q1", "q2", "q1_t", "q2_t": module trees, "log_alpha":
# scalar}``.  The port's modules keep those names as their state dict's
# (``layers.0.w``, ``q1_t.pi.b``, ...); a convolution's kernel is OIHW.

def rl_state_from_jax(np_params) -> dict:
    """The reference's RL pytree as the port's state dict of f32 CPU
    tensors (convolution kernels HWIO -> OIHW), bit for bit."""
    out = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}{k}.")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}{i}.")
        else:
            a = np.array(node, dtype=np.float32)  # a writable copy
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            out[prefix[:-1]] = torch.from_numpy(np.ascontiguousarray(a))

    walk(np_params, "")
    return out


def rl_params_from_jax(np_params, module_config, device="cuda") -> nn.Module:
    """The port's module for ``module_config`` (``MLPModuleConfig`` or
    ``CNNModuleConfig``) on ``device`` holding the reference's pytree;
    SAC's composite gives a ``rllib.sac.SACModules``."""
    from ray_tpu_torch.rllib import core
    from ray_tpu_torch.rllib.sac import SACModules

    if "q1" in np_params:
        pi, q1, q2 = (core.module_init(module_config, None, device) for _ in range(3))
        module = SACModules(pi, q1, q2, 1.0)
    else:
        module = core.module_init(module_config, None, device)
    module.load_state_dict(rl_state_from_jax(np_params))
    return module


def rl_params_to_jax(module: nn.Module) -> dict:
    """The way back from :func:`rl_params_from_jax`: the module's state as
    the reference's pytree of f32 numpy arrays (lists for ``layers`` and
    ``conv``, kernels OIHW -> HWIO), bit for bit."""
    tree: dict = {}
    for name, t in module.state_dict().items():
        a = _np(t)
        if a.ndim == 4:
            a = np.ascontiguousarray(a.transpose(2, 3, 1, 0))
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = a

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)
