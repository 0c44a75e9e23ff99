"""Vision Transformer for image classification on PyTorch (port of
``ray_tpu/models/vit.py``).

The reference's design, kept: patchify is one product over
non-overlapping patches (the same arithmetic as a convolution of stride =
kernel); the encoder blocks are pre-LN with bidirectional attention (no
mask, no class token) and a tanh-GELU MLP; the patch tokens are mean-pooled
into an f32 head whose classes are padded to a multiple of 128.  Attention
is plain PyTorch: scores in f32, softmax in f32 and cast to ``dtype``
before the product with v, as the reference takes them; no flash kernel
runs here (the port's kernels are causal).

Parameters keep the reference's per-layer shapes and are stored in
``param_dtype``, cast to ``dtype`` at each use.  The reference's
``lax.scan`` over stacked layers is a Python loop over ``blocks``; with
``remat`` each block runs under ``torch.utils.checkpoint`` when gradients
are taken, as the reference wraps it in ``jax.checkpoint``.

Sharded over a mesh (:func:`param_logical_axes`, the same vocabulary as
GPT-2's), each rank runs on its block of the batch, with attention heads and
MLP columns split over tp as in GPT-2's blocks; the patch tokens are never
split (sp = 1).  The loss is the mean over the whole batch.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models.common import block_weights, gelu, layernorm
from ray_tpu_torch.parallel.collectives import allreduce_mean, allreduce_sum, pvary
from ray_tpu_torch.parallel.mesh import SP_AXIS, TP_AXIS
from ray_tpu_torch.parallel.spmd import local_param, mesh_of


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1024  # padded to a multiple of 128
    channels: int = 3
    num_layers: int = 12
    num_heads: int = 12
    embed_dim: int = 768
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: bool = True

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.channels * self.patch_size ** 2

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return self.mlp_ratio * self.embed_dim

    @staticmethod
    def vit_b16(**kw) -> "ViTConfig":
        return ViTConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "ViTConfig":
        kw.setdefault("image_size", 32)
        kw.setdefault("patch_size", 8)
        kw.setdefault("num_classes", 128)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("embed_dim", 64)
        return ViTConfig(**kw)


def param_logical_axes(config: ViTConfig) -> dict:
    """Logical axis names of every parameter, keyed by its name in
    ``named_parameters`` (the reference's table, per block and without its
    leading "layers" axis)."""
    blk = {
        "ln1_scale": ("embed",),
        "ln1_bias": ("embed",),
        "qkv_kernel": ("embed", "heads", "kv"),
        "qkv_bias": ("heads", "kv"),
        "proj_kernel": ("heads", "kv", "embed"),
        "proj_bias": ("embed",),
        "ln2_scale": ("embed",),
        "ln2_bias": ("embed",),
        "fc_kernel": ("embed", "mlp"),
        "fc_bias": ("mlp",),
        "out_kernel": ("mlp", "embed"),
        "out_bias": ("embed",),
    }
    out = {
        "patch_kernel": (None, "embed"),  # (patch_dim, E)
        "patch_bias": ("embed",),
        "pos_embed": (None, "embed"),  # (num_patches, E)
    }
    for i in range(config.num_layers):
        out.update({f"blocks.{i}.{k}": v for k, v in blk.items()})
    out.update({"lnf_scale": ("embed",), "lnf_bias": ("embed",),
                "head_kernel": ("embed", "vocab"), "head_bias": ("vocab",)})
    return out


def _param(shape, c: ViTConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=c.param_dtype, device=device))


def patchify(images, config: ViTConfig):
    """(B, H, W, C) → (B, num_patches, patch_dim): non-overlapping patches
    in row-major order, each flattened as (P, P, C); the product that
    follows is the patch-embedding convolution."""
    B = images.shape[0]
    P, S = config.patch_size, config.image_size
    n = S // P
    x = images.reshape(B, n, P, n, P, config.channels)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (B, n, n, P, P, C)
    return x.reshape(B, n * n, config.patch_dim)


class Block(nn.Module):
    """One encoder block: bidirectional attention and a GELU MLP, pre-norm."""

    def __init__(self, config: ViTConfig, device):
        super().__init__()
        c = self.config = config
        E, H, D, M = c.embed_dim, c.num_heads, c.head_dim, c.mlp_dim
        self.ln1_scale = _param((E,), c, device)
        self.ln1_bias = _param((E,), c, device)
        self.qkv_kernel = _param((E, 3 * H, D), c, device)
        self.qkv_bias = _param((3 * H, D), c, device)
        self.proj_kernel = _param((H, D, E), c, device)
        self.proj_bias = _param((E,), c, device)
        self.ln2_scale = _param((E,), c, device)
        self.ln2_bias = _param((E,), c, device)
        self.fc_kernel = _param((E, M), c, device)
        self.fc_bias = _param((M,), c, device)
        self.out_kernel = _param((M, E), c, device)
        self.out_bias = _param((E,), c, device)

    def forward(self, x):
        """x: (B, S, E) in config.dtype → (B, S, E)."""
        c = self.config
        dt, D = c.dtype, c.head_dim
        mesh = mesh_of(self)
        w = block_weights(self, mesh)
        H = w["proj_kernel"].shape[0]  # this rank's heads
        h = pvary(layernorm(x, w["ln1_scale"], w["ln1_bias"]), TP_AXIS, mesh=mesh)
        qkv = torch.einsum("bse,ehd->bshd", h, w["qkv_kernel"].to(dt)) + w["qkv_bias"].to(dt)
        q, k, v = qkv.split(H, dim=2)  # (B, S, H, D) each
        # bidirectional attention: every patch attends to every patch
        q = q.transpose(1, 2) * (1.0 / math.sqrt(D))
        scores = torch.einsum("bhqd,bkhd->bhqk", q.float(), k.float())
        probs = torch.softmax(scores, dim=-1).to(dt)
        o = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        x = x + (allreduce_sum(torch.einsum("bshd,hde->bse", o, w["proj_kernel"].to(dt)), TP_AXIS,
                               mesh=mesh) + w["proj_bias"].to(dt))
        h = pvary(layernorm(x, w["ln2_scale"], w["ln2_bias"]), TP_AXIS, mesh=mesh)
        h = gelu(torch.einsum("bse,em->bsm", h, w["fc_kernel"].to(dt)) + w["fc_bias"].to(dt))
        return x + (allreduce_sum(torch.einsum("bsm,me->bse", h, w["out_kernel"].to(dt)), TP_AXIS,
                                  mesh=mesh) + w["out_bias"].to(dt))


class ViT(nn.Module):
    """ViT with a mean-pooled f32 head.  Parameters are allocated
    uninitialised on ``device``; fill them with :func:`init` or
    :func:`ray_tpu_torch.models.convert.vit_params_from_jax`."""

    def __init__(self, config: ViTConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        c = self.config = config
        E = c.embed_dim
        self.patch_kernel = _param((c.patch_dim, E), c, device)
        self.patch_bias = _param((E,), c, device)
        self.pos_embed = _param((c.num_patches, E), c, device)
        self.blocks = nn.ModuleList(Block(c, device) for _ in range(c.num_layers))
        self.lnf_scale = _param((E,), c, device)
        self.lnf_bias = _param((E,), c, device)
        self.head_kernel = _param((E, c.num_classes), c, device)
        self.head_bias = _param((c.num_classes,), c, device)

    def forward(self, images):
        """images (B, H, W, C) float → logits (B, num_classes) in f32."""
        c = self.config
        dt = c.dtype
        mesh = mesh_of(self)
        if mesh.size(SP_AXIS) > 1:
            raise ValueError("ViT attends over all patches of an image: it runs with sp = 1")
        w = {name: local_param(p, mesh) for name, p in self.named_parameters(recurse=False)}
        x = patchify(images.to(dt), c)
        x = (torch.einsum("bsp,pe->bse", x, w["patch_kernel"].to(dt))
             + w["patch_bias"].to(dt) + w["pos_embed"].to(dt)[None])
        remat = c.remat and torch.is_grad_enabled()
        for block in self.blocks:
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        x = layernorm(x, w["lnf_scale"], w["lnf_bias"])
        pooled = x.mean(dim=1)  # mean-pool patch tokens
        return pooled.float() @ w["head_kernel"].float() + w["head_bias"].float()


def init(config: ViTConfig, generator: Optional[torch.Generator] = None,
         device="cuda") -> ViT:
    """A ViT with the reference's initialisation: N(0, 0.02), residual
    projections N(0, 0.02 / sqrt(2 L)), position table N(0, 0.01), norms at
    (1, 0), biases 0.  Draws from ``generator`` (default: seed 0 on
    ``device``); the numbers differ from the reference's ``jax.random``."""
    model = ViT(config, device)
    device = model.patch_kernel.device
    g = generator if generator is not None else torch.Generator(device=device).manual_seed(0)
    std = 0.02
    resid_std = std / math.sqrt(2 * config.num_layers)

    def normal_(p, s):
        p.copy_(torch.randn(p.shape, generator=g, dtype=torch.float32, device=device) * s)

    with torch.no_grad():
        for blk in model.blocks:
            normal_(blk.qkv_kernel, std)
            normal_(blk.proj_kernel, resid_std)
            normal_(blk.fc_kernel, std)
            normal_(blk.out_kernel, resid_std)
            for p in (blk.ln1_scale, blk.ln2_scale):
                p.fill_(1.0)
            for p in (blk.ln1_bias, blk.ln2_bias, blk.qkv_bias, blk.proj_bias,
                      blk.fc_bias, blk.out_bias):
                p.zero_()
        normal_(model.patch_kernel, std)
        model.patch_bias.zero_()
        normal_(model.pos_embed, 0.01)
        model.lnf_scale.fill_(1.0)
        model.lnf_bias.zero_()
        normal_(model.head_kernel, std)
        model.head_bias.zero_()
    return model


def loss_fn(model: ViT, batch):
    """Mean cross-entropy of the labels.  batch: {"images": (B, H, W, C),
    "labels": (B,)}."""
    logits = model(batch["images"])
    logp = torch.log_softmax(logits, dim=-1)
    mesh = mesh_of(model)
    # every rank holds as many images: the mean of the ranks' means
    return allreduce_mean(-torch.gather(logp, -1, batch["labels"].long()[:, None])[:, 0].mean(),
                          mesh.data_axes, mesh=mesh)


def accuracy(model: ViT, batch):
    """Share of images whose top logit is their label, a 0-d f32 tensor."""
    logits = model(batch["images"])
    mesh = mesh_of(model)
    return allreduce_mean((torch.argmax(logits, dim=-1) == batch["labels"].long()).float().mean(),
                          mesh.data_axes, mesh=mesh)


def num_params(config: ViTConfig) -> int:
    c = config
    E, H, D, M = c.embed_dim, c.num_heads, c.head_dim, c.mlp_dim
    per_layer = 4 * E + E * 3 * H * D + 3 * H * D + H * D * E + E + E * M + M + M * E + E
    return ((c.patch_dim + 1 + c.num_patches) * E + c.num_layers * per_layer + 2 * E
            + E * c.num_classes + c.num_classes)


def flops_per_image(config: ViTConfig) -> float:
    """Training FLOPs an image, counted from the shapes: three times the
    forward's products (patch embedding, qkv, scores, p·v, projection, MLP,
    head), multiply-adds counted as two."""
    c = config
    S, E, M, L = c.num_patches, c.embed_dim, c.mlp_dim, c.num_layers
    per_layer = 2 * S * (3 * E * E + E * E + 2 * E * M) + 2 * 2 * S * S * E
    forward = 2 * S * c.patch_dim * E + L * per_layer + 2 * E * c.num_classes
    return 3.0 * forward
