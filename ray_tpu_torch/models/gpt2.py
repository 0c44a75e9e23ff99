"""GPT-2 decoder-only transformer on PyTorch (port of ``ray_tpu/models/gpt2.py``).

Parameters keep the reference's per-layer shapes (``qkv_kernel`` is
(E, 3H, D), ``proj_kernel`` (H, D, E), ...), so converted weights are copied
slice by slice and every product is the same einsum as in the reference.
Parameters are stored in ``param_dtype`` and cast to ``dtype`` at each use;
activations, residual adds and products run in ``dtype``; layernorm, softmax
and the head's logits are f32.

The reference's ``lax.scan`` over stacked layers is a Python loop over
``blocks``; with ``remat`` each block runs under ``torch.utils.checkpoint``
when gradients are taken, as the reference wraps it in ``jax.checkpoint``.
``attention_impl="flash"`` sends attention, forward and backward, through
the port's CUDA flash kernels; "dense" is the plain path and the one a
ragged ``S`` takes.  The reference takes flash at any head dim; on the card
the port's kernels take D = 64 or 128 in f32 or bf16 and raise for any other
shape, so a flash config such as ``GPTConfig.tiny``'s (D = 16) runs only on
the CPU, where attention is the kernels' plain version.  "ring" is ring
attention over the mesh's sp axis (dense where sp = 1).  With
``num_experts`` > 0 every block's MLP is the reference's top-1 (switch)
Mixture-of-Experts (:func:`_moe_mlp`), whose load-balancing aux loss
``loss_fn`` adds.

Sharded over a mesh (``parallel.spmd.sharded_init`` with
:func:`param_logical_axes`), every rank runs the same code on its local
blocks: the batch split over the data axes, the sequence over sp, attention
heads and MLP columns over tp (Megatron's layout), experts over ep.  Each
block takes its weights through ``spmd.local_param``; where the reference
constrains a layout, the collectives are written out: the tp-sharded
products' partial sums are summed over tp (``allreduce_sum``) and their
replicated inputs take the gradients of every shard (``pvary``), the
experts' outputs are summed over ep, ring attention passes K and V round sp,
and the loss is the mean over the whole batch.  Unsharded, each of these is
the identity and the arithmetic is the single-device model's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models.common import block_weights, gelu, layernorm, matmul_f32
from ray_tpu_torch.models.xent import head_loss, split_batch
from ray_tpu_torch.ops.attention import dense_attention
from ray_tpu_torch.ops.flash_attention import sharded_flash_attention_bhsd
from ray_tpu_torch.ops.ring_attention import ring_attention
from ray_tpu_torch.parallel.collectives import allreduce_mean, allreduce_sum, pvary
from ray_tpu_torch.parallel.mesh import EP_AXIS, SP_AXIS, TP_AXIS, Mesh
from ray_tpu_torch.parallel.spmd import local_param, mesh_of


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    vocab_size: int = 50304  # 50257 padded to a multiple of 128
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    embed_dim: int = 768
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.bfloat16  # activation/matmul dtype
    param_dtype: torch.dtype = torch.float32
    attention_impl: str = "dense"  # "dense" | "flash" | "ring" (sp-sharded)
    # recompute each block's activations in the backward pass instead of
    # keeping them (torch.utils.checkpoint); no effect without gradients
    remat: bool = True
    # chunked cross-entropy: the lm_head + logsumexp per sequence chunk of
    # this many tokens (0 = dense)
    xent_chunk: int = 0
    # shapes the reference's compiled layer scan; the port's layer loop is
    # Python and has nothing to unroll, so it keeps it only to read the same
    scan_unroll: int = 1
    # Mixture-of-Experts: num_experts > 0 replaces every block's dense MLP
    # with a top-1 (switch) MoE: dense one-hot dispatch with a per-row
    # expert capacity; tokens past capacity pass through the residual.
    num_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_aux_coeff: float = 0.01  # Switch load-balancing aux loss weight

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def mlp_dim(self) -> int:
        return self.mlp_ratio * self.embed_dim

    @staticmethod
    def gpt2_124m(**kw) -> "GPTConfig":
        return GPTConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "GPTConfig":
        kw.setdefault("vocab_size", 256)
        kw.setdefault("max_seq_len", 128)
        kw.setdefault("num_layers", 2)
        kw.setdefault("num_heads", 4)
        kw.setdefault("embed_dim", 64)
        return GPTConfig(**kw)


def _check_config(c: GPTConfig):
    if c.attention_impl not in ("dense", "flash", "ring"):
        raise ValueError(f"unknown attention_impl {c.attention_impl!r}")


def param_logical_axes(config: GPTConfig) -> dict:
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
    }
    if config.num_experts > 0:
        blk.update({
            "router": ("embed", "expert"),
            "moe_in": ("expert", "embed", "mlp"),
            "moe_out": ("expert", "mlp", "embed"),
        })
    else:
        blk.update({
            "fc_kernel": ("embed", "mlp"),
            "fc_bias": ("mlp",),
            "out_kernel": ("mlp", "embed"),
            "out_bias": ("embed",),
        })
    out = {"wte": ("vocab", "embed"), "wpe": (None, "embed")}
    for i in range(config.num_layers):
        out.update({f"blocks.{i}.{k}": v for k, v in blk.items()})
    out.update({"lnf_scale": ("embed",), "lnf_bias": ("embed",)})
    return out


def _param(shape, c: GPTConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=c.param_dtype, device=device))


def moe_route(h, router, config: GPTConfig, mask=None):
    """The top-1 routing of :func:`_moe_mlp`, all in f32: router
    probabilities (B, S, X), each token's gate (its top probability) and
    expert, its one-hot choice (B, S, X) with padding tokens zeroed, and its
    slot within its row's expert buffer (``pos``: -1 where it chose no
    expert, at or past ``capacity`` where it overflowed)."""
    X = config.num_experts
    logits = torch.einsum("bse,ex->bsx", h.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    gate = probs.amax(dim=-1)
    expert = torch.argmax(probs, dim=-1)
    onehot = F.one_hot(expert, X).float()
    if mask is not None:
        onehot = onehot * mask[..., None].float()
    # position of each token within its row's expert capacity buffer
    pos = torch.cumsum(onehot, dim=1) * onehot - 1.0
    return probs, gate, expert, onehot, pos


def moe_capacity(config: GPTConfig, seq_len: int) -> int:
    """Each expert's buffer per batch row: ceil(cap_factor · S / X)."""
    return max(1, math.ceil(config.moe_capacity_factor * seq_len / config.num_experts))


def _moe_mlp(h, router, moe_in, moe_out, config: GPTConfig, mask=None,
             mesh: Mesh = Mesh.unsharded()):
    """Top-1 (switch) MoE MLP, the reference's ``_moe_mlp``.  h (B, S, E)
    post-norm → (delta (B, S, E) in dtype, aux 0-d f32).

    GShard-style dense dispatch grouped by batch row: each row routes its S
    tokens with per-row expert capacity C = ceil(cap_factor · S / X), so the
    one-hot dispatch tensor is (B, S, X, C).  The dispatch einsum runs in
    f32 and is cast to dtype; the experts' GELU MLP runs in dtype; the
    combine is weighted by the top-1 gate.  Tokens past capacity add
    nothing (the residual carries them).  aux is the Switch
    load-balancing loss X·Σ f_i·P_i (1.0 at perfect balance), f and P means
    over the whole batch.  ``mask`` (B, S) takes padding tokens out of
    routing: they use no capacity and the aux statistics count only real
    tokens.

    Under a mesh every rank routes its tokens to all X experts; ``moe_in``
    and ``moe_out`` are this rank's experts (ep) and MLP columns (tp), whose
    outputs are summed over ep and tp.  The reference adds no explicit
    all_to_all, and neither does this: the tokens are replicated over ep."""
    c = config
    dt = c.dtype
    X = c.num_experts
    C = moe_capacity(c, h.shape[1])
    probs, gate, _, onehot, pos = moe_route(h, router, c, mask)
    disp = torch.where((pos >= 0) & (pos < C), onehot, 0.0)
    pos_idx = pos.clamp(0, C - 1).long()
    disp_bsxc = disp[..., None] * F.one_hot(pos_idx, C).float()
    n_local = moe_in.shape[0]
    if n_local != X:  # this ep rank's experts
        disp_bsxc = disp_bsxc.narrow(2, mesh.index(EP_AXIS) * n_local, n_local)
    experts = (EP_AXIS, TP_AXIS)
    expert_in = torch.einsum("bsxc,bse->bxce", disp_bsxc, pvary(h, experts, mesh=mesh).float()).to(dt)
    hmid = gelu(torch.einsum("bxce,xem->bxcm", expert_in, moe_in.to(dt)))
    expert_out = torch.einsum("bxcm,xme->bxce", hmid, moe_out.to(dt))
    combine = (disp_bsxc * pvary(gate, experts, mesh=mesh)[..., None, None]).to(dt)
    out = allreduce_sum(torch.einsum("bsxc,bxce->bse", combine, expert_out), experts, mesh=mesh)
    data = (*mesh.data_axes, SP_AXIS)
    if mask is None:
        f = allreduce_mean(onehot.mean(dim=(0, 1)), data, mesh=mesh)
        P = allreduce_mean(probs.mean(dim=(0, 1)), data, mesh=mesh)
    else:
        m = mask[..., None].float()
        denom = torch.clamp(allreduce_sum(m.sum(), data, mesh=mesh), min=1.0)
        f = allreduce_sum(onehot.sum(dim=(0, 1)), data, mesh=mesh) / denom
        P = allreduce_sum((probs * m).sum(dim=(0, 1)), data, mesh=mesh) / denom
    aux = X * torch.sum(f * P)
    return out, aux


class Block(nn.Module):
    """One transformer block: attention and a GELU MLP (dense, or the
    switch MoE with ``num_experts`` > 0), pre-norm."""

    def __init__(self, config: GPTConfig, device):
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
        if c.num_experts > 0:
            X = c.num_experts
            self.router = _param((E, X), c, device)
            self.moe_in = _param((X, E, M), c, device)
            self.moe_out = _param((X, M, E), c, device)
        else:
            self.fc_kernel = _param((E, M), c, device)
            self.fc_bias = _param((M,), c, device)
            self.out_kernel = _param((M, E), c, device)
            self.out_bias = _param((E,), c, device)

    def forward(self, x, mask=None):
        """x: (B, S, E) in config.dtype → (x (B, S, E), the MoE aux loss: a
        0-d f32 tensor, None for a dense MLP).  ``mask`` (B, S) reaches only
        the MoE's routing.  Under a mesh, x is this rank's block."""
        c = self.config
        dt = c.dtype
        mesh = mesh_of(self)
        w = block_weights(self, mesh)
        H = w["proj_kernel"].shape[0]  # this rank's heads
        sp = mesh.size(SP_AXIS) > 1
        if sp and c.attention_impl != "ring":
            raise ValueError(f"attention_impl={c.attention_impl!r} sees only this rank's "
                             "sequence block; shard the sequence over sp with 'ring'")
        h = pvary(layernorm(x, w["ln1_scale"], w["ln1_bias"]), TP_AXIS, mesh=mesh)
        if c.attention_impl == "flash" and x.shape[1] % 128 == 0:
            # The kernel reads q, k, v as strided (B, H, S, D) views of the
            # projection's output: q is heads 0..H-1, k H..2H-1, v 2H..3H-1.
            qkv = torch.einsum("bse,ehd->bhsd", h, w["qkv_kernel"].to(dt)) + (
                w["qkv_bias"].to(dt)[None, :, None, :]
            )
            q, k, v = qkv.split(H, dim=1)
            attn = sharded_flash_attention_bhsd(q, k, v, mesh=mesh)
            x = x + allreduce_sum(torch.einsum(
                "bhsd,hde->bse", attn, w["proj_kernel"].to(dt)), TP_AXIS, mesh=mesh
            ) + w["proj_bias"].to(dt)
        else:
            qkv = torch.einsum(
                "bse,ehd->bshd", h, w["qkv_kernel"].to(dt)
            ) + w["qkv_bias"].to(dt)
            q, k, v = qkv.split(H, dim=2)
            if c.attention_impl == "ring":
                attn = ring_attention(q, k, v, mesh=mesh)
            else:
                attn = dense_attention(q, k, v)
            x = x + allreduce_sum(torch.einsum(
                "bshd,hde->bse", attn, w["proj_kernel"].to(dt)), TP_AXIS, mesh=mesh
            ) + w["proj_bias"].to(dt)
        h = layernorm(x, w["ln2_scale"], w["ln2_bias"])
        if c.num_experts > 0:
            if sp:
                raise ValueError("the experts' per-row capacity counts along the whole "
                                 "sequence: GPT-2 with experts runs with sp = 1")
            delta, aux = _moe_mlp(h, w["router"], w["moe_in"], w["moe_out"], c, mask, mesh=mesh)
            return x + delta, aux
        h = pvary(h, TP_AXIS, mesh=mesh)
        h = gelu(torch.einsum("bse,em->bsm", h, w["fc_kernel"].to(dt)) + w["fc_bias"].to(dt))
        return x + allreduce_sum(torch.einsum(
            "bsm,me->bse", h, w["out_kernel"].to(dt)), TP_AXIS, mesh=mesh
        ) + w["out_bias"].to(dt), None


class GPT2(nn.Module):
    """GPT-2 with a head tied to ``wte``.  Parameters are allocated
    uninitialised on ``device``; fill them with :func:`init` or
    :func:`ray_tpu_torch.models.convert.gpt2_params_from_jax`."""

    def __init__(self, config: GPTConfig, device="cuda"):
        super().__init__()
        _check_config(config)
        device = resolve_device(device)
        c = self.config = config
        self.wte = _param((c.vocab_size, c.embed_dim), c, device)
        self.wpe = _param((c.max_seq_len, c.embed_dim), c, device)
        self.blocks = nn.ModuleList(Block(c, device) for _ in range(c.num_layers))
        self.lnf_scale = _param((c.embed_dim,), c, device)
        self.lnf_bias = _param((c.embed_dim,), c, device)

    def embed(self, tokens):
        """tokens (B, S) int → token plus position embedding (B, S, E) in dtype."""
        dt = self.config.dtype
        # The reference casts the table to dtype and then looks up; a cast
        # commutes with the lookup bit for bit, and casting the B·S rows
        # moves fewer bytes than casting the table.  The position add is in
        # dtype, as there.  The forward is the reference's bit for bit; the
        # gradient is not quite: the reference sums the rows of a repeated
        # token into its bf16 table copy, in bf16, where this sums them in
        # f32 and does not round.  Rows of a token seen n times may differ by
        # about n bf16 roundings (2^-9 relative each) of the partial sums.
        # Under a mesh, tokens are this rank's block: its positions start at
        # its sequence block's offset.
        mesh = mesh_of(self)
        S = tokens.shape[1]
        x = F.embedding(tokens, local_param(self.wte, mesh)).to(dt)
        start = mesh.index(SP_AXIS) * S
        return x + local_param(self.wpe, mesh).to(dt)[start: start + S]

    def features(self, tokens):
        """tokens (B, S) int → final-layernorm features (B, S, E) in dtype."""
        return self.features_aux(tokens)[0]

    def features_aux(self, tokens, mask=None):
        """tokens (B, S) int → (final-layernorm features (B, S, E) in dtype,
        the MoE aux loss summed over layers: a 0-d f32 tensor, None for
        dense MLPs).  ``mask`` (B, S) reaches only the MoE's routing."""
        x = self.embed(tokens)
        remat = self.config.remat and torch.is_grad_enabled()
        aux = None
        for block in self.blocks:
            if remat:
                x, a = checkpoint(block, x, mask, use_reentrant=False)
            else:
                x, a = block(x, mask)
            if a is not None:
                aux = a if aux is None else aux + a
        mesh = mesh_of(self)
        return layernorm(x, local_param(self.lnf_scale, mesh), local_param(self.lnf_bias, mesh)), aux

    @property
    def head_weight(self):
        """The (V, E) table the head multiplies by: ``wte``, tied (under a
        mesh, gathered whole on every rank)."""
        return local_param(self.wte, mesh_of(self))

    def head(self, x):
        """Tied lm_head: features (B, S, E) → logits (B, S, V) in f32, from
        dtype operands with f32 accumulation (see ``matmul_f32``)."""
        return matmul_f32(x, self.head_weight.to(self.config.dtype).t())

    def forward(self, tokens):
        """tokens (B, S) int → logits (B, S, vocab) in f32."""
        return self.head(self.features(tokens))


def init(config: GPTConfig, generator: Optional[torch.Generator] = None,
         device="cuda") -> GPT2:
    """A GPT-2 with the reference's initialisation: N(0, 0.02), residual
    projections N(0, 0.02 / sqrt(2 L)), position table N(0, 0.01), norms at
    (1, 0), biases 0.  Draws from ``generator`` (default: seed 0 on
    ``device``); the numbers differ from the reference's ``jax.random``."""
    model = GPT2(config, device)
    device = model.wte.device
    g = generator if generator is not None else torch.Generator(device=device).manual_seed(0)
    std = 0.02
    resid_std = std / math.sqrt(2 * config.num_layers)

    def normal_(p, s):
        noise = torch.randn(p.shape, generator=g, dtype=torch.float32, device=device)
        p.copy_(noise * s)

    with torch.no_grad():
        for blk in model.blocks:
            normal_(blk.qkv_kernel, std)
            normal_(blk.proj_kernel, resid_std)
            if config.num_experts > 0:
                normal_(blk.router, std)
                normal_(blk.moe_in, std)
                normal_(blk.moe_out, resid_std)
                zeros = (blk.ln1_bias, blk.ln2_bias, blk.qkv_bias, blk.proj_bias)
            else:
                normal_(blk.fc_kernel, std)
                normal_(blk.out_kernel, resid_std)
                zeros = (blk.ln1_bias, blk.ln2_bias, blk.qkv_bias, blk.proj_bias,
                         blk.fc_bias, blk.out_bias)
            for p in (blk.ln1_scale, blk.ln2_scale):
                p.fill_(1.0)
            for p in zeros:
                p.zero_()
        normal_(model.wte, std)
        normal_(model.wpe, 0.01)
        model.lnf_scale.fill_(1.0)
        model.lnf_bias.zero_()
    return model


def loss_fn(model: GPT2, batch):
    """Next-token cross-entropy, plus ``moe_aux_coeff`` times the aux loss
    summed over layers where the blocks are MoE.  batch: {"tokens": (B,
    S+1)} or {"inputs", "targets"}, optional "mask" (which also takes
    padding tokens out of the MoE's routing); chunked with
    config.xent_chunk."""
    c = model.config
    inputs, targets, mask = split_batch(batch)
    x, aux = model.features_aux(inputs, mask)
    loss = head_loss(model, x, targets, mask)
    return loss + c.moe_aux_coeff * aux if c.num_experts > 0 else loss


def num_params(config: GPTConfig) -> int:
    c = config
    E, H, D, M, X = c.embed_dim, c.num_heads, c.head_dim, c.mlp_dim, c.num_experts
    per_layer = 4 * E + E * 3 * H * D + 3 * H * D + H * D * E + E
    if X > 0:
        per_layer += E * X + 2 * X * E * M
    else:
        per_layer += E * M + M + M * E + E
    return (c.vocab_size + c.max_seq_len) * E + c.num_layers * per_layer + 2 * E


def flops_per_token(config: GPTConfig, seq_len: Optional[int] = None) -> float:
    """Approximate training FLOPs/token: 6N + attention term, with N
    counting the tied ``wte`` (its head product is real work) and not the
    position table.  A forward pass is a third of it.  With experts, top-1
    routing runs one expert's MLP a token, so 1/X of the experts'
    parameters count."""
    c = config
    s = seq_len or c.max_seq_len
    n = num_params(c) - c.max_seq_len * c.embed_dim
    if c.num_experts > 1:
        moe_ffn = 2 * c.num_layers * c.num_experts * c.embed_dim * c.mlp_dim
        n = n - moe_ffn + moe_ffn // c.num_experts
    return 6 * n + 12 * c.num_layers * c.embed_dim * s
