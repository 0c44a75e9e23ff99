"""Llama-family decoder on PyTorch (port of ``ray_tpu/models/llama.py``).

RMSNorm, rotary embeddings, grouped-query attention (``num_kv_heads`` <
``num_heads`` shares each KV head across ``q_per_kv`` query heads), a SwiGLU
MLP and an optional sliding window (Mistral).  As in the GPT-2 port,
parameters keep the reference's per-layer shapes (``wq`` (E, H, D), ``wk``
and ``wv`` (E, KV, D), ``wo`` (H, D, E), ``w_gate`` and ``w_up`` (E, M),
``w_down`` (M, E)), so converted weights copy slice by slice.  They are
stored in ``param_dtype`` and cast to ``dtype`` at each use; products,
activations and residual adds run in ``dtype``, RMSNorm statistics, RoPE,
softmax and logits in f32: every rounding falls where the reference's
source puts it.

Three paths share the blocks' weights:

- ``forward``/``loss_fn``: the full causal forward (scoring and training);
- ``forward_cached``: Sq new tokens through a fixed (L, B, T, KV, D) KV
  cache at one start position, for prefill and ``generate_kv``'s decode;
- ``decode_step_rowwise`` and ``prefill_into_slot``: continuous batching,
  one token for every cache row at the row's own position, and one prompt
  into one row (``serve/llm.py``'s engine).

The reference donates its cache to each compiled step; here the cache is
updated in place and never copied.  With a ``sliding_window`` the cache may
be a rolling buffer: position t lives in slot t mod T (``rolling_cache_len``).
The reference's ``_cached_attention`` and the attention inside its
``_block_decode_rowwise`` are one function here, ``_cached_attention``, and
its ``_block_cached`` and ``_block_decode_rowwise`` one ``_block_cached``,
which writes the cache at the positions its caller computed once for all
layers.  ``attention_impl="ring"`` is ring attention over a mesh's sp axis
(dense where sp = 1) on the full forward.

Sharded over a mesh (:func:`param_logical_axes`), every path runs on each
rank's blocks as GPT-2's does: ``wq`` and ``wo`` split their heads over tp,
and the MLP its columns; ``wk`` and ``wv`` are replicated (the rule table
maps "kv" to nothing), and each tp rank computes the KV heads its query
heads read, so that its cache holds num_kv_heads / tp heads
(``init_cache(..., mesh=)``).  The attention projection's and the MLP's
partial sums are summed over tp.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.device import resolve_device
from ray_tpu_torch.models.common import bmm_f32, matmul_f32
from ray_tpu_torch.models.xent import next_token_loss
from ray_tpu_torch.ops.attention import NEG_INF, dense_attention
from ray_tpu_torch.ops.ring_attention import ring_attention
from ray_tpu_torch.parallel.collectives import allreduce_sum, pvary
from ray_tpu_torch.parallel.mesh import SP_AXIS, TP_AXIS, Mesh
from ray_tpu_torch.parallel.spmd import local_param, mesh_of


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_seq_len: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    embed_dim: int = 4096
    mlp_dim: int = 11008
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    attention_impl: str = "dense"  # "dense" | "ring" (sp-sharded)
    # sliding-window attention (Mistral-style): > 0 limits every query to
    # the last `sliding_window` keys, in training and in the cached paths.
    # 0 = full causal.
    sliding_window: int = 0
    # recompute each block's activations in the backward pass
    # (torch.utils.checkpoint); no effect without gradients
    remat: bool = True
    xent_chunk: int = 0
    tie_embeddings: bool = False

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @staticmethod
    def llama2_7b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)

    @staticmethod
    def mistral_7b(**kw) -> "LlamaConfig":
        """Mistral-7B shape: GQA (8 KV heads) and a 4096-token sliding
        window over a 32k context."""
        kw.setdefault("vocab_size", 32000)
        kw.setdefault("max_seq_len", 32768)
        kw.setdefault("num_layers", 32)
        kw.setdefault("num_heads", 32)
        kw.setdefault("num_kv_heads", 8)
        kw.setdefault("embed_dim", 4096)
        kw.setdefault("mlp_dim", 14336)
        kw.setdefault("sliding_window", 4096)
        return LlamaConfig(**kw)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        defaults = dict(
            vocab_size=256, max_seq_len=128, num_layers=2, num_heads=4,
            num_kv_heads=2, embed_dim=64, mlp_dim=160,
            dtype=torch.float32, remat=False,
        )
        defaults.update(kw)
        return LlamaConfig(**defaults)


def _check_config(c: LlamaConfig):
    if c.attention_impl not in ("dense", "ring"):
        raise ValueError(f"unknown attention_impl {c.attention_impl!r}")
    if c.attention_impl == "ring" and c.sliding_window:
        raise NotImplementedError(
            "sliding_window with ring attention: window the KV ring "
            "instead (sp shards already bound the lookback)"
        )
    if c.num_heads % c.num_kv_heads:
        raise ValueError(f"num_heads {c.num_heads} is not a multiple of num_kv_heads {c.num_kv_heads}")


def param_logical_axes(config: LlamaConfig) -> dict:
    """Logical axis names of every parameter, keyed by its name in
    ``named_parameters`` (the reference's table, per block and without its
    leading "layers" axis)."""
    blk = {
        "attn_norm": ("embed",),
        "wq": ("embed", "heads", None),
        "wk": ("embed", "kv", None),
        "wv": ("embed", "kv", None),
        "wo": ("heads", None, "embed"),
        "mlp_norm": ("embed",),
        "w_gate": ("embed", "mlp"),
        "w_up": ("embed", "mlp"),
        "w_down": ("mlp", "embed"),
    }
    out = {"tok_embed": ("vocab", "embed")}
    for i in range(config.num_layers):
        out.update({f"blocks.{i}.{k}": v for k, v in blk.items()})
    out["final_norm"] = ("embed",)
    if not config.tie_embeddings:
        out["lm_head"] = ("vocab", "embed")
    return out


_TP_KEPT = ("wq", "wo", "w_gate", "w_up", "w_down")


class _Weights:
    """A block's weights as this rank computes with them (attributes named
    as the block's parameters)."""

    def __init__(self, **w):
        self.__dict__.update(w)


def _weights(block: nn.Module, mesh: Mesh):
    """The tensors a block computes with on this rank: unsharded, the block
    itself; under a mesh, ``wq``/``wo`` and the MLP's tp shards as they lie,
    ``wk``/``wv`` gathered and cut to the KV heads that this rank's query
    heads read, the norms gathered."""
    tp = mesh.size(TP_AXIS)
    if mesh.torch_mesh is None:
        return block
    c = block.config
    if c.num_kv_heads % tp:
        raise ValueError(f"num_kv_heads {c.num_kv_heads} is not divisible by tp {tp}: "
                         "each tp rank computes its query heads' own KV heads")
    kv = c.num_kv_heads // tp
    w = {}
    for name, p in block.named_parameters(recurse=False):
        if name in ("wk", "wv"):
            w[name] = local_param(p, mesh, split=(TP_AXIS,)).narrow(1, mesh.index(TP_AXIS) * kv, kv)
        else:
            w[name] = local_param(p, mesh, keep=(TP_AXIS,) if name in _TP_KEPT else ())
    return _Weights(**w)


def _param(shape, c: LlamaConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=c.param_dtype, device=device))


def _rmsnorm(x, scale, eps):
    """f32 statistics, the result in x.dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def _rope_tables(positions, head_dim: int, theta: float):
    """(cos, sin) of the rotary angles, each (B, S, 1, D/2) in f32, for
    positions (B, S).  The frequencies are taken as the reference takes
    them, exp(-log(theta) * i / half) in f32 in that order:
    theta ** (-i / half) rounds differently."""
    half = head_dim // 2
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    )
    angles = positions[:, :, None].float() * freqs[None, None, :]
    return torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]


def _rotate(x, cos, sin):
    """Rotate-half RoPE of x (B, S, H, D): x's halves times the f32 tables
    promote to f32, and the result is rounded once to x.dtype."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def _rope(x, positions, theta):
    """Rotary embedding over the last dim.  x: (B, S, H, D); positions (B, S)."""
    return _rotate(x, *_rope_tables(positions, x.shape[-1], theta))


class Block(nn.Module):
    """One decoder block: RMSNorm, GQA attention, RMSNorm, SwiGLU MLP."""

    def __init__(self, config: LlamaConfig, device):
        super().__init__()
        c = self.config = config
        E, H, KV, D, M = c.embed_dim, c.num_heads, c.num_kv_heads, c.head_dim, c.mlp_dim
        self.attn_norm = _param((E,), c, device)
        self.wq = _param((E, H, D), c, device)
        self.wk = _param((E, KV, D), c, device)
        self.wv = _param((E, KV, D), c, device)
        self.wo = _param((H, D, E), c, device)
        self.mlp_norm = _param((E,), c, device)
        self.w_gate = _param((E, M), c, device)
        self.w_up = _param((E, M), c, device)
        self.w_down = _param((M, E), c, device)

    def forward(self, x, rope):
        """Full causal attention.  x: (B, S, E) in dtype; rope: the (cos,
        sin) tables of x's positions."""
        mesh = mesh_of(self)
        return _block(x, _weights(self, mesh), rope, self.config, mesh)


def _qkv(x, p: Block, rope, c: LlamaConfig, mesh: Mesh):
    """q (B, S, H, D), k and v (B, S, KV, D) of x, RoPE on q and k (this
    rank's heads under a mesh)."""
    dt = c.dtype
    h = pvary(_rmsnorm(x, p.attn_norm, c.rms_eps), TP_AXIS, mesh=mesh)
    q = _rotate(torch.einsum("bse,ehd->bshd", h, p.wq.to(dt)), *rope)
    k = _rotate(torch.einsum("bse,ekd->bskd", h, p.wk.to(dt)), *rope)
    v = torch.einsum("bse,ekd->bskd", h, p.wv.to(dt))
    return q, k, v


def _out_and_mlp(x, attn, p: Block, c: LlamaConfig, mesh: Mesh):
    """The attention projection's residual add, then the SwiGLU MLP's."""
    dt = c.dtype
    x = x + allreduce_sum(torch.einsum("bshd,hde->bse", attn, p.wo.to(dt)), TP_AXIS, mesh=mesh)
    h = pvary(_rmsnorm(x, p.mlp_norm, c.rms_eps), TP_AXIS, mesh=mesh)
    gate = torch.einsum("bse,em->bsm", h, p.w_gate.to(dt))
    up = torch.einsum("bse,em->bsm", h, p.w_up.to(dt))
    # jax.nn.silu is x * sigmoid(x), rounded to dtype after each op
    return x + allreduce_sum(torch.einsum(
        "bsm,me->bse", gate * torch.sigmoid(gate) * up, p.w_down.to(dt)), TP_AXIS, mesh=mesh)


def _block(x, p: Block, rope, c: LlamaConfig, mesh: Mesh):
    q, k, v = _qkv(x, p, rope, c, mesh)
    if c.q_per_kv > 1:
        # jnp.repeat along heads: each KV head serves q_per_kv adjacent
        # query heads (head h reads KV head h // q_per_kv)
        k = k.repeat_interleave(c.q_per_kv, dim=2)
        v = v.repeat_interleave(c.q_per_kv, dim=2)
    if c.attention_impl == "ring":
        attn = ring_attention(q, k, v, mesh=mesh)
    elif mesh.size(SP_AXIS) > 1:
        raise ValueError("dense attention sees only this rank's sequence block; "
                         "shard the sequence over sp with attention_impl='ring'")
    else:
        attn = dense_attention(q, k, v, window=c.sliding_window)
    return _out_and_mlp(x, attn, p, c, mesh)


class Llama(nn.Module):
    """The decoder.  Parameters are allocated uninitialised on ``device``;
    fill them with :func:`init` or
    :func:`ray_tpu_torch.models.convert.llama_params_from_jax`."""

    def __init__(self, config: LlamaConfig, device="cuda"):
        super().__init__()
        _check_config(config)
        device = resolve_device(device)
        c = self.config = config
        self.tok_embed = _param((c.vocab_size, c.embed_dim), c, device)
        self.blocks = nn.ModuleList(Block(c, device) for _ in range(c.num_layers))
        self.final_norm = _param((c.embed_dim,), c, device)
        if not c.tie_embeddings:
            self.lm_head = _param((c.vocab_size, c.embed_dim), c, device)

    @property
    def head_weight(self):
        """The (V, E) table the head multiplies by (under a mesh, gathered
        whole on every rank)."""
        return local_param(self.tok_embed if self.config.tie_embeddings else self.lm_head,
                           mesh_of(self))

    def embed(self, tokens):
        """tokens (B, S) int → (B, S, E) in dtype.  The lookup of the stored
        table, then the cast: the reference's cast-then-lookup bit for bit."""
        table = local_param(self.tok_embed, mesh_of(self))
        return nn.functional.embedding(tokens, table).to(self.config.dtype)

    def final_norm_weight(self):
        return local_param(self.final_norm, mesh_of(self))

    def features(self, tokens):
        """tokens (B, S) int → final-RMSNorm features (B, S, E) in dtype.
        Under a mesh, tokens are this rank's block, whose positions start at
        its sequence block's offset."""
        c = self.config
        B, S = tokens.shape
        start = mesh_of(self).index(SP_AXIS) * S
        positions = torch.arange(start, start + S, device=tokens.device).expand(B, S)
        rope = _rope_tables(positions, c.head_dim, c.rope_theta)
        x = self.embed(tokens)
        remat = c.remat and torch.is_grad_enabled()
        for block in self.blocks:
            x = checkpoint(block, x, rope, use_reentrant=False) if remat else block(x, rope)
        return _rmsnorm(x, self.final_norm_weight(), c.rms_eps)

    def head(self, x):
        """Features (..., E) → logits (..., V) in f32, from dtype operands
        with f32 accumulation (see ``matmul_f32``)."""
        return matmul_f32(x, self.head_weight.to(self.config.dtype).t())

    def forward(self, tokens):
        """tokens (B, S) int → logits (B, S, vocab) in f32."""
        return self.head(self.features(tokens))


def init(config: LlamaConfig, generator: Optional[torch.Generator] = None,
         device="cuda") -> Llama:
    """A Llama with the reference's initialisation: N(0, 0.02), the
    residual projections ``wo`` and ``w_down`` N(0, 0.02 / sqrt(2 L)), norms
    at 1.  Draws in f32 from ``generator`` (default: seed 0 on ``device``),
    one tensor at a time, and casts to ``param_dtype``; the numbers differ
    from the reference's ``jax.random``."""
    model = Llama(config, device)
    device = model.tok_embed.device
    g = generator if generator is not None else torch.Generator(device=device).manual_seed(0)
    std = 0.02
    resid_std = std / math.sqrt(2 * config.num_layers)

    def normal_(p, s):
        p.copy_(torch.randn(p.shape, generator=g, dtype=torch.float32, device=device) * s)

    with torch.no_grad():
        normal_(model.tok_embed, std)
        for blk in model.blocks:
            for p in (blk.wq, blk.wk, blk.wv, blk.w_gate, blk.w_up):
                normal_(p, std)
            normal_(blk.wo, resid_std)
            normal_(blk.w_down, resid_std)
            blk.attn_norm.fill_(1.0)
            blk.mlp_norm.fill_(1.0)
        model.final_norm.fill_(1.0)
        if not config.tie_embeddings:
            normal_(model.lm_head, std)
    return model


# Next-token cross-entropy, the same contract as gpt2.loss_fn.
loss_fn = next_token_loss


def num_params(config: LlamaConfig) -> int:
    return sum(p.numel() for p in Llama(config, device="meta").parameters())


def flops_per_token(config: LlamaConfig, seq_len: Optional[int] = None) -> float:
    """fwd+bwd FLOPs per token: 6N, N without the embedding table's lookup
    (but with a tied head's product), plus the attention term."""
    c = config
    S = seq_len or c.max_seq_len
    n = num_params(c) - c.vocab_size * c.embed_dim * (0 if c.tie_embeddings else 1)
    return 6.0 * n + 12 * c.num_layers * c.embed_dim * S


def _pick_token(logits, temperature: float, generator: torch.Generator):
    """Greedy (temperature 0: the first maximum, as jnp.argmax) or sampled
    from softmax(logits / temperature).  Sampling draws from ``generator``,
    so it is deterministic for a seed but cannot reproduce the reference's
    jax.random stream."""
    if temperature > 0.0:
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]
    return logits.argmax(dim=-1)


def _prompt(model: Llama, prompt):
    return torch.as_tensor(prompt, dtype=torch.long, device=model.tok_embed.device)


def _generator(model: Llama, generator):
    if generator is not None:
        return generator
    return torch.Generator(device=model.tok_embed.device).manual_seed(0)


@torch.inference_mode()
def generate(model: Llama, prompt, *, max_new_tokens: int = 32,
             temperature: float = 0.0, generator: Optional[torch.Generator] = None):
    """Greedy or sampled decode by full recompute: (B, S) → (B, S +
    max_new_tokens).  The context is padded once to S + max_new_tokens and
    every step runs the whole bucket; causal attention keeps the padding
    beyond the current length out of its readout."""
    tokens = _prompt(model, prompt)
    B, S0 = tokens.shape
    if max_new_tokens <= 0:
        return tokens
    padded = tokens.new_zeros((B, S0 + max_new_tokens))
    padded[:, :S0] = tokens
    g = _generator(model, generator)
    for i in range(max_new_tokens):
        last = model(padded)[:, S0 + i - 1]
        padded[:, S0 + i] = _pick_token(last, float(temperature or 0.0), g)
    return padded


# ---------------------------------------------------------------------------
# KV-cache incremental decoding (the serving fast path)
# ---------------------------------------------------------------------------


def init_cache(config: LlamaConfig, batch_size: int, max_len: int, device="cuda",
               mesh: Optional[Mesh] = None):
    """Fixed-bucket KV cache: {"k", "v"}, each (L, B, max_len, KV, D) zeros
    in dtype.  With ``sliding_window`` it may be a rolling buffer (slot =
    position mod max_len) as short as ``rolling_cache_len``.  For a model
    sharded over ``mesh`` it is this rank's: KV = num_kv_heads / tp."""
    c = config
    device = resolve_device(device)
    kv = c.num_kv_heads // (mesh.size(TP_AXIS) if mesh is not None else 1)
    shape = (c.num_layers, batch_size, max_len, kv, c.head_dim)
    return {
        "k": torch.zeros(shape, dtype=c.dtype, device=device),
        "v": torch.zeros(shape, dtype=c.dtype, device=device),
    }


def rolling_cache_len(config: LlamaConfig, prefill_chunk: int) -> int:
    """Smallest safe rolling-cache length for unbounded windowed decoding:
    ``window + prefill_chunk - 1`` slots guarantee that a wrapped write only
    lands on a position already outside every live query's window."""
    if config.sliding_window <= 0:
        raise ValueError("rolling caches need sliding_window")
    return config.sliding_window + max(1, prefill_chunk) - 1


def _rolling_mask(q_pos, t_idx, T: int, window: int):
    """Validity of rolling-buffer slots: slot s as seen by query position q
    holds position q - ((q - s) mod T), the newest position <= q congruent
    to s; valid iff non-negative and inside the window.  The modulo is
    Python's (``%``, as jnp's), never ``torch.fmod``: q - s is negative for
    slots past q."""
    t_pos = q_pos - (q_pos - t_idx) % T
    return (t_pos >= 0) & (t_pos > q_pos - window)


def _cached_attention(q, k_cache, v_cache, mask, c: LlamaConfig):
    """q (B, Sq, H, D) over a cache's k, v (B, T, KV, D); mask (B or 1,
    Sq, T).  Scores in f32 from dtype operands, masked, f32 softmax,
    probabilities rounded to dtype before the product with v, as the
    reference; but grouped: each KV head serves its q_per_kv query heads
    without the cache being repeated (``jnp.repeat`` would read and write
    q_per_kv times the cache a step).

    Sq > 1 (prefill): one product per (row, KV head) over that head's
    (T, D) keys; the cache is read in place when B == 1 (a slot's prefill)
    and copied once when B > 1.  Sq == 1 (decode, B rows): the queries go
    in block-diagonal form, row (j, g) holding head j·G + g's query in
    columns j·D..(j+1)·D and zeros elsewhere, against each row's whole
    (T, KV·D) cache, read in place.  The zero terms add exactly 0, so
    every dot product keeps its terms; the product does KV times the
    operations, which decode, bound by reading the cache, has to spare.
    The probabilities times each row's whole (T, KV·D) values give every
    head's output on the diagonal blocks."""
    B, Sq, H, D = q.shape
    T, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    if Sq == 1:
        qb = q.new_zeros((B, KV, G, KV, D))
        qb.diagonal(dim1=1, dim2=3).copy_(q.view(B, KV, G, D).permute(0, 2, 3, 1))
        scores = bmm_f32(qb.view(B, H, KV * D), k_cache.view(B, T, KV * D).transpose(1, 2))
    else:
        qg = q.view(B, Sq, KV, G, D).permute(0, 2, 3, 1, 4).reshape(B * KV, G * Sq, D)
        scores = bmm_f32(qg, k_cache.permute(0, 2, 3, 1).reshape(B * KV, D, T))
    scores = scores.view(B, KV, G, Sq, T) / math.sqrt(D)
    scores = torch.where(mask[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(c.dtype)
    if Sq == 1:
        r = torch.bmm(probs.view(B, H, T), v_cache.view(B, T, KV * D)).view(B, KV, G, KV, D)
        return r.diagonal(dim1=1, dim2=3).permute(0, 3, 1, 2).reshape(B, 1, H, D)
    vg = v_cache.permute(0, 2, 1, 3).reshape(B * KV, T, D)
    out = torch.bmm(probs.view(B * KV, G * Sq, T), vg)
    return out.view(B, KV, G, Sq, D).permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


def _block_cached(x, blk: Block, cache_k, cache_v, where, rope, mask, c: LlamaConfig):
    """One block over x (B, Sq, E): writes the new k and v into this
    layer's cache (B, T, KV, D) in place at index ``where`` (shaped like
    k), then attends over the cache under ``mask``."""
    mesh = mesh_of(blk)
    p = _weights(blk, mesh)
    q, k, v = _qkv(x, p, rope, c, mesh)
    cache_k[where] = k
    cache_v[where] = v
    return _out_and_mlp(x, _cached_attention(q, cache_k, cache_v, mask, c), p, c, mesh)


def _last_logits(model: Llama, x):
    """Final RMSNorm and head of the last position only: (B, V) f32."""
    return model.head(_rmsnorm(x[:, -1], model.final_norm_weight(), model.config.rms_eps))


@torch.inference_mode()
def forward_cached(model: Llama, tokens, cache, start: int):
    """Run Sq new tokens (B, Sq) through all layers at absolute positions
    start..start+Sq-1, writing their k and v into ``cache`` in place.
    Returns (last_logits (B, V) f32, cache).

    Without a window the positions must lie inside the cache: the
    reference's dynamic_update_slice would clamp the start and write the
    wrong slots, so the port raises.  With a window the cache is a rolling
    buffer and a chunk longer than it raises."""
    c = model.config
    B, Sq = tokens.shape
    T = cache["k"].shape[2]
    dev = cache["k"].device
    positions = torch.arange(start, start + Sq, device=dev)
    t_idx = torch.arange(T, device=dev)
    if c.sliding_window:
        if Sq > T:
            raise ValueError(
                f"prefill chunk {Sq} exceeds cache length {T}; prefill long prompts in chunks")
        where = (slice(None), positions % T)
        mask = _rolling_mask(positions[:, None], t_idx[None, :], T, c.sliding_window)
    else:
        if start < 0 or start + Sq > T:
            raise ValueError(f"positions {start}..{start + Sq - 1} lie outside the cache's {T} slots")
        where = (slice(None), slice(start, start + Sq))
        mask = t_idx[None, :] <= positions[:, None]
    rope = _rope_tables(positions.expand(B, Sq), c.head_dim, c.rope_theta)
    x = model.embed(tokens)
    for layer, blk in enumerate(model.blocks):
        x = _block_cached(x, blk, cache["k"][layer], cache["v"][layer], where, rope, mask[None], c)
    return _last_logits(model, x), cache


@torch.inference_mode()
def generate_kv(model: Llama, prompt, *, max_new_tokens: int = 32,
                temperature: float = 0.0, generator: Optional[torch.Generator] = None):
    """KV-cache decode: prefill once, then one token a step through the
    cache.  Same contract as :func:`generate`."""
    tokens = _prompt(model, prompt)
    B, S0 = tokens.shape
    if max_new_tokens <= 0:
        return tokens
    temperature = float(temperature or 0.0)
    g = _generator(model, generator)
    cache = init_cache(model.config, B, S0 + max_new_tokens, tokens.device)
    logits, cache = forward_cached(model, tokens, cache, 0)
    nxt = _pick_token(logits, temperature, g)
    out = [tokens, nxt[:, None]]
    for i in range(1, max_new_tokens):
        logits, cache = forward_cached(model, nxt[:, None], cache, S0 + i - 1)
        nxt = _pick_token(logits, temperature, g)
        out.append(nxt[:, None])
    return torch.cat(out, dim=1)


# -- continuous batching (row-wise positions) --------------------------------
# Serving batches sequences at different positions: each cache row b has its
# own length pos[b].  The decode step writes the new k and v at [b, pos[b]]
# and masks attention per row.


@torch.inference_mode()
def decode_step_rowwise(model: Llama, tokens, cache, pos):
    """One token for every row at per-row positions.

    tokens: (B,) int, the last token of each row; pos: (B,) int, its
    absolute position, best given on the host (a sequence, numpy array or
    CPU tensor: it is checked there).  Returns (logits (B, V) f32, cache),
    the cache updated in place.  Rows the caller does not use decode
    garbage into their own rows.  Without a window a position must lie
    inside the cache: the reference's scatter drops an out-of-range write
    silently, the port raises."""
    c = model.config
    B, T = cache["k"].shape[1], cache["k"].shape[2]
    dev = cache["k"].device
    pos = torch.as_tensor(pos)
    if pos.shape != (B,):
        raise ValueError(f"pos has shape {tuple(pos.shape)}, expected ({B},)")
    lo, hi = int(pos.min()), int(pos.max())
    if lo < 0 or (not c.sliding_window and hi >= T):
        raise ValueError(f"positions {lo}..{hi} lie outside the cache's {T} slots")
    pos = pos.to(device=dev, dtype=torch.long)
    t_idx = torch.arange(T, device=dev)
    if c.sliding_window:
        slots = pos % T
        mask = _rolling_mask(pos[:, None], t_idx[None, :], T, c.sliding_window)
    else:
        slots = pos
        mask = t_idx[None, :] <= pos[:, None]
    where = (torch.arange(B, device=dev)[:, None], slots[:, None])
    rope = _rope_tables(pos[:, None], c.head_dim, c.rope_theta)
    x = model.embed(torch.as_tensor(tokens, device=dev)[:, None])
    for layer, blk in enumerate(model.blocks):
        x = _block_cached(x, blk, cache["k"][layer], cache["v"][layer], where, rope, mask[:, None], c)
    return _last_logits(model, x), cache


@torch.inference_mode()
def prefill_into_slot(model: Llama, tokens, cache, slot: int):
    """Prefill one sequence (1, S) into row ``slot`` of the engine's
    (L, B, T, KV, D) cache, through a view of that row.  Returns
    (last-token logits (1, V), cache).  The reference's dynamic slice
    clamps an out-of-range slot; the port raises."""
    if not 0 <= slot < cache["k"].shape[1]:
        raise ValueError(f"slot {slot} outside the cache's {cache['k'].shape[1]} rows")
    row = {name: t[:, slot:slot + 1] for name, t in cache.items()}
    logits, _ = forward_cached(model, tokens, row, 0)
    return logits, cache
