"""Numerics shared across model families (port of ``ray_tpu/models/common.py``),
and the sharded weights of the GPT-2 and ViT blocks, which share their
parameters' names and layouts."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ray_tpu_torch.parallel.mesh import EP_AXIS, TP_AXIS, Mesh
from ray_tpu_torch.parallel.spmd import local_param


def layernorm(x, scale, bias, eps: float = 1e-5):
    """f32-accumulated LayerNorm returned in x.dtype.  The variance is the
    population variance, as the reference takes it."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def gelu(x):
    """The tanh approximation, which is what ``jax.nn.gelu`` computes by
    default (PyTorch's default is the exact erf form)."""
    return F.gelu(x, approximate="tanh")


def _mm_f32(a, b):
    """2-D ``a @ b`` of bf16 operands, summed in f32 and returned in f32.
    On a CUDA device one bf16 tensor-core product with an f32 output
    (``torch.mm`` with ``out_dtype``); elsewhere the operands are widened to
    f32 first.  Every product of two bf16 values is exact in f32, so both
    are the same function up to summation order."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def bmm_f32(a, b):
    """Batched ``a @ b`` (a: (N, M, K), b: (N, K, P)) with f32 sums and an
    f32 result, for inference: one bf16 tensor-core product with an f32
    output on a CUDA device (``torch.bmm`` with ``out_dtype``, which has no
    derivative), the operands widened to f32 elsewhere, as ``_mm_f32``."""
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _split_bf16(g):
    """An f32 tensor as hi + lo, two bf16 tensors: hi carries g's first 8
    significant bits, lo the next 8, and g - (hi + lo) is below 2^-16 of |g|
    (for |g| above bf16's subnormal range)."""
    hi = g.to(torch.bfloat16)
    # one pass: the difference is taken in f32 and rounded as it is stored
    return hi, torch.sub(g, hi, out=torch.empty_like(hi))


class _MatmulF32(torch.autograd.Function):
    """bf16 ``a @ b`` with an f32 result, and the reference's gradient.

    JAX's gradient of an einsum with ``preferred_element_type=f32`` takes
    each operand's gradient as the f32 cotangent times the other operand
    widened to f32, in f32, rounded once to the operand's dtype.  Taken so on
    the card, the lm-head's two backward products run off the tensor cores
    (about 1.27 TFLOP in f32 a GPT-2-124M step).  Here the cotangent is split
    into hi + lo bf16 terms (``_split_bf16``) and each gradient is two bf16
    tensor-core products summed in f32: since the other operand is exactly
    bf16, that is the reference's f32 product up to summation order and a
    residual below 2^-16 of each term, before the one rounding to bf16.
    The backward is this formula on every device; only ``_mm_f32`` differs.
    """

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        hi, lo = _split_bf16(g)
        da = db = None
        if ctx.needs_input_grad[0]:
            bt = b.t()
            da = (_mm_f32(hi, bt) + _mm_f32(lo, bt)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            at = a.t()
            db = (_mm_f32(at, hi) + _mm_f32(at, lo)).to(b.dtype)
        return da, db


def matmul_f32(a, b):
    """``a @ b`` with f32 accumulation and an f32 result, never rounded to
    the operands' type: the reference's ``preferred_element_type=jnp.float32``.
    a: (..., K), b: (K, N).

    bf16 operands go through :class:`_MatmulF32`, whose backward is defined
    explicitly (``torch.mm`` with ``out_dtype`` has no derivative); f32
    operands are a plain f32 product.
    """
    if a.dtype == b.dtype == torch.float32:
        return torch.matmul(a, b)
    if not a.dtype == b.dtype == torch.bfloat16:
        raise ValueError(f"matmul_f32 takes bf16 or f32 operands, got {a.dtype}, {b.dtype}")
    out = _MatmulF32.apply(a.reshape(-1, a.shape[-1]), b)
    return out.reshape(*a.shape[:-1], b.shape[-1])


# Weights whose tp (and, for the experts, ep) shards a block multiplies by
# as they lie: the products' outputs are this rank's heads, MLP columns or
# experts.
_TP_KEPT = {"proj_kernel": (TP_AXIS,), "fc_kernel": (TP_AXIS,), "fc_bias": (TP_AXIS,),
            "out_kernel": (TP_AXIS,), "moe_in": (EP_AXIS, TP_AXIS), "moe_out": (EP_AXIS, TP_AXIS)}


def head_aligned(t, mesh: Mesh, num_heads: int):
    """This tp rank's q, k and v heads of a gathered (..., 3H, D) qkv
    weight: heads r·H/tp .. (r+1)·H/tp - 1 of each of q, k and v.

    The rule table shards the 3H dim over tp as one block, which would give
    rank 0 all the q heads and some of k; GSPMD reshards around the split,
    but a local split must see its own heads of each."""
    tp = mesh.size(TP_AXIS)
    if tp == 1:
        return t
    dim = t.dim() - 2
    h = num_heads // tp
    r = mesh.index(TP_AXIS)
    return t.unflatten(dim, (3, num_heads)).narrow(dim + 1, r * h, h).flatten(dim, dim + 1)


def block_weights(block: torch.nn.Module, mesh: Mesh) -> dict:
    """The tensors a GPT-2 or ViT block computes with on this rank: under a
    mesh, each parameter gathered over every axis but those in
    ``_TP_KEPT``, and the qkv weights' own heads; unsharded, the parameters
    themselves."""
    H = block.config.num_heads
    w = {}
    for name, p in block.named_parameters(recurse=False):
        if name in ("qkv_kernel", "qkv_bias"):
            w[name] = head_aligned(local_param(p, mesh, split=(TP_AXIS,)), mesh, H)
        else:
            w[name] = local_param(p, mesh, keep=_TP_KEPT.get(name, ()))
    return w
