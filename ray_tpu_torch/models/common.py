"""Numerics shared across model families (port of ``ray_tpu/models/common.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


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


def matmul_f32(a, b):
    """``a @ b`` of low-precision operands with f32 accumulation and an f32
    result, never rounded to the operands' type: the reference's
    ``preferred_element_type=jnp.float32``.

    On a CUDA device bf16 operands go through one bf16 tensor-core product
    with an f32 output (``torch.mm`` with ``out_dtype``).  Elsewhere the
    operands are widened to f32 first; every product of two bf16 values is
    exact in f32, so the result is the same function up to summation order.
    """
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        out = torch.mm(a.reshape(-1, a.shape[-1]), b, out_dtype=torch.float32)
        return out.reshape(*a.shape[:-1], b.shape[-1])
    return torch.matmul(a.float(), b.float())
