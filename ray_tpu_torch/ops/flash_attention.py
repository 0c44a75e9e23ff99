"""Causal flash attention, forward: a CUDA kernel for Hopper and its plain
PyTorch version.

Port of ``ray_tpu/ops/flash_attention.py``.  The kernel
(``csrc/flash_attention_fwd.cu``) replaces the Pallas kernel ``_fwd_kernel``;
its design note is in that source.  It returns ``o`` and the per-row
log-sum-exp ``lse``, which the backward kernels and ring attention read.

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises.  There is no fallback between the two.

Forward only: the backward kernels (``_dq_kernel``, ``_dkv_kernel``) are not
ported yet, so the wrappers refuse inputs that require grad.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _check_seq_len(S: int):
    """The reference's block rule (``_block_sizes``) refuses S % 128 != 0;
    the port keeps that error, so that both packages take the flash path for
    the same shapes, though its kernel tiles by 64."""
    if S % 128 != 0:
        raise ValueError(
            f"flash_attention requires seq len divisible by 128, got {S}; "
            "use the dense attention path for ragged lengths"
        )


def flash_attention_fwd_reference(q, k, v, scale: float):
    """Plain version of the kernel.  q, k, v: (B, H, S, D) → (o, lse).

    f32 scores, causal mask at -1e30, log-sum-exp, the product with ``v`` in
    f32, ``o`` cast to ``q.dtype``; ``lse`` is (B, H, S) f32.
    """
    S = q.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    pos = torch.arange(S, device=q.device)
    s = torch.where(pos[:, None] >= pos[None, :], s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return o.to(q.dtype), lse


def _check(q, k, v):
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash attention is forward-only in the port until its backward "
            "kernels land; call it under torch.no_grad() or "
            "torch.inference_mode(), or use attention_impl='dense' for training"
        )
    if q.dim() != 4 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            f"q, k, v must share one (B, H, S, D) shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v devices differ: {q.device}, {k.device}, {v.device}")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q, k, v need a unit stride along D")
    _check_seq_len(q.shape[2])


def _launch(q, k, v, scale):
    B, H, S, D = q.shape
    if q.dtype not in _DTYPE_CODES:
        raise ValueError(f"flash attention kernel takes float32 or bfloat16, got {q.dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernel takes head dim 64 or 128, got {D}")
    if any(st < 0 for t in (q, k, v) for st in t.stride()):
        raise ValueError("q, k, v need non-negative strides")
    if q.dtype == torch.bfloat16 and any(
        t.data_ptr() % 16 or any(st % 8 for st in t.stride()[:3]) for t in (q, k, v)
    ):
        raise ValueError(
            "the bf16 kernel reads rows 16 bytes at a time: q, k, v need "
            "16-byte aligned data and strides that are multiples of 8"
        )
    lib = _build.load("flash_attention_fwd")
    fn = lib.flash_attention_fwd
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_int64] * 9
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    o = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    strides = [st for t in (q, k, v) for st in t.stride()[:3]]
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
            B, H, S, D, *strides, float(scale), _DTYPE_CODES[q.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention_fwd kernel launch failed: cudaError {err}")
    flash_attention_fwd.launches += 1
    return o, lse


def flash_attention_fwd(q, k, v, scale: float | None = None):
    """Causal flash attention forward.  q, k, v: (B, H, S, D), any strides
    with unit stride along D → (o (B, H, S, D) in q.dtype, lse (B, H, S) f32).

    Port of the reference's ``_fwd``.  ``launches`` counts kernel launches.
    """
    _check(q, k, v)
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_fwd_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, got {q.device}")
    return _launch(q, k, v, scale)


flash_attention_fwd.launches = 0


def flash_attention_bhsd(q, k, v, scale: float | None = None):
    """Causal flash attention, (B, H, S, D) layout (kernel-native) → o."""
    return flash_attention_fwd(q, k, v, scale)[0]


def flash_attention(q, k, v, scale: float | None = None):
    """Causal flash attention.  q, k, v: (B, S, H, D) → (B, S, H, D).

    The kernel reads the (B, S, H, D) inputs in place through their
    strides; only the transposed views change hands.
    """
    o = flash_attention_bhsd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale
    )
    return o.transpose(1, 2)
