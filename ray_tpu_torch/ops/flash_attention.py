"""Causal flash attention: CUDA kernels for Hopper and their plain PyTorch
versions, forward and backward.

Port of ``ray_tpu/ops/flash_attention.py``.  Three kernels replace the three
Pallas kernels there; each one's design note is in its source, and their
bf16 versions share the Hopper primitives of ``csrc/hopper.cuh`` (TMA,
mbarriers, wgmma):

- ``csrc/flash_attention_fwd.cu`` replaces ``_fwd_kernel``: o and the per-row
  log-sum-exp ``lse``, which the backward kernels and ring attention read;
- ``csrc/flash_attention_bwd.cu`` replaces ``_dq_kernel`` (dq) and
  ``_dkv_kernel`` (dk, dv), the FlashAttention-2 backward that recomputes
  ``p = exp(s - lse)`` from the saved ``lse``.

``flash_attention_bhsd`` and ``flash_attention`` are differentiable: a
``torch.autograd.Function`` runs the forward kernel and saves (q, k, v, o,
lse); its backward takes ``delta = rowsum(do * o)`` as a torch op, as the
reference takes it outside its kernels, and launches the dq kernel, then the
dk/dv kernel.

On a CPU tensor every wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.  There is no fallback between the two.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _check_seq_len(S: int):
    """The reference's block rule (``_block_sizes``) refuses S % 128 != 0;
    the port keeps that error, so that both packages take the flash path for
    the same shapes, though its kernels tile by 64."""
    if S % 128 != 0:
        raise ValueError(
            f"flash_attention requires seq len divisible by 128, got {S}; "
            "use the dense attention path for ragged lengths"
        )


def _wide(x):
    """x in f32, or in f64 where it already is (the f64 gradient check)."""
    return x if x.dtype == torch.float64 else x.float()


def _scores(q, k, scale):
    """Causal scores in f32 (f64 for f64 inputs), masked at -1e30."""
    S = q.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", _wide(q), _wide(k)) * scale
    pos = torch.arange(S, device=q.device)
    return torch.where(pos[:, None] >= pos[None, :], s, NEG_INF)


def flash_attention_fwd_reference(q, k, v, scale: float):
    """Plain version of the forward kernel.  q, k, v: (B, H, S, D) → (o, lse).

    f32 scores, causal mask at -1e30, log-sum-exp, the product with ``v`` in
    f32, ``o`` cast to ``q.dtype``; ``lse`` is (B, H, S) f32.
    """
    s = _scores(q, k, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum("bhqk,bhkd->bhqd", p, _wide(v))
    return o.to(q.dtype), lse


def _probs_and_ds(q, k, v, do, lse, delta, scale):
    """p = exp(s - lse) and ds = p (dp - delta) scale, both f32 (B, H, S, S),
    with dp = do vᵀ taken in f32 (the reference's l.131-134, l.183-186)."""
    p = torch.exp(_scores(q, k, scale) - lse[..., None])
    dp = torch.einsum("bhqd,bhkd->bhqk", _wide(do), _wide(v))
    return p, p * (dp - delta[..., None]) * scale


def flash_attention_dq_reference(q, k, v, do, lse, delta, scale: float):
    """Plain version of the dq kernel (the reference's ``_dq_kernel``):
    ds is rounded to k's dtype before ``dq = ds k``, which is summed in f32
    and cast to q's dtype once."""
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, scale)
    dq = torch.einsum("bhqk,bhkd->bhqd", _wide(ds.to(k.dtype)), _wide(k))
    return dq.to(q.dtype)


def flash_attention_dkv_reference(q, k, v, do, lse, delta, scale: float):
    """Plain version of the dk/dv kernel (the reference's ``_dkv_kernel``):
    p is rounded to do's dtype before ``dv = pᵀ do`` and ds to q's dtype
    before ``dk = dsᵀ q``; both sums are f32, cast to k's and v's dtype."""
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, scale)
    dv = torch.einsum("bhqk,bhqd->bhkd", _wide(p.to(do.dtype)), _wide(do))
    dk = torch.einsum("bhqk,bhqd->bhkd", _wide(ds.to(q.dtype)), _wide(q))
    return dk.to(k.dtype), dv.to(v.dtype)


def _delta(o, do):
    """rowsum(do * o) in f32 (B, H, S): the reference's l.241-243."""
    return (_wide(do) * _wide(o)).sum(-1)


def flash_attention_bwd_reference(q, k, v, o, lse, do, scale: float):
    """Plain version of the backward (the reference's ``_bwd``).  All
    tensors (B, H, S, D), lse (B, H, S) → (dq, dk, dv) in the inputs'
    dtypes.  The reference adds each block's contribution into an output
    held in the inputs' dtype; this sums in f32 and rounds once, as the
    kernels do."""
    delta = _delta(o, do)
    dq = flash_attention_dq_reference(q, k, v, do, lse, delta, scale)
    return (dq, *flash_attention_dkv_reference(q, k, v, do, lse, delta, scale))


def _check(q, k, v):
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
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash attention runs on cuda or cpu tensors, got {q.device}")


def _check_kernel_inputs(*ts):
    """What the kernels take: f32 or bf16, D = 64 or 128, (batch, head, seq)
    strides that are non-negative, and for bf16 rows that TMA can read:
    16-byte aligned data and byte strides that are multiples of 16."""
    B, H, S, D = ts[0].shape
    if ts[0].dtype not in _DTYPE_CODES:
        raise ValueError(f"flash attention kernels take float32 or bfloat16, got {ts[0].dtype}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"flash attention kernels take head dim 64 or 128, got {D}")
    if any(st < 0 for t in ts for st in t.stride()):
        raise ValueError("flash attention kernels need non-negative strides")
    if ts[0].dtype == torch.bfloat16 and not all(_rows_aligned(t) for t in ts):
        raise ValueError(
            "the bf16 kernels read rows through TMA: inputs need 16-byte "
            "aligned data and strides that are multiples of 8"
        )


def _rows_aligned(t) -> bool:
    return t.data_ptr() % 16 == 0 and all(st % 8 == 0 for st in t.stride()[:3])


@functools.lru_cache(maxsize=None)
def _fn(lib_name: str, sym: str, n_ptrs: int, n_strided: int):
    """The C function ``sym`` of ``csrc/<lib_name>.cu``, typed once and
    cached: ``n_ptrs`` pointers, B, H, S, D, the (batch, head, seq) strides
    of ``n_strided`` tensors, scale, dtype code and stream."""
    fn = getattr(_build.load(lib_name), sym)
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * 4
        + [ctypes.c_int64] * (3 * n_strided)
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    return fn


# What the C functions return when the driver refuses a TMA tensor map:
# this plus the CUresult (csrc/hopper.cuh kTensorMapError).
_TENSOR_MAP_ERROR = 10000


def _call(fn, name, ptrs, strided, scale):
    """Launch ``fn`` on the current stream of the inputs' device."""
    t = strided[0]
    B, H, S, D = t.shape
    strides = [st for x in strided for st in x.stride()[:3]]
    # Switching devices costs a context manager a call; skip it when the
    # inputs' device is the current one.
    same = t.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if same else torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*ptrs, B, H, S, D, *strides, float(scale), _DTYPE_CODES[t.dtype], stream)
    if err >= _TENSOR_MAP_ERROR:
        raise RuntimeError(f"{name}: the driver refused a TMA tensor map: "
                           f"CUresult {err - _TENSOR_MAP_ERROR}")
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _launch_fwd(q, k, v, scale):
    _check_kernel_inputs(q, k, v)
    B, H, S, D = q.shape
    o = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    fn = _fn("flash_attention_fwd", "flash_attention_fwd", 5, 3)
    _call(fn, "flash_attention_fwd", [x.data_ptr() for x in (q, k, v, o, lse)],
          (q, k, v), scale)
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
    return _launch_fwd(q, k, v, scale)


flash_attention_fwd.launches = 0


def _bwd_inputs(q, k, v, do, lse, delta):
    """Check the backward's inputs and bring ``do`` to a layout the kernels
    read: ``do`` is taken through its (batch, head, seq) strides where it
    has a unit stride along D (and, in bf16, 16-byte rows), and copied with
    ``.contiguous()`` otherwise.  lse and delta are read as contiguous
    (B, H, S) f32."""
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device:
        raise ValueError(
            f"do must match q: {tuple(do.shape)} {do.dtype} {do.device}, "
            f"expected {tuple(q.shape)} {q.dtype} {q.device}"
        )
    for name, r in (("lse", lse), ("delta", delta)):
        if r.shape != q.shape[:3] or r.dtype != torch.float32 or r.device != q.device:
            raise ValueError(f"{name} must be (B, H, S) float32 on {q.device}, got "
                             f"{tuple(r.shape)} {r.dtype} {r.device}")
    if do.stride(-1) != 1 or (do.dtype == torch.bfloat16 and not _rows_aligned(do)):
        do = do.contiguous()
    _check_kernel_inputs(q, k, v, do)
    return do, lse.contiguous(), delta.contiguous()


def flash_attention_dq(q, k, v, do, lse, delta, scale: float):
    """dq of causal flash attention (port of the reference's ``_dq_kernel``
    pass).  q, k, v, do: (B, H, S, D); lse, delta: (B, H, S) f32 → dq
    (B, H, S, D) in q.dtype.  ``launches`` counts kernel launches."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_dq_reference(q, k, v, do, lse, delta, scale)
    do, lse, delta = _bwd_inputs(q, k, v, do, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    fn = _fn("flash_attention_bwd", "flash_attention_bwd_dq", 7, 4)
    _call(fn, "flash_attention_dq",
          [x.data_ptr() for x in (q, k, v, do, lse, delta, dq)], (q, k, v, do), scale)
    flash_attention_dq.launches += 1
    return dq


flash_attention_dq.launches = 0


def flash_attention_dkv(q, k, v, do, lse, delta, scale: float):
    """(dk, dv) of causal flash attention (port of the reference's
    ``_dkv_kernel`` pass).  Inputs as for :func:`flash_attention_dq` →
    (dk, dv) (B, H, S, D) in k's and v's dtype.  ``launches`` counts kernel
    launches."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_dkv_reference(q, k, v, do, lse, delta, scale)
    do, lse, delta = _bwd_inputs(q, k, v, do, lse, delta)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    fn = _fn("flash_attention_bwd", "flash_attention_bwd_dkv", 8, 4)
    _call(fn, "flash_attention_dkv",
          [x.data_ptr() for x in (q, k, v, do, lse, delta, dk, dv)], (q, k, v, do), scale)
    flash_attention_dkv.launches += 1
    return dk, dv


flash_attention_dkv.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, scale: float | None = None):
    """Causal flash attention backward (port of the reference's ``_bwd``).
    q, k, v, o, do: (B, H, S, D); lse: (B, H, S) f32 from the forward →
    (dq, dk, dv) in the inputs' dtypes.  ``delta = rowsum(do * o)`` is a
    torch op; dq and (dk, dv) are two kernels with no atomics, so two runs
    give the same bits."""
    scale = scale or 1.0 / math.sqrt(q.shape[-1])
    delta = _delta(o, do)
    dq = flash_attention_dq(q, k, v, do, lse, delta, scale)
    return (dq, *flash_attention_dkv(q, k, v, do, lse, delta, scale))


class _FlashAttention(torch.autograd.Function):
    """The reference's ``jax.custom_vjp``: the forward saves (q, k, v, o,
    lse), the backward recomputes p from lse."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = flash_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*flash_attention_bwd(q, k, v, o, lse, do, ctx.scale), None)


def flash_attention_bhsd(q, k, v, scale: float | None = None):
    """Causal flash attention, (B, H, S, D) layout (kernel-native) → o.
    Differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, scale or 1.0 / math.sqrt(q.shape[-1]))


def flash_attention(q, k, v, scale: float | None = None):
    """Causal flash attention.  q, k, v: (B, S, H, D) → (B, S, H, D).

    The kernels read the (B, S, H, D) inputs in place through their
    strides; only the transposed views change hands.
    """
    o = flash_attention_bhsd(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale
    )
    return o.transpose(1, 2)
