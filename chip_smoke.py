#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:
  1. print the card's name and power limit; build every CUDA kernel from
     ray_tpu_torch/csrc with nvcc, all sources at once, and print each
     kernel's registers and spills (ptxas) and the dynamic shared memory
     the wgmma kernels ask for;
  2. hold the flash-attention forward kernel against its plain PyTorch
     version on the card, on o and lse, at the shapes listed in CHECKS
     (D = 128 at full depth among them), on strided (B, S, 3H, D) views,
     and with q and k scaled by SCALED_QK at the main-path shape; check
     that two runs give the same bits;
  3. hold the backward kernels (dq; dk and dv) against their plain versions
     at the same shapes, on strided (B, S, 3H, D) views with a
     non-contiguous do, and with q and k scaled by SCALED_QK_BWD, and check
     that two runs give the same bits; then measure, without a check, how
     far the plain backward is from itself with f64 products at SCALED_QK;
  4. time each kernel, its plain version and PyTorch's fused attention
     (scaled_dot_product_attention: its forward, and its backward as
     forward-and-backward less forward, timed as yardsticks only) at the
     GPT-2 main-path shape, by device time under torch.profiler; each
     wrapper's time per call under CUDA events, host cost included, is
     printed beside it;
  5. the forward path: GPT-2-124M (random weights from a seeded generator,
     bf16 compute, flash attention) scores a few (8, 1024) token batches
     through the model's forward and loss_fn, and entry() runs once at
     (4, 512).  The forward kernel's launch count is reset just before and
     read just after; every forward must launch it once per layer.  The
     same weights with dense attention must give the same logits within a
     bf16 tolerance.  Then the forward is timed at (8, 1024) and profiled;
  6. the training path (this slice's main path): GPT-2-124M at B=8, S=1024,
     bf16, flash, remat off, AdamW(3e-4, weight decay 0.1), the same tokens
     every step, 3 warm-up and 10 timed steps through compile_train_step.
     Every kernel's launch count is reset just before and read just after;
     each step must launch each kernel once per layer, and the loss must be
     finite and fall.  One step's gradients with flash and with dense
     attention, from the same weights, must agree within a bf16 tolerance.
     The lm-head's backward is timed, and one step is profiled by kernel
     group.
The line before the last is a JSON object {"kernels": [...]} with each
kernel's launches on the training path, error against its plain version,
time, the plain version's time, the library call's time and the card's
bound; the last line is {"ok": true, "device": {...}}.  With no CUDA device
it prints no result and exits 2.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import math
import re
import subprocess
import sys
import time

import torch

# H100 SXM: HBM rate and dense bf16 tensor-core peak (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
MAIN_SHAPE = (8, 12, 1024, 64)  # GPT-2-124M attention at B=8, S=1024
# (shape, dtype) pairs the kernels are held against their plain versions at.
CHECKS = [
    (shape, dtype)
    for shape in ((1, 2, 128, 64), (1, 2, 384, 64), (2, 4, 512, 64), (1, 2, 256, 128))
    for dtype in (torch.float32, torch.bfloat16)
] + [(MAIN_SHAPE, torch.bfloat16), ((2, 4, 1024, 128), torch.bfloat16),
       # D = 128 with more tiles than the card has SMs, so every persistent
       # wgmma kernel's blocks take a second tile there too.
       ((8, 12, 1024, 128), torch.bfloat16)]
# q and k scaled by this at the main-path shape: scores of std ~16, so row
# maxima move from kv tile to kv tile and the online rescale is exercised.
SCALED_QK = 4.0
# The backward's scaled check.  At SCALED_QK the plain backward does not
# reproduce itself within BWD_TOL once its products are summed in f64: bf16
# roundings of p and ds flip with the last bits of s (phase_tolerance_floor
# measures it in every run).  At 2.0 (scores of std ~4) it does.
SCALED_QK_BWD = 2.0
# f32: the kernel and the plain version sum in another order (5e-5).
# bf16: the kernel rounds p to bf16 before the product with v (as the Pallas
# kernel does) and both round o to bf16 once, so o may differ by about one
# bf16 ulp (2^-8 relative); lse is f32 from the same bf16 inputs.
TOL = {
    torch.float32: {"o": dict(atol=5e-5, rtol=5e-5), "lse": dict(atol=5e-5, rtol=5e-5)},
    torch.bfloat16: {"o": dict(atol=1e-2, rtol=1e-2), "lse": dict(atol=1e-4, rtol=1e-4)},
}
# Backward, dq, dk, dv against the plain versions.  f32: summation order
# (5e-5).  bf16: both round p and ds to bf16 before their products, where
# summation order can flip a rounding, and both sum in f32 and round the
# output once, so an output may differ by about one bf16 ulp (2^-8 relative).
BWD_TOL = {torch.float32: dict(atol=5e-5, rtol=5e-5), torch.bfloat16: dict(atol=1e-2, rtol=1e-2)}
# Init loss of a random-weight model: about ln(vocab).
LOSS_WINDOW = 0.5
# Flash vs dense logits in bf16: the kernel keeps p and the sum in f32, the
# dense path rounds p and the product to bf16; logits are O(0.5).
FLASH_VS_DENSE_MAX_ABS = 0.1
FLASH_VS_DENSE_LOSS = 1e-2
# Flash vs dense gradients of one bf16 training step, |g_flash - g_dense| over
# |g_dense| for each parameter: the dense path rounds p and its backward
# products to bf16 where the kernels keep f32, and those roundings (2^-8
# relative) are carried back through 12 layers.
FLASH_VS_DENSE_GRAD = 5e-2
TRAIN_WARMUP, TRAIN_STEPS = 3, 10


def _require(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def _log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def _time_ms(fn, iters, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _randn(shape, dtype, g):
    return torch.randn(shape, generator=g, device="cuda").to(dtype)


def _qkv(shape, dtype, seed, n=3):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [_randn(shape, dtype, g) for _ in range(n)]


def _bound(nbytes, flops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _attention_bound(shape, dtype):
    """Least time for the causal forward: q, k, v read once, o and lse
    written once, against the product count of the causal triangle."""
    B, H, S, D = shape
    elt = torch.finfo(dtype).bits // 8
    nbytes = 4 * B * H * S * D * elt + B * H * S * 4
    flops = 4 * B * H * D * S * (S + 1) // 2
    return (*_bound(nbytes, flops), nbytes, flops)


def _bwd_bound(shape, dtype, n_products, n_outputs):
    """Least time for one backward pass: q, k, v, do, lse and delta read
    once, its outputs written once, against ``n_products`` causal
    products (dq: s, dp, ds k; dk/dv: s, dp, p do, ds q)."""
    B, H, S, D = shape
    elt = torch.finfo(dtype).bits // 8
    nbytes = (4 + n_outputs) * B * H * S * D * elt + 2 * B * H * S * 4
    flops = n_products * 2 * B * H * D * S * (S + 1) // 2
    return (*_bound(nbytes, flops), nbytes, flops)


def phase_device_and_build(_build):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _log("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
                   f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    paths = _build.build(_build.all_sources())
    _log("build", f"{len(paths)} kernel source(s) built in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        kernel = ""
        for line in open(f"{path}.log").read().splitlines():
            if "Compiling entry function" in line:
                mangled = line.split("'")[1]
                m = re.search(r"\d(flash_[a-z0-9_]*_kernel)ILi(\d+)E", mangled)
                kernel = f"{m[1]}<{m[2]}>" if m else mangled[-60:]
            if any(w in line for w in ("registers", "spill", "error", "Performance Loss")):
                _log("build", f"{name}: {kernel}: {line.strip()}")
    for lib, sym in (("flash_attention_fwd", "flash_attention_fwd_smem_bytes"),
                     ("flash_attention_bwd", "flash_attention_bwd_dq_smem_bytes"),
                     ("flash_attention_bwd", "flash_attention_bwd_dkv_smem_bytes")):
        fn = getattr(_build.load(lib), sym)
        fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int, ctypes.c_int]
        _log("build", f"{sym}: bf16 (wgmma) D=64 {fn(64, 1)} B, D=128 {fn(128, 1)} B; "
                      f"f32 D=64 {fn(64, 0)} B, D=128 {fn(128, 0)} B of dynamic shared memory")
    return smi


def phase_check(fa):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {}
    for i, (shape, dtype) in enumerate(CHECKS):
        q, k, v = _qkv(shape, dtype, seed=i)
        scale = 1.0 / math.sqrt(shape[-1])
        o, lse = fa.flash_attention_fwd(q, k, v)
        o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, scale)
        torch.cuda.synchronize()
        _require(o.dtype == dtype and lse.dtype == torch.float32, f"{shape}: o {o.dtype}, lse {lse.dtype}")
        torch.testing.assert_close(o.float(), o_ref.float(), **TOL[dtype]["o"])
        torch.testing.assert_close(lse, lse_ref, **TOL[dtype]["lse"])
        errs[(shape, dtype)] = ((o.float() - o_ref.float()).abs().max().item(),
                                (lse - lse_ref).abs().max().item())
        _log("check", f"{shape} {str(dtype)[6:]}: max|o-ref| {errs[(shape, dtype)][0]:.3g} "
                      f"max|lse-ref| {errs[(shape, dtype)][1]:.3g}")
    # The model hands the kernel strided views of its (B, S, 3H, D)
    # projection output; hold that layout too, at the main-path shape.
    B, H, S, D = MAIN_SHAPE
    g = torch.Generator(device="cuda").manual_seed(99)
    qkv = torch.randn((B, S, 3 * H, D), generator=g, device="cuda").bfloat16()
    q, k, v = (t.transpose(1, 2) for t in qkv.split(H, dim=2))
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, 1.0 / math.sqrt(D))
    torch.testing.assert_close(o.float(), o_ref.float(), **TOL[torch.bfloat16]["o"])
    torch.testing.assert_close(lse, lse_ref, **TOL[torch.bfloat16]["lse"])
    _log("check", f"strided (B,S,3H,D) views at {MAIN_SHAPE}: max|o-ref| "
                  f"{(o.float() - o_ref.float()).abs().max().item():.3g}")
    # No atomics: two runs give the same bits.
    o2, lse2 = fa.flash_attention_fwd(q, k, v)
    _require(torch.equal(o, o2) and torch.equal(lse, lse2), "two forward runs differ")
    _log("check", "forward: two runs at the main-path shape are bitwise equal")
    q, k, v = _qkv(MAIN_SHAPE, torch.bfloat16, seed=97)
    q, k = q * SCALED_QK, k * SCALED_QK
    o, lse = fa.flash_attention_fwd(q, k, v)
    o_ref, lse_ref = fa.flash_attention_fwd_reference(q, k, v, 1.0 / math.sqrt(D))
    torch.testing.assert_close(o.float(), o_ref.float(), **TOL[torch.bfloat16]["o"])
    torch.testing.assert_close(lse, lse_ref, **TOL[torch.bfloat16]["lse"])
    _log("check", f"q, k scaled by {SCALED_QK} at {MAIN_SHAPE}: max|o-ref| "
                  f"{(o.float() - o_ref.float()).abs().max().item():.3g} max|lse-ref| "
                  f"{(lse - lse_ref).abs().max().item():.3g}")
    return errs[(MAIN_SHAPE, torch.bfloat16)][0]


def _bwd_pair(fa, q, k, v, do):
    """(dq, dk, dv) from the kernels and from the plain versions, on the
    forward kernel's o and lse."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa._delta(o, do)
    got = (fa.flash_attention_dq(q, k, v, do, lse, delta, scale),
           *fa.flash_attention_dkv(q, k, v, do, lse, delta, scale))
    ref = (fa.flash_attention_dq_reference(q, k, v, do, lse, delta, scale),
           *fa.flash_attention_dkv_reference(q, k, v, do, lse, delta, scale))
    torch.cuda.synchronize()
    return got, ref


def _hold_bwd(label, got, ref, dtype):
    errs = []
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        _require(a.dtype == dtype and a.shape == b.shape, f"{label} {name}: {a.dtype} {tuple(a.shape)}")
        torch.testing.assert_close(a.float(), b.float(), **BWD_TOL[dtype],
                                   msg=lambda m: f"{label} {name}: {m}")
        errs.append((a.float() - b.float()).abs().max().item())
    _log("check", f"{label}: max|d-ref| dq {errs[0]:.3g} dk {errs[1]:.3g} dv {errs[2]:.3g}")
    return errs


def phase_check_bwd(fa):
    errs = {}
    for i, (shape, dtype) in enumerate(CHECKS):
        q, k, v, do = _qkv(shape, dtype, seed=100 + i, n=4)
        got, ref = _bwd_pair(fa, q, k, v, do)
        errs[(shape, dtype)] = _hold_bwd(f"bwd {shape} {str(dtype)[6:]}", got, ref, dtype)
    # The model's layout: q, k, v strided views of one (B, S, 3H, D) tensor.
    # do from autograd need not be contiguous: one in (B, S, H, D) memory
    # order is read through its strides, one without a unit stride along D
    # is copied by the wrapper first.
    B, H, S, D = MAIN_SHAPE
    g = torch.Generator(device="cuda").manual_seed(98)
    qkv = _randn((B, S, 3 * H, D), torch.bfloat16, g)
    q, k, v = (t.transpose(1, 2) for t in qkv.split(H, dim=2))
    for label, do in (
        ("(B,S,H,D)-ordered do", _randn((B, S, H, D), torch.bfloat16, g).transpose(1, 2)),
        ("do with D stride != 1", _randn((B, H, D, S), torch.bfloat16, g).transpose(2, 3)),
    ):
        _require(not do.is_contiguous(), f"{label} is contiguous")
        got, ref = _bwd_pair(fa, q, k, v, do)
        _hold_bwd(f"strided views, {label}", got, ref, torch.bfloat16)
    # No atomics: two runs give the same bits.
    got2, _ = _bwd_pair(fa, q, k, v, do)
    _require(all(torch.equal(a, b) for a, b in zip(got, got2)), "two backward runs differ")
    _log("check", "backward: two runs at the main-path shape are bitwise equal")
    q, k, v, do = _qkv(MAIN_SHAPE, torch.bfloat16, seed=96, n=4)
    got, ref = _bwd_pair(fa, q * SCALED_QK_BWD, k * SCALED_QK_BWD, v, do)
    _hold_bwd(f"q, k scaled by {SCALED_QK_BWD} at {MAIN_SHAPE}", got, ref, torch.bfloat16)
    main = errs[(MAIN_SHAPE, torch.bfloat16)]
    return {"dq": main[0], "dkv": max(main[1], main[2])}


def _bwd_f64(q, k, v, do, lse, delta, scale):
    """The plain backward with every product summed in f64; p and ds are
    still rounded to the inputs' dtype before their products."""
    S = q.shape[2]
    w = lambda x: x.double()
    s = torch.einsum("bhqd,bhkd->bhqk", w(q), w(k)) * scale
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.where(causal, torch.exp(s - w(lse)[..., None]), 0.0)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", w(do), w(v)) - w(delta)[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", w(ds.to(q.dtype)), w(k))
    dk = torch.einsum("bhqk,bhqd->bhkd", w(ds.to(q.dtype)), w(q))
    dv = torch.einsum("bhqk,bhqd->bhkd", w(p.to(do.dtype)), w(do))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def phase_tolerance_floor(fa):
    """A measurement, not a check: at the main-path shape with q and k
    scaled by SCALED_QK, how many elements of dq, dk and dv fall outside
    BWD_TOL between the kernels, the plain backward (f32 products) and the
    plain backward with f64 products.  Where the two plain versions
    disagree as much as the kernels do, the tolerance is below the
    function's own rounding noise at those inputs."""
    q, k, v, do = _qkv(MAIN_SHAPE, torch.bfloat16, seed=96, n=4)
    q, k = q * SCALED_QK, k * SCALED_QK
    got, ref = _bwd_pair(fa, q, k, v, do)
    o, lse = fa.flash_attention_fwd(q, k, v)
    alt = _bwd_f64(q, k, v, do, lse, fa._delta(o, do), 1.0 / math.sqrt(MAIN_SHAPE[-1]))

    def outside(a, b):
        d = (a.float() - b.float()).abs()
        tol = BWD_TOL[torch.bfloat16]
        return int((d > tol["atol"] + tol["rtol"] * b.float().abs()).sum()), d.max().item()

    for name, g, r, a in zip(("dq", "dk", "dv"), got, ref, alt):
        _log("floor", f"q, k scaled by {SCALED_QK}, {name}: elements outside BWD_TOL (max |diff|): "
                      "kernel vs plain %d (%.4g), f64-product plain vs plain %d (%.4g), "
                      "kernel vs f64-product plain %d (%.4g)" % (*outside(g, r), *outside(a, r), *outside(g, a)))


def _spread(samples):
    s = sorted(samples)
    q = lambda f: s[min(len(s) - 1, int(f * len(s)))]
    return s[len(s) // 2], q(0.25), q(0.75)


def _device_events(run):
    """The device kernels of one ``run()`` under torch.profiler (after a
    warm-up run), leaving out user annotations, which span kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def _sdpa_backward_ms(q, k, v, do, iters=20):
    """SDPA's backward at these inputs: the device time of its forward and
    backward less that of its forward (inputs that require grad in both),
    summed over the kernels of ``iters`` calls.  A loop of autograd calls is
    bound by the host, so CUDA events around it would time the host."""
    import torch.nn.functional as F

    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qr, kr, vr), do)

    def device_ms(fn):
        events = _device_events(lambda: [fn() for _ in range(iters)])
        return sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters

    return device_ms(fwd_bwd) - device_ms(fwd)


def _device_ms(fn, iters, kernel=None):
    """Device time of one ``fn()`` from the kernels of ``iters`` calls under
    torch.profiler.  With ``kernel``, only the launches whose name holds it
    (one a call): their median and quartiles; without, the sum of every
    kernel over ``iters``."""
    events = _device_events(lambda: [fn() for _ in range(iters)])
    if kernel is None:
        _require(events, "no device events recorded")
        return sum(e.time_range.elapsed_us() for e in events) / 1e3 / iters
    events = [e for e in events if kernel in e.name]
    _require(len(events) == iters, f"{kernel}: {len(events)} launches profiled, expected {iters}")
    return _spread([e.time_range.elapsed_us() / 1e3 for e in events])


def _time_one(label, kernel, call, plain, bound, library_ms, iters=50):
    """A kernel's device time (median and quartiles of ``iters`` launches),
    its wrapper's time per call under CUDA events (host cost included), its
    plain version's device time, beside its bound and the library's time."""
    ms, q25, q75 = _device_ms(call, iters, kernel=kernel)
    wrapper_ms = _time_ms(call, iters=iters)
    plain_ms = _device_ms(plain, 3)
    bound_ms, bound_by, nbytes, flops = bound
    _log("time", f"{label} {MAIN_SHAPE} bf16: kernel {ms:.4f} ms device time (quartiles "
                 f"{q25:.4f}..{q75:.4f} over {iters} launches), wrapper {wrapper_ms:.4f} ms a call "
                 f"(CUDA events), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}: "
                 f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), kernel/bound {ms / bound_ms:.1f}x, "
                 f"kernel/library {ms / library_ms:.2f}x")
    return dict(ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_time_kernel(fa):
    import torch.nn.functional as F

    q, k, v = _qkv(MAIN_SHAPE, torch.bfloat16, seed=7)
    scale = 1.0 / math.sqrt(MAIN_SHAPE[-1])
    library_ms = _device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), 50)
    _log("time", f"sdpa forward (device time) {library_ms:.4f} ms")
    return _time_one("flash_attention_fwd", "flash_fwd_wgmma_kernel", lambda: fa.flash_attention_fwd(q, k, v),
                     lambda: fa.flash_attention_fwd_reference(q, k, v, scale),
                     _attention_bound(MAIN_SHAPE, torch.bfloat16), library_ms)


def phase_time_bwd(fa):
    """The dq and dk/dv kernels at the main-path shape, beside their plain
    versions, their bounds and SDPA's backward (which computes dq, dk and
    dv together, so it is the yardstick of the two kernels' sum)."""
    q, k, v, do = _qkv(MAIN_SHAPE, torch.bfloat16, seed=8, n=4)
    scale = 1.0 / math.sqrt(MAIN_SHAPE[-1])
    o, lse = fa.flash_attention_fwd(q, k, v)
    delta = fa._delta(o, do)
    args = (q, k, v, do, lse, delta, scale)
    library_ms = _sdpa_backward_ms(q, k, v, do)
    times = {}
    for key, kernel, plain, n_products, n_outputs in (
        ("dq", fa.flash_attention_dq, fa.flash_attention_dq_reference, 3, 1),
        ("dkv", fa.flash_attention_dkv, fa.flash_attention_dkv_reference, 4, 2),
    ):
        times[key] = _time_one(f"flash_attention_{key}", f"flash_{key}_wgmma_kernel", lambda: kernel(*args),
                               lambda: plain(*args),
                               _bwd_bound(MAIN_SHAPE, torch.bfloat16, n_products, n_outputs),
                               library_ms)
    total = times["dq"]["ms"] + times["dkv"]["ms"]
    _log("time", f"sdpa backward (device time of fwd+bwd less fwd) {library_ms:.4f} ms; dq + dk/dv kernels "
                 f"{total:.4f} ms ({total / library_ms:.2f}x sdpa)")
    return times


def phase_main_path(fa, gpt2, entry, model, tokens):
    """The forward path, whose forward-kernel launches are counted: each
    batch scored by the model's forward and by loss_fn, then entry() once."""
    cfg = model.config
    per_forward = cfg.num_layers
    results = []
    fa.flash_attention_fwd.launches = 0
    with torch.inference_mode():
        for i in range(tokens.shape[0]):
            before = fa.flash_attention_fwd.launches
            logits = model(tokens[i, :, :-1])
            mid = fa.flash_attention_fwd.launches
            loss = float(gpt2.loss_fn(model, {"tokens": tokens[i]}))
            after = fa.flash_attention_fwd.launches
            _require(mid - before == per_forward and after - mid == per_forward,
                     f"batch {i}: {mid - before} and {after - mid} launches, "
                     f"expected {per_forward} per forward")
            _require(logits.shape == (8, 1024, cfg.vocab_size) and logits.dtype == torch.float32,
                     f"batch {i}: logits {tuple(logits.shape)} {logits.dtype}")
            _require(bool(torch.isfinite(logits).all()), f"batch {i}: non-finite logits")
            _require(abs(loss - math.log(cfg.vocab_size)) < LOSS_WINDOW, f"batch {i}: loss {loss}")
            _log("model", f"batch {i}: loss {loss:.6f} (ln V = {math.log(cfg.vocab_size):.5f}), "
                          f"logits finite, std {logits.std().item():.4f}")
            results.append((logits, loss))
        fn, (emodel, etokens) = entry(device="cuda", attention_impl="flash")
        before = fa.flash_attention_fwd.launches
        elogits = fn(emodel, etokens)
        torch.cuda.synchronize()
    launches = fa.flash_attention_fwd.launches
    _require(launches - before == per_forward, f"entry(): {launches - before} launches")
    _require(elogits.shape == (4, 512, cfg.vocab_size) and bool(torch.isfinite(elogits).all()),
             f"entry(): logits {tuple(elogits.shape)} not finite or misshapen")
    _require(launches > 0, "the flash kernel was never launched on the forward path")
    _log("model", f"entry(): logits {tuple(elogits.shape)} finite; flash kernel launches on "
                  f"the forward path: {launches} ({per_forward} per forward, "
                  f"{2 * tokens.shape[0] + 1} forwards)")
    return launches, results[0]


def phase_flash_vs_dense(gpt2, model, tokens, flash_logits, flash_loss):
    dense = gpt2.GPT2(dataclasses.replace(model.config, attention_impl="dense"), "cuda")
    dense.load_state_dict(model.state_dict())
    with torch.inference_mode():
        d_logits = dense(tokens[0, :, :-1])
        d_loss = float(gpt2.loss_fn(dense, {"tokens": tokens[0]}))
    diff = (d_logits - flash_logits).abs()
    _log("model", f"flash vs dense logits: max abs {diff.max().item():.4g}, mean abs "
                  f"{diff.mean().item():.4g}; loss {flash_loss:.6f} vs {d_loss:.6f}")
    _require(diff.max().item() < FLASH_VS_DENSE_MAX_ABS, "flash and dense logits disagree")
    _require(abs(d_loss - flash_loss) < FLASH_VS_DENSE_LOSS, "flash and dense losses disagree")
    return dense


def phase_time_forward(gpt2, models, x, reps=10):
    """Host clock around each synchronised (8, 1024) forward."""
    fwd_flops = gpt2.flops_per_token(models["flash"].config, x.shape[1]) / 3 * x.numel()
    timing = {}
    with torch.inference_mode():
        for name, m in models.items():
            for _ in range(2):
                m(x)
            samples = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m(x)
                torch.cuda.synchronize()
                samples.append((time.perf_counter() - t0) * 1e3)
            ms, q25, q75 = _spread(samples)
            timing[name] = ms
            _log("forward", f"{name}: {ms:.3f} ms per {tuple(x.shape)} forward (median of {reps}, "
                            f"quartiles {q25:.3f}..{q75:.3f}), {x.numel() / ms * 1e3:.0f} tokens/s, "
                            f"{fwd_flops / 1e12:.3f} TFLOP -> {fwd_flops / (ms / 1e3) / BF16_FLOPS:.4f} "
                            f"of the bf16 peak")
    _log("forward", f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return timing


GEMM_MARKERS = ("nvjet", "gemm", "cutlass", "xmma", "cublas")
KERNEL_GROUPS = (("flash_fwd", "flash fwd"), ("flash_dq", "flash dq"), ("flash_dkv", "flash dkv"))


def _group(name):
    for marker, group in KERNEL_GROUPS:
        if marker in name:
            return group
    return "gemm" if any(m in name.lower() for m in GEMM_MARKERS) else "other"


def phase_profile(run, label, unprofiled_ms, top=6, expect=None):
    """Device time by kernel group over one ``run()`` (torch.profiler).  The
    profiler slows the host, so the device's idle share is taken against the
    unprofiled time as well as the profiled window.  ``expect`` maps a kernel
    name to the launches of it the run must show."""
    kernels = _device_events(run)
    if not kernels:
        _log("profile", f"{label}: no device events recorded: not measured")
        return
    for name, n in (expect or {}).items():
        got = sum(name in e.name for e in kernels)
        _require(got == n, f"{label}: {got} launches of {name} profiled, expected {n}")
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s_, e_ in spans[1:]:
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    by_name = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    _log("profile", f"{label}: {len(kernels)} kernels, device busy {busy / 1e3:.3f} ms; "
                    f"idle share {1 - busy / window:.4f} of the profiled {window / 1e3:.3f} ms window, "
                    f"{1 - busy / 1e3 / unprofiled_ms:.4f} of the unprofiled {unprofiled_ms:.3f} ms")
    groups = {}
    for name, (t, n) in by_name.items():
        gt, gn = groups.get(_group(name), (0.0, 0))
        groups[_group(name)] = (gt + t, gn + n)
    for group, (t, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        _log("profile", f"{label}: {group}: {t / 1e3:.3f} ms ({t / busy:.1%}) in {n} kernels")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        _log("profile", f"{label}: {t / 1e3:8.3f} ms {t / busy:6.1%} x{n:<3d} {name[:90]}")


def _counts(fa):
    return {"fwd": fa.flash_attention_fwd.launches, "dq": fa.flash_attention_dq.launches,
            "dkv": fa.flash_attention_dkv.launches}


def phase_train(fa, gpt2, spmd, model, tokens):
    """The training path: 3 warm-up and 10 timed steps on one repeated
    batch.  Every kernel's count is reset just before and read just after;
    each step must launch each kernel once per layer."""
    cfg = model.config
    batch = {"tokens": tokens}
    step = spmd.compile_train_step(
        gpt2.loss_fn, spmd.adamw(model.parameters(), 3e-4, weight_decay=0.1))
    state = spmd.TrainState(0, model)
    losses, norms, samples = [], [], []
    torch.cuda.reset_peak_memory_stats()
    fa.flash_attention_fwd.launches = 0
    fa.flash_attention_dq.launches = 0
    fa.flash_attention_dkv.launches = 0
    for i in range(TRAIN_WARMUP + TRAIN_STEPS):
        before = _counts(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        losses.append(metrics["loss"].item())  # synchronises
        samples.append((time.perf_counter() - t0) * 1e3)
        norms.append(metrics["grad_norm"].item())
        after = _counts(fa)
        per_step = {key: after[key] - before[key] for key in after}
        _require(all(n == cfg.num_layers for n in per_step.values()),
                 f"step {i}: launches {per_step}, expected {cfg.num_layers} of each")
    launches = _counts(fa)
    _require(state.step == TRAIN_WARMUP + TRAIN_STEPS, f"state.step {state.step}")
    _require(all(math.isfinite(x) for x in losses + norms), f"non-finite loss or grad norm: {losses}")
    _require(abs(losses[0] - math.log(cfg.vocab_size)) < LOSS_WINDOW, f"first loss {losses[0]}")
    _require(losses[-1] < losses[0] - 0.1, f"loss did not fall: {losses}")
    _require(all(n > 0 for n in launches.values()), f"a kernel was never launched: {launches}")
    ms, q25, q75 = _spread(samples[TRAIN_WARMUP:])
    n_tokens = tokens.shape[0] * (tokens.shape[1] - 1)
    flops = gpt2.flops_per_token(cfg, tokens.shape[1] - 1) * n_tokens
    _log("train", "loss " + " ".join(f"{x:.4f}" for x in losses))
    _log("train", "grad_norm " + " ".join(f"{x:.4f}" for x in norms))
    _log("train", f"kernel launches on the training path: {launches} "
                  f"({cfg.num_layers} of each per step, {len(losses)} steps)")
    _log("train", f"step {ms:.3f} ms (median of {TRAIN_STEPS}, quartiles {q25:.3f}..{q75:.3f}), "
                  f"{n_tokens / ms * 1e3:.0f} tokens/s, {flops / 1e12:.3f} TFLOP per step -> "
                  f"{flops / (ms / 1e3) / BF16_FLOPS:.4f} of the bf16 peak; peak memory "
                  f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches, step, state, dict(step_ms=ms, tokens_per_s=n_tokens / ms * 1e3,
                                       losses=losses)


def phase_grad_flash_vs_dense(gpt2, model, tokens):
    """One step's gradients with flash and with dense attention from the
    same weights, relative to each gradient's norm."""
    def grads(m):
        m.zero_grad(set_to_none=True)
        gpt2.loss_fn(m, {"tokens": tokens}).backward()
        return {n: p.grad.clone() for n, p in m.named_parameters()}

    dense = gpt2.GPT2(dataclasses.replace(model.config, attention_impl="dense"), model.wte.device)
    dense.load_state_dict(model.state_dict())
    g_flash, g_dense = grads(model), grads(dense)
    model.zero_grad(set_to_none=True)
    del dense
    rel = {n: ((g_flash[n] - g_dense[n]).norm() / g_dense[n].norm()).item() for n in g_dense}
    worst = sorted(rel, key=rel.get)[-4:]
    _log("train", f"flash vs dense gradients, |g_flash - g_dense| / |g_dense|: worst "
                  + ", ".join(f"{n} {rel[n]:.4g}" for n in reversed(worst))
                  + f"; median {sorted(rel.values())[len(rel) // 2]:.4g} over {len(rel)} parameters")
    _require(max(rel.values()) < FLASH_VS_DENSE_GRAD, "flash and dense gradients disagree")


def phase_time_head_backward(model, x_rows):
    """The lm-head's backward at the training shape, (B·S, E) features and
    the (V, E) table: the port's formula (f32 cotangent split into two bf16
    terms, four bf16 products) beside the two it was chosen between, as
    yardsticks: the exact f32 products, and one bf16 product each from the
    cotangent rounded to bf16."""
    from ray_tpu_torch.models.common import matmul_f32

    dev = model.wte.device
    a = torch.randn((x_rows, model.config.embed_dim), device=dev).bfloat16().requires_grad_()
    b = model.wte.detach().bfloat16().t().requires_grad_()
    g = torch.randn((x_rows, b.shape[1]), device=dev) * 1e-5
    out = matmul_f32(a, b)

    def port():
        torch.autograd.grad(out, (a, b), g, retain_graph=True)

    def exact_f32():
        (g.mm(b.detach().float().t()).bfloat16(), a.detach().float().t().mm(g).bfloat16())

    def rounded_bf16():
        gb = g.bfloat16()
        (gb.mm(b.detach().t()), a.detach().t().mm(gb))

    times = {name: _time_ms(fn, iters=5, warmup=1)
             for name, fn in (("port (hi+lo bf16)", port), ("exact f32", exact_f32),
                              ("cotangent rounded to bf16", rounded_bf16))}
    _log("head", f"lm-head backward at ({x_rows}, {model.config.embed_dim}) x "
                 f"({model.config.embed_dim}, {b.shape[1]}): "
                 + ", ".join(f"{n} {t:.3f} ms" for n, t in times.items()))
    return times


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from ray_tpu_torch.entry import entry
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.parallel import spmd

    t_start = time.perf_counter()
    smi = phase_device_and_build(_build)
    fwd_err = phase_check(fa)
    bwd_err = phase_check_bwd(fa)
    phase_tolerance_floor(fa)
    times = {"fwd": phase_time_kernel(fa), **phase_time_bwd(fa)}

    # The forward path (PR 1's main path).
    cfg = gpt2.GPTConfig.gpt2_124m(attention_impl="flash", remat=False, scan_unroll=12)
    g = torch.Generator(device="cuda").manual_seed(0)
    model = gpt2.init(cfg, g, "cuda")
    tokens = torch.randint(0, 50257, (3, 8, 1025), generator=g, device="cuda")
    fwd_launches, (logits, loss) = phase_main_path(fa, gpt2, entry, model, tokens)
    dense = phase_flash_vs_dense(gpt2, model, tokens, logits, loss)
    del logits
    x = tokens[0, :, :-1]
    fwd = phase_time_forward(gpt2, {"flash": model, "dense": dense}, x)
    del dense
    with torch.inference_mode():
        phase_profile(lambda: model(x), "one flash forward", fwd["flash"])

    # The training path (this slice's main path), from fresh weights.
    model = gpt2.init(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    phase_grad_flash_vs_dense(gpt2, model, tokens[1])
    launches, step, state, train = phase_train(fa, gpt2, spmd, model, tokens[0])
    head = phase_time_head_backward(model, tokens.shape[1] * (tokens.shape[2] - 1))
    # The step's bf16 kernels are the wgmma ones, one launch a layer each.
    phase_profile(lambda: step(state, {"tokens": tokens[0]}), "one train step", train["step_ms"], top=10,
                  expect={f"flash_{k}_wgmma_kernel": cfg.num_layers for k in ("fwd", "dq", "dkv")})
    _log("done", f"{time.perf_counter() - t_start:.1f} s in all")

    def entry_of(key, name, line, err):
        t = times[key]
        return {
            "name": name,
            "route": "cuda",
            "source": f"ray_tpu_torch/csrc/flash_attention_{'fwd' if key == 'fwd' else 'bwd'}.cu",
            "replaces": f"ray_tpu/ops/flash_attention.py:{line}",
            "launches": launches[key],
            "max_abs_err": err,
            "ms": t["ms"],
            "wrapper_ms": t["wrapper_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        }

    kernels = [
        entry_of("fwd", "flash_attention_fwd", 39, fwd_err),
        entry_of("dq", "flash_attention_dq", 97, bwd_err["dq"]),
        entry_of("dkv", "flash_attention_dkv", 142, bwd_err["dkv"]),
    ]
    print(json.dumps({"forward_ms": fwd, "forward_path_fwd_launches": fwd_launches,
                      "train_step_ms": train["step_ms"], "train_tokens_per_s": train["tokens_per_s"],
                      "head_backward_ms": head, "card": smi}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
