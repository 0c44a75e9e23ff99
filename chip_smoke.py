#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each of which raises (and so exits non-zero) on failure:
  1. print the card's name and power limit; build every CUDA kernel from
     ray_tpu_torch/csrc with nvcc, all sources at once;
  2. hold the flash-attention forward kernel against its plain PyTorch
     version on the card, on o and lse, at the shapes listed in CHECKS;
  3. time the kernel, its plain version and PyTorch's fused attention
     (scaled_dot_product_attention, timed as a yardstick only) at the GPT-2
     main-path shape, with CUDA events;
  4. the main path: GPT-2-124M (random weights from a seeded generator,
     bf16 compute, flash attention) scores a few (8, 1024) token batches
     through the model's forward and loss_fn, and entry() runs once at
     (4, 512).  The kernel's launch count is reset just before and read just
     after; every forward must launch it once per layer.  The same weights
     with dense attention must give the same logits within a bf16 tolerance.
     Then the forward is timed at (8, 1024).
The line before the last is a JSON object {"kernels": [...]} with each
kernel's launches on the main path, error against its plain version, time,
the plain version's time, the library call's time and the card's bound; the
last line is {"ok": true, "device": {...}}.  With no CUDA device it prints no
result and exits 2.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import time

import torch

# H100 SXM: HBM rate and dense bf16 tensor-core peak (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
MAIN_SHAPE = (8, 12, 1024, 64)  # GPT-2-124M attention at B=8, S=1024
# (shape, dtype) pairs the kernel is held against its plain version at.
CHECKS = [
    (shape, dtype)
    for shape in ((1, 2, 128, 64), (1, 2, 384, 64), (2, 4, 512, 64), (1, 2, 256, 128))
    for dtype in (torch.float32, torch.bfloat16)
] + [(MAIN_SHAPE, torch.bfloat16)]
# f32: the kernel and the plain version sum in another order (5e-5).
# bf16: the kernel rounds p to bf16 before the product with v (as the Pallas
# kernel does) and both round o to bf16 once, so o may differ by about one
# bf16 ulp (2^-8 relative); lse is f32 from the same bf16 inputs.
TOL = {
    torch.float32: {"o": dict(atol=5e-5, rtol=5e-5), "lse": dict(atol=5e-5, rtol=5e-5)},
    torch.bfloat16: {"o": dict(atol=1e-2, rtol=1e-2), "lse": dict(atol=1e-4, rtol=1e-4)},
}
# Init loss of a random-weight model: about ln(vocab).
LOSS_WINDOW = 0.5
# Flash vs dense logits in bf16: the kernel keeps p and the sum in f32, the
# dense path rounds p and the product to bf16; logits are O(0.5).
FLASH_VS_DENSE_MAX_ABS = 0.1
FLASH_VS_DENSE_LOSS = 1e-2


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


def _qkv(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(shape, generator=g, device="cuda").to(dtype) for _ in range(3)]


def _attention_bound(shape, dtype):
    """Least time for the causal forward: q, k, v read once, o and lse
    written once, against the product count of the causal triangle."""
    B, H, S, D = shape
    elt = torch.finfo(dtype).bits // 8
    nbytes = 4 * B * H * S * D * elt + B * H * S * 4
    flops = 4 * B * H * D * S * (S + 1) // 2
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


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
        for line in open(f"{path}.log").read().splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                _log("build", f"{name}: {line.strip()}")
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
    return errs[(MAIN_SHAPE, torch.bfloat16)][0]


def _spread(samples):
    s = sorted(samples)
    q = lambda f: s[min(len(s) - 1, int(f * len(s)))]
    return s[len(s) // 2], q(0.25), q(0.75)


def phase_time_kernel(fa):
    import torch.nn.functional as F

    q, k, v = _qkv(MAIN_SHAPE, torch.bfloat16, seed=7)
    scale = 1.0 / math.sqrt(MAIN_SHAPE[-1])
    kernel = [_time_ms(lambda: fa.flash_attention_fwd(q, k, v), iters=20) for _ in range(5)]
    plain_ms = _time_ms(lambda: fa.flash_attention_fwd_reference(q, k, v, scale), iters=5)
    library = [_time_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), iters=50)
               for _ in range(5)]
    kernel_ms, k25, k75 = _spread(kernel)
    library_ms, l25, l75 = _spread(library)
    bound_ms, bound_by, nbytes, flops = _attention_bound(MAIN_SHAPE, torch.bfloat16)
    _log("time", f"flash_attention_fwd {MAIN_SHAPE} bf16: kernel {kernel_ms:.4f} ms "
                 f"(quartiles {k25:.4f}..{k75:.4f} over 5 runs of 20), plain {plain_ms:.4f} ms, "
                 f"sdpa {library_ms:.4f} ms ({l25:.4f}..{l75:.4f}), bound {bound_ms:.4f} ms "
                 f"({bound_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
                 f"kernel/bound {kernel_ms / bound_ms:.1f}x")
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def phase_main_path(fa, gpt2, entry, model, tokens):
    """The run whose kernel launches are counted: each batch scored by the
    model's forward and by loss_fn, then entry() once."""
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
    _require(launches > 0, "the flash kernel was never launched on the main path")
    _log("model", f"entry(): logits {tuple(elogits.shape)} finite; flash kernel launches on "
                  f"the main path: {launches} ({per_forward} per forward, "
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


def phase_profile(model, x, forward_ms, top=6):
    """Device time by kernel over one flash forward (torch.profiler).  The
    profiler slows the host, so the device's idle share is taken against the
    unprofiled forward time as well as the profiled window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model(x)
            torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        _log("profile", "no device events recorded: not measured")
        return
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
    _log("profile", f"one flash forward: {len(kernels)} kernels, device busy {busy / 1e3:.3f} ms; "
                    f"idle share {1 - busy / window:.4f} of the profiled {window / 1e3:.3f} ms window, "
                    f"{1 - busy / 1e3 / forward_ms:.4f} of the unprofiled {forward_ms:.3f} ms forward")
    groups = {}
    for name, (t, n) in by_name.items():
        group = ("flash kernel" if "flash_fwd" in name
                 else "gemm" if any(m in name.lower() for m in GEMM_MARKERS)
                 else "other")
        gt, gn = groups.get(group, (0.0, 0))
        groups[group] = (gt + t, gn + n)
    for group, (t, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        _log("profile", f"{group}: {t / 1e3:.3f} ms ({t / busy:.1%}) in {n} kernels")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        _log("profile", f"{t / 1e3:8.3f} ms {t / busy:6.1%} x{n:<3d} {name[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from ray_tpu_torch.entry import entry
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa

    t_start = time.perf_counter()
    smi = phase_device_and_build(_build)
    max_err = phase_check(fa)
    times = phase_time_kernel(fa)

    cfg = gpt2.GPTConfig.gpt2_124m(attention_impl="flash", remat=False, scan_unroll=12)
    g = torch.Generator(device="cuda").manual_seed(0)
    model = gpt2.init(cfg, g, "cuda")
    tokens = torch.randint(0, 50257, (3, 8, 1025), generator=g, device="cuda")
    launches, (logits, loss) = phase_main_path(fa, gpt2, entry, model, tokens)
    dense = phase_flash_vs_dense(gpt2, model, tokens, logits, loss)
    del logits
    x = tokens[0, :, :-1]
    fwd = phase_time_forward(gpt2, {"flash": model, "dense": dense}, x)
    phase_profile(model, x, fwd["flash"])
    _log("done", f"{time.perf_counter() - t_start:.1f} s in all")
    kernel = {
        "name": "flash_attention_fwd",
        "route": "cuda",
        "source": "ray_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:39",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": times["ms"],
        "kernel_ms": times["ms"],
        "plain_ms": times["plain_ms"],
        "bound_ms": times["bound_ms"],
        "bound_by": times["bound_by"],
        "library_ms": times["library_ms"],
    }
    print(json.dumps({"forward_ms": fwd, "card": smi}))
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
