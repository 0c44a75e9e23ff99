#!/usr/bin/env python3
"""Time GPT-2-124M's training step on one card through each of the port's paths.

The model, batch and steps are those of chip_smoke.py's ``[train]``:
``GPTConfig.gpt2_124m(attention_impl="flash", remat=False, scan_unroll=12)``
with weights drawn from seed 1, one batch of B = 8 rows of S = 1024 tokens
(seed 0), AdamW (lr 3e-4, weight decay 0.1), 3 warm-up and 10 timed steps,
each timed from a synchronised start to its loss on the host.  The modes:

- ``plain``: ``spmd.compile_train_step`` on the module (``[train]``);
- ``mesh``: ``make_mesh(MeshConfig(dp=1))`` over an NCCL group of one,
  ``sharded_init``, ``shard_batch`` and the same step (``[spmd]``);
- ``fsdp2``: ``train.fsdp_utils`` (FSDP2's ``fully_shard`` over the
  (dp, fsdp) mesh of one) with its own step.

With ``--profile`` each mode then runs one more step under cProfile (the
host's functions with the most time of their own, and with the most in
total) and one under torch.profiler (the device-busy time: the sum of the
step's kernels).  The script prints one JSON line a mode, with the card's
name and power limit.

    python3 step_probe.py --modes plain mesh fsdp2 --profile
    python3 step_probe.py --root <checkout> --modes plain   # that checkout's package

Give a checkout with ``--root`` to time its package: a tree that predates
the mesh path runs ``plain`` only.  Runs only where CUDA is available.
"""

import argparse
import cProfile
import json
import os
import pstats
import socket
import subprocess
import sys
import time

WARMUP, STEPS = 3, 10


def _smi():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _median(xs):
    s = sorted(xs)
    return s[len(s) // 2]


def _build(mode, cfg, tokens):
    """(step(batch) -> loss tensor, the batch it takes) for ``mode``."""
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import spmd

    model = gpt2.init(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    if mode == "plain":
        step = spmd.compile_train_step(gpt2.loss_fn, spmd.adamw(model.parameters(), 3e-4, weight_decay=0.1))
        state = [spmd.TrainState(0, model)]

        def run(batch):
            state[0], metrics = step(state[0], batch)
            return metrics["loss"]

        return run, {"tokens": tokens}
    from ray_tpu_torch.parallel import mesh as mesh_mod

    mesh = mesh_mod.make_mesh(mesh_mod.MeshConfig(dp=1), device_type="cuda")
    if mode == "mesh":
        state = [spmd.sharded_init(mesh, lambda: model, gpt2.param_logical_axes(cfg))]
        step = spmd.compile_train_step(
            gpt2.loss_fn, spmd.adamw(state[0].params.parameters(), 3e-4, weight_decay=0.1))

        def run(batch):
            state[0], metrics = step(state[0], batch)
            return metrics["loss"]

        return run, spmd.shard_batch(mesh, {"tokens": tokens})
    if mode == "fsdp2":
        from torch.distributed.fsdp import register_fsdp_forward_method

        from ray_tpu_torch.train import fsdp_utils

        state = [fsdp_utils.create_train_state(
            model, lambda p: spmd.adamw(p, 3e-4, weight_decay=0.1), mesh)]
        # gpt2.loss_fn enters the model through features_aux, not forward
        register_fsdp_forward_method(model, "features_aux")
        step = fsdp_utils.make_train_step(gpt2.loss_fn, state[0])

        def run(batch):
            state[0], metrics = step(state[0], batch)
            return metrics["loss"]

        return run, {"tokens": tokens}
    raise ValueError(f"unknown mode {mode!r}")


def _host_top(run, batch, n=12):
    prof = cProfile.Profile()
    prof.enable()
    run(batch).item()
    prof.disable()
    stats = pstats.Stats(prof)
    rows = [(f"{os.path.basename(f)}:{line}:{fn}", tt * 1e3, ct * 1e3, nc)
            for (f, line, fn), (_, nc, tt, ct, _) in stats.stats.items()]
    fmt = lambda r: {"fn": r[0], "own_ms": round(r[1], 3), "total_ms": round(r[2], 3), "calls": r[3]}
    return {"host_ms": round(stats.total_tt * 1e3, 3),
            "by_own": [fmt(r) for r in sorted(rows, key=lambda r: -r[1])[:n]],
            "by_total": [fmt(r) for r in sorted(rows, key=lambda r: -r[2])[:n]]}


def _device_busy_ms(run, batch):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run(batch).item()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3, len(kernels)


def probe(mode, cfg, tokens, profile):
    import torch

    from ray_tpu_torch.ops import flash_attention as fa

    run, batch = _build(mode, cfg, tokens)
    kernels = (fa.flash_attention_fwd, fa.flash_attention_dq, fa.flash_attention_dkv)
    for k in kernels:
        k.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, samples = [], []
    for _ in range(WARMUP + STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(run(batch).item())
        samples.append((time.perf_counter() - t0) * 1e3)
    out = {"mode": mode, "step_ms": _median(samples[WARMUP:]), "samples_ms": samples[WARMUP:],
           "losses": losses, "launches": [k.launches for k in kernels],
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    if profile:
        out["host"] = _host_top(run, batch)
        out["device_busy_ms"], out["device_kernels"] = _device_busy_ms(run, batch)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--modes", nargs="+", default=["plain"], choices=["plain", "mesh", "fsdp2"])
    parser.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                        help="the checkout whose ray_tpu_torch to time (default: this script's)")
    parser.add_argument("--profile", action="store_true", help="also profile one step of each mode")
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        print("step_probe: no CUDA device", file=sys.stderr)
        return 2
    import ray_tpu_torch
    from ray_tpu_torch.models import gpt2

    smi = _smi()
    cfg = gpt2.GPTConfig.gpt2_124m(attention_impl="flash", remat=False, scan_unroll=12)
    tokens = torch.randint(0, cfg.vocab_size, (8, 1025), device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(0))
    if any(m != "plain" for m in args.modes):
        dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                                world_size=1)
    try:
        for mode in args.modes:
            out = probe(mode, cfg, tokens, args.profile)
            out.update(package=os.path.dirname(ray_tpu_torch.__file__), card=smi)
            print(json.dumps(out), flush=True)
            torch.cuda.empty_cache()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
