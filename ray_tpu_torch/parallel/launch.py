"""Run a function on every rank of a fresh process group, one process a rank.

The reference's SPMD tests run one process over many virtual devices; torch
runs one process per device, so the multi-rank paths (the dry run, the
tests) start their ranks here.  Rendezvous goes through a file store in a
fresh temporary directory, never a fixed port.  Every rank is awaited with
a deadline, and a rank that fails ends its siblings at once: gloo peers
would otherwise wait minutes in their next collective.
"""

from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import traceback
from typing import Any, Callable, List


def _rank_main(fn, rank, n, backend, store_dir, threads, results, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, init_method=f"file://{store_dir}/store",
                                rank=rank, world_size=n)
        try:
            out = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        # by value: a tensor put on the queue as it is would be shared
        # through this process, which may be gone when the parent reads it
        results.put((rank, True, pickle.dumps(out)))
    except BaseException:  # noqa: BLE001 — reported to the parent, which ends the siblings
        results.put((rank, False, traceback.format_exc()))
        raise


def run_ranks(fn: Callable[..., Any], n: int, *args, backend: str,
              timeout: float = 600.0) -> List[Any]:
    """``[fn(rank, *args) for rank in range(n)]``, each in its own spawned
    process inside a process group of ``n`` ranks over ``backend``
    (``"nccl"``, one card a rank, or ``"gloo"``; the caller names it).  ``fn`` and ``args`` are
    pickled, so ``fn`` is a module-level function.  Raises with the first
    failing rank's traceback, or when the ranks are not done within
    ``timeout`` seconds; either way every rank's process is ended."""
    import multiprocessing as mp
    import time

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    store_dir = tempfile.mkdtemp(prefix="ray_tpu_torch_ranks_")
    # at most two intra-op threads a rank: the ranks share the host's cores
    # with each other and with whatever else runs there
    threads = max(1, min(2, (os.cpu_count() or 1) // n))
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, n, backend, store_dir, threads, results, args))
             for r in range(n)]
    out: dict = {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(out) < n:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(f"rank process {procs.index(dead[0])} died with exit code "
                                       f"{dead[0].exitcode} before reporting")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks did not finish {fn.__name__} within {timeout:.0f} s; "
                                       f"{len(out)} reported")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {n} failed in {fn.__name__}:\n{value}")
            out[rank] = pickle.loads(value)
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=10)
        shutil.rmtree(store_dir, ignore_errors=True)
    return [out[r] for r in range(n)]
