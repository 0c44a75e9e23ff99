"""How long does a large file write or read stall the other threads of its
process?  The question behind a raylet whose event loop stopped answering
while it spilled a 14.5 GB object to disk.

A buffer of ``--gb`` GB in a shared-memory mapping (as the object store's
arena is) is written to a file in ``--dir`` and read back, by a thread, in
the ways below, while the main thread runs an asyncio loop that sleeps 10 ms
at a time and then allocates 4 MiB (as an event loop's work allocates).  For
each way the script prints the seconds it took, the loop's longest overshoot
of its sleep, the longest allocation, and the longest of two filesystem
operations the loop makes in ``--dir`` after each sleep (a line appended to
a log file; ``true`` started with its output there), during the work and
for ``--after`` seconds after it:

- ``write_whole``: one ``f.write`` of the whole buffer, then ``fsync`` (the
  raylet's spill);
- ``write_sliced``: ``os.write`` of 64 MiB slices, then ``fsync``;
- ``write_subprocess``: ``write_whole`` in a child process;
- ``read_whole``: one ``f.read()`` of the file (the raylet's restore);
- ``read_sliced``: ``readinto`` of 64 MiB slices into one buffer.

    python3 spill_io_probe.py --gb 14.5 [--dir DIR] [--ways write_whole,read_whole]

It needs about three times ``--gb`` of host memory and ``--gb`` free in
``--dir`` (the temp dir by default).
"""

import argparse
import asyncio
import json
import mmap
import multiprocessing
import os
import subprocess
import sys
import tempfile
import threading
import time

SLICE = 64 << 20


def _fs_of(path: str) -> str:
    path, best = os.path.realpath(path), ("", "?")
    with open("/proc/mounts") as f:
        for line in f:
            _, mnt, fs = line.split()[:3]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) and len(mnt) > len(best[0]):
                best = (mnt, fs)
    return f"{best[1]} at {best[0]}"


def _write_whole(path, view):
    with open(path, "wb") as f:
        f.write(view)
        f.flush()
        os.fsync(f.fileno())


def _write_sliced(path, view):
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    try:
        off = 0
        while off < len(view):
            off += os.write(fd, view[off:off + SLICE])
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_child(shm_path, n, path):
    with open(shm_path, "r+b") as f:
        m = mmap.mmap(f.fileno(), n)
    _write_whole(path, memoryview(m))


def _read_whole(path):
    with open(path, "rb") as f:
        return len(f.read())


def _read_sliced(path):
    with open(path, "rb", buffering=0) as f:
        size = os.fstat(f.fileno()).st_size
        buf = bytearray(size)
        view, off = memoryview(buf), 0
        while off < size:
            got = f.readinto(view[off:off + SLICE])
            if not got:
                raise OSError(f"short read at {off} of {size}")
            off += got
    return off


def _small_op(d):
    """What a raylet's event loop does on the filesystem: append a line to a
    log file, and start a process whose output goes to a file there."""
    t0 = time.perf_counter()
    with open(os.path.join(d, f"spill_io_probe_{os.getpid()}.log"), "ab") as f:
        f.write(b"x\n")
    t1 = time.perf_counter()
    with open(os.path.join(d, f"spill_io_probe_{os.getpid()}.out"), "ab") as f:
        subprocess.run(["true"], stdout=f, check=True)
    return t1 - t0, time.perf_counter() - t1


def _watch(work, d, after_s):
    """Run ``work`` in a thread while the main thread's loop measures, then
    go on measuring for ``after_s`` seconds after it ends."""
    done, res = threading.Event(), {}

    def run():
        t0 = time.perf_counter()
        try:
            res["result"] = work()
        except Exception as e:  # noqa: BLE001 — reported
            res["error"] = repr(e)
        res["s"] = time.perf_counter() - t0
        done.set()

    async def loop():
        lag = alloc = 0.0
        ops = {"during": [0.0, 0.0], "after": [0.0, 0.0]}
        slow = []  # (when, seconds from the work's start or end, log append s, spawn s) above 0.1 s
        end = None
        while end is None or time.perf_counter() - end < after_s:
            t = time.perf_counter()
            await asyncio.sleep(0.01)
            t1 = time.perf_counter()
            junk = [bytearray(1 << 20) for _ in range(4)]
            del junk
            t2 = time.perf_counter()
            lag, alloc = max(lag, t1 - t - 0.01), max(alloc, t2 - t1)
            if end is None and done.is_set():
                end = t2
            when = "during" if end is None else "after"
            a, b = _small_op(d)
            ops[when] = [max(ops[when][0], a), max(ops[when][1], b)]
            if a + b > 0.1:
                slow.append((when, round(t2 - (t0 if end is None else end), 3), round(a, 3), round(b, 3)))
        return lag, alloc, ops, slow

    th = threading.Thread(target=run)
    t0 = time.perf_counter()
    th.start()
    lag, alloc, ops, slow = asyncio.run(loop())
    th.join()
    return {**res, "max_loop_lag_s": lag, "max_alloc_s": alloc,
            "max_log_append_s": {k: v[0] for k, v in ops.items()},
            "max_spawn_s": {k: v[1] for k, v in ops.items()},
            "slow_ops": slow[:40]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gb", type=float, default=1.0)
    ap.add_argument("--dir", default=tempfile.gettempdir())
    ap.add_argument("--ways", default="write_whole,write_sliced,write_subprocess,read_whole,read_sliced")
    ap.add_argument("--after", type=float, default=10.0,
                    help="seconds to go on measuring after each way ends")
    a = ap.parse_args()
    n = int(a.gb * 1e9)
    shm_path = f"/dev/shm/spill_io_probe_{os.getpid()}"
    path = os.path.join(a.dir, f"spill_io_probe_{os.getpid()}.obj")
    out = {"bytes": n, "dir": a.dir, "fs": _fs_of(a.dir)}
    try:
        with open(shm_path, "w+b") as f:
            f.truncate(n)
            m = mmap.mmap(f.fileno(), n)
        view = memoryview(m)
        pattern = bytes(range(256)) * (SLICE // 256)
        for off in range(0, n, SLICE):
            view[off:off + min(SLICE, n - off)] = pattern[:min(SLICE, n - off)]
        ways = {
            "write_whole": lambda: _write_whole(path, view),
            "write_sliced": lambda: _write_sliced(path, view),
            "write_subprocess": lambda: _run_child(shm_path, n, path),
            "read_whole": lambda: _read_whole(path),
            "read_sliced": lambda: _read_sliced(path),
        }
        for way in a.ways.split(","):
            out[way] = _watch(ways[way], a.dir, a.after)
    finally:
        for p in (path, shm_path, *(os.path.join(a.dir, f"spill_io_probe_{os.getpid()}{e}")
                                     for e in (".log", ".out"))):
            try:
                os.unlink(p)
            except OSError:
                pass
    print(json.dumps(out))
    return 0


def _run_child(shm_path, n, path):
    p = multiprocessing.get_context("spawn").Process(target=_write_child, args=(shm_path, n, path))
    p.start()
    p.join()
    return p.exitcode


if __name__ == "__main__":
    sys.exit(main())
