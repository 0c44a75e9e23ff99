"""Does the port's node stay live while a large object is spilled and restored?

An object is put into a store sized so that it fills ``--fill`` of it (above
the spill's high mark), the raylet spills it to disk, and a task then reads
it and copies it (as a state dict's tensors are copied out of the store),
which makes the raylet read it back into the store.  Through every phase a
thread asks the GCS every 50 ms how long the node has been silent (the time
since its last heartbeat, which the failure detector reads), times a round
trip to the raylet, and reads the host's available memory.  The script
prints one JSON line: the sizes, where the spill file lies, and for each
phase (put, spill, read) its seconds, the longest silence, the slowest
raylet round trip and the least memory available; then whether the node
was alive at the end.  A raylet round trip that waits more than 1.5 s
makes the raylet dump its threads' stacks into its log (at most three
times), which ``--logs`` copies, beside each thread's kernel wait channel
read from ``/proc`` at that moment.  The GCS declares a node dead once it has been
silent for half of ``node_death_timeout_s`` (5 s by default) with a high
suspicion level.

    python3 restore_probe.py --gb 14.5 --fill 0.93
    python3 restore_probe.py --root <checkout> ...   # that checkout's package
    python3 restore_probe.py --logs DIR ...  # also the samples and the logs' ends

Keep ``--gb`` to a few GB on a shared host: the full size needs about four
times ``--gb`` of host memory (the store, the spill file if the temp dir is
in memory, the restore's read, the task's copy).
"""

import argparse
import json
import os
import signal
import sys
import tempfile
import threading
import time


def _mem_available_gb() -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def _fs_of(path: str) -> str:
    """The type of the filesystem that holds ``path``."""
    path, best = os.path.realpath(path), ("", "?")
    with open("/proc/mounts") as f:
        for line in f:
            _, mnt, fs = line.split()[:3]
            if (path == mnt or path.startswith(mnt.rstrip("/") + "/")) and len(mnt) > len(best[0]):
                best = (mnt, fs)
    return f"{best[1]} at {best[0]}"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gb", type=float, default=1.0, help="object size, GB")
    ap.add_argument("--fill", type=float, default=0.93, help="object size over store size")
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(__file__)),
                    help="checkout whose ray_tpu_torch to run")
    ap.add_argument("--logs", help="copy the last 256 KiB of the GCS's and the raylet's logs here")
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    import numpy as np

    import ray_tpu_torch as rt
    from ray_tpu_torch.core import api as rt_api
    from ray_tpu_torch.core.runtime import get_runtime

    nbytes = int(a.gb * 1e9)
    store = int(nbytes / a.fill)
    info = rt.init(num_cpus=1, object_store_bytes=store, log_to_driver=False)
    out = {"root": os.path.abspath(a.root), "bytes": nbytes, "store_bytes": store,
           "spill_dir_fs": _fs_of(tempfile.gettempdir()),
           "mem_available_gb_at_start": _mem_available_gb()}
    samples, stop, phase = [], threading.Event(), ["put"]
    try:
        r = get_runtime()
        node = r.node_id if isinstance(r.node_id, str) else r.node_id.hex()

        def stats():
            return r._run(r.raylet.call("store_stats", {}), timeout=120)

        def health():
            return r._run(r.gcs.call("node_health", {}), timeout=5)[node]

        # A raylet round trip pending for more than 1.5 s makes the
        # raylet dump its threads' stacks into its log (SIGUSR1), at most
        # three times: where its event loop is stuck.
        pending, dumps = [None], []
        raylet_pid = rt_api._node_group.raylet_proc.pid

        def threads(pid):
            """Each thread's name, state and the kernel function it waits
            in (and its kernel stack where it can be read)."""
            rows = {}
            for tid in sorted(os.listdir(f"/proc/{pid}/task")):
                row = {}
                for key in ("comm", "wchan", "stack"):
                    try:
                        with open(f"/proc/{pid}/task/{tid}/{key}") as f:
                            row[key] = f.read().strip()[:600]
                    except OSError as e:
                        row[key] = repr(e)[:80]
                with open(f"/proc/{pid}/task/{tid}/stat") as f:
                    row["state"] = f.read().rsplit(")", 1)[1].split()[0]
                rows[tid] = row
            with open(f"/proc/{pid}/status") as f:
                mem = [ln.strip() for ln in f if ln.startswith(("VmRSS", "VmPTE", "RssAnon", "RssShmem"))]
            return {"mem": mem, "threads": rows}

        def watchdog():
            while not stop.is_set():
                t1 = pending[0]
                if t1 is not None and time.perf_counter() - t1 > 1.5 and len(dumps) < 3 and \
                        (not dumps or t1 != dumps[-1][1]):
                    try:
                        seen = threads(raylet_pid)
                    except OSError as e:
                        seen = repr(e)
                    os.kill(raylet_pid, signal.SIGUSR1)
                    dumps.append((phase[0], t1, round(time.perf_counter() - t_start, 3), seen))
                time.sleep(0.1)

        def sampler():
            while not stop.is_set():
                t, p = time.perf_counter(), phase[0]
                try:
                    h = health()
                    t1 = pending[0] = time.perf_counter()
                    stats()
                    pending[0] = None
                    samples.append((p, h["silent_s"], h["alive"], time.perf_counter() - t1,
                                    _mem_available_gb(), t - t_start))
                except Exception as e:  # noqa: BLE001 — reported as a sample
                    samples.append((p, None, None, repr(e), _mem_available_gb(), t - t_start))
                time.sleep(max(0.0, 0.05 - (time.perf_counter() - t)))

        @rt.remote(num_cpus=1)
        def read(refs):
            arr = rt.get(refs[0])
            copy = np.array(arr)
            return int(copy.sum(dtype=np.uint64))

        arr = np.full(nbytes, 7, dtype=np.uint8)
        t_start = time.perf_counter()
        th = threading.Thread(target=sampler, daemon=True)
        th.start()
        threading.Thread(target=watchdog, daemon=True).start()
        times = {}
        t0 = time.perf_counter()
        ref = rt.put(arr)
        del arr
        times["put"] = time.perf_counter() - t0
        phase[0], t0 = "spill", time.perf_counter()
        while stats()["spill_count"] < 1:
            if time.perf_counter() - t0 > 300:
                raise RuntimeError("the raylet did not spill the object in 300 s")
            time.sleep(0.2)
        times["spill"] = time.perf_counter() - t0
        phase[0], t0 = "read", time.perf_counter()
        try:
            out["read_ok"] = rt.get(read.remote([ref]), timeout=900) == 7 * nbytes
        except Exception as e:  # noqa: BLE001 — reported
            out["read_error"] = repr(e)
        times["read"] = time.perf_counter() - t0
        phase[0] = "after"
        time.sleep(2.0)
        stop.set()
        th.join()
        for p in ("put", "spill", "read", "after"):
            ok = [s for s in samples if s[0] == p and s[1] is not None]
            out[p] = {"s": times.get(p),
                      "max_silent_s": max((s[1] for s in ok), default=None),
                      "max_raylet_rtt_s": max((s[3] for s in ok), default=None),
                      "min_mem_available_gb": min((s[4] for s in samples if s[0] == p), default=None),
                      "samples": len(ok)}
        out["stack_dumps"] = [(p, round(t1 - t_start, 3), at) for p, t1, at, _ in dumps]
        if a.logs:
            os.makedirs(a.logs, exist_ok=True)
            with open(os.path.join(a.logs, "stalls.json"), "w") as f:
                json.dump(dumps, f, indent=1)
        out["failed_samples"] = [(s[0], s[3]) for s in samples if s[1] is None][:5]
        out["node_alive_at_end"] = next((s[2] for s in reversed(samples) if s[1] is not None), None)
        try:
            out["restore_count"] = stats()["restore_count"]
        except Exception as e:  # noqa: BLE001 — reported
            out["restore_count"] = repr(e)
    finally:
        stop.set()
        if a.logs:
            os.makedirs(a.logs, exist_ok=True)
            with open(os.path.join(a.logs, "samples.json"), "w") as f:
                json.dump({"fields": ["phase", "silent_s", "alive", "raylet_rtt_s",
                                      "mem_available_gb", "t_s"], "samples": samples}, f)
            for name in ("gcs.log", "raylet.log"):
                src = os.path.join(info["session_dir"], name)
                if os.path.exists(src):
                    with open(src, "rb") as f:
                        f.seek(max(0, os.path.getsize(src) - (256 << 10)))
                        tail = f.read()
                    with open(os.path.join(a.logs, name), "wb") as f:
                        f.write(tail)
        rt.shutdown()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
