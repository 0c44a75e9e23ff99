"""Worker -> driver log streaming.

Role-equivalent of ray: the log monitor + driver-side ``print_logs``
(python/ray/_private/log_monitor.py:103, worker.py print_logs).  The
reference tails every worker's log FILES from a per-node daemon and
routes lines to drivers over GCS pubsub; here the worker itself tees
``sys.stdout``/``sys.stderr`` (the file redirection set up by the raylet
stays in place underneath) and publishes line batches straight to the
``worker_logs`` pubsub channel — no extra daemon, no fs polling.

Caveat (documented divergence): C-level writes that bypass Python's
``sys.stdout`` (native extensions printing from C) land only in the
worker's log file, not on the driver.  ``ray_tpu_torch logs`` tails the files.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Optional

_FLUSH_INTERVAL_S = 0.1
_FLUSH_BYTES = 8192
_MAX_BUFFERED_LINES = 10_000  # drop (count) beyond this; never OOM


class _TeeStream:
    """File-like wrapper: passes writes through to the real stream (the
    worker's log file) and buffers complete lines for the publisher."""

    def __init__(self, inner, publisher: "_LogPublisher", stream_name: str):
        self._inner = inner
        self._pub = publisher
        self._name = stream_name
        self._partial = ""

    def write(self, s: str) -> int:
        n = self._inner.write(s)
        try:
            self._partial += s
            if "\n" in self._partial:
                *lines, self._partial = self._partial.split("\n")
                self._pub.add(self._name, lines)
        except Exception:
            pass  # streaming must never break user prints
        return n

    def flush(self) -> None:
        self._inner.flush()

    def writelines(self, lines) -> None:
        for line in lines:
            self.write(line)

    def fileno(self) -> int:
        return self._inner.fileno()

    def isatty(self) -> bool:
        return False

    @property
    def encoding(self):
        return getattr(self._inner, "encoding", "utf-8")

    def __getattr__(self, name):
        return getattr(self._inner, name)


class _LogPublisher:
    """Batches teed lines and ships them over GCS pubsub from a small
    daemon thread (user code may print from any thread; publishing from
    the io loop per line would make print() latency depend on the GCS)."""

    def __init__(self, rt):
        self.rt = rt
        self._lock = threading.Lock()
        self._buf: list = []  # (stream, line)
        self._dropped = 0
        self._actor_name: Optional[str] = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._flush_loop, name="rt-log-pub", daemon=True
        )
        self._thread.start()

    def set_actor_name(self, name: str) -> None:
        self._actor_name = name

    def add(self, stream: str, lines) -> None:
        with self._lock:
            room = _MAX_BUFFERED_LINES - len(self._buf)
            if room <= 0:
                self._dropped += len(lines)
                return
            if len(lines) > room:
                self._dropped += len(lines) - room
                lines = lines[:room]
            self._buf.extend((stream, ln) for ln in lines)

    def _flush_loop(self) -> None:
        while not self._closed:
            time.sleep(_FLUSH_INTERVAL_S)
            self.flush_now()

    def flush_now(self) -> None:
        with self._lock:
            if not self._buf and not self._dropped:
                return
            buf, self._buf = self._buf, []
            dropped, self._dropped = self._dropped, 0
        job = getattr(self.rt, "_current_job_hex", None)
        msg = {
            "pid": os.getpid(),
            "node": self.rt.node_id,
            "job": job,
            "actor": self._actor_name,
            "lines": [
                {"stream": s, "line": ln} for s, ln in buf
            ],
            "dropped": dropped,
        }
        try:
            self.rt.publish("worker_logs", msg)
        except Exception:
            pass  # GCS unreachable: lines stay in the log file

    def close(self) -> None:
        self._closed = True
        self.flush_now()


_publisher: Optional[_LogPublisher] = None


def install_worker_tee(rt) -> _LogPublisher:
    """Wrap this worker's stdout/stderr so task/actor prints stream to
    the driver.  The raylet's file redirection stays underneath."""
    global _publisher
    if _publisher is not None:
        return _publisher
    _publisher = _LogPublisher(rt)
    sys.stdout = _TeeStream(sys.stdout, _publisher, "stdout")
    sys.stderr = _TeeStream(sys.stderr, _publisher, "stderr")
    return _publisher


# ---- driver side ----------------------------------------------------------

def make_driver_printer(job_hex: Optional[str]):
    """Callback for Runtime.subscribe('worker_logs', ...): prints each
    line with a ``({actor} pid=..., node=...)`` prefix, like the
    reference's colorized ``(pid=..., ip=...)`` prefixes.  Lines from
    other jobs are dropped; lines with no job attribution are shown."""

    def _print(msg: dict) -> None:
        if msg.get("job") and job_hex and msg["job"] != job_hex:
            return
        pid = msg.get("pid")
        node = (msg.get("node") or "")[:8]
        actor = msg.get("actor")
        who = f"{actor} pid={pid}" if actor else f"pid={pid}"
        prefix = f"({who}, node={node}) "
        out = sys.stdout
        err = sys.stderr
        for item in msg.get("lines", ()):
            stream = err if item.get("stream") == "stderr" else out
            try:
                stream.write(prefix + item["line"] + "\n")
            except Exception:
                return
        if msg.get("dropped"):
            try:
                err.write(
                    f"{prefix}[{msg['dropped']} log lines dropped "
                    "(worker buffered too fast)]\n"
                )
            except Exception:
                return
        try:
            out.flush()
        except Exception:
            pass

    return _print
