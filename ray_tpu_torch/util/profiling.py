"""Env-gated cProfile capture for the io-loop threads of every role.

Role-equivalent of ray: RAY_PROFILING / `ray timeline`'s perf-capture
side (python/ray/_private/profiling.py role) — but for the Python
control plane itself: set ``RT_PROFILE_DIR=/some/dir`` before starting
a cluster and every process (driver, worker, gcs, raylet) profiles its
io-loop thread, dumping ``<role>-<pid>.pstats`` there on clean exit.

The profiler runs INSIDE the loop thread (cProfile is per-thread), so
enable/disable are marshalled onto the loop.  Dumping is best-effort:
a SIGKILLed process leaves nothing, which is fine for a dev tool.
"""

from __future__ import annotations

import cProfile
import os
import threading
from typing import Optional

_active: Optional[tuple] = None  # (prof, path, loop)


def maybe_enable_loop_profile(loop, role: str) -> None:
    """If RT_PROFILE_DIR is set, start profiling ``loop``'s thread."""
    global _active
    d = os.environ.get("RT_PROFILE_DIR")
    if not d or _active is not None:
        return
    prof = cProfile.Profile()
    path = os.path.join(d, f"{role}-{os.getpid()}.pstats")
    _active = (prof, path, loop)
    loop.call_soon_threadsafe(prof.enable)


def dump_profile(timeout: float = 1.0) -> Optional[str]:
    """Stop the loop profiler and write the .pstats file; returns the
    path (None when profiling is off or the loop is already gone)."""
    global _active
    if _active is None:
        return None
    prof, path, loop = _active
    # dev-only tool: enable runs once at process startup, dump once at
    # shutdown — the planes never actually overlap in time
    # rtlint: disable-next=RT301
    _active = None
    done = threading.Event()

    def _stop():
        prof.disable()
        done.set()

    try:
        loop.call_soon_threadsafe(_stop)
        done.wait(timeout)
    except RuntimeError:
        pass  # loop closed: the profile holds whatever was captured
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        prof.dump_stats(path)
    except Exception:
        return None
    return path
