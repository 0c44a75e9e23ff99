"""Node memory monitor + OOM worker-killing policy.

Role-equivalent of ray: src/ray/common/memory_monitor.h:52 (usage
polling against a threshold) and raylet/worker_killing_policy*.cc (pick
a victim instead of letting the kernel OOM-killer take the raylet or
the GCS).  Runs as an asyncio task inside the raylet.

Usage is the max of system pressure (1 - MemAvailable/MemTotal from
/proc/meminfo) and cgroup-v2 pressure (memory.current/memory.max) so
containerized nodes respect their limit, not the host's.

Victim policy (reference: retriable-FIFO + group-by-owner, collapsed):
prefer the most recently leased busy worker — its task has the least
progress to lose and the core's existing worker-crash machinery retries
it; idle pooled workers are killed first since that fails nothing.
A killed worker surfaces to the driver as WorkerCrashedError with an
OOM hint in the reason, mirroring the reference's OomKiller message.

For tests (and only tests): `RT_MEMORY_MONITOR_FAKE_USAGE_FILE` points
at a file holding a float usage fraction that overrides measurement —
the same trick the reference plays with its fake memory monitor.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Optional

from ray_tpu_torch.common.config import cfg

logger = logging.getLogger(__name__)


def measure_usage_fraction() -> float:
    """Max of host and cgroup-v2 memory pressure, in [0, 1]."""
    fake = cfg.memory_monitor_fake_usage_file
    if fake:
        try:
            with open(fake) as f:
                return float(f.read().strip())
        except (OSError, ValueError):
            return 0.0
    frac = 0.0
    try:
        info = {}
        with open("/proc/meminfo") as f:
            for line in f:
                k, _, rest = line.partition(":")
                info[k] = int(rest.strip().split()[0])
        total = info.get("MemTotal", 0)
        avail = info.get("MemAvailable", 0)
        if total > 0:
            frac = 1.0 - avail / total
    except OSError:
        pass
    try:
        with open("/sys/fs/cgroup/memory.max") as f:
            raw = f.read().strip()
        if raw != "max":
            limit = int(raw)
            with open("/sys/fs/cgroup/memory.current") as f:
                cur = int(f.read().strip())
            if limit > 0:
                frac = max(frac, cur / limit)
    except (OSError, ValueError):
        pass
    return frac


class MemoryMonitor:
    def __init__(self, raylet):
        self.raylet = raylet
        self.kills = 0
        self._last_kill = 0.0

    def pick_victim(self):
        """Idle pooled workers first; else the most recently LEASED
        worker (leased_at, not spawn time — pooled workers are reused,
        so spawn order says nothing about task progress)."""
        workers = [
            w for w in self.raylet.workers.values()
            if w.proc.poll() is None
        ]
        idle = [w for w in workers if w.idle]
        if idle:
            return max(idle, key=lambda w: w.started_at), "idle"
        busy = [w for w in workers if w.lease_id is not None]
        if busy:
            return max(busy, key=lambda w: w.leased_at), "busy"
        return None, ""

    async def step(self) -> Optional[str]:
        """One poll; returns the killed worker id hex (or None)."""
        usage = measure_usage_fraction()
        if usage < cfg.memory_usage_threshold:
            return None
        # one kill per grace window: give freed memory time to register
        now = time.monotonic()
        if now - self._last_kill < cfg.memory_monitor_kill_grace_s:
            return None
        victim, kind = self.pick_victim()
        if victim is None:
            return None
        self._last_kill = now
        self.kills += 1
        logger.warning(
            "memory monitor: usage %.3f >= %.3f, killing %s worker %s",
            usage, cfg.memory_usage_threshold, kind,
            victim.worker_id.hex()[:12],
        )
        try:
            victim.proc.kill()
        except Exception:
            pass
        await self.raylet._on_worker_exit(
            victim,
            reason=(
                f"worker killed by the node memory monitor (node memory "
                f"usage {usage:.2f} >= threshold "
                f"{cfg.memory_usage_threshold:.2f}); task will be retried "
                "if retriable"
            ),
        )
        return victim.worker_id.hex()

    async def loop(self):
        while True:
            await asyncio.sleep(cfg.memory_monitor_interval_s)
            try:
                await self.step()
            except Exception:
                logger.exception("memory monitor step failed")
