"""Adaptive (phi-accrual) failure detection for the GCS health plane.

Role-equivalent of the reference's GcsHealthCheckManager (ray:
src/ray/gcs/gcs_server/gcs_health_check_manager.h) upgraded from a
fixed `last_heartbeat + timeout` boolean to an accrual detector in the
style of Hayashibara et al. ("The phi Accrual Failure Detector", SRDS
2004, the detector Akka/Cassandra ship): each node's inter-heartbeat
intervals feed a rolling window, and the *suspicion level*

    phi(t_now) = -log10( P(interval > t_now - t_last) )

is computed against the observed interval distribution instead of a
wall-clock constant.  A loaded node whose heartbeats stretch from
100 ms to 200 ms raises phi slowly (the history absorbs the new
normal); a partitioned node's phi climbs without bound.  Consumers map
phi onto a three-state machine:

    ALIVE    phi <  phi_suspect
    SUSPECT  phi >= phi_suspect   (deprioritized, nothing killed)
    DEAD     phi >= phi_death     (confirmed: fencing + recovery fire)

Two wall-clock guards bound the adaptive band (see gcs.py):
``node_death_timeout_s`` stays the hard cap (silence past it is death
regardless of history — detection latency never regresses vs the fixed
detector), and ``health_death_floor_frac`` of it is the floor (a CI
box stalling the whole process for a second must not mass-kill nodes
whose learned interval was 100 ms).

The distribution model is a normal tail with a floored standard
deviation (``min_std_frac`` x mean): a floor is what keeps a
metronome-regular heartbeat history (std ~ 0) from exploding phi on
the first 2x-late beat — the exact false-positive mode this detector
exists to remove.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Optional

__all__ = ["PhiAccrualDetector", "death_confirmed", "is_suspect"]

_SQRT2 = math.sqrt(2.0)
_LN10 = math.log(10.0)


class PhiAccrualDetector:
    """Per-node inter-heartbeat history + suspicion level.

    Not thread-safe by design: lives on the GCS event loop.  O(1) per
    heartbeat (rolling sum / sum-of-squares over a bounded window).
    """

    __slots__ = (
        "window", "min_std_frac", "min_samples",
        "_intervals", "_sum", "_sumsq", "_last",
    )

    def __init__(
        self,
        window: int = 64,
        min_std_frac: float = 0.35,
        min_samples: int = 5,
    ):
        self.window = max(2, int(window))
        self.min_std_frac = float(min_std_frac)
        self.min_samples = max(2, int(min_samples))
        self._intervals: deque = deque()
        self._sum = 0.0
        self._sumsq = 0.0
        self._last: Optional[float] = None

    # ---- recording -----------------------------------------------------
    def heartbeat(self, now: float) -> None:
        """Record one heartbeat arrival at monotonic time ``now``."""
        last = self._last
        self._last = now
        if last is None:
            return
        iv = now - last
        if iv <= 0.0:
            iv = 1e-9  # same-tick duplicates: keep the math finite
        self._intervals.append(iv)
        self._sum += iv
        self._sumsq += iv * iv
        if len(self._intervals) > self.window:
            old = self._intervals.popleft()
            self._sum -= old
            self._sumsq -= old * old

    # ---- queries -------------------------------------------------------
    @property
    def last_heartbeat(self) -> Optional[float]:
        return self._last

    def ready(self) -> bool:
        """Enough history for the adaptive verdict (before this, callers
        fall back to the fixed timeout)."""
        return len(self._intervals) >= self.min_samples

    def mean(self) -> float:
        n = len(self._intervals)
        return self._sum / n if n else 0.0

    def std(self) -> float:
        n = len(self._intervals)
        if n < 2:
            return 0.0
        m = self._sum / n
        var = self._sumsq / n - m * m
        return math.sqrt(var) if var > 0.0 else 0.0

    def phi(self, now: float) -> float:
        """Suspicion level at ``now``: 0 when a heartbeat just arrived /
        history is insufficient, growing without bound with silence."""
        if self._last is None or not self.ready():
            return 0.0
        elapsed = now - self._last
        m = self.mean()
        std = max(self.std(), self.min_std_frac * m, 1e-9)
        z = (elapsed - m) / std
        if z <= 0.0:
            return 0.0
        # phi = -log10(P(X > elapsed)), X ~ N(mean, std)
        p = 0.5 * math.erfc(z / _SQRT2)
        if p > 1e-300:
            return -math.log10(p)
        # erfc underflowed: asymptotic tail  P ~ pdf(z)/z
        return (z * z / 2.0 + math.log(z * math.sqrt(2.0 * math.pi))) / _LN10


def death_confirmed(phi: float, elapsed: float,
                    phi_death: float, floor_s: float, cap_s: float) -> bool:
    """The ONE death rule (GCS health loop and the failure_detection
    bench share it): phi past the death threshold with at least
    ``floor_s`` of silence, or silence past the hard cap ``cap_s``
    regardless of phi."""
    return (phi >= phi_death and elapsed >= floor_s) or elapsed > cap_s


def is_suspect(phi: float, phi_suspect: float) -> bool:
    return phi >= phi_suspect
