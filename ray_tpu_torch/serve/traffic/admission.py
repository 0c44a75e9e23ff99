"""Admission control + load shedding for one deployment's traffic.

The Podracer central-batcher lesson (arxiv 2104.06272) applied to
serving: the way to keep replicas saturated WITHOUT unbounded latency
is a short bounded queue in front of them — deep enough to ride out
service-time jitter, shallow enough that everything admitted still
makes its deadline.  This module is the policy half: given the queue
depth, the in-flight count, and an EWMA of observed completion
throughput, decide admit-or-shed and compute the Retry-After hint.

Shed decisions are O(1) arithmetic on counters the scheduler already
maintains — no locks, no RPCs — so the admission check sits on the
proxy's per-request hot path without showing up in depth-1 latency.
"""

from __future__ import annotations

import time
from typing import Optional

from ray_tpu_torch.serve.traffic.config import RequestShedError, TrafficConfig

#: EWMA horizon for the service-rate estimate, in completions.  Small
#: enough to track load shifts within a second of steady traffic, big
#: enough that one slow outlier doesn't crater the rate.
_RATE_ALPHA = 0.1

#: a cold controller (no completions observed yet) admits on depth
#: alone — shedding on a rate estimate of zero would refuse the very
#: requests that would have warmed it
_MIN_OBSERVATIONS = 4


class AdmissionController:
    """Per-deployment, per-routing-process admission policy.

    Owned by a RequestScheduler; all methods run on that scheduler's
    event loop (no locking).  Tracks:

    - ``inflight``/``queued`` — updated by the scheduler
    - completion-rate EWMA (requests/s across all replicas, as observed
      from THIS process)
    - shed/admit/complete counters for the stats push + bench
    """

    def __init__(self, config: TrafficConfig, deployment: str = ""):
        self.config = config
        self.deployment = deployment
        self.queued = 0
        self.inflight = 0
        # service-rate EWMA state
        self._rate: float = 0.0          # completions/s
        self._last_complete_t: Optional[float] = None
        self._completions = 0
        # counters (monotonic; the stats push sends deltas)
        self.admitted_total = 0
        self.shed_total = 0
        self.completed_total = 0
        self.expired_total = 0  # admitted but deadline passed in queue

    # -- signal updates (scheduler-driven) -------------------------------
    def on_admit(self) -> None:
        self.queued += 1
        self.admitted_total += 1

    def on_dispatch(self) -> None:
        self.queued -= 1
        self.inflight += 1

    def on_expire(self) -> None:
        """An admitted request's deadline passed while it waited."""
        self.queued -= 1
        self.expired_total += 1
        self.shed_total += 1

    def on_complete(self, now: Optional[float] = None) -> None:
        self.inflight -= 1
        self.completed_total += 1
        self._completions += 1
        t = time.monotonic() if now is None else now
        if self._last_complete_t is not None:
            dt = t - self._last_complete_t
            if dt > 0:
                inst = 1.0 / dt
                self._rate = (
                    inst if self._rate == 0.0
                    else (1 - _RATE_ALPHA) * self._rate + _RATE_ALPHA * inst
                )
        self._last_complete_t = t

    # -- policy ----------------------------------------------------------
    @property
    def service_rate(self) -> float:
        """Observed completions/s (EWMA), 0.0 while cold."""
        if self._completions < _MIN_OBSERVATIONS:
            return 0.0
        return self._rate

    def predicted_delay_s(self) -> float:
        """Expected queueing delay for the NEXT admitted request: the
        work ahead of it (queued, plus whatever is in flight beyond
        what completes "for free" this instant) divided by the observed
        drain rate.  0.0 while cold — depth caps govern the cold
        start."""
        rate = self.service_rate
        if rate <= 0.0:
            return 0.0
        return self.queued / rate

    def check(self) -> None:
        """Admit or raise RequestShedError.  Two independent trips:

        - depth: the bounded queue is full (backpressure made visible
          instead of buffering unboundedly), or
        - SLO: the predicted queueing delay alone already exceeds the
          end-to-end budget, so admitting would only manufacture a
          deadline miss the replica pays compute for.
        """
        c = self.config
        if self.queued >= c.max_queue_depth:
            self.shed_total += 1
            raise RequestShedError(
                f"queue depth {self.queued} at cap {c.max_queue_depth}",
                retry_after_s=self._retry_after(),
                deployment=self.deployment,
            )
        slo_s = c.slo_ms / 1000.0
        predicted = self.predicted_delay_s()
        if predicted > slo_s:
            self.shed_total += 1
            raise RequestShedError(
                f"predicted queueing delay {predicted * 1000:.0f}ms "
                f"exceeds the {c.slo_ms:.0f}ms SLO budget",
                retry_after_s=self._retry_after(),
                deployment=self.deployment,
            )

    def _retry_after(self) -> float:
        """Hint: time for the current backlog to drain to half the SLO
        budget at the observed rate, floored by config."""
        c = self.config
        rate = self.service_rate
        if rate <= 0.0:
            return c.shed_retry_after_s
        target_depth = max(1.0, rate * (c.slo_ms / 2000.0))
        excess = self.queued - target_depth
        return max(c.shed_retry_after_s, excess / rate)

    def expired_retry_after(self) -> float:
        return self._retry_after()

    def snapshot(self) -> dict:
        return {
            "queued": self.queued,
            "inflight": self.inflight,
            "rate": round(self.service_rate, 3),
            "admitted_total": self.admitted_total,
            "shed_total": self.shed_total,
            "expired_total": self.expired_total,
            "completed_total": self.completed_total,
        }
