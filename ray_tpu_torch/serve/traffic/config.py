"""Traffic-plane configuration, shed error, and per-request deadline
context.

The traffic plane (scheduler + admission + queue-driven autoscaling)
activates for a deployment when its ``Deployment.traffic_config`` is
set; without one, serve behaves exactly as before (direct pow-2
dispatch, no admission control) — the depth-1 path is untouched.

Deadlines cross the proxy→replica boundary as a REMAINING BUDGET in
seconds (``DEADLINE_KWARG``), not an absolute timestamp: monotonic
clocks don't transfer between processes and wall clocks skew.  The
replica re-anchors the budget against its own monotonic clock on
arrival and exposes it via ``get_request_deadline()`` (same contextvar
pattern as serve.multiplex), which the LLM engine's slot admitter uses
for earliest-deadline-first admission.
"""

from __future__ import annotations

import contextvars
import dataclasses
from typing import Optional

#: kwarg under which the scheduler smuggles the remaining SLO budget
#: (seconds, float) to the replica; popped before the user callable
#: sees kwargs (exactly like multiplex.MODEL_ID_KWARG).
DEADLINE_KWARG = "__rt_slo_remaining_s__"


@dataclasses.dataclass
class TrafficConfig:
    """Per-deployment SLO + queueing policy (reference shape: the ray
    serve request-router/autoscaling knobs, collapsed to the queue
    model architecture.md documents).

    ``slo_ms`` is the admission→completion budget: requests predicted
    (or observed) to miss it are shed with a 503 + Retry-After instead
    of queueing unboundedly.
    """

    #: per-request deadline budget, admission to completion
    slo_ms: float = 1000.0
    #: hard cap of queued (admitted, undispatched) requests per
    #: deployment per routing process — the bounded queue
    max_queue_depth: int = 256
    #: floor for Retry-After hints on shed responses
    shed_retry_after_s: float = 1.0
    #: queue depth per replica the autoscaler treats as "backed up"
    #: (scale up on sustained depth past this)
    target_queue_depth_per_replica: float = 4.0
    #: how often each scheduler pushes depth/rate stats to the
    #: controller (the autoscaling signal)
    stats_push_interval_s: float = 0.5
    #: scale-down grace: a draining replica finishes its in-flight
    #: work for at most this long before it is stopped anyway
    drain_timeout_s: float = 30.0

    def to_wire(self) -> dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_wire(d: Optional[dict]) -> "Optional[TrafficConfig]":
        if d is None:
            return None
        if isinstance(d, TrafficConfig):
            return d
        known = {f.name for f in dataclasses.fields(TrafficConfig)}
        return TrafficConfig(**{k: v for k, v in d.items() if k in known})


class RequestShedError(Exception):
    """Raised when admission control refuses (or the scheduler expires)
    a request instead of queueing it past the SLO budget.  Carries the
    Retry-After hint the proxies surface (HTTP 503 / gRPC
    RESOURCE_EXHAUSTED)."""

    def __init__(self, reason: str, retry_after_s: float = 1.0,
                 deployment: str = ""):
        super().__init__(
            f"request shed{f' for {deployment!r}' if deployment else ''}: "
            f"{reason} (retry after {retry_after_s:.2f}s)"
        )
        self.reason = reason
        self.retry_after_s = float(retry_after_s)
        self.deployment = deployment

    def __reduce__(self):
        return (
            RequestShedError,
            (self.reason, self.retry_after_s, self.deployment),
        )


_request_deadline: contextvars.ContextVar = contextvars.ContextVar(
    "rt_serve_request_deadline", default=None
)


def set_request_deadline(deadline_monotonic: Optional[float]) -> None:
    """Replica-side: record this request's deadline (time.monotonic()
    reference frame of THIS process)."""
    _request_deadline.set(deadline_monotonic)


def get_request_deadline() -> Optional[float]:
    """Deadline of the current request as a local ``time.monotonic()``
    timestamp, or None when the caller attached no SLO (direct handle
    calls, deployments without a traffic config)."""
    return _request_deadline.get()
