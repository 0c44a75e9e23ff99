"""Per-request deadline context and the shed error of the serving traffic
plane: the part of ``ray_tpu/serve/traffic/config.py`` that the LLM engine
uses (``serve/llm.py``).

A replica records each request's deadline, a ``time.monotonic()``
timestamp of its own process, in a context variable
(``set_request_deadline``); the engine reads it when the request is
submitted (``get_request_deadline``), admits waiting requests
earliest-deadline first, and sheds one whose deadline lapsed before a slot
freed up with :class:`RequestShedError`.
"""

from __future__ import annotations

import contextvars
from typing import Optional


class RequestShedError(Exception):
    """Raised when a request is refused or expired instead of being queued
    past its SLO budget.  Carries the Retry-After hint a proxy surfaces
    (HTTP 503 / gRPC RESOURCE_EXHAUSTED)."""

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
    """Record the current request's deadline (``time.monotonic()`` frame of
    this process), or None for no deadline."""
    _request_deadline.set(deadline_monotonic)


def get_request_deadline() -> Optional[float]:
    """The current request's deadline as a local ``time.monotonic()``
    timestamp, or None when the caller attached no SLO."""
    return _request_deadline.get()
