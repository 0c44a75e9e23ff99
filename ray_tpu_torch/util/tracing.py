"""Distributed tracing: spans around task/actor submit + execute with
W3C trace context propagated in the TaskSpec.

Role-equivalent of ray: python/ray/util/tracing/tracing_helper.py:34
(_OpenTelemetryProxy + the submit/execute span wrappers, context carried
in TaskOptions["_ray_trace_ctx"]).  Design differences, TPU-image
reality: the OpenTelemetry *API* is available but no SDK is baked in, so
spans are recorded by a built-in lightweight tracer (W3C-compatible
trace/span ids, bounded in-process ring + optional GCS event export) and
BRIDGED to OpenTelemetry when an application has installed a real
TracerProvider — `pip install opentelemetry-sdk` + set_tracer_provider
and ray_tpu_torch spans appear in your OTel backend with no further wiring.

Tracing is off by default (zero overhead on the hot paths: one module
flag check).  Enable with ``ray_tpu_torch.util.tracing.enable()`` in the
driver or ``RT_TRACING_ENABLED=1`` cluster-wide (workers inherit env).
"""

from __future__ import annotations

import contextvars
import os
import secrets
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

_enabled: Optional[bool] = None  # tri-state: None = read env on first use
_SPANS: deque = deque(maxlen=4096)  # newest-last ring of finished spans
_LOCK = threading.Lock()

#: current span context: (trace_id_hex32, span_id_hex16) or None
_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "rt_trace_ctx", default=None
)

CARRIER_KEY = "traceparent"  # W3C trace context header


def enable() -> None:
    global _enabled
    _enabled = True
    os.environ["RT_TRACING_ENABLED"] = "1"  # workers spawned later inherit


def disable() -> None:
    global _enabled
    _enabled = False
    # mirror enable(): workers spawned from now on must not inherit a
    # stale flag and keep exporting span events forever
    os.environ.pop("RT_TRACING_ENABLED", None)


def enabled() -> bool:
    global _enabled
    if _enabled is None:
        _enabled = os.environ.get("RT_TRACING_ENABLED", "") in (
            "1", "true", "True",
        )
    return _enabled


# -- context propagation (W3C traceparent) ---------------------------------


def inject() -> Optional[Dict[str, str]]:
    """Carrier dict for the current trace context, to ride a TaskSpec.
    Starts a fresh trace when none is active (every task belongs to some
    trace once tracing is on)."""
    cur = _CURRENT.get()
    if cur is None:
        cur = (secrets.token_hex(16), secrets.token_hex(8))
    return {CARRIER_KEY: f"00-{cur[0]}-{cur[1]}-01"}


def _extract(carrier: Optional[Dict[str, str]]):
    if not carrier:
        return None
    try:
        _ver, trace_id, span_id, _flags = carrier[CARRIER_KEY].split("-")
        return (trace_id, span_id)
    except (KeyError, ValueError):
        return None


# -- spans -----------------------------------------------------------------


class Span:
    """One span; context-manager.  Records into the process-local ring
    and mirrors to an OpenTelemetry tracer when a real provider is
    installed."""

    __slots__ = (
        "name", "trace_id", "span_id", "parent_id", "start", "end",
        "attrs", "_token", "_otel_span", "_otel_token",
    )

    def __init__(self, name: str, parent, attrs: Dict[str, Any]):
        self.name = name
        self.trace_id = parent[0] if parent else secrets.token_hex(16)
        self.span_id = secrets.token_hex(8)
        self.parent_id = parent[1] if parent else None
        self.start = time.time()
        self.end = None
        self.attrs = attrs
        self._token = None
        self._otel_span = None
        self._otel_token = None

    def __enter__(self):
        self._token = _CURRENT.set((self.trace_id, self.span_id))
        otel = _otel_tracer()
        if otel is not None:
            try:
                from opentelemetry import context as otel_ctx
                from opentelemetry import trace as otel_trace
                from opentelemetry.trace.propagation.tracecontext import (
                    TraceContextTextMapPropagator,
                )

                parent_ctx = None
                if self.parent_id:
                    parent_ctx = TraceContextTextMapPropagator().extract({
                        CARRIER_KEY:
                            f"00-{self.trace_id}-{self.parent_id}-01",
                    })
                self._otel_span = otel.start_span(
                    self.name, context=parent_ctx, attributes=self.attrs
                )
                self._otel_token = otel_ctx.attach(
                    otel_trace.set_span_in_context(self._otel_span)
                )
            except Exception:
                self._otel_span = None
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end = time.time()
        if exc_type is not None:
            self.attrs["error"] = f"{exc_type.__name__}"
        _CURRENT.reset(self._token)
        if self._otel_span is not None:
            try:
                from opentelemetry import context as otel_ctx

                if exc is not None:
                    self._otel_span.record_exception(exc)
                self._otel_span.end()
                if self._otel_token is not None:
                    otel_ctx.detach(self._otel_token)
            except Exception:
                pass
        d = self.to_dict()
        with _LOCK:
            _SPANS.append(d)
        # aggregate cluster-wide via the GCS event ring (queryable with
        # events.list_events / the dashboard), fire-and-forget so a span
        # exit never blocks the worker's io loop
        if os.environ.get("RT_TRACING_EXPORT_EVENTS", "1") == "1":
            try:
                from ray_tpu_torch.core.runtime import get_runtime

                rt = get_runtime()
                rt._spawn(rt.gcs.notify("report_event", {
                    "severity": "DEBUG",
                    "source": "tracing",
                    "message": self.name,
                    "fields": d,
                }))
            except Exception:
                pass  # no runtime (unit test) / shutdown race
        return False

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "start": self.start,
            "end": self.end,
            "duration_ms": round(((self.end or self.start) - self.start)
                                 * 1e3, 3),
            "attributes": dict(self.attrs),
            "pid": os.getpid(),
        }


def _otel_tracer():
    """An OpenTelemetry tracer IFF the app installed a real provider
    (the API's default ProxyTracerProvider is a no-op — bridging to it
    would just burn cycles)."""
    try:
        from opentelemetry import trace as otel_trace

        provider = otel_trace.get_tracer_provider()
        if type(provider).__name__ in (
            "ProxyTracerProvider", "NoOpTracerProvider",
        ):
            return None
        return otel_trace.get_tracer("ray_tpu_torch")
    except Exception:
        return None


def span(name: str, carrier: Optional[Dict[str, str]] = None,
         **attrs) -> Span:
    """Start a span.  ``carrier``: remote parent context (a TaskSpec's
    trace_ctx); otherwise the ambient context is the parent."""
    parent = _extract(carrier) if carrier is not None else _CURRENT.get()
    return Span(name, parent, attrs)


def spans(trace_id: Optional[str] = None) -> List[dict]:
    """Finished spans recorded in THIS process (newest last)."""
    with _LOCK:
        out = list(_SPANS)
    if trace_id:
        out = [s for s in out if s["trace_id"] == trace_id]
    return out


def clear() -> None:
    with _LOCK:
        _SPANS.clear()
