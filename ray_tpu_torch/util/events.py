"""Structured cluster events.

Role-equivalent of ray: src/ray/util/event.h:41 (RAY_EVENT macro) +
dashboard/modules/event/ — collapsed to a bounded GCS-side log.  Core
transitions (node death, actor restart, OOM kills) record
automatically; applications report their own:

    from ray_tpu_torch.util import events
    events.report("WARNING", "ingest", "falling behind", lag_s=4.2)
    events.list_events(severity="ERROR")
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

SEVERITIES = ("DEBUG", "INFO", "WARNING", "ERROR", "FATAL")


def report(severity: str, source: str, message: str, **fields) -> None:
    """Record one structured event in the cluster event log."""
    if severity not in SEVERITIES:
        raise ValueError(f"severity must be one of {SEVERITIES}")
    from ray_tpu_torch.core.runtime import get_runtime

    rt = get_runtime()
    rt._run(rt.gcs.call("report_event", {
        "severity": severity,
        "source": source,
        "message": message,
        "fields": fields,
    }))


def list_events(severity: Optional[str] = None,
                limit: int = 500) -> List[Dict[str, Any]]:
    from ray_tpu_torch.core.runtime import get_runtime

    rt = get_runtime()
    return rt._run(rt.gcs.call("list_events", {
        "severity": severity,
        "limit": limit,
    }))
