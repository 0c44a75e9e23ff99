"""Unified state API: list/filter live cluster entities.

Role-equivalent of ray: python/ray/util/state/api.py (list_actors,
list_nodes, list_tasks, list_objects, list_placement_groups, summarize)
— sourced live from the GCS tables and a raylet→worker fan-out instead
of an event-backed state store.

Filters are ``(key, op, value)`` triples with op in {"=", "!="} applied
client-side, matching the reference's predicate shape.

Rows carry the port's resources: ``GPU`` (and ``GPU-<kind>``) where the
reference's carry ``TPU``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

Filter = Tuple[str, str, Any]


def _call(method: str, payload: Optional[dict] = None):
    from ray_tpu_torch.core.runtime import get_runtime

    rt = get_runtime()
    # state reads hit the GCS directory with no server-side wait: this
    # process's windowed object notifies (put announces, ref updates)
    # must flush first or a just-put object is invisible to the read
    rt.flush_object_notifies()
    return rt._run(rt.gcs.call(method, payload or {}))


def _apply_filters(rows: List[dict], filters: Optional[Sequence[Filter]]):
    if not filters:
        return rows
    out = []
    for row in rows:
        ok = True
        for key, op, want in filters:
            have = row.get(key)
            if op == "=":
                ok = have == want
            elif op == "!=":
                ok = have != want
            else:
                raise ValueError(f"unsupported filter op {op!r}")
            if not ok:
                break
        if ok:
            out.append(row)
    return out


def list_nodes(filters: Optional[Sequence[Filter]] = None) -> List[dict]:
    return _apply_filters(_call("get_nodes"), filters)


def list_actors(filters: Optional[Sequence[Filter]] = None) -> List[dict]:
    return _apply_filters(_call("list_actors", {}), filters)


def list_tasks(filters: Optional[Sequence[Filter]] = None) -> List[dict]:
    """Live running tasks across the cluster (worker fan-out)."""
    rows: List[dict] = []
    for w in _call("list_tasks"):
        for t in w.get("running_tasks", []):
            rows.append({
                "task_id": t["task_id"],
                "name": t["name"],
                "start_time": t["start_time"],
                "worker_id": w["worker_id"],
                "node_id": w["node_id"],
                "actor_class": w.get("actor_class"),
            })
    return _apply_filters(rows, filters)


def list_workers(filters: Optional[Sequence[Filter]] = None) -> List[dict]:
    rows = [
        {
            "worker_id": w["worker_id"],
            "node_id": w["node_id"],
            "pid": w.get("pid"),
            "actor_class": w.get("actor_class"),
            "leased": w.get("leased"),
            "num_running_tasks": len(w.get("running_tasks", [])),
        }
        for w in _call("list_tasks")
    ]
    return _apply_filters(rows, filters)


def list_objects(
    filters: Optional[Sequence[Filter]] = None, limit: int = 1000
) -> List[dict]:
    return _apply_filters(_call("list_objects", {"limit": limit}), filters)


def list_placement_groups(
    filters: Optional[Sequence[Filter]] = None,
) -> List[dict]:
    return _apply_filters(_call("list_placement_groups", {}), filters)


def get_metrics() -> List[dict]:
    """Cluster-aggregated application metrics (util.metrics)."""
    return _call("get_metrics")


def summarize() -> Dict[str, Any]:
    """One-shot cluster summary (ray: `ray status` + summarize APIs)."""
    nodes = list_nodes()
    actors = list_actors()
    resources = _call("cluster_resources")
    demand = _call("get_autoscaler_state")
    return {
        "nodes_alive": sum(1 for n in nodes if n["alive"]),
        "nodes_total": len(nodes),
        "actors_alive": sum(1 for a in actors if a.get("state") == "ALIVE"),
        "actors_total": len(actors),
        "resources_total": resources["total"],
        "resources_available": resources["available"],
        "pending_leases": len(demand["pending_leases"]),
        "pending_pg_bundles": sum(
            len(b["bundles"]) for b in demand["pending_pg_bundles"]
        ),
    }


def memory_summary() -> Dict[str, Any]:
    """Per-node object-store usage (ray: `ray memory` / memory_summary)."""
    return _call("cluster_store_stats")


def worker_stacks(worker_id: str) -> Dict[str, Any]:
    """Per-thread Python stacks of a live worker, captured on demand
    (reference role: the dashboard's py-spy stack profiling —
    dashboard/modules/reporter/profile_manager.py:83).  ``worker_id``
    is the hex id from list_workers()."""
    return _call(
        "dump_worker_stacks", {"worker_id": bytes.fromhex(worker_id)}
    )


# single implementation lives in util.events; re-exported here so the
# state API surface is complete (ray: list_cluster_events)
from ray_tpu_torch.util.events import list_events  # noqa: E402,F401
