"""Dataset execution statistics (port of ``ray_tpu/data/stats.py``,
unchanged).

Role-equivalent of ray: ``Dataset.stats()``
(python/ray/data/dataset.py:4573) + the _StatsActor
(data/_internal/stats.py) — per-stage wall time / blocks / rows / bytes,
collected from the fused stage tasks wherever they ran, plus cluster
store spill counters.

Stage tasks report fire-and-forget to one named stats actor; records
are keyed by a per-execution run id, so concurrent datasets (or
drivers) never mix.  Collection is always on (like the reference) and
costs one extra fire-and-forget actor call per block task.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Tuple

import ray_tpu_torch

STATS_ACTOR_NAME = "_rt_data_stats"
_MAX_RUNS = 256          # oldest runs evicted beyond this
_MAX_RECORDS_PER_STAGE = 10_000


@ray_tpu_torch.remote
class _StatsActor:
    """Cluster-wide sink for stage-task measurements."""

    def __init__(self):
        # run_id -> stage -> list[(wall_s, rows, bytes)]
        self._runs: Dict[str, Dict[str, List[Tuple[float, int, int]]]] = {}
        self._order: List[str] = []

    def record(self, run_id: str, stage: str, wall_s: float, rows: int,
               nbytes: int) -> None:
        run = self._runs.get(run_id)
        if run is None:
            run = self._runs[run_id] = {}
            self._order.append(run_id)
            while len(self._order) > _MAX_RUNS:
                self._runs.pop(self._order.pop(0), None)
        recs = run.setdefault(stage, [])
        if len(recs) < _MAX_RECORDS_PER_STAGE:
            recs.append((wall_s, rows, nbytes))

    def get(self, run_ids: List[str]) -> Dict[str, dict]:
        return {
            rid: {k: list(v) for k, v in self._runs.get(rid, {}).items()}
            for rid in run_ids
        }


_handle_cache: Any = None


def stats_handle():
    """The shared stats actor (created on first use, reused via name)."""
    global _handle_cache
    if _handle_cache is None:
        _handle_cache = _StatsActor.options(
            name=STATS_ACTOR_NAME, get_if_exists=True, num_cpus=0,
        ).remote()
    return _handle_cache


def record_stage(run_id: str, stage: str, t0: float, block) -> None:
    """Fire-and-forget one block-task measurement (called inside stage
    tasks on whatever worker ran them)."""
    try:
        rows = int(getattr(block, "num_rows", 0) or 0)
        nbytes = int(getattr(block, "nbytes", 0) or 0)
        # fire-and-forget BY DESIGN: stats are advisory, the enclosing
        # try swallows every failure, and holding refs would pin one
        # object per block task (rtflow RT202 audit: the ref is dropped,
        # never stored, so nothing pins the arena)
        # rtlint: disable-next=RT105
        stats_handle().record.remote(
            run_id, stage, time.perf_counter() - t0, rows, nbytes
        )
    except Exception:
        pass  # stats must never fail an execution


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GB"


def format_stats(
    runs: List[Tuple[str, str]],
    collected: Dict[str, dict],
    store_stats: Optional[dict] = None,
) -> str:
    """Render the reference-style per-stage summary.  ``runs`` is the
    execution lineage: (run_id, default_label) oldest first."""
    out: List[str] = []
    n = 0
    for run_id, label in runs:
        stages = collected.get(run_id) or {}
        if not stages:
            continue
        for stage, recs in stages.items():
            n += 1
            walls = [r[0] for r in recs]
            rows = sum(r[1] for r in recs)
            nbytes = sum(r[2] for r in recs)
            out.append(
                f"Stage {n} {stage or label}: {len(recs)} blocks executed"
            )
            out.append(
                "* Wall time: "
                f"{min(walls) * 1e3:.1f}ms min, {max(walls) * 1e3:.1f}ms "
                f"max, {sum(walls) / len(walls) * 1e3:.1f}ms mean, "
                f"{sum(walls):.3f}s total"
            )
            out.append(
                f"* Output rows: {rows} total, "
                f"{rows / max(1, len(recs)):.0f} mean per block"
            )
            out.append(
                f"* Output size: {_fmt_bytes(nbytes)} total, "
                f"{_fmt_bytes(nbytes / max(1, len(recs)))} mean per block"
            )
    if not out:
        out.append(
            "No execution stats recorded yet (consume or materialize the "
            "dataset first)."
        )
    if store_stats:
        spilled_n = sum(
            s.get("spill_count", 0) for s in store_stats.values()
            if isinstance(s, dict)
        )
        spilled_b = sum(
            s.get("spilled_bytes", 0) for s in store_stats.values()
            if isinstance(s, dict)
        )
        restored = sum(
            s.get("restore_count", 0) for s in store_stats.values()
            if isinstance(s, dict)
        )
        out.append(
            f"Cluster object store: {spilled_n} blocks spilled "
            f"({_fmt_bytes(spilled_b)}), {restored} restored"
        )
    return "\n".join(out)
