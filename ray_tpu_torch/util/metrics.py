"""Application metrics: Counter / Gauge / Histogram.

Role-equivalent of ray: python/ray/util/metrics.py:137 (Metric, Counter,
Gauge, Histogram) with the export pipeline collapsed: instead of
OpenCensus → dashboard agent → Prometheus, every process keeps one
in-memory registry and the runtime pushes snapshots to the GCS
(rpc_metrics_push) on an interval; `ray_tpu_torch.util.state.get_metrics()`
(or the CLI `status --metrics`) reads the cluster aggregate.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_registry_lock = threading.Lock()
_registry: List["Metric"] = []


def _tags_key(tags: Optional[Dict[str, str]]) -> str:
    return json.dumps(sorted((tags or {}).items()))


class Metric:
    TYPE = "none"

    def __init__(
        self,
        name: str,
        description: str = "",
        tag_keys: Sequence[str] = (),
    ):
        if not name:
            raise ValueError("metric name must be non-empty")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        self._series: Dict[str, float] = {}
        self._lock = threading.Lock()
        with _registry_lock:
            _registry.append(self)

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def _resolve_tags(self, tags: Optional[Dict[str, str]]) -> str:
        merged = dict(self._default_tags)
        merged.update(tags or {})
        extra = set(merged) - set(self.tag_keys)
        if extra:
            raise ValueError(
                f"tags {sorted(extra)} not in declared tag_keys "
                f"{list(self.tag_keys)} for metric {self.name!r}"
            )
        return _tags_key(merged)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "name": self.name,
                "type": self.TYPE,
                "description": self.description,
                "series": dict(self._series),
            }


class Counter(Metric):
    """Monotonically increasing value (ray: util/metrics.py Counter)."""

    TYPE = "counter"

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        if value < 0:
            raise ValueError("counters only increase")
        key = self._resolve_tags(tags)
        with self._lock:
            self._series[key] = self._series.get(key, 0.0) + value


class Gauge(Metric):
    """Last-value metric (ray: util/metrics.py Gauge)."""

    TYPE = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = self._resolve_tags(tags)
        with self._lock:
            self._series[key] = float(value)


class Histogram(Metric):
    """Bucketed distribution: exports per-bucket cumulative counts plus
    _sum/_count series (Prometheus-style; ray: util/metrics.py Histogram).
    """

    TYPE = "histogram"

    def __init__(
        self,
        name: str,
        description: str = "",
        boundaries: Sequence[float] = (),
        tag_keys: Sequence[str] = (),
    ):
        if not boundaries or list(boundaries) != sorted(boundaries):
            raise ValueError("histogram needs sorted, non-empty boundaries")
        super().__init__(name, description, tag_keys)
        self.boundaries = tuple(float(b) for b in boundaries)

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = self._resolve_tags(tags)
        with self._lock:
            for b in self.boundaries:
                if value <= b:
                    bkey = f"{key}|le={b}"
                    self._series[bkey] = self._series.get(bkey, 0.0) + 1.0
            inf_key = f"{key}|le=+Inf"
            self._series[inf_key] = self._series.get(inf_key, 0.0) + 1.0
            self._series[f"{key}|sum"] = (
                self._series.get(f"{key}|sum", 0.0) + value
            )


def registry_snapshot() -> List[dict]:
    """All metrics of this process (what the runtime pushes to the GCS)."""
    with _registry_lock:
        metrics = list(_registry)
    return [m.snapshot() for m in metrics if m._series]
