"""Resource accounting with fixed-point arithmetic.

Role-equivalent of the reference's ResourceSet/FixedPoint (ray:
src/ray/common/scheduling/resource_set.h:31, fixed_point.h) redesigned for a
TPU cluster: besides the scalar resources ("CPU", "memory",
"object_store_memory"), TPU capacity is modelled as

  - ``TPU``                 — number of chips on the host
  - ``TPU-<gen>`` (e.g. TPU-v5e)  — generation-tagged chip count
  - ``<slice_name>``        — 1.0 on every host of a named slice (gang affinity)
  - ``TPU-<topology>-head`` — 1.0 only on worker 0 of a slice (coordinator
                              election for SPMD groups; mirrors the semantics
                              of ray: python/ray/_private/accelerators/tpu.py:376-397)

All quantities are stored as integers in units of 1/10000 so fractional
requests (e.g. {"CPU": 0.5}) compose exactly.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

GRANULARITY = 10000

TPU_RESOURCE = "TPU"
CPU_RESOURCE = "CPU"
GPU_RESOURCE = "GPU"
MEMORY_RESOURCE = "memory"
OBJECT_STORE_MEMORY = "object_store_memory"

# Resources where fractional allocation of a single unit makes no sense and a
# request > 1 must be an integer (mirrors the reference's UNIT_INSTANCE set).
UNIT_INSTANCE_RESOURCES = {TPU_RESOURCE, GPU_RESOURCE}


def _to_fixed(v: float) -> int:
    fp = round(v * GRANULARITY)
    if fp < 0:
        raise ValueError(f"negative resource quantity: {v}")
    if fp == 0 and v > 0:
        raise ValueError(
            f"resource quantity {v} is below the minimum granularity "
            f"of {1 / GRANULARITY}"
        )
    return fp


class ResourceSet:
    """A bag of named resource quantities (fixed-point)."""

    __slots__ = ("_fp",)

    def __init__(self, quantities: Mapping[str, float] | None = None, *, _fp=None):
        if _fp is not None:
            self._fp: Dict[str, int] = {k: v for k, v in _fp.items() if v > 0}
        else:
            self._fp = {}
            for k, v in (quantities or {}).items():
                fp = _to_fixed(v)
                if fp > 0:
                    self._fp[k] = fp

    # -- queries ---------------------------------------------------------
    def get(self, name: str) -> float:
        return self._fp.get(name, 0) / GRANULARITY

    def keys(self) -> Iterable[str]:
        return self._fp.keys()

    def is_empty(self) -> bool:
        return not self._fp

    def to_dict(self) -> Dict[str, float]:
        return {k: v / GRANULARITY for k, v in self._fp.items()}

    def covers(self, demand: "ResourceSet") -> bool:
        """True if every demanded quantity is available here."""
        for k, v in demand._fp.items():
            if self._fp.get(k, 0) < v:
                return False
        return True

    def utilization(self, total: "ResourceSet") -> float:
        """Max fractional utilization across resources present in `total`,
        treating self as the *available* amount. Used by the scheduler's
        binpack/spread scoring."""
        worst = 0.0
        for k, cap in total._fp.items():
            if cap <= 0:
                continue
            avail = self._fp.get(k, 0)
            used = (cap - avail) / cap
            worst = max(worst, used)
        return worst

    # -- arithmetic ------------------------------------------------------
    def add(self, other: "ResourceSet") -> "ResourceSet":
        fp = dict(self._fp)
        for k, v in other._fp.items():
            fp[k] = fp.get(k, 0) + v
        return ResourceSet(_fp=fp)

    def subtract(self, other: "ResourceSet") -> "ResourceSet":
        """Subtract; raises if it would go negative."""
        fp = dict(self._fp)
        for k, v in other._fp.items():
            nv = fp.get(k, 0) - v
            if nv < 0:
                raise ValueError(f"resource {k} would go negative")
            fp[k] = nv
        return ResourceSet(_fp=fp)

    def __eq__(self, other):
        return isinstance(other, ResourceSet) and self._fp == other._fp

    def __repr__(self):
        return f"ResourceSet({self.to_dict()})"

    def __reduce__(self):
        return (_resource_set_from_fp, (dict(self._fp),))


def _resource_set_from_fp(fp):
    return ResourceSet(_fp=fp)


def validate_task_resources(res: Mapping[str, float]) -> None:
    for k, v in res.items():
        if v < 0:
            raise ValueError(f"resource {k!r} quantity must be >= 0, got {v}")
        if k in UNIT_INSTANCE_RESOURCES and v > 1 and v != int(v):
            raise ValueError(
                f"{k} request must be an integer when > 1 (got {v}); "
                "fractional requests are only allowed for a single unit"
            )
