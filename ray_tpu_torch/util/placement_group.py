"""Placement groups: gang reservations of resource bundles across nodes.

Role-equivalent of ray: python/ray/util/placement_group.py (PlacementGroup:41,
placement_group():145).  On a TPU cluster this is the primitive under every
SPMD worker group: STRICT_PACK pins a group to one host's chips,
STRICT_SPREAD lays one bundle per host of a slice.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ray_tpu_torch.common.constants import PG_STRATEGIES as VALID_STRATEGIES
from ray_tpu_torch.common.ids import PlacementGroupID


def _rt():
    from ray_tpu_torch.core.runtime import get_runtime

    return get_runtime()


class PlacementGroup:
    """Handle to a placement group (live or pending)."""

    def __init__(self, pg_id: PlacementGroupID, bundles: List[Dict[str, float]]):
        self.id = pg_id
        self._bundles = [dict(b) for b in bundles]

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return [dict(b) for b in self._bundles]

    @property
    def bundle_count(self) -> int:
        return len(self._bundles)

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        """Block until every bundle is reserved; False on timeout."""
        rt = _rt()
        reply = rt._run(
            rt.gcs.call(
                "wait_placement_group_ready",
                {"pg_id": self.id.binary(), "timeout": timeout_seconds},
                timeout=timeout_seconds + 10,
            )
        )
        return reply["state"] == "CREATED"

    def ready(self):
        """ObjectRef that resolves when the group is fully reserved.

        Like the reference (placement_group.py:81), implemented as a
        zero-resource probe task scheduled into the group.
        """
        from ray_tpu_torch.core.api import remote
        from ray_tpu_torch.util.scheduling_strategies import (
            PlacementGroupSchedulingStrategy,
        )

        @remote
        def _pg_ready_probe():
            return True

        return _pg_ready_probe.options(
            num_cpus=0,
            scheduling_strategy=PlacementGroupSchedulingStrategy(self),
            max_retries=3,
        ).remote()

    def __reduce__(self):
        return (PlacementGroup, (self.id, self._bundles))

    def __repr__(self):
        return f"PlacementGroup({self.id.hex()[:12]}, {len(self._bundles)} bundles)"


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
    lifetime: Optional[str] = None,
    namespace: str = "default",
) -> PlacementGroup:
    """Reserve ``bundles`` across the cluster per ``strategy``.

    Returns immediately; use ``pg.wait()`` / ``ray_tpu_torch.get(pg.ready())``
    to block until reserved.
    """
    if strategy not in VALID_STRATEGIES:
        raise ValueError(
            f"strategy must be one of {VALID_STRATEGIES}, got {strategy!r}"
        )
    if not bundles:
        raise ValueError("placement group needs at least one bundle")
    for b in bundles:
        if not b or all(v == 0 for v in b.values()):
            raise ValueError(f"bundles must be non-empty, got {b!r}")
    rt = _rt()
    pg_id = PlacementGroupID.random()
    rt._run(
        rt.gcs.call(
            "create_placement_group",
            {
                "pg_id": pg_id.binary(),
                "bundles": bundles,
                "strategy": strategy,
                "name": name,
                "namespace": namespace,
                "job_id": rt.job_id.binary() if rt.job_id else None,
                "detached": lifetime == "detached",
            },
        )
    )
    return PlacementGroup(pg_id, bundles)


def remove_placement_group(pg: PlacementGroup) -> None:
    """Release the reservation; kills actors/tasks running inside it."""
    rt = _rt()
    rt._run(rt.gcs.call("remove_placement_group", {"pg_id": pg.id.binary()}))


def get_placement_group(name: str, namespace: str = "default") -> PlacementGroup:
    """Look up a live placement group by name."""
    rt = _rt()
    info = rt._run(
        rt.gcs.call(
            "get_placement_group", {"name": name, "namespace": namespace}
        )
    )
    if info is None or info["state"] == "REMOVED":
        raise ValueError(f"no live placement group named {name!r}")
    return PlacementGroup(PlacementGroupID(info["pg_id"]), info["bundles"])


def placement_group_table() -> Dict[str, dict]:
    """All placement groups and their bundle states (ray: placement_group_table)."""
    rt = _rt()
    infos = rt._run(rt.gcs.call("list_placement_groups", {}))
    return {
        PlacementGroupID(i["pg_id"]).hex(): {
            "name": i["name"],
            "strategy": i["strategy"],
            "state": i["state"],
            "bundles": i["bundles"],
            "bundle_nodes": i["bundle_nodes"],
            "bundles_available": i["bundles_available"],
        }
        for i in infos
    }
