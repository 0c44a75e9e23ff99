"""Scheduling strategy objects passed as ``scheduling_strategy=`` options.

Role-equivalent of ray: python/ray/util/scheduling_strategies.py
(PlacementGroupSchedulingStrategy:15, NodeAffinitySchedulingStrategy:41).
Each strategy lowers to a plain dict shipped with the lease request; the
GCS scheduler interprets it (core/gcs.py Scheduler.pick_node and
_request_pg_lease).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:
    from ray_tpu_torch.util.placement_group import PlacementGroup


@dataclass
class PlacementGroupSchedulingStrategy:
    """Run the task/actor inside a placement-group bundle.

    ``placement_group_bundle_index=-1`` means any bundle with room.
    """

    placement_group: "PlacementGroup"
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False

    def to_dict(self) -> dict:
        return {
            "type": "placement_group",
            "pg_id": self.placement_group.id.hex(),
            "bundle_index": self.placement_group_bundle_index,
        }


@dataclass
class NodeAffinitySchedulingStrategy:
    """Pin to a node by id; ``soft=True`` allows fallback elsewhere."""

    node_id: str
    soft: bool = False

    def to_dict(self) -> dict:
        return {"type": "node_affinity", "node_id": self.node_id, "soft": self.soft}


@dataclass
class SpreadSchedulingStrategy:
    """Prefer the least-utilized node (ray: "SPREAD" string strategy)."""

    def to_dict(self) -> dict:
        return {"type": "spread"}
