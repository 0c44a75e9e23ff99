"""Autoscaler: elastic nodes driven by pending demand.

Role-equivalent of the reference's autoscaler v2 (ray:
python/ray/autoscaler/v2/scheduler.py:624, instance_manager/
reconciler.py:53) collapsed to the shape of the problem: node types are
host shapes (CPUs and cards, ``{"CPU": 8, "GPU": 1}``), demand is pending
leases + unplaced placement-group bundles read straight from the GCS, and
the reconcile loop is a single bin-packing pass — no instance-manager
state machine, because a node is provisioned by one create/delete call.

Imports no torch: the monitor process and the providers are control
plane.  The reference's TPU-slice provider and its Cloud TPU API client
are not ported (ROADMAP A4).
"""

from ray_tpu_torch.autoscaler.autoscaler import Autoscaler, AutoscalerConfig, NodeTypeConfig
from ray_tpu_torch.autoscaler.node_provider import (
    LocalSubprocessProvider,
    NodeProvider,
)

__all__ = [
    "Autoscaler",
    "AutoscalerConfig",
    "NodeTypeConfig",
    "NodeProvider",
    "LocalSubprocessProvider",
]
