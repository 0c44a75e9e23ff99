"""Shared constants used by both the control plane and client APIs."""

import os
import tempfile


def session_root() -> str:
    """The directory under which the runtime writes its sessions, blobs,
    job dirs and runtime-env extracts: ``ray_tpu_torch`` in the process's
    temp dir (``TMPDIR``), so that runs with different temp dirs never
    share files."""
    return os.path.join(tempfile.gettempdir(), "ray_tpu_torch")

# Placement-group bundle strategies (ray: python/ray/util/placement_group.py
# `strategy` arg; src/ray/protobuf/common.proto PlacementStrategy).
PG_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")

# Placement-group lifecycle states.
PG_PENDING = "PENDING"
PG_CREATED = "CREATED"
PG_RESCHEDULING = "RESCHEDULING"
PG_REMOVED = "REMOVED"
