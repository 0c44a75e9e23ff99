"""ray_tpu_torch.util: placement groups, scheduling strategies, the actor pool.

Role-equivalent of ray: python/ray/util/.
"""

from ray_tpu_torch.util.placement_group import (  # noqa: F401
    PlacementGroup,
    get_placement_group,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from ray_tpu_torch.util.scheduling_strategies import (  # noqa: F401
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
    SpreadSchedulingStrategy,
)
from ray_tpu_torch.util.actor_pool import ActorPool  # noqa: F401
