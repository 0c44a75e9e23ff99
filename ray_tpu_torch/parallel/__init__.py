"""SPMD parallelism over torch device meshes (dp/fsdp/ep/pp/sp/tp), port of
``ray_tpu/parallel``: mesh construction over a process group's ranks
(``mesh``), logical-axis sharding rules (``sharding``), collectives over a
mesh's axes (``collectives``), the sharded training step (``spmd``) and
GPipe over the pp axis (``pipeline``)."""

from ray_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER,
    DATA_AXES,
    DP_AXIS,
    EP_AXIS,
    FSDP_AXIS,
    PP_AXIS,
    SP_AXIS,
    TP_AXIS,
    MeshConfig,
    make_mesh,
)
from ray_tpu_torch.parallel.sharding import (  # noqa: F401
    DEFAULT_RULES,
    constrain,
    logical_to_spec,
    replicated,
    tree_shardings,
)
from ray_tpu_torch.parallel import collectives  # noqa: F401
