"""ray_tpu_torch.util.collective: runtime actor-group collectives.

Role-equivalent of ray: python/ray/util/collective/ — allreduce /
allgather / reducescatter / broadcast / barrier / send / recv between
arbitrary actor groups AT RUNTIME (out-of-program).

Quick shape::

    from ray_tpu_torch.util import collective as col

    # inside each member actor (or col.create_collective_group(actors)
    # from the driver):
    col.init_collective_group(world_size=4, rank=r, backend="rpc")
    reduced = col.allreduce(my_grads)          # numpy in, numpy out
    w = col.broadcast_object(w if r == 0 else None, src_rank=0)
    col.destroy_collective_group()

Backends: ``"rpc"`` (alias ``"gloo"``; ring algorithms over the duplex
worker RPC plane, zero-copy shm-arena handoff between co-hosted ranks) and
``"nccl"`` (the members' own ``torch.distributed`` gang: NCCL where their
leases hold cards, gloo where they do not).  The in-program
``"device_mesh"`` adapter names the collectives over a mesh's axes
(``ray_tpu_torch.parallel.collectives``).  The reference's ``"jax"`` gang
and ``"xla"`` adapter raise ``CollectiveError`` naming these.

``broadcast_tree`` also carries ``torch.Tensor`` leaves, dtype and shape
kept; torch is reached through ``sys.modules``, never imported here.

The module-level ops BLOCK and are for sync actor methods; from
``async def`` bodies use the ``*_async`` twins or hand the call to a
thread — rtlint rule RT109 enforces this.

Fault tolerance: a member death poisons the group; instead of a full
teardown, survivors can call ``reform_collective_group(new_world)`` to
re-run rendezvous with the survivors (shrink) or with a replacement
member joining under the dead rank — see docs/architecture.md "Fault
injection & recovery".
"""

from ray_tpu_torch.util.collective.backend import (  # noqa: F401
    available_backends,
    register_backend,
)
from ray_tpu_torch.util.collective.collective import (  # noqa: F401
    CollectiveWork,
    allgather,
    allgather_async,
    allgather_launch,
    allreduce,
    allreduce_async,
    allreduce_launch,
    barrier,
    barrier_async,
    broadcast,
    broadcast_async,
    broadcast_launch,
    broadcast_object,
    broadcast_object_async,
    broadcast_tree,
    broadcast_tree_async,
    create_collective_group,
    destroy_collective_group,
    get_backend,
    get_collective_group_size,
    get_group_options,
    get_rank,
    init_collective_group,
    is_group_initialized,
    local_group_memberships,
    recv,
    recv_async,
    recv_launch,
    reducescatter,
    reducescatter_async,
    reform_collective_group,
    reform_collective_group_async,
    send,
    send_async,
    send_launch,
)
from ray_tpu_torch.util.collective.channel import (  # noqa: F401
    ChannelError,
    ChannelReceiver,
    ChannelSender,
)
from ray_tpu_torch.util.collective.types import (  # noqa: F401
    CollectiveError,
    CollectiveGroupError,
    CollectiveTimeoutError,
    GroupOptions,
    ReduceOp,
    RendezvousTimeoutError,
)
