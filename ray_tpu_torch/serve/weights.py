"""Collective weight push for serve deployments (Collectives v2).

Live weight updates for replicated deployments: the driver ships the
new weights ONCE (to rank 0, as a task argument over the object
plane), a transient collective group fans them out replica-to-replica
(ring/btree over RPC + shm — no N-fold driver upload), and every
replica applies them through its ``update_weights`` method.  The
weights are a pytree of numpy arrays or a model's state dict of
``torch.Tensor`` leaves (``LlamaDeployment.update_weights`` takes the
latter); bf16 tensors travel exactly, through the serializer's tensor
reducer.  With ``wire_dtype="bf16"|"int8"`` the float32 leaves ride the
block-quantized tensor path — every replica (rank 0 included) adopts
the decode of the single encoding, so the fleet stays bit-identical,
which is exactly the invariant replicated serving needs (two replicas
answering the same prompt differently is a correctness bug; a bounded
quantization delta vs the trainer's copy is a quality knob).

Quick shape::

    from ray_tpu_torch.serve import weights as sw

    # by deployment name (replica handles fetched from the controller):
    sw.push_deployment_weights("llm", model.state_dict(), wire_dtype="bf16")

    # or directly over actor handles (any actors with the method):
    sw.push_weights(actors, new_params, wire_dtype="int8")
"""

from __future__ import annotations

import uuid
from typing import Any, List, Optional

__all__ = ["push_weights", "push_deployment_weights"]


def _push_in_actor(inst, group: str, world: int, rank: int, weights,
                   wire_dtype, method: str):
    """Runs inside each target actor (executor thread via ``_apply``).
    Serve's ReplicaActor wraps the user object at ``_callable``; plain
    actors ARE the target."""
    from ray_tpu_torch.util import collective as col

    target = getattr(inst, "_callable", inst)
    apply_fn = getattr(target, method)
    if world == 1:
        apply_fn(weights)
        return True
    col.init_collective_group(world, rank, group_name=group)
    try:
        w = col.broadcast_tree(
            weights, src_rank=0, group_name=group, wire_dtype=wire_dtype
        )
        apply_fn(w)
        # the broadcast root finishes as soon as its sends are acked
        # (receivers buffer chunks in mailboxes even pre-init), so
        # WITHOUT this barrier a fast rank 0 would destroy the group —
        # retracting its rendezvous key — before slow ranks' membership
        # polls ever saw it, wedging their init until timeout
        col.barrier(group_name=group)
    finally:
        col.destroy_collective_group(group_name=group)
    return True


def push_weights(actors: List[Any], weights, *,
                 wire_dtype: Optional[str] = None,
                 method: str = "update_weights",
                 group_name: Optional[str] = None,
                 timeout: Optional[float] = None) -> int:
    """Push ``weights`` (a pytree of numpy arrays or tensors, or an
    ``ObjectRef`` to one) to every actor in ``actors`` via one collective
    broadcast; each actor applies them with ``method``.  Returns the
    number of actors updated.

    The driver uploads the payload once: it is ``put`` into the object
    store (unless it is a ref already) and the ref is rank 0's task
    argument, which the runtime resolves in rank 0.  (The reference
    passes the tree itself, which the runtime pickles into the call; a
    7B model's state dict is too large for that.)  The group moves it
    between replicas over the RPC + shm plane, and the transient group
    is always destroyed — a failed push never leaks a group name."""
    import ray_tpu_torch
    from ray_tpu_torch.common.config import cfg

    if not actors:
        return 0
    group = group_name or f"weight-push-{uuid.uuid4().hex[:8]}"
    world = len(actors)
    if not isinstance(weights, ray_tpu_torch.ObjectRef):
        weights = ray_tpu_torch.put(weights)
    refs = [
        a._apply(
            _push_in_actor, group, world, rank,
            weights if rank == 0 else None, wire_dtype, method,
        )
        for rank, a in enumerate(actors)
    ]
    ray_tpu_torch.get(
        refs,
        timeout=timeout if timeout is not None
        else cfg.collective_rendezvous_timeout_s + 60.0,
    )
    return world


def push_deployment_weights(name: str, weights, *,
                            app_name: str = "default",
                            wire_dtype: Optional[str] = None,
                            method: str = "update_weights",
                            timeout: Optional[float] = None) -> int:
    """``push_weights`` over the live replicas of one serve deployment
    (handles fetched from the controller; draining victims excluded)."""
    import ray_tpu_torch
    from ray_tpu_torch.serve.controller import get_or_create_controller

    controller = get_or_create_controller()
    actors = ray_tpu_torch.get(
        controller.get_replica_actors.remote(name, app_name), timeout=30.0
    )
    return push_weights(
        actors, weights, wire_dtype=wire_dtype, method=method,
        timeout=timeout,
    )
