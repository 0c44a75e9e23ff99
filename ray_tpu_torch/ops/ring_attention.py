"""Ring attention: causal attention with the sequence sharded over ``sp``
(port of ``ray_tpu/ops/ring_attention.py``).

Each sp rank holds one block of the sequence.  K and V blocks travel round
the ring (``ring_permute``, point to point) while every rank accumulates its
queries' attention online in log-sum-exp form, so each rank holds O(S/n)
of the sequence.

Numerics follow flash attention: f32 running (max, sumexp, out)
accumulators, and the causal mask applied multiplicatively after the
exponential, so that a block wholly in a query's future adds exactly zero.
The gradient is autograd's through these ops; the permutes send theirs
back the other way round the ring.  Routing the blocks through the flash
kernels would need a q/kv position offset that the kernels lack.
"""

from __future__ import annotations

import functools
import math
from typing import Optional

import torch

from ray_tpu_torch.ops.attention import NEG_INF, dense_attention
from ray_tpu_torch.parallel.collectives import ring_permute
from ray_tpu_torch.parallel.mesh import SP_AXIS, TP_AXIS, Mesh, current_mesh
from ray_tpu_torch.parallel.sharding import PartitionSpec, spec_placements


def _block_update(carry, kv, *, q, q_pos, k_pos, scale):
    """One online-softmax update with the resident KV block.  q is f32
    (B, S, H, D); k, v (B, Sk, H, D); o (B, H, S, D) and m, l (B, H, S)
    f32."""
    o, m, l = carry
    k, v = kv
    s = torch.einsum("bqhd,bkhd->bhqk", q, k.float()) * scale
    mask = (q_pos[:, None] >= k_pos[None, :])[None, None, :, :]
    s = torch.where(mask, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(-1))
    p = torch.exp(s - m_new[..., None]) * mask
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(-1)
    o = o * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return o, m_new, l


def ring_attention_manual(q, k, v, *, axis_name: str = SP_AXIS, mesh: Optional[Mesh] = None):
    """Ring attention over this rank's blocks: q, k, v (B, S_local, H, D),
    the sequence block at this rank's coordinate on ``axis_name``.  Returns
    (B, S_local, H, D) in q.dtype.  Every rank of the axis must call it."""
    mesh = current_mesh() if mesh is None else mesh
    B, S, H, D = q.shape
    n = mesh.size(axis_name)
    my = mesh.index(axis_name)
    scale = 1.0 / math.sqrt(D)
    qf = q.float()
    o = q.new_zeros((B, H, S, D), dtype=torch.float32)
    m = q.new_full((B, H, S), NEG_INF, dtype=torch.float32)
    l = q.new_zeros((B, H, S), dtype=torch.float32)
    pos = torch.arange(S, device=q.device)
    q_pos = my * S + pos
    k, v = k.to(q.dtype), v.to(q.dtype)
    for t in range(n):
        src = (my - t) % n  # whose KV block this rank holds at step t
        o, m, l = _block_update((o, m, l), (k, v), q=qf, q_pos=q_pos, k_pos=src * S + pos,
                                scale=scale)
        if t < n - 1:  # the reference's last rotation feeds nothing
            k = ring_permute(k, axis_name, mesh=mesh)
            v = ring_permute(v, axis_name, mesh=mesh)
    out = o / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q.dtype)


def ring_attention(q, k, v, *, mesh: Optional[Mesh] = None):
    """Causal ring attention over ``mesh``'s sp axis (default: the current
    mesh).  q, k, v: this rank's blocks (B, S_local, H, D), or DTensors laid
    out batch over the data axes, sequence over sp and heads over tp, which
    run through ``local_map``.

    With no mesh, or sp = 1, this is the equivalent dense computation (the
    reference's documented semantics), so that model code can select
    ``attention_impl="ring"`` unconditionally.
    """
    mesh = current_mesh() if mesh is None else mesh
    if mesh is None or mesh.size(SP_AXIS) == 1:
        return dense_attention(q, k, v)
    from torch.distributed.tensor import DTensor

    if isinstance(q, DTensor):
        from torch.distributed.tensor.experimental import local_map

        # a list: local_map reads a tuple of out_placements as one per output
        placements = list(spec_placements(mesh, PartitionSpec(mesh.data_axes, SP_AXIS, TP_AXIS)))
        fn = local_map(functools.partial(ring_attention_manual, mesh=mesh), out_placements=placements,
                       in_placements=(placements,) * 3, device_mesh=mesh.torch_mesh)
        return fn(q, k, v)
    return ring_attention_manual(q, k, v, mesh=mesh)
