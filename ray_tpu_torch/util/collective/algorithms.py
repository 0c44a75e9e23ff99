"""Collective algorithm selection (Collectives v2).

No single algorithm wins across message sizes and topologies (arxiv
2510.20171): the bandwidth-optimal ring costs ``2(n-1)`` sequential
hops per allreduce — fine at 16 MB, ruinous at 1 KB — while the
latency-optimal exchanges cost ``log2(n)`` hops of the whole payload.
This module is the small registry + policy table that picks per op,
from message size x world size x plane (all ranks co-hosted on one shm
arena vs crossing hosts), with the health plane's SUSPECT signal as a
topology input.

Algorithms (implemented in ``rpc_backend.py``, named here):

- ``ring``   — reduce-scatter + allgather ring (allreduce /
  reducescatter), chunk-pipelined ring forward (broadcast).  Bandwidth
  optimal; the original data path, and the bit-compat default for fp
  reductions.
- ``rd``     — recursive-doubling allreduce: ``log2(n)`` pairwise
  whole-vector exchanges, power-of-two worlds only.  Latency optimal
  for small messages; all ranks finish bit-identical (pairwise sums
  commute), but the accumulation TREE differs from ring order, so it
  is never auto-picked for fp reductions unless the group opted into
  ``algorithm="auto"``.
- ``btree``  — binomial-tree broadcast: ``ceil(log2(n))`` levels
  instead of an ``n-1``-deep pipeline chain.  Bytes are bytes — the
  result is bit-identical to the ring forward — so small broadcasts
  take it by default; ranks whose node the health plane marks SUSPECT
  are placed at the LEAVES, so a stalling host delays only itself,
  never a subtree (the ring pipeline has no such freedom: every chunk
  crosses every rank).

Determinism: the choice is a pure function of (op, nbytes, world,
plane, options, suspect set) — two ranks computing it independently
for the same op agree unless their suspect views diverge, which is why
only *topology* (btree layout, announced inside the op's first
message by the root) may consult health, never the algorithm identity
for multi-rank-coordinated reductions.
"""

from __future__ import annotations

from typing import FrozenSet, Optional

from ray_tpu_torch.common.config import cfg
from ray_tpu_torch.util.collective.types import CollectiveError, GroupOptions

# op -> algorithms that can run it (first = bit-compat default shape)
REGISTRY = {
    "allreduce": ("ring", "rd"),
    "reducescatter": ("ring",),
    "allgather": ("ring",),
    "broadcast": ("ring", "btree"),
}


def _is_pow2(n: int) -> bool:
    return n > 0 and (n & (n - 1)) == 0


def select(op: str, nbytes: int, world_size: int, *,
           all_cohosted: bool,
           options: GroupOptions,
           override: Optional[str] = None,
           any_suspect: bool = False) -> str:
    """The algorithm for one op instance.

    ``override`` is the per-op ``algorithm=`` argument; it beats the
    group's ``options.algorithm``; both may be "auto" for the policy
    table.  Policy:

    - reductions (allreduce/reducescatter): default ``ring`` — the
      original ring's reduction order, bit-for-bit.  Under "auto", small
      (<= collective_small_max_bytes) pow2-world allreduces take
      ``rd`` (log-latency; deterministic but a different sum tree).
    - broadcast: bytes are routing-independent, so the default IS the
      table: small payloads or any SUSPECT member node -> ``btree``
      (log depth / stragglers at leaves), large healthy -> ``ring``
      pipeline (bandwidth).
    - co-hosted planes lean harder on latency: every hop is a shm
      handoff, so the small-message threshold doubles (chunk setup
      dominates sooner than wire bandwidth does).
    """
    allowed = REGISTRY.get(op)
    if allowed is None:
        raise CollectiveError(f"unknown collective op {op!r}")
    choice = override
    if choice is None:
        # the GROUP-wide algorithm is advisory per op: it applies where
        # it can run (e.g. "rd" steers allreduce but not broadcast, and
        # falls back to ring when a shrink reform lands on a non-pow2
        # world) — only a PER-OP override is held to strict validity
        g = options.algorithm
        if g is not None and g != "auto":
            if g not in allowed or (g == "rd" and not _is_pow2(world_size)):
                g = None
        choice = g
    if choice is not None and choice != "auto":
        if choice not in allowed:
            raise CollectiveError(
                f"algorithm {choice!r} cannot run {op} "
                f"(supported: {list(allowed)})"
            )
        if choice == "rd" and not _is_pow2(world_size):
            raise CollectiveError(
                f"recursive doubling needs a power-of-two world, got "
                f"{world_size}; use algorithm='ring' (or 'auto', which "
                f"falls back)"
            )
        return choice
    small_max = int(cfg.collective_small_max_bytes)
    if all_cohosted:
        small_max *= 2
    small = nbytes <= small_max
    if op == "broadcast":
        return "btree" if (small or any_suspect) else "ring"
    if op == "allreduce" and choice == "auto":
        if small and _is_pow2(world_size):
            return "rd"
    return "ring"


def btree_order(world_size: int, root: int,
                suspect_ranks: FrozenSet[int]) -> list:
    """Rank order for the binomial broadcast tree: virtual rank 0 is
    the root, healthy ranks fill the inner positions, SUSPECT-node
    ranks sort to the tail (= leaves of the binomial tree, since
    children are always at higher virtual ranks than parents' early
    positions).  Deterministic for a fixed (world, root, suspects)."""
    rest = [r for r in range(world_size) if r != root]
    healthy = [r for r in rest if r not in suspect_ranks]
    slow = [r for r in rest if r in suspect_ranks]
    return [root] + healthy + slow


def btree_parent_children(order: list, rank: int):
    """This rank's (parent, children) in the binomial tree over
    ``order`` (order[0] = root).  Standard binomial shape: virtual
    rank v's parent clears v's highest set bit; v's children are
    ``v + 2**k`` for k from v's bit length up, while in range."""
    n = len(order)
    v = order.index(rank)
    if v == 0:
        parent = None
        lo = 0
    else:
        h = v.bit_length() - 1
        parent = order[v - (1 << h)]
        lo = h + 1
    children = []
    k = lo
    while v + (1 << k) < n:
        children.append(order[v + (1 << k)])
        k += 1
    return parent, children
