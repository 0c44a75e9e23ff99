"""Shared types for the runtime collective subsystem.

Role-equivalent of ray: python/ray/util/collective/types.py (ReduceOp,
backend descriptors) — kept import-light so the registry and lint rules
can reference these without pulling numpy-heavy modules.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, List, Optional

# wire dtypes a group/op may request for the quantized data path
# (quantize.py implements the codecs); None/"fp32" = raw fp32 bytes,
# the bit-exact default
WIRE_DTYPES = ("fp32", "bf16", "int8")


class ReduceOp(enum.Enum):
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"
    MEAN = "mean"


DEFAULT_GROUP_NAME = "default"


class CollectiveError(Exception):
    """Base error for the runtime collective subsystem."""


class RendezvousTimeoutError(CollectiveError):
    """Not every rank declared itself at the GCS within the window."""


class CollectiveGroupError(CollectiveError):
    """The group is unusable (a member died / the group was poisoned).

    Once raised, every subsequent op on the group raises too — callers
    must ``destroy_collective_group`` and re-init with live members.
    """


class CollectiveTimeoutError(CollectiveGroupError):
    """An op waited past the configured timeout for peer traffic.

    Subclasses CollectiveGroupError: a timed-out collective leaves
    partial ring state behind, so the group is poisoned like any other
    mid-op failure — this type only adds the "likely just slow or
    wedged, not observed dead" distinction for callers that retry with
    a fresh group."""


@dataclass
class MemberInfo:
    """One rank's identity as published at rendezvous."""

    rank: int
    addr: str  # worker RPC server address (the peer channel endpoint)
    node_id: str  # hex; equal node_id ⇒ ranks share one shm arena
    worker_id: str  # hex
    actor_id: Optional[str] = None  # hex, when the rank is an actor

    def to_dict(self) -> dict:
        return {
            "rank": self.rank,
            "addr": self.addr,
            "node_id": self.node_id,
            "worker_id": self.worker_id,
            "actor_id": self.actor_id,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MemberInfo":
        return cls(
            rank=d["rank"],
            addr=d["addr"],
            node_id=d["node_id"],
            worker_id=d["worker_id"],
            actor_id=d.get("actor_id"),
        )


@dataclass
class GroupOptions:
    """Per-group data-path configuration (Collectives v2).

    Every field defaults to None = "inherit": the selection layer
    (``algorithms.py``) and the global config knobs decide.  The whole
    object is persisted in the rendezvous records and carried through
    ``reform_collective_group`` — a migration or shrink never silently
    changes the group's wire format or algorithm choice.
    """

    # collective algorithm: None = the bit-compat default per op
    # (ring for reductions, size-based ring/btree for broadcast),
    # "auto" = full size x world x plane selection table,
    # or an explicit name ("ring" | "rd" | "btree")
    algorithm: Optional[str] = None
    # payload codec for float32 tensors: None/"fp32" = raw bytes
    # (bit-exact), "bf16" | "int8" = block-quantized (quantize.py)
    wire_dtype: Optional[str] = None
    # per-hop transfer chunk size; None = cfg.collective_chunk_bytes
    chunk_bytes: Optional[int] = None
    # elements per quantization block; None = cfg.collective_quant_block
    quant_block: Optional[int] = None

    def to_dict(self) -> dict:
        return {
            "algorithm": self.algorithm,
            "wire_dtype": self.wire_dtype,
            "chunk_bytes": self.chunk_bytes,
            "quant_block": self.quant_block,
        }

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "GroupOptions":
        if not d:
            return cls()
        return cls(
            algorithm=d.get("algorithm"),
            wire_dtype=d.get("wire_dtype"),
            chunk_bytes=d.get("chunk_bytes"),
            quant_block=d.get("quant_block"),
        )

    def validate(self) -> "GroupOptions":
        if self.wire_dtype is not None and self.wire_dtype not in WIRE_DTYPES:
            raise CollectiveError(
                f"unknown wire_dtype {self.wire_dtype!r}; "
                f"one of {WIRE_DTYPES}"
            )
        if self.chunk_bytes is not None and int(self.chunk_bytes) < 1:
            raise CollectiveError(
                f"chunk_bytes must be >= 1, got {self.chunk_bytes}"
            )
        if self.quant_block is not None and int(self.quant_block) < 1:
            raise CollectiveError(
                f"quant_block must be >= 1, got {self.quant_block}"
            )
        return self


@dataclass
class GroupSpec:
    """Everything a backend needs to know about an initialized group."""

    name: str
    world_size: int
    rank: int
    backend: str
    members: List[MemberInfo] = field(default_factory=list)
    # rendezvous-agreed incarnation (rank 0's nonce): wire chunks carry
    # it so traffic from a destroyed same-named group can never be
    # consumed by — or corrupt — a re-initialized one
    incarnation: str = ""
    # reform generation: bumped by each reform_collective_group round.
    # Rendezvous records carry it, and await_members only accepts
    # records of its own generation — a survivor re-declaring can never
    # adopt the DEAD member's stale record (same key, older gen)
    reform_gen: int = 0
    # Collectives v2 data-path config: algorithm override, wire dtype,
    # chunk size.  Adopted from rank 0's rendezvous record so every
    # member agrees, and carried through reform (a replacement member
    # inherits it from the stale record it overwrites)
    options: GroupOptions = field(default_factory=GroupOptions)

    def member(self, rank: int) -> MemberInfo:
        return self.members[rank]

    def describe_member(self, rank: int) -> str:
        m = self.members[rank]
        who = f"actor {m.actor_id[:12]}" if m.actor_id else f"worker {m.worker_id[:12]}"
        return f"rank {rank} ({who} at {m.addr})"


# numpy reduce kernels, keyed by op; applied as ``kernel(acc_view, incoming)``
# with acc_view a writable ndarray view — in-place so ring steps never
# allocate per hop.  MEAN reduces as SUM; the final /world_size happens once.
def apply_reduce(op: ReduceOp, acc: Any, incoming: Any) -> None:
    import numpy as np

    if op in (ReduceOp.SUM, ReduceOp.MEAN):
        np.add(acc, incoming, out=acc)
    elif op is ReduceOp.PRODUCT:
        np.multiply(acc, incoming, out=acc)
    elif op is ReduceOp.MIN:
        np.minimum(acc, incoming, out=acc)
    elif op is ReduceOp.MAX:
        np.maximum(acc, incoming, out=acc)
    else:
        raise CollectiveError(f"unsupported reduce op {op!r}")
