"""GCS-KV rendezvous for collective groups.

Role-equivalent of ray: python/ray/util/collective/collective.py's
``_group_mgr`` + the named-actor "Info" rendezvous
(collective_group/... Rendezvous classes), collapsed onto the GCS KV
table this runtime already has: each rank publishes its identity under
``collective:<group>:<rank>`` and polls until the full membership table
is visible.  Teardown deletes the keys so a group name can be reused
after ``destroy_collective_group``.

Re-formation (``reform_collective_group``) reuses the same keyspace at
a bumped **generation**: every record carries ``gen`` and
``await_members`` only accepts records of its own generation, so a
dead member's stale record (same key, older gen) can never complete a
reformed membership table.  A shrink reform runs a phase-A roster
first — survivors declare their OLD ranks under
``collective-reform:<group>:<old incarnation>:<old_rank>`` and the new
rank is each survivor's position in the sorted old-rank order.

All coroutines here run on the runtime's io loop.
"""

from __future__ import annotations

import asyncio
import os
import pickle
import time
from typing import Optional

from ray_tpu_torch.common.backoff import Backoff, BackoffPolicy
from ray_tpu_torch.common.config import cfg
from ray_tpu_torch.util.collective.types import (
    CollectiveError,
    GroupOptions,
    GroupSpec,
    MemberInfo,
    RendezvousTimeoutError,
)

# poll schedule for the KV tables (historic values, now expressed as
# the shared backoff policy shape; jitter off keeps polls predictable)
_POLL_POLICY = BackoffPolicy(base_s=0.02, mult=2.0, max_s=0.25,
                             jitter_frac=0.0)


def _key(group_name: str, rank: int) -> str:
    return f"collective:{group_name}:{rank}"


def _reform_key(group_name: str, incarnation: str, rank: int) -> str:
    return f"collective-reform:{group_name}:{incarnation or '0'}:{rank}"


async def declare(rt, group_name: str, world_size: int, rank: int,
                  actor_id_hex: Optional[str], gen: int = 0,
                  options: Optional[GroupOptions] = None) -> MemberInfo:
    """Publish this rank's identity.  Overwrites any stale key from a
    previous same-named group (names are reusable only after destroy —
    concurrent same-named groups are user error and detected below by
    world_size/identity mismatches).  Rank 0's record also carries the
    group's incarnation nonce; every rank adopts it at await_members,
    and wire chunks are keyed by it so stale traffic from a previous
    incarnation is dropped, never consumed.  ``gen`` is the reform
    generation (0 for a fresh group).  ``options`` (the Collectives v2
    data-path config) rides every record: rank 0's copy is adopted
    group-wide, and a replacement member inherits it from the stale
    record (peek_record) so a reform never changes the wire format."""
    server = getattr(rt, "_worker_server", None)
    if server is None:
        raise CollectiveError(
            "runtime collectives need a worker-hosted RPC server; call "
            "init_collective_group from inside an actor (the driver "
            "process has no peer-reachable endpoint)"
        )
    me = MemberInfo(
        rank=rank,
        addr=server.server.address,
        node_id=rt.node_id,
        worker_id=rt.worker_id.hex(),
        actor_id=actor_id_hex,
    )
    record = {"world_size": world_size, "member": me.to_dict(), "gen": gen}
    if options is not None:
        record["options"] = options.to_dict()
    if rank == 0:
        record["incarnation"] = os.urandom(8).hex()
    await rt.gcs.call(
        "kv_put",
        {
            "key": _key(group_name, rank),
            "value": pickle.dumps(record),
            "overwrite": True,
        },
    )
    return me


async def await_members(rt, group_name: str, world_size: int, rank: int,
                        me: MemberInfo,
                        timeout: Optional[float] = None,
                        gen: int = 0,
                        options: Optional[GroupOptions] = None):
    """Poll the KV table until every rank has declared; returns
    ``(members in rank order, incarnation nonce, group options)``.
    Raises RendezvousTimeoutError naming the missing ranks — the
    actionable shape ("rank 2 never arrived") rather than a bare hang.

    The group-wide ``GroupOptions`` are RANK 0's (taken from the same
    final re-read as the incarnation) so every member agrees on the
    wire format; a non-rank-0 member that declared a CONFLICTING
    non-default config gets a loud error, not a silent override.

    Records whose ``gen`` differs from ours are SKIPPED (treated as
    not-yet-declared): on the reform path those are a dead member's
    leftovers, and adopting one would hand the new group a corpse's
    address.

    The incarnation is taken from a FINAL re-read of rank 0's record
    once the table is complete: destroy deletes the keys, so stale
    records only exist on the crash-without-destroy path, and the
    re-read shrinks the adopt-an-old-nonce window to a single GCS
    round trip."""
    if timeout is None:
        timeout = cfg.collective_rendezvous_timeout_s
    deadline = time.monotonic() + timeout
    members: dict = {rank: me}
    poll_backoff = Backoff(_POLL_POLICY, deadline=deadline)
    while True:
        for i in range(world_size):
            if i in members:
                continue
            blob = await rt.gcs.call("kv_get", {"key": _key(group_name, i)})
            if blob is None:
                continue
            rec = pickle.loads(blob)
            if rec.get("gen", 0) != gen:
                continue  # stale generation: not a declaration for US
            if rec["world_size"] != world_size:
                raise CollectiveError(
                    f"collective group {group_name!r}: rank {i} declared "
                    f"world_size={rec['world_size']} but this rank expects "
                    f"{world_size} — two groups are using the same name"
                )
            members[i] = MemberInfo.from_dict(rec["member"])
        if len(members) == world_size:
            blob = await rt.gcs.call("kv_get", {"key": _key(group_name, 0)})
            rec = pickle.loads(blob) if blob is not None else {}
            if rank != 0 and rec.get("gen", 0) != gen:
                # rank 0's record moved under us (a racing round):
                # treat the table as incomplete and keep polling
                members.pop(0, None)
                if time.monotonic() >= deadline:
                    raise RendezvousTimeoutError(
                        f"collective group {group_name!r} rendezvous "
                        f"could not settle rank 0's record at "
                        f"generation {gen}"
                    )
                await poll_backoff.wait()
                continue
            incarnation = rec.get("incarnation", "")
            members[0] = (
                MemberInfo.from_dict(rec["member"])
                if "member" in rec and rank != 0
                else members[0]
            )
            if rank == 0:
                adopted = options or GroupOptions()
            else:
                adopted = GroupOptions.from_dict(rec.get("options"))
                mine = (options or GroupOptions()).to_dict()
                if (
                    any(v is not None for v in mine.values())
                    and mine != adopted.to_dict()
                ):
                    raise CollectiveError(
                        f"collective group {group_name!r}: rank {rank} "
                        f"declared options {mine} but rank 0 declared "
                        f"{adopted.to_dict()} — the group config (wire "
                        f"dtype / algorithm / chunk size) must agree; "
                        f"rank 0's copy is authoritative"
                    )
            return (
                [members[i] for i in range(world_size)], incarnation, adopted
            )
        if time.monotonic() >= deadline:
            missing = sorted(set(range(world_size)) - set(members))
            raise RendezvousTimeoutError(
                f"collective group {group_name!r} rendezvous timed out "
                f"after {timeout:.0f}s: rank(s) {missing} never declared "
                f"(got {len(members)}/{world_size}).  Check that every "
                f"member actor is alive and called init_collective_group "
                f"with the same group_name and world_size."
            )
        await poll_backoff.wait()


async def retract(rt, group_name: str, rank: int) -> None:
    """Delete this rank's key (teardown half of the lifecycle)."""
    try:
        await rt.gcs.call("kv_del", {"key": _key(group_name, rank)})
    except Exception:
        pass  # best-effort: the GCS may already be gone at shutdown


# ---------------------------------------------------------------------------
# Re-formation (group shrink / member replacement)
# ---------------------------------------------------------------------------


async def reform_roster(rt, group_name: str, old_spec: GroupSpec,
                        world_size: int,
                        timeout: Optional[float] = None) -> int:
    """Phase A of a SHRINK reform: survivors declare their old ranks
    under a keyspace scoped by the old incarnation, wait until exactly
    ``world_size`` survivors have declared, and take new rank = own
    position in the sorted old-rank order.  Returns this rank's new
    rank.  More declarations than ``world_size`` means the caller's
    survivor count was wrong — raised, not guessed around."""
    if timeout is None:
        timeout = cfg.collective_rendezvous_timeout_s
    deadline = time.monotonic() + timeout
    inc = old_spec.incarnation
    await rt.gcs.call("kv_put", {
        "key": _reform_key(group_name, inc, old_spec.rank),
        "value": b"1",
        "overwrite": True,
    })
    declared = {old_spec.rank}
    poll_backoff = Backoff(_POLL_POLICY, deadline=deadline)
    while True:
        for i in range(old_spec.world_size):
            if i in declared:
                continue
            blob = await rt.gcs.call(
                "kv_get", {"key": _reform_key(group_name, inc, i)}
            )
            if blob is not None:
                declared.add(i)
        if len(declared) >= world_size:
            if len(declared) > world_size:
                raise CollectiveError(
                    f"reform of group {group_name!r}: {len(declared)} "
                    f"survivors declared ({sorted(declared)}) but "
                    f"world_size={world_size} was requested — every "
                    f"surviving member must call reform_collective_group "
                    f"with the same world_size"
                )
            return sorted(declared).index(old_spec.rank)
        if time.monotonic() >= deadline:
            raise RendezvousTimeoutError(
                f"reform of group {group_name!r} timed out after "
                f"{timeout:.0f}s: {len(declared)}/{world_size} survivors "
                f"declared ({sorted(declared)}).  Another member may "
                f"have died too — fall back to destroy_collective_group "
                f"+ init_collective_group with the live set."
            )
        await poll_backoff.wait()


async def peek_record(rt, group_name: str, rank: int):
    """``(gen, options)`` recorded under ``rank``'s key — how a
    REPLACEMENT member, which has no local group history, joins at the
    right generation AND inherits the group's data-path config
    (algorithm / wire dtype / chunk size) instead of silently
    re-joining with defaults.  (0, None) when the key is absent or
    predates generations."""
    blob = await rt.gcs.call("kv_get", {"key": _key(group_name, rank)})
    if blob is None:
        return 0, None
    try:
        rec = pickle.loads(blob)
        return rec.get("gen", 0), GroupOptions.from_dict(rec.get("options"))
    except Exception:
        return 0, None


async def peek_gen(rt, group_name: str, rank: int) -> int:
    """Back-compat shim: just the generation half of peek_record."""
    gen, _ = await peek_record(rt, group_name, rank)
    return gen


async def reform_cleanup(rt, group_name: str, old_spec: GroupSpec,
                         world_size: int) -> None:
    """Post-reform housekeeping (new rank 0 only): drop the phase-A
    roster keys and the stale member keys beyond the new world size —
    a later destroy/re-init must not trip over them."""
    inc = old_spec.incarnation
    for i in range(old_spec.world_size):
        try:
            await rt.gcs.call(
                "kv_del", {"key": _reform_key(group_name, inc, i)}
            )
        except Exception:
            pass
        if i >= world_size:
            try:
                await rt.gcs.call("kv_del", {"key": _key(group_name, i)})
            except Exception:
                pass
