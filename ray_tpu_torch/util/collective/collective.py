"""Runtime actor-group collectives: group lifecycle + op dispatch.

Role-equivalent of ray: python/ray/util/collective/collective.py
(init_collective_group:120, allreduce:258, declare/teardown) rebuilt on
this runtime's own planes: rendezvous rides the GCS KV table, the data
plane is the duplex worker RPC framing (``core/rpc.py``) with
zero-copy shm-arena handoff between co-hosted ranks
(``_native/store.py``), and backends are pluggable through
``util/collective/backend.py`` (the "rpc" ring backend here).

Threading contract: the async core runs on the runtime's io loop; the
public module-level ops are **blocking** and must be called from a sync
context (sync actor methods run on executor threads, which is the
intended call site).  From ``async def`` bodies use the ``*_async``
twins or hand the sync op to a thread — calling a blocking op on the io
loop would deadlock it, which is exactly what rtlint rule RT109 flags.
"""

from __future__ import annotations

import asyncio
import logging
import sys
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.common.config import cfg
from ray_tpu_torch.core.runtime import get_runtime
from ray_tpu_torch.util.collective import rendezvous
from ray_tpu_torch.util.collective.backend import (
    backend_kind,
    resolve_backend,
)
from ray_tpu_torch.util.collective.types import (
    DEFAULT_GROUP_NAME,
    CollectiveError,
    CollectiveGroupError,
    CollectiveTimeoutError,
    GroupOptions,
    GroupSpec,
    ReduceOp,
)

logger = logging.getLogger(__name__)

RPC_METHOD = "collective"  # the one method name the subsystem claims


def reform_channel(group_name: str) -> str:
    """GCS pubsub channel carrying drain-migration reform events for one
    group: a member that migrated off a draining node publishes here
    right before re-joining under its old rank, and every surviving
    member's subscription enters the same-world replacement reform — the
    group proactively re-forms *before* the preempted node dies instead
    of poisoning after it."""
    return f"collective:reform:{group_name}"


class _Mailbox:
    """Arrived-but-unconsumed chunks for one (group, src, tag) stream.

    Created on demand by WHICHEVER side gets there first — delivery may
    beat the local op (a fast peer), or the op may park before any
    traffic arrives.  All access is on the io loop; no locks.
    """

    __slots__ = ("chunks", "event", "failed")

    def __init__(self):
        self.chunks: list = []
        self.event = asyncio.Event()
        self.failed: Optional[Exception] = None


class GroupHandle:
    """Per-process state of one initialized group."""

    def __init__(self, spec: GroupSpec, backend_impl):
        self.spec = spec
        self.backend = backend_impl
        self.failed: Optional[Exception] = None
        self.op_lock = asyncio.Lock()  # collectives are one-at-a-time
        self.op_seq = 0
        self.p2p_send_seq: Dict[int, int] = {}
        self.p2p_recv_seq: Dict[int, int] = {}

    def check_alive(self):
        if self.failed is not None:
            raise CollectiveGroupError(
                f"collective group {self.spec.name!r} is poisoned: "
                f"{self.failed}.  Call destroy_collective_group and "
                f"re-init with live members."
            ) from self.failed


class CollectiveManager:
    """One per process; owns group table, mailboxes, and the RPC hook."""

    def __init__(self, rt):
        self.rt = rt
        self.groups: Dict[str, GroupHandle] = {}
        # groups currently mid-reform in this process (a drain-migration
        # reform event arriving while one is running must not start a
        # second, racing rendezvous); an event that lands mid-reform is
        # parked here and replayed when the current reform finishes
        # (two members of one group migrating near-simultaneously)
        self._reforming: set = set()
        self._pending_reform: Dict[str, dict] = {}
        self._inbox: Dict[tuple, _Mailbox] = {}
        # (group, inc, tag) → Event: set on any chunk arrival for that
        # tag, for first_src() waiters (btree broadcast consumers that
        # do not yet know which rank the root routed to them)
        self._tag_events: Dict[tuple, asyncio.Event] = {}
        # health-plane input to algorithm selection: node ids currently
        # SUSPECT, cached with a TTL so ops never add more than one
        # node_health rpc per refresh window
        self._suspect_cache: frozenset = frozenset()
        self._suspect_at: float = float("-inf")
        self._suspect_refreshing: bool = False
        # conn → {(group, peer_rank)}: every connection known to carry
        # a group's traffic, for death detection (inbound recorded at
        # delivery, outbound at peer-channel acquisition)
        self._conn_groups: Dict[Any, set] = {}
        # group name → callbacks fired whenever a fresh incarnation of
        # that group is installed (first init, survivor-side reform, or
        # this process's post-restore re-join).  The persistent-channel
        # plane (util/collective/channel.py) hangs its reform-resend
        # here: a sender re-offers its unpurged outbox into every new
        # incarnation, because acked payloads may have died unconsumed
        # in a preempted receiver's mailbox.
        self._group_listeners: Dict[str, list] = {}
        rt.register_rpc_handler(RPC_METHOD, self._handle)
        rt.add_peer_close_watcher(self._on_conn_closed)

    def add_group_listener(self, group_name: str, cb) -> None:
        """Register ``cb(group_handle)`` to run after every install of
        ``group_name``.  A returned coroutine is spawned on the io loop;
        exceptions are logged, never propagated into the install."""
        self._group_listeners.setdefault(group_name, []).append(cb)

    def remove_group_listener(self, group_name: str, cb) -> None:
        cbs = self._group_listeners.get(group_name)
        if cbs is None:
            return
        try:
            cbs.remove(cb)
        except ValueError:
            return
        if not cbs:
            del self._group_listeners[group_name]

    # ---- RPC plane -----------------------------------------------------
    async def _handle(self, conn, payload: dict):
        op = payload.get("op")
        if op == "chunk":
            # deliver synchronously (no await before the mailbox write):
            # the rpc recv loop creates handler tasks in frame order, so
            # in-order delivery per connection is preserved
            key = (
                payload["group"], payload.get("inc", ""),
                payload["src"], payload["tag"],
            )
            gh = self.groups.get(payload["group"])
            box = self._inbox.get(key)
            if (
                gh is not None
                and (
                    gh.failed is not None
                    or gh.spec.incarnation != payload.get("inc", "")
                )
            ) or (box is not None and box.failed is not None):
                # poisoned group/stream — or traffic from a DIFFERENT
                # incarnation of this name (a destroyed predecessor):
                # nobody will consume; reclaim the shm chunk instead of
                # buffering it (a fresh mailbox would outlive the group,
                # and a stale-tag chunk consumed by a re-initialized
                # group would corrupt it)
                self._drop_chunk_shm(payload)
                return True
            if box is None:
                box = self._inbox[key] = _Mailbox()
            box.chunks.append(payload)
            box.event.set()
            ev = self._tag_events.get(
                (payload["group"], payload.get("inc", ""), payload["tag"])
            )
            if ev is not None:
                ev.set()
            self._track_conn(conn, payload["group"], payload["src"])
            return True
        if op == "fail":
            # re-propagate: the detector only reaches its own dialed
            # conns (ring successor), so a received failure must travel
            # on — fail_group no-ops on an already-poisoned group, so
            # the relay terminates after one lap of the ring
            self.fail_group(
                payload["group"],
                CollectiveGroupError(payload["reason"]),
                propagate=True,
            )
            return True
        if op == "ping":
            return True
        raise CollectiveError(f"unknown collective wire op {op!r}")

    def _track_conn(self, conn, group: str, peer_rank: int):
        s = self._conn_groups.get(conn)
        if s is None:
            s = self._conn_groups[conn] = set()
        s.add((group, peer_rank))

    def _on_conn_closed(self, conn):
        pairs = self._conn_groups.pop(conn, None)
        if not pairs or self.rt._closed:
            return
        for group, peer_rank in pairs:
            gh = self.groups.get(group)
            if gh is None or gh.failed is not None:
                continue
            err = CollectiveGroupError(
                f"{gh.spec.describe_member(peer_rank)} lost its "
                f"connection (member died?) during group "
                f"{group!r} traffic"
            )
            # health-plane gate: poisoning (and the reform it triggers)
            # fires off CONFIRMED death, not suspicion — a conn lost
            # while the member's node is merely SUSPECT (a stall or a
            # partition in progress) parks until the GCS resolves the
            # node's fate.  A healthy-node conn loss (worker kill,
            # injected reset) poisons immediately, as before.
            self.rt._spawn(self._confirm_then_fail(group, peer_rank, err))

    async def _confirm_then_fail(self, group: str, peer_rank: int,
                                 err: Exception):
        gh = self.groups.get(group)
        if gh is None or gh.failed is not None:
            return
        member = (
            gh.spec.members[peer_rank]
            if peer_rank < len(gh.spec.members) else None
        )
        deferred = False
        if member is not None and member.node_id:
            deadline = (
                time.monotonic() + cfg.collective_confirm_death_timeout_s
            )
            while time.monotonic() < deadline:
                if gh.failed is not None:
                    return  # somebody else (a fail relay) resolved it
                try:
                    # node_health, not get_nodes: a multi-member stall
                    # spawns one poller per lost conn, and each poll
                    # must not serialize the whole cluster's resource
                    # tables on the GCS loop it is waiting on
                    rows = await self.rt.gcs.call("node_health", {},
                                                  timeout=5.0)
                except Exception:
                    break  # GCS unreachable: poison (fail-safe)
                row = rows.get(member.node_id)
                if row is None or not row.get("alive"):
                    break  # confirmed dead: poison
                if not row.get("suspect"):
                    if deferred:
                        # the node RECOVERED from suspicion: the conn
                        # loss may have been partition debris — only a
                        # live re-dial distinguishes "member fine" from
                        # "member died during the stall"
                        try:
                            peer = await self.rt.peer_connection_to(
                                member.addr, member.node_id
                            )
                            await peer.call(RPC_METHOD, {"op": "ping"},
                                            timeout=5.0)
                            return  # member reachable: no poison
                        except Exception:
                            pass
                    break  # healthy node, dead conn: a real member loss
                deferred = True  # SUSPECT: hold the verdict
                await asyncio.sleep(cfg.collective_confirm_poll_s)
        gh = self.groups.get(group)
        if gh is None or gh.failed is not None:
            return
        self.fail_group(group, err, propagate=True)

    # ---- failure -------------------------------------------------------
    def _drop_chunk_shm(self, msg: dict):
        """Reclaim the arena object of an unconsumed co-hosted chunk."""
        oid = msg.get("shm")
        if oid is not None:
            try:
                self.rt.store.delete(oid)
            except Exception:
                pass

    def _drop_box(self, box: "_Mailbox", err: Exception):
        """Mark a mailbox failed and reclaim its buffered shm chunks —
        a failed stream is never consumed, and sealed+protected chunks
        would otherwise pin arena capacity forever."""
        if box.failed is None:
            box.failed = err
        for msg in box.chunks:
            self._drop_chunk_shm(msg)
        box.chunks.clear()
        box.event.set()

    def _fail_group_local(self, group: str, err: Exception):
        gh = self.groups.get(group)
        if gh is not None:
            if gh.failed is not None:
                return
            gh.failed = err
        for key, box in self._inbox.items():
            if key[0] == group and box.failed is None:
                self._drop_box(box, err)
        for key, ev in self._tag_events.items():
            if key[0] == group:
                ev.set()  # wake first_src waiters: they re-check failed

    def fail_group(self, group: str, err: Exception, propagate: bool):
        """Poison the group locally; optionally fan the failure out to
        every member we already have a live channel to, so ranks not
        adjacent to the dead member learn immediately instead of timing
        out."""
        gh = self.groups.get(group)
        already = gh is not None and gh.failed is not None
        self._fail_group_local(group, err)
        if not propagate or gh is None or already:
            return
        for m in gh.spec.members:
            if m.rank == gh.spec.rank:
                continue
            conn = self.rt._worker_conns.get(m.addr)
            if conn is not None and not conn.closed:
                self.rt._spawn(
                    conn.notify(
                        RPC_METHOD,
                        {"op": "fail", "group": group, "reason": str(err)},
                    )
                )

    # ---- mailbox consumption (backends call these) ---------------------
    async def recv_chunks(self, group: str, src: int, tag: str,
                          expected_bytes: int,
                          timeout: Optional[float] = None) -> List[dict]:
        """Await chunk messages on (group, src, tag) until their payload
        bytes sum to ``expected_bytes``; returns them in arrival order."""
        if timeout is None:
            timeout = cfg.collective_op_timeout_s
        gh = self.groups.get(group)
        inc = gh.spec.incarnation if gh is not None else ""
        key = (group, inc, src, tag)
        box = self._inbox.get(key)
        if box is None:
            box = self._inbox[key] = _Mailbox()
        got: List[dict] = []
        nbytes = 0
        try:
            while nbytes < expected_bytes:
                if box.failed is not None:
                    raise box.failed
                if not box.chunks:
                    box.event.clear()
                    try:
                        await asyncio.wait_for(box.event.wait(), timeout)
                    except asyncio.TimeoutError:
                        raise self._timeout_error(
                            group, src, tag, timeout, nbytes, expected_bytes
                        ) from None
                    continue
                msg = box.chunks.pop(0)
                got.append(msg)
                nbytes += msg["nbytes"]
        except BaseException:
            # popped-but-unconsumed chunks die with the op: reclaim
            # their protected arena objects (failed streams never
            # resume; leaving them sealed+protected pins the arena)
            for msg in got:
                self._drop_chunk_shm(msg)
            raise
        finally:
            if not box.chunks and box.failed is None:
                self._inbox.pop(key, None)
        return got

    async def first_src(self, group: str, tag: str,
                        timeout: Optional[float] = None) -> int:
        """The source rank of the first chunk to arrive on (group, tag)
        — how a broadcast consumer learns which rank the root's
        algorithm (ring predecessor or btree parent) routed to it,
        without pre-agreeing on the topology.  Does NOT consume the
        chunk; call recv_chunks with the returned src."""
        if timeout is None:
            timeout = cfg.collective_op_timeout_s
        gh = self.groups.get(group)
        inc = gh.spec.incarnation if gh is not None else ""
        tkey = (group, inc, tag)
        deadline = time.monotonic() + timeout
        try:
            while True:
                if gh is not None and gh.failed is not None:
                    raise gh.failed
                for key, box in self._inbox.items():
                    if key[0] == group and key[1] == inc and key[3] == tag:
                        if box.failed is not None:
                            raise box.failed
                        if box.chunks:
                            return key[2]
                ev = self._tag_events.get(tkey)
                if ev is None:
                    ev = self._tag_events[tkey] = asyncio.Event()
                ev.clear()
                left = deadline - time.monotonic()
                if left <= 0:
                    raise CollectiveTimeoutError(
                        f"collective op on group {group!r} timed out "
                        f"after {timeout:.0f}s waiting for the first "
                        f"broadcast chunk (tag {tag}).  The root or an "
                        f"upstream rank is likely dead or wedged."
                    )
                try:
                    await asyncio.wait_for(ev.wait(), left)
                except asyncio.TimeoutError:
                    continue  # deadline check above raises
        finally:
            self._tag_events.pop(tkey, None)

    async def suspect_nodes(self) -> frozenset:
        """Node ids the health plane currently marks SUSPECT — the
        topology input to algorithm selection (btree leaf placement,
        broadcast algorithm choice at the root).  NEVER blocks the
        data path: returns the cached set immediately and, when stale
        past collective_suspect_refresh_s, kicks a background refresh
        — a slow or partitioned GCS must not add its latency to a
        broadcast.  Advisory only: a stale (or initially empty) view
        costs performance, never correctness."""
        ttl = cfg.collective_suspect_refresh_s
        if ttl <= 0:
            return frozenset()
        now = time.monotonic()
        if now >= self._suspect_at + ttl and not self._suspect_refreshing:
            self._suspect_refreshing = True
            self.rt._spawn(self._refresh_suspects())
        return self._suspect_cache

    async def _refresh_suspects(self):
        try:
            rows = await self.rt.gcs.call("node_health", {}, timeout=2.0)
            self._suspect_cache = frozenset(
                nid for nid, row in rows.items() if row.get("suspect")
            )
        except Exception:
            pass  # keep the stale view; the next TTL expiry retries
        finally:
            self._suspect_at = time.monotonic()
            self._suspect_refreshing = False

    def _timeout_error(self, group, src, tag, timeout, got, want):
        gh = self.groups.get(group)
        who = (
            gh.spec.describe_member(src)
            if gh is not None and src < len(gh.spec.members)
            else f"rank {src}"
        )
        return CollectiveTimeoutError(
            f"collective op on group {group!r} timed out after "
            f"{timeout:.0f}s waiting for {who} "
            f"(tag {tag}, {got}/{want} bytes arrived).  The member is "
            f"likely dead or wedged; kill the group's actors, call "
            f"destroy_collective_group, and re-init."
        )

    # ---- lifecycle -----------------------------------------------------
    async def _install_group(self, spec: GroupSpec) -> GroupHandle:
        """Instantiate the backend for ``spec`` and publish the handle
        (shared tail of init_group and reform_group)."""
        backend_cls = resolve_backend(spec.backend)
        impl = backend_cls(spec, self)
        setup = getattr(impl, "setup", None)
        if setup is not None:
            await setup()
        gh = GroupHandle(spec, impl)
        self.groups[spec.name] = gh
        # blocking sync methods bridge through the io loop; a
        # proven-fast collective call must never be promoted onto the
        # loop itself (it would park the loop it needs) — disable the
        # inline-execution fast path for this worker outright
        server = getattr(self.rt, "_worker_server", None)
        if server is not None:
            server.disable_inline_execution(
                f"collective group {spec.name!r} member"
            )
        # drain-migration reform events: when a peer rank migrates off a
        # draining node, its restored process publishes on the group's
        # reform channel and every member (we included) enters the
        # same-world replacement reform.  Subscribing AFTER install means
        # a fresh/migrated member can never consume its own publish.
        try:
            await self.rt.subscribe_async(
                reform_channel(spec.name),
                lambda msg, _g=spec.name: self._on_reform_event(_g, msg),
            )
        except Exception:
            logger.warning(
                "reform-channel subscribe failed for group %r "
                "(drain-driven proactive reform disabled here)",
                spec.name, exc_info=True,
            )
        for cb in list(self._group_listeners.get(spec.name, ())):
            try:
                res = cb(gh)
                if asyncio.iscoroutine(res):
                    self.rt._spawn(res)
            except Exception:
                logger.exception(
                    "group listener failed for %r", spec.name
                )
        return gh

    def _on_reform_event(self, group_name: str, msg: dict):
        """Pubsub callback (io loop): a migrated member is re-joining —
        survivors reform at unchanged world size, keeping their ranks."""
        gh = self.groups.get(group_name)
        if gh is None:
            return  # not currently a member (mid-reform or torn down)
        origin = msg.get("origin_rank")
        if origin is not None and origin == gh.spec.rank:
            # our own old process's event echoed back (the predecessor of
            # a migrated member is still subscribed while it is killed) —
            # never reform against ourselves
            return
        if group_name in self._reforming:
            # park it: the migrating member behind this event still
            # needs a rendezvous round after the current one completes
            self._pending_reform[group_name] = msg
            return
        world_size = int(msg.get("world_size", gh.spec.world_size))
        self._reforming.add(group_name)

        async def go():
            try:
                await self.reform_group(group_name, world_size)
                logger.info(
                    "group %r proactively re-formed after a member "
                    "migration (rank %s moved)", group_name, origin,
                )
            except Exception:
                logger.exception(
                    "drain-driven reform of group %r failed; the group "
                    "is left uninitialized (destroy + re-init recovers)",
                    group_name,
                )
            finally:
                self._reforming.discard(group_name)
                pending = self._pending_reform.pop(group_name, None)
                if pending is not None:
                    self._on_reform_event(group_name, pending)

        self.rt._spawn(go())

    async def init_group(self, group_name: str, world_size: int, rank: int,
                         backend_name: str,
                         options: Optional[GroupOptions] = None
                         ) -> GroupHandle:
        if not (0 <= rank < world_size):
            raise CollectiveError(
                f"rank {rank} out of range for world_size {world_size}"
            )
        if group_name in self.groups:
            raise CollectiveError(
                f"collective group {group_name!r} already initialized in "
                f"this process; destroy_collective_group first"
            )
        if backend_kind(backend_name) != "runtime":
            raise CollectiveError(
                f"backend {backend_name!r} is an in-program backend: its "
                f"ops run inside a compiled program, not on runtime "
                f"tensors; use it via get_backend({backend_name!r}) "
                f"or pick 'rpc' for runtime groups"
            )
        options = (options or GroupOptions()).validate()
        actor_id = self.rt.actor_id.hex() if self.rt.actor_id else None
        me = await rendezvous.declare(
            self.rt, group_name, world_size, rank, actor_id,
            options=options,
        )
        try:
            members, incarnation, options = await rendezvous.await_members(
                self.rt, group_name, world_size, rank, me,
                options=options,
            )
            spec = GroupSpec(
                name=group_name, world_size=world_size, rank=rank,
                backend=backend_name, members=members,
                incarnation=incarnation, options=options,
            )
            return await self._install_group(spec)
        except BaseException:
            # a failed init never reaches self.groups, so destroy_group
            # would not retract for it — take the declared key back here
            # or a later same-name group reads this rank's stale record
            await rendezvous.retract(self.rt, group_name, rank)
            raise

    async def reform_group(self, group_name: str, world_size: int,
                           rank: Optional[int] = None,
                           backend_name: Optional[str] = None,
                           timeout: Optional[float] = None) -> GroupHandle:
        """Re-form a (typically poisoned) group without a full teardown:
        re-run GCS rendezvous at a bumped generation with the surviving
        ranks (shrink) or with a replacement member joining under the
        dead member's rank.

        Survivors call with just the new ``world_size``; shrinking
        reassigns new ranks by sorted old-rank order (phase-A roster),
        while an unchanged ``world_size`` keeps every survivor's rank
        and expects a replacement to join with an explicit ``rank=``.
        A replacement member (no local history for the group) must pass
        ``rank=`` and learns the generation from the stale KV record.

        Fallback: if reform itself fails (another member died mid-way,
        rendezvous times out), the group is left uninitialized locally —
        ``destroy_collective_group`` + ``init_collective_group`` with
        the live set is always available, and an un-reformed group stays
        poisoned rather than half-alive."""
        # validate BEFORE the destructive scrub below: a pure usage
        # error on a healthy group must not un-initialize it
        gh = self.groups.get(group_name)
        old_spec = gh.spec if gh is not None else None
        if old_spec is not None and world_size > old_spec.world_size:
            raise CollectiveError(
                f"reform cannot GROW group {group_name!r} "
                f"({old_spec.world_size} -> {world_size}); use "
                f"destroy_collective_group + init_collective_group"
            )
        if old_spec is None and rank is None:
            raise CollectiveError(
                f"reform of group {group_name!r} from a fresh member "
                f"needs rank= (the dead member's rank)"
            )
        if rank is not None and not (0 <= rank < world_size):
            raise CollectiveError(
                f"rank {rank} out of range for world_size {world_size}"
            )
        if (
            old_spec is not None
            and rank is not None
            and world_size < old_spec.world_size
        ):
            # a survivor with an explicit rank would skip the phase-A
            # roster declaration and strand every derive-mode survivor
            # until the rendezvous timeout — shrink ranks are DERIVED
            raise CollectiveError(
                f"reform of group {group_name!r}: shrink derives new "
                f"ranks from the surviving-rank order — do not pass "
                f"rank= from a survivor (rank= is for a replacement "
                f"member at unchanged world_size)"
            )
        self.groups.pop(group_name, None)
        # scrub every trace of the old incarnation: mailboxes (buffered
        # chunks are reclaimed), connection→group tracking (a late close
        # of a conn that carried OLD traffic must not poison the NEW
        # group), and the backend's own state
        for key in [k for k in self._inbox if k[0] == group_name]:
            self._drop_box(
                self._inbox.pop(key),
                CollectiveGroupError(f"group {group_name!r} is re-forming"),
            )
        for key in [k for k in self._tag_events if k[0] == group_name]:
            self._tag_events.pop(key).set()
        for pairs in self._conn_groups.values():
            pairs.difference_update({p for p in pairs if p[0] == group_name})
        if gh is not None:
            try:
                await gh.backend.shutdown()
            except Exception:
                pass
        if backend_name is None:
            backend_name = old_spec.backend if old_spec is not None else "rpc"
        # carry the FULL group config through the reform: algorithm
        # override, wire dtype, chunk size — a migration or shrink must
        # never silently change the group's wire format
        options = old_spec.options if old_spec is not None else None
        if old_spec is not None:
            gen = old_spec.reform_gen + 1
            if rank is None:
                if world_size == old_spec.world_size:
                    # replacement scenario: survivors keep their ranks,
                    # the fresh member joins under the dead one's rank
                    rank = old_spec.rank
                else:  # shrink (grow rejected above)
                    rank = await rendezvous.reform_roster(
                        self.rt, group_name, old_spec, world_size, timeout
                    )
        else:
            # replacement member: no local history (rank= validated
            # above) — learns the generation AND the group's data-path
            # config from the stale record it is about to overwrite
            gen, options = await rendezvous.peek_record(
                self.rt, group_name, rank
            )
            gen += 1
        options = (options or GroupOptions()).validate()
        actor_id = self.rt.actor_id.hex() if self.rt.actor_id else None
        me = await rendezvous.declare(
            self.rt, group_name, world_size, rank, actor_id, gen=gen,
            options=options,
        )
        members, incarnation, options = await rendezvous.await_members(
            self.rt, group_name, world_size, rank, me,
            timeout=timeout, gen=gen, options=options,
        )
        spec = GroupSpec(
            name=group_name, world_size=world_size, rank=rank,
            backend=backend_name, members=members,
            incarnation=incarnation, reform_gen=gen, options=options,
        )
        new_gh = await self._install_group(spec)
        if rank == 0 and old_spec is not None:
            await rendezvous.reform_cleanup(
                self.rt, group_name, old_spec, world_size
            )
        return new_gh

    async def destroy_group(self, group_name: str):
        gh = self.groups.pop(group_name, None)
        for key in [k for k in self._inbox if k[0] == group_name]:
            box = self._inbox.pop(key)
            self._drop_box(
                box, CollectiveGroupError(f"group {group_name!r} destroyed")
            )
        for key in [k for k in self._tag_events if k[0] == group_name]:
            self._tag_events.pop(key).set()
        # forget the group's connection tracking: a later close of a
        # conn that once carried this group's traffic must not poison a
        # re-initialized same-name group
        for pairs in self._conn_groups.values():
            pairs.difference_update(
                {p for p in pairs if p[0] == group_name}
            )
        if gh is not None:
            try:
                await gh.backend.shutdown()
            except Exception:
                pass
            await rendezvous.retract(self.rt, group_name, gh.spec.rank)

    def get_group(self, group_name: str) -> GroupHandle:
        gh = self.groups.get(group_name)
        if gh is None:
            raise CollectiveError(
                f"collective group {group_name!r} is not initialized in "
                f"this process; call init_collective_group first "
                f"(initialized here: {sorted(self.groups)})"
            )
        return gh


# --------------------------------------------------------------------------
# module-level API (the ray.util.collective-shaped surface)
# --------------------------------------------------------------------------

_managers: Dict[int, CollectiveManager] = {}
_mgr_lock = threading.Lock()


def _manager() -> CollectiveManager:
    rt = get_runtime()
    key = id(rt)
    mgr = _managers.get(key)
    if mgr is None or mgr.rt is not rt:
        with _mgr_lock:
            mgr = _managers.get(key)
            if mgr is None or mgr.rt is not rt:
                _managers.clear()  # previous runtime's manager is dead
                mgr = CollectiveManager(rt)
                _managers[key] = mgr
    return mgr


def _run_blocking(coro):
    """Bridge a collective coroutine from a sync caller onto the io
    loop.  Refuses to run ON the loop (that would deadlock it): async
    actor methods must use the *_async twins (rtlint RT109)."""
    rt = get_runtime()
    if threading.current_thread() is rt._thread:
        raise CollectiveError(
            "blocking collective op called on the runtime io loop; "
            "use the *_async twin (e.g. `await allreduce_async(...)`) "
            "or hand the sync op to a thread with asyncio.to_thread"
        )
    return rt._run(coro, timeout=None)


def _coerce_options(options) -> Optional[GroupOptions]:
    if options is None or isinstance(options, GroupOptions):
        return options
    if isinstance(options, dict):
        return GroupOptions.from_dict(options)
    raise CollectiveError(
        f"options must be a GroupOptions or dict, got {type(options)}"
    )


def init_collective_group(world_size: int, rank: int, *,
                          backend: str = "rpc",
                          group_name: str = DEFAULT_GROUP_NAME,
                          options=None) -> None:
    """Join a collective group (call from inside each member actor).

    ``options`` (GroupOptions or dict) sets the group's data path:
    ``algorithm`` ("auto" for the size/topology selection table, or an
    explicit name), ``wire_dtype`` ("bf16"/"int8" block-quantized
    payloads), ``chunk_bytes``, ``quant_block``.  Rank 0's copy is
    authoritative group-wide and persists through
    ``reform_collective_group``."""
    mgr = _manager()
    _run_blocking(mgr.init_group(
        group_name, world_size, rank, backend,
        options=_coerce_options(options),
    ))


def _init_in_actor(inst, group_name, world_size, rank, backend, options):
    init_collective_group(
        world_size, rank, backend=backend, group_name=group_name,
        options=options,
    )
    return True


def _destroy_in_actor(inst, group_name):
    destroy_collective_group(group_name=group_name)
    return True


def create_collective_group(actors, *, world_size: Optional[int] = None,
                            ranks: Optional[List[int]] = None,
                            backend: str = "rpc",
                            group_name: str = DEFAULT_GROUP_NAME,
                            timeout: Optional[float] = None,
                            options=None) -> None:
    """Driver-side declarative form: make ``actors`` a collective group
    (actor i gets ``ranks[i]``, default i).  Blocks until every member
    finished rendezvous — afterwards ops may be issued on any member.

    ``world_size`` may exceed ``len(actors)``: the remaining ranks then
    join from their own processes via ``init_collective_group`` (the
    mixed declaration pattern) — this call blocks until THEY arrive too,
    since rendezvous completes only at full membership."""
    import ray_tpu_torch

    if world_size is None:
        world_size = len(actors)
    if ranks is None:
        if world_size != len(actors):
            raise CollectiveError(
                f"world_size {world_size} != len(actors) "
                f"{len(actors)}: pass explicit ranks for the declared "
                f"subset (the rest join via init_collective_group)"
            )
        ranks = list(range(len(actors)))
    if len(ranks) != len(actors):
        raise CollectiveError(
            f"{len(ranks)} ranks for {len(actors)} actors"
        )
    if len(set(ranks)) != len(ranks) or not all(
        0 <= r < world_size for r in ranks
    ):
        raise CollectiveError(
            f"ranks {ranks} must be distinct and within "
            f"0..{world_size - 1}"
        )
    opts = _coerce_options(options)
    refs = [
        a._apply(_init_in_actor, group_name, world_size, rk, backend, opts)
        for a, rk in zip(actors, ranks)
    ]
    ray_tpu_torch.get(
        refs,
        timeout=timeout
        if timeout is not None
        else cfg.collective_rendezvous_timeout_s + 30.0,
    )


def _reform_in_actor(inst, group_name, world_size, rank, backend):
    reform_collective_group(world_size, rank=rank, group_name=group_name,
                            backend=backend)
    return True


def reform_collective_group(world_size: int, *,
                            rank: Optional[int] = None,
                            group_name: str = DEFAULT_GROUP_NAME,
                            backend: Optional[str] = None,
                            timeout: Optional[float] = None,
                            actors=None,
                            ranks: Optional[List[int]] = None) -> None:
    """Re-form a group after a member death — the alternative to a full
    teardown when the group is poisoned.

    In-actor (each surviving member calls it, concurrently)::

        col.reform_collective_group(3, group_name=g)        # shrink 4→3
        col.reform_collective_group(4, group_name=g)        # survivor,
                                                            # keeps rank
        col.reform_collective_group(4, rank=2, group_name=g)  # the
                                                            # REPLACEMENT

    Shrinking DERIVES new ranks (sorted old-rank order) — survivors
    must not pass ``rank=`` on a shrink; an unchanged world_size keeps
    survivor ranks and expects a replacement member to join with the
    dead member's ``rank``.  Driver-side declarative form: pass
    ``actors`` (the surviving/replacement handles) and optionally
    ``ranks`` (None entries mean "derive like the in-actor form";
    explicit entries only for replacement members).

    On failure the group is left uninitialized locally (poisoning
    fallback): ``destroy_collective_group`` + ``init_collective_group``
    always recovers."""
    if actors is not None:
        import ray_tpu_torch

        if ranks is None:
            ranks = [None] * len(actors)
        if len(ranks) != len(actors):
            raise CollectiveError(
                f"{len(ranks)} ranks for {len(actors)} actors"
            )
        refs = [
            a._apply(_reform_in_actor, group_name, world_size, rk, backend)
            for a, rk in zip(actors, ranks)
        ]
        ray_tpu_torch.get(
            refs,
            timeout=timeout
            if timeout is not None
            else cfg.collective_rendezvous_timeout_s + 30.0,
        )
        return
    mgr = _manager()
    _run_blocking(mgr.reform_group(
        group_name, world_size, rank=rank, backend_name=backend,
        timeout=timeout,
    ))


async def reform_collective_group_async(world_size: int, *,
                                        rank: Optional[int] = None,
                                        group_name: str = DEFAULT_GROUP_NAME,
                                        backend: Optional[str] = None,
                                        timeout: Optional[float] = None) -> None:
    """Loop-native twin of :func:`reform_collective_group` for async
    actor methods (RT109: the blocking form would park the io loop)."""
    await _manager().reform_group(
        group_name, world_size, rank=rank, backend_name=backend,
        timeout=timeout,
    )


def destroy_collective_group(group_name: str = DEFAULT_GROUP_NAME,
                             actors=None) -> None:
    """Tear the group down.  In-actor: drops this rank's state.  With
    ``actors`` (driver side): tears down every member."""
    if actors is not None:
        import ray_tpu_torch

        refs = [a._apply(_destroy_in_actor, group_name) for a in actors]
        ray_tpu_torch.get(refs, timeout=60.0)
        return
    mgr = _manager()
    _run_blocking(mgr.destroy_group(group_name))


def is_group_initialized(group_name: str = DEFAULT_GROUP_NAME) -> bool:
    try:
        return group_name in _manager().groups
    except Exception:
        return False


def local_group_memberships() -> List[dict]:
    """Groups THIS process is a member of — the drain plane's migration
    envelope (worker_main.handle_checkpoint_actor ships it so a migrated
    actor's new process can re-join under its old ranks).  Passive: never
    instantiates a manager, so a process that never touched collectives
    reports [] without side effects."""
    try:
        rt = get_runtime()
    except Exception:
        return []
    mgr = _managers.get(id(rt))
    if mgr is None or mgr.rt is not rt:
        return []
    return [
        {
            "group_name": name,
            "world_size": gh.spec.world_size,
            "rank": gh.spec.rank,
            "backend": gh.spec.backend,
            "options": gh.spec.options.to_dict(),
        }
        for name, gh in mgr.groups.items()
    ]


def get_rank(group_name: str = DEFAULT_GROUP_NAME) -> int:
    return _manager().get_group(group_name).spec.rank


def get_group_options(group_name: str = DEFAULT_GROUP_NAME) -> GroupOptions:
    """The group's live data-path config (algorithm override, wire
    dtype, chunk size) — what the selection layer consults, and what a
    reform must carry unchanged."""
    return _manager().get_group(group_name).spec.options


def get_collective_group_size(group_name: str = DEFAULT_GROUP_NAME) -> int:
    return _manager().get_group(group_name).spec.world_size


def get_backend(name: str):
    """The registered backend class/adapter for ``name`` (for an
    in-program backend; runtime groups go through init)."""
    return resolve_backend(name)


# ---- async op twins (awaitable on the io loop: async actor methods) ----

async def _collective_op(group_name, fn):
    gh = _manager().get_group(group_name)
    gh.check_alive()
    async with gh.op_lock:
        gh.check_alive()
        try:
            return await fn(gh)
        except asyncio.CancelledError:
            raise
        except CollectiveGroupError as e:
            # already actionable (poisoned group / member timeout);
            # make sure this process's group state agrees
            _manager().fail_group(group_name, e, propagate=True)
            raise
        except CollectiveError:
            # usage error (bad root/rank, unsupported op) raised before
            # any ring traffic: the op fails, the group stays usable
            raise
        except Exception as e:
            # a mid-op transport error (peer conn refused/reset) poisons
            # the group: partial ring state is unrecoverable (peers hold
            # partial sums) — surface the actionable wrapper
            err = CollectiveGroupError(
                f"collective op on group {group_name!r} failed "
                f"mid-flight ({e!r}); a member is likely dead.  The "
                f"group is poisoned — destroy_collective_group and "
                f"re-init with live members."
            )
            _manager().fail_group(group_name, err, propagate=True)
            raise err from e


async def allreduce_async(tensor, group_name: str = DEFAULT_GROUP_NAME,
                          op: ReduceOp = ReduceOp.SUM, *,
                          wire_dtype: Optional[str] = None,
                          algorithm: Optional[str] = None):
    return await _collective_op(
        group_name,
        lambda gh: gh.backend.allreduce(
            tensor, op, wire_dtype=wire_dtype, algorithm=algorithm
        ),
    )


async def allgather_async(tensor, group_name: str = DEFAULT_GROUP_NAME):
    return await _collective_op(
        group_name, lambda gh: gh.backend.allgather(tensor)
    )


async def reducescatter_async(tensor, group_name: str = DEFAULT_GROUP_NAME,
                              op: ReduceOp = ReduceOp.SUM, *,
                              wire_dtype: Optional[str] = None):
    return await _collective_op(
        group_name,
        lambda gh: gh.backend.reducescatter(
            tensor, op, wire_dtype=wire_dtype
        ),
    )


async def broadcast_async(tensor, src_rank: int = 0,
                          group_name: str = DEFAULT_GROUP_NAME, *,
                          wire_dtype: Optional[str] = None,
                          algorithm: Optional[str] = None):
    return await _collective_op(
        group_name,
        lambda gh: gh.backend.broadcast(
            tensor, src_rank, wire_dtype=wire_dtype, algorithm=algorithm
        ),
    )


async def broadcast_object_async(obj=None, src_rank: int = 0,
                                 group_name: str = DEFAULT_GROUP_NAME):
    return await _collective_op(
        group_name, lambda gh: gh.backend.broadcast_object(obj, src_rank)
    )


async def barrier_async(group_name: str = DEFAULT_GROUP_NAME):
    return await _collective_op(group_name, lambda gh: gh.backend.barrier())


async def _p2p_op(group_name, peer_rank, fn):
    """Like _collective_op but WITHOUT the per-group op lock: pairwise
    traffic from concurrent threads must not serialize against group
    collectives (a PS server recv parked under the lock while a worker
    thread needs to send would deadlock the pattern, not the loop)."""
    gh = _manager().get_group(group_name)
    gh.check_alive()
    try:
        return await fn(gh)
    except asyncio.CancelledError:
        raise
    except CollectiveGroupError as e:
        _manager().fail_group(group_name, e, propagate=True)
        raise
    except CollectiveError:
        raise  # usage error (self-send, bad rank): op fails, group lives
    except Exception as e:
        err = CollectiveGroupError(
            f"p2p op with rank {peer_rank} on group {group_name!r} "
            f"failed ({e!r}); the peer is likely dead.  The group is "
            f"poisoned — destroy_collective_group and re-init."
        )
        _manager().fail_group(group_name, err, propagate=True)
        raise err from e


async def send_async(tensor, dst_rank: int,
                     group_name: str = DEFAULT_GROUP_NAME):
    return await _p2p_op(
        group_name, dst_rank, lambda gh: gh.backend.send(tensor, dst_rank)
    )


async def recv_async(tensor, src_rank: int,
                     group_name: str = DEFAULT_GROUP_NAME):
    return await _p2p_op(
        group_name, src_rank, lambda gh: gh.backend.recv(tensor, src_rank)
    )


# ---- blocking ops (sync actor methods; NOT for async def — RT109) ------

def allreduce(tensor, group_name: str = DEFAULT_GROUP_NAME,
              op: ReduceOp = ReduceOp.SUM, *,
              wire_dtype: Optional[str] = None,
              algorithm: Optional[str] = None):
    """Allreduce; returns the reduced array (same shape/dtype).

    ``wire_dtype="int8"|"bf16"`` ships block-quantized payloads for
    this op (overriding the group default; "fp32" forces raw bytes);
    ``algorithm`` overrides the selection table ("ring", "rd", "auto").
    Every rank must pass the SAME per-op overrides."""
    return _run_blocking(allreduce_async(
        tensor, group_name, op, wire_dtype=wire_dtype, algorithm=algorithm
    ))


def allgather(tensor, group_name: str = DEFAULT_GROUP_NAME):
    """Returns [array from rank 0, ..., array from rank n-1]."""
    return _run_blocking(allgather_async(tensor, group_name))


def reducescatter(tensor, group_name: str = DEFAULT_GROUP_NAME,
                  op: ReduceOp = ReduceOp.SUM, *,
                  wire_dtype: Optional[str] = None):
    """Reduce then scatter: returns THIS rank's segment of the reduced
    flat tensor (numpy array_split segmentation)."""
    return _run_blocking(reducescatter_async(
        tensor, group_name, op, wire_dtype=wire_dtype
    ))


def broadcast(tensor, src_rank: int = 0,
              group_name: str = DEFAULT_GROUP_NAME, *,
              wire_dtype: Optional[str] = None,
              algorithm: Optional[str] = None):
    """Root's tensor replicated to all; non-root tensors are filled
    in place (shapes/dtypes must match) and returned.  With a
    ``wire_dtype`` codec every rank (root included) returns the decode
    of the root's one encoding — all ranks bit-identical."""
    return _run_blocking(broadcast_async(
        tensor, src_rank, group_name,
        wire_dtype=wire_dtype, algorithm=algorithm,
    ))


def broadcast_object(obj=None, src_rank: int = 0,
                     group_name: str = DEFAULT_GROUP_NAME):
    """Pickle-broadcast an arbitrary object from ``src_rank``; non-root
    callers pass obj=None and get the root's object back."""
    return _run_blocking(broadcast_object_async(obj, src_rank, group_name))


def barrier(group_name: str = DEFAULT_GROUP_NAME):
    """Block until every rank has entered the barrier."""
    return _run_blocking(barrier_async(group_name))


def send(tensor, dst_rank: int, group_name: str = DEFAULT_GROUP_NAME):
    """Point-to-point send to ``dst_rank`` (pairs with its recv)."""
    return _run_blocking(send_async(tensor, dst_rank, group_name))


def recv(tensor, src_rank: int, group_name: str = DEFAULT_GROUP_NAME):
    """Receive into ``tensor`` (shape/dtype must match the send);
    returns the filled array."""
    return _run_blocking(recv_async(tensor, src_rank, group_name))


# ---- pytree broadcast (weight-sync consumers: learner group, serve) ----

class _QLeaf:
    """Placeholder for a float32 leaf extracted into the concatenated
    quantized tensor (position + original shape).  ``tensor`` is
    ``torch.float32`` for a ``torch.Tensor`` leaf and None for a numpy
    one: unpickling it imports torch on a rank that has not, as the
    serializer's tensor restore does."""

    __slots__ = ("idx", "shape", "tensor")

    def __init__(self, idx: int, shape: tuple, tensor=None):
        self.idx = idx
        self.shape = tuple(shape)
        self.tensor = tensor

    def __reduce__(self):
        return (_QLeaf, (self.idx, self.shape, self.tensor))


def _strip_f32(node, leaves: list):
    import numpy as np

    if isinstance(node, dict):
        return {k: _strip_f32(v, leaves) for k, v in node.items()}
    if isinstance(node, list):
        return [_strip_f32(v, leaves) for v in node]
    if isinstance(node, tuple):
        return tuple(_strip_f32(v, leaves) for v in node)
    if isinstance(node, np.ndarray) and node.dtype == np.float32:
        leaves.append(np.ascontiguousarray(node))
        return _QLeaf(len(leaves) - 1, node.shape)
    # torch is looked up, never imported: a tensor leaf means the caller
    # has it.  Other tensor dtypes (bf16 weights) stay exact in the
    # skeleton, as non-f32 numpy leaves do.
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(node, torch.Tensor) and node.dtype == torch.float32:
        leaves.append(node.detach().cpu().contiguous().numpy().reshape(-1))
        return _QLeaf(len(leaves) - 1, node.shape, torch.float32)
    return node


def _fill_f32(node, arrs: list):
    if isinstance(node, dict):
        return {k: _fill_f32(v, arrs) for k, v in node.items()}
    if isinstance(node, list):
        return [_fill_f32(v, arrs) for v in node]
    if isinstance(node, _QLeaf):
        a = arrs[node.idx].reshape(node.shape)
        if node.tensor is None:
            return a
        # a CPU tensor that owns its memory, as the serializer restores one
        return sys.modules["torch"].from_numpy(a.copy())
    if isinstance(node, tuple):
        return tuple(_fill_f32(v, arrs) for v in node)
    return node


async def broadcast_tree_async(tree=None, src_rank: int = 0,
                               group_name: str = DEFAULT_GROUP_NAME, *,
                               wire_dtype: Optional[str] = None):
    """Broadcast a pytree (nested dict/list/tuple) of numpy arrays or
    ``torch.Tensor`` leaves from ``src_rank`` — the weight-sync
    primitive (a model's state dict is such a tree).

    Without a codec this is plain ``broadcast_object``.  With
    ``wire_dtype`` the float32 leaves ride ONE concatenated quantized
    tensor broadcast (structure + non-f32 leaves, bf16 tensors included,
    stay exact in the pickled skeleton), and EVERY rank — the root
    included — returns the decode of the root's single encoding, so all
    replicas end bit-identical (the root trades its exact copy for
    fleet-wide equality, which is what replicated serving/learning
    needs).  Tensor leaves come back as CPU tensors of their dtype and
    shape."""
    import numpy as np

    if wire_dtype is None or wire_dtype == "fp32":
        return await broadcast_object_async(tree, src_rank, group_name)
    rank = _manager().get_group(group_name).spec.rank
    if rank == src_rank:
        leaves: list = []
        skel = _strip_f32(tree, leaves)
        sizes = [int(a.size) for a in leaves]
        flat = (
            np.concatenate([a.reshape(-1) for a in leaves])
            if leaves else np.empty(0, np.float32)
        )
        await broadcast_object_async(
            {"skel": skel, "sizes": sizes, "n": int(flat.size)},
            src_rank, group_name,
        )
    else:
        meta = await broadcast_object_async(None, src_rank, group_name)
        skel, sizes = meta["skel"], meta["sizes"]
        flat = np.zeros(meta["n"], dtype=np.float32)
    out = await broadcast_async(
        flat, src_rank, group_name, wire_dtype=wire_dtype
    )
    arrs, off = [], 0
    for sz in sizes:
        arrs.append(out[off:off + sz])
        off += sz
    return _fill_f32(skel, arrs)


def broadcast_tree(tree=None, src_rank: int = 0,
                   group_name: str = DEFAULT_GROUP_NAME, *,
                   wire_dtype: Optional[str] = None):
    """Blocking twin of :func:`broadcast_tree_async`."""
    return _run_blocking(broadcast_tree_async(
        tree, src_rank, group_name, wire_dtype=wire_dtype
    ))


# ---- async progress engine (launch / wait: compute-comm overlap) -------

class CollectiveWork:
    """Handle to a collective in flight on the runtime's io loop.

    The T3-style overlap surface (arxiv 2401.16677) without
    caller-side threading: ``launch`` returns immediately, the chunked
    collective steps progress on the runtime loop (socket traffic and
    shm handoffs interleave with whatever the caller thread does —
    jax compute, typically), and ``wait()`` joins and returns the op's
    result.  The input tensor is OWNED by the collective until
    ``wait()`` returns: mutating it mid-flight races the chunk reads.

    Failure surfaces at ``wait()`` exactly as it would from the
    blocking op (same poisoning semantics — the coroutine underneath
    IS the ``*_async`` twin)."""

    __slots__ = ("_fut", "op", "group_name")

    def __init__(self, fut, op: str, group_name: str):
        self._fut = fut
        self.op = op
        self.group_name = group_name

    def done(self) -> bool:
        """True once the op finished (successfully or not)."""
        return self._fut.done()

    def wait(self, timeout: Optional[float] = None):
        """Block until the op completes; returns its result (the
        reduced/filled array) or raises its failure."""
        return self._fut.result(timeout)

    def exception(self, timeout: Optional[float] = None):
        """The op's exception (None on success); blocks like wait."""
        return self._fut.exception(timeout)


def _launch(coro, op: str, group_name: str) -> CollectiveWork:
    rt = get_runtime()
    if threading.current_thread() is rt._thread:
        raise CollectiveError(
            "collective launch from the runtime io loop: you are "
            "already async — just `await` the *_async twin (and don't "
            "block the loop on wait())"
        )
    return CollectiveWork(
        asyncio.run_coroutine_threadsafe(coro, rt._loop), op, group_name
    )


def allreduce_launch(tensor, group_name: str = DEFAULT_GROUP_NAME,
                     op: ReduceOp = ReduceOp.SUM, *,
                     wire_dtype: Optional[str] = None,
                     algorithm: Optional[str] = None) -> CollectiveWork:
    """Start an allreduce and return immediately: run compute while
    the chunked ring/rd steps progress on the runtime loop, then
    ``work.wait()`` for the reduced array."""
    return _launch(
        allreduce_async(tensor, group_name, op,
                        wire_dtype=wire_dtype, algorithm=algorithm),
        "allreduce", group_name,
    )


def broadcast_launch(tensor, src_rank: int = 0,
                     group_name: str = DEFAULT_GROUP_NAME, *,
                     wire_dtype: Optional[str] = None,
                     algorithm: Optional[str] = None) -> CollectiveWork:
    """Start a broadcast and return immediately (see
    allreduce_launch)."""
    return _launch(
        broadcast_async(tensor, src_rank, group_name,
                        wire_dtype=wire_dtype, algorithm=algorithm),
        "broadcast", group_name,
    )


def allgather_launch(tensor,
                     group_name: str = DEFAULT_GROUP_NAME) -> CollectiveWork:
    """Start an allgather and return immediately (see
    allreduce_launch)."""
    return _launch(
        allgather_async(tensor, group_name), "allgather", group_name
    )


def send_launch(tensor, dst_rank: int,
                group_name: str = DEFAULT_GROUP_NAME) -> CollectiveWork:
    """Start a p2p send and return immediately: the chunked transfer
    progresses on the runtime loop while the caller computes (the T3
    overlap shape the pipeline channels build on)."""
    return _launch(
        send_async(tensor, dst_rank, group_name), "send", group_name
    )


def recv_launch(tensor, src_rank: int,
                group_name: str = DEFAULT_GROUP_NAME) -> CollectiveWork:
    """Start a p2p receive into ``tensor`` and return immediately
    (see send_launch); ``work.wait()`` before reading the buffer."""
    return _launch(
        recv_async(tensor, src_rank, group_name), "recv", group_name
    )
