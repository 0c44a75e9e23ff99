"""GCS: the cluster-global control plane.

Role-equivalent of the reference's GCS server (ray:
src/ray/gcs/gcs_server/gcs_server.h:78 and the managers under it —
GcsNodeManager, GcsActorManager gcs_actor_manager.h:281, GcsJobManager,
GcsKvManager, GcsHealthCheckManager) plus the *global* half of scheduling.

Design difference from the reference, on purpose: the reference scatters
scheduling across per-node raylets with spillback (raylet/scheduling/
cluster_task_manager.h) because its clusters are huge and heterogeneous.
A TPU cluster is a few hundred hosts arranged in slices, and gang placement
is the common case — so scheduling here is GCS-centric: submitters lease
workers from the GCS scheduler (amortized by client-side lease reuse), and
the raylet is just a worker factory.  This removes the lease-spillback
round-trips entirely and makes gang (slice) placement a single atomic
decision.

All state is in-memory; persistence/HA hooks live behind `CheckpointStore`
(flushed on change, reloadable on restart — the reference's Redis-backed
StoreClient analogue, gcs/store_client/store_client.h).
"""

from __future__ import annotations

import asyncio
import copy
import logging
import os
import time
from collections import OrderedDict, deque
from typing import Deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch.common.config import cfg
from ray_tpu_torch.common.health import (
    PhiAccrualDetector,
    death_confirmed,
    is_suspect,
)
from ray_tpu_torch.common.constants import (
    PG_CREATED,
    PG_PENDING,
    PG_REMOVED,
    PG_RESCHEDULING,
    PG_STRATEGIES,
    session_root,
)
from ray_tpu_torch.common.ids import ActorID, JobID, NodeID, PlacementGroupID, WorkerID
from ray_tpu_torch.common.resources import ResourceSet
from ray_tpu_torch.core import rpc
from ray_tpu_torch.core.errors import FencedError

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------------
# Tables
# --------------------------------------------------------------------------


@dataclass
class NodeEntry:
    node_id: NodeID
    address: str  # raylet rpc address
    resources_total: ResourceSet
    resources_available: ResourceSet
    labels: Dict[str, str]
    conn: rpc.Connection
    alive: bool = True
    # adaptive failure detection (common/health.py): phi crossed the
    # suspect threshold — the node is DEPRIORITIZED (leases, pulls,
    # serve routing) but nothing is killed until phi confirms death.
    # Cleared the moment a heartbeat arrives.
    suspect: bool = False
    # monotonically-increasing life counter, bumped on every fresh
    # (re)registration and on _on_node_death — the fencing token: RPCs
    # carrying a stale incarnation are rejected with FencedError, so a
    # zombie raylet on the far side of a healed partition can never
    # keep serving objects or leases alongside its replacement
    incarnation: int = 0
    draining: bool = False  # drain requested: stop scheduling onto it
    # drain protocol v2 (rpc_drain_node): why and until when
    drain_reason: Optional[str] = None  # "idle" | "preemption"
    drain_status: Optional[dict] = None  # progress; see _drain_node
    # lease_worker calls currently awaiting this node's raylet: a grant
    # issued just before a drain began is not in self.leases yet, and
    # the drain's settle phase must not conclude "no work here" while
    # one is in flight (its task would dispatch onto the node after the
    # final evacuation sweep and be lost to the kill)
    inflight_grants: int = 0
    last_heartbeat: float = field(default_factory=time.monotonic)

    # Write-through scheduler index: every assignment to a field the
    # scheduler scores by re-buckets this node (class attrs, not dataclass
    # fields — set per-instance by Scheduler.index_node).
    _sched = None
    _bucket = None

    def __setattr__(self, name, value):
        if name == "resources_available":
            old = getattr(self, "resources_available", None)
            object.__setattr__(self, name, value)
            sched = self._sched
            if sched is not None:
                sched.note_available_change(self, old, value)
            return
        object.__setattr__(self, name, value)
        if name in ("alive", "draining", "conn", "suspect"):
            sched = self._sched
            if sched is not None:
                sched.rebucket(self)


@dataclass
class LeaseEntry:
    lease_id: int
    node_id: NodeID
    worker_id: WorkerID
    worker_addr: str
    resources: ResourceSet
    client_conn: rpc.Connection  # the submitter holding the lease
    actor_id: Optional[ActorID] = None  # set for actor-dedicated leases
    # (pg_id, bundle_index) when the lease draws from a placement-group
    # bundle instead of the node's general pool
    pg_ref: Optional[Tuple[PlacementGroupID, int]] = None


RUNNING_JOB = "RUNNING"
SUCCEEDED_JOB = "SUCCEEDED"
FAILED_JOB = "FAILED"
STOPPED_JOB = "STOPPED"

ACTOR_PENDING = "PENDING_CREATION"
ACTOR_ALIVE = "ALIVE"
ACTOR_RESTARTING = "RESTARTING"
ACTOR_DEAD = "DEAD"

@dataclass
class PlacementGroupEntry:
    """A gang reservation: bundles of resources carved out of nodes.

    Role-equivalent of ray: src/ray/gcs/gcs_server/gcs_placement_group_manager.h:230.
    Because all scheduling is GCS-centric here, "prepare/commit 2-phase
    protocol across raylets" (gcs_placement_group_scheduler.cc) collapses
    to an atomic in-memory reservation: bundle resources move from the
    node's pool into the PG at creation, and leases inside the PG draw
    from the bundle instead of the node.
    """

    pg_id: PlacementGroupID
    name: Optional[str]
    strategy: str
    bundles: List[ResourceSet]
    state: str
    owner_job: Optional[JobID]
    detached: bool
    bundle_nodes: List[Optional[NodeID]]
    bundle_available: List[ResourceSet]
    namespace: str = "default"
    created_at: float = field(default_factory=time.time)


@dataclass
class ActorEntry:
    actor_id: ActorID
    name: Optional[str]
    namespace: str
    state: str
    owner_job: JobID
    max_restarts: int
    restarts_used: int = 0
    creation_spec: Any = None  # serialized class+args, kept for restarts
    resources: Dict[str, float] = field(default_factory=dict)
    scheduling: Dict[str, Any] = field(default_factory=dict)
    worker_addr: Optional[str] = None
    node_id: Optional[NodeID] = None
    lease_id: Optional[int] = None
    detached: bool = False
    runtime_env: Optional[dict] = None  # descriptor for restart replay
    # graceful-drain policy: "migrate" (default — the GCS checkpoint/
    # restart-migrates it off a draining node) or "ignore" (an app-level
    # manager owns relocation, e.g. serve replicas ride the controller's
    # drain-then-stop flow instead)
    on_drain: str = "migrate"
    death_cause: Optional[str] = None
    num_pending_restart_waiters: int = 0
    # conn of the creating client while PENDING_CREATION; a PENDING actor
    # whose creator vanishes can never be reported started — kill it so
    # callers waiting on the state don't hang forever
    creator_conn: Any = None


@dataclass
class PendingLease:
    """A queued lease request waiting for capacity."""

    fut: asyncio.Future
    demand: ResourceSet
    strategy: Dict[str, Any]
    client_conn: rpc.Connection
    actor_id: Optional[ActorID]
    enqueued_at: float = field(default_factory=time.monotonic)
    # client-chosen tag (scheduling-class id) so the client can cancel
    # parked requests whose demand evaporated (ray: CancelWorkerLease)
    tag: Optional[int] = None


# --------------------------------------------------------------------------
# Scheduler policies (ray: raylet/scheduling/policy/* redesigned global)
# --------------------------------------------------------------------------


_NBUCKETS = 64          # utilization buckets (~1.6% granularity)
_FULL_BUCKET = _NBUCKETS        # max-utilization >= 1.0
_SUSPECT_BUCKET = _NBUCKETS + 1  # alive but failure-suspected: scanned
#   LAST by every strategy, so a suspect node costs placement
#   preference (nothing new lands there while healthy capacity exists)
#   without costing an outage — the DRAINING parking machinery, one
#   notch softer
_PARKED_BUCKET = _NBUCKETS + 2  # dead / draining / not-yet-attached


class Scheduler:
    """Global resource accounting + node selection.

    Scale: nodes live in a write-through utilization-bucket index
    (NodeEntry.__setattr__ re-buckets on every availability/liveness
    change), so node selection is O(1) amortized instead of an O(nodes)
    scan — the binpack/spread orderings become bucket-granular (~1.6%)
    approximations of their exact forms.  Feasibility checks are cached
    per demand signature (totals only change on membership changes).
    `_kick_pending` wakes queued requests through a bounded scan window,
    so a deep backlog (100k+ queued, reference envelope: 1M) costs
    O(granted + window) per freed lease, not O(backlog).
    """

    def __init__(self, gcs: "GcsServer"):
        self.gcs = gcs
        self.pending: Deque[PendingLease] = deque()
        self._buckets: List[Dict[NodeID, NodeEntry]] = [
            {} for _ in range(_PARKED_BUCKET + 1)
        ]
        self._node_entry: Dict[NodeID, NodeEntry] = {}  # indexed entry
        self._feasible_cache: Dict[tuple, bool] = {}
        # the node shapes an attached autoscaler can launch
        # (rpc_get_autoscaler_state): a demand one of them covers queues
        self.launchable: List[ResourceSet] = []
        # no-fit fast path: when nothing in the cluster fits a demand,
        # every queued waiter re-asks constantly (kick scans) — a full
        # fail scan touches the whole "full" bucket, O(nodes).  A no-fit
        # verdict stays valid until capacity INCREASES somewhere, so it's
        # cached against an epoch bumped on every availability increase
        # (returns, node joins, unparks) — never on debits, which can't
        # turn no-fit into fit.
        self._capacity_epoch = 0
        self._nofit: Dict[tuple, int] = {}

    # -- index maintenance ----------------------------------------------
    def index_node(self, n: NodeEntry):
        # Evict a superseded entry for the same node (raylet
        # re-registration builds a fresh NodeEntry): the old one may sit
        # in a different bucket and would otherwise remain pickable
        # forever — a live ghost the scheduler grants against.
        old = self._node_entry.get(n.node_id)
        if old is not None and old is not n:
            if old._bucket is not None:
                self._buckets[old._bucket].pop(n.node_id, None)
            object.__setattr__(old, "_sched", None)
            object.__setattr__(old, "_bucket", None)
        self._node_entry[n.node_id] = n
        object.__setattr__(n, "_sched", self)
        object.__setattr__(n, "_bucket", None)
        self.rebucket(n)
        self._feasible_cache.clear()

    def _bucket_of(self, n: NodeEntry) -> int:
        if not n.alive or n.conn is None or n.draining:
            return _PARKED_BUCKET
        if n.suspect:
            return _SUSPECT_BUCKET
        u = n.resources_available.utilization(n.resources_total)
        if u >= 1.0:
            return _FULL_BUCKET
        return min(int(u * _NBUCKETS), _NBUCKETS - 1)

    def rebucket(self, n: NodeEntry):
        b = self._bucket_of(n)
        old = n._bucket
        if b == old:
            return
        if old is not None:
            self._buckets[old].pop(n.node_id, None)
        self._buckets[b][n.node_id] = n
        object.__setattr__(n, "_bucket", b)
        if old is None or b < old:
            # capacity appeared (node joined / unparked / freed into a
            # lower-utilization bucket)
            self._capacity_epoch += 1
        if b == _PARKED_BUCKET or old == _PARKED_BUCKET:
            # liveness changed: cached feasibility may now be wrong
            self._feasible_cache.clear()

    def note_available_change(self, n: NodeEntry, old_rs, new_rs):
        """resources_available was assigned: rebucket, and bump the
        capacity epoch on any per-resource INCREASE even when the bucket
        index doesn't move (a 1-CPU return on a large node stays in the
        same ~1.6% bucket but can turn a cached no-fit into a fit)."""
        self.rebucket(n)
        if old_rs is None:
            self._capacity_epoch += 1
            return
        old_fp = old_rs._fp
        for k, v in new_rs._fp.items():
            if v > old_fp.get(k, 0):
                self._capacity_epoch += 1
                return

    # -- queries ---------------------------------------------------------
    def is_feasible(self, demand: ResourceSet) -> bool:
        key = tuple(sorted(demand._fp.items()))
        hit = self._feasible_cache.get(key)
        if hit is None:
            hit = any(
                n.alive and n.resources_total.covers(demand)
                for n in self.gcs.nodes.values()
            ) or any(r.covers(demand) for r in self.launchable)
            self._feasible_cache[key] = hit
        return hit

    def pick_node(
        self, demand: ResourceSet, strategy: Dict[str, Any]
    ) -> Optional[NodeEntry]:
        """Returns a node with available capacity, or None (queue it)."""
        stype = strategy.get("type", "default")
        if stype == "node_affinity":
            node = self.gcs.nodes.get(NodeID.from_hex(strategy["node_id"]))
            if (node and node.alive and node.conn is not None
                    and not node.draining
                    and node.resources_available.covers(demand)):
                return node
            if node and strategy.get("soft", False):
                pass  # fall through to default placement
            elif node:
                return None  # hard affinity: wait for that node
            # unknown node id with hard affinity -> handled by caller
        # no-fit fast path (default/spread only — node_affinity restricts
        # the candidate set and is a cheap single lookup anyway)
        key = tuple(sorted(demand._fp.items()))
        if self._nofit.get(key) == self._capacity_epoch:
            return None
        if stype == "spread":
            # least-utilized first (bucket-granular); the "full" bucket
            # still gets scanned last — a node can be max-utilized in one
            # resource yet cover a demand on another; SUSPECT nodes are
            # the last resort in every strategy (alive, but failure-
            # suspected: new work prefers healthy capacity)
            node = self._first_covering(demand, range(0, _FULL_BUCKET + 1))
            if node is None:
                node = self._first_covering(demand, (_SUSPECT_BUCKET,))
            if node is None:
                self._note_nofit(key)
            return node
        # default: hybrid binpack — prefer the most-utilized node that
        # still fits while below the spread threshold, so small tasks pack
        # and big clusters don't fragment (ray: hybrid_scheduling_policy.cc
        # in spirit); above-threshold nodes next, max-utilized, then
        # suspect nodes last
        thresh_b = min(
            int(cfg.sched_spread_threshold * _NBUCKETS), _NBUCKETS
        )
        node = self._first_covering(demand, range(thresh_b - 1, -1, -1))
        if node is None:
            node = self._first_covering(
                demand, range(_NBUCKETS - 1, thresh_b - 1, -1)
            )
        if node is None:
            node = self._first_covering(
                demand, (_FULL_BUCKET, _SUSPECT_BUCKET)
            )
        if node is None:
            self._note_nofit(key)
        return node

    def _note_nofit(self, key):
        if len(self._nofit) > 4096:
            self._nofit.clear()
        self._nofit[key] = self._capacity_epoch

    def _first_covering(self, demand, bucket_order):
        for b in bucket_order:
            for n in self._buckets[b].values():
                if n.resources_available.covers(demand):
                    return n
        return None


# --------------------------------------------------------------------------
# GCS server
# --------------------------------------------------------------------------


class CheckpointStore:
    """Debounced snapshot persistence for GCS fault tolerance.

    Role-equivalent of the reference's Redis/observability-backed
    StoreClient (ray: src/ray/gcs/store_client/store_client.h,
    redis_store_client.h): GCS tables are flushed to one pickle file
    (atomic tmp+rename) shortly after every mutation, and reloaded on
    restart so the cluster can re-attach instead of dying with the head.
    A single local file instead of Redis is deliberate: TPU pods mount a
    shared or local session dir, and the write set (control-plane tables,
    not objects) is small.
    """

    def __init__(self, path: str):
        self.path = path
        self._dirty = False
        self._flush_task: Optional[asyncio.Task] = None
        self._get_state: Optional[Any] = None  # set by the server
        self._wal_path = path + ".wal"
        self._wal_file = None

    def load(self) -> Optional[dict]:
        import pickle

        try:
            with open(self.path, "rb") as f:
                return pickle.load(f)
        except FileNotFoundError:
            return None
        except Exception:
            logger.exception("GCS checkpoint at %s unreadable; starting fresh",
                             self.path)
            return None

    def load_wal(self) -> list:
        """Records appended after the last snapshot, oldest first.  A torn
        final record (crash mid-append) ends the replay cleanly."""
        import pickle

        records = []
        try:
            with open(self._wal_path, "rb") as f:
                while True:
                    records.append(pickle.load(f))
        except FileNotFoundError:
            pass
        except Exception:
            pass  # EOF or torn tail — replay what we have
        return records

    def wal_append(self, record) -> None:
        """O(delta) durability for critical mutations: append one pickled
        record and flush to the OS (process-crash durable, like the
        reference's Redis write-before-ack) instead of rewriting the full
        snapshot inline with the RPC reply."""
        import pickle

        try:
            if self._wal_file is None:
                self._wal_file = open(self._wal_path, "ab")
            pickle.dump(record, self._wal_file, protocol=5)
            self._wal_file.flush()
        except Exception:
            logger.exception("GCS WAL append failed")

    def mark_dirty(self):
        self._dirty = True
        if self._flush_task is None or self._flush_task.done():
            self._flush_task = asyncio.get_running_loop().create_task(
                self._flush_soon()
            )

    async def _flush_soon(self):
        await asyncio.sleep(cfg.gcs_checkpoint_debounce_s)
        self.flush()

    def flush(self):
        import os
        import pickle

        if not self._dirty or self._get_state is None:
            return
        self._dirty = False
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                pickle.dump(self._get_state(), f, protocol=5)
            os.replace(tmp, self.path)
        except Exception:
            logger.exception("GCS checkpoint flush failed")
            return
        # the snapshot now covers everything the WAL recorded
        if self._wal_file is not None:
            try:
                self._wal_file.truncate(0)
                self._wal_file.seek(0)
            except Exception:
                logger.exception("GCS WAL truncate failed")
        else:
            try:
                os.unlink(self._wal_path)
            except FileNotFoundError:
                pass
            except Exception:
                pass


#: rpc methods that only mutate the high-churn object tables; their
#: checkpoint rides a separate, debounce-only file so critical control
#: flushes stay O(control-plane state)
_OBJECT_RPCS = frozenset({
    "add_object_location", "remove_object_location", "free_objects",
    "ref_edge", "ref_update", "add_spilled_location",
    "object_notify_batch",
})

#: rpc methods whose effects must survive an immediate crash: flushed
#: synchronously before the reply (the reference writes Redis before
#: acking — gcs_actor_manager.cc persistence-first pattern).  High-churn
#: mutations (object locations, refcounts) stay on the debounced path.
_CRITICAL_RPCS = frozenset({
    "register_actor", "actor_started", "actor_creation_failed",
    "kill_actor", "create_placement_group", "remove_placement_group",
    "register_node", "register_job", "kv_put", "kv_del",
})

#: rpc methods that never mutate durable GCS state (no checkpoint after
#: these; metrics are ephemeral by design)
_READONLY_RPCS = frozenset({
    "get_nodes", "cluster_resources", "kv_get", "kv_exists", "kv_keys",
    "get_object_locations", "get_actor", "list_actors", "heartbeat",
    "get_placement_group", "list_placement_groups",
    "wait_placement_group_ready", "ping", "subscribe", "unsubscribe",
    "get_drain_status",
    "get_autoscaler_state", "list_tasks", "list_objects",
    "metrics_push", "get_metrics", "get_job_info", "get_job_logs",
    "list_jobs", "list_events", "report_event", "get_worker_death_info",
    "cluster_store_stats", "dump_worker_stacks", "cancel_lease_requests",
    "dump_tasks", "publish", "chaos_partition", "chaos_heal",
    "node_health",
})


class GcsServer:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        session_dir: Optional[str] = None,
    ):
        self.server = rpc.Server(
            self._handle, host=host, port=port, on_close=self._conn_closed
        )
        self.checkpoint: Optional[CheckpointStore] = None
        self.checkpoint_objects: Optional[CheckpointStore] = None
        if session_dir:
            import os

            os.makedirs(session_dir, exist_ok=True)
            self.checkpoint = CheckpointStore(
                os.path.join(session_dir, "gcs_checkpoint.pkl")
            )
            self.checkpoint._get_state = self._snapshot_state
            self.checkpoint_objects = CheckpointStore(
                os.path.join(session_dir, "gcs_objects.pkl")
            )
            self.checkpoint_objects._get_state = self._snapshot_object_state
        self.nodes: Dict[NodeID, NodeEntry] = {}
        # health plane: per-node phi-accrual detectors (alive, attached
        # nodes only) and the monotonic incarnation counters (persisted
        # — fencing must survive a GCS restart, or a zombie could
        # re-enter through the reborn control plane)
        self.node_health: Dict[NodeID, PhiAccrualDetector] = {}
        self.node_incarnations: Dict[NodeID, int] = {}
        self.actors: Dict[ActorID, ActorEntry] = {}
        self.named_actors: Dict[Tuple[str, str], ActorID] = {}  # (ns, name)
        self.jobs: Dict[JobID, dict] = {}
        self.kv: Dict[str, bytes] = {}
        self.leases: Dict[int, LeaseEntry] = {}
        self._lease_ids = iter(range(1, 1 << 62))
        self.scheduler = Scheduler(self)
        # placement groups
        self.placement_groups: Dict[PlacementGroupID, PlacementGroupEntry] = {}
        self.named_pgs: Dict[Tuple[str, str], PlacementGroupID] = {}
        self._pending_pgs: List[PlacementGroupID] = []
        self._pg_state_waiters: Dict[PlacementGroupID, List[asyncio.Future]] = {}
        # object directory: object_id bytes -> {node_id}
        self.object_locations: Dict[bytes, Set[NodeID]] = {}
        self.object_sizes: Dict[bytes, int] = {}
        # objects spilled to a node's disk (the file outlives the arena
        # copy; reference role: object directory's spilled-URL field,
        # gcs_object_manager + local_object_manager.h:110)
        self.spilled_objects: Dict[bytes, NodeID] = {}
        # recently freed oids: a location announce racing the free (a
        # restore or pull finishing after delete_objects went out) must
        # not resurrect the object's directory entry.  Object ids are
        # never reused, so a bounded FIFO window is sufficient.
        self._freed_tombstones: "OrderedDict[bytes, None]" = OrderedDict()
        self._location_waiters: Dict[bytes, List[asyncio.Future]] = {}
        # distributed refcounting: object_id -> holder tokens (worker_id
        # bytes for processes, b"actor:<id>" for actor creation specs).
        # When a registered object's holder set empties, the object is
        # freed cluster-wide after a short grace (reference analogue: the
        # owner releasing its ReferenceCounter entry, reference_count.h:61)
        self.object_holders: Dict[bytes, Set[bytes]] = {}
        self.object_edges: Dict[bytes, List[bytes]] = {}  # parent -> children
        self._free_scheduled: Set[bytes] = set()
        # pubsub: channel -> set of conns
        self.subscribers: Dict[str, Set[rpc.Connection]] = {}
        # conn bookkeeping
        self._conn_leases: Dict[rpc.Connection, Set[int]] = {}
        self._conn_node: Dict[rpc.Connection, NodeID] = {}
        self._conn_job: Dict[rpc.Connection, JobID] = {}
        self._worker_conns: Dict[WorkerID, rpc.Connection] = {}
        self._worker_death_reasons: Dict[bytes, str] = {}
        # in-flight graceful drains: node_id -> asyncio.Task (strong refs;
        # the loop holds tasks weakly and a GC'd drain would silently stop)
        self._drain_tasks: Dict[NodeID, asyncio.Task] = {}
        # shielded drain-migration actor restarts (strong refs only: a
        # drain-deadline cancel orphans the shield inner, which must
        # keep running onto its surviving node)
        self._restart_tasks: Set[asyncio.Task] = set()
        self._events: List[dict] = []  # bounded structured event log
        self._health_task: Optional[asyncio.Task] = None
        self._start_time = time.time()
        # observability: reporter id -> latest metric snapshot
        self.metrics_by_reporter: Dict[str, dict] = {}
        # submitted driver jobs (job_submission.py): sub_id -> info
        self.submitted_jobs: Dict[str, dict] = {}
        self.session_dir = session_dir

    # ---- persistence ---------------------------------------------------
    def _mark_dirty(self):
        if self.checkpoint is not None:
            self.checkpoint.mark_dirty()

    def _mark_objects_dirty(self):
        if self.checkpoint_objects is not None:
            self.checkpoint_objects.mark_dirty()

    def _snapshot_state(self) -> dict:
        """Connection-free copy of every durable table."""
        actors = {}
        for aid, a in self.actors.items():
            c = copy.copy(a)
            c.creator_conn = None
            actors[aid] = c
        nodes = {
            nid: {
                "address": n.address,
                "resources": n.resources_total.to_dict(),
                "labels": n.labels,
                "incarnation": n.incarnation,
                # a restart must not silently re-admit a node the
                # provider is mid-way through terminating
                "draining": n.draining,
                "drain_reason": n.drain_reason,
                "drain_status": dict(n.drain_status)
                if n.drain_status else None,
            }
            for nid, n in self.nodes.items()
            if n.alive
        }
        return {
            "version": 1,
            "nodes": nodes,
            "node_incarnations": dict(self.node_incarnations),
            "actors": actors,
            "named_actors": dict(self.named_actors),
            "jobs": {j: dict(v) for j, v in self.jobs.items()},
            "kv": dict(self.kv),
            "placement_groups": {
                pid: copy.copy(pg) for pid, pg in self.placement_groups.items()
            },
            "named_pgs": dict(self.named_pgs),
            "submitted_jobs": {
                k: {kk: vv for kk, vv in v.items() if not kk.startswith("_")}
                for k, v in self.submitted_jobs.items()
            },
        }

    def _snapshot_object_state(self) -> dict:
        return {
            "object_locations": {
                k: set(v) for k, v in self.object_locations.items()
            },
            "object_sizes": dict(self.object_sizes),
            "object_holders": {
                k: set(v) for k, v in self.object_holders.items()
            },
            "object_edges": {k: list(v) for k, v in self.object_edges.items()},
            "spilled_objects": dict(self.spilled_objects),
        }

    def _restore_object_state(self, st: dict):
        self.object_locations.update(st["object_locations"])
        self.object_sizes.update(st["object_sizes"])
        self.object_holders.update(st["object_holders"])
        self.object_edges.update(st["object_edges"])
        self.spilled_objects.update(st.get("spilled_objects", {}))

    def _restore_state(self, st: dict):
        """Rebuild tables from a snapshot; connections re-attach lazily.

        Nodes come back as alive-with-no-conn entries: their raylets hold
        ReconnectingConnections and will re-register within the death
        timeout, re-applying placement-group bundle debits; ones that
        don't are reaped by the normal health loop.  ALIVE actors keep
        serving the whole time — actor calls ride direct client->worker
        connections that never touched the GCS.
        """
        now = time.monotonic()
        self.node_incarnations.update(st.get("node_incarnations", {}))
        for nid, n in st["nodes"].items():
            self.nodes[nid] = entry = NodeEntry(
                node_id=nid,
                address=n["address"],
                resources_total=ResourceSet(n["resources"]),
                resources_available=ResourceSet(n["resources"]),
                labels=n["labels"],
                conn=None,
                alive=True,
                incarnation=n.get("incarnation", 0),
                last_heartbeat=now,
            )
            if n.get("draining"):
                entry.drain_reason = n.get("drain_reason")
                entry.drain_status = n.get("drain_status")
                if entry.drain_status and entry.drain_status.get(
                    "state"
                ) == "draining":
                    # the drain task died with the old GCS: report it
                    # settled-as-failed (pollers must not wait forever)
                    # but keep the node excluded — the provider's kill
                    # is still coming and the hard-death path cleans up
                    entry.drain_status["state"] = "failed"
                    entry.drain_status["error"] = "GCS restarted mid-drain"
                entry.draining = True
            self.scheduler.index_node(entry)
        self.actors.update(st["actors"])
        self.named_actors.update(st["named_actors"])
        self.jobs.update(st["jobs"])
        self.kv.update(st["kv"])
        self.placement_groups.update(st["placement_groups"])
        self.named_pgs.update(st["named_pgs"])
        for k, v in st.get("submitted_jobs", {}).items():
            # a restart orphans the driver subprocess handle; a job still
            # marked RUNNING has unknown fate — report FAILED conservatively
            if v.get("status") == RUNNING_JOB:
                v = dict(v, status=FAILED_JOB,
                         end_time=v.get("end_time") or time.time())
            self.submitted_jobs[k] = v
        # A PENDING actor's creating client must re-drive creation itself
        # (its conn died with us); mid-restart actors get their restart
        # replayed once nodes have had a chance to re-register.  Leases
        # are NOT checkpointed and the lease-id counter restarts, so any
        # restored lease_id is stale — scrub it (a fresh synthetic lease
        # is attached when the hosting raylet re-registers).
        to_replay = []
        for a in self.actors.values():
            a.lease_id = None
            if a.state == ACTOR_PENDING:
                a.state = ACTOR_DEAD
                a.death_cause = "GCS restarted during creation"
            elif a.state == ACTOR_RESTARTING:
                to_replay.append(a)
        # Re-derive per-node available resources: nothing holds leases
        # across a restart, but CREATED placement groups keep their
        # bundle reservations (re-debited in rpc_register_node).
        for pg in self.placement_groups.values():
            if pg.state == PG_PENDING:
                self._pending_pgs.append(pg.pg_id)
        if to_replay:
            async def _replay():
                await asyncio.sleep(cfg.node_death_timeout_s)
                for a in to_replay:
                    if a.state == ACTOR_RESTARTING:
                        await self._restart_actor(a, "GCS restart replay")

            # keep a strong ref: the loop holds tasks weakly and a
            # GC'd task would silently drop the replay
            self._replay_task = asyncio.get_running_loop().create_task(
                _replay()
            )
        logger.info(
            "GCS state restored: %d nodes, %d actors, %d PGs, %d kv keys",
            len(self.nodes), len(self.actors),
            len(self.placement_groups), len(self.kv),
        )

    # ---- lifecycle -----------------------------------------------------
    async def start(self):
        if self.checkpoint is not None:
            st = self.checkpoint.load()
            wal = self.checkpoint.load_wal()
            if wal:
                if not st:
                    st = {
                        "version": 1, "nodes": {}, "actors": {},
                        "named_actors": {}, "jobs": {}, "kv": {},
                        "placement_groups": {}, "named_pgs": {},
                        "submitted_jobs": {},
                    }
                st = self._apply_wal(st, wal)
            if st:
                self._restore_state(st)
            if wal:
                # Compact immediately: a torn tail from the crash would
                # otherwise stay in the file, and records appended after
                # it would be unreachable by the next replay (load_wal
                # stops at the first bad record).
                self.checkpoint._dirty = True
                self.checkpoint.flush()
            ost = self.checkpoint_objects.load()
            if ost:
                self._restore_object_state(ost)
        await self.server.start()
        self._health_task = asyncio.get_running_loop().create_task(
            self._health_loop()
        )
        logger.info("GCS listening on %s", self.server.address)

    async def close(self):
        if self._health_task:
            self._health_task.cancel()
        if self.checkpoint is not None:
            self.checkpoint.flush()
        if self.checkpoint_objects is not None:
            self.checkpoint_objects.flush()
        await self.server.close()

    @property
    def address(self) -> str:
        return self.server.address

    # ---- dispatch ------------------------------------------------------
    async def _handle(self, conn: rpc.Connection, method: str, p: Any):
        fn = getattr(self, f"rpc_{method}", None)
        if fn is None:
            raise rpc.RpcError(f"GCS: unknown method {method!r}")
        result = await fn(conn, p)
        if method in _OBJECT_RPCS:
            if self.checkpoint_objects is not None:
                self.checkpoint_objects.mark_dirty()
        elif method not in _READONLY_RPCS:
            self._mark_dirty()
            if method in _CRITICAL_RPCS and self.checkpoint is not None:
                # O(delta) persistence before the ack: append just the
                # mutated rows to the WAL; the debounced snapshot
                # (cfg.gcs_checkpoint_debounce_s) compacts it.  Rewriting
                # the full snapshot inline here capped PG churn at ~150/s.
                for rec in self._wal_records(method, p):
                    self.checkpoint.wal_append(rec)
        return result

    def _wal_records(self, method: str, p: Any) -> list:
        """Snapshot-representation deltas for a critical mutation, applied
        over the loaded snapshot at restore (see start()).  Covers the
        primary row the ack promises durability for; cascaded effects on
        other tables ride the debounced snapshot like everything else."""
        recs = []
        if method in ("create_placement_group", "remove_placement_group"):
            pid = PlacementGroupID(p["pg_id"])
            pg = self.placement_groups.get(pid)
            if pg is not None:
                recs.append(("put", "placement_groups", pid, copy.copy(pg)))
                if pg.name:
                    key = (pg.namespace, pg.name)
                    if self.named_pgs.get(key) == pid:
                        recs.append(("put", "named_pgs", key, pid))
                    else:
                        recs.append(("del", "named_pgs", key))
        elif method in ("register_actor", "actor_started",
                        "actor_creation_failed", "kill_actor"):
            aid = ActorID(p["actor_id"])
            actor = self.actors.get(aid)
            if actor is not None:
                c = copy.copy(actor)
                c.creator_conn = None
                recs.append(("put", "actors", aid, c))
                if actor.name:
                    key = (actor.namespace, actor.name)
                    if self.named_actors.get(key) == aid:
                        recs.append(("put", "named_actors", key, aid))
                    else:
                        recs.append(("del", "named_actors", key))
        elif method == "register_node":
            nid = NodeID(p["node_id"])
            n = self.nodes.get(nid)
            if n is not None and n.alive:
                recs.append(("put", "nodes", nid, {
                    "address": n.address,
                    "resources": n.resources_total.to_dict(),
                    "labels": n.labels,
                    "incarnation": n.incarnation,
                }))
                # the fencing token must be crash-durable with the ack:
                # a restarted GCS re-admitting a zombie at its old
                # incarnation would re-open the split-brain window
                recs.append((
                    "put", "node_incarnations", nid,
                    self.node_incarnations.get(nid, n.incarnation),
                ))
        elif method == "register_job":
            # a fresh registration has no job_id in the payload (the GCS
            # generates one); its row rides the debounced snapshot and the
            # driver re-registers on reconnect anyway
            if p.get("job_id"):
                jid = JobID(p["job_id"])
                j = self.jobs.get(jid)
                if j is not None:
                    recs.append(("put", "jobs", jid, dict(j)))
        elif method == "kv_put":
            recs.append(("put", "kv", p["key"], self.kv.get(p["key"])))
        elif method == "kv_del":
            recs.append(("del", "kv", p["key"]))
        return recs

    @staticmethod
    def _apply_wal(snap: dict, records: list) -> dict:
        for rec in records:
            try:
                if rec[0] == "put":
                    _, table, key, value = rec
                    snap.setdefault(table, {})[key] = value
                elif rec[0] == "del":
                    _, table, key = rec
                    snap.setdefault(table, {}).pop(key, None)
            except Exception:
                logger.exception("bad WAL record skipped: %r", rec[:2])
        return snap

    def _conn_closed(self, conn: rpc.Connection):
        loop = asyncio.get_event_loop()
        loop.create_task(self._cleanup_conn(conn))

    async def _cleanup_conn(self, conn: rpc.Connection):
        # Release leases held by a disconnected submitter.  kick=False +
        # one kick at the end: a dead driver can hold tens of thousands
        # of leases (scale tests hold 32k), and a kick per release is
        # O(leases × kick) of synchronous event-loop work that starves
        # every other RPC for minutes.
        held = list(self._conn_leases.pop(conn, ()))
        for lease_id in held:
            await self._release_lease(lease_id, kick=False)
        if held:
            self._kick_pending()
        # node connection lost -> node death, unless the raylet already
        # re-registered over a NEWER connection (half-open TCP: the stale
        # server-side socket can outlive the replacement)
        node_id = self._conn_node.pop(conn, None)
        if node_id is not None:
            node = self.nodes.get(node_id)
            if node is None or node.conn is conn or node.conn is None:
                await self._on_node_death(node_id, "raylet connection lost")
        job_id = self._conn_job.pop(conn, None)
        if job_id is not None and job_id not in self._conn_job.values():
            await self._on_job_finished(job_id)
        # orphaned creations: a PENDING actor whose creating client is gone
        # will never receive actor_started — fail it now
        for actor in list(self.actors.values()):
            if actor.state == ACTOR_PENDING and actor.creator_conn is conn:
                await self._kill_actor(
                    actor, "creating client disconnected", no_restart=True
                )
        for wid, c in list(self._worker_conns.items()):
            if c is conn:
                del self._worker_conns[wid]
                self._scrub_holder(wid.binary())
        for subs in self.subscribers.values():
            subs.discard(conn)

    # ---- health --------------------------------------------------------
    #
    # Adaptive failure detection (reference role: GcsHealthCheckManager,
    # gcs_health_check_manager.h, upgraded from fixed-timeout to
    # phi-accrual — common/health.py).  Verdicts per alive node:
    #
    #   phi >= health_phi_suspect  -> SUSPECT: parked in the scheduler's
    #       last-resort bucket, deprioritized for pulls and serve
    #       routing; NOTHING killed/reformed/restarted.  Cleared by the
    #       next heartbeat.
    #   phi >= health_phi_death AND silence >= floor -> confirmed DEAD
    #       (floor = health_death_floor_frac x node_death_timeout_s: a
    #       whole-process stall must not mass-kill fast-heartbeat nodes)
    #   silence > node_death_timeout_s -> DEAD regardless of phi (hard
    #       cap: adaptive detection never detects SLOWER than the old
    #       fixed detector)
    #
    # Nodes without enough history (or restored without a conn) keep the
    # fixed-timeout behavior.
    async def _health_loop(self):
        while True:
            await asyncio.sleep(cfg.heartbeat_interval_s)
            # reap finished driver subprocesses even when nobody polls
            # (zombies otherwise; and the checkpoint must not persist a
            # finished job as RUNNING)
            try:
                self._poll_submitted_jobs()
            except Exception:
                pass
            now = time.monotonic()
            death_floor = (
                cfg.node_death_timeout_s * cfg.health_death_floor_frac
            )
            for node in list(self.nodes.values()):
                if not node.alive:
                    continue
                elapsed = now - node.last_heartbeat
                det = self.node_health.get(node.node_id)
                if det is None or not det.ready() or node.conn is None:
                    if elapsed > cfg.node_death_timeout_s:
                        await self._on_node_death(
                            node.node_id, "heartbeat timeout"
                        )
                    continue
                phi = det.phi(now)
                if death_confirmed(phi, elapsed, cfg.health_phi_death,
                                   death_floor, cfg.node_death_timeout_s):
                    await self._on_node_death(
                        node.node_id,
                        f"failure detector confirmed death "
                        f"(phi={phi:.1f}, silent {elapsed:.2f}s)",
                    )
                elif is_suspect(phi, cfg.health_phi_suspect) and not node.suspect:
                    node.suspect = True  # re-buckets to last-resort
                    self.record_cluster_event(
                        "WARNING", "gcs",
                        f"node suspected (phi={phi:.1f}, silent "
                        f"{elapsed:.2f}s): deprioritized, not killed",
                        node_id=node.node_id.hex(),
                    )
                    await self.publish("nodes", {
                        "event": "suspect",
                        "node_id": node.node_id.hex(),
                        "incarnation": node.incarnation,
                        "phi": phi,
                    })
            # Compact cancelled/abandoned pending-lease entries: kicks
            # drop them lazily, but kicks are event-driven — a saturated
            # cluster with clients re-requesting on LEASE_PENDING every
            # 60 s would otherwise accumulate dead entries without bound.
            pending = self.scheduler.pending
            if any(e.fut.done() or e.client_conn.closed for e in pending):
                keep: deque = deque()
                for e in pending:
                    if e.fut.done():
                        continue
                    if e.client_conn.closed:
                        e.fut.cancel()
                        continue
                    keep.append(e)
                self.scheduler.pending = keep

    async def _on_node_death(self, node_id: NodeID, reason: str):
        self._mark_dirty()
        node = self.nodes.get(node_id)
        if not node or not node.alive:
            return
        node.alive = False
        node.suspect = False  # parked now; suspicion is moot
        # fence the dead life: bump the incarnation counter PAST the
        # node's, so every RPC the old life may still send (a healed
        # partition, a zombie raylet) is rejected with FencedError
        self.node_incarnations[node_id] = max(
            self.node_incarnations.get(node_id, 0), node.incarnation
        ) + 1
        self.node_health.pop(node_id, None)
        if self.checkpoint is not None:
            self.checkpoint.flush()
        # a drain in flight for this node is moot now (the failure path
        # pops itself before calling here, so this never self-cancels)
        drain_task = self._drain_tasks.pop(node_id, None)
        if drain_task is not None:
            drain_task.cancel()
        if node.drain_status is not None and node.drain_status.get(
            "state"
        ) == "draining":
            node.drain_status["state"] = "dead"
        logger.warning("node %s died: %s", node_id, reason)
        self.record_cluster_event(
            "ERROR", "gcs", f"node died: {reason}",
            node_id=node_id.hex(),
        )
        # drop object locations on that node
        for oid, locs in list(self.object_locations.items()):
            locs.discard(node_id)
            if not locs:
                del self.object_locations[oid]
        # break leases on that node — kick=False + one kick after: a
        # dense node (fractional-CPU actors) can hold thousands of
        # leases, and a kick per release is the same O(leases × kick)
        # event-loop starvation _cleanup_conn's batching eliminates
        broke = 0
        for lease_id, lease in list(self.leases.items()):
            if lease.node_id == node_id:
                await self._release_lease(lease_id, broken=True, kick=False)
                broke += 1
        if broke:
            self._kick_pending()
        # restart/kill actors that lived there
        for actor in list(self.actors.values()):
            if actor.node_id == node_id and actor.state in (
                ACTOR_ALIVE,
                ACTOR_PENDING,
            ):
                await self._maybe_restart_actor(actor, f"node died: {reason}")
        # reschedule placement-group bundles that lived there
        for pg in list(self.placement_groups.values()):
            if pg.state not in (PG_CREATED, PG_RESCHEDULING):
                continue
            lost = [
                i for i, nid in enumerate(pg.bundle_nodes) if nid == node_id
            ]
            if not lost:
                continue
            for i in lost:
                pg.bundle_nodes[i] = None
                pg.bundle_available[i] = ResourceSet()
            pg.state = PG_RESCHEDULING
            if pg.pg_id not in self._pending_pgs:
                self._pending_pgs.append(pg.pg_id)
            await self.publish(
                "placement_groups",
                {"event": "rescheduling", "pg_id": pg.pg_id.hex()},
            )
        await self.publish("nodes", {
            "event": "dead",
            "node_id": node_id.hex(),
            # the NEW (fenced-to) incarnation: peers raise their
            # watermark past the dead life's token
            "incarnation": self.node_incarnations[node_id],
        })
        self._kick_pending()

    async def _on_job_finished(self, job_id: JobID):
        self.jobs.get(job_id, {}).update(state="FINISHED")
        # kill non-detached actors owned by the job
        for actor in list(self.actors.values()):
            if actor.owner_job == job_id and not actor.detached:
                await self._kill_actor(actor, "owner job finished", no_restart=True)
        # remove non-detached placement groups owned by the job
        for pg in list(self.placement_groups.values()):
            if pg.owner_job == job_id and not pg.detached and pg.state != PG_REMOVED:
                await self._remove_pg(pg)
        await self.publish("jobs", {"event": "finished", "job_id": job_id.hex()})

    # ---- pubsub --------------------------------------------------------
    async def publish(self, channel: str, message: dict):
        for conn in list(self.subscribers.get(channel, ())):
            try:
                await conn.notify("publish", {"channel": channel, "message": message})
            except Exception:
                pass

    async def rpc_publish(self, conn, p):
        """Client-initiated publish (worker log streaming rides this;
        reference role: log_monitor -> GCS pubsub -> driver print_logs,
        python/ray/_private/log_monitor.py:103)."""
        await self.publish(p["channel"], p["message"])
        return True

    async def rpc_subscribe(self, conn, p):
        self.subscribers.setdefault(p["channel"], set()).add(conn)
        return True

    async def rpc_unsubscribe(self, conn, p):
        self.subscribers.get(p["channel"], set()).discard(conn)
        return True

    # ---- nodes ---------------------------------------------------------
    def _check_node_fence(self, node_id: NodeID, inc) -> None:
        """Reject an RPC carrying a stale node incarnation.  ``inc`` is
        the sender's claimed incarnation (None = legacy/fresh caller:
        no check).  The raised FencedError reaches the zombie raylet as
        a RemoteCallError and triggers its self-fence (kill workers,
        discard object copies, re-register fresh)."""
        if inc is None:
            return
        cur = self.node_incarnations.get(node_id, 0)
        if inc < cur:
            raise FencedError(
                f"node {node_id.hex()[:12]} incarnation {inc} is stale "
                f"(current {cur}): the node was declared dead — fence "
                f"yourself (kill workers, discard objects) and "
                f"re-register fresh"
            )

    async def rpc_register_node(self, conn, p):
        node_id = NodeID(p["node_id"])
        # incarnation assignment: a fresh registration (no claimed
        # incarnation) always starts a NEW life; a reconnect claiming
        # the CURRENT incarnation keeps its life (transient conn loss /
        # GCS restart — its object copies and leases are still valid);
        # a stale claim is fenced — the raylet must purge before
        # re-joining (closing the healed-partition split brain)
        prev_inc = p.get("incarnation")
        cur = self.node_incarnations.get(node_id, 0)
        prev_entry = self.nodes.get(node_id)
        if prev_inc is not None:
            self._check_node_fence(node_id, prev_inc)
            if prev_entry is not None and not prev_entry.alive:
                # counter bump lost (pre-fencing snapshot): still treat
                # a re-registration from a declared-dead life as fenced
                raise FencedError(
                    f"node {node_id.hex()[:12]} was declared dead; "
                    f"purge and re-register fresh"
                )
            inc = max(prev_inc, cur)
        else:
            inc = cur + 1
        self.node_incarnations[node_id] = inc
        entry = NodeEntry(
            node_id=node_id,
            address=p["address"],
            resources_total=ResourceSet(p["resources"]),
            resources_available=ResourceSet(p["resources"]),
            labels=p.get("labels", {}),
            conn=conn,
            incarnation=inc,
        )
        # Re-registration (GCS restarted, raylet re-attaching): the fresh
        # available pool must re-absorb reservations that survive a
        # restart — CREATED/RESCHEDULING placement-group bundles placed on
        # this node, and the resources of restored ALIVE actors still
        # running here.  (Plain task leases die with the GCS; their
        # workers are reclaimed by the raylet's idle reaper.)
        for pg in self.placement_groups.values():
            if pg.state == PG_REMOVED:
                continue
            for bi, bnode in enumerate(pg.bundle_nodes):
                if bnode == node_id:
                    entry.resources_available = (
                        entry.resources_available.subtract(pg.bundles[bi])
                    )
        # transient reconnect (GCS never restarted): live leases on this
        # node are still tracked and their debits must carry over — bundle
        # draws (pg_ref) live inside bundle_available and must not debit
        # the node pool twice
        for lease in self.leases.values():
            if lease.node_id == node_id and lease.pg_ref is None:
                entry.resources_available = (
                    entry.resources_available.subtract(lease.resources)
                )
        for actor in self.actors.values():
            if (
                actor.state in (ACTOR_ALIVE, ACTOR_RESTARTING)
                and actor.node_id == node_id
                and actor.lease_id is None
            ):
                # synthesize the lease the old GCS held, so the actor's
                # capacity is debited now and refunded on its death
                lease_id = next(self._lease_ids)
                sched = actor.scheduling or {}
                pg_ref = None
                if sched.get("type") == "placement_group":
                    pgid = PlacementGroupID.from_hex(sched["pg_id"])
                    pg = self.placement_groups.get(pgid)
                    if pg is not None:
                        bi = sched.get("bundle_index", -1)
                        if bi is None or bi < 0:
                            bi = next(
                                (
                                    i
                                    for i, bn in enumerate(pg.bundle_nodes)
                                    if bn == node_id
                                ),
                                None,
                            )
                        if bi is not None:
                            pg_ref = (pgid, bi)
                res = ResourceSet(actor.resources)
                if pg_ref is None:
                    # bundle draws persisted inside bundle_available; only
                    # non-PG actors debit the node pool directly
                    entry.resources_available = (
                        entry.resources_available.subtract(res)
                    )
                self.leases[lease_id] = LeaseEntry(
                    lease_id=lease_id,
                    node_id=node_id,
                    worker_id=WorkerID.nil(),
                    worker_addr=actor.worker_addr or "",
                    resources=res,
                    client_conn=_GCS_SELF_CONN,
                    actor_id=actor.actor_id,
                    pg_ref=pg_ref,
                )
                actor.lease_id = lease_id
        # drop a stale conn mapping from a previous connection so its
        # eventual close is not mistaken for a node death
        for old_conn, nid in list(self._conn_node.items()):
            if nid == node_id and old_conn is not conn:
                del self._conn_node[old_conn]
        # a raylet reconnecting mid-drain must come back DRAINING: the
        # fresh entry would otherwise silently re-admit a node the
        # provider is about to terminate
        prev = self.nodes.get(node_id)
        if prev is not None and prev.draining:
            entry.drain_reason = prev.drain_reason
            entry.drain_status = prev.drain_status
            entry.draining = True
        self.nodes[node_id] = entry
        self.scheduler.index_node(entry)
        self._conn_node[conn] = node_id
        # label the conn for the partition plane + start a fresh
        # inter-heartbeat history (stale stats from the previous life
        # would poison the adaptive detector's first verdicts)
        conn.peer_endpoint = node_id.hex()
        self.node_health[node_id] = PhiAccrualDetector(
            window=cfg.health_window,
            min_std_frac=cfg.health_min_std_frac,
            min_samples=cfg.health_min_samples,
        )
        await self.publish(
            "nodes",
            {
                # a reconnecting mid-drain node must not announce "alive"
                # — subscribers (the serve controller's draining-node set)
                # would un-track it and route traffic back onto a node
                # the provider is about to terminate
                "event": "draining" if entry.draining else "alive",
                "node_id": node_id.hex(),
                "address": p["address"],
                "incarnation": inc,
            },
        )
        logger.info(
            "node %s registered: %s %s (incarnation %d)",
            node_id, p["address"], entry.resources_total, inc,
        )
        self._kick_pending()
        return {"gcs_time": time.time(), "incarnation": inc}

    async def rpc_heartbeat(self, conn, p):
        node_id = NodeID(p["node_id"])
        # fencing: a zombie's heartbeat is the rendezvous where it
        # LEARNS it was declared dead (the heal-side of a partition)
        self._check_node_fence(node_id, p.get("incarnation"))
        node = self.nodes.get(node_id)
        if node:
            now = time.monotonic()
            node.last_heartbeat = now
            det = self.node_health.get(node_id)
            if det is not None:
                det.heartbeat(now)
            if node.suspect:
                node.suspect = False  # un-parks in the scheduler index
                self.record_cluster_event(
                    "INFO", "gcs", "suspected node recovered",
                    node_id=node_id.hex(),
                )
                await self.publish("nodes", {
                    "event": "recovered",
                    "node_id": node_id.hex(),
                    "incarnation": node.incarnation,
                })
                self._kick_pending()
        return True

    async def rpc_get_nodes(self, conn, p):
        return [
            {
                "node_id": n.node_id.hex(),
                "address": n.address,
                # a restored-but-unattached node is not usable yet
                "alive": n.alive and n.conn is not None,
                "suspect": n.suspect,
                "incarnation": n.incarnation,
                "draining": n.draining,
                "resources_total": n.resources_total.to_dict(),
                "resources_available": n.resources_available.to_dict(),
                "labels": n.labels,
            }
            for n in self.nodes.values()
        ]

    async def rpc_cluster_resources(self, conn, p):
        total: ResourceSet = ResourceSet()
        avail: ResourceSet = ResourceSet()
        for n in self.nodes.values():
            if n.alive:
                total = total.add(n.resources_total)
                avail = avail.add(n.resources_available)
        return {"total": total.to_dict(), "available": avail.to_dict()}

    # ---- jobs ----------------------------------------------------------
    async def rpc_register_job(self, conn, p):
        if p.get("job_id"):
            # driver re-attaching after a GCS restart keeps its identity so
            # actor/object ownership and namespaces stay coherent
            job_id = JobID(p["job_id"])
            entry = self.jobs.get(job_id) or {"start_time": time.time()}
            entry.update({"state": "RUNNING", "driver_pid": p.get("pid")})
            self.jobs[job_id] = entry
        else:
            job_id = JobID.random()
            self.jobs[job_id] = {
                "state": "RUNNING",
                "start_time": time.time(),
                "driver_pid": p.get("pid"),
            }
        self._conn_job[conn] = job_id
        return {"job_id": job_id.binary()}

    # ---- workers (register their duplex conns for GCS-initiated pushes)
    async def rpc_dump_worker_stacks(self, conn, p):
        """Per-thread Python stacks of a live worker (reference role:
        dashboard py-spy profiling, reporter/profile_manager.py:83)."""
        wid = WorkerID(p["worker_id"])
        wconn = self._worker_conns.get(wid)
        if wconn is None or wconn.closed:
            raise rpc.RpcError(f"worker {wid.hex()[:12]} not connected")
        return await asyncio.wait_for(
            wconn.call("dump_stacks", {}), timeout=15.0
        )

    async def rpc_register_worker(self, conn, p):
        self._worker_conns[WorkerID(p["worker_id"])] = conn
        # workers/drivers share their node's fate under a partition:
        # label the conn so the link-cut site can match it
        if p.get("node_id"):
            conn.peer_endpoint = p["node_id"]
        return True

    # ---- chaos (network-partition installs; see common/faults.py) ------
    async def rpc_chaos_partition(self, conn, p):
        from ray_tpu_torch.common import faults

        faults.cut_link(p["src"], p["dst"], p.get("duration_s"))
        return True

    async def rpc_chaos_heal(self, conn, p):
        from ray_tpu_torch.common import faults

        faults.heal_link(p.get("src"), p.get("dst"))
        return True

    # ---- kv ------------------------------------------------------------
    async def rpc_kv_put(self, conn, p):
        key = p["key"]
        if p.get("overwrite", True) or key not in self.kv:
            self.kv[key] = p["value"]
            return True
        return False

    async def rpc_kv_get(self, conn, p):
        return self.kv.get(p["key"])

    async def rpc_kv_del(self, conn, p):
        return self.kv.pop(p["key"], None) is not None

    async def rpc_kv_exists(self, conn, p):
        return p["key"] in self.kv

    async def rpc_kv_keys(self, conn, p):
        prefix = p.get("prefix", "")
        return [k for k in self.kv if k.startswith(prefix)]

    # ---- object directory ---------------------------------------------
    async def rpc_add_object_location(self, conn, p):
        oid = p["object_id"]
        # a zombie raylet's announce must not re-enter the directory:
        # its arena is about to be (or was) discarded by the fence
        self._check_node_fence(NodeID(p["node_id"]), p.get("incarnation"))
        if oid in self._freed_tombstones:
            return False  # announce raced the free; do not resurrect
        self.object_locations.setdefault(oid, set()).add(NodeID(p["node_id"]))
        if "size" in p:
            self.object_sizes[oid] = p["size"]
        for fut in self._location_waiters.pop(oid, ()):
            if not fut.done():
                fut.set_result(True)
        return True

    async def rpc_add_spilled_location(self, conn, p):
        oid = p["object_id"]
        self._check_node_fence(NodeID(p["node_id"]), p.get("incarnation"))
        # A spill can race the object's free: the raylet picked the victim
        # before delete_objects arrived.  Registering a spilled location
        # for a freed object would orphan the file forever — refuse, and
        # the raylet keeps its arena copy (the pending delete reclaims it).
        if oid in self._freed_tombstones or (
            not self.object_holders.get(oid)
            and oid not in self.object_locations
        ):
            return {"ok": False}
        self.spilled_objects[oid] = NodeID(p["node_id"])
        if "size" in p:
            self.object_sizes[oid] = p["size"]
        for fut in self._location_waiters.pop(oid, ()):
            if not fut.done():
                fut.set_result(True)
        return {"ok": True}

    async def rpc_remove_object_location(self, conn, p):
        oid = p["object_id"]
        locs = self.object_locations.get(oid)
        if locs:
            locs.discard(NodeID(p["node_id"]))
            if not locs:
                del self.object_locations[oid]
        return True

    async def rpc_get_object_locations(self, conn, p):
        oid = p["object_id"]
        timeout = p.get("timeout", 0)
        locs = self.object_locations.get(oid)
        if not locs and oid not in self.spilled_objects and timeout:
            fut = asyncio.get_running_loop().create_future()
            self._location_waiters.setdefault(oid, []).append(fut)
            try:
                await asyncio.wait_for(fut, timeout=timeout)
            except asyncio.TimeoutError:
                pass
            locs = self.object_locations.get(oid)
        out = []
        for nid in locs or ():
            node = self.nodes.get(nid)
            if node and node.alive:
                # pullers prefer non-suspect copies: a stalled/partition-
                # suspected node would cost a full pull timeout per try
                out.append({
                    "node_id": nid.hex(),
                    "address": node.address,
                    "suspect": node.suspect,
                })
        spilled = None
        snid = self.spilled_objects.get(oid)
        if snid is not None:
            node = self.nodes.get(snid)
            if node and node.alive:
                spilled = {"node_id": snid.hex(), "address": node.address}
        return {
            "locations": out,
            "size": self.object_sizes.get(oid),
            "spilled": spilled,
        }

    async def rpc_free_objects(self, conn, p):
        for oid in p["object_ids"]:
            await self._free_object(oid)
        return True

    #: sub-methods a client may batch into one object_notify_batch rpc —
    #: the flush-window transport for high-churn object bookkeeping
    _BATCHABLE_OBJECT_RPCS = frozenset({
        "add_object_location", "remove_object_location", "free_objects",
        "ref_edge", "ref_update",
    })

    async def rpc_object_notify_batch(self, conn, p):
        """Apply a client's buffered object-directory notifies in arrival
        order (one rpc per flush window instead of one per task/object).
        Order matters: e.g. an add_object_location buffered before a
        free_objects must land first so the free's node fan-out sees the
        location."""
        for method, payload in p["items"]:
            if method not in self._BATCHABLE_OBJECT_RPCS:
                raise rpc.RpcError(
                    f"non-batchable method {method!r} in object_notify_batch"
                )
            await getattr(self, f"rpc_{method}")(conn, payload)
        return True

    async def _free_object(self, oid: bytes):
        self._mark_objects_dirty()
        self._freed_tombstones[oid] = None
        while len(self._freed_tombstones) > 10_000:
            self._freed_tombstones.popitem(last=False)
        locs = self.object_locations.pop(oid, set())
        self.object_sizes.pop(oid, None)
        self.object_holders.pop(oid, None)
        spilled_nid = self.spilled_objects.pop(oid, None)
        if spilled_nid is not None:
            locs = set(locs)
            locs.add(spilled_nid)  # its raylet also removes the spill file
        for nid in locs:
            node = self.nodes.get(nid)
            if node and node.alive:
                try:
                    await node.conn.notify(
                        "delete_objects", {"object_ids": [oid]}
                    )
                except Exception:
                    pass
        # a freed parent releases its nested (borrowed) children
        token = b"obj:" + oid
        for child in self.object_edges.pop(oid, ()):
            s = self.object_holders.get(child)
            if s is not None:
                s.discard(token)
                if not s:
                    self._schedule_free(child)

    async def rpc_ref_edge(self, conn, p):
        """A stored object contains serialized refs to children: pin the
        children for as long as the parent object exists."""
        parent = p["parent"]
        token = b"obj:" + parent
        kids = self.object_edges.setdefault(parent, [])
        for child in p.get("children", ()):
            if child not in kids:
                kids.append(child)
                self.object_holders.setdefault(child, set()).add(token)
        return True

    # ---- distributed refcounting ---------------------------------------
    async def rpc_ref_update(self, conn, p):
        holder = p["holder"]
        for oid in p.get("add", ()):
            self.object_holders.setdefault(oid, set()).add(holder)
        for oid in p.get("del", ()):
            s = self.object_holders.get(oid)
            if s is not None:
                s.discard(holder)
                if not s:
                    self._schedule_free(oid)
        return True

    def _schedule_free(self, oid: bytes):
        """Free after a grace window, re-checking holders — an in-flight
        ref_add from a borrower that deserialized the ref moments ago must
        win over a racing release."""
        if oid in self._free_scheduled:
            return
        self._free_scheduled.add(oid)

        def _maybe_free():
            self._free_scheduled.discard(oid)
            s = self.object_holders.get(oid)
            if s is not None and not s:
                asyncio.get_event_loop().create_task(self._free_object(oid))

        asyncio.get_event_loop().call_later(cfg.gcs_free_delay_s, _maybe_free)

    def _scrub_holder(self, holder: bytes):
        """A process died: remove it from every holder set."""
        self._mark_objects_dirty()
        for oid, s in list(self.object_holders.items()):
            if holder in s:
                s.discard(holder)
                if not s:
                    self._schedule_free(oid)

    # ---- placement groups ----------------------------------------------
    def _bundle_order(self, pg: PlacementGroupEntry, indices: List[int]) -> List[int]:
        """Place big bundles first (first-fit-decreasing)."""
        return sorted(
            indices,
            key=lambda i: -sum(pg.bundles[i]._fp.values()),
        )

    def _place_bundles(
        self, pg: PlacementGroupEntry, include_suspect: bool = False
    ) -> Optional[Dict[int, NodeID]]:
        """Choose a node for every unplaced bundle, or None if impossible now.

        Works against a scratch copy of availability so the decision is
        atomic: either every missing bundle fits, or nothing is reserved.
        (The reference does this with a 2-phase prepare/commit across
        raylets — bundle_scheduling_policy.cc; here one atomic pass.)
        Suspect nodes are excluded unless ``include_suspect`` — the
        caller retries with them only when healthy capacity can't place
        the gang (a transient stall must not block PG creation, but it
        must not attract fresh gangs either).
        """
        alive = {
            n.node_id: n
            for n in self.nodes.values()
            if n.alive and n.conn is not None and not n.draining
            and (include_suspect or not n.suspect)
        }
        avail = {nid: n.resources_available for nid, n in alive.items()}
        missing = [i for i in range(len(pg.bundles)) if pg.bundle_nodes[i] is None]
        used: Set[NodeID] = {nid for nid in pg.bundle_nodes if nid is not None}
        assignment: Dict[int, NodeID] = {}

        def util(nid: NodeID) -> float:
            return avail[nid].utilization(alive[nid].resources_total)

        if pg.strategy == "STRICT_PACK":
            total = ResourceSet()
            for b in pg.bundles:
                total = total.add(b)
            cands = [nid for nid, a in avail.items() if a.covers(total)]
            if not cands:
                return None
            nid = max(cands, key=util)  # binpack: densest feasible node
            return {i: nid for i in missing}

        for i in self._bundle_order(pg, missing):
            b = pg.bundles[i]
            feas = [nid for nid, a in avail.items() if a.covers(b)]
            fresh = [nid for nid in feas if nid not in used]
            if pg.strategy == "STRICT_SPREAD":
                if not fresh:
                    return None
                nid = min(fresh, key=util)  # emptiest distinct node
            elif pg.strategy == "SPREAD":
                pool = fresh or feas
                if not pool:
                    return None
                nid = min(pool, key=util)
            else:  # PACK: fewest nodes — prefer nodes this pg already uses
                pool = [nid for nid in feas if nid in used] or feas
                if not pool:
                    return None
                nid = max(pool, key=util)
            assignment[i] = nid
            avail[nid] = avail[nid].subtract(b)
            used.add(nid)
        return assignment

    def _try_place_pg(self, pg: PlacementGroupEntry) -> bool:
        assignment = self._place_bundles(pg)
        if assignment is None and any(
            n.suspect and n.alive and n.conn is not None and not n.draining
            for n in self.nodes.values()
        ):
            # healthy capacity can't place the gang: fall back to
            # suspect nodes rather than park the PG behind a stall
            assignment = self._place_bundles(pg, include_suspect=True)
        if assignment is None:
            return False
        for i, nid in assignment.items():
            node = self.nodes[nid]
            node.resources_available = node.resources_available.subtract(
                pg.bundles[i]
            )
            pg.bundle_nodes[i] = nid
            pg.bundle_available[i] = pg.bundles[i]
        pg.state = PG_CREATED
        self._wake_pg_waiters(pg.pg_id)
        return True

    def _wake_pg_waiters(self, pg_id: PlacementGroupID):
        for fut in self._pg_state_waiters.pop(pg_id, ()):
            if not fut.done():
                fut.set_result(True)

    async def _pg_state_wait(self, pg_id: PlacementGroupID, timeout: float) -> bool:
        fut = asyncio.get_running_loop().create_future()
        self._pg_state_waiters.setdefault(pg_id, []).append(fut)
        try:
            await asyncio.wait_for(fut, timeout=timeout)
            return True
        except asyncio.TimeoutError:
            return False

    async def rpc_create_placement_group(self, conn, p):
        pg_id = PlacementGroupID(p["pg_id"])
        existing = self.placement_groups.get(pg_id)
        if existing is not None and existing.state != PG_REMOVED:
            # retry of a create that already landed (checkpoint flushed,
            # GCS crashed before the reply) — idempotent success
            return {"state": existing.state}
        strategy = p.get("strategy", "PACK")
        if strategy not in PG_STRATEGIES:
            raise rpc.RpcError(f"unknown placement strategy {strategy!r}")
        bundles = [ResourceSet(b) for b in p["bundles"]]
        if not bundles or any(b.is_empty() for b in bundles):
            raise rpc.RpcError("placement group bundles must be non-empty")
        name = p.get("name") or None
        ns = p.get("namespace", "default")
        if name:
            key = (ns, name)
            if key in self.named_pgs:
                existing = self.placement_groups.get(self.named_pgs[key])
                if existing and existing.state != PG_REMOVED:
                    raise rpc.RpcError(f"placement group name {name!r} already taken")
            self.named_pgs[key] = pg_id
        pg = PlacementGroupEntry(
            pg_id=pg_id,
            name=name,
            strategy=strategy,
            bundles=bundles,
            state=PG_PENDING,
            owner_job=JobID(p["job_id"]) if p.get("job_id") else None,
            detached=p.get("detached", False),
            bundle_nodes=[None] * len(bundles),
            bundle_available=[ResourceSet() for _ in bundles],
            namespace=ns,
        )
        self.placement_groups[pg_id] = pg
        if not self._try_place_pg(pg):
            self._pending_pgs.append(pg_id)
        await self.publish(
            "placement_groups", {"event": "created", "pg_id": pg_id.hex()}
        )
        return {"state": pg.state}

    async def rpc_wait_placement_group_ready(self, conn, p):
        pg = self.placement_groups.get(PlacementGroupID(p["pg_id"]))
        if pg is None:
            raise rpc.RpcError("placement group not found")
        deadline = time.monotonic() + p.get("timeout", 30.0)
        while pg.state not in (PG_CREATED, PG_REMOVED):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return {"state": pg.state}
            await self._pg_state_wait(pg.pg_id, remaining)
        if pg.state == PG_REMOVED:
            raise rpc.RpcError("placement group was removed while waiting")
        return {"state": pg.state}

    async def rpc_remove_placement_group(self, conn, p):
        pg = self.placement_groups.get(PlacementGroupID(p["pg_id"]))
        if pg is None or pg.state == PG_REMOVED:
            return True
        await self._remove_pg(pg)
        return True

    async def _remove_pg(self, pg: PlacementGroupEntry):
        # State first: _release_lease consults it to decide where freed
        # resources go (bundle vs node pool).
        pg.state = PG_REMOVED
        if pg.name:
            self.named_pgs.pop((pg.namespace, pg.name), None)
        # Kill actors and break leases living in the group (the reference
        # kills workers of removed PGs: gcs_placement_group_manager.cc).
        for lease in list(self.leases.values()):
            if lease.pg_ref and lease.pg_ref[0] == pg.pg_id:
                if lease.actor_id:
                    actor = self.actors.get(lease.actor_id)
                    if actor:
                        await self._kill_actor(
                            actor, "placement group removed", no_restart=True
                        )
                        continue  # _kill_actor released the lease
                await self._release_lease(lease.lease_id, broken=True)
        # Return unleased bundle remainders to their nodes.
        for i, nid in enumerate(pg.bundle_nodes):
            if nid is not None:
                node = self.nodes.get(nid)
                if node and node.alive:
                    node.resources_available = node.resources_available.add(
                        pg.bundle_available[i]
                    )
            pg.bundle_nodes[i] = None
            pg.bundle_available[i] = ResourceSet()
        if pg.pg_id in self._pending_pgs:
            self._pending_pgs.remove(pg.pg_id)
        self._wake_pg_waiters(pg.pg_id)
        await self.publish(
            "placement_groups", {"event": "removed", "pg_id": pg.pg_id.hex()}
        )
        self._kick_pending()

    async def rpc_get_placement_group(self, conn, p):
        if "name" in p:
            key = (p.get("namespace", "default"), p["name"])
            pg_id = self.named_pgs.get(key)
            pg = self.placement_groups.get(pg_id) if pg_id else None
        else:
            pg = self.placement_groups.get(PlacementGroupID(p["pg_id"]))
        if pg is None:
            return None
        return self._pg_info(pg)

    def _pg_info(self, pg: PlacementGroupEntry) -> dict:
        return {
            "pg_id": pg.pg_id.binary(),
            "name": pg.name,
            "strategy": pg.strategy,
            "state": pg.state,
            "bundles": [b.to_dict() for b in pg.bundles],
            "bundle_nodes": [
                nid.hex() if nid else None for nid in pg.bundle_nodes
            ],
            "bundles_available": [b.to_dict() for b in pg.bundle_available],
            "created_at": pg.created_at,
        }

    async def rpc_list_placement_groups(self, conn, p):
        return [self._pg_info(pg) for pg in self.placement_groups.values()]

    # ---- blob store (runtime-env packages and other large artifacts;
    # files under the session dir, so they survive GCS restarts without
    # riding the control checkpoint) ------------------------------------
    def _blob_path(self, sha: str) -> str:
        import os

        base = self.session_dir or session_root()
        return os.path.join(base, "blobs", sha)

    async def rpc_put_blob(self, conn, p):
        import os

        sha = p["sha"]
        path = self._blob_path(sha)

        def write():
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + f".tmp{os.getpid()}"
            with open(tmp, "wb") as f:
                f.write(p["data"])
            os.replace(tmp, path)

        if not os.path.exists(path):
            await asyncio.get_running_loop().run_in_executor(None, write)
        return True

    async def rpc_get_blob(self, conn, p):
        path = self._blob_path(p["sha"])

        def read():
            try:
                with open(path, "rb") as f:
                    return f.read()
            except FileNotFoundError:
                return None

        return await asyncio.get_running_loop().run_in_executor(None, read)

    # ---- job submission (ray: dashboard/modules/job/job_manager.py:529,
    # embedded here instead of a dashboard process) ---------------------
    async def rpc_submit_job(self, conn, p):
        import os
        import subprocess
        import uuid

        sub_id = p.get("submission_id") or f"rtjob-{uuid.uuid4().hex[:12]}"
        if sub_id in self.submitted_jobs:
            raise rpc.RpcError(f"submission_id {sub_id!r} already used")
        base = self.session_dir or session_root()
        jobs_dir = os.path.join(base, "jobs", sub_id)
        os.makedirs(jobs_dir, exist_ok=True)
        env = dict(os.environ)
        env["RT_ADDRESS"] = self.address
        # the driver sees the node's cards, not the control plane's pin
        # (node.py _control_plane_env)
        env.pop("CUDA_VISIBLE_DEVICES", None)
        if "RT_GPU_VISIBLE_DEVICES" in env:
            env["CUDA_VISIBLE_DEVICES"] = env["RT_GPU_VISIBLE_DEVICES"]
        cwd = jobs_dir
        desc = p.get("runtime_env") or {}
        env.update(desc.get("env_vars") or {})
        if desc.get("working_dir_pkg"):
            import io
            import zipfile

            blob = await self.rpc_get_blob(
                conn, {"sha": desc["working_dir_pkg"]}
            )
            if blob is None:
                raise rpc.RpcError("job working_dir package missing")
            cwd = os.path.join(jobs_dir, "working_dir")
            await asyncio.get_running_loop().run_in_executor(
                None,
                lambda: zipfile.ZipFile(io.BytesIO(bytes(blob))).extractall(
                    cwd
                ),
            )
        log_path = os.path.join(jobs_dir, "driver.log")

        def launch():
            log_f = open(log_path, "ab")
            try:
                return subprocess.Popen(
                    ["bash", "-c", p["entrypoint"]],
                    cwd=cwd, env=env, stdout=log_f,
                    stderr=subprocess.STDOUT,
                )
            finally:
                log_f.close()

        proc = await asyncio.get_running_loop().run_in_executor(None, launch)
        self.submitted_jobs[sub_id] = {
            "submission_id": sub_id,
            "entrypoint": p["entrypoint"],
            "metadata": p.get("metadata", {}),
            "status": RUNNING_JOB,
            "start_time": time.time(),
            "end_time": None,
            "log_path": log_path,
            "pid": proc.pid,
            "_proc": proc,
        }
        self._mark_dirty()
        return {"submission_id": sub_id}

    def _poll_submitted_jobs(self):
        for info in self.submitted_jobs.values():
            proc = info.get("_proc")
            if info["status"] == RUNNING_JOB and proc is not None:
                rc = proc.poll()
                if rc is not None:
                    info["status"] = (
                        SUCCEEDED_JOB if rc == 0 else FAILED_JOB
                    )
                    info["end_time"] = time.time()
                    info["returncode"] = rc
                    self._mark_dirty()

    async def rpc_get_job_info(self, conn, p):
        self._poll_submitted_jobs()
        info = self.submitted_jobs.get(p["submission_id"])
        if info is None:
            raise rpc.RpcError(f"no job {p['submission_id']!r}")
        return {k: v for k, v in info.items() if not k.startswith("_")}

    async def rpc_get_job_logs(self, conn, p):
        info = self.submitted_jobs.get(p["submission_id"])
        if info is None:
            raise rpc.RpcError(f"no job {p['submission_id']!r}")

        def read():
            try:
                with open(info["log_path"], "rb") as f:
                    return f.read().decode("utf-8", "replace")
            except FileNotFoundError:
                return ""

        # off-loop: a multi-GB driver log must not stall heartbeats
        return await asyncio.get_running_loop().run_in_executor(None, read)

    async def rpc_stop_job(self, conn, p):
        info = self.submitted_jobs.get(p["submission_id"])
        if info is None:
            return False
        proc = info.get("_proc")
        if info["status"] == RUNNING_JOB and proc is not None:
            proc.terminate()

            def wait_or_kill():
                try:
                    proc.wait(timeout=5)
                except Exception:
                    proc.kill()

            # off-loop: an entrypoint ignoring SIGTERM must not stall the
            # control plane for the grace period
            await asyncio.get_running_loop().run_in_executor(
                None, wait_or_kill
            )
            info["status"] = STOPPED_JOB
            info["end_time"] = time.time()
            self._mark_dirty()
        return True

    async def rpc_list_jobs(self, conn, p):
        self._poll_submitted_jobs()
        return [
            {k: v for k, v in info.items() if not k.startswith("_")}
            for info in self.submitted_jobs.values()
        ]

    async def rpc_delete_job(self, conn, p):
        """Drop a TERMINAL submitted job's record (reference:
        DELETE /api/jobs/{id}, job_head.py:368 — running jobs must be
        stopped first)."""
        self._poll_submitted_jobs()
        info = self.submitted_jobs.get(p["submission_id"])
        if info is None:
            return False
        if info["status"] == RUNNING_JOB:
            raise rpc.RpcError(
                f"job {p['submission_id']!r} is RUNNING; stop it first"
            )
        del self.submitted_jobs[p["submission_id"]]
        self._mark_dirty()
        return True

    async def rpc_list_tasks(self, conn, p):
        """Cluster-wide live tasks: fan out to raylets → workers (ray:
        python/ray/util/state/api.py list_tasks, sourced live instead of
        from an event store)."""
        out = []
        for n in list(self.nodes.values()):
            if not n.alive or n.conn is None:
                continue
            try:
                out.extend(
                    await n.conn.call("list_worker_tasks", {}, timeout=10.0)
                )
            except Exception:
                continue
        return out

    async def rpc_list_objects(self, conn, p):
        """Object directory view (id, size, locations, holder count)."""
        limit = p.get("limit", 1000)
        out = []
        for oid, nodes in list(self.object_locations.items())[:limit]:
            out.append({
                "object_id": oid.hex(),
                "size_bytes": self.object_sizes.get(oid),
                "locations": [n.hex() for n in nodes],
                "num_holders": len(self.object_holders.get(oid, ())),
            })
        return out

    def record_cluster_event(self, severity: str, source: str,
                             message: str, **fields) -> None:
        """Append a structured event to the bounded cluster event log
        (ray: src/ray/util/event.h RAY_EVENT + dashboard/modules/event).
        Core transitions (node/actor/worker lifecycle) record here
        automatically; applications report via util.events."""
        self._events.append({
            "ts": time.time(),
            "severity": severity,
            "source": source,
            "message": message,
            **fields,
        })
        while len(self._events) > 2000:
            self._events.pop(0)

    async def rpc_cluster_store_stats(self, conn, p):
        """Per-node shm store stats fanned out to live raylets (ray:
        `ray memory` / memory_summary role)."""
        alive = [
            n for n in self.nodes.values()
            if n.alive and n.conn is not None
        ]

        async def one(node):
            try:
                return node.node_id.hex(), await asyncio.wait_for(
                    node.conn.call("store_stats", {}), timeout=10.0
                )
            except Exception as e:  # noqa: BLE001 — report per-node
                return node.node_id.hex(), {"error": repr(e)}

        # concurrent fan-out: one hung raylet costs 10s total, not 10s
        # per node
        return dict(await asyncio.gather(*(one(n) for n in alive)))

    async def rpc_report_event(self, conn, p):
        self.record_cluster_event(
            p.get("severity", "INFO"), p.get("source", "app"),
            p.get("message", ""), **(p.get("fields") or {}),
        )
        return True

    async def rpc_list_events(self, conn, p):
        sev = p.get("severity")
        rows = [
            e for e in self._events
            if sev is None or e["severity"] == sev
        ]
        limit = int(p.get("limit", 500))
        return rows[-limit:] if limit > 0 else []

    async def rpc_metrics_push(self, conn, p):
        """A process pushes its metric snapshot (ray: stats exporter →
        dashboard agent; here straight into the GCS aggregate table)."""
        self.metrics_by_reporter[p["reporter"]] = {
            "ts": time.time(),
            "metrics": p["metrics"],
        }
        return True

    async def rpc_get_metrics(self, conn, p):
        """Aggregated metrics: counters/histogram buckets sum across
        reporters, gauges keep per-reporter last values."""
        agg: Dict[str, Any] = {}
        for reporter, snap in self.metrics_by_reporter.items():
            for m in snap["metrics"]:
                key = m["name"]
                ent = agg.setdefault(
                    key,
                    {"name": key, "type": m["type"],
                     "description": m.get("description", ""),
                     "series": {}},
                )
                for tags_key, value in m["series"].items():
                    if m["type"] == "gauge":
                        ent["series"][f"{reporter}|{tags_key}"] = value
                    else:
                        ent["series"][tags_key] = (
                            ent["series"].get(tags_key, 0) + value
                        )
        return list(agg.values())

    async def rpc_scheduler_stats(self, conn, p):
        """O(1) control-plane counters (queue depth, leases, nodes,
        actors, PGs) — the cheap probe for dashboards and scale tests;
        get_autoscaler_state serializes the full pending list and is
        O(queue), unusable at 1M queued."""
        return {
            "pending_leases": len(self.scheduler.pending),
            "leases": len(self.leases),
            "nodes": len(self.nodes),
            "nodes_alive": sum(
                1 for n in self.nodes.values()
                if n.alive and n.conn is not None
            ),
            "actors": len(self.actors),
            "placement_groups": sum(
                1 for pg in self.placement_groups.values()
                if pg.state != PG_REMOVED
            ),
        }

    async def rpc_get_autoscaler_state(self, conn, p):
        """Demand/usage view for the autoscaler's reconcile loop (ray:
        autoscaler/v2 GetClusterResourceState — scheduler.py:624).  The
        caller's ``node_types`` (resource dicts) are what it can launch:
        from then on a lease that only such a node could hold is queued
        as demand, as Ray queues an infeasible task for its autoscaler,
        where without them it is refused at once."""
        if p and p.get("node_types") is not None:
            self.scheduler.launchable = [
                ResourceSet(r) for r in p["node_types"]
            ]
            self.scheduler._feasible_cache.clear()
        pending = [
            {"demand": pl.demand.to_dict(), "strategy": pl.strategy,
             "age_s": time.monotonic() - pl.enqueued_at}
            for pl in self.scheduler.pending
        ]
        pending_bundles = []
        for pg in self.placement_groups.values():
            if pg.state in (PG_PENDING, PG_RESCHEDULING):
                pending_bundles.append({
                    "pg_id": pg.pg_id.hex(),
                    "strategy": pg.strategy,
                    "bundles": [
                        pg.bundles[i].to_dict()
                        for i in range(len(pg.bundles))
                        if pg.bundle_nodes[i] is None
                    ],
                })
        busy_nodes: Set[NodeID] = set()
        for lease in self.leases.values():
            busy_nodes.add(lease.node_id)
        for a in self.actors.values():
            if a.state in (ACTOR_ALIVE, ACTOR_RESTARTING) and a.node_id:
                busy_nodes.add(a.node_id)
        for pg in self.placement_groups.values():
            if pg.state != PG_REMOVED:
                busy_nodes.update(n for n in pg.bundle_nodes if n)
        nodes = [
            {
                "node_id": n.node_id.hex(),
                "alive": n.alive and n.conn is not None,
                # suspect nodes still COUNT as supply (autoscaler: a
                # transient stall must not launch replacement capacity)
                # but must not be idle-drained while their fate is open
                "suspect": n.suspect,
                "draining": n.draining,
                "labels": n.labels,
                "resources_total": n.resources_total.to_dict(),
                "resources_available": n.resources_available.to_dict(),
                "idle": n.node_id not in busy_nodes,
            }
            for n in self.nodes.values()
        ]
        return {
            "pending_leases": pending,
            "pending_pg_bundles": pending_bundles,
            "nodes": nodes,
        }

    # ---- graceful drain (protocol v2) -----------------------------------
    #
    # DrainNode role-equivalent (ray: NodeInfoGcsService DrainNode,
    # gcs_node_manager.cc) extended into zero-loss migration: a DRAINING
    # node is excluded from lease grants and PG (re)placement, then —
    # inside the announced deadline — its PG bundles are relocated, its
    # sole-copy shm objects are pulled onto surviving nodes (so
    # object_locations never goes empty: no lineage reconstruction), and
    # its actors migrate (checkpoint hooks → state handoff that does not
    # consume the restart budget; hook-less → fresh restart under
    # max_restarts; no budget → left to serve until the kill).  On
    # deadline expiry the GCS falls back to the hard _on_node_death path,
    # so a stuck drain can never wedge the cluster.

    @staticmethod
    def _ckpt_key(actor_id: ActorID) -> str:
        return f"__rt_actor_ckpt:{actor_id.hex()}"

    async def _drop_actor_ckpt(self, actor_id: ActorID) -> None:
        """Retire an actor's parked drain checkpoint: pop the KV record
        and, when the blob rode the object plane, free the blob object
        cluster-wide (its copies would otherwise pin arena space as
        protected primaries forever)."""
        import pickle

        raw = self.kv.pop(self._ckpt_key(actor_id), None)
        if raw is None:
            return
        self._mark_dirty()
        try:
            ref = pickle.loads(raw).get("blob_ref")
        except Exception:
            return
        if ref is not None:
            await self._free_object(ref)

    async def rpc_drain_node(self, conn, p):
        """Start a graceful drain: stop scheduling onto the node, then
        migrate its state within ``deadline_s``.  The node stays alive
        until its raylet actually dies (or the deadline lapses), so
        _on_node_death can still scrub whatever the drain did not move."""
        node = self.nodes.get(NodeID.from_hex(p["node_id"]))
        if node is None or not node.alive:
            return {"accepted": False, "state": "unknown"}
        reason = p.get("reason", "idle")
        deadline_s = float(
            p.get("deadline_s") or cfg.drain_deadline_default_s
        )
        if node.draining:
            # idempotent re-request (a metadata watcher re-announcing):
            # report the in-flight drain instead of restarting it
            st = node.drain_status or {}
            return {"accepted": True, "state": st.get("state", "draining")}
        node.drain_reason = reason
        node.drain_status = {
            "state": "draining",
            "reason": reason,
            "deadline_s": deadline_s,
            "started_at": time.time(),
            "objects_total": 0,
            "objects_moved": 0,
            "actors_total": 0,
            "actors_moved": 0,
            "ckpt_blob_objects": 0,
        }
        node.draining = True  # parks the node in the scheduler index
        self.record_cluster_event(
            "WARNING", "gcs",
            f"node draining ({reason}, deadline {deadline_s:g}s)",
            node_id=node.node_id.hex(),
        )
        await self.publish(
            "nodes",
            {"event": "draining", "node_id": p["node_id"],
             "reason": reason, "deadline_s": deadline_s},
        )
        self._drain_tasks[node.node_id] = (
            asyncio.get_running_loop().create_task(
                self._drain_node(node, deadline_s)
            )
        )
        return {"accepted": True, "state": "draining"}

    async def rpc_get_drain_status(self, conn, p):
        node = self.nodes.get(NodeID.from_hex(p["node_id"]))
        if node is None:
            return {"state": "unknown"}
        if not node.alive:
            return dict(node.drain_status or {}, state="dead")
        if node.drain_status is None:
            return {"state": "none"}
        return dict(node.drain_status)

    async def _drain_node(self, node: NodeEntry, deadline_s: float):
        """Deadline-bounded drain driver: on success the node sits fully
        evacuated (still alive, still excluded) awaiting its kill; on
        timeout or error the hard node-death path cleans up reactively."""
        st = node.drain_status
        try:
            await asyncio.wait_for(
                self._drain_node_inner(node, deadline_s), timeout=deadline_s
            )
        except Exception as e:  # noqa: BLE001 — incl. wait_for timeout
            st["state"] = "failed"
            st["error"] = repr(e)
            logger.warning(
                "drain of node %s failed (%r); falling back to hard "
                "node-death cleanup", node.node_id, e,
            )
            self._drain_tasks.pop(node.node_id, None)
            await self._on_node_death(
                node.node_id, f"drain deadline expired/failed: {e!r}"
            )
            return
        finally:
            self._drain_tasks.pop(node.node_id, None)
            self._mark_dirty()
        st["state"] = "drained"
        st["finished_at"] = time.time()
        self.record_cluster_event(
            "INFO", "gcs",
            f"node drained ({st['reason']}): {st['objects_moved']} objects, "
            f"{st['actors_moved']} actors migrated",
            node_id=node.node_id.hex(),
        )
        await self.publish(
            "nodes", {"event": "drained", "node_id": node.node_id.hex()}
        )

    async def _drain_node_inner(self, node: NodeEntry, deadline_s: float):
        budget_end = time.monotonic() + deadline_s
        # 1. the raylet stops accepting leases and lets in-flight tasks
        # finish (GCS-side exclusion is authoritative; this closes the
        # grant-in-flight window and arms the raylet's local refusals)
        try:
            await node.conn.call(
                "drain",
                {"reason": node.drain_reason, "deadline_s": deadline_s},
                timeout=5.0,
            )
        except Exception:
            logger.warning("raylet drain notify failed", exc_info=True)
        # 2. relocate placement-group bundles living here: replacements
        # land on surviving nodes (draining nodes are excluded from
        # placement), so gang actors can restart into their own bundle
        await self._drain_evict_pg_bundles(node)
        # 3. evacuate sole-copy shm objects onto surviving nodes over the
        # existing pull plane — object_locations never goes empty, so no
        # get() ever needs lineage reconstruction
        await self._drain_evacuate_objects(node)
        # 4. migrate actors (checkpoint handoff / fresh restart)
        await self._drain_migrate_actors(node)
        # 5. give in-flight normal-task leases a bounded window to return
        # naturally (clients return leases shortly after their queue
        # drains); whatever remains is broken by the eventual node death,
        # riding the task retry path
        lease_grace = max(
            0.0,
            min(
                (budget_end - time.monotonic()),
                deadline_s * cfg.drain_lease_wait_frac,
            ),
        )
        # actor leases are excluded: migrated actors' leases were already
        # released above, and the ones that legitimately remain
        # (on_drain="ignore", no restart budget) live until the node
        # dies — waiting on them would burn the whole grace for nothing
        lease_end = time.monotonic() + lease_grace
        while time.monotonic() < lease_end:
            if node.inflight_grants == 0 and not any(
                lease.node_id == node.node_id and lease.actor_id is None
                for lease in self.leases.values()
            ):
                break
            await asyncio.sleep(0.05)
        # 6. re-scan evacuation: a task that was in flight at phase 3
        # may have stored a sole-copy result on the node since the first
        # sweep — it must not be lost to the kill (the second pass is
        # incremental: usually zero victims)
        await self._drain_evacuate_objects(node)

    async def _drain_evict_pg_bundles(self, node: NodeEntry):
        nid = node.node_id
        moved = False
        for pg in list(self.placement_groups.values()):
            if pg.state not in (PG_CREATED, PG_RESCHEDULING):
                continue
            lost = [
                i for i, bn in enumerate(pg.bundle_nodes) if bn == nid
            ]
            if not lost:
                continue
            # break non-actor leases drawing from the evicted bundles —
            # their tasks requeue onto the relocated bundle (actor leases
            # are handled by the migration phase, which releases them
            # itself once the actor's state is safe)
            for lease in list(self.leases.values()):
                if (
                    lease.node_id == nid
                    and lease.pg_ref is not None
                    and lease.pg_ref[0] == pg.pg_id
                    and lease.pg_ref[1] in lost
                    and lease.actor_id is None
                ):
                    await self._release_lease(
                        lease.lease_id, broken=True, kick=False
                    )
            for i in lost:
                # accounting: only the UNLEASED remainder returns to the
                # (parked) node pool — outstanding draws (gang-actor
                # leases) are credited by their own _release_lease when
                # the migration phase frees them, and the full bundle
                # here would double-count them past resources_total
                node.resources_available = node.resources_available.add(
                    pg.bundle_available[i]
                )
                pg.bundle_nodes[i] = None
                pg.bundle_available[i] = ResourceSet()
            pg.state = PG_RESCHEDULING
            if pg.pg_id not in self._pending_pgs:
                self._pending_pgs.append(pg.pg_id)
            await self.publish(
                "placement_groups",
                {"event": "rescheduling", "pg_id": pg.pg_id.hex()},
            )
            moved = True
        if moved:
            self._kick_pending()  # place the evicted bundles elsewhere now

    def _drain_targets(self, node: NodeEntry) -> List[NodeEntry]:
        targets = [
            n for n in self.nodes.values()
            if n.alive and n.conn is not None and not n.draining
        ]
        # healthy targets first: evacuating onto a failure-suspected
        # node risks a second move (or a loss) moments later
        targets.sort(key=lambda n: n.suspect)
        return targets

    def _node_is_doomed(self, nid: NodeID) -> bool:
        n = self.nodes.get(nid)
        return n is None or not n.alive or n.draining

    async def _drain_evacuate_objects(self, node: NodeEntry):
        nid = node.node_id
        st = node.drain_status
        # an object needs evacuation when one copy is here and EVERY
        # copy sits on a doomed (draining/dead) node — exact `== {nid}`
        # would let an object replicated only across two concurrently
        # draining nodes (a whole preempted slice) be evacuated by
        # neither drain and lost to both kills; dual evacuation of the
        # same object is harmless (the targets' pulls coalesce)
        victims = [
            oid for oid, locs in self.object_locations.items()
            if nid in locs and all(self._node_is_doomed(l) for l in locs)
        ]
        sole = set(victims)
        for oid, snid in self.spilled_objects.items():
            # spilled-only objects (file on the draining node's disk, no
            # live arena copy on a surviving node): a target's pull
            # restores them straight off the spill file
            if snid == nid and oid not in sole and all(
                self._node_is_doomed(l)
                for l in self.object_locations.get(oid, ())
            ):
                victims.append(oid)
        # accumulate: the drain runs two sweeps (bulk + a post-settle
        # re-scan for results stored mid-drain)
        st["objects_total"] += len(victims)
        if not victims:
            return
        targets = self._drain_targets(node)
        if not targets:
            raise rpc.RpcError(
                "no surviving node to evacuate onto (sole-copy objects "
                "would be lost)"
            )
        sem = asyncio.Semaphore(cfg.drain_evac_concurrency)

        async def evacuate(i: int, oid: bytes):
            async with sem:
                # try each surviving node once, starting round-robin —
                # the outer deadline bounds total time
                errs = []
                for k in range(len(targets)):
                    t = targets[(i + k) % len(targets)]
                    try:
                        ok = await t.conn.call(
                            "pull_object",
                            {"object_id": oid, "timeout": 20.0},
                            timeout=30.0,
                        )
                    except Exception as e:  # noqa: BLE001
                        errs.append(e)
                        continue
                    if ok is True:
                        st["objects_moved"] += 1
                        return
                raise rpc.RpcError(
                    f"evacuation of {oid.hex()[:12]} failed on every "
                    f"surviving node ({errs!r})"
                )

        await asyncio.gather(
            *(evacuate(i, oid) for i, oid in enumerate(victims))
        )

    async def _drain_migrate_actors(self, node: NodeEntry):
        import pickle

        nid = node.node_id
        st = node.drain_status
        victims = [
            a for a in self.actors.values()
            if a.node_id == nid and a.state == ACTOR_ALIVE
            and getattr(a, "on_drain", "migrate") != "ignore"
        ]
        st["actors_total"] = len(victims)
        for actor in victims:
            lease = self.leases.get(actor.lease_id)
            wconn = (
                self._worker_conns.get(lease.worker_id)
                if lease is not None else None
            )
            ck = {"supported": False, "blob": None, "groups": []}
            if wconn is not None and not wconn.closed:
                try:
                    # unbounded on purpose: a hung __rt_checkpoint__ is
                    # exactly what the outer drain deadline exists for
                    ck = await wconn.call(
                        "checkpoint_actor",
                        {"actor_id": actor.actor_id.binary()},
                        timeout=-1,
                    )
                except Exception:
                    logger.warning(
                        "checkpoint of actor %s failed; migrating fresh",
                        actor.actor_id, exc_info=True,
                    )
            groups = ck.get("groups") or []
            reason = f"node draining ({st['reason']})"
            if ck.get("supported"):
                # stateful migration: intentional relocation, NOT a
                # failure — does not consume the restart budget.  Large
                # blobs arrive as an object-plane ref (blob_ref): only
                # the id is parked in KV; the restore pulls the payload
                # over the data plane and _drop_actor_ckpt frees it.
                self.kv[self._ckpt_key(actor.actor_id)] = pickle.dumps(
                    {"blob": ck.get("blob"),
                     "blob_ref": ck.get("blob_ref"),
                     "groups": groups}, protocol=5
                )
                if ck.get("blob_ref") is not None:
                    st["ckpt_blob_objects"] = (
                        st.get("ckpt_blob_objects", 0) + 1
                    )
                self._mark_dirty()
            elif groups:
                # hook-less collective member: no user state to carry,
                # but the membership envelope still rides along so the
                # restarted process re-joins its groups
                self.kv[self._ckpt_key(actor.actor_id)] = pickle.dumps(
                    {"blob": None, "groups": groups}, protocol=5
                )
                self._mark_dirty()
            if not ck.get("supported"):
                can_restart = actor.max_restarts != 0 and (
                    actor.max_restarts < 0
                    or actor.restarts_used < actor.max_restarts
                )
                if not can_restart:
                    # no budget: leave it serving — it dies with the node
                    # exactly as it would today, and killing it early
                    # would only shorten its remaining service time.
                    # If the worker DID capture (its reply was lost), its
                    # admission fence is up — lift it, or "serving" would
                    # really be "parking every call until node death"
                    if wconn is not None and not wconn.closed:
                        try:
                            await wconn.notify("checkpoint_abort", {})
                        except Exception:
                            pass
                    await self._drop_actor_ckpt(actor.actor_id)
                    continue
                actor.restarts_used += 1
            actor.state = ACTOR_RESTARTING
            actor.worker_addr = None
            self.record_cluster_event(
                "WARNING", "gcs",
                f"actor migrating off draining node "
                f"({'with state' if ck.get('supported') else 'fresh'})",
                actor_id=actor.actor_id.hex(),
            )
            await self.publish(
                f"actor:{actor.actor_id.hex()}", {"state": ACTOR_RESTARTING}
            )
            old_lease = actor.lease_id
            actor.lease_id = None
            if old_lease is not None:
                # kills the old worker (its state is safe now); the
                # raylet's worker_died report finds no lease/ALIVE state
                # to act on, so no double restart
                await self._release_lease(old_lease, broken=True)
            # shielded: once the old worker is gone the restart targets a
            # SURVIVING node — a drain-deadline cancellation mid-restart
            # must let it finish rather than strand the actor RESTARTING
            # (strong ref held: the loop tracks tasks weakly, and an
            # orphaned shield inner would otherwise be GC-able)
            restart = asyncio.get_running_loop().create_task(
                self._restart_actor(actor, reason)
            )
            self._restart_tasks.add(restart)
            restart.add_done_callback(self._restart_tasks.discard)
            await asyncio.shield(restart)
            if actor.state == ACTOR_ALIVE:
                st["actors_moved"] += 1

    def _pg_bundle_candidates(
        self, pg: PlacementGroupEntry, idx: int, demand: ResourceSet
    ) -> List[int]:
        """Bundle indices this lease may draw from; validates feasibility.

        Raises immediately (like the non-PG infeasibility path) when the
        demand can never fit the targeted bundle(s), instead of letting the
        caller wait forever on LEASE_PENDING.
        """
        if idx >= len(pg.bundles):
            raise rpc.RpcError(
                f"bundle_index {idx} out of range ({len(pg.bundles)} bundles)"
            )
        cands = [idx] if idx >= 0 else list(range(len(pg.bundles)))
        if not any(pg.bundles[i].covers(demand) for i in cands):
            raise rpc.RpcError(
                f"infeasible placement-group request {demand.to_dict()}: no "
                f"targeted bundle is large enough "
                f"(bundles: {[pg.bundles[i].to_dict() for i in cands]})"
            )
        return cands

    async def _try_grant_pg_lease(
        self, pg: PlacementGroupEntry, cands: List[int], demand: ResourceSet,
        conn, p,
    ):
        """Grant from the first bundle with room on an alive node, else None."""
        if pg.state != PG_CREATED:
            return None
        for i in cands:
            nid = pg.bundle_nodes[i]
            node = self.nodes.get(nid) if nid else None
            # `not node.draining`: the general scheduler parks draining
            # nodes in its index, but PG grants bypass the index and
            # would otherwise keep placing fresh work onto a node the
            # autoscaler/provider is about to terminate
            if (node and node.alive and node.conn is not None
                    and not node.draining
                    and pg.bundle_available[i].covers(demand)):
                return await self._grant_lease(
                    node, demand, conn, p, pg_ref=(pg.pg_id, i)
                )
        return None

    async def _request_pg_lease(self, conn, p, demand: ResourceSet, strategy):
        pg = self.placement_groups.get(
            PlacementGroupID.from_hex(strategy["pg_id"])
        )
        if pg is None:
            raise rpc.RpcError("placement group not found")
        idx = strategy.get("bundle_index", -1)
        cands = self._pg_bundle_candidates(pg, idx, demand)
        deadline = time.monotonic() + cfg.sched_max_pending_lease_s
        while True:
            if pg.state == PG_REMOVED:
                raise rpc.RpcError("placement group was removed")
            grant = await self._try_grant_pg_lease(pg, cands, demand, conn, p)
            if grant is not None:
                return grant
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not await self._pg_state_wait(
                pg.pg_id, remaining
            ):
                raise rpc.RpcError(
                    f"LEASE_PENDING: waiting for placement-group capacity for "
                    f"{demand.to_dict()} (bundle_index={idx}, state={pg.state})"
                )

    # ---- leases (the scheduling hot path) ------------------------------
    async def rpc_request_lease(self, conn, p):
        """Grant a worker lease: pick node, get a worker from its raylet."""
        demand = ResourceSet(p["resources"])
        strategy = p.get("strategy", {})
        if strategy.get("type") == "placement_group":
            return await self._request_pg_lease(conn, p, demand, strategy)
        actor_id = ActorID(p["actor_id"]) if p.get("actor_id") else None
        if not self.scheduler.is_feasible(demand):
            raise rpc.RpcError(
                f"infeasible resource request {demand.to_dict()}: no node in the "
                f"cluster can ever satisfy it (cluster: "
                f"{[n.resources_total.to_dict() for n in self.nodes.values()]})"
            )
        t_start = time.monotonic()
        deadline = t_start + cfg.sched_max_pending_lease_s
        tag = p.get("tag")
        while True:
            if tag is not None:
                stamp = conn.peer_info.get("cancelled_tags", {}).get(tag)
                if stamp is not None and stamp >= t_start:
                    return {"cancelled": True}
            node = self.scheduler.pick_node(demand, strategy)
            if node is None:
                fut = asyncio.get_running_loop().create_future()
                entry = PendingLease(
                    fut, demand, strategy, conn, actor_id, tag=tag
                )
                self.scheduler.pending.append(entry)
                try:
                    # bounded wait: the client re-requests on LEASE_PENDING so
                    # a vanished client can never leak a queued grant
                    if await asyncio.wait_for(
                        fut, timeout=deadline - time.monotonic()
                    ) == "cancelled":
                        # client demand evaporated (rpc_cancel_lease_requests):
                        # answer with a no-lease marker instead of granting
                        # capacity the client would bounce straight back
                        return {"cancelled": True}
                except asyncio.TimeoutError:
                    # no eager dequeue: membership + remove are O(queue)
                    # on a deque, and with 100k queued the timeout path
                    # IS the hot path.  wait_for already cancelled fut;
                    # _kick_pending lazily drops done/cancelled entries.
                    raise rpc.RpcError(
                        "LEASE_PENDING: waiting for cluster capacity for "
                        f"{demand.to_dict()}"
                    )
                # woken up: re-pick — capacity may have been taken by another
                # grant racing this continuation
                continue
            if not node.resources_available.covers(demand):
                continue  # stale pick; loop re-evaluates
            granted = await self._grant_lease(node, demand, conn, p)
            # chain the drain: kicks wake at most a window of waiters, so
            # a large capacity release (PG removal, node join) relies on
            # each resulting grant re-kicking to keep freed slots filling
            if self.scheduler.pending:
                self._kick_pending()
            return granted

    async def _grant_lease(
        self, node: NodeEntry, demand: ResourceSet, conn, p, pg_ref=None
    ):
        if getattr(conn, "closed", False):
            self._kick_pending()
            raise rpc.RpcError("client disconnected before lease grant")
        lease_id = next(self._lease_ids)
        if pg_ref is not None:
            # PG leases draw from the bundle's reservation, not the node
            # pool (the node pool was already debited at PG creation).
            pg = self.placement_groups[pg_ref[0]]
            pg.bundle_available[pg_ref[1]] = pg.bundle_available[
                pg_ref[1]
            ].subtract(demand)
        else:
            node.resources_available = node.resources_available.subtract(demand)
        node.inflight_grants += 1
        try:
            reply = await node.conn.call(
                "lease_worker",
                {
                    "lease_id": lease_id,
                    "resources": demand.to_dict(),
                    "runtime_env": p.get("runtime_env"),
                },
                timeout=cfg.worker_start_timeout_s,
            )
            # Re-check after the await: _remove_pg may have run while the
            # raylet was starting the worker, and its lease scan could not
            # see this in-flight grant — the reference kills all PG
            # inhabitants on removal, so fail the grant and free the worker.
            if pg_ref is not None:
                pg = self.placement_groups[pg_ref[0]]
                if pg.state == PG_REMOVED or pg.bundle_nodes[pg_ref[1]] != node.node_id:
                    try:
                        await node.conn.notify(
                            "release_worker",
                            {
                                "lease_id": lease_id,
                                "worker_id": reply["worker_id"],
                                "broken": True,
                            },
                        )
                    except Exception:
                        pass
                    # _remove_pg already credited the (post-debit) bundle
                    # remainder back to the node; refund our demand debit
                    # too, or the node leaks capacity permanently
                    if pg.state == PG_REMOVED and node.alive:
                        node.resources_available = (
                            node.resources_available.add(demand)
                        )
                        self._kick_pending()
                    raise rpc.RpcError(
                        "placement group was removed while the lease was "
                        "being granted"
                    )
        except Exception:
            if pg_ref is not None:
                pg = self.placement_groups[pg_ref[0]]
                # refund only if the bundle still lives on this node — it
                # may have been rescheduled elsewhere (already back at full
                # availability) while the lease_worker RPC was in flight
                if (
                    pg.state != PG_REMOVED
                    and pg.bundle_nodes[pg_ref[1]] == node.node_id
                ):
                    pg.bundle_available[pg_ref[1]] = pg.bundle_available[
                        pg_ref[1]
                    ].add(demand)
                    self._wake_pg_waiters(pg.pg_id)
            else:
                node.resources_available = node.resources_available.add(demand)
            self._kick_pending()
            raise
        finally:
            # success continues to the LeaseEntry registration below with
            # no await in between, so a drain's settle poll can never see
            # "no inflight grant AND no lease" for a granted worker
            node.inflight_grants -= 1
        lease = LeaseEntry(
            lease_id=lease_id,
            node_id=node.node_id,
            worker_id=WorkerID(reply["worker_id"]),
            worker_addr=reply["worker_addr"],
            resources=demand,
            client_conn=conn,
            actor_id=ActorID(p["actor_id"]) if p.get("actor_id") else None,
            pg_ref=pg_ref,
        )
        self.leases[lease_id] = lease
        self._conn_leases.setdefault(conn, set()).add(lease_id)
        return {
            "lease_id": lease_id,
            "node_id": node.node_id.hex(),
            "worker_id": reply["worker_id"],
            "worker_addr": reply["worker_addr"],
            "accelerator_env": reply.get("accelerator_env", {}),
        }

    async def rpc_return_lease(self, conn, p):
        await self._release_lease(p["lease_id"], broken=p.get("broken", False))
        return True

    async def rpc_dump_tasks(self, conn, p):
        """Stacks of every live asyncio task in the GCS process — the
        suspended-coroutine complement of dump_worker_stacks (thread
        stacks only show the epoll wait)."""
        def chain(coro, limit=12):
            # follow the await chain (task.get_stack stops at the
            # outermost suspended frame, hiding WHAT it awaits)
            frames = []
            while coro is not None and len(frames) < limit:
                f = getattr(coro, "cr_frame", None) or getattr(
                    coro, "gi_frame", None
                )
                if f is None:
                    frames.append(repr(coro)[:120])
                    break
                frames.append(
                    f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:"
                    f"{f.f_lineno} {f.f_code.co_name}"
                )
                coro = getattr(coro, "cr_await", None) or getattr(
                    coro, "gi_yieldfrom", None
                )
            return frames

        out = []
        for t in asyncio.all_tasks():
            coro = t.get_coro()
            out.append({
                "name": getattr(coro, "__qualname__", str(coro)),
                "stack": chain(coro),
            })
        return out

    async def rpc_cancel_lease_requests(self, conn, p):
        """Cancel THIS client's parked lease requests carrying one of the
        given tags (ray: CancelWorkerLease, raylet node_manager.cc).

        Without this, a client whose task queue drained leaves its parked
        requests behind; every freed slot then ping-pongs through
        grant → client-sees-no-work → return-after-grace, serially
        starving real demand (PGs, new classes) for `grace × parked`
        seconds.  O(pending) walk — acceptable because cancels fire only
        on queue-drain edges, not per task."""
        tags = set(p["tags"])
        # Stamp the cancel on the connection: a request that was mid-wake
        # (granted a re-pick by _kick_pending) is NOT in pending right now
        # but re-parks immediately — it must still observe this cancel, or
        # it ping-pongs forever.  rpc_request_lease checks the stamp
        # against its own start time on every loop iteration.
        stamps = conn.peer_info.setdefault("cancelled_tags", {})
        now = time.monotonic()
        for t in tags:
            stamps[t] = now
        n = 0
        for req in self.scheduler.pending:
            if (
                req.client_conn is conn
                and req.tag in tags
                and not req.fut.done()
            ):
                req.fut.set_result("cancelled")
                n += 1
        return n

    async def _release_lease(self, lease_id: int, broken: bool = False,
                             kick: bool = True):
        lease = self.leases.pop(lease_id, None)
        if lease is None:
            return
        self._conn_leases.get(lease.client_conn, set()).discard(lease_id)
        node = self.nodes.get(lease.node_id)
        returned_to_bundle = False
        if lease.pg_ref is not None:
            pg = self.placement_groups.get(lease.pg_ref[0])
            i = lease.pg_ref[1]
            if (
                pg is not None
                and pg.state != PG_REMOVED
                and pg.bundle_nodes[i] == lease.node_id
            ):
                # bundle still lives where the lease ran: capacity returns
                # to the bundle, not the node pool
                pg.bundle_available[i] = pg.bundle_available[i].add(
                    lease.resources
                )
                returned_to_bundle = True
                self._wake_pg_waiters(pg.pg_id)
        if node and node.alive:
            if not returned_to_bundle:
                node.resources_available = node.resources_available.add(
                    lease.resources
                )
            try:
                await node.conn.notify(
                    "release_worker",
                    {
                        "lease_id": lease_id,
                        "worker_id": lease.worker_id.binary(),
                        "broken": broken,
                    },
                )
            except Exception:
                pass
        if kick:
            self._kick_pending()

    def _kick_pending(self):
        """Re-try queued placement groups and lease requests after
        resources freed / node joined.  PGs go first: gang reservations
        are all-or-nothing and would otherwise starve behind a stream of
        small leases."""
        still_pgs: List[PlacementGroupID] = []
        for pg_id in self._pending_pgs:
            pg = self.placement_groups.get(pg_id)
            if pg is None or pg.state in (PG_CREATED, PG_REMOVED):
                continue
            if not self._try_place_pg(pg):
                still_pgs.append(pg_id)
        self._pending_pgs = still_pgs
        # Bounded scan: each pass pops at most `sched_kick_scan_window`
        # non-placeable requests and wakes at most `window` placeable
        # ones.  The wake bound matters at depth: capacity is only
        # debited when a woken coroutine actually grants, so during this
        # synchronous loop pick_node keeps seeing the same free capacity
        # — unbounded, one freed CPU against a 100k-deep queue would wake
        # ALL 100k waiters (thundering herd, O(backlog) per freed lease).
        # Scanned-but-unplaceable requests ROTATE TO THE TAIL: strict
        # FIFO would let 64 unplaceable requests at the head permanently
        # shadow a placeable one behind them; rotation round-robins the
        # whole queue across kicks instead (lease grant order is not a
        # FIFO contract — and the client-side LEASE_PENDING re-request
        # after sched_max_pending_lease_s is the liveness backstop for
        # any request the rotation visits rarely).  Under-wake after a
        # large capacity release is absorbed by grant-chaining: every
        # successful grant re-kicks while the queue is non-empty.
        pending = self.scheduler.pending
        budget = len(pending)
        fails = 0
        wakes = 0
        window = cfg.sched_kick_scan_window
        while pending and budget > 0 and fails < window and wakes < window:
            budget -= 1
            req = pending.popleft()
            if req.fut.done():
                continue
            if req.client_conn.closed:
                req.fut.cancel()
                continue
            node = self.scheduler.pick_node(req.demand, req.strategy)
            if node is not None:
                req.fut.set_result(True)  # waker only; requester re-picks
                wakes += 1
            else:
                fails += 1
                pending.append(req)  # rotate to tail

    # ---- actors --------------------------------------------------------
    async def rpc_register_actor(self, conn, p):
        actor_id = ActorID(p["actor_id"])
        name = p.get("name")
        ns = p.get("namespace", "default")
        if name:
            key = (ns, name)
            if key in self.named_actors:
                existing = self.actors.get(self.named_actors[key])
                if existing and existing.state != ACTOR_DEAD:
                    if p.get("get_if_exists"):
                        return {"existing": True, "actor_id": existing.actor_id.binary()}
                    raise rpc.RpcError(f"actor name {name!r} already taken")
            self.named_actors[key] = actor_id
        # actors created from worker processes have no owning job; they die
        # with the cluster (or explicitly), not with any job
        job_id = JobID(p["job_id"]) if p.get("job_id") else None
        entry = ActorEntry(
            actor_id=actor_id,
            name=name,
            namespace=ns,
            state=ACTOR_PENDING,
            owner_job=job_id,
            max_restarts=p.get("max_restarts", 0),
            creation_spec=p.get("creation_spec"),
            resources=p["resources"],
            scheduling=p.get("strategy", {}),
            runtime_env=p.get("runtime_env"),
            detached=p.get("detached", False),
            on_drain=p.get("on_drain", "migrate"),
            creator_conn=conn,
        )
        self.actors[actor_id] = entry
        # pin ref args inside the creation spec for the actor's lifetime:
        # restart replay must be able to resolve them even after every
        # client ref died
        token = b"actor:" + actor_id.binary()
        for oid in self._spec_ref_oids(entry.creation_spec):
            self.object_holders.setdefault(oid, set()).add(token)
        return {"existing": False, "actor_id": actor_id.binary()}

    @staticmethod
    def _spec_ref_oids(creation_spec) -> List[bytes]:
        out = []
        for item in (creation_spec or {}).get("args", ()):
            if item[0] == "ref":
                out.append(item[1])
            elif item[0] == "kwref":
                out.append(item[2])
        return out

    async def rpc_actor_started(self, conn, p):
        """Creator reports the actor's worker is up and __init__ succeeded."""
        actor = self.actors.get(ActorID(p["actor_id"]))
        if not actor:
            return False
        actor.state = ACTOR_ALIVE
        actor.worker_addr = p["worker_addr"]
        actor.node_id = NodeID.from_hex(p["node_id"])
        actor.lease_id = p.get("lease_id")
        # the actor's lease is now owned by the actor lifetime, not the client
        lease = self.leases.get(actor.lease_id)
        if lease:
            self._conn_leases.get(lease.client_conn, set()).discard(actor.lease_id)
            lease.actor_id = actor.actor_id
        await self.publish(
            f"actor:{actor.actor_id.hex()}",
            {"state": ACTOR_ALIVE, "worker_addr": actor.worker_addr},
        )
        return True

    async def rpc_actor_creation_failed(self, conn, p):
        actor = self.actors.get(ActorID(p["actor_id"]))
        if actor:
            await self._kill_actor(actor, p.get("reason", "creation failed"),
                                   no_restart=True)
        return True

    async def rpc_get_actor(self, conn, p):
        if "name" in p:
            key = (p.get("namespace", "default"), p["name"])
            actor_id = self.named_actors.get(key)
            if actor_id is None:
                return None
            actor = self.actors.get(actor_id)
        else:
            actor = self.actors.get(ActorID(p["actor_id"]))
        if actor is None:
            return None
        # If restarting, optionally wait for the new address
        if actor.state in (ACTOR_PENDING, ACTOR_RESTARTING) and p.get("wait", 0):
            deadline = time.monotonic() + p["wait"]
            while (
                actor.state in (ACTOR_PENDING, ACTOR_RESTARTING)
                and time.monotonic() < deadline
            ):
                await asyncio.sleep(0.05)
        return {
            "actor_id": actor.actor_id.binary(),
            "state": actor.state,
            "worker_addr": actor.worker_addr,
            "node_id": actor.node_id.hex() if actor.node_id else None,
            "name": actor.name,
            "death_cause": actor.death_cause,
            "resources": actor.resources,
        }

    async def rpc_kill_actor(self, conn, p):
        actor = self.actors.get(ActorID(p["actor_id"]))
        if actor:
            await self._kill_actor(
                actor, "killed via ray_tpu_torch.kill", no_restart=p.get("no_restart", True)
            )
        return True

    async def _kill_actor(self, actor: ActorEntry, reason: str, no_restart: bool):
        self._mark_dirty()
        if actor.state == ACTOR_DEAD:
            return
        actor.state = ACTOR_DEAD
        actor.death_cause = reason
        await self._drop_actor_ckpt(actor.actor_id)
        token = b"actor:" + actor.actor_id.binary()
        for oid in self._spec_ref_oids(actor.creation_spec):
            s = self.object_holders.get(oid)
            if s is not None:
                s.discard(token)
                if not s:
                    self._schedule_free(oid)
        if actor.name:
            self.named_actors.pop((actor.namespace, actor.name), None)
        if actor.worker_addr:
            # tell the worker to exit
            wid_conn = None
            lease = self.leases.get(actor.lease_id)
            if lease:
                wid_conn = self._worker_conns.get(lease.worker_id)
            if wid_conn:
                try:
                    await wid_conn.notify("exit_worker", {"reason": reason})
                except Exception:
                    pass
        if actor.lease_id is not None:
            await self._release_lease(actor.lease_id, broken=True)
        await self.publish(
            f"actor:{actor.actor_id.hex()}",
            {"state": ACTOR_DEAD, "death_cause": reason},
        )

    async def _maybe_restart_actor(self, actor: ActorEntry, reason: str):
        if (
            actor.max_restarts != 0
            and (actor.max_restarts < 0 or actor.restarts_used < actor.max_restarts)
            and actor.creation_spec is not None
        ):
            actor.restarts_used += 1
            actor.state = ACTOR_RESTARTING
            actor.worker_addr = None
            self.record_cluster_event(
                "WARNING", "gcs",
                f"actor restarting ({reason})",
                actor_id=actor.actor_id.hex(),
                restarts_used=actor.restarts_used,
            )
            await self.publish(
                f"actor:{actor.actor_id.hex()}", {"state": ACTOR_RESTARTING}
            )
            asyncio.get_running_loop().create_task(self._restart_actor(actor, reason))
        else:
            await self._kill_actor(actor, reason, no_restart=True)

    async def _restart_actor(self, actor: ActorEntry, reason: str):
        self._mark_dirty()
        """GCS-driven actor restart: lease a fresh worker, replay creation."""
        try:
            demand = ResourceSet(actor.resources)
            grant = None
            if actor.scheduling.get("type") == "placement_group":
                # A gang actor restarts into its own bundle (which may
                # itself be rescheduling after the node death).
                pg = self.placement_groups.get(
                    PlacementGroupID.from_hex(actor.scheduling["pg_id"])
                )
                if pg is None:
                    raise rpc.RpcError("actor's placement group not found")
                idx = actor.scheduling.get("bundle_index", -1)
                cands = self._pg_bundle_candidates(pg, idx, demand)
                while grant is None:
                    if pg.state == PG_REMOVED:
                        raise rpc.RpcError(
                            "actor's placement group was removed"
                        )
                    grant = await self._try_grant_pg_lease(
                        pg, cands, demand, _GCS_SELF_CONN,
                        {
                            "actor_id": actor.actor_id.binary(),
                            "runtime_env": getattr(
                                actor, "runtime_env", None
                            ),
                        },
                    )
                    if grant is None:
                        await self._pg_state_wait(pg.pg_id, 5.0)
            else:
                while True:
                    node = self.scheduler.pick_node(demand, actor.scheduling)
                    if node is not None and node.resources_available.covers(
                        demand
                    ):
                        break
                    fut = asyncio.get_running_loop().create_future()
                    self.scheduler.pending.append(
                        PendingLease(fut, demand, actor.scheduling,
                                     actor_id=actor.actor_id,
                                     client_conn=_GCS_SELF_CONN)
                    )
                    await fut
                grant = await self._grant_lease(
                    node, demand, _GCS_SELF_CONN,
                    {
                        "actor_id": actor.actor_id.binary(),
                        "runtime_env": getattr(actor, "runtime_env", None),
                    },
                )
            worker_conn = None
            deadline = time.monotonic() + cfg.worker_start_timeout_s
            wid = WorkerID(grant["worker_id"])
            while time.monotonic() < deadline:
                worker_conn = self._worker_conns.get(wid)
                if worker_conn:
                    break
                await asyncio.sleep(0.02)
            if worker_conn is None:
                raise rpc.RpcError("restarted worker never registered with GCS")
            # graceful-drain handoff: a checkpoint blob (and collective
            # group memberships) parked in the KV rides the creation
            # replay — the worker restores state after __init__
            create_payload = {
                "actor_id": actor.actor_id.binary(),
                "creation_spec": actor.creation_spec,
                "accelerator_env": grant.get("accelerator_env", {}),
            }
            ck_raw = self.kv.get(self._ckpt_key(actor.actor_id))
            if ck_raw is not None:
                import pickle

                try:
                    ck = pickle.loads(ck_raw)
                    create_payload["checkpoint"] = ck.get("blob")
                    create_payload["checkpoint_ref"] = ck.get("blob_ref")
                    create_payload["collective_groups"] = ck.get(
                        "groups") or []
                except Exception:
                    logger.exception("bad actor checkpoint record dropped")
            # No fixed deadline on __init__ replay — liveness comes from the
            # worker: its death breaks the duplex conn and fails this call.
            await worker_conn.call("create_actor", create_payload, timeout=-1)
            await self._drop_actor_ckpt(actor.actor_id)
            actor.state = ACTOR_ALIVE
            actor.worker_addr = grant["worker_addr"]
            actor.node_id = NodeID.from_hex(grant["node_id"])
            actor.lease_id = grant["lease_id"]
            lease = self.leases.get(actor.lease_id)
            if lease:
                lease.actor_id = actor.actor_id
            await self.publish(
                f"actor:{actor.actor_id.hex()}",
                {"state": ACTOR_ALIVE, "worker_addr": actor.worker_addr},
            )
        except Exception as e:
            logger.exception("actor restart failed")
            await self._kill_actor(actor, f"restart failed: {e}", no_restart=True)

    async def rpc_worker_died(self, conn, p):
        """Raylet reports a worker process exited."""
        if p.get("node_id") is not None and p.get("incarnation") is not None:
            # a zombie's death report must not break its replacement's
            # state (notify: swallow instead of raise)
            try:
                self._check_node_fence(
                    NodeID(p["node_id"]), p["incarnation"]
                )
            except FencedError:
                return False
        wid = WorkerID(p["worker_id"])
        # keep a bounded trail of death reasons so drivers can enrich
        # their WorkerCrashedError (e.g. "killed by the memory monitor")
        self._worker_death_reasons[wid.binary()] = p.get("reason") or ""
        while len(self._worker_death_reasons) > 1000:
            self._worker_death_reasons.pop(
                next(iter(self._worker_death_reasons))
            )
        reason = p.get("reason") or ""
        if "memory monitor" in reason:
            self.record_cluster_event(
                "WARNING", "memory_monitor", reason,
                worker_id=wid.hex(),
            )
        self._worker_conns.pop(wid, None)
        self._scrub_holder(wid.binary())
        for lease_id, lease in list(self.leases.items()):
            if lease.worker_id == wid:
                actor_id = lease.actor_id
                await self._release_lease(lease_id, broken=True)
                if actor_id:
                    actor = self.actors.get(actor_id)
                    if actor and actor.state in (ACTOR_ALIVE, ACTOR_PENDING):
                        await self._maybe_restart_actor(
                            actor, f"worker died: {p.get('reason', 'unknown')}"
                        )
        return True

    async def rpc_get_worker_death_info(self, conn, p):
        return {
            "reason": self._worker_death_reasons.get(p["worker_id"], "")
        }

    async def rpc_list_actors(self, conn, p):
        return [
            {
                "actor_id": a.actor_id.hex(),
                "name": a.name,
                "state": a.state,
                "node_id": a.node_id.hex() if a.node_id else None,
                "resources": a.resources,
                "restarts_used": a.restarts_used,
            }
            for a in self.actors.values()
        ]

    async def rpc_node_health(self, conn, p):
        """Health-plane observability: per-node suspicion level, silence,
        and incarnation (what the dashboard/tests/bench read instead of
        groping NodeEntry internals)."""
        now = time.monotonic()
        out = {}
        for nid, n in self.nodes.items():
            det = self.node_health.get(nid)
            out[nid.hex()] = {
                "alive": n.alive and n.conn is not None,
                "suspect": n.suspect,
                "incarnation": n.incarnation,
                "phi": det.phi(now) if det is not None else None,
                "silent_s": now - n.last_heartbeat,
                "mean_interval_s": det.mean() if det is not None else None,
                "samples": len(det._intervals) if det is not None else 0,
            }
        return out

    async def rpc_ping(self, conn, p):
        return {"time": time.time(), "uptime": time.time() - self._start_time}


class _SelfConn:
    """Placeholder 'connection' for GCS-originated leases (actor restarts)."""

    closed = False


_GCS_SELF_CONN: Any = _SelfConn()


# --------------------------------------------------------------------------
# Entrypoint (run as the head's GCS process)
# --------------------------------------------------------------------------


def main():
    import argparse
    import sys

    ap = argparse.ArgumentParser()
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--session-dir", default=None,
                    help="enables checkpoint persistence / restart recovery")
    args = ap.parse_args()

    logging.basicConfig(level=logging.INFO,
                        format="[gcs] %(levelname)s %(message)s")

    # partition plane: this process IS the control-plane endpoint
    from ray_tpu_torch.common import faults as _faults

    _faults.set_local_endpoint("gcs")

    # SIGUSR1 → dump all thread stacks to stderr (the gcs log): the
    # zero-dependency "where is it stuck" probe
    import faulthandler
    import signal as _sig

    faulthandler.register(_sig.SIGUSR1)

    prof_dir = os.environ.get("RT_PROFILE_DIR")
    if prof_dir:
        # dev profiling (see util/profiling.py): capture the whole server
        # loop; SIGTERM (the normal teardown signal) dumps the stats
        import cProfile
        import signal

        prof = cProfile.Profile()
        path = os.path.join(prof_dir, f"gcs-{os.getpid()}.pstats")

        def _term(_sig, _frm):
            prof.disable()
            prof.dump_stats(path)
            sys.exit(0)

        signal.signal(signal.SIGTERM, _term)
        prof.enable()

    async def run():
        gcs = GcsServer(
            host=args.host, port=args.port, session_dir=args.session_dir
        )
        await gcs.start()
        # report the bound address to the parent on stdout
        print(f"GCS_ADDRESS={gcs.address}", flush=True)
        await asyncio.Event().wait()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        sys.exit(0)


if __name__ == "__main__":
    main()
