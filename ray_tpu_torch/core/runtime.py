"""The in-process runtime: task submission, object resolution, actor calls.

Role-equivalent of the reference's CoreWorker (ray:
src/ray/core_worker/core_worker.h:292 — SubmitTask:2128, Get:1523,
SubmitActorTask:2438) plus the client half of its direct task transport
(direct_task_transport.h:75).  Runs inside every driver and worker process:
an asyncio loop on a background thread owns all connections (GCS, local
raylet, peer workers); the public API is synchronous and bridges in via
run_coroutine_threadsafe.

Scheduling fast path: leases are requested from the GCS per scheduling class
and *reused* across tasks with a short idle grace, so a steady stream of
tasks costs one GCS round-trip per worker, not per task (ray:
direct_task_transport.cc lease reuse + pipelining analogue).
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import os
import threading
import weakref
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle

from ray_tpu_torch._native.store import (
    ObjectExistsError,
    ShmStore,
    StoreError,
    StoreFullError,
)
from ray_tpu_torch.common.backoff import Backoff, BackoffPolicy
from ray_tpu_torch.common.config import cfg
from ray_tpu_torch.common.ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    TaskID,
    WorkerID,
    task_return_binary,
)
from ray_tpu_torch.common import serialization as ser
from ray_tpu_torch.core import rpc
from ray_tpu_torch.core.errors import (
    ActorDiedError,
    GetTimeoutError,
    ObjectLostError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.util import tracing

logger = logging.getLogger(__name__)

_global_runtime: Optional["Runtime"] = None
_init_lock = threading.Lock()


def get_runtime() -> "Runtime":
    if _global_runtime is None:
        raise RuntimeError("ray_tpu_torch is not initialized; call ray_tpu_torch.init() first")
    return _global_runtime


def set_runtime(rt: Optional["Runtime"]):
    global _global_runtime
    _global_runtime = rt


# --------------------------------------------------------------------------
# Lease management (client side of scheduling)
# --------------------------------------------------------------------------


@dataclass
class Lease:
    lease_id: int
    worker_addr: str
    worker_id: bytes
    node_id: str
    conn: rpc.Connection
    inflight: int = 0
    broken: bool = False
    draining: bool = False  # a drain-then-pump task is in flight


@dataclass(slots=True)
class PendingTask:
    spec: Any  # wire spec dict; None for compact template-path tasks
    return_ids: Any  # tuple/list of return oid bytes
    retries_left: int
    sub_idx: int = 0  # per-actor submission order (client-side)
    dep_oids: Any = ()  # oids held while in flight (list, or shared ())
    # scheduling-class routing for NORMAL tasks (None for actor tasks):
    # carried on the task so the coalesced submit queue and lineage need
    # no per-call argument tuples
    class_key: Any = None
    resources: Any = None
    strategy: Any = None
    # reply routing (assigned at dispatch; rt/st/conn live on the task's
    # slots so the done-callback is ONE bound method instead of a
    # closure + cells per call).  st is the ActorClientState for actor
    # pushes and the Lease for normal-task pushes.
    rt: Any = None
    st: Any = None
    conn: Any = None
    # Compact template path (data plane v2): the immutable skeleton lives
    # on the TaskTemplate and ships to each worker once per connection;
    # per-call state is just (task_id, args, job) and the wire carries a
    # tuple — the driver never copies the spec dict per call.  ``spec``
    # stays None unless the call needs the full-dict form (streaming,
    # tracing, actor tasks, untemplated submits).
    tmpl: Any = None
    task_id: bytes = b""
    args: Any = ()
    job: Any = None
    streaming: bool = False
    # Slotted lineage record fields: the PendingTask itself IS the lineage
    # record (reference analogue of task_manager.h lineage entries) — no
    # per-task entry dict, no live-returns set; liveness is a bitmask over
    # return_ids positions and the budget rides two int slots.
    lineage_budget: int = 0
    live_mask: int = 0
    recon_inflight: bool = False

    def name(self) -> str:
        if self.tmpl is not None:
            return self.tmpl.skeleton["name"]
        s = self.spec
        return s.get("name") or s.get("method", "") if s else ""

    def on_push_reply(self, fut):
        self.rt._on_push_reply(self.st, self.conn, self, fut)

    def on_task_reply(self, fut):
        self.rt._on_task_push_reply(self, fut)


class _LineageSlots:
    """Slotted lineage store (data plane v2): a preallocated array of
    slots keyed by task-id low bits, with an overflow dict for slot
    collisions.  Records are the PendingTask objects themselves — already
    allocated for submission and reused here, so recording lineage for a
    task costs zero container allocations (v1 paid a 9-key dict + a
    live-returns set per call, the dominant term in the ~25 allocs/call
    normal-task driver path)."""

    __slots__ = ("_mask", "_slots", "_overflow")

    def __init__(self, n_slots: int = 1024):
        assert n_slots & (n_slots - 1) == 0
        self._mask = n_slots - 1
        self._slots: list = [None] * n_slots
        self._overflow: Dict[bytes, Any] = {}

    def insert(self, rec) -> None:
        tid = rec.task_id
        i = (tid[0] | (tid[1] << 8)) & self._mask
        if self._slots[i] is None:
            self._slots[i] = rec
        else:
            self._overflow[tid] = rec

    def get(self, tid: bytes):
        rec = self._slots[(tid[0] | (tid[1] << 8)) & self._mask]
        if rec is not None and rec.task_id == tid:
            return rec
        return self._overflow.get(tid)

    def remove(self, tid: bytes) -> None:
        i = (tid[0] | (tid[1] << 8)) & self._mask
        rec = self._slots[i]
        if rec is not None and rec.task_id == tid:
            self._slots[i] = None
            return
        self._overflow.pop(tid, None)

    def __len__(self) -> int:  # tests/diagnostics
        return sum(1 for r in self._slots if r is not None) + len(
            self._overflow
        )


@dataclass
class ActorClientState:
    """Client half of ordered actor-call transport (reference analogue:
    CoreWorkerDirectActorTaskSubmitter, direct_actor_task_submitter.h:74).

    Wire sequence numbers are assigned per CONNECTION EPOCH: each
    (re)connect bumps `epoch` and restarts `wire_seq` at 0, and unacked
    calls are re-pushed in original submission order — so the server can
    enforce exact per-caller ordering even across reconnects/restarts."""

    queue: Any = None  # deque[PendingTask] in submission order
    inflight: Dict[int, PendingTask] = field(default_factory=dict)  # sub_idx→task
    epoch: int = -1  # bumped to 0 on first connect
    wire_seq: int = 0
    conn: Any = None
    wake: Any = None  # asyncio.Event
    pump_running: bool = False
    dead: bool = False  # actor creation failed / actor died — pump exits
    draining: bool = False  # pump is parked mid-drain waiting for inflight


class TaskTemplate:
    """Pre-computed, immutable submission state for one RemoteFunction
    option-set (reference analogue: the cached TaskSpec prelude ray
    builds once per function descriptor).  Everything that is identical
    across `.remote()` calls — function hash, validated resources,
    scheduling class key, runtime-env descriptor, the spec skeleton
    dict — is computed once at first submit; each call then only fills
    task/object ids and args.  Treat every field as frozen.  ``rt`` is a
    weakref: the template is cached on long-lived RemoteFunction objects
    and must not keep a shut-down Runtime (loop, stores, futures) alive
    across init/shutdown cycles — callers deref it purely as the
    staleness check."""

    __slots__ = (
        "rt", "skeleton", "class_key", "resources", "strategy",
        "num_returns", "streaming", "max_retries", "fill_job", "tpl_id",
    )

    def __init__(self, rt, skeleton, class_key, resources, strategy,
                 num_returns, streaming, max_retries, fill_job):
        self.rt = weakref.ref(rt)
        self.skeleton = skeleton
        self.class_key = class_key
        self.resources = resources
        self.strategy = strategy
        self.num_returns = num_returns
        self.streaming = streaming
        self.max_retries = max_retries
        self.fill_job = fill_job
        # wire identity for the compact push path: the skeleton ships to
        # each worker connection once under this id; subsequent pushes
        # carry only (tpl_id, task_id, args, job)
        self.tpl_id = os.urandom(8)


_sched_class_tags = iter(range(1, 1 << 62))


class SchedClassState:
    def __init__(self):
        # deque: the pump pops from the front at pipeline depth — a list
        # pop(0) is O(queue) and turns a deep windowed burst quadratic
        self.queue: deque = deque()
        self.leases: List[Lease] = []
        self.requests_inflight = 0
        self.idle_timer: Optional[asyncio.TimerHandle] = None
        # wire id for cancel_lease_requests (parked requests at the GCS
        # are cancelled by (client conn, tag) when local demand drains)
        self.tag = next(_sched_class_tags)
        self.cancel_sent = False


# --------------------------------------------------------------------------
# Runtime
# --------------------------------------------------------------------------


_PENDING_RESULT = object()  # lazy marker: locally-pending result, no async waiter yet


def _ignore_pubsub(msg):
    """Placeholder callback holding the "nodes" channel slot: the
    runtime's internal node-event hook runs in _gcs_handler regardless
    of which user callback (if any) owns the slot."""


def lease_pending_backoff() -> Backoff:
    """Backoff between LEASE_PENDING re-requests.  The request_lease
    call itself parks at the GCS until woken or expired, so this sleep
    exists only to DE-CORRELATE re-requests across classes/callers —
    capped well under the grant cadence (a 2 s tail here would idle
    freed capacity).  Shared by both lease loops and sched_bench."""
    return Backoff(BackoffPolicy(
        base_s=cfg.backoff_base_s, mult=cfg.backoff_mult,
        max_s=0.25, jitter_frac=cfg.backoff_jitter_frac,
    ))


class Runtime:
    def __init__(
        self,
        gcs_address: str,
        node_id: str,
        raylet_address: str,
        store_path: str,
        mode: str = "driver",
        worker_id: Optional[WorkerID] = None,
        job_id: Optional[JobID] = None,
    ):
        self.gcs_address = gcs_address
        self.node_id = node_id
        self.raylet_address = raylet_address
        self.mode = mode
        self.worker_id = worker_id or WorkerID.random()
        self.job_id = job_id
        self.actor_id: Optional[ActorID] = None  # set when this worker hosts one

        self._loop = asyncio.new_event_loop()
        # eager tasks (3.12+): create_task runs the coroutine synchronously
        # up to its first await, removing one loop wakeup from every
        # dispatch hop (submit→push, reply fan-out) — worth ~10% on the
        # actor-call round-trip
        try:
            self._loop.set_task_factory(asyncio.eager_task_factory)
        except AttributeError:
            pass
        self._thread = threading.Thread(
            target=self._loop.run_forever, name="rt-io", daemon=True
        )
        self._thread.start()
        from ray_tpu_torch.util.profiling import maybe_enable_loop_profile

        maybe_enable_loop_profile(self._loop, mode)

        self.store = ShmStore(store_path)
        self._zerocopy_threshold = cfg.zerocopy_get_min_bytes
        self.gcs: Optional[rpc.Connection] = None
        self.raylet: Optional[rpc.Connection] = None

        # local object state
        self.memory_store: Dict[bytes, Any] = {}
        self.result_futures: Dict[bytes, asyncio.Future] = {}
        # caller threads parked in get()'s fast path, keyed by oid; the
        # reply applier signals them directly, skipping the
        # run_coroutine_threadsafe round trip (see _try_sync_get).  The
        # lock serializes caller-thread register/drop (the io-loop signal
        # path pops atomically and never takes it).
        # oid -> Event (single waiter) or list of Events (contended)
        self._sync_waiters: Dict[bytes, Any] = {}
        self._sync_reg_lock = threading.Lock()
        self._sync_get_tls = threading.local()  # reusable wait Event
        self._shared: set = set()  # oids known to be in shm + registered
        self._escaped: set = set()  # refs passed on before their task finished

        # streaming generator tasks by task_id (reference:
        # ObjectRefGenerator, python/ray/_raylet.pyx:273): items arrive as
        # stream_item notifies on the worker connection and are buffered
        # here until the consumer's next()
        self._streams: Dict[bytes, "_StreamBuf"] = {}
        # abandoned stream -> consumed-upto index; the closing reply frees
        # the producer-stored items the consumer never took
        self._abandoned_streams: Dict[bytes, int] = {}

        # scheduling
        self._classes: Dict[tuple, SchedClassState] = {}
        self._worker_conns: Dict[str, rpc.Connection] = {}
        self._put_index = 0

        # caller-thread submission coalescing: tasks submitted between
        # two io-loop ticks ride ONE call_soon_threadsafe wakeup (the
        # per-call Handle + args tuple + context copy was a measurable
        # slice of submission churn).  deque ops are GIL-atomic; the
        # flag protocol (drainer clears BEFORE draining, submitters
        # schedule only on a False read) cannot miss a wakeup.
        self._submit_q: deque = deque()
        self._submit_q_scheduled = False

        # flush-window GCS notifications: object-directory notifies
        # (add_object_location / ref_edge / ref_update / free_objects)
        # buffer here and go out as one object_notify_batch rpc — per
        # tick for urgent events, per gcs_notify_flush_window_s for
        # windowed ones.  Ref export and local get-miss flush eagerly,
        # so cross-process visibility semantics are unchanged.
        self._gcs_nbuf: list = []
        self._gcs_nbuf_lock = threading.Lock()
        self._gcs_nbuf_mode: Optional[str] = None  # None | "timer" | "soon"

        # actors (client side)
        self._actor_conns: Dict[bytes, rpc.Connection] = {}
        self._actor_addrs: Dict[bytes, str] = {}
        self._actor_seq: Dict[bytes, int] = {}
        self._actor_states: Dict[bytes, ActorClientState] = {}

        # in-flight dispatch registry for cancellation: first return oid ->
        # (task_id, conn carrying the running call)
        self._inflight_dispatch: Dict[bytes, tuple] = {}
        self._cancel_requested: set = set()  # oids cancelled pre-enqueue

        # function cache (worker side)
        self._fn_cache: Dict[bytes, Any] = {}
        # id(fn) -> (weakref(fn), hash): submit-path memo (see
        # fn_hash_and_register)
        self._fn_hash_memo: Dict[int, tuple] = {}

        # ---- distributed refcounting (reference analogue:
        # core_worker/reference_count.h:61, collapsed to a GCS-tracked
        # holder set per object; this process reports itself as a holder
        # while any local ObjectRef instance or in-flight task arg needs
        # the object, with events batched per flush window) ----
        self._ref_lock = threading.Lock()
        self._local_refs: Dict[bytes, int] = {}   # live ObjectRef instances
        self._task_holds: Dict[bytes, int] = {}   # held as in-flight task deps
        self._ref_registered: set = set()         # ref_add sent (or pending)
        self._pending_ref_add: set = set()
        self._pending_ref_del: set = set()
        # adds skipped at flush time because the value was a LOCAL-ONLY
        # inline result (nothing cluster-side to keep alive); promotion
        # via ensure_shared re-registers (see _flush_ref_events)
        self._deferred_reg: set = set()
        self._ref_flush_scheduled = False

        # ---- lineage (reference analogue: task_manager.h:208 lineage +
        # object_recovery_manager.h:41): keep resubmittable tasks while
        # any of their return refs live, so a lost object re-executes its
        # producing task.  Slotted store: records are the PendingTask
        # objects themselves (see _LineageSlots) ----
        self._lineage = _LineageSlots()
        self._lineage_by_return: Dict[bytes, Any] = {}  # oid -> record
        # lineage re-executions started by this process — the drain
        # plane's "zero reconstructions" acceptance counter
        self.reconstructions = 0

        # subsystem RPC methods: method name -> async handler(conn, payload).
        # Libraries (util.collective is the first) claim a method name and
        # receive every inbound request/notify for it, whichever channel it
        # arrived on — the worker's server or a caller→worker connection.
        self._rpc_subhandlers: Dict[str, Any] = {}
        # peer-connection lifecycle observers: callback(conn) fired on the
        # io loop when any worker-peer connection (dialed or accepted)
        # closes — the liveness signal group-membership code keys off
        self._peer_close_watchers: List[Any] = []

        # pubsub: channel -> callback (driver log streaming rides this)
        self._subscriptions: Dict[str, Any] = {}
        # job attribution for log streaming: drivers use job_id; workers
        # learn it from executed task specs (nested submissions inherit)
        self._current_job_hex: Optional[str] = None
        self._serialization = ser.SerializationContext()
        self._serialization.register_reducer(ObjectRef, self._reduce_ref)
        self._nested_ref_sink = threading.local()
        self._class_runtime_envs: Dict[Any, dict] = {}
        # timeline: bounded ring of task lifecycle events for
        # api.timeline() (ray: ray.timeline / chrome-trace export role).
        # Stored as compact tuples (phase, name, task_id, ts, pid, extra)
        # — the per-call event dict was measurable churn on the task
        # submission path; timeline() rebuilds the dict view on read.
        self._timeline = deque(maxlen=cfg.timeline_max_events)
        self._pid = os.getpid()
        self._closed = False

    def record_event(self, phase: str, name: str, task_id_hex: str,
                     **extra) -> None:
        self._timeline.append(
            (phase, name, task_id_hex, time.time(), self._pid,
             extra or None)
        )

    def _record_exec(self, name: str, task_id_hex: str, worker: str,
                     start: float, dur: float) -> None:
        """kwargs-free twin of record_event for the per-reply exec span
        (the **extra dict per call was pure hot-path churn)."""
        self._timeline.append(
            ("exec", name, task_id_hex, time.time(), self._pid,
             (worker, start, dur))
        )

    def timeline(self) -> list:
        """Chrome-trace-style task lifecycle events recorded by this
        process (submit/start/end with worker-side execution spans)."""
        out = []
        for phase, name, tid, ts, pid, extra in list(self._timeline):
            ev = dict(phase=phase, name=name, task_id=tid, ts=ts, pid=pid)
            if extra is not None:
                if type(extra) is tuple:  # exec-span compact extras
                    ev["worker"], ev["start"], ev["dur"] = extra
                else:
                    ev.update(extra)
            out.append(ev)
        return out

    def _normalize_runtime_env(self, env: Optional[dict]) -> Optional[dict]:
        """Package + upload a runtime_env once; returns the descriptor."""
        if not env:
            return None
        from ray_tpu_torch.core import runtime_env as rtenv_mod

        def kv_put(sha, value):
            if threading.current_thread() is self._thread:
                raise RuntimeError(
                    "runtime_env with working_dir/py_modules cannot be "
                    "packaged from inside an async actor method; submit "
                    "from a sync context"
                )
            self._run(
                self.gcs.call("put_blob", {"sha": sha, "data": value})
            )

        return rtenv_mod.normalize(env, kv_put, scope=self.gcs_address)

    # ---- loop bridging -------------------------------------------------
    def _run(self, coro, timeout: Optional[float] = None):
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        try:
            return fut.result(timeout)
        except TimeoutError:
            fut.cancel()
            raise

    def _spawn(self, coro):
        """Fire-and-forget a coroutine on the io loop from any thread.
        Connection loss is swallowed (fire-and-forget messages racing
        shutdown are expected)."""

        async def _quiet():
            try:
                await coro
            except (rpc.ConnectionLost, rpc.RpcError):
                pass

        if threading.current_thread() is self._thread:
            self._loop.create_task(_quiet())
        else:
            asyncio.run_coroutine_threadsafe(_quiet(), self._loop)

    # ---- startup -------------------------------------------------------
    def connect(self):
        self._run(self._connect(), timeout=cfg.rpc_connect_timeout_s + 5)

    async def _connect(self):
        # partition plane: drivers and workers share their node's
        # logical endpoint (first writer wins — worker_main labels
        # worker processes before this runs)
        from ray_tpu_torch.common import faults as _faults

        _faults.set_local_endpoint(self.node_id)
        # Reconnecting channel: survives GCS restarts (the GCS restores
        # its tables from the checkpoint; we re-register our identity).
        self.gcs = rpc.ReconnectingConnection(
            self.gcs_address, self._gcs_handler, name=f"{self.mode}->gcs",
            on_reconnect=self._reattach_gcs,
            peer_endpoint="gcs",
        )
        self.raylet = await rpc.connect(
            self.raylet_address, name=f"{self.mode}->raylet",
            peer_endpoint=self.node_id,
        )
        await self.gcs.call(
            "register_worker",
            {"worker_id": self.worker_id.binary(), "node_id": self.node_id},
        )
        # node-event subscription (health plane): a "dead" event closes
        # our conns to that node's workers.  Under a silent partition a
        # TCP conn to a dead node never breaks on its own — pushes would
        # blackhole forever — and after the partition HEALS, a stale
        # conn could reach a zombie worker the GCS already replaced
        # (split-brain).  The GCS's death verdict is the authority;
        # closing the conn routes the actor pump through get_actor to
        # the replacement.  setdefault: a user subscribe("nodes") (the
        # serve controller) replaces the callback, not the subscription;
        # _gcs_handler runs our internal hook regardless.
        self._subscriptions.setdefault("nodes", _ignore_pubsub)
        await self.gcs.call("subscribe", {"channel": "nodes"})
        if self.mode == "driver":
            reply = await self.gcs.call("register_job", {"pid": os.getpid()})
            self.job_id = JobID(reply["job_id"])
        self._metrics_task = self._loop.create_task(self._metrics_push_loop())

    async def _metrics_push_loop(self):
        """Ship this process's util.metrics registry to the GCS
        periodically (ray: stats exporter role)."""
        from ray_tpu_torch.util import metrics as metrics_mod

        while not self._closed:
            await asyncio.sleep(cfg.metrics_push_interval_s)
            snap = metrics_mod.registry_snapshot()
            if not snap:
                continue
            try:
                await self.gcs.notify(
                    "metrics_push",
                    {"reporter": self.worker_id.hex(), "metrics": snap},
                )
            except Exception:
                pass

    async def _reattach_gcs(self, conn):
        await conn.call(
            "register_worker",
            {"worker_id": self.worker_id.binary(), "node_id": self.node_id},
        )
        self._subscriptions.setdefault("nodes", _ignore_pubsub)
        if self.mode == "driver" and self.job_id is not None:
            await conn.call(
                "register_job",
                {"pid": os.getpid(), "job_id": self.job_id.binary()},
            )
        for channel in list(self._subscriptions):
            await conn.call("subscribe", {"channel": channel})

    def _on_node_event_internal(self, msg: dict) -> None:
        """io-loop hook for GCS "nodes" events: when a node is declared
        DEAD, close every cached conn labeled with it.  The close fails
        pending pushes with ConnectionLost, so the actor pump requeues
        and re-resolves through get_actor — landing on the restarted
        actor instead of blackholing into (or, post-heal, split-braining
        with) the dead node's zombie workers."""
        if msg.get("event") != "dead":
            return
        nid = msg.get("node_id")
        if not nid:
            return
        for aid, conn in list(self._actor_conns.items()):
            if conn.peer_endpoint == nid and not conn.closed:
                self._actor_conns.pop(aid, None)
                self._loop.create_task(conn.close())
        for addr, conn in list(self._worker_conns.items()):
            if conn.peer_endpoint == nid and not conn.closed:
                self._loop.create_task(conn.close())

    def _job_hex(self) -> Optional[str]:
        """Job attribution for specs: the driver's own job, or (in a
        worker) the job of the task that last ran here."""
        if self.job_id is not None:
            return self.job_id.hex()
        return self._current_job_hex

    def subscribe(self, channel: str, callback) -> None:
        """Register a pubsub callback (runs on the io loop) and subscribe
        at the GCS; survives GCS restarts via _reattach_gcs."""
        self._subscriptions[channel] = callback
        self._run(self.gcs.call("subscribe", {"channel": channel}))

    async def subscribe_async(self, channel: str, callback) -> None:
        """Loop-native twin of subscribe() for callers already ON the io
        loop (an actor's async method — e.g. the serve proxies
        subscribing to route-version bumps); `_run` from the loop would
        deadlock."""
        self._subscriptions[channel] = callback
        await self.gcs.call("subscribe", {"channel": channel})

    def publish(self, channel: str, message: dict) -> None:
        """Fire-and-forget publish from any thread."""
        self._spawn(
            self.gcs.notify("publish", {"channel": channel, "message": message})
        )

    async def _gcs_handler(self, conn, method, payload):
        # GCS-initiated pushes (actor restarts target workers; pubsub)
        if method == "publish":
            if payload.get("channel") == "nodes":
                # internal health-plane hook, independent of whatever
                # user callback holds the channel slot
                try:
                    self._on_node_event_internal(payload["message"])
                except Exception:
                    logger.exception("node-event hook failed")
            cb = self._subscriptions.get(payload.get("channel"))
            if cb is not None:
                try:
                    cb(payload["message"])
                except Exception:
                    logger.exception(
                        "pubsub callback for %r failed", payload.get("channel")
                    )
            return True
        if method == "exit_worker":
            logger.info("worker told to exit: %s", payload.get("reason"))
            threading.Thread(target=_delayed_exit, daemon=True).start()
            return True
        if method == "create_actor" and self._worker_server is not None:
            return await self._worker_server.handle_create_actor(payload)
        if method == "checkpoint_actor" and self._worker_server is not None:
            return await self._worker_server.handle_checkpoint_actor(payload)
        if method == "checkpoint_abort" and self._worker_server is not None:
            return await self._worker_server.handle_checkpoint_abort()
        if method == "dump_stacks" and self._worker_server is not None:
            return await self._worker_server._handle(conn, "dump_stacks",
                                                     payload)
        raise rpc.RpcError(f"unexpected GCS push {method!r}")

    _worker_server = None  # set by worker_main for GCS-initiated actor creation

    def shutdown(self):
        if self._closed:
            return
        self._closed = True

        async def _close():
            # windowed object notifies (announces, frees) must not die in
            # the buffer — other processes may hold refs to the objects
            self._flush_gcs_notify()
            t = getattr(self, "_metrics_task", None)
            if t is not None:
                t.cancel()
            # resident actor pumps park on their wake events; release
            # them cleanly instead of tearing the loop down under them
            for st in self._actor_states.values():
                st.dead = True
                if st.wake is not None:
                    st.wake.set()
            await asyncio.sleep(0)
            for c in list(self._worker_conns.values()):
                await c.close()
            for c in list(self._actor_conns.values()):
                await c.close()
            if self.gcs:
                await self.gcs.close()
            if self.raylet:
                await self.raylet.close()
            # let cancelled recv loops finalize before the loop stops
            await asyncio.sleep(0.05)

        try:
            self._run(_close(), timeout=5)
        except Exception:
            pass
        from ray_tpu_torch.util.profiling import dump_profile

        dump_profile()
        self.store.close()
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=2)
        set_runtime(None)

    # ---- serialization with ref promotion ------------------------------
    def _reduce_ref(self, ref: ObjectRef):
        """Custom reducer: a ref escaping this process must be resolvable
        anywhere → promote its value to the shared store first."""
        self.ensure_shared(ref.object_id)
        sink = getattr(self._nested_ref_sink, "sink", None)
        if sink is not None:
            sink.append(ref.object_id.binary())
        return (ObjectRef, (ref.object_id, self.node_id))

    def _serialize_tracked(self, value):
        """Serialize, collecting any ObjectRefs nested inside the value —
        the caller registers parent→child edges with the GCS so a stored
        object keeps its borrowed children alive (reference: borrowing,
        reference_count.h — collapsed to GCS-tracked object→object pins)."""
        sink: List[bytes] = []
        self._nested_ref_sink.sink = sink
        try:
            s = self._serialization.serialize(value)
        finally:
            self._nested_ref_sink.sink = None
        return s, sink

    def _register_edges(self, parent_oid: bytes, children: List[bytes]):
        if children and self.gcs and not self.gcs.closed:
            self._gcs_object_notify(
                "ref_edge", {"parent": parent_oid, "children": children}
            )

    def serialize(self, value) -> ser.SerializedObject:
        return self._serialization.serialize(value)

    def deserialize(self, data) -> Any:
        return self._serialization.deserialize(data)

    def _reregister_if_deferred(self, oid: bytes) -> None:
        """A ref whose GCS registration was skipped as local-only is
        escaping: register this process as holder after all."""
        with self._ref_lock:
            if oid in self._deferred_reg:
                self._deferred_reg.discard(oid)
                if (
                    self._local_refs.get(oid, 0) > 0
                    or self._task_holds.get(oid, 0) > 0
                ):
                    self._ref_registered.add(oid)
                    self._pending_ref_add.add(oid)
                    self._schedule_ref_flush()

    def ensure_shared(self, object_id: ObjectID) -> None:
        """Make the object resolvable cluster-wide (idempotent)."""
        oid = object_id.binary()
        # Escape-in-progress marker BEFORE the (possibly slow: spill
        # retries) promotion below: the ref flush must not classify this
        # oid as local-only mid-promotion and silently drop our holder
        # registration.  Ordered before _reregister_if_deferred so a
        # deferral that raced us earlier is cured and none can follow.
        self._escaped.add(oid)
        self._reregister_if_deferred(oid)
        # ref export: any windowed location announce (e.g. this object's
        # own put()) must be GCS-visible before the ref can reach a
        # process that would look it up
        self.flush_object_notifies()
        if oid in self._shared or self.store.contains(oid):
            self._shared.add(oid)
            return
        # The reply applier (io thread) can land the value and pop the result
        # future at any point between our checks — so check, mark, re-check.
        while True:
            if oid in self.memory_store:
                value = self.memory_store[oid]
                if not isinstance(value, _RaiseOnGet):
                    s, nested = self._serialize_tracked(value)
                    self._write_to_store(oid, s)
                    self._register_edges(oid, nested)
                return
            if oid in self._escaped:
                return  # marked; the reply applier will promote on arrival
            if oid in self.result_futures:
                # producing task still in flight from this process: promote
                # its result the moment the reply arrives (re-check in case
                # it landed while we marked)
                self._escaped.add(oid)
                continue
            if oid in self.memory_store:
                # the applier stores the value before popping the future, so
                # a futures-miss for an object of ours means the value is
                # here now — loop back to promote it
                continue
            # Not local: a borrowed ref whose value lives elsewhere already.
            self._shared.add(oid)
            return

    def _write_to_store(self, oid: bytes, s: ser.SerializedObject,
                        urgent_announce: bool = True) -> int:
        """Vectored single-pass put (data plane v2): reserve the arena
        allocation FIRST (exact size — the serialize pass already ran
        without touching payload bytes: large buffers ride the pickle5
        out-of-band protocol as views), then write header + metadata +
        payload buffers straight into the reservation.  Each payload byte
        is copied exactly once; no intermediate bytes is ever built
        (pinned by serialization.COPY_TRACE).  Small payloads land in the
        pre-faulted inline slab; commit() applies the primary-copy flag
        atomically with the seal/publish."""
        size = s.total_bytes
        try:
            buf = self._spill_retry(
                lambda: self.store.reserve(oid, size), size)
        except ObjectExistsError:
            self._shared.add(oid)
            return size
        try:
            s.write_into(buf)
        except BaseException:
            self.store.abort(oid)
            raise
        try:
            # primary copy: the protect flag lands atomically with the
            # seal/publish (seal2), so there is no window where a sealed
            # primary is LRU prey — spilling stays the only sanctioned
            # way out of the arena for a primary.  commit can ALSO hit a
            # packed arena (a slab publish whose shard sub-table is full
            # falls back to the evicting create path); the slab
            # reservation survives that failure, so it rides the same
            # spill-and-retry as reserve.
            self._spill_retry(
                lambda: self.store.commit(oid, protect=True), size)
        except ObjectExistsError:
            # a concurrent writer of the same oid won the publish race
            # (e.g. two threads promoting one escaped result); their copy
            # is the primary
            self._shared.add(oid)
            return size
        self._shared.add(oid)
        self._gcs_object_notify(
            "add_object_location",
            {
                "object_id": oid,
                "node_id": bytes.fromhex(self.node_id),
                "size": size,
            },
            urgent=urgent_announce,
        )
        return size

    def _spill_retry(self, attempt, size: int):
        """Run an arena write step, spilling and retrying on a packed
        arena (StoreFullError): give back any idle inline-slab slots,
        then ask the raylet to spill LRU primaries to disk and retry.
        Escalating requests ride out fragmentation (freed regions merge
        only when adjacent) and concurrent writers racing us to the freed
        space; the bounded patience window rides out a busy raylet whose
        spill pass (fsync per object) is slow under load — failing a task
        because disk IO lagged is worse than waiting.  Only caller/
        executor threads wait; the io loop (which cannot block) keeps the
        single-attempt behavior."""
        try:
            return attempt()
        except StoreFullError:
            self.store.shrink_slab()
            on_loop = threading.current_thread() is self._thread
            deadline = time.monotonic() + (0 if on_loop else 60.0)
            mult = 1  # exact size first: a near-arena-sized object must
            #           not escalate past capacity (the raylet clamps, but
            #           requesting precisely what fits spills the least)
            while True:
                requested = self._request_spill(size * mult,
                                                object_bytes=size)
                try:
                    return attempt()
                except StoreFullError:
                    if requested is None:
                        raise  # no raylet to ask: patience is futile
                    if time.monotonic() >= deadline:
                        raise
                    mult = min(mult + 1, 6)
                    time.sleep(0.25)

    def _request_spill(self, needed_bytes: int,
                       object_bytes: int = 0):
        """Ask our raylet to spill primaries so a create can proceed.

        Returns None when requesting is IMPOSSIBLE (no raylet, raylet
        gone, or called on the io loop, which must not block) — callers
        stop retrying; True/False report whether the pass freed bytes."""
        if self.raylet is None or getattr(self.raylet, "closed", True):
            return None
        if threading.current_thread() is self._thread:
            return None
        try:
            freed = self._run(
                self.raylet.call(
                    "spill_now",
                    {"needed_bytes": needed_bytes,
                     "object_bytes": object_bytes},
                ),
                timeout=30,
            )
            return bool(freed)
        except Exception:
            return None

    # ---- puts / gets ---------------------------------------------------
    def put(self, value) -> ObjectRef:
        self._put_index += 1
        object_id = ObjectID.for_put(self.worker_id, self._put_index)
        oid = object_id.binary()
        s, nested = self._serialize_tracked(value)
        # windowed announce: nothing cluster-side can look this oid up
        # until the ref escapes, and every escape path flushes the window
        self._write_to_store(oid, s, urgent_announce=False)
        self._register_edges(oid, nested)
        return ObjectRef(object_id, self.node_id)

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        if single:
            refs = [refs]
        for r in refs:
            if not isinstance(r, ObjectRef):
                raise TypeError(f"ray_tpu_torch.get expects ObjectRef(s), got {type(r)}")
        deadline = None if timeout is None else time.monotonic() + timeout
        # Fast path: locally-produced inline task results resolve on the
        # caller thread with a direct wakeup from the reply applier — no
        # coroutine scheduling, no extra io-loop iterations.  Any ref the
        # fast path can't serve (shm-stored, remote, reconstruction) drops
        # the remainder onto the full async path.
        out = []
        # reusable per-thread wait Event: a thread waits on one oid at a
        # time and always deregisters before moving on, so pure
        # memory-store hits never allocate and windowed gets share one
        ev = getattr(self._sync_get_tls, "ev", None)
        if ev is None:
            ev = self._sync_get_tls.ev = threading.Event()
        for r in refs:
            oid = r.object_id.binary()
            v = self._try_sync_get(oid, deadline, ev)
            if v is _SYNC_MISS:
                # local shm hit: read directly on the caller thread — the
                # arena is process-shared-mutex guarded, deserialize is
                # pure, so no io-loop round trip is needed (ray: plasma
                # client reads mmap'd objects without the core worker)
                if oid not in self.result_futures:
                    value, found = self._read_from_store(oid)
                    if found:
                        out.append(value)
                        continue
                break
            out.append(v)
        if len(out) < len(refs):
            out.extend(self._run(
                self._get_async(
                    [r.object_id.binary() for r in refs[len(out):]], deadline
                ),
                timeout=None,
            ))
        return out[0] if single else out

    def _try_sync_get(self, oid: bytes, deadline, ev=None):
        """Resolve a locally-produced inline task result without touching
        the io loop.  Lock-free: correctness rides on the reply applier's
        write order (value into memory_store BEFORE the result future is
        popped and waiters are signalled) plus a re-check after waiter
        registration, so a completion racing the registration can never
        strand the caller.  Returns _SYNC_MISS for anything that needs the
        shm store or a remote pull.  ``ev`` is an optional reusable wait
        Event (a windowed get would otherwise allocate one per ref)."""
        while True:
            if oid in self.memory_store:
                value = self.memory_store[oid]
                if isinstance(value, _RaiseOnGet):
                    raise value.exc
                return value
            if oid not in self.result_futures:
                return _SYNC_MISS
            if ev is None:
                ev = threading.Event()
            else:
                ev.clear()
            with self._sync_reg_lock:
                # single-waiter fast shape: the Event itself; upgraded
                # to a list only under contention on one oid
                cur = self._sync_waiters.get(oid)
                if cur is None:
                    self._sync_waiters[oid] = ev
                elif isinstance(cur, list):
                    cur.append(ev)
                else:
                    self._sync_waiters[oid] = [cur, ev]
            # re-check: the reply may have been applied between the checks
            # above and the registration, in which case its signal pass
            # could have missed our event
            if oid in self.memory_store or oid not in self.result_futures:
                self._drop_sync_waiter(oid, ev)
                continue
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                ok = False
            else:
                ok = ev.wait(remaining)
            self._drop_sync_waiter(oid, ev)
            if not ok:
                raise GetTimeoutError(
                    f"timed out waiting for {oid.hex()[:16]}"
                )

    def _drop_sync_waiter(self, oid: bytes, ev):
        with self._sync_reg_lock:
            ws = self._sync_waiters.get(oid)
            if ws is ev:
                # drop the empty entry (it would otherwise leak: the
                # one-shot signal for this oid may already have fired)
                self._sync_waiters.pop(oid, None)
            elif isinstance(ws, list):
                try:
                    ws.remove(ev)
                except ValueError:
                    pass
                if not ws:
                    self._sync_waiters.pop(oid, None)

    def _signal_sync_waiters(self, oid: bytes):
        ws = self._sync_waiters.pop(oid, None)
        if ws is None:
            return
        if isinstance(ws, list):
            # snapshot: a timed-out caller may remove() concurrently, and
            # iterating the live list under a remove can skip a waiter
            for ev in list(ws):
                ev.set()
        else:
            ws.set()

    # ---- streaming generator returns -----------------------------------
    # Reference: num_returns="streaming" + ObjectRefGenerator
    # (python/ray/_raylet.pyx:273, remote_function.py:343-349).  The
    # producing worker ships each yielded item as a `stream_item` notify
    # over the same duplex connection that carried the push; the final RPC
    # reply closes the stream with the item count.  Consumption acks feed
    # credit-based backpressure on the producer.

    async def _worker_inbound(self, conn, method: str, p: Any):
        """Inbound messages on caller->worker connections."""
        if method == "stream_item":
            self._deliver_stream_item(conn, p)
            return True
        sub = self._rpc_subhandlers.get(method)
        if sub is not None:
            return await sub(conn, p)
        raise rpc.RpcError(f"unexpected inbound {method!r} on worker conn")

    # ---- subsystem RPC + peer channels ---------------------------------
    def register_rpc_handler(self, method: str, handler) -> None:
        """Claim an RPC method name for a subsystem.  ``handler`` is an
        ``async (conn, payload) -> result`` invoked on the io loop for
        every inbound request/notify carrying that method (on the worker
        server and on caller→worker connections alike)."""
        existing = self._rpc_subhandlers.get(method)
        if existing is not None and existing is not handler:
            raise ValueError(f"rpc method {method!r} already registered")
        self._rpc_subhandlers[method] = handler

    def add_peer_close_watcher(self, cb) -> None:
        """Observe worker-peer connection closures (io loop callback)."""
        if cb not in self._peer_close_watchers:
            self._peer_close_watchers.append(cb)

    def _notify_peer_closed(self, conn) -> None:
        for cb in list(self._peer_close_watchers):
            try:
                cb(conn)
            except Exception:
                logger.exception("peer close watcher failed")

    async def peer_connection(self, addr: str) -> rpc.Connection:
        """Peer channel acquisition: a (cached) duplex connection to
        another worker's RPC server, usable from inside actors for
        direct worker↔worker traffic (the runtime-collective data
        plane).  Shares the cache with the task-dispatch path, so a
        collective group and a task stream to the same peer ride one
        TCP connection."""
        return await self._connect_worker(addr)

    async def peer_connection_to(self, addr: str,
                                 node_hex: Optional[str] = None):
        """peer_connection with the peer's node identity, so the conn is
        labeled for the partition plane (collective backends know their
        members' nodes; plain addr callers keep the unlabeled form)."""
        return await self._connect_worker(addr, node_hex)

    def _deliver_stream_item(self, conn, p: dict):
        tid = p["task_id"]
        buf = self._streams.get(tid)
        if buf is None:
            return  # stream abandoned/cancelled: drop silently
        idx = p["index"]
        kind, payload = p["item"]
        oid = ObjectID.for_task_return(TaskID(tid), idx).binary()
        if kind == "inline":
            self.memory_store[oid] = self._serialization.deserialize(payload)
        elif kind == "err":
            self.memory_store[oid] = _RaiseOnGet(
                self._serialization.deserialize(payload)
            )
        # kind == "stored": resolvable via the shm/pull path
        buf.deliver(idx, conn)
        if buf.cancel_state == 1:
            # cancel arrived before we knew the producing connection
            buf.cancel_state = 2
            self._spawn(conn.notify("cancel_task", {"task_id": tid}))

    def stream_next(self, tid: bytes, timeout: Optional[float] = None):
        """Block until the next stream item is available; returns its
        ObjectRef (which may raise on get for an error item).  Raises
        StopIteration when the stream is exhausted."""
        buf = self._streams.get(tid)
        if buf is None:
            raise StopIteration
        deadline = None if timeout is None else time.monotonic() + timeout
        with buf.cond:
            while True:
                idx = buf.next_idx
                if idx in buf.items:
                    buf.items.discard(idx)
                    buf.next_idx = idx + 1
                    conn = buf.conn
                    break
                if buf.count is not None and idx >= buf.count:
                    if not buf.items:
                        self._streams.pop(tid, None)
                    raise StopIteration
                if buf.failed is not None:
                    raise buf.failed
                remaining = (
                    None if deadline is None else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    raise GetTimeoutError(
                        f"timed out waiting for stream item {idx}"
                    )
                buf.cond.wait(remaining)
        oid = ObjectID.for_task_return(TaskID(tid), idx)
        if conn is not None and not conn.closed:
            self._spawn(conn.notify("stream_ack", {"task_id": tid, "upto": idx}))
        return ObjectRef(oid)

    async def stream_next_async(self, tid: bytes):
        """Async variant of stream_next.

        Loop-native when awaited on the runtime's own io loop (async
        actor methods, serve replicas/proxies): NO thread is parked per
        in-flight stream — the delivery path sets an asyncio.Event.
        Elsewhere it falls back to a worker thread."""
        try:
            on_loop = asyncio.get_running_loop() is self._loop
        except RuntimeError:
            on_loop = False
        if not on_loop:
            try:
                return await asyncio.to_thread(self.stream_next, tid)
            except StopIteration:
                raise StopAsyncIteration from None
        # exhaustion raises StopAsyncIteration (PEP 479: a coroutine must
        # not let StopIteration escape)
        buf = self._streams.get(tid)
        if buf is None:
            raise StopAsyncIteration
        while True:
            with buf.cond:
                idx = buf.next_idx
                if idx in buf.items:
                    buf.items.discard(idx)
                    buf.next_idx = idx + 1
                    conn = buf.conn
                    break
                if buf.count is not None and idx >= buf.count:
                    if not buf.items:
                        self._streams.pop(tid, None)
                    raise StopAsyncIteration
                if buf.failed is not None:
                    raise buf.failed
                buf.aev = asyncio.Event()
                ev = buf.aev
            await ev.wait()
        oid = ObjectID.for_task_return(TaskID(tid), idx)
        if conn is not None and not conn.closed:
            self._spawn(
                conn.notify("stream_ack", {"task_id": tid, "upto": idx})
            )
        return ObjectRef(oid)

    def stream_cancel(self, tid: bytes) -> bool:
        """Stop a streaming producer; the consumer's next() receives a
        TaskCancelledError ref once the worker acknowledges (or drains)."""
        buf = self._streams.get(tid)
        if buf is None:
            return False
        conn = buf.conn
        if conn is not None and not conn.closed:
            buf.cancel_state = 2
            self._spawn(conn.notify("cancel_task", {"task_id": tid}))
        else:
            # Either not dispatched yet (the pre-push flag catches it) or
            # pushed but no item delivered yet — mark the buf so the first
            # delivery forwards the cancel to the producing worker.
            buf.cancel_state = 1
            self._cancel_requested.add(
                ObjectID.for_task_return(TaskID(tid), 0).binary()
            )
        return True

    def stream_abandon(self, tid: bytes):
        """Consumer dropped the generator: cancel production, release any
        undelivered buffered items."""
        buf = self._streams.pop(tid, None)
        if buf is None:
            return
        with buf.cond:
            pending = list(buf.items)
            conn = buf.conn
            consumed_upto = buf.next_idx
        for idx in pending:
            oid = ObjectID.for_task_return(TaskID(tid), idx).binary()
            self.memory_store.pop(oid, None)
        if buf.count is None and buf.failed is None:
            # still producing: the closing reply frees the stored tail
            # (see _apply_task_reply) and the worker gets a cancel
            self._abandoned_streams[tid] = consumed_upto
            if conn is not None and not conn.closed:
                self._spawn(conn.notify("cancel_task", {"task_id": tid}))
        elif buf.count is not None and buf.count > consumed_upto:
            # producer already finished: free the stored tail now
            oids = [
                ObjectID.for_task_return(TaskID(tid), i).binary()
                for i in range(consumed_upto, buf.count)
            ]
            if self.gcs and not self.gcs.closed:
                self._gcs_object_notify("free_objects", {"object_ids": oids})

    async def await_ref(self, ref: ObjectRef):
        (value,) = await self._get_async([ref.object_id.binary()], None)
        return value

    def as_future(self, ref: ObjectRef):
        """concurrent.futures.Future resolving to the object's VALUE
        (not the one-element batch list `_get_async` returns) — the
        thread-safe bridge for awaiting a ref from outside the runtime
        loop (ObjectRef.future(), serve's loop-agnostic result_async)."""

        async def _one():
            (value,) = await self._get_async(
                [ref.object_id.binary()], None
            )
            return value

        return asyncio.run_coroutine_threadsafe(_one(), self._loop)

    async def _get_async(self, oids: List[bytes], deadline) -> List[Any]:
        results: Dict[bytes, Any] = {}
        for oid in oids:
            if oid not in results:
                results[oid] = await self._resolve_one(oid, deadline)
        return [results[oid] for oid in oids]

    async def _worker_death_detail(self, worker_id) -> str:
        """Ask the GCS why a worker died (e.g. the memory monitor killed
        it).  The raylet's death notification races our ConnectionLost,
        so poll briefly; empty string when nothing is recorded."""
        wid = (
            worker_id.binary() if hasattr(worker_id, "binary") else worker_id
        )
        for _ in range(4):
            try:
                info = await asyncio.wait_for(
                    self.gcs.call("get_worker_death_info",
                                  {"worker_id": wid}),
                    timeout=2.0,
                )
                if info.get("reason"):
                    return f" ({info['reason']})"
            except Exception:
                return ""
            await asyncio.sleep(0.5)
        return ""

    def _result_future(self, oid: bytes):
        """Loop-only: the real asyncio.Future for a locally-pending
        result, upgrading the lazy _PENDING_RESULT marker on first async
        need.  None when the result is not pending here."""
        fut = self.result_futures.get(oid)
        if fut is _PENDING_RESULT:
            fut = self.result_futures[oid] = asyncio.Future(loop=self._loop)
        return fut

    async def await_ref_completion(self, ref: ObjectRef) -> None:
        """Wait until the task producing ``ref`` has COMPLETED, without
        fetching its value — bookkeeping callers (e.g. serve's chained
        in-flight accounting) must not materialize a possibly-huge
        result into this process just to observe that it finished."""
        fut = self._result_future(ref.object_id.binary())
        if fut is not None:
            try:
                await asyncio.shield(fut)
            except Exception:
                pass  # errored completion still counts as completed

    async def _resolve_one(self, oid: bytes, deadline) -> Any:
        failed_pulls = 0
        pull_backoff = None  # built lazily: only failed pulls pay for it
        last_pull_exc = None  # chained into ObjectLostError for diagnosis
        while True:
            if oid in self.memory_store:
                value = self.memory_store[oid]
                if isinstance(value, _RaiseOnGet):
                    raise value.exc
                return value
            # a task from this process produces it → wait for completion
            fut = self._result_future(oid)
            if fut is not None:
                remaining = (
                    None
                    if deadline is None or deadline == float("inf")
                    else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    raise GetTimeoutError(f"timed out waiting for {oid.hex()[:16]}")
                try:
                    await asyncio.wait_for(
                        asyncio.shield(fut),
                        timeout=remaining,
                    )
                except asyncio.TimeoutError:
                    raise GetTimeoutError(
                        f"timed out waiting for {oid.hex()[:16]}"
                    ) from None
                continue  # completed: value now in memory store or shm
            # shared store path
            value, found = self._read_from_store(oid)
            if found:
                return value
            # local get-miss: flush any windowed announces before asking
            # the cluster (the object may be one whose announce is still
            # sitting in our own window)
            self.flush_object_notifies()
            # ask raylet to pull it from another node
            remaining = 30.0 if deadline is None else deadline - time.monotonic()
            if remaining <= 0:
                raise GetTimeoutError(f"timed out resolving {oid.hex()[:16]}")
            try:
                ok = await self.raylet.call(
                    "pull_object",
                    {"object_id": oid, "timeout": min(remaining, 30.0)},
                    timeout=min(remaining, 30.0) + 10,
                )
            except rpc.ConnectionLost as e:
                # our raylet is gone: there is no pull plane left to
                # retry against — fall through to reconstruction/loss
                ok = False
                last_pull_exc = e
            except (rpc.RemoteCallError, rpc.RpcError,
                    asyncio.TimeoutError) as e:
                # a transient pull-plane failure (raylet handler error,
                # rpc budget exceeded under load, an injected recv
                # fault) is a FAILED PULL, not object loss — it rides
                # the same bounded retry budget as a "retry" verdict
                ok = "retry"
                last_pull_exc = e
            if not ok or ok == "retry":
                # last chance: it may have landed locally while we pulled
                value, found = self._read_from_store(oid)
                if found:
                    return value
                failed_pulls += 1
                if ok == "retry" and failed_pulls < cfg.pull_retry_max:
                    # a copy exists (spill file / live peer) but this
                    # round's restore or transfer failed — transient
                    # arena pressure, NOT object loss; back off and retry
                    # (shared policy; a lapsed deadline surfaces at the
                    # loop head as GetTimeoutError)
                    if pull_backoff is None:
                        pull_backoff = Backoff(
                            BackoffPolicy(
                                base_s=cfg.pull_retry_base_s,
                                mult=cfg.backoff_mult,
                                max_s=cfg.pull_retry_max_s,
                                jitter_frac=cfg.backoff_jitter_frac,
                            ),
                            deadline=deadline,
                        )
                    await pull_backoff.wait()
                    continue
                # A failed pull already waited a location round: if we own
                # lineage for the object, re-execute its producing task now
                # (reference: object_recovery_manager.h:41) — whatever the
                # deadline shape, recovery beats spinning.
                if await self._try_reconstruct(oid):
                    continue
                if deadline is None or (
                    deadline == float("inf")
                    and failed_pulls >= cfg.pull_retry_infinite_max
                ):
                    # no-timeout get fails fast; an infinite-deadline wait
                    # (ray_tpu_torch.wait) retries a few ~30s location rounds so
                    # an in-flight cross-owner ref isn't misreported, then
                    # surfaces genuinely lost objects as errored (= ready)
                    # chain the last pull-plane error (when there was
                    # one): a persistent raylet handler failure must not
                    # masquerade as plain object loss
                    raise ObjectLostError(
                        f"object {oid.hex()[:16]} not found anywhere in "
                        f"the cluster"
                        + (f" (last pull error: {last_pull_exc!r})"
                           if last_pull_exc is not None else "")
                    ) from last_pull_exc
                await asyncio.sleep(cfg.get_retry_poll_s)  # retry until deadline

    def _read_from_store(self, oid: bytes) -> Tuple[Any, bool]:
        pin = self.store.get(oid)
        if pin is None:
            return None, False
        if (
            pin.view.nbytes >= self._zerocopy_threshold
            and self.store.pin_headroom() > 64
            and ser.SUPPORTS_ZEROCOPY_OWNER
        ):
            # Zero-copy: deserialize straight off the arena; the pin's
            # lifetime rides the returned object's buffer-base chain
            # (serialization._OwnedBuffer), exactly plasma's mmap-read
            # semantics.  Read-only so a caller can't scribble on shm.
            # The pin is deliberately NOT released here — it unpins when
            # the last deserialized view is garbage-collected.
            try:
                value = self._serialization.deserialize(
                    pin.view.toreadonly(), owner=pin
                )
            except BaseException:
                # On failure nothing chains the pin; a retained exception
                # (logging, sys.last_exc) would otherwise keep the arena
                # range pinned for as long as the traceback lives.
                pin.release()
                raise
            return value, True
        try:
            # small objects (and pin-ledger pressure — many large results
            # already held zero-copy): a copy is cheaper than holding a
            # pin that blocks LRU eviction for the value's whole lifetime
            value = self._serialization.deserialize(bytes(pin.view))
        finally:
            pin.release()
        return value, True

    def wait(self, refs, num_returns=1, timeout=None, fetch_local=True):
        if num_returns > len(refs):
            raise ValueError("num_returns > len(refs)")
        deadline = None if timeout is None else time.monotonic() + timeout
        return self._run(self._wait_async(refs, num_returns, deadline))

    async def _wait_async(self, refs, num_returns, deadline):
        pending = list(refs)
        ready: List[ObjectRef] = []
        # Per-ref resolution runs with an INFINITE deadline: the wait
        # timeout is enforced by asyncio.wait below.  A real deadline here
        # would complete futures with GetTimeoutError at the cutoff and
        # misreport timed-out refs as ready; deadline=None would convert a
        # slow cross-owner pull into ObjectLostError (also "ready").  inf
        # keeps retrying the pull until the ref truly resolves or errors.
        futs = {
            r: asyncio.ensure_future(
                self._resolve_one(r.object_id.binary(), float("inf"))
            )
            for r in pending
        }
        try:
            while len(ready) < num_returns:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    # A spent deadline (timeout=0 included) still reports
                    # what is ready: one turn of the loop runs each
                    # resolution to its first wait, so a ref resolved
                    # before the call counts, as in Ray.  The reference
                    # leaves here before looking and returns none ready.
                    await asyncio.sleep(0)
                    for r in list(pending):
                        if futs[r].done() and len(ready) < num_returns:
                            pending.remove(r)
                            ready.append(r)
                    break
                done, _ = await asyncio.wait(
                    [futs[r] for r in pending],
                    timeout=remaining,
                    return_when=asyncio.FIRST_COMPLETED,
                )
                if not done:
                    break
                for r in list(pending):
                    if futs[r].done():
                        pending.remove(r)
                        ready.append(r)
                        if futs[r].exception():
                            pass  # errored objects count as ready (ray semantics)
        finally:
            for r in pending:
                futs[r].cancel()
        return ready, pending

    # ---- task submission ----------------------------------------------
    def fn_hash_and_register(self, fn) -> bytes:
        # Memoized per function OBJECT: cloudpickling the (identical)
        # function on every submit cost ~90µs/call — the whole hash
        # exists so the function ships once.  Semantics note (same as
        # the reference's once-per-export function shipping): the code
        # and its captured state are SNAPSHOTTED at a function object's
        # first submit; mutating a captured cell between submits of the
        # same object is not re-shipped.  A NEW function object (fresh
        # lambda/def) always re-pickles.
        #
        # The identity check rides a WeakValueDictionary: a dead
        # function's entry vanishes, so a recycled id() can never alias
        # a DIFFERENT function to a stale hash, and per-submit lambdas
        # (with whatever their closures capture) are not pinned alive.
        entry = self._fn_hash_memo.get(id(fn))
        if entry is not None and entry[0]() is fn:
            # single-entry read: (weakref, hash) read atomically, so a
            # concurrent submit clearing the memo can't strand us between
            # an identity check and a separate hash lookup
            return entry[1]
        blob = cloudpickle.dumps(fn)
        h = hashlib.blake2b(blob, digest_size=16).digest()
        if h not in self._fn_cache:
            self._fn_cache[h] = fn
            self._spawn(
                self.gcs.call(
                    "kv_put",
                    {"key": f"fn:{h.hex()}", "value": blob, "overwrite": False},
                )
            )
        if len(self._fn_hash_memo) > 4096:
            self._fn_hash_memo.clear()  # also reaps dead-weakref entries
        try:
            self._fn_hash_memo[id(fn)] = (weakref.ref(fn), h)
        except TypeError:
            pass  # not weakref-able: skip memoization
        return h

    async def resolve_fn(self, fn_hash: bytes):
        fn = self._fn_cache.get(fn_hash)
        if fn is None:
            blob = await self.gcs.call("kv_get", {"key": f"fn:{fn_hash.hex()}"})
            if blob is None:
                raise TaskError("FunctionNotFound", fn_hash.hex(), "", "")
            fn = cloudpickle.loads(blob)
            self._fn_cache[fn_hash] = fn
        return fn

    def _pack_args(self, args, kwargs) -> list:
        """Top-level refs pass by reference; values serialize (promoting any
        nested refs via the reducer)."""
        if not args and not kwargs:
            return ()  # shared empty: no per-call list on no-arg calls
        ser_ctx = self._serialization
        packed = []
        for a in args:
            if isinstance(a, ObjectRef):
                self.ensure_shared(a.object_id)
                packed.append(("ref", a.object_id.binary(), a._owner_hint))
            else:
                # small immutable values (flags, indexes, short strings)
                # repeat across submissions: the memo skips the pickle
                b = ser_ctx.serialize_small(a)
                if b is None:
                    b = ser_ctx.serialize(a).to_bytes()
                packed.append(("val", b))
        for k, v in (kwargs or {}).items():
            if isinstance(v, ObjectRef):
                self.ensure_shared(v.object_id)
                packed.append(("kwref", k, v.object_id.binary(), v._owner_hint))
            else:
                b = ser_ctx.serialize_small(v)
                if b is None:
                    b = ser_ctx.serialize(v).to_bytes()
                packed.append(("kwval", k, b))
        return packed

    def unpack_args_sync(self, packed) -> Optional[Tuple[list, dict]]:
        """Ref-free fast path: pure deserialization, no loop round-trip.
        Returns None when any arg is an ObjectRef (caller must await
        unpack_args on the io loop instead) — the hot actor-call path
        has inline args and skips two thread handoffs per call."""
        if any(item[0] in ("ref", "kwref") for item in packed):
            return None
        args, kwargs = [], {}
        for item in packed:
            if item[0] == "val":
                args.append(self._serialization.deserialize(item[1]))
            else:
                kwargs[item[1]] = self._serialization.deserialize(item[2])
        return args, kwargs

    async def unpack_args(self, packed) -> Tuple[list, dict]:
        args, kwargs = [], {}
        for item in packed:
            kind = item[0]
            if kind == "ref":
                (value,) = await self._get_async([item[1]], None)
                args.append(value)
            elif kind == "val":
                args.append(self._serialization.deserialize(item[1]))
            elif kind == "kwref":
                (value,) = await self._get_async([item[2]], None)
                kwargs[item[1]] = value
            else:
                kwargs[item[1]] = self._serialization.deserialize(item[2])
        return args, kwargs

    def make_task_template(
        self,
        fn,
        *,
        name: str = "",
        num_returns=1,
        resources: Optional[Dict[str, float]] = None,
        max_retries: int = 0,
        strategy: Optional[dict] = None,
        runtime_env: Optional[dict] = None,
    ) -> TaskTemplate:
        """Build the immutable submission template for one function /
        option-set: function shipping, resource validation, scheduling
        class key, runtime-env normalization and the spec skeleton all
        happen HERE, once — `.remote()` pays only id/arg fills.
        RemoteFunction caches the result per runtime instance."""
        fn_hash = self.fn_hash_and_register(fn)
        # {} is a valid demand (zero-resource tasks, e.g. PG probes)
        resources = dict(resources) if resources is not None else {"CPU": 1}
        streaming = num_returns == "streaming"
        if streaming:
            num_returns = 1
            max_retries = 0  # re-running a generator would double-send items
        strategy = dict(strategy) if strategy else {}
        # Scheduling class = (fn, resources, strategy) — like the reference's
        # SchedulingClass (ray: common/task/task_spec.h) — so leased workers
        # are only reused for the same function shape and a slow function
        # can't head-of-line-block unrelated tasks.
        rtenv_desc = self._normalize_runtime_env(runtime_env)
        from ray_tpu_torch.core import runtime_env as rtenv_mod

        class_key = (
            fn_hash,
            tuple(sorted(resources.items())),
            tuple(sorted(strategy.items(), key=lambda kv: kv[0])),
            rtenv_mod.descriptor_key(rtenv_desc),
        )
        if rtenv_desc is not None:
            self._class_runtime_envs[class_key] = rtenv_desc
        # NB: resources deliberately do NOT ride the wire spec — the
        # worker never schedules (the lease already placed the task) and
        # nothing else reads them off the spec; they live on the template
        # and PendingTask for lease requests and lineage re-execution
        skeleton = {
            "task_id": b"",  # filled per call
            "name": name,
            "fn_hash": fn_hash,
            "args": (),      # filled per call
            "num_returns": num_returns,
            "caller_id": self.worker_id.binary(),
        }
        if streaming:
            skeleton["streaming"] = True
        # drivers bake their (constant) job into the skeleton; workers
        # attribute nested submissions to the job of the task that last
        # ran here, which changes — those fill per call
        fill_job = self.job_id is None
        if not fill_job:
            skeleton["job"] = self._job_hex()
        return TaskTemplate(
            self, skeleton, class_key, resources, strategy,
            num_returns, streaming, max_retries, fill_job,
        )

    def submit_task_from_template(self, tmpl: TaskTemplate, args, kwargs):
        """Hot-path submit: fill ids + args against the cached template
        and hand the PendingTask to the io loop through the coalesced
        submit queue.  The spec dict is NOT copied per call — the compact
        wire path ships (tpl_id, task_id, args, job) and the skeleton
        travels to each worker connection once (streaming and tracing
        calls keep the full-dict spec, which both need to annotate).
        Returns a bare ObjectRef for num_returns == 1, a list of refs
        otherwise, an ObjectRefGenerator when streaming."""
        task_id = os.urandom(16)
        packed = self._pack_args(args, kwargs)
        job = self._job_hex() if tmpl.fill_job else None
        spec = None
        if tmpl.streaming or tracing.enabled():
            spec = dict(tmpl.skeleton)
            spec["task_id"] = task_id
            spec["args"] = packed
            if job is not None:
                spec["job"] = job
        n = tmpl.num_returns
        if n == 1:
            return_ids = (task_return_binary(task_id, 0),)
        else:
            return_ids = tuple(
                task_return_binary(task_id, i) for i in range(n)
            )
        # Dependencies this process itself is producing.  They must resolve
        # BEFORE the task may occupy a lease — a worker blocking on an
        # in-flight upstream result while holding the worker that upstream
        # task needs is a scheduling deadlock (reference:
        # LocalDependencyResolver, core_worker/transport/dependency_resolver.h).
        dep_oids = () if not packed else [
            item[1] if item[0] == "ref" else item[2]
            for item in packed
            if item[0] in ("ref", "kwref")
        ]
        pending = PendingTask(
            spec, return_ids, tmpl.max_retries, dep_oids=dep_oids,
            class_key=tmpl.class_key, resources=tmpl.resources,
            strategy=tmpl.strategy, tmpl=tmpl, task_id=task_id,
            args=packed, job=job, streaming=tmpl.streaming,
        )
        self._timeline.append(
            ("submit", tmpl.skeleton["name"], task_id.hex(), time.time(),
             self._pid, None)
        )
        if spec is not None and tracing.enabled():
            # W3C trace context rides the spec; the worker's execute
            # span parents under THIS submit span (reference:
            # _ray_trace_ctx in tracing_helper.py)
            with tracing.span(
                f"submit {tmpl.skeleton['name']}", task_id=task_id.hex()
            ):
                spec["trace_ctx"] = tracing.inject()
        # ref args stay pinned while the task is in flight, even if the
        # caller drops its own refs (reference: task-argument references,
        # reference_count.h)
        if dep_oids:
            self._hold_for_task(dep_oids)
        if tmpl.streaming:
            # stream buffer must exist before any item can arrive; no
            # result futures (items resolve via the memory store / shm),
            # no lineage (generators are not reconstructible)
            self._streams[task_id] = _StreamBuf()
            self._submit_to_loop(pending)
            return ObjectRefGenerator(task_id)
        self._record_lineage(pending)
        # Register result futures before the task can possibly complete,
        # lazily (_PENDING_RESULT upgrades to an asyncio.Future only on
        # async need), and create refs BEFORE the enqueue can run: a fast
        # failure path must see a nonzero refcount or it would drop the
        # error sentinel.
        for oid in return_ids:
            self.result_futures[oid] = _PENDING_RESULT
        if n == 1:
            ref = ObjectRef(ObjectID(return_ids[0]), self.node_id)
            self._submit_to_loop(pending)
            return ref
        refs = [ObjectRef(ObjectID(oid), self.node_id) for oid in return_ids]
        self._submit_to_loop(pending)
        return refs

    def submit_task(
        self,
        fn,
        args,
        kwargs,
        *,
        name: str = "",
        num_returns: int = 1,
        resources: Optional[Dict[str, float]] = None,
        max_retries: int = 0,
        strategy: Optional[dict] = None,
        runtime_env: Optional[dict] = None,
    ):
        """Untemplated submit (compatibility surface): builds a one-shot
        template.  RemoteFunction bypasses this with a cached template;
        returns a list of refs (or a generator) like it always did."""
        tmpl = self.make_task_template(
            fn, name=name, num_returns=num_returns, resources=resources,
            max_retries=max_retries, strategy=strategy,
            runtime_env=runtime_env,
        )
        out = self.submit_task_from_template(tmpl, args, kwargs)
        if isinstance(out, ObjectRef):
            return [out]
        return out

    # ---- coalesced submission hop --------------------------------------
    def _submit_to_loop(self, task: PendingTask):
        """Hand a PendingTask to the io loop, coalescing the cross-thread
        wakeup: every task appended between two loop ticks drains in one
        scheduled callback."""
        if threading.current_thread() is self._thread:
            self._admit_submitted(task)
            return
        self._submit_q.append(task)
        # deliberately lock-free (GIL-ordered): the drainer clears the
        # flag BEFORE draining, so a submitter reading a stale True has
        # its append covered by that very drain; a stale False only
        # schedules a redundant no-op drain.  A lock here would sit on
        # every submission.
        # rtlint: disable-next=RT108
        if not self._submit_q_scheduled:
            # cross-plane by design: the protocol above makes the
            # caller-side set / loop-side clear safe without a lock
            # rtlint: disable-next=RT301
            self._submit_q_scheduled = True
            self._loop.call_soon_threadsafe(self._drain_submit_q)

    def _drain_submit_q(self):
        # clear the flag BEFORE draining: a submitter appending after the
        # clear schedules a fresh (possibly redundant, never missed) drain
        # (GIL-ordered handshake with _submit_to_loop, audited above)
        # rtlint: disable-next=RT301
        self._submit_q_scheduled = False
        q = self._submit_q
        while q:
            try:
                task = q.popleft()
            except IndexError:
                break
            self._admit_submitted(task)

    def _admit_submitted(self, task: PendingTask):
        if task.spec is not None and "actor_id" in task.spec:
            self._enqueue_actor_task(task)
        else:
            self._enqueue_after_deps(task)

    # ---- flush-window GCS notifications --------------------------------
    def _gcs_object_notify(self, method: str, payload: dict,
                           urgent: bool = True) -> None:
        """Buffer an object-directory notify for the batched flush.
        ``urgent`` events (locations another process may already be
        waiting on) flush this tick; windowed events (e.g. put()
        announces of refs that have not escaped) wait up to
        cfg.gcs_notify_flush_window_s / gcs_notify_flush_max for
        company.  Buffer order is preserved on the wire and applied in
        order by the GCS, so announce-before-free style invariants hold
        within the batch."""
        if self._closed:
            return
        with self._gcs_nbuf_lock:
            self._gcs_nbuf.append((method, payload))
            if len(self._gcs_nbuf) >= cfg.gcs_notify_flush_max:
                urgent = True
            if urgent:
                if self._gcs_nbuf_mode == "soon":
                    return
                self._gcs_nbuf_mode = "soon"
                mode = "soon"
            else:
                if self._gcs_nbuf_mode is not None:
                    return
                self._gcs_nbuf_mode = "timer"
                mode = "timer"
        try:
            if mode == "soon":
                self._loop.call_soon_threadsafe(self._flush_gcs_notify)
            else:
                self._loop.call_soon_threadsafe(self._arm_gcs_notify_timer)
        except RuntimeError:
            pass  # loop closing

    def flush_object_notifies(self) -> None:
        """Flush the object-notify window now (callable from any
        thread).  Every path that can make a windowed announce
        observable to another process — ref export, a directory read,
        an explicit free — calls this first; the flush-window batching
        is then invisible to cross-process visibility semantics."""
        if self._gcs_nbuf:
            self._flush_gcs_notify()

    def _arm_gcs_notify_timer(self):
        # loop-only.  The window may have been upgraded to a tick flush
        # meanwhile; the timer then fires on an empty buffer (no-op).
        self._loop.call_later(
            cfg.gcs_notify_flush_window_s, self._flush_gcs_notify
        )

    def _flush_gcs_notify(self):
        """Send everything buffered as ONE rpc (callable from any
        thread; the send itself always happens on the io loop)."""
        with self._gcs_nbuf_lock:
            items = self._gcs_nbuf
            self._gcs_nbuf_mode = None
            if not items:
                return
            self._gcs_nbuf = []
        if self.gcs is None or self.gcs.closed:
            return
        if len(items) == 1:
            self._spawn(self.gcs.notify(items[0][0], items[0][1]))
        else:
            self._spawn(
                self.gcs.notify("object_notify_batch", {"items": items})
            )

    def _enqueue_after_deps(self, pending: PendingTask):
        """Queue the task once locally-produced ref args have resolved."""
        dep_oids = pending.dep_oids
        waits = [
            fut
            for oid in dep_oids
            if (fut := self._result_future(oid)) is not None
            and not fut.done()
        ]
        if not waits:
            failed = self._failed_dep(dep_oids)
            if failed is not None:
                self._fail_task(pending, failed)
                return
            self._enqueue_task(pending)
            return

        async def wait_then_enqueue():
            await asyncio.gather(
                *(asyncio.shield(f) for f in waits), return_exceptions=True
            )
            failed = self._failed_dep(dep_oids)
            if failed is not None:
                self._fail_task(pending, failed)
            else:
                self._enqueue_task(pending)

        self._loop.create_task(wait_then_enqueue())

    def _failed_dep(self, dep_oids) -> Optional[Exception]:
        """If a locally-owned dependency errored, its error (else None)."""
        for oid in dep_oids:
            value = self.memory_store.get(oid)
            if isinstance(value, _RaiseOnGet):
                return value.exc
        return None

    def _consume_cancel_flag(self, task: PendingTask) -> bool:
        """True (and fails the task) if cancel() flagged it pre-dispatch."""
        if any(oid in self._cancel_requested for oid in task.return_ids):
            for oid in task.return_ids:
                self._cancel_requested.discard(oid)
            self._fail_task(task, TaskCancelledError(task.return_ids[0].hex()))
            return True
        return False

    def _enqueue_task(self, pending: PendingTask):
        if self._consume_cancel_flag(pending):
            return
        class_key = pending.class_key
        st = self._classes.get(class_key)
        if st is None:
            st = self._classes[class_key] = SchedClassState()
        st.queue.append(pending)
        self._pump_class(class_key, pending.resources, pending.strategy)

    def _pump_class(self, class_key, resources, strategy):
        """Dispatch queued tasks onto leased workers; request more leases if
        the queue outruns capacity; give idle leases back."""
        st = self._classes[class_key]
        cap = cfg.max_tasks_in_flight_per_worker
        # dispatch — but never past the transport's backlog budget: a
        # connection already over rpc_send_backlog_limit_bytes stops
        # taking pushes until its drain completes (real flow control;
        # the dispatch path itself never awaits)
        limit = cfg.rpc_send_backlog_limit_bytes
        for lease in st.leases:
            while (
                st.queue and not lease.broken and lease.inflight < cap
                and lease.conn.send_backlog <= limit
            ):
                task = st.queue.popleft()
                lease.inflight += 1
                self._dispatch(class_key, lease, task, resources, strategy)
            if (
                st.queue and not lease.broken
                and lease.conn.send_backlog > limit
            ):
                self._drain_then_pump(class_key, lease, resources, strategy)
        if st.queue:
            # scale leases: one in-flight request per ~cap queued tasks
            # beyond current capacity — but never more than the pending-
            # request ceiling.  Unbounded want (= queue depth) let a deep
            # window park hundreds of lease requests at the GCS on a
            # saturated host, each costing a parked call's coroutine/
            # future/timer machinery (~12 allocs) for a grant that could
            # never arrive; grants re-pump, so a bounded pipeline loses
            # no ramp (reference: lease request pipelining,
            # direct_task_transport.cc).
            want = (len(st.queue) + cap - 1) // cap
            have = len(st.leases) + st.requests_inflight
            ceiling = cfg.sched_max_lease_requests_per_class
            if want > have and st.requests_inflight < ceiling:
                st.cancel_sent = False
                for _ in range(min(want - have, 8,
                                   ceiling - st.requests_inflight)):
                    st.requests_inflight += 1
                    self._loop.create_task(
                        self._acquire_lease(class_key, resources, strategy)
                    )
        else:
            # demand drained: cancel requests still parked at the GCS —
            # left alone, every freed slot would be granted to a parked
            # request, bounced back after the reuse grace, granted to the
            # next one, ... serially starving other classes/PGs for
            # grace × parked seconds (ray: CancelWorkerLease)
            if st.requests_inflight and not st.cancel_sent:
                st.cancel_sent = True
                self._spawn(
                    self.gcs.notify(
                        "cancel_lease_requests", {"tags": [st.tag]}
                    )
                )
            # idle leases (including ones granted after the queue drained)
            # go back to the GCS after a short reuse grace
            for lease in st.leases:
                if lease.inflight == 0 and not lease.broken:
                    self._schedule_lease_return(class_key, lease)

    async def _acquire_lease(self, class_key, resources, strategy):
        st = self._classes[class_key]
        pending_backoff = None  # built on first LEASE_PENDING only
        try:
            while True:
                try:
                    grant = await self.gcs.call(
                        "request_lease",
                        {
                            "resources": resources,
                            "strategy": strategy,
                            "tag": st.tag,
                            "runtime_env": self._class_runtime_envs.get(
                                class_key
                            ),
                        },
                        timeout=cfg.sched_max_pending_lease_s
                        + cfg.worker_start_timeout_s,
                    )
                    break
                except rpc.RemoteCallError as e:
                    # capacity-pending timeout at the GCS: keep waiting as
                    # long as we still have queued demand; infeasible → fail
                    if "LEASE_PENDING" in str(e.remote_exception) and st.queue:
                        # brief shared-policy backoff so a fleet of
                        # starved classes doesn't re-request in lockstep
                        if pending_backoff is None:
                            pending_backoff = lease_pending_backoff()
                        await pending_backoff.wait()
                        continue
                    raise
            if grant.get("cancelled"):
                # demand drained while parked — no lease; the pump below
                # re-requests if demand reappeared since the cancel
                pass
            else:
                try:
                    conn = await self._connect_worker(
                        grant["worker_addr"], grant.get("node_id")
                    )
                except (OSError, rpc.RpcError, asyncio.TimeoutError) as e:
                    # the granted worker died in the grant→dial window
                    # (crash, OOM kill, injected chaos).  Return the
                    # lease as broken and fall through to the pump —
                    # the still-queued demand re-requests.  (A bare
                    # return here stranded the queue forever: nothing
                    # re-pumped the class; found by the chaos plane's
                    # nth-hit lease-kill.)
                    logger.warning(
                        "granted worker at %s unreachable: %r",
                        grant["worker_addr"], e,
                    )
                    self._spawn(self.gcs.notify(
                        "return_lease",
                        {"lease_id": grant["lease_id"], "broken": True},
                    ))
                else:
                    lease = Lease(
                        lease_id=grant["lease_id"],
                        worker_addr=grant["worker_addr"],
                        worker_id=grant["worker_id"],
                        node_id=grant["node_id"],
                        conn=conn,
                    )
                    st.leases.append(lease)
        except Exception as e:
            # fail queued tasks if the demand is infeasible
            if st.queue and isinstance(e, rpc.RemoteCallError):
                for task in st.queue:
                    self._fail_task(task, TaskError(
                        "SchedulingError", str(e.remote_exception), "", "lease"
                    ))
                st.queue.clear()
            return
        finally:
            st.requests_inflight -= 1
        self._pump_class(class_key, resources, strategy)

    async def _connect_worker(self, addr: str,
                              node_hex: Optional[str] = None) -> rpc.Connection:
        conn = self._worker_conns.get(addr)
        if conn is None or conn.closed:
            conn = await rpc.connect(
                addr, self._worker_inbound, name=f"->worker@{addr}",
                on_close=self._on_worker_conn_closed,
                peer_endpoint=node_hex,
            )
            conn.peer_info["addr"] = addr
            self._worker_conns[addr] = conn
        elif node_hex is not None and conn.peer_endpoint is None:
            conn.peer_endpoint = node_hex
        return conn

    def _on_worker_conn_closed(self, conn) -> None:
        addr = conn.peer_info.get("addr")
        if addr is not None and self._worker_conns.get(addr) is conn:
            self._worker_conns.pop(addr, None)
        self._notify_peer_closed(conn)

    def _dispatch(self, class_key, lease: Lease, task: PendingTask,
                  resources, strategy):
        """Fire one task push and attach the reply callback — NO per-task
        coroutine/Task (the awaiting-coroutine shape cost a Task object +
        frame per call on the pipelined-task hot path; the actor path
        made the same move a round earlier)."""
        if self._consume_cancel_flag(task):  # cancelled in the pop→push window
            lease.inflight -= 1
            self._pump_class(class_key, resources, strategy)
            return
        task.rt = self
        task.st = lease
        task.conn = lease.conn
        self._inflight_dispatch[task.return_ids[0]] = task
        try:
            # call_soon: no wait_for timer / pending-pop bookkeeping per
            # task (same no-timeout semantics the old timeout=-1 had).
            # Its skipped write flow control is restored below: past the
            # backlog budget, spawn a drain so large pipelined arg
            # payloads hit the high-water mark instead of buffering
            # unbounded (pipelining is already capped per lease).
            if task.spec is not None:
                fut = lease.conn.call_soon("push_task", task.spec)
            else:
                # compact template wire: the skeleton ships once per
                # (connection, template); every later push is a 4-tuple.
                # The sent-set dies with the connection, so a worker that
                # never saw the skeleton (lost frame ⇒ lost conn) gets it
                # again on the replacement lease.
                tmpl = task.tmpl
                sent = lease.conn.peer_info.get("_tpl_sent")
                if sent is None:
                    sent = lease.conn.peer_info["_tpl_sent"] = set()
                if tmpl.tpl_id in sent:
                    payload = (tmpl.tpl_id, task.task_id, task.args,
                               task.job)
                else:
                    sent.add(tmpl.tpl_id)
                    payload = (tmpl.tpl_id, task.task_id, task.args,
                               task.job, tmpl.skeleton)
                fut = lease.conn.call_soon("push_task", payload)
        except (rpc.ConnectionLost, OSError):
            self._task_push_failed(task, lease,
                                   rpc.ConnectionLost("push failed"))
            self._dispatch_done(task, lease)
            return
        fut.add_done_callback(task.on_task_reply)
        if lease.conn.send_backlog > cfg.rpc_send_backlog_limit_bytes:
            # over budget after this push: pause dispatch onto this lease
            # (the pump skips draining/over-budget leases) and resume
            # pumping when the transport falls below the high-water mark
            self._drain_then_pump(
                task.class_key, lease, task.resources, task.strategy
            )

    def _drain_then_pump(self, class_key, lease: Lease, resources, strategy):
        """Await the lease connection's transport drain, then pump the
        class again.  One in-flight drain per lease; this is the awaiting
        fallback the call_soon contract requires (RT110)."""
        if lease.draining or lease.broken:
            return
        lease.draining = True

        async def _d():
            try:
                await lease.conn.drain()
            except (rpc.ConnectionLost, OSError):
                pass  # loss surfaces through the push reply futures
            finally:
                lease.draining = False
            self._pump_class(class_key, resources, strategy)

        self._loop.create_task(_d())

    def _on_task_push_reply(self, task: PendingTask, fut):
        lease = task.st
        try:
            if fut.cancelled():
                exc = rpc.ConnectionLost("push future cancelled")
            else:
                exc = fut.exception()
            if exc is None:
                reply = fut.result()
                try:
                    span = None
                    if type(reply) is tuple:
                        if len(reply) > 2:  # ("i", payload, t0, t1)
                            span = (reply[2], reply[3])
                    elif reply.get("exec_span"):
                        span = reply["exec_span"]
                    if span:
                        t0, t1 = span
                        self._record_exec(
                            task.name(), task.task_id.hex(),
                            lease.worker_id.hex()
                            if hasattr(lease.worker_id, "hex")
                            else str(lease.worker_id),
                            t0, t1 - t0,
                        )
                    self._apply_task_reply(task, reply)
                except Exception as e:  # noqa: BLE001
                    # the task RAN; a local failure applying its reply
                    # (e.g. result deserialization needs a worker-only
                    # module) must fail the ObjectRef, not re-queue the
                    # side effects and not leave the caller hanging on a
                    # never-resolved ref
                    self._fail_task(
                        task, TaskError.from_exception(
                            e, f"applying reply of {task.name()}"
                        )
                    )
            elif isinstance(exc, (rpc.ConnectionLost, rpc.RpcError, OSError)):
                # wire I/O failure ONLY reaches here before a reply is in
                # hand — break the lease and retry/fail (OSError covers
                # raw socket errors surfacing through the transport)
                self._task_push_failed(task, lease, exc)
            else:
                self._fail_task(task, TaskError(
                    "TaskDispatchError", repr(exc), "", task.name(),
                ))
        finally:
            self._dispatch_done(task, lease)

    def _task_push_failed(self, task: PendingTask, lease: Lease, exc):
        st = self._classes[task.class_key]
        lease.broken = True
        if task.retries_left > 0:
            task.retries_left -= 1
            st.queue.append(task)
        else:
            self._spawn(self._fail_task_worker_death(task, lease, exc))

    async def _fail_task_worker_death(self, task, lease, exc):
        # cold path: asking the GCS why the worker died needs an rpc
        detail = await self._worker_death_detail(lease.worker_id)
        self._fail_task(
            task,
            WorkerCrashedError(
                f"worker died while running {task.name()}: "
                f"{exc}{detail}"
            ),
        )

    def _dispatch_done(self, task: PendingTask, lease: Lease):
        class_key = task.class_key
        st = self._classes[class_key]
        self._inflight_dispatch.pop(task.return_ids[0], None)
        # the task may live on as a lineage record for as long as its
        # return refs do — drop the dispatch-time plumbing so a retained
        # record can't keep a dead Lease/Connection alive with it
        task.st = task.conn = None
        lease.inflight -= 1
        if lease.broken:
            if lease in st.leases:
                st.leases.remove(lease)
            self._spawn(
                self.gcs.notify(
                    "return_lease", {"lease_id": lease.lease_id, "broken": True}
                )
            )
        self._pump_class(class_key, task.resources, task.strategy)
        if not st.queue and lease.inflight == 0 and not lease.broken:
            self._schedule_lease_return(class_key, lease)

    def _schedule_lease_return(self, class_key, lease: Lease, grace: float = 0.25):
        def _return():
            st = self._classes.get(class_key)
            if st and lease in st.leases and lease.inflight == 0 and not st.queue:
                st.leases.remove(lease)
                self._spawn(
                    self.gcs.notify(
                        "return_lease", {"lease_id": lease.lease_id, "broken": False}
                    )
                )

        self._loop.call_later(grace, _return)

    def _apply_task_reply(self, task: PendingTask, reply: dict):
        if type(reply) is tuple:
            # compact single-inline-return shape ("i", payload) — the hot
            # actor-call reply (one tuple on the wire instead of
            # dict + returns list + item tuple)
            oid = task.return_ids[0]
            self._unhold_for_task(task.dep_oids)
            value = self._serialization.deserialize(reply[1])
            self.memory_store[oid] = value
            if oid in self._escaped and oid not in self._shared:
                try:
                    self.store.put(oid, reply[1], protect=True)
                    self._shared.add(oid)
                    self._gcs_object_notify(
                        "add_object_location",
                        {
                            "object_id": oid,
                            "node_id": bytes.fromhex(self.node_id),
                            "size": len(reply[1]),
                        },
                    )
                except ObjectExistsError:
                    self._shared.add(oid)
            self._cancel_requested.discard(oid)
            fut = self.result_futures.pop(oid, None)
            if (fut is not None and fut is not _PENDING_RESULT
                    and not fut.done()):
                fut.set_result(True)
            self._signal_sync_waiters(oid)
            self._maybe_release_after_reply(oid)
            return
        if reply["status"] == "error":
            self._fail_task(task, self._serialization.deserialize(reply["error"]))
            return
        if task.streaming:
            self._unhold_for_task(task.dep_oids)
            tid = task.task_id
            n = reply.get("streaming", 0)
            buf = self._streams.get(tid)
            consumed_upto = self._abandoned_streams.pop(tid, None)
            if buf is not None:
                buf.complete(n)
            elif consumed_upto is not None and n > consumed_upto:
                # consumer abandoned mid-stream: free the producer-stored
                # items it never took
                oids = [
                    ObjectID.for_task_return(TaskID(tid), i).binary()
                    for i in range(consumed_upto, n)
                ]
                self._gcs_object_notify("free_objects", {"object_ids": oids})
            return
        self._unhold_for_task(task.dep_oids)
        for oid, ret in zip(task.return_ids, reply["returns"]):
            kind = ret[0]
            if kind == "inline":
                value = self._serialization.deserialize(ret[1])
                self.memory_store[oid] = value
                if oid in self._escaped and oid not in self._shared:
                    # a borrower is waiting on the shared store: publish the
                    # raw serialized bytes there now — as a PROTECTED
                    # primary (an unprotected copy is LRU-evictable and the
                    # borrower's pull would find nothing)
                    try:
                        self.store.put(oid, ret[1], protect=True)
                        self._shared.add(oid)
                        self._gcs_object_notify(
                            "add_object_location",
                            {
                                "object_id": oid,
                                "node_id": bytes.fromhex(self.node_id),
                                "size": len(ret[1]),
                            },
                        )
                    except ObjectExistsError:
                        self._shared.add(oid)
            else:  # stored in shm on the producing node
                pass  # resolvable via store/pull path
            self._cancel_requested.discard(oid)
            fut = self.result_futures.pop(oid, None)
            if (fut is not None and fut is not _PENDING_RESULT
                    and not fut.done()):
                fut.set_result(True)
            self._signal_sync_waiters(oid)
            self._maybe_release_after_reply(oid)

    def _fail_task(self, task: PendingTask, exc: Exception):
        self._unhold_for_task(task.dep_oids)
        if task.streaming:
            # already-delivered items stay readable; the consumer's next()
            # raises.  Never write _RaiseOnGet into return oids here — item
            # 0 shares its oid with return id 0 and may hold a real value.
            tid = task.task_id
            self._abandoned_streams.pop(tid, None)
            buf = self._streams.get(tid)
            if buf is not None:
                buf.fail(exc)
            return
        for oid in task.return_ids:
            self._cancel_requested.discard(oid)
            self.memory_store[oid] = _RaiseOnGet(exc)
            fut = self.result_futures.pop(oid, None)
            if (fut is not None and fut is not _PENDING_RESULT
                    and not fut.done()):
                fut.set_result(True)
            self._signal_sync_waiters(oid)
            self._maybe_release_after_reply(oid)

    # ---- actors (client side) ------------------------------------------
    def create_actor(
        self,
        cls,
        args,
        kwargs,
        *,
        name=None,
        namespace="default",
        get_if_exists=False,
        num_returns=1,
        resources=None,
        max_restarts=0,
        max_task_retries=0,
        detached=False,
        strategy=None,
        runtime_env=None,
        max_concurrency=None,
        concurrency_groups=None,
        method_groups=None,
        on_drain="migrate",
    ) -> "ActorID":
        actor_id = ActorID.random()
        rtenv_desc = self._normalize_runtime_env(runtime_env)
        cls_hash = self.fn_hash_and_register(cls)
        creation_spec = {
            "cls_hash": cls_hash,
            "args": self._pack_args(args, kwargs),
            "max_task_retries": max_task_retries,
            "job": self._job_hex(),
        }
        if max_concurrency is not None:
            creation_spec["max_concurrency"] = int(max_concurrency)
        if concurrency_groups:
            # named groups with per-group limits (reference:
            # python/ray/actor.py:521-539 concurrency_groups)
            creation_spec["concurrency_groups"] = {
                str(k): int(v) for k, v in concurrency_groups.items()
            }
            creation_spec["method_groups"] = dict(method_groups or {})
        resources = dict(resources if resources is not None else {"CPU": 1})
        reply = self._run(
            self.gcs.call(
                "register_actor",
                {
                    "actor_id": actor_id.binary(),
                    "job_id": self.job_id.binary() if self.job_id else None,
                    "name": name,
                    "namespace": namespace,
                    "get_if_exists": get_if_exists,
                    "max_restarts": max_restarts,
                    "creation_spec": creation_spec,
                    "resources": resources,
                    "strategy": strategy or {},
                    "detached": detached,
                    "runtime_env": rtenv_desc,
                    "on_drain": on_drain,
                },
            )
        )
        if reply.get("existing"):
            return ActorID(reply["actor_id"])
        self._spawn(self._create_actor_async(actor_id, creation_spec, resources,
                                             strategy or {}, rtenv_desc))
        return actor_id

    async def _create_actor_async(self, actor_id, creation_spec, resources,
                                  strategy, runtime_env=None):
        pending_backoff = None  # built on first LEASE_PENDING only
        try:
            while True:
                try:
                    grant = await self.gcs.call(
                        "request_lease",
                        {
                            "resources": resources,
                            "strategy": strategy,
                            "actor_id": actor_id.binary(),
                            "runtime_env": runtime_env,
                        },
                        timeout=cfg.sched_max_pending_lease_s
                        + cfg.worker_start_timeout_s,
                    )
                    break
                except rpc.RemoteCallError as e:
                    # capacity-pending: keep waiting — an actor whose demand
                    # is feasible must eventually place (infeasible demands
                    # error immediately at the GCS instead)
                    if "LEASE_PENDING" in str(e.remote_exception):
                        if pending_backoff is None:
                            pending_backoff = lease_pending_backoff()
                        await pending_backoff.wait()
                        continue
                    raise
            conn = await self._connect_worker(
                grant["worker_addr"], grant.get("node_id")
            )
            # No wall-clock deadline on __init__: arbitrarily long startup
            # (torch import, CUDA init, first kernel build) is legal as long as
            # the worker process is alive — its death breaks this TCP
            # connection, which is the liveness signal (the reference's
            # analogue: actor creation has no fixed timeout either; failure
            # is detected via worker death, gcs_actor_manager.cc).
            await conn.call(
                "create_actor",
                {
                    "actor_id": actor_id.binary(),
                    "creation_spec": creation_spec,
                },
                timeout=-1,
            )
            await self.gcs.call(
                "actor_started",
                {
                    "actor_id": actor_id.binary(),
                    "worker_addr": grant["worker_addr"],
                    "node_id": grant["node_id"],
                    "lease_id": grant["lease_id"],
                },
            )
            self._actor_addrs[actor_id.binary()] = grant["worker_addr"]
        except Exception as e:
            logger.warning("actor creation failed: %r", e)
            try:
                await self.gcs.call(
                    "actor_creation_failed",
                    {"actor_id": actor_id.binary(), "reason": repr(e)},
                )
            except Exception:
                pass

    async def _actor_conn(self, actor_id: bytes):
        """Connection to the actor's worker, waiting through PENDING/RESTARTING.

        Liveness-based, not deadline-based: an actor may spend minutes in
        __init__ (CUDA init + a first kernel build routinely exceed any
        fixed budget).  The GCS is the liveness authority — worker/node death
        transitions the actor to DEAD (or RESTARTING → replay), so waiting on
        a non-DEAD state can only block while the creation is genuinely in
        progress."""
        conn = self._actor_conns.get(actor_id)
        if conn is not None and not conn.closed:
            return conn
        # stale-address redials + state polls ride the shared backoff
        # policy (liveness-based wait: no deadline, the GCS's DEAD
        # transition is the exit)
        retry_backoff = Backoff(BackoffPolicy(
            base_s=cfg.backoff_base_s, mult=cfg.backoff_mult,
            max_s=1.0, jitter_frac=cfg.backoff_jitter_frac,
        ))
        while True:
            info = await self.gcs.call(
                "get_actor", {"actor_id": actor_id, "wait": 5.0}, timeout=-1
            )
            if info is None:
                raise ActorDiedError(f"actor {actor_id.hex()[:12]} unknown")
            if info["state"] == "ALIVE" and info["worker_addr"]:
                try:
                    conn = await rpc.connect(
                        info["worker_addr"], self._worker_inbound,
                        name="->actor",
                        # label for the partition plane: the actor's
                        # hosting node is its network identity
                        peer_endpoint=info.get("node_id"),
                    )
                    self._actor_conns[actor_id] = conn
                    self._actor_addrs[actor_id] = info["worker_addr"]
                    return conn
                except OSError:
                    pass  # stale address; retry
            elif info["state"] == "DEAD":
                raise ActorDiedError(
                    f"actor {actor_id.hex()[:12]} is dead: {info.get('death_cause')}"
                )
            await retry_backoff.wait()

    def make_actor_skeleton(
        self,
        actor_id: ActorID,
        method_name: str,
        num_returns=1,
        concurrency_group: Optional[str] = None,
    ) -> tuple:
        """(spec skeleton, fill_job) for one actor method / option-set —
        the actor twin of make_task_template, cached by ActorMethod."""
        skeleton = {
            "task_id": b"",  # filled per call
            "actor_id": actor_id.binary(),
            "method": method_name,
            "args": (),      # filled per call
            "num_returns": 1 if num_returns == "streaming" else num_returns,
            "caller_id": self.worker_id.binary(),
            # seq/seq_epoch are assigned at push time by the actor pump
        }
        if num_returns == "streaming":
            skeleton["streaming"] = True
        if concurrency_group:
            skeleton["concurrency_group"] = concurrency_group
        fill_job = self.job_id is None
        if not fill_job:
            skeleton["job"] = self._job_hex()
        return skeleton, fill_job

    def submit_actor_task_from_skeleton(
        self, skeleton: dict, fill_job: bool, args, kwargs, retries: int = 0
    ):
        """Hot-path actor submit.  Returns a bare ObjectRef for a single
        return, a list otherwise, an ObjectRefGenerator when streaming."""
        aid = skeleton["actor_id"]
        task_id = os.urandom(16)
        sub_idx = self._actor_seq.get(aid, 0)
        self._actor_seq[aid] = sub_idx + 1
        streaming = "streaming" in skeleton
        if streaming:
            retries = 0  # re-running a generator would double-send items
        spec = dict(skeleton)
        spec["task_id"] = task_id
        spec["args"] = self._pack_args(args, kwargs)
        if fill_job:
            spec["job"] = self._job_hex()
        if tracing.enabled():
            with tracing.span(
                f"submit {spec['method']}", task_id=task_id.hex(),
                actor_id=aid.hex(),
            ):
                spec["trace_ctx"] = tracing.inject()
        n = spec["num_returns"]
        if n == 1:
            return_ids = (task_return_binary(task_id, 0),)
        else:
            return_ids = tuple(
                task_return_binary(task_id, i) for i in range(n)
            )
        dep_oids = () if not spec["args"] else [
            item[1] if item[0] == "ref" else item[2]
            for item in spec["args"]
            if item[0] in ("ref", "kwref")
        ]
        task = PendingTask(
            spec, return_ids, retries, sub_idx=sub_idx, dep_oids=dep_oids,
            task_id=task_id, streaming=streaming,
        )
        if dep_oids:
            self._hold_for_task(dep_oids)
        if streaming:
            self._streams[task_id] = _StreamBuf()
            self._submit_to_loop(task)
            return ObjectRefGenerator(task_id)
        for oid in return_ids:
            self.result_futures[oid] = _PENDING_RESULT
        if n == 1:
            ref = ObjectRef(ObjectID(return_ids[0]))
            self._submit_to_loop(task)
            return ref
        refs = [ObjectRef(ObjectID(oid)) for oid in return_ids]
        self._submit_to_loop(task)
        return refs

    def submit_actor_task(
        self,
        actor_id: ActorID,
        method_name: str,
        args,
        kwargs,
        num_returns: int = 1,
        retries: int = 0,
        concurrency_group: Optional[str] = None,
    ):
        """Untemplated actor submit (compatibility surface); returns a
        list of refs (or a generator) like it always did."""
        skeleton, fill_job = self.make_actor_skeleton(
            actor_id, method_name, num_returns, concurrency_group
        )
        out = self.submit_actor_task_from_skeleton(
            skeleton, fill_job, args, kwargs, retries
        )
        if isinstance(out, ObjectRef):
            return [out]
        return out

    def _enqueue_actor_task(self, task: PendingTask):
        aid = task.spec["actor_id"]
        st = self._actor_states.get(aid)
        if st is None:
            st = self._actor_states[aid] = ActorClientState(
                queue=deque(), wake=asyncio.Event()
            )
        # Fast path (the hot loop for steady traffic): connection is
        # live and nothing is queued ahead — assign the wire seq inline
        # and push directly, skipping the pump wake hop.  Safe because
        # this runs on the io loop (serial with the pump's drain, which
        # never awaits mid-drain), so submission order == wire order is
        # preserved; the task lands in st.inflight like any other, so
        # the pump's reconnect replay still covers it.
        if (
            st.pump_running
            and not st.dead
            and st.conn is not None
            and not st.conn.closed
            and not st.queue
            # a stalled peer's write buffer must push new calls onto the
            # queue so the PUMP (which awaits drain) provides the flow
            # control call_soon skips
            and st.conn.send_backlog < cfg.rpc_send_backlog_limit_bytes
        ):
            if not self._consume_cancel_flag(task):
                task.spec["seq"] = st.wire_seq
                task.spec["seq_epoch"] = st.epoch
                st.wire_seq += 1
                st.inflight[task.sub_idx] = task
                self._dispatch_actor_push(aid, st, st.conn, task)
            return
        st.queue.append(task)
        st.wake.set()
        if not st.pump_running:
            st.pump_running = True
            self._loop.create_task(self._actor_pump(aid, st))

    async def _actor_pump(self, aid: bytes, st: ActorClientState):
        """Single pusher per actor: establishes the connection, assigns
        wire (epoch, seq) pairs in submission order, and re-pushes unacked
        calls — still in submission order — after a connection loss."""
        while True:
            while st.queue or st.inflight:
                if st.conn is None or st.conn.closed:
                    # requeue unacked calls ahead of fresh ones, in order
                    if st.inflight:
                        requeue = []
                        for k in sorted(st.inflight):
                            t = st.inflight.pop(k)
                            if t.retries_left == 0:
                                self._fail_task(
                                    t,
                                    ActorDiedError(
                                        f"actor {aid.hex()[:12]} died while "
                                        f"running {t.spec['method']}"
                                    ),
                                )
                                continue
                            if t.retries_left > 0:
                                t.retries_left -= 1
                            requeue.append(t)
                        st.queue.extendleft(reversed(requeue))
                    if not st.queue and not st.inflight:
                        break
                    self._actor_conns.pop(aid, None)
                    try:
                        st.conn = await self._actor_conn(aid)
                    except ActorDiedError as e:
                        for t in list(st.queue):
                            self._fail_task(t, e)
                        st.queue.clear()
                        st.dead = True
                        break
                    st.epoch += 1
                    st.wire_seq = 0
                while st.queue:
                    t = st.queue.popleft()
                    if self._consume_cancel_flag(t):
                        continue
                    t.spec["seq"] = st.wire_seq
                    t.spec["seq_epoch"] = st.epoch
                    st.wire_seq += 1
                    st.inflight[t.sub_idx] = t
                    self._dispatch_actor_push(aid, st, st.conn, t)
                    if (
                        st.conn is not None
                        and st.conn.send_backlog
                        > cfg.rpc_send_backlog_limit_bytes
                    ):
                        # flow control: call_soon skipped drain(), so the
                        # pump awaits it — a stalled actor must apply
                        # backpressure to submitters, not buffer every
                        # serialized call in the transport until OOM
                        try:
                            await st.conn.drain()
                        except (rpc.ConnectionLost, OSError):
                            break  # loss path re-queues via st.inflight
                st.wake.clear()
                if st.inflight:
                    # woken by new submissions, a connection break, or the
                    # last in-flight reply landing (so the pump can exit)
                    st.draining = True
                    try:
                        await st.wake.wait()
                    finally:
                        st.draining = False
            if st.dead:
                st.pump_running = False
                return
            # idle: stay RESIDENT, parked on the wake event — exiting
            # here made every serial caller pay a pump restart per call.
            # Park with a timeout so pumps of killed/idle actors retire
            # instead of leaking a task per dead actor forever (nothing
            # wakes an idle pump when its actor is killed).
            st.wake.clear()
            # re-check BOTH queue and inflight: an eager fast-path submit
            # places the task straight into st.inflight, so a pump that
            # retires on an empty queue alone would orphan it — a later
            # connection loss then has no pump to re-push it.
            if not st.queue and not st.inflight:
                try:
                    await asyncio.wait_for(st.wake.wait(), timeout=60.0)
                except asyncio.TimeoutError:
                    if not st.queue and not st.inflight:
                        st.pump_running = False
                        return

    def _dispatch_actor_push(
        self, aid: bytes, st: ActorClientState, conn, task: PendingTask
    ):
        """Fire the push and attach the reply callback — NO per-call
        coroutine/Task (the old awaiting-coroutine shape cost a Task
        object + frame per call on the submission hot path)."""
        task.rt = self
        task.st = st
        task.conn = conn
        # the task itself is the dispatch registry entry (task_id + conn
        # ride its slots) — no per-call tuple
        self._inflight_dispatch[task.return_ids[0]] = task
        try:
            # RT110 audited + baselined: backlog policing lives in the
            # CALLERS — the pump awaits drain() past the budget after
            # each push, and the _enqueue_actor_task fast path only
            # dispatches while send_backlog is under budget
            fut = conn.call_soon("push_actor_task", task.spec)
        except (rpc.ConnectionLost, OSError):
            # Leave the task in st.inflight; the pump reconnects and
            # re-pushes.  Only signal if WE carry the current connection.
            # Clean the dispatch entry (the callback path's finally does
            # this) — a stale entry would make cancel() target a dead
            # conn instead of flagging the re-push for drop-on-arrival.
            cur = self._inflight_dispatch.get(task.return_ids[0])
            if cur is not None and cur.conn is conn:
                self._inflight_dispatch.pop(task.return_ids[0], None)
            if st.conn is conn:
                st.conn = None
                st.wake.set()
            return
        # bound method, not a closure: rt/st/conn ride the task's slots,
        # so the reply callback costs one object instead of fn + cells
        fut.add_done_callback(task.on_push_reply)

    def _on_push_reply(
        self, st: ActorClientState, conn, task: PendingTask, fut
    ):
        try:
            exc = None if fut.cancelled() else fut.exception()
            if fut.cancelled():
                exc = rpc.ConnectionLost("push future cancelled")
            if exc is None:
                st.inflight.pop(task.sub_idx, None)
                if not st.inflight and st.draining:
                    # wake ONLY a pump parked mid-drain on this event;
                    # waking the idle 60s park costs a task resume +
                    # fresh timer per call, which dominated the serial
                    # sync-call path
                    st.wake.set()
                self._apply_task_reply(task, fut.result())
            elif isinstance(exc, (rpc.ConnectionLost, OSError)):
                # ConnectionLost subclasses RpcError: checked FIRST.
                # Leave the task in st.inflight; the pump reconnects and
                # re-pushes.  Only signal if WE carry the current
                # connection — a stale callback observing an old conn's
                # loss after the pump already reconnected must not
                # clobber the fresh one.
                if st.conn is conn:
                    st.conn = None
                    st.wake.set()
            elif isinstance(exc, rpc.RpcError):
                st.inflight.pop(task.sub_idx, None)
                if not st.inflight and st.draining:
                    st.wake.set()
                self._fail_task(task, TaskError(
                    "ActorCallError", str(exc), "", task.spec["method"]
                ))
            else:
                st.inflight.pop(task.sub_idx, None)
                if not st.inflight and st.draining:
                    st.wake.set()
                self._fail_task(task, TaskError(
                    "ActorCallError", repr(exc), "", task.spec["method"]
                ))
        finally:
            cur = self._inflight_dispatch.get(task.return_ids[0])
            if cur is not None and cur.conn is conn:
                self._inflight_dispatch.pop(task.return_ids[0], None)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True):
        self._run(
            self.gcs.call(
                "kill_actor",
                {"actor_id": actor_id.binary(), "no_restart": no_restart},
            )
        )

    # ---- misc ----------------------------------------------------------
    def cancel(self, ref: ObjectRef) -> bool:
        """Cancel the task producing ``ref``.

        Queued client-side → removed before dispatch.  Already running →
        a ``cancel_task`` RPC interrupts the executing thread on the worker
        (reference: CoreWorker::CancelTask → HandleCancelTask raising
        TaskCancelledError in the Cython execution wrapper; interruption is
        best-effort at bytecode boundaries, like the reference)."""
        return self._run(self._cancel_async(ref.object_id.binary()))

    async def _cancel_async(self, oid: bytes) -> bool:
        # On the io loop: serialized with enqueue/dispatch, no scan races.
        for st in self._classes.values():
            for task in list(st.queue):
                if oid in task.return_ids:
                    st.queue.remove(task)
                    self._fail_task(task, TaskCancelledError(oid.hex()))
                    return True
        for ast in self._actor_states.values():
            for task in list(ast.queue):
                if oid in task.return_ids:
                    ast.queue.remove(task)
                    self._fail_task(task, TaskCancelledError(oid.hex()))
                    return True
        entry = self._inflight_dispatch.get(oid)
        if entry is not None and entry.conn is not None:
            self._spawn(
                entry.conn.call("cancel_task", {"task_id": entry.task_id})
            )
            return True
        if oid in self.result_futures:
            # submitted but not yet enqueued (waiting on local deps):
            # flag it; _enqueue_task drops it on arrival
            self._cancel_requested.add(oid)
            return True
        return False

    def free(self, refs: List[ObjectRef]):
        oids = [r.object_id.binary() for r in refs]
        for oid in oids:
            self.memory_store.pop(oid, None)
            self._shared.discard(oid)
        # windowed location announces must reach the GCS before the free
        # (a free seen first plants a tombstone and the late announce is
        # dropped — the stored primary would never be deleted)
        self.flush_object_notifies()
        self._run(self.gcs.call("free_objects", {"object_ids": oids}))

    # ---- distributed refcounting ---------------------------------------
    def on_ref_created(self, object_id: ObjectID):
        oid = object_id.binary()
        with self._ref_lock:
            n = self._local_refs.get(oid, 0) + 1
            self._local_refs[oid] = n
            if n == 1:
                if oid in self._pending_ref_del:
                    # re-created before the release flushed: net effect is
                    # "still held" — cancel the pending del
                    self._pending_ref_del.discard(oid)
                    self._ref_registered.add(oid)
                elif oid not in self._ref_registered:
                    self._ref_registered.add(oid)
                    self._pending_ref_add.add(oid)
                    self._schedule_ref_flush()

    def on_ref_deleted(self, object_id: ObjectID):
        oid = object_id.binary()
        with self._ref_lock:
            n = self._local_refs.get(oid, 0) - 1
            if n > 0:
                self._local_refs[oid] = n
                return
            self._local_refs.pop(oid, None)
            if self._task_holds.get(oid, 0) > 0:
                return  # still pinned as an in-flight task dependency
        self._release_local(oid)

    def _hold_for_task(self, oids):
        with self._ref_lock:
            for oid in oids:
                self._task_holds[oid] = self._task_holds.get(oid, 0) + 1

    def _unhold_for_task(self, oids):
        released = []
        with self._ref_lock:
            for oid in oids:
                n = self._task_holds.get(oid, 0) - 1
                if n > 0:
                    self._task_holds[oid] = n
                else:
                    self._task_holds.pop(oid, None)
                    if self._local_refs.get(oid, 0) == 0:
                        released.append(oid)
        for oid in released:
            self._release_local(oid)

    def _release_local(self, oid: bytes):
        """Last local reference (and task hold) is gone: drop the local
        value and tell the GCS this process no longer holds the object."""
        if self._closed:
            return
        was_shared = oid in self._shared
        self.memory_store.pop(oid, None)
        self._shared.discard(oid)
        self._escaped.discard(oid)
        self._release_lineage_return(oid)
        with self._ref_lock:
            self._deferred_reg.discard(oid)
            if oid in self._ref_registered:
                self._ref_registered.discard(oid)
                if (
                    oid in self._pending_ref_add
                    and not was_shared
                    and oid not in self.result_futures
                ):
                    # the add never went out and nothing cluster-side
                    # exists (local-only value, no in-flight outcome):
                    # cancel the pair outright instead of planting a
                    # holder entry the GCS would never delete
                    self._pending_ref_add.discard(oid)
                else:
                    # the del is sent in the same or a later window as its
                    # add (adds flush before dels; an add parked for an
                    # in-flight result HOLDS its del — see
                    # _flush_ref_events): the GCS must see the holder set
                    # empty to free any stored copies
                    self._pending_ref_del.add(oid)
                    self._schedule_ref_flush()

    def _schedule_ref_flush(self):
        # caller holds _ref_lock (every call site takes it; the flush
        # callback clears the flag under it too) — locked, just not
        # lexically here, which is past what rtrace can see
        if self._ref_flush_scheduled or self._closed:
            return
        # rtlint: disable-next=RT301
        self._ref_flush_scheduled = True
        try:
            self._loop.call_soon_threadsafe(
                self._loop.call_later, cfg.ref_flush_interval_s,
                self._flush_ref_events,
            )
        except RuntimeError:
            # loop closing; same caller-held _ref_lock as the set above
            # rtlint: disable-next=RT301
            self._ref_flush_scheduled = False

    def _flush_ref_events(self):
        with self._ref_lock:
            add = []
            revisit = []
            for oid in self._pending_ref_add:
                if (
                    oid in self.memory_store
                    and oid not in self._shared
                    and oid not in self._escaped
                ):
                    # LOCAL-ONLY inline result: its value lives solely in
                    # this process's memory store and no other process can
                    # reach the ref (escape requires serialization, which
                    # promotes via ensure_shared first) — cluster-wide
                    # holder tracking would be 2 GCS messages + free
                    # scheduling per task for nothing (the dominant
                    # per-task GCS cost for small-result task storms).
                    # ensure_shared re-registers on a later escape.
                    self._ref_registered.discard(oid)
                    self._deferred_reg.add(oid)
                elif oid in self.result_futures and oid not in self._escaped:
                    # OUR in-flight task return: nothing exists cluster-
                    # side yet, so a holder add is premature — re-check
                    # next flush window once the reply landed (then it
                    # either defers as inline-local or registers as
                    # stored).  Safe against the GCS free machinery:
                    # frees are only scheduled on holder-set DELETIONS,
                    # never on first registration of locations.
                    revisit.append(oid)
                else:
                    add.append(oid)
            # a del whose add is still parked must WAIT for it (an
            # unpaired del is a GCS no-op and the later add would plant a
            # holder entry nothing deletes — the fire-and-forget leak)
            revisit_set = set(revisit)
            dels = [
                oid for oid in self._pending_ref_del
                if oid not in revisit_set
            ]
            held_dels = [
                oid for oid in self._pending_ref_del if oid in revisit_set
            ]
            self._pending_ref_add.clear()
            self._pending_ref_add.update(revisit)
            self._pending_ref_del.clear()
            self._pending_ref_del.update(held_dels)
            self._ref_flush_scheduled = False
            if revisit:
                self._schedule_ref_flush()
        if (add or dels) and self.gcs and not self.gcs.closed:
            # rides the object-notify coalescer: a ref window that
            # coincides with pending location announces shares their rpc
            self._gcs_object_notify(
                "ref_update",
                {
                    "holder": self.worker_id.binary(),
                    "add": add,
                    "del": dels,
                },
            )

    def _maybe_release_after_reply(self, oid: bytes):
        """A task reply landed a value for ``oid`` but every ref died while
        the task ran — release immediately so unobserved results can't
        accumulate in the memory store."""
        with self._ref_lock:
            live = self._local_refs.get(oid, 0) > 0 or self._task_holds.get(
                oid, 0
            ) > 0
        if not live:
            self._release_local(oid)

    # ---- lineage + reconstruction --------------------------------------
    def _record_lineage(self, task: PendingTask):
        budget = cfg.lineage_reconstruction_max
        if budget <= 0:
            return
        # the PendingTask IS the lineage record (slotted store): liveness
        # is a bitmask over return_ids positions, the budget an int slot —
        # zero container allocations per recorded task
        task.lineage_budget = budget
        task.live_mask = (1 << len(task.return_ids)) - 1
        self._lineage.insert(task)
        by_ret = self._lineage_by_return
        for oid in task.return_ids:
            by_ret[oid] = task

    def _release_lineage_return(self, oid: bytes):
        rec = self._lineage_by_return.pop(oid, None)
        if rec is None:
            return
        rids = rec.return_ids
        if len(rids) == 1:
            rec.live_mask = 0
        else:
            try:
                rec.live_mask &= ~(1 << rids.index(oid))
            except ValueError:
                pass
        if rec.live_mask == 0:
            self._lineage.remove(rec.task_id)

    async def _try_reconstruct(self, oid: bytes) -> bool:
        """Re-execute the task that produced ``oid`` (lineage recovery).

        Returns True if a reconstruction is running (caller loops back to
        waiting on the result future).  Runs on the io loop."""
        rec = self._lineage_by_return.get(oid)
        if rec is None:
            return False
        if rec.recon_inflight or oid in self.result_futures:
            return True  # already being reconstructed
        if rec.lineage_budget <= 0:
            return False
        rec.lineage_budget -= 1
        rec.recon_inflight = True
        self.reconstructions += 1
        try:
            logger.info(
                "reconstructing object %s via task %s (budget left %d)",
                oid.hex()[:12], rec.task_id.hex()[:12], rec.lineage_budget,
            )
            # Recover dependencies first: resolving them triggers their own
            # reconstruction recursively through this same path, then
            # re-promote each to the shared store for the executing worker.
            for dep in rec.dep_oids:
                value = await self._resolve_one(dep, None)
                if not self.store.contains(dep):
                    self._shared.discard(dep)
                    self._write_to_store(
                        dep, self._serialization.serialize(value)
                    )
            # fresh dispatchable task sharing the record's immutable state
            # (the record itself stays in the slot tracking budget/liveness)
            task = PendingTask(
                rec.spec, rec.return_ids,
                retries_left=0,
                class_key=rec.class_key,
                resources=rec.resources,
                strategy=rec.strategy,
                tmpl=rec.tmpl, task_id=rec.task_id, args=rec.args,
                job=rec.job, streaming=rec.streaming,
            )
            for roid in rec.return_ids:
                if roid not in self.result_futures:
                    self.memory_store.pop(roid, None)
                    self.result_futures[roid] = _PENDING_RESULT
            self._enqueue_task(task)
            return True
        finally:
            rec.recon_inflight = False

    def cluster_resources(self) -> dict:
        return self._run(self.gcs.call("cluster_resources", {}))

    def nodes(self) -> list:
        return self._run(self.gcs.call("get_nodes", {}))


class _StreamBuf:
    """Caller-side buffer of one streaming task's delivered item indexes.

    The io loop delivers (`deliver`, `complete`, `fail`); the consumer
    thread waits in `Runtime.stream_next` on `cond`.  Item values live in
    the runtime memory store / shm keyed by for_task_return(tid, idx) —
    this tracks only arrival and ordering."""

    __slots__ = (
        "cond", "items", "next_idx", "count", "failed", "conn",
        "cancel_state", "aev",
    )

    def __init__(self):
        self.cond = threading.Condition()
        self.items: set = set()   # delivered, not yet consumed indexes
        self.next_idx = 0
        self.count: Optional[int] = None  # total items once producer done
        self.failed: Optional[Exception] = None
        self.conn = None  # connection items arrived on (for acks/cancel)
        self.cancel_state = 0  # 0 none, 1 requested (conn unknown), 2 sent
        # loop-native waiter (stream_next_async); all signal paths run ON
        # the io loop, so setting an asyncio.Event here is safe
        self.aev: Optional[Any] = None

    def _signal(self):
        self.cond.notify_all()
        if self.aev is not None:
            self.aev.set()

    def deliver(self, idx: int, conn):
        with self.cond:
            self.items.add(idx)
            self.conn = conn
            self._signal()

    def complete(self, count: int):
        with self.cond:
            self.count = count
            self._signal()

    def fail(self, exc: Exception):
        with self.cond:
            self.failed = exc
            self._signal()


class ObjectRefGenerator:
    """Iterator over a streaming task's return refs (reference:
    ObjectRefGenerator, python/ray/_raylet.pyx:273).  Each next() blocks
    until the producer has yielded the next item and returns an ObjectRef
    resolvable with ray_tpu_torch.get; a mid-stream producer error arrives as a
    ref whose get raises, after which the stream ends."""

    def __init__(self, task_id: bytes):
        self._task_id = task_id
        self._exhausted = False

    def __iter__(self):
        return self

    def __next__(self) -> "ObjectRef":
        if self._exhausted:
            raise StopIteration
        try:
            return get_runtime().stream_next(self._task_id)
        except StopIteration:
            self._exhausted = True
            raise

    def __aiter__(self):
        return self

    async def __anext__(self) -> "ObjectRef":
        if self._exhausted:
            raise StopAsyncIteration
        try:
            return await get_runtime().stream_next_async(self._task_id)
        except (StopIteration, StopAsyncIteration):
            self._exhausted = True
            raise StopAsyncIteration from None

    def next_with_timeout(self, timeout: float) -> "ObjectRef":
        return get_runtime().stream_next(self._task_id, timeout=timeout)

    @property
    def task_id(self) -> bytes:
        return self._task_id

    def __del__(self):
        if not self._exhausted:
            try:
                get_runtime().stream_abandon(self._task_id)
            except Exception:
                pass

    def __repr__(self):
        return f"ObjectRefGenerator({self._task_id.hex()[:16]})"


# get()-fast-path sentinel: "this ref needs the full async resolve path"
_SYNC_MISS = object()


class _RaiseOnGet:
    """Sentinel stored in the memory store for errored returns."""

    __slots__ = ("exc",)

    def __init__(self, exc: Exception):
        self.exc = exc


def _delayed_exit():
    time.sleep(0.1)
    os._exit(0)
