"""Raylet: the per-node daemon — worker pool, store owner, object transfer.

Role-equivalent of the reference's raylet (ray: src/ray/raylet/raylet.h:37,
node_manager.h:125, worker_pool.h:156, object_manager/object_manager.h:117)
with a deliberately smaller job: scheduling decisions live in the GCS (see
gcs.py header), so the raylet is (1) a worker process factory with
accelerator-aware reuse, (2) the owner of the node's shm object store, and
(3) the node-to-node object transfer endpoint (PullManager/PushManager
analogue, pull-based).

GPU ownership model: a lease with ``GPU > 0`` carries an explicit card
assignment (``CUDA_VISIBLE_DEVICES``) decided here, drawn from a free set of
card indices; every other lease gets ``CUDA_VISIBLE_DEVICES=""`` and sees no
card.  Index k names the k-th card of the driver's visible set
(``RT_GPU_VISIBLE_DEVICES``, node.py), or card k when the driver had none.
A worker is forever bound to the first accelerator env it receives (CUDA
reads the variable once, when it initialises); idle workers are reused only
on exact-match bindings, and idle workers whose cards conflict with a new
allocation are killed (ray's env-var dance at
python/ray/_private/accelerators/nvidia_gpu.py is per-task; here it is a
lease-time contract).
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set

from ray_tpu_torch._native.store import ObjectExistsError, ShmStore, default_capacity
from ray_tpu_torch.common import faults
from ray_tpu_torch.common.config import cfg
from ray_tpu_torch.common.constants import session_root
from ray_tpu_torch.common.ids import NodeID, WorkerID
from ray_tpu_torch.core import rpc
from ray_tpu_torch.core.errors import FencedError, is_fenced

logger = logging.getLogger(__name__)

#: Pull-source shuffle: one private instance instead of the module-global
#: random state, so the load-spreading shuffle neither perturbs nor is
#: perturbed by seeded user code (and stays outside RT116's
#: unseeded-global-RNG scope if the soak lint ever widens)
_PULL_SHUFFLE_RNG = random.Random()

#: Spill files are written and read in slices of this size (see
#: ``Raylet._write_file`` and ``Raylet._read_into_store``)
_IO_SLICE_BYTES = 64 << 20

#: FaultPlan.delay_s's field default — a node.preempt plan that never set
#: delay_s means "use the config drain deadline", not a 50 ms drain
_PLAN_DELAY_DEFAULT = faults.FaultPlan.__dataclass_fields__[
    "delay_s"
].default


@dataclass
class WorkerEntry:
    worker_id: WorkerID
    proc: subprocess.Popen
    conn: Optional[rpc.Connection] = None  # worker's connection to us
    addr: Optional[str] = None  # worker's own rpc server address
    bound_env: Optional[Dict[str, str]] = None  # accelerator env, once set
    rtenv_key: str = ""  # runtime-env binding (core/runtime_env.py)
    venv_key: str = ""   # pip-env interpreter this worker was spawned with
    lease_id: Optional[int] = None
    gpus: tuple = ()  # card indices of its binding
    started_at: float = field(default_factory=time.monotonic)
    leased_at: float = 0.0  # monotonic time of the CURRENT lease grant
    # containerized workers: `docker/podman kill <name>` argv — SIGKILL
    # on `proc` (the run CLIENT) never reaches the container
    container_kill_argv: Optional[list] = None

    @property
    def idle(self) -> bool:
        return self.lease_id is None and self.conn is not None


def _whole_gpus(resources: Dict[str, float]) -> int:
    """Cards a lease is given: a fractional GPU sees one whole card."""
    n = int(resources.get("GPU", 0))
    if n <= 0 and resources.get("GPU", 0) > 0:
        n = 1
    return n


class Raylet:
    def __init__(
        self,
        gcs_address: str,
        node_id: Optional[NodeID] = None,
        host: str = "127.0.0.1",
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        store_capacity: int = 0,
        session_dir: Optional[str] = None,
    ):
        self.gcs_address = gcs_address
        self.node_id = node_id or NodeID.random()
        self.host = host
        self.labels = labels or {}
        self.session_dir = session_dir or session_root()
        self.resources = resources or {}
        self.store_path = os.path.join(
            "/dev/shm", f"rt_store_{self.node_id.hex()[:12]}"
        )
        self.store_capacity = store_capacity or default_capacity()
        self.store: Optional[ShmStore] = None
        self.server = rpc.Server(self._handle, host=host, port=0)
        self.gcs: Optional[rpc.Connection] = None
        self.workers: Dict[WorkerID, WorkerEntry] = {}
        self._idle_by_env: Dict[tuple, List[WorkerEntry]] = {}
        self._gpus_free: Set[int] = set(
            range(int(self.resources.get("GPU", 0)))
        )
        gpu_set = os.environ.get("RT_GPU_VISIBLE_DEVICES")
        self._gpu_names: Optional[List[str]] = (
            None if gpu_set is None
            else [x.strip() for x in gpu_set.split(",") if x.strip()]
        )
        self._peer_conns: Dict[str, rpc.Connection] = {}
        self._inflight_pulls: Dict[bytes, asyncio.Future] = {}
        self._tasks: List[asyncio.Task] = []
        self._closing = False
        # Object spilling (reference role: raylet/local_object_manager.h:41
        # SpillObjects + python/ray/_private/external_storage.py).  Primary
        # copies are `protect`ed in the arena (LRU cannot evict them);
        # when the arena passes the high-water mark the spill loop writes
        # the least-recently-used ones to files here, registers the
        # spilled location with the GCS, and drops the arena copy.
        self.spill_dir = os.path.join(
            session_dir, "spill", self.node_id.hex()[:12]
        )
        self._spilled: Dict[bytes, int] = {}  # oid -> size
        self._spilled_bytes = 0
        self._spill_count = 0
        self._restore_count = 0
        self._spill_lock = asyncio.Lock()
        # pip runtime envs: requirement-hash -> creation lock (venvs live
        # under session_dir/pip_envs; see _ensure_pip_env)
        self._pip_env_locks: Dict[str, asyncio.Lock] = {}
        # set by SIGTERM or the shutdown_node RPC; main() awaits it and
        # tears the node down (cluster launcher `down` uses the RPC to
        # drain nodes it has no pid for, e.g. on other hosts)
        self.stop_requested = asyncio.Event()
        # graceful drain: set by the GCS's drain notify (or by the local
        # preemption watcher) — new leases are refused while in-flight
        # work finishes inside the announced deadline
        self.draining = False
        # incarnation fencing: this life's token (assigned by the GCS at
        # registration, carried on every raylet->GCS and peer->raylet
        # RPC); a FencedError reply means the cluster declared this life
        # dead — _fence_self kills the workers, discards the object
        # copies, and re-registers fresh
        self.incarnation = 0
        self._fencing = False
        # peer incarnation watermarks (node hex -> highest incarnation
        # seen, via the "nodes" pubsub channel and peer RPC payloads):
        # an inbound peer RPC below the watermark is rejected
        self._node_incs: Dict[str, int] = {}
        # per-tick add_object_location coalescing (data plane v2): pulls,
        # spill restores and evacuation sweeps started within one loop
        # tick announce through one object_notify_batch rpc instead of a
        # notify per object (see _announce)
        self._announce_buf: list = []
        self._announce_flush = None  # in-flight flush future, if any

    # ---- lifecycle -----------------------------------------------------
    async def start(self):
        os.makedirs(self.session_dir, exist_ok=True)
        if os.path.exists(self.store_path):
            os.unlink(self.store_path)
        self.store = ShmStore(self.store_path, self.store_capacity, create=True)
        await self.server.start()
        # partition plane: this raylet (and every worker it spawns) is
        # the node's logical endpoint
        faults.set_local_endpoint(self.node_id.hex())
        # Reconnecting channel: a GCS crash/restart no longer kills the
        # node — the raylet re-dials, re-registers (same node_id), and the
        # GCS restores cluster state from its checkpoint (gcs.py
        # CheckpointStore).  Workers and their direct client connections
        # keep running through the outage.
        self.gcs = rpc.ReconnectingConnection(
            self.gcs_address, self._handle, name="raylet->gcs",
            on_reconnect=self._register_with_gcs,
            on_give_up=self._on_gcs_lost,
            peer_endpoint="gcs",
        )
        reply = await self.gcs.call("register_node", self._register_payload())
        self.incarnation = int((reply or {}).get("incarnation", 0) or 0)
        # incarnation watermarks for peer->raylet fencing ride the
        # "nodes" pubsub channel (suspect/dead/alive events carry them)
        await self.gcs.call("subscribe", {"channel": "nodes"})
        loop = asyncio.get_running_loop()
        self._tasks.append(loop.create_task(self._heartbeat_loop()))
        self._tasks.append(loop.create_task(self._reaper_loop()))
        if cfg.preempt_poll_interval_s > 0:
            self._tasks.append(loop.create_task(self._preempt_watch_loop()))
        if cfg.memory_monitor_interval_s > 0:
            from ray_tpu_torch.core.memory_monitor import MemoryMonitor

            self.memory_monitor = MemoryMonitor(self)
            self._tasks.append(loop.create_task(self.memory_monitor.loop()))
        n_prestart = min(int(self.resources.get("CPU", 0)), cfg.worker_pool_prestart)
        for _ in range(n_prestart):
            self._spawn_worker()
        logger.info(
            "raylet %s up at %s (store %s, %d bytes)",
            self.node_id, self.server.address, self.store_path, self.store_capacity,
        )

    def _register_payload(self, fresh: bool = False) -> dict:
        return {
            "node_id": self.node_id.binary(),
            "address": self.server.address,
            "resources": self.resources,
            "labels": self.labels,
            # claim the current life on reconnects so object copies and
            # leases carry over; None starts a NEW incarnation
            "incarnation": (
                None if fresh or not self.incarnation else self.incarnation
            ),
        }

    async def _register_with_gcs(self, conn):
        """Re-attach to a reborn GCS over a fresh connection.  NB: runs
        inside ReconnectingConnection._ensure — must use ``conn``
        directly (self.gcs.call would deadlock on the redial lock)."""
        try:
            reply = await conn.call("register_node", self._register_payload())
        except rpc.RemoteCallError as e:
            if not is_fenced(e):
                raise
            # declared dead while we were away (partition healed): purge
            # this life's state, then join as a fresh incarnation.  The
            # _fencing guard holds across the purge AND the fresh
            # registration: leases are refused meanwhile, and a
            # concurrent peer-fence (_fence_self off a rejected pull)
            # must not purge a second time — it would destroy the
            # rebuilt arena and kill workers just leased to the new
            # incarnation.  Conversely, if a _fence_self purge is
            # already in flight (it set _fencing before blocking on
            # this redial's lock), skip the purge here and only
            # re-register fresh.
            already_fencing = self._fencing
            self._fencing = True
            try:
                if not already_fencing:
                    await self._purge_for_fence(
                        "re-registration rejected: stale incarnation"
                    )
                reply = await conn.call(
                    "register_node", self._register_payload(fresh=True)
                )
            finally:
                if not already_fencing:
                    self._fencing = False
        self.incarnation = int((reply or {}).get("incarnation", 0) or 0)
        await conn.call("subscribe", {"channel": "nodes"})
        logger.info(
            "raylet %s re-registered with GCS (incarnation %d)",
            self.node_id, self.incarnation,
        )

    def _on_gcs_lost(self):
        if not self._closing:
            logger.error(
                "raylet %s: GCS unreachable past the reconnect budget; "
                "shutting down", self.node_id,
            )
            for w in self.workers.values():
                if w.container_kill_argv:
                    # fire-and-forget: this process is about to _exit and
                    # a terminated run client strands its container
                    try:
                        subprocess.Popen(
                            w.container_kill_argv,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL,
                        )
                    except Exception:
                        pass
                w.proc.terminate()
            os._exit(1)

    async def close(self):
        self._closing = True
        for t in self._tasks:
            t.cancel()
        await self._leave_cluster()
        for w in list(self.workers.values()):
            try:
                w.proc.terminate()
            except Exception:
                pass
        for w in list(self.workers.values()):
            try:
                w.proc.wait(timeout=2)
            except Exception:
                self._hard_kill_worker(w)
        if self.gcs:
            await self.gcs.close()
        await self.server.close()
        if self.store:
            self.store.destroy()

    async def _leave_cluster(self):
        """A graceful shutdown (SIGTERM, ``shutdown_node``) tells the GCS
        first that this node is going: it is marked draining there, so no
        lease is granted to it from here on, and a queued lease waits for
        another node, as after a hard kill.  The GCS then sees the node
        die when this process exits.  The reference stops its workers
        first, and a lease queued for their resources can be granted to
        the dying node, where it neither runs nor fails (ROADMAP C4)."""
        if self.draining or self.gcs is None:
            return  # a drain is under way: the GCS knows already
        self.draining = True  # refuse a grant already in flight
        # the live connection only, never a redial: in a whole-cluster
        # shutdown the GCS is going too, and nothing is left to tell
        conn = self.gcs.current
        if conn is None or conn.closed:
            return
        try:
            await conn.call(
                "drain_node",
                {"node_id": self.node_id.hex(), "reason": "shutdown",
                 "deadline_s": cfg.drain_deadline_default_s},
                timeout=2.0,
            )
        except Exception:
            logger.warning("raylet %s: leave notice to the GCS failed",
                           self.node_id, exc_info=True)

    async def _heartbeat_loop(self):
        while True:
            await asyncio.sleep(cfg.heartbeat_interval_s)
            try:
                # a CALL, not a notify: the reply channel is where a
                # zombie learns it was fenced.  urgent=True writes the
                # tiny frame ahead of any per-tick BATCH accumulation
                # and skips transport flow-control waits — a loaded
                # tick must not delay the detector's input (that delay
                # IS the false-positive mode the phi detector absorbs).
                # The timeout is ONE interval: delivery is one-way for
                # liveness (the reply only carries fencing), and a lost
                # heartbeat must not block the next one past the
                # detector's death floor — that would turn a healed
                # sub-threshold partition into a false death.
                await self.gcs.call(
                    "heartbeat",
                    {
                        "node_id": self.node_id.binary(),
                        "incarnation": self.incarnation,
                    },
                    timeout=max(cfg.heartbeat_interval_s, 0.2),
                    urgent=True,
                )
            except rpc.RemoteCallError as e:
                if is_fenced(e):
                    await self._fence_self(str(e.remote_exception))
            except Exception:
                pass
            # collect dead worker processes
            for w in list(self.workers.values()):
                if w.proc.poll() is not None:
                    await self._on_worker_exit(w)

    async def _reaper_loop(self):
        while True:
            await asyncio.sleep(5.0)
            try:
                self.store.reap()
            except Exception:
                pass
            try:
                await self._maybe_spill()
            except Exception:
                logger.exception("spill pass failed")

    # ---- object spilling ------------------------------------------------

    def _spill_path(self, oid: bytes) -> str:
        return os.path.join(self.spill_dir, oid.hex() + ".obj")

    async def _maybe_spill(self, needed_bytes: int = 0,
                           object_bytes: int = 0) -> int:
        """Spill LRU primaries until the arena is under the low-water mark
        (or `needed_bytes` have been freed).  Returns bytes freed.
        ``object_bytes`` (when known) is the size of the single object
        the caller is trying to place — one that can NEVER fit fails
        fast instead of stripping the whole arena for nothing."""
        if not cfg.object_spill_enabled:
            return 0
        async with self._spill_lock:
            st = self.store.stats()
            cap = st["capacity"] or 1
            if object_bytes and object_bytes > cap:
                return 0
            if needed_bytes:
                # clamp instead of refusing: escalating retries may ask
                # for more than capacity while the OBJECT still fits —
                # worst case we spill the whole arena, which is exactly
                # what a near-capacity create needs
                needed_bytes = min(needed_bytes, cap)
                headroom = cap - st["used"]
                shortfall = needed_bytes - headroom
                if shortfall <= 0:
                    # the caller's create failed despite apparent headroom:
                    # fragmentation — spill ~needed_bytes of LRU primaries
                    # so arena_free can merge a contiguous run.  Do NOT
                    # clamp this to the low-water mark: when used is
                    # already below it the clamp would free 0 bytes on
                    # every retry and the fragmented create starves (the
                    # retry loops in _write_to_store / _restore_from_spill
                    # give up on a zero-freed pass).  Spill amount stays
                    # bounded at ~needed_bytes per pass (callers escalate
                    # needed_bytes across retries; min(needed, cap) above
                    # bounds the worst case).
                    shortfall = needed_bytes
                # floor at 0: needed_bytes >= used means the caller needs
                # more than everything currently resident — draining all
                # spillables is then exactly the progress required
                target = max(st["used"] - shortfall, 0)
            elif st["used"] > cfg.object_spill_high_frac * cap:
                target = int(cfg.object_spill_low_frac * cap)
            else:
                return 0
            freed = 0
            for oid, size in self.store.list_spillable():
                if st["used"] - freed <= target:
                    break
                if await self._spill_one(oid, size):
                    freed += size
            return freed

    async def _spill_one(self, oid: bytes, size: int) -> bool:
        pin = self.store.get(oid)
        if pin is None:
            return False
        path = self._spill_path(oid)
        tmp = path + ".tmp"
        try:
            os.makedirs(self.spill_dir, exist_ok=True)
            # write straight from the pinned arena view on a worker thread
            # (copying multi-GB objects on the event loop stalls all RPCs)
            await asyncio.to_thread(self._write_file, tmp, pin.view)
            os.replace(tmp, path)
        except OSError:
            logger.exception("spill write failed for %s", oid.hex()[:12])
            return False
        finally:
            pin.release()
        self._spilled[oid] = size
        self._spilled_bytes += size
        self._spill_count += 1
        try:
            reply = await self.gcs.call("add_spilled_location", {
                "object_id": oid,
                "node_id": self.node_id.binary(),
                "incarnation": self.incarnation,
                "size": size,
            })
        except Exception:
            # GCS unreachable: keep the arena copy authoritative
            self._drop_spill_file(oid)
            return False
        if not (isinstance(reply, dict) and reply.get("ok")):
            # the object was freed while we were writing the file: keep
            # the arena copy (its pending delete reclaims it), drop ours
            self._drop_spill_file(oid)
            return False
        # The file is now the durable primary; the arena copy is cache.
        self.store.protect(oid, False)
        if self.store.delete(oid):
            # arena copy gone: retract the directory entry so pullers
            # don't see this node listed twice (location + spilled)
            try:
                await self.gcs.notify("remove_object_location", {
                    "object_id": oid,
                    "node_id": self.node_id.binary(),
                })
            except Exception:
                pass
        # (delete refuses while a reader holds a pin — fine: the entry is
        # unprotected now, so LRU reclaims it and the location goes stale
        # only until the object is freed)
        return True

    @staticmethod
    def _write_file(path: str, data) -> None:
        # bytes or a pinned memoryview — no extra copy; in slices: while
        # one write of many GB from the arena's mapping runs, the process
        # can start no process and map no memory (on a 9p temp dir,
        # seconds; spill_io_probe.py), and the event loop does both
        view = memoryview(data).cast("B")
        fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            off = 0
            while off < len(view):
                off += os.write(fd, view[off:off + _IO_SLICE_BYTES])
            os.fsync(fd)
        finally:
            os.close(fd)

    @staticmethod
    def _read_into_store(store, oid: bytes, path: str) -> int:
        """Read a spill file straight into a reservation in the arena, in
        slices, and seal it; returns its size.  Run on a worker thread: the
        read syscalls copy without the GIL, so the event loop runs on while
        many GB come back (a bytes copy of the object, or a copy of it into
        the arena, would hold the GIL for seconds)."""
        with open(path, "rb", buffering=0) as f:
            size = os.fstat(f.fileno()).st_size
            view = store.reserve(oid, size)
            try:
                off = 0
                while off < size:
                    got = f.readinto(view[off:off + _IO_SLICE_BYTES])
                    if not got:
                        raise OSError(f"spill file {path} ends at {off} of {size} bytes")
                    off += got
            except BaseException:
                store.abort(oid)
                raise
        store.commit(oid)
        return size

    def _drop_spill_file(self, oid: bytes) -> None:
        size = self._spilled.pop(oid, None)
        if size is not None:
            self._spilled_bytes -= size
        try:
            os.unlink(self._spill_path(oid))
        except OSError:
            pass

    async def _restore_from_spill(self, oid: bytes) -> bool:
        """Read a spilled object back into the arena (stays spilled on
        disk; the arena copy is a cache until the object is freed)."""
        if oid not in self._spilled:
            return False
        size = self._spilled[oid]
        placed = False
        for attempt in range(3):
            try:
                await asyncio.to_thread(
                    self._read_into_store, self.store, oid, self._spill_path(oid)
                )
                placed = True
                break
            except ObjectExistsError:
                placed = True
                break
            except OSError:
                logger.exception("spill restore failed for %s", oid.hex()[:12])
                return False
            except Exception:
                # arena full: make room (exact size first, then
                # escalating; _maybe_spill clamps to capacity) — the
                # pull path treats a failed restore as retryable, but
                # succeeding here saves the caller a full round trip
                freed = await self._maybe_spill(
                    needed_bytes=size * (attempt + 1),
                    object_bytes=size,
                )
                if not freed and attempt:
                    break
        if not placed:
            return False
        self._restore_count += 1
        await self._announce(oid, size)
        return True

    def _read_spilled(self, oid: bytes, offset: int = 0,
                      length: Optional[int] = None) -> Optional[bytes]:
        if oid not in self._spilled:
            return None
        try:
            with open(self._spill_path(oid), "rb") as f:
                if offset:
                    f.seek(offset)
                return f.read(length if length is not None else -1)
        except OSError:
            return None

    # ---- graceful drain / preemption ------------------------------------

    async def rpc_drain(self, conn, p):
        """GCS drain notify: stop accepting leases; in-flight tasks keep
        running and finish inside the announced deadline (the GCS drain
        task waits for their leases to return before declaring the node
        drained)."""
        self.draining = True
        logger.warning(
            "raylet %s draining (%s, deadline %.1fs): refusing new leases",
            self.node_id, p.get("reason"), p.get("deadline_s", 0.0),
        )
        return True

    async def _preempt_watch_loop(self):
        """Preemption watcher: converts an announced termination (spot/
        preemptible notice) into a graceful drain.  Two signal sources:

        - the ``node.preempt`` chaos site — each poll is one hit with
          the node id as context, so a seeded ``FaultPlan`` drives a
          preemption deterministically (``delay_s`` carries the
          announced deadline; 0/default falls back to
          ``cfg.drain_deadline_default_s``);
        - the GCE metadata stub (``RT_PREEMPT_METADATA``), which lives
          with the TPU-slice provider and raises until that is ported
          (ROADMAP A4).
        """
        source = None
        if os.environ.get("RT_PREEMPT_METADATA"):
            # the reference's GceMetadataPreemption sits in its TPU-slice
            # provider, whose GPU counterpart is still to be decided
            raise NotImplementedError(
                "RT_PREEMPT_METADATA needs the GCE metadata preemption "
                "watcher of the TPU-slice provider (tpu_provider.py, "
                "gce_tpu_api.py), which is not ported yet (ROADMAP A4)"
            )
        while True:
            await asyncio.sleep(cfg.preempt_poll_interval_s)
            if self.draining:
                continue  # notice already delivered
            deadline_s = 0.0
            fault_ctl = faults.ACTIVE  # bind once: clear() races the check
            if fault_ctl is not None:
                plan = fault_ctl.hit(
                    faults.SITE_NODE_PREEMPT, self.node_id.hex()
                )
                if plan is not None and plan.action in ("preempt", "error"):
                    # delay_s carries the announced deadline; unset
                    # (FaultPlan's 0.05 "delay" default) or non-positive
                    # falls back to the config default — a fired plan
                    # must always deliver a usable notice (the nth-hit
                    # window is already consumed)
                    d = plan.delay_s
                    if d is None or d <= 0 or d == _PLAN_DELAY_DEFAULT:
                        d = cfg.drain_deadline_default_s
                    deadline_s = d
            if not deadline_s and source is not None:
                try:
                    deadline_s = await asyncio.to_thread(source.poll)
                except Exception:
                    deadline_s = 0.0
            if not deadline_s or deadline_s <= 0:
                continue
            logger.warning(
                "raylet %s: preemption notice, %.1fs to termination — "
                "requesting graceful drain", self.node_id, deadline_s,
            )
            self.draining = True
            try:
                await self.gcs.call(
                    "drain_node",
                    {
                        "node_id": self.node_id.hex(),
                        "reason": "preemption",
                        "deadline_s": deadline_s,
                    },
                )
            except Exception:
                # GCS unreachable: un-arm so the next poll retries the
                # notice (the kill is coming either way; retrying is the
                # only useful move)
                logger.exception("preemption drain request failed")
                self.draining = False

    async def rpc_shutdown_node(self, conn, p):
        """Graceful remote shutdown (ray: `ray down` draining a node the
        caller holds no pid for): main() observes stop_requested and runs
        the same close() path SIGTERM takes — workers killed, arena
        unlinked, node deregistered."""
        self.stop_requested.set()
        return True

    # ---- incarnation fencing --------------------------------------------

    async def _purge_for_fence(self, reason: str):
        """Discard everything this (declared-dead) life owned: workers
        are hard-killed (a named actor must never execute on two nodes
        at once — the replacement is already running elsewhere), the
        shm arena is destroyed and re-created empty (our object copies
        were dropped from the directory at death; serving them again
        would resurrect stale locations), and spill files are deleted."""
        logger.error(
            "raylet %s FENCED (%s): killing %d worker(s), discarding "
            "object copies, re-registering fresh",
            self.node_id, reason, len(self.workers),
        )
        for w in list(self.workers.values()):
            self._hard_kill_worker(w)
        self.workers.clear()
        self._idle_by_env.clear()
        self._gpus_free = set(range(int(self.resources.get("GPU", 0))))
        for oid in list(self._spilled):
            self._drop_spill_file(oid)
        try:
            self.store.destroy()
        except Exception:
            logger.exception("fenced arena teardown failed")
        try:
            self.store = ShmStore(
                self.store_path, self.store_capacity, create=True
            )
        except Exception:
            logger.exception("fenced arena rebuild failed")
        self.draining = False

    async def _fence_self(self, reason: str):
        """A FencedError reached us (stale incarnation — the cluster
        declared this node dead, e.g. across a healed partition): purge
        this life and re-register as a fresh incarnation.  Failure to
        re-register leaves the stale token in place, so the next
        heartbeat's fence reply retries the whole sequence."""
        if self._fencing or self._closing:
            return
        self._fencing = True
        try:
            await self._purge_for_fence(reason)
            reply = await self.gcs.call(
                "register_node", self._register_payload(fresh=True)
            )
            self.incarnation = int((reply or {}).get("incarnation", 0) or 0)
            await self.gcs.call("subscribe", {"channel": "nodes"})
            logger.warning(
                "raylet %s re-joined as incarnation %d",
                self.node_id, self.incarnation,
            )
        except Exception:
            logger.exception(
                "fence recovery failed; retrying on next heartbeat"
            )
        finally:
            self._fencing = False

    def _note_peer_inc(self, p) -> None:
        """peer->raylet fencing: reject RPCs whose sender's incarnation
        sits below this node's watermark (learned from the GCS "nodes"
        pubsub and from peer payloads themselves), and raise the
        watermark on newer tokens."""
        fn, fi = p.get("from_node"), p.get("from_inc")
        if fn is None or fi is None:
            return
        known = self._node_incs.get(fn, 0)
        if fi < known:
            raise FencedError(
                f"peer {fn[:12]} incarnation {fi} is stale (watermark "
                f"{known}): fence yourself and re-register"
            )
        if fi > known:
            self._node_incs[fn] = fi

    def _peer_stamp(self) -> dict:
        return {
            "from_node": self.node_id.hex(),
            "from_inc": self.incarnation,
        }

    async def rpc_publish(self, conn, p):
        """GCS pubsub push (we subscribe to "nodes"): keep incarnation
        watermarks current so stale peers are rejected promptly."""
        if p.get("channel") != "nodes":
            return True
        msg = p.get("message") or {}
        nid, inc = msg.get("node_id"), msg.get("incarnation")
        if nid and inc is not None and inc > self._node_incs.get(nid, 0):
            self._node_incs[nid] = inc
        return True

    # ---- chaos (network-partition installs; see common/faults.py) ------
    async def rpc_chaos_partition(self, conn, p):
        faults.cut_link(p["src"], p["dst"], p.get("duration_s"))
        # workers share the node's network fate: fan the cut out
        for w in list(self.workers.values()):
            if w.conn is not None and not w.conn.closed:
                try:
                    await w.conn.notify("chaos_partition", p)
                except Exception:
                    pass
        return True

    async def rpc_chaos_heal(self, conn, p):
        faults.heal_link(p.get("src"), p.get("dst"))
        for w in list(self.workers.values()):
            if w.conn is not None and not w.conn.closed:
                try:
                    await w.conn.notify("chaos_heal", p)
                except Exception:
                    pass
        return True

    async def rpc_spill_now(self, conn, p):
        """Synchronous pressure relief: a client's create just failed."""
        return await self._maybe_spill(
            needed_bytes=p.get("needed_bytes", 0),
            object_bytes=p.get("object_bytes", 0),
        )

    # ---- dispatch ------------------------------------------------------
    async def _handle(self, conn: rpc.Connection, method: str, p: Any):
        fn = getattr(self, f"rpc_{method}", None)
        if fn is None:
            raise rpc.RpcError(f"raylet: unknown method {method!r}")
        return await fn(conn, p)

    async def rpc_list_worker_tasks(self, conn, p):
        """Live task/actor descriptors from every connected worker
        (state-API fan-out leg; ray: util/state aggregating from raylets)."""
        out = []
        for w in list(self.workers.values()):
            if w.conn is None or w.conn.closed:
                continue
            try:
                st = await w.conn.call("status", {}, timeout=5.0)
            except Exception:
                continue
            st["worker_id"] = w.worker_id.hex()
            st["node_id"] = self.node_id.hex()
            st["leased"] = w.lease_id is not None
            out.append(st)
        return out

    # ---- worker pool ---------------------------------------------------

    def _spawn_worker(self, python_exe: Optional[str] = None,
                      venv_key: str = "",
                      container: Optional[tuple] = None) -> WorkerEntry:
        worker_id = WorkerID.random()
        env = dict(os.environ)
        env["RT_WORKER_ID"] = worker_id.hex()
        env["RT_RAYLET_ADDR"] = self.server.address
        env["RT_GCS_ADDR"] = self.gcs_address
        env["RT_NODE_ID"] = self.node_id.hex()
        env["RT_STORE_PATH"] = self.store_path
        env["RT_SESSION_DIR"] = self.session_dir
        container_kill_argv = None
        if container is not None:
            # (prefix, image) from _container_spawn_prefix: the worker
            # runs inside the container; its env arrives via -e flags
            # (a container does not inherit the raylet's environ).  The
            # container is NAMED so hard kills can target it — SIGKILL
            # on the run client detaches without stopping the container.
            prefix, image = container
            cname = f"rt-worker-{worker_id.hex()[:12]}"
            argv = list(prefix) + ["--name", cname]
            for k, v in env.items():
                if k.startswith(("RT_", "CUDA_", "TORCH_")):
                    argv += ["-e", f"{k}={v}"]
            argv += [image, "python", "-m", "ray_tpu_torch.core.worker_main"]
            container_kill_argv = [prefix[0], "kill", cname]
        else:
            argv = [
                python_exe or sys.executable, "-m",
                "ray_tpu_torch.core.worker_main",
            ]
        log_path = os.path.join(self.session_dir, f"worker-{worker_id.hex()[:12]}.log")
        logf = open(log_path, "ab")
        proc = subprocess.Popen(
            argv,
            env=env,
            stdout=logf,
            stderr=subprocess.STDOUT,
        )
        logf.close()
        entry = WorkerEntry(
            worker_id=worker_id, proc=proc, venv_key=venv_key,
            container_kill_argv=container_kill_argv,
        )
        self.workers[worker_id] = entry
        return entry

    def _chaos_on_lease_grant(self, w: "WorkerEntry") -> None:
        """Chaos site ``raylet.lease.grant``: fires as a lease is handed
        out.  ``kill`` hard-kills the granted worker — the client's push
        then fails, the lease breaks, and the task-plane retry path
        (requeue → fresh lease → resubmit) runs for real.  This is the
        deterministic nth-hit lease-break the chaos suite drives."""
        fault_ctl = faults.ACTIVE  # re-read: clear() races the caller's check
        if fault_ctl is None:
            return
        plan = fault_ctl.hit(
            faults.SITE_RAYLET_LEASE_GRANT, w.worker_id.hex()
        )
        if plan is not None and plan.action == "kill":
            logger.warning(
                "chaos: killing worker %s on lease grant", w.worker_id
            )
            self._hard_kill_worker(w)

    @staticmethod
    def _hard_kill_worker(w: "WorkerEntry"):
        """SIGKILL that actually reaches containerized workers: the run
        client detaches on SIGKILL without stopping the container, so
        the container is killed by name first.  Fire-and-forget — this
        runs inside async close(); blocking on a wedged container
        runtime daemon would stall the event loop per worker."""
        if w.container_kill_argv:
            try:
                subprocess.Popen(
                    w.container_kill_argv,
                    stdout=subprocess.DEVNULL,
                    stderr=subprocess.DEVNULL,
                )
            except Exception:
                pass
        try:
            w.proc.kill()
        except Exception:
            pass

    async def _ensure_cached_env(self, kind: str, key: str, build) -> str:
        """Shared scaffolding for isolated-interpreter runtime envs (pip
        venvs, conda envs): env dir keyed under session_dir/<kind>/<key>,
        creation lock-serialized and marker-gated so concurrent leases —
        and a restarted raylet — reuse one env.  ``build(root, python)``
        materializes the env (and must call _inject_parent_site itself
        at the right point); returns the env's python executable."""
        root = os.path.join(self.session_dir, kind, key)
        python = os.path.join(root, "bin", "python")
        marker = os.path.join(root, ".ready")
        if os.path.exists(marker):
            return python
        lock = self._pip_env_locks.setdefault(
            f"{kind}:{key}", asyncio.Lock()
        )
        async with lock:
            if os.path.exists(marker):
                return python

            def run():
                import shutil

                shutil.rmtree(root, ignore_errors=True)
                os.makedirs(os.path.dirname(root), exist_ok=True)
                build(root, python)
                with open(marker, "w") as f:
                    f.write("ok")

            try:
                await asyncio.to_thread(run)
            except Exception as e:
                raise rpc.RpcError(
                    f"{kind.rstrip('s').replace('_', ' ')} setup failed: "
                    f"{e}"
                ) from e
            return python

    async def _ensure_pip_env(self, rtenv: dict) -> str:
        """Materialize (once) a virtualenv for a pip runtime env; returns
        its python executable (reference role:
        python/ray/_private/runtime_env/pip.py PipProcessor).  The venv
        uses --system-site-packages so the base image's torch/numpy stay
        importable; isolation comes from the venv's OWN site-packages
        shadowing them where the requirements overlap."""
        import hashlib
        import json as _json

        reqs = list(rtenv["pip"])
        key = hashlib.sha256(_json.dumps(reqs).encode()).hexdigest()[:16]

        def build(root, python):
            subprocess.run(
                [sys.executable, "-m", "venv",
                 "--system-site-packages", root],
                check=True, capture_output=True,
                timeout=cfg.pip_env_install_timeout_s,
            )
            # injection BEFORE install: --no-build-isolation source
            # builds need setuptools from the parent site
            _inject_parent_site(root)
            r = subprocess.run(
                [python, "-m", "pip", "install",
                 "--no-build-isolation", *reqs],
                capture_output=True, text=True,
                timeout=cfg.pip_env_install_timeout_s,
            )
            if r.returncode != 0:
                raise RuntimeError(
                    f"pip install {reqs} failed: {r.stderr[-800:]}"
                )

        return await self._ensure_cached_env("pip_envs", key, build)

    async def _ensure_conda_env(self, rtenv: dict) -> str:
        """Materialize (once) a conda env for a conda runtime env;
        returns its python executable.  Keyed by the canonical spec hash
        (reference role: python/ray/_private/runtime_env/conda.py —
        env-spec hashing + cached env creation + runtime injection).
        The conda executable comes from RT_CONDA_EXE or PATH
        (conda/mamba/micromamba); a node without one rejects the lease
        with an actionable error."""
        import hashlib
        import json as _json
        import shutil

        spec = rtenv["conda"]
        exe = cfg.conda_exe or next(
            (e for e in ("conda", "mamba", "micromamba") if shutil.which(e)),
            None,
        )
        if exe is None or not shutil.which(exe):
            raise rpc.RpcError(
                "conda runtime env requested but no conda executable was "
                "found on this node (looked for RT_CONDA_EXE, conda, "
                "mamba, micromamba on PATH). Install miniconda/micromamba "
                "on every node, or use pip=[...] (virtualenv over the "
                "base image) / container={'image': ...} instead."
            )
        key = hashlib.sha256(
            _json.dumps(spec, sort_keys=True).encode()
        ).hexdigest()[:16]

        def build(root, python):
            cmd = [shutil.which(exe), "create", "--yes", "-p", root]
            for ch in spec.get("channels", []):
                cmd += ["-c", ch]
            cmd += spec["dependencies"]
            r = subprocess.run(
                cmd, capture_output=True, text=True,
                timeout=cfg.pip_env_install_timeout_s,
            )
            if r.returncode != 0:
                raise RuntimeError(
                    f"{exe} create failed for {spec['dependencies']}: "
                    f"{r.stderr[-800:]}"
                )
            if not os.path.exists(python):
                raise RuntimeError(
                    f"conda env at {root} has no bin/python — add an "
                    "explicit python dependency to the spec (e.g. "
                    "'python=3.12')"
                )
            _inject_parent_site(root)

        return await self._ensure_cached_env("conda_envs", key, build)

    def _container_spawn_prefix(self, rtenv: dict) -> list:
        """argv prefix that wraps the worker command in a container
        (reference role: python/ray/_private/runtime_env/container.py).
        The session dir, the temp dir (spill + runtime-env extracts), and /dev/shm
        (the object arena) are shared with the host, and the host network
        is used so the worker's TCP endpoints are directly reachable."""
        import shutil

        runtime = cfg.container_runtime or next(
            (r for r in ("podman", "docker") if shutil.which(r)), None
        )
        if runtime is None or not shutil.which(runtime):
            raise rpc.RpcError(
                "container runtime env requested but no container runtime "
                "was found on this node (looked for RT_CONTAINER_RUNTIME, "
                "podman, docker on PATH). Install one, or use pip/conda "
                "runtime envs instead."
            )
        desc = rtenv["container"]
        pkg_root = os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))
        )  # .../ray_tpu_torch
        repo_root = os.path.dirname(pkg_root)
        tmp = os.path.dirname(session_root())
        prefix = [
            # --init: an init shim as PID1 forwards SIGTERM/SIGKILL to
            # the worker — without it the in-container python is PID1
            # (default signal dispositions ignored), the raylet's kill
            # paths only hit the `docker run` CLIENT, and the container
            # (plus its leased cards) leaks forever
            shutil.which(runtime), "run", "--rm", "--init",
            "--network=host", "--ipc=host",
            "-v", f"{self.session_dir}:{self.session_dir}",
            "-v", f"{tmp}:{tmp}", "-e", f"TMPDIR={tmp}",
            "-v", f"{repo_root}:{repo_root}:ro",
            "-e", f"PYTHONPATH={repo_root}",
        ]
        prefix += desc.get("run_options", [])
        # image appended by _spawn_worker AFTER the worker's -e env flags
        return prefix, desc["image"]

    async def rpc_worker_ready(self, conn: rpc.Connection, p):
        """A spawned worker reports in with its own server address."""
        wid = WorkerID(p["worker_id"])
        w = self.workers.get(wid)
        if w is None:
            raise rpc.RpcError("unknown worker")
        w.conn = conn
        w.addr = p["address"]
        conn.peer_info["worker_id"] = wid
        key = _env_key(w.bound_env, w.rtenv_key) if w.bound_env else ()
        self._idle_by_env.setdefault(key, []).append(w)
        return True

    async def _wait_for_worker(self, w: WorkerEntry):
        deadline = time.monotonic() + cfg.worker_start_timeout_s
        while w.conn is None:
            if time.monotonic() > deadline:
                raise rpc.RpcError("worker failed to start in time")
            if w.proc.poll() is not None:
                raise rpc.RpcError(
                    f"worker process exited at startup (code {w.proc.returncode}); "
                    f"see {self.session_dir}/worker-{w.worker_id.hex()[:12]}.log"
                )
            await asyncio.sleep(0.01)

    def _gpu_name(self, index: int) -> str:
        if self._gpu_names is None:
            return str(index)
        if index >= len(self._gpu_names):
            raise rpc.RpcError(
                f"GPU index {index} is outside the driver's visible set "
                f"{','.join(self._gpu_names)!r}"
            )
        return self._gpu_names[index]

    def _accel_env_for(self, resources: Dict[str, float]) -> Dict[str, str]:
        """Accelerator visibility env for a lease: its cards, or none."""
        n_gpu = _whole_gpus(resources)
        if n_gpu > 0:
            if len(self._gpus_free) < n_gpu:
                raise rpc.RpcError(
                    f"GPUs exhausted: want {n_gpu}, free {len(self._gpus_free)}"
                )
            idx = sorted(self._gpus_free)[:n_gpu]
            names = [self._gpu_name(i) for i in idx]
            for i in idx:
                self._gpus_free.discard(i)
            return {
                "CUDA_VISIBLE_DEVICES": ",".join(names),
                "_RT_GPUS": ",".join(map(str, idx)),
            }
        return {"CUDA_VISIBLE_DEVICES": ""}

    def _release_accel_env(self, env: Dict[str, str]):
        gpus = env.get("_RT_GPUS")
        if gpus:
            for i in gpus.split(","):
                self._gpus_free.add(int(i))

    def _find_idle_gpu_worker(
        self, n_gpu: int, rtenv_key: str = ""
    ) -> Optional[WorkerEntry]:
        """An idle worker already bound to exactly n_gpu cards — reusing
        it avoids allocating fresh cards (which may all be bound to such
        idle workers; the old cards stay with the worker by design)."""
        for pool in self._idle_by_env.values():
            while pool:
                cand = pool[-1]
                if (
                    cand.proc.poll() is not None
                    or cand.conn is None
                    or cand.conn.closed
                ):
                    pool.pop()
                    continue
                if len(cand.gpus) == n_gpu and cand.rtenv_key == rtenv_key:
                    pool.pop()
                    return cand
                break  # pools are homogeneous per binding
        return None

    async def _evict_idle_gpu_holders(self, n_gpu_needed: int):
        """Kill idle workers holding cards until n_gpu_needed are free."""
        for pool in list(self._idle_by_env.values()):
            for cand in list(pool):
                if len(self._gpus_free) >= n_gpu_needed:
                    return
                if cand.gpus and cand.idle:
                    pool.remove(cand)
                    await self._on_worker_exit(cand, kill=True)

    async def rpc_lease_worker(self, conn: rpc.Connection, p):
        """GCS asks for a worker bound to `resources` (+ runtime env).
        Returns its address."""
        from ray_tpu_torch.core import runtime_env as rtenv_mod

        if self.draining or self._fencing:
            # belt-and-braces with the GCS-side exclusion: a grant that
            # was in flight when the drain notify landed must not bind a
            # fresh worker to a node about to be terminated (or one
            # mid-fence, whose workers are being purged)
            raise rpc.RpcError(
                f"node {self.node_id.hex()[:12]} is "
                f"{'draining' if self.draining else 'fencing'}; "
                f"lease refused"
            )
        resources = p["resources"]
        rtenv = p.get("runtime_env")
        rtenv_key = rtenv_mod.descriptor_key(rtenv)
        venv_python: Optional[str] = None
        venv_key = ""
        container: Optional[tuple] = None
        if rtenv and rtenv.get("pip"):
            venv_python = await self._ensure_pip_env(rtenv)
            venv_key = rtenv_key
        elif rtenv and rtenv.get("conda"):
            venv_python = await self._ensure_conda_env(rtenv)
            venv_key = rtenv_key
        elif rtenv and rtenv.get("container"):
            container = self._container_spawn_prefix(rtenv)
            venv_key = rtenv_key  # containerized workers never mix pools
        n_gpu = _whole_gpus(resources)
        if n_gpu > 0:
            # card-bound reuse must come BEFORE allocation: the free set
            # may be empty precisely because idle workers hold the cards
            w = self._find_idle_gpu_worker(n_gpu, rtenv_key)
            if w is None and len(self._gpus_free) < n_gpu:
                # no compatible idle worker and not enough free cards:
                # evict idle card holders bound to other envs (the
                # docstring contract: conflicting idle workers are killed)
                await self._evict_idle_gpu_holders(n_gpu)
            if w is not None:
                w.lease_id = p["lease_id"]
                w.leased_at = time.monotonic()
                if faults.ACTIVE is not None:
                    self._chaos_on_lease_grant(w)
                return {
                    "worker_id": w.worker_id.binary(),
                    "worker_addr": w.addr,
                    "accelerator_env": {
                        k: v
                        for k, v in (w.bound_env or {}).items()
                        if not k.startswith("_")
                    },
                }
        accel_env = self._accel_env_for(resources)
        key = _env_key(accel_env, rtenv_key)
        # exact-match idle worker?
        w: Optional[WorkerEntry] = None
        pool = self._idle_by_env.get(key, [])
        while pool:
            cand = pool.pop()
            if cand.proc.poll() is None and cand.conn and not cand.conn.closed:
                w = cand
                break
        if w is None:
            # fresh workers (no binding yet) can take any env — but the
            # INTERPRETER is fixed at spawn, so a plain worker can never
            # serve a pip env (nor the reverse)
            pool = self._idle_by_env.get(_env_key(None), [])
            mismatched = []
            while pool:
                cand = pool.pop()
                if cand.venv_key != venv_key:
                    mismatched.append(cand)
                    continue
                if cand.proc.poll() is None and cand.conn and not cand.conn.closed:
                    w = cand
                    break
            pool.extend(mismatched)
        if w is None:
            logger.info(
                "lease %s: no idle worker for key=%s (pools: %s) — spawning",
                p["lease_id"], key,
                {k: len(v) for k, v in self._idle_by_env.items()},
            )
            w = self._spawn_worker(python_exe=venv_python,
                                   venv_key=venv_key,
                                   container=container)
            await self._wait_for_worker(w)
            # worker_ready put the fresh worker in the idle pool; it is being
            # handed out right now, so pull it back out
            for pool in self._idle_by_env.values():
                if w in pool:
                    pool.remove(w)
        if w.bound_env is None:
            try:
                await w.conn.call(
                    "bind_env", {"env": accel_env, "runtime_env": rtenv}
                )
            except Exception:
                # failed bind (e.g. missing runtime-env package): the
                # cards allocated above and the worker itself must not
                # leak — refund and retire it
                self._release_accel_env(accel_env)
                await self._on_worker_exit(w, kill=True)
                raise
            w.bound_env = accel_env
            w.rtenv_key = rtenv_key
            w.gpus = tuple(
                int(i) for i in accel_env.get("_RT_GPUS", "").split(",") if i
            )
        else:
            # reused exact-match worker: give back the duplicate allocation
            self._release_accel_env(accel_env)
        w.lease_id = p["lease_id"]
        w.leased_at = time.monotonic()
        if faults.ACTIVE is not None:
            self._chaos_on_lease_grant(w)
        return {
            "worker_id": w.worker_id.binary(),
            "worker_addr": w.addr,
            "accelerator_env": {
                k: v for k, v in (w.bound_env or {}).items() if not k.startswith("_")
            },
        }

    async def rpc_release_worker(self, conn: rpc.Connection, p):
        wid = WorkerID(p["worker_id"])
        w = self.workers.get(wid)
        if w is None:
            return True
        w.lease_id = None
        if p.get("broken") or w.proc.poll() is not None or (
            w.conn is None or w.conn.closed
        ):
            await self._on_worker_exit(w, kill=True)
            return True
        self._idle_by_env.setdefault(
            _env_key(w.bound_env, w.rtenv_key), []
        ).append(w)
        return True

    async def _on_worker_exit(
        self, w: WorkerEntry, kill: bool = False,
        reason: Optional[str] = None,
    ):
        self.workers.pop(w.worker_id, None)
        for pool in self._idle_by_env.values():
            if w in pool:
                pool.remove(w)
        if w.bound_env:
            self._release_accel_env(w.bound_env)
        if kill and w.proc.poll() is None:
            try:
                w.proc.terminate()
            except Exception:
                pass
        if reason is None:
            reason = f"exit code {w.proc.poll()}"
        try:
            await self.gcs.notify(
                "worker_died",
                {"worker_id": w.worker_id.binary(), "reason": reason,
                 "node_id": self.node_id.binary(),
                 "incarnation": self.incarnation},
            )
        except Exception:
            pass

    # ---- object plane --------------------------------------------------
    async def rpc_pull_object(self, conn: rpc.Connection, p):
        """Local runtime asks us to fetch an object into the node store.

        (ray: object_manager pull_manager.h:52 analogue, pull-based only.)
        Concurrent requests for one object coalesce into a single
        transfer (several tasks landing on a node with the same large
        argument is the broadcast-ingest common case)."""
        oid: bytes = p["object_id"]
        if self.store.contains(oid):
            return True
        existing = self._inflight_pulls.get(oid)
        if existing is not None:
            return await asyncio.shield(existing)
        fut = asyncio.get_running_loop().create_future()
        self._inflight_pulls[oid] = fut
        try:
            ok = await self._pull_object_inner(oid, p)
        except BaseException:
            ok = False
            raise
        finally:
            self._inflight_pulls.pop(oid, None)
            if not fut.done():
                fut.set_result(ok)
        return ok

    async def _pull_object_inner(self, oid: bytes, p) -> bool:
        reply = await self.gcs.call(
            "get_object_locations",
            {"object_id": oid, "timeout": p.get("timeout", 30.0)},
        )
        locations = reply["locations"]
        spilled = reply.get("spilled")
        had_spill_here = False
        if spilled is not None and spilled["node_id"] == self.node_id.hex():
            # our own disk holds it: restore locally, no network
            had_spill_here = True
            if await self._restore_from_spill(oid):
                return True
        elif spilled is not None and spilled["node_id"] not in {
            loc["node_id"] for loc in locations
        }:
            # the spilling node serves fetches straight from its file
            locations = locations + [spilled]
        if not locations:
            # "retry": the directory knows a copy exists (our spill file,
            # restore transiently failed under arena pressure) — the
            # caller must NOT treat this as object loss
            return "retry" if had_spill_here else False
        # Shuffle: under a broadcast (N nodes pulling one seeder's object)
        # each completed pull registers a new location, and randomized
        # source choice spreads the remaining pulls across all replicas —
        # an emergent broadcast tree instead of N full reads of one node
        # (ray: push_manager.h broadcast role, inverted pull-side).
        peers = [
            loc for loc in locations if loc["node_id"] != self.node_id.hex()
        ]
        _PULL_SHUFFLE_RNG.shuffle(peers)
        # health plane: non-suspect copies first (stable sort keeps the
        # shuffle within each class) — a failure-suspected replica costs
        # a full transfer timeout per attempt, so it is the last resort
        peers.sort(key=lambda loc: bool(loc.get("suspect")))
        if not peers and self.store.contains(oid):
            return True
        last_err = None
        transient = had_spill_here
        for loc in peers:
            try:
                if await self._pull_from(oid, loc, peers):
                    return True
                # the peer ANSWERED but had nothing to serve: it may be
                # mid-restore/mid-spill — retryable
                transient = True
            except (rpc.ConnectionLost, ConnectionError, OSError) as e:
                # dead peer with a stale location: NOT retryable — let
                # the caller fall through to lineage reconstruction
                last_err = e
                continue
            except Exception as e:
                if is_fenced(e):
                    # a peer rejected OUR incarnation: this whole life
                    # is stale — fence now (kills workers, discards
                    # copies); the pull fails with the node's old life
                    asyncio.get_running_loop().create_task(
                        self._fence_self("peer rejected our incarnation")
                    )
                    return False
                last_err = e
                transient = True
                continue
        if last_err:
            logger.warning("pull of %s failed: %r", oid.hex()[:12], last_err)
        return "retry" if transient else False

    async def _pull_from(self, oid: bytes, loc, all_peers) -> bool:
        """Fetch one object from `loc` (chunked + pipelined when large,
        striped across additional replicas when available)."""
        peer = await self._peer(loc["address"], loc.get("node_id"))
        # every peer->raylet RPC carries the sender's incarnation: a
        # zombie's fetch is rejected (FencedError) by any peer whose
        # watermark advanced past the dead life
        stamp = self._peer_stamp()
        meta = await peer.call(
            "fetch_object_meta", {"object_id": oid, **stamp},
            timeout=cfg.rpc_call_timeout_s,
        )
        if meta is None:
            return False
        size = meta["size"]
        chunk = cfg.transfer_chunk_bytes
        if size <= chunk:
            data = await peer.call(
                "fetch_object", {"object_id": oid, **stamp},
                timeout=cfg.rpc_call_timeout_s,
            )
            if data is None:
                return False
            self._store_put_new(oid, data)
            await self._announce(oid, size)
            return True
        # large object: write chunks straight into the shm allocation,
        # several in flight, round-robining across known replicas
        try:
            view = self.store.create(oid, size)
        except Exception:
            from ray_tpu_torch._native.store import ObjectExistsError

            if self.store.contains(oid):
                return True
            raise
        sources = [peer]
        for other in all_peers:
            if other is loc:
                continue
            try:
                sources.append(
                    await self._peer(other["address"], other.get("node_id"))
                )
            except Exception:
                continue
        offsets = list(range(0, size, chunk))
        sem = asyncio.Semaphore(cfg.transfer_inflight_chunks)

        async def fetch_one(i: int, off: int):
            src = sources[i % len(sources)]
            length = min(chunk, size - off)
            async with sem:
                data = None
                try:
                    data = await src.call(
                        "fetch_object_chunk",
                        {"object_id": oid, "offset": off, "length": length,
                         **stamp},
                        timeout=cfg.rpc_call_timeout_s,
                    )
                except Exception:
                    pass  # replica died mid-transfer: fall through
                if (data is None or len(data) != length) and src is not peer:
                    data = await peer.call(
                        "fetch_object_chunk",
                        {"object_id": oid, "offset": off, "length": length,
                         **stamp},
                        timeout=cfg.rpc_call_timeout_s,
                    )
                if data is None or len(data) != length:
                    raise rpc.RpcError(
                        f"chunk {off}+{length} of {oid.hex()[:12]} unavailable"
                    )
                view[off:off + length] = data

        # return_exceptions: every fetch task must have FINISHED before the
        # allocation can be aborted — a cancelled-but-running writer on a
        # released memoryview would corrupt the arena
        results = await asyncio.gather(
            *(fetch_one(i, off) for i, off in enumerate(offsets)),
            return_exceptions=True,
        )
        errs = [r for r in results if isinstance(r, BaseException)]
        if errs:
            try:
                self.store.abort(oid)
            except Exception:
                pass
            raise errs[0]
        self.store.seal(oid)
        await self._announce(oid, size)
        return True

    def _store_put_new(self, oid: bytes, data) -> None:
        try:
            self.store.put(oid, data)
        except Exception as e:
            from ray_tpu_torch._native.store import ObjectExistsError

            if not isinstance(e, ObjectExistsError):
                raise

    async def _announce(self, oid: bytes, size: int) -> None:
        """Register an arena copy with the directory.  Announces buffered
        within one loop tick ride a single object_notify_batch rpc (an
        evacuation sweep or a burst of restores was paying one GCS notify
        per object); awaiting the shared flush future keeps the v1
        contract that the announce is on the wire before the caller
        proceeds.  The first announcer of a tick becomes the flusher: it
        yields once (so same-tick announcers land in the buffer behind
        it), swaps the buffer out, and sends one batch; everyone else
        just awaits the flusher's future."""
        self._announce_buf.append((
            "add_object_location",
            {
                "object_id": oid,
                "node_id": self.node_id.binary(),
                "incarnation": self.incarnation,
                "size": size,
            },
        ))
        fut = self._announce_flush
        if fut is not None:
            await fut
            return
        self._announce_flush = fut = (
            asyncio.get_running_loop().create_future()
        )
        try:
            await asyncio.sleep(0)
        except BaseException as e:
            # cancelled before the swap: waiters' items are still
            # buffered — fail them so nobody parks on a dead future
            self._announce_flush = None
            fut.set_exception(e)
            fut.exception()
            raise
        # swap + clear BEFORE the notify awaits: an announcer arriving
        # mid-send must become the next flusher, not park on a future
        # whose batch does not contain its item
        items, self._announce_buf = self._announce_buf, []
        self._announce_flush = None
        try:
            if self.gcs is not None and items:
                if len(items) == 1:
                    await self.gcs.notify(items[0][0], items[0][1])
                else:
                    await self.gcs.notify(
                        "object_notify_batch", {"items": items}
                    )
        except BaseException as e:
            fut.set_exception(e)
            fut.exception()  # mark retrieved: waiters may all be gone
            raise
        fut.set_result(None)

    async def rpc_fetch_object(self, conn: rpc.Connection, p):
        """A remote raylet asks for an object's bytes (small objects)."""
        self._note_peer_inc(p)
        oid = p["object_id"]
        pin = self.store.get(oid)
        if pin is None:
            return await asyncio.to_thread(self._read_spilled, oid)
        try:
            return bytes(pin.view)
        finally:
            pin.release()

    async def rpc_fetch_object_meta(self, conn: rpc.Connection, p):
        self._note_peer_inc(p)
        oid = p["object_id"]
        pin = self.store.get(oid)
        if pin is None:
            size = self._spilled.get(oid)
            return None if size is None else {"size": size}
        try:
            return {"size": pin.view.nbytes}
        finally:
            pin.release()

    async def rpc_fetch_object_chunk(self, conn: rpc.Connection, p):
        self._note_peer_inc(p)
        oid = p["object_id"]
        off, ln = p["offset"], p["length"]
        pin = self.store.get(oid)
        if pin is None:
            # spilled: serve the byte range straight from the file — no
            # arena restore on the serving node
            return await asyncio.to_thread(self._read_spilled, oid, off, ln)
        try:
            return bytes(pin.view[off:off + ln])
        finally:
            pin.release()

    async def rpc_delete_objects(self, conn: rpc.Connection, p):
        for oid in p["object_ids"]:
            if not self.store.delete(oid):
                # a reader still pins it (zero-copy get in some process):
                # the delete is refused, and nothing ever retries it.
                # Clear the primary bit so the entry becomes ordinary LRU
                # prey the moment the last pin drops — a freed object
                # must not stay resident as an undeletable protected
                # primary for the life of the node.
                self.store.protect(oid, on=False)
            self._drop_spill_file(oid)
        return True

    async def rpc_store_stats(self, conn: rpc.Connection, p):
        st = self.store.stats()
        st["spilled_bytes"] = self._spilled_bytes
        st["spilled_objects"] = len(self._spilled)
        st["spill_count"] = self._spill_count
        st["restore_count"] = self._restore_count
        return st

    async def _peer(self, address: str,
                    node_hex: Optional[str] = None) -> rpc.Connection:
        c = self._peer_conns.get(address)
        if c is None or c.closed:
            c = await rpc.connect(address, name=f"raylet->{address}",
                                  peer_endpoint=node_hex)
            self._peer_conns[address] = c
        elif node_hex is not None and c.peer_endpoint is None:
            c.peer_endpoint = node_hex
        return c


def _inject_parent_site(root: str) -> None:
    """Make ray_tpu_torch + the base image's packages importable inside an
    isolated env at ``root`` (pip venv or conda env): a .pth in each of
    the env's site-packages appends the ray_tpu_torch package root and this
    interpreter's site dirs AFTER the env's own site-packages — the
    env's dependencies shadow ours where they overlap, but workers can
    always import the runtime (reference: runtime_env/conda.py
    _inject_ray_to_conda_site; shared here so pip and conda injection
    semantics can never diverge)."""
    import glob

    pkg_parent = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    parents = [pkg_parent] + [
        p for p in sys.path if p.endswith("site-packages")
    ]
    for vs in glob.glob(
        os.path.join(root, "lib", "python*", "site-packages")
    ):
        with open(os.path.join(vs, "_rt_parent_env.pth"), "w") as f:
            f.write("\n".join(parents) + "\n")


def _env_key(env: Optional[Dict[str, str]], rtenv_key: str = "") -> tuple:
    if env is None and not rtenv_key:
        return ()
    return (tuple(sorted((env or {}).items())), rtenv_key)


# --------------------------------------------------------------------------
# Entrypoint
# --------------------------------------------------------------------------


def main():
    import argparse
    import json

    ap = argparse.ArgumentParser()
    ap.add_argument("--gcs", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--node-id", default="")
    ap.add_argument("--resources", default="{}")
    ap.add_argument("--labels", default="{}")
    ap.add_argument("--store-capacity", type=int, default=0)
    ap.add_argument("--session-dir", default="")
    args = ap.parse_args()

    logging.basicConfig(level=logging.INFO,
                        format="[raylet] %(levelname)s %(message)s")

    # SIGUSR1 → dump all thread stacks to stderr (the raylet log): the
    # zero-dependency "where is it stuck" probe (reference role: py-spy
    # via the dashboard reporter)
    import faulthandler
    import signal as _signal

    faulthandler.register(_signal.SIGUSR1)

    async def run():
        import signal

        # Graceful SIGTERM: kill workers and unlink the shm arena — node
        # removal must not leak /dev/shm store files.  Installed BEFORE
        # start(): the parent can observe the node's GCS registration (made
        # inside start()) and send SIGTERM before this coroutine resumes.
        raylet = Raylet(
            gcs_address=args.gcs,
            node_id=NodeID.from_hex(args.node_id) if args.node_id else None,
            host=args.host,
            resources=json.loads(args.resources),
            labels=json.loads(args.labels),
            store_capacity=args.store_capacity,
            session_dir=args.session_dir,
        )
        asyncio.get_running_loop().add_signal_handler(
            signal.SIGTERM, raylet.stop_requested.set
        )
        await raylet.start()
        print(f"RAYLET_ADDRESS={raylet.server.address}", flush=True)
        print(f"RAYLET_NODE_ID={raylet.node_id.hex()}", flush=True)
        await raylet.stop_requested.wait()
        await raylet.close()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
