"""Worker process: executes tasks and hosts actors.

Role-equivalent of the reference's worker-side CoreWorker task execution
(ray: core_worker.cc ExecuteTask:2852, HandlePushTask:3424, the scheduling
queues in core_worker/transport/, and _raylet.pyx execute_task:1721).

Execution model: the runtime's asyncio loop owns all I/O; user code runs on
a single executor thread (sync tasks and sync actor methods — which also
gives per-worker FIFO) or directly on the loop (async actor methods, with a
max_concurrency semaphore).  Actor calls from one caller execute in
submission order via per-caller sequence gating, like the reference's
ActorSchedulingQueue.
"""

from __future__ import annotations

import asyncio
import contextlib
import inspect
import logging
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

from ray_tpu_torch.common.config import cfg
from ray_tpu_torch.common.ids import ActorID, NodeID, WorkerID
from ray_tpu_torch.core import rpc
from ray_tpu_torch.core.errors import TaskCancelledError, TaskError
from ray_tpu_torch.core.runtime import Runtime, set_runtime
from ray_tpu_torch.util import tracing

logger = logging.getLogger(__name__)


class WorkerServer:
    def __init__(self, runtime: Runtime):
        self.rt = runtime
        self.server = rpc.Server(
            self._handle, host="127.0.0.1", port=0,
            on_close=runtime._notify_peer_closed,
        )
        self._exec = ThreadPoolExecutor(max_workers=1, thread_name_prefix="rt-exec")
        self._exec_thread_id: Optional[int] = None
        self.actor_instance: Any = None
        self.actor_id: Optional[ActorID] = None
        self._actor_is_async = False
        self._actor_sem: Optional[asyncio.Semaphore] = None
        self._actor_thread_pool = None  # set for threaded sync actors
        # drain-migration capture fence: once this actor's state has been
        # captured (handle_checkpoint_actor), no further call may execute
        # here — post-capture effects would be acked and then lost.
        # _ckpt_unseal releases fence-parked calls if a FAILED capture
        # lifts the seal; _actor_exec_inflight counts admitted executions
        # across every path (executor, thread pools, loop-resident async
        # methods) so the capture can wait for quiescence.
        self._ckpt_sealed = False
        self._ckpt_unseal = asyncio.Event()
        self._actor_exec_inflight = 0
        # last object-plane checkpoint blob this process stored; freed if
        # a later capture finds it unconsumed (reply lost → never parked)
        self._ckpt_blob_oid: Optional[bytes] = None
        self._concurrency_groups: Dict[str, dict] = {}  # name -> sem/pool
        self._method_groups: Dict[str, str] = {}  # method -> group name
        self._running_task_threads: Dict[bytes, int] = {}  # task_id -> thread id
        self._running_tasks: Dict[bytes, dict] = {}  # task_id -> descriptor
        self._cancelled: set = set()
        # Per-caller actor-call ordering state (reference analogue:
        # ActorSchedulingQueue, core_worker/transport/actor_scheduling_queue.h):
        # caller_id -> {"next_seq": int admitted so far,
        #               "waiters": {seq: asyncio.Event},
        #               "inflight": {task_id: asyncio.Future(reply)},
        #               "replies": OrderedDict task_id -> reply (retry dedupe)}
        self._callers: Dict[bytes, dict] = {}
        # Adaptive inline execution of sync actor methods (serial actors
        # only).  The executor hop costs two context switches per call —
        # the dominant term for sub-millisecond methods — so a method
        # that has proven consistently fast runs directly on the io loop.
        # method name -> [fast_streak, demoted]
        self._method_stats: Dict[str, list] = {}
        # subsystems whose sync ops BRIDGE through the io loop (runtime
        # collectives) must never have their calling methods promoted
        # onto that loop — promotion would park the loop on itself.
        # Set via disable_inline_execution(); checked by both inline
        # fast paths.
        self._inline_disabled_reason: Optional[str] = None
        self._sync_exec_inflight = 0  # sync methods currently on the pool
        self._exec_counts = [0, 0]    # [inline runs, pool runs] (status RPC)
        # in-flight streaming generator tasks: task_id -> credit state
        self._out_streams: Dict[bytes, dict] = {}
        # compact-push task templates (data plane v2): tpl_id -> spec
        # skeleton.  The driver ships each skeleton once per connection;
        # later pushes carry only (tpl_id, task_id, args, job).  Process-
        # lifetime cache, bounded by the driver's distinct RemoteFunction
        # option-sets (the same bound as the fn cache).
        self._tpl_cache: Dict[bytes, dict] = {}

    _REPLY_CACHE_PER_CALLER = 256
    _INLINE_AFTER = 10        # samples before a method may promote
    _INLINE_EMA_S = 0.005     # stay inline while the exec-time EMA is under
    _INLINE_DEMOTE_S = 0.05   # one run this long bans inline for good

    async def start(self):
        await self.server.start()
        # capture the executor thread id for cancellation; awaited (not
        # fut.result()) so a slow pool spin-up can't stall the io loop
        fut = self._exec.submit(threading.get_ident)
        self._exec_thread_id = await asyncio.wrap_future(fut)

    async def _handle(self, conn: rpc.Connection, method: str, p: Any):
        if method == "push_task":
            return await self.handle_push_task(p, conn)
        if method == "push_actor_task":
            return await self.handle_push_actor_task(p, conn)
        if method == "stream_ack":
            st = self._out_streams.get(p["task_id"])
            if st is not None:
                st["acked"] = max(st["acked"], p["upto"])
                st["credit"].set()
            return True
        if method == "create_actor":
            return await self.handle_create_actor(p)
        if method == "checkpoint_actor":
            return await self.handle_checkpoint_actor(p)
        if method == "checkpoint_abort":
            return await self.handle_checkpoint_abort()
        if method == "bind_env":
            _bind_cuda(p["env"])
            os.environ.update(p["env"])
            if p.get("runtime_env"):
                from ray_tpu_torch.core import runtime_env as rtenv_mod

                async def _kv_get(sha):
                    return await self.rt.gcs.call("get_blob", {"sha": sha})

                await rtenv_mod.apply(p["runtime_env"], _kv_get)
            return True
        if method == "cancel_task":
            return self._cancel(p["task_id"])
        if method == "exit_worker":
            logger.info("exit requested: %s", p.get("reason"))
            threading.Thread(target=_exit_soon, daemon=True).start()
            return True
        if method == "ping":
            return {"pid": os.getpid(), "actor": bool(self.actor_instance)}
        if method == "chaos_partition":
            # raylet fan-out of a network-partition install: this worker
            # shares its node's network fate (common/faults.py link cuts)
            from ray_tpu_torch.common import faults

            faults.cut_link(p["src"], p["dst"], p.get("duration_s"))
            return True
        if method == "chaos_heal":
            from ray_tpu_torch.common import faults

            faults.heal_link(p.get("src"), p.get("dst"))
            return True
        if method == "dump_stacks":
            # on-demand stack capture (reference role: the dashboard's
            # py-spy integration, dashboard/modules/reporter/
            # profile_manager.py:83 — here native: every thread's Python
            # stack, no external profiler binary)
            import traceback

            frames = sys._current_frames()
            threads = {t.ident: t.name for t in threading.enumerate()}
            out = {}
            for ident, frame in frames.items():
                name = threads.get(ident, f"thread-{ident}")
                out[f"{name} ({ident})"] = "".join(
                    traceback.format_stack(frame)
                )
            return {"pid": os.getpid(), "stacks": out}
        if method == "status":
            # live task/actor view for the state API (ray: util/state)
            return {
                "pid": os.getpid(),
                "actor_class": type(self.actor_instance).__name__
                if self.actor_instance is not None
                else None,
                "running_tasks": list(self._running_tasks.values()),
                "exec_counts": {
                    "inline": self._exec_counts[0],
                    "pool": self._exec_counts[1],
                },
            }
        sub = self.rt._rpc_subhandlers.get(method)
        if sub is not None:
            return await sub(conn, p)
        raise rpc.RpcError(f"worker: unknown method {method!r}")

    # ---- normal tasks --------------------------------------------------
    def _expand_task_wire(self, t: tuple) -> dict:
        """Rebuild the full spec dict from a compact template push:
        ``(tpl_id, task_id, args, job[, skeleton])`` — the skeleton rides
        along on the first push over a connection and is cached here, so
        the driver never copies the spec per call."""
        if len(t) == 5:
            skel = t[4]
            self._tpl_cache[t[0]] = skel
        else:
            skel = self._tpl_cache.get(t[0])
            if skel is None:
                # driver believed the skeleton was already here (e.g. a
                # restarted worker reached through a recycled connection);
                # an RpcError reply breaks the lease, and the retry lands
                # with a fresh sent-set that re-ships the skeleton
                raise rpc.RpcError(
                    f"unknown task template {t[0].hex()}"
                )
        spec = dict(skel)
        spec["task_id"] = t[1]
        spec["args"] = t[2]
        if t[3]:
            spec["job"] = t[3]
        return spec

    async def handle_push_task(self, spec, conn=None) -> dict:
        if type(spec) is tuple:
            spec = self._expand_task_wire(spec)
        if spec.get("job"):
            # log-streaming attribution + nested submissions inherit it
            self.rt._current_job_hex = spec["job"]
        try:
            fn = await self.rt.resolve_fn(spec["fn_hash"])
        except Exception as e:
            return self._error_reply(e, spec)
        if spec.get("streaming") or inspect.iscoroutinefunction(fn):
            try:
                args, kwargs = await self.rt.unpack_args(spec["args"])
            except Exception as e:
                return self._error_reply(e, spec)
            if spec.get("streaming"):
                return await self._run_streaming(
                    conn, spec, fn, args, kwargs, self._exec
                )
            try:
                with _maybe_execute_span(spec):
                    result = await fn(*args, **kwargs)
                return self._exec_pack(spec, result)
            except Exception as e:
                return self._error_reply(e, spec)
        # sync function: proven-fast fns run inline on the io loop (the
        # executor is ONE thread, so execution is serial either way and
        # inline only skips its two context switches — the same
        # promote/demote contract as actor methods)
        key = "task:" + spec["fn_hash"].hex()
        reply = self._maybe_execute_task_inline(fn, key, spec)
        if reply is not None:
            return reply
        try:
            args, kwargs = await self.rt.unpack_args(spec["args"])
        except Exception as e:
            return self._error_reply(e, spec)
        self._sync_exec_inflight += 1
        try:
            # the streak is noted inside _execute_sync with PURE execution
            # time (queue wait excluded): pure time is what an inline run
            # would cost the loop, and for a serial executor the pool can
            # never overlap — so pipelined windows must still be able to
            # promote (r4 regression: queue-wait-inclusive timing kept
            # every windowed call on the pool forever)
            reply = await asyncio.get_running_loop().run_in_executor(
                self._exec, self._execute_sync, fn, args, kwargs, spec
            )
        finally:
            self._sync_exec_inflight -= 1
        return reply

    def disable_inline_execution(self, reason: str) -> None:
        """Permanently route this worker's sync methods through the
        executor pool.  Called by subsystems whose blocking ops await
        io-loop traffic (util.collective): a loop-inlined caller would
        deadlock the loop it bridges into."""
        self._inline_disabled_reason = reason

    def _maybe_execute_task_inline(self, fn, key: str, spec):
        """Plain-task twin of _maybe_execute_inline: run a proven-fast
        sync function directly on the io loop.  Same safety conditions —
        nothing on the executor (serial semantics preserved), ref-free
        args, sub-2ms streak; same tail-risk bound (one slow run demotes
        permanently past 50 ms)."""
        if self._sync_exec_inflight or self._inline_disabled_reason:
            return None
        st = self._method_stats.get(key)
        if (
            st is None or st[1] or st[0] < self._INLINE_AFTER
            or st[2] >= self._INLINE_EMA_S
        ):
            return None
        try:
            unpacked = self.rt.unpack_args_sync(spec["args"])
        except Exception as e:
            # a bad ARG (undeserializable payload) is the caller's error,
            # not a worker crash — letting it escape would surface as
            # RESPONSE_ERR and tear the healthy lease down
            return self._error_reply(e, spec)
        if unpacked is None:
            return None
        tid = spec["task_id"]
        if tid in self._cancelled:
            self._cancelled.discard(tid)
            return self._error_reply(TaskCancelledError("cancelled"), spec)
        t0_wall = time.time()
        # time ONLY fn(): all four note sites (inline + pool, task +
        # actor) must measure the same quantity or the EMA flaps between
        # promote and demote for methods with expensive serialization;
        # noted in a finally so slow RAISING runs demote/ban too
        t0 = time.perf_counter()
        try:
            args, kwargs = unpacked
            try:
                with _maybe_execute_span(spec):
                    result = fn(*args, **kwargs)
            finally:
                self._note_method_time(key, time.perf_counter() - t0)
            reply = self._exec_pack(spec, result)
            # exec span for the timeline, both reply shapes (promoted
            # fns must not vanish from dashboards)
            if type(reply) is tuple:
                reply = (reply[0], reply[1], t0_wall, time.time())
            else:
                reply["exec_span"] = (t0_wall, time.time())
        except TaskCancelledError as e:
            reply = self._error_reply(e, spec)
        except BaseException as e:
            reply = self._error_reply(
                e if isinstance(e, Exception) else RuntimeError(repr(e)),
                spec,
            )
        finally:
            self._cancelled.discard(tid)
        return reply

    def _execute_sync(self, fn, args, kwargs, spec) -> dict:
        tid = spec["task_id"]
        if tid in self._cancelled:  # cancelled while queued on the executor
            self._cancelled.discard(tid)
            return self._error_reply(TaskCancelledError("cancelled"), spec)
        self._running_task_threads[tid] = threading.get_ident()
        self._running_tasks[tid] = {
            "task_id": tid.hex(),
            "name": spec.get("name") or "<task>",
            "start_time": time.time(),
        }
        try:
            t0 = time.time()
            t0p = time.perf_counter()
            try:
                with _maybe_execute_span(spec):
                    result = fn(*args, **kwargs)
            finally:
                # finally: slow raising runs must demote/ban too
                self._note_method_time(
                    "task:" + spec["fn_hash"].hex(),
                    time.perf_counter() - t0p,
                )
            reply = self._exec_pack(spec, result)
            if type(reply) is tuple:  # compact ("i", payload) fast shape
                return (reply[0], reply[1], t0, time.time())
            reply["exec_span"] = (t0, time.time())
            return reply
        except TaskCancelledError as e:
            return self._error_reply(e, spec)
        except BaseException as e:
            if tid in self._cancelled:
                return self._error_reply(TaskCancelledError(str(e)), spec)
            return self._error_reply(e, spec)
        finally:
            self._running_task_threads.pop(tid, None)
            self._running_tasks.pop(tid, None)
            self._cancelled.discard(tid)

    # ---- streaming generator tasks --------------------------------------
    # Reference: streaming generators (_raylet.pyx:273 ObjectRefGenerator,
    # core_worker task output streaming).  Items ship as stream_item
    # notifies over the duplex connection that carried the push; the RPC
    # reply closes the stream with the total item count.  `stream_ack`
    # notifies from the consumer advance the credit window.

    async def _run_streaming(
        self, conn, spec, fn, args, kwargs, pool, sem=None
    ) -> dict:
        tid = spec["task_id"]
        state = {"acked": -1, "sent": 0, "credit": asyncio.Event()}
        self._out_streams[tid] = state
        loop = asyncio.get_running_loop()
        err: Optional[BaseException] = None
        try:
            if tid in self._cancelled:
                self._cancelled.discard(tid)
                raise TaskCancelledError("cancelled before start")
            if inspect.isasyncgenfunction(fn):
                # Generator methods count against the actor/group
                # concurrency limit for their whole lifetime, like the
                # non-streaming async path (sync generators are bounded
                # by the pool they occupy below).
                async with sem if sem is not None else contextlib.nullcontext():
                    async for item in fn(*args, **kwargs):
                        await self._stream_send(conn, spec, state, item)
            else:
                def pump():
                    # sync generator on the executor thread; each item ships
                    # through the loop synchronously, so backpressure stalls
                    # the generator itself
                    self._running_task_threads[tid] = threading.get_ident()
                    self._running_tasks[tid] = {
                        "task_id": tid.hex(),
                        "name": spec.get("name") or spec.get("method")
                        or "<generator>",
                        "start_time": time.time(),
                    }
                    try:
                        for item in fn(*args, **kwargs):
                            if tid in self._cancelled:
                                raise TaskCancelledError("cancelled")
                            asyncio.run_coroutine_threadsafe(
                                self._stream_send(conn, spec, state, item),
                                loop,
                            ).result()
                    finally:
                        self._running_task_threads.pop(tid, None)
                        self._running_tasks.pop(tid, None)

                await loop.run_in_executor(pool, pump)
        except BaseException as e:
            err = e if isinstance(e, Exception) else RuntimeError(repr(e))
        if err is not None:
            # deliver the error as the stream's final item (the consumer's
            # next() hands back a ref that raises), then close normally.
            # Must run BEFORE the state pop: error sends skip backpressure,
            # but the state must stay reachable for stream_ack handlers.
            try:
                await self._stream_send(conn, spec, state, None, error=err)
            except Exception:
                pass  # conn gone: the caller already failed the stream
        self._out_streams.pop(tid, None)
        self._cancelled.discard(tid)
        return {"status": "ok", "streaming": state["sent"]}

    async def _stream_send(self, conn, spec, state, item, error=None):
        idx = state["sent"]
        if error is None:
            # error items skip backpressure: a consumer that stopped
            # acking (cancel/abandon) must not deadlock the closing send
            if spec["task_id"] in self._cancelled:
                raise TaskCancelledError("cancelled")
            while idx - state["acked"] > cfg.streaming_backpressure_items:
                state["credit"].clear()
                await state["credit"].wait()
                if spec["task_id"] in self._cancelled:
                    raise TaskCancelledError("cancelled")
        from ray_tpu_torch.common.ids import task_return_binary

        if error is not None:
            terr = error if isinstance(error, TaskError) else (
                TaskError.from_exception(
                    error,
                    task_desc=spec.get("name") or spec.get("method", "task"),
                )
            )
            payload = ("err", self.rt.serialize(terr).to_bytes())
        else:
            s, nested = self.rt._serialize_tracked(item)
            if s.total_bytes <= cfg.inline_object_max_bytes:
                payload = ("inline", s.to_bytes())
            else:
                oid = task_return_binary(spec["task_id"], idx)
                # windowed announce (BENCH.md multi-client term (c)): the
                # GCS directory parks location lookups behind a waiter, so
                # a cross-node consumer racing the flush window resolves
                # the moment the batched announce lands
                self.rt._write_to_store(oid, s, urgent_announce=False)
                self.rt._register_edges(oid, nested)
                payload = ("stored", s.total_bytes)
        await conn.notify("stream_item", {
            "task_id": spec["task_id"],
            "index": idx,
            "item": payload,
        })
        state["sent"] = idx + 1

    def _exec_pack(self, spec, result):
        n = spec["num_returns"]
        if n == 1:
            # hot path: single return, inline-sized → compact tuple reply
            # ("i", payload); the caller's _apply_task_reply fast-branch
            # consumes it (dict replies remain for every other shape)
            s, nested = self.rt._serialize_tracked(result)
            if s.total_bytes <= cfg.inline_object_max_bytes:
                return ("i", s.to_bytes())
            from ray_tpu_torch.common.ids import task_return_binary

            oid = task_return_binary(spec["task_id"], 0)
            # windowed announce (BENCH.md multi-client term (c)): a same-
            # node caller resolves the "stored" reply straight off the
            # shared arena (no directory read), and a cross-node pull
            # parks on the GCS location waiter until the batched announce
            # lands ≤ one flush window later — per-result notify rpcs
            # were one of the three multi-client put costs itemized in
            # the roofline
            self.rt._write_to_store(oid, s, urgent_announce=False)
            self.rt._register_edges(oid, nested)
            return {"status": "ok", "returns": [("stored", s.total_bytes)]}
        values = list(result)
        if len(values) != n:
            raise ValueError(
                f"task declared num_returns={n} but returned {len(values)}"
            )
        from ray_tpu_torch.common.ids import task_return_binary

        tid = spec["task_id"]
        returns = []
        for i, v in enumerate(values):
            s, nested = self.rt._serialize_tracked(v)
            if s.total_bytes <= cfg.inline_object_max_bytes:
                # inline: the caller deserializes immediately, so nested
                # refs become live ObjectRefs there — no edge needed
                returns.append(("inline", s.to_bytes()))
            else:
                oid = task_return_binary(tid, i)
                self.rt._write_to_store(oid, s, urgent_announce=False)
                self.rt._register_edges(oid, nested)
                returns.append(("stored", s.total_bytes))
        return {"status": "ok", "returns": returns}

    def _error_reply(self, e, spec) -> dict:
        if isinstance(e, TaskError):
            err = e
        else:
            err = TaskError.from_exception(
                e, task_desc=spec.get("name") or spec.get("method", "task")
            )
        return {"status": "error", "error": self.rt.serialize(err).to_bytes()}

    def _cancel(self, task_id: bytes) -> bool:
        thread_id = self._running_task_threads.get(task_id)
        self._cancelled.add(task_id)
        st = self._out_streams.get(task_id)
        if st is not None:
            # wake a producer parked in the backpressure credit wait — the
            # async-exc below cannot land while its pump thread is blocked
            # inside run_coroutine_threadsafe(...).result()
            st["credit"].set()
        if thread_id is not None:
            import ctypes

            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(thread_id), ctypes.py_object(TaskCancelledError)
            )
            return True
        return False

    # ---- actors --------------------------------------------------------
    async def handle_create_actor(self, p) -> bool:
        spec = p["creation_spec"]
        if p.get("accelerator_env"):
            _bind_cuda(p["accelerator_env"])
        cls = await self.rt.resolve_fn(spec["cls_hash"])
        args, kwargs = await self.rt.unpack_args(spec["args"])
        self.actor_id = ActorID(p["actor_id"])
        self.rt.actor_id = self.actor_id
        # async actor iff any public method is a coroutine function
        self._actor_is_async = any(
            inspect.iscoroutinefunction(m)
            for _, m in inspect.getmembers(cls, predicate=inspect.isfunction)
        )
        self._actor_sem = asyncio.Semaphore(spec.get("max_concurrency") or 1000)
        # threaded sync actors (reference: threaded actors via
        # max_concurrency on a non-async class): methods run on a pool of
        # N threads instead of the single ordered executor thread.
        # Admission stays per-caller-ordered (seq), but executions
        # overlap — the same relaxation the reference documents.
        mc = spec.get("max_concurrency") or 1
        if not self._actor_is_async and mc > 1:
            import concurrent.futures

            self._actor_thread_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=mc, thread_name_prefix="actor-mc"
            )
        # Named concurrency groups (reference: python/ray/actor.py:521-539):
        # each group gets its own limit — a semaphore for async methods, a
        # thread pool for sync ones — so saturating one group never blocks
        # another.  Method→group defaults come from @method(
        # concurrency_group=...); per-call .options() overrides.
        self._concurrency_groups = {}
        self._method_groups = dict(spec.get("method_groups") or {})
        for gname, limit in (spec.get("concurrency_groups") or {}).items():
            import concurrent.futures

            self._concurrency_groups[gname] = {
                "sem": asyncio.Semaphore(limit),
                "pool": concurrent.futures.ThreadPoolExecutor(
                    max_workers=limit,
                    thread_name_prefix=f"actor-cg-{gname}",
                ),
            }
        if spec.get("job"):
            self.rt._current_job_hex = spec["job"]
        from ray_tpu_torch.core import log_streaming

        if log_streaming._publisher is not None:
            # driver-side log prefix becomes "(ClassName pid=..., ...)"
            log_streaming._publisher.set_actor_name(cls.__name__)
        loop = asyncio.get_running_loop()
        self.actor_instance = await loop.run_in_executor(
            self._exec, lambda: cls(*args, **kwargs)
        )
        # graceful-drain handoff: restore the migrated state (opt-in
        # __rt_checkpoint__/__rt_restore__ pair), then re-join any
        # collective groups the predecessor process was a member of —
        # the replacement-reform path, with survivors nudged via pubsub
        blob = p.get("checkpoint")
        blob_ref = p.get("checkpoint_ref")
        restore = getattr(self.actor_instance, "__rt_restore__", None)
        if callable(restore) and (blob is not None or blob_ref is not None):
            state, have = None, False
            if blob is not None:
                state = self.rt.deserialize(blob)
                have = True
                src = f"{len(blob)} bytes inline"
            else:
                # object-plane blob: pull over the data plane (the
                # draining source node is still alive — the drain holds
                # the kill until migration completes).  A lost blob
                # (drain fell back to hard death before a copy escaped)
                # degrades to a fresh start, like a failed capture.
                deadline = (
                    time.monotonic() + cfg.actor_ckpt_fetch_timeout_s
                )
                try:
                    (state,) = await self.rt._get_async(
                        [blob_ref], deadline
                    )
                    have = True
                    src = f"object {blob_ref.hex()[:12]}"
                except Exception:
                    logger.exception(
                        "actor %s checkpoint blob %s unavailable; "
                        "restoring fresh", self.actor_id,
                        blob_ref.hex()[:12],
                    )
            if have:
                await loop.run_in_executor(self._exec, restore, state)
                logger.info(
                    "actor %s state restored from drain checkpoint "
                    "(%s)", self.actor_id, src,
                )
        for g in p.get("collective_groups") or ():
            try:
                await self._rejoin_collective_group(g)
            except Exception:
                logger.exception(
                    "collective group %r re-join failed after migration; "
                    "the group stays un-reformed (destroy + re-init "
                    "recovers)", g.get("group_name"),
                )
        logger.info("actor %s created (%s)", self.actor_id, cls.__name__)
        return True

    async def _rejoin_collective_group(self, g: dict):
        """Re-join one group after a drain migration: publish the reform
        event so the surviving ranks enter the same-world replacement
        reform, then join under the predecessor's rank."""
        from ray_tpu_torch.util.collective import collective as col_mod

        mgr = col_mod._manager()
        self.rt.publish(
            col_mod.reform_channel(g["group_name"]),
            {
                "world_size": g["world_size"],
                "origin_rank": g["rank"],
            },
        )
        await mgr.reform_group(
            g["group_name"], g["world_size"], rank=g["rank"],
            backend_name=g.get("backend"),
        )
        logger.info(
            "re-joined collective group %r as rank %d after migration",
            g["group_name"], g["rank"],
        )

    async def handle_checkpoint_actor(self, p) -> dict:
        """Drain-time state capture (GCS → worker): runs the opt-in
        ``__rt_checkpoint__`` hook and reports this process's collective
        group memberships.  A half-implemented hook pair (rtlint RT113)
        degrades to unsupported — the actor restarts fresh.

        Blobs at most ``actor_ckpt_inline_max_bytes`` ride inline over
        this conn into GCS KV, bit-for-bit the original path.  Larger
        blobs (a pipeline stage's params + optimizer state) are stored
        in the shm object plane — written via the vectored single-pass
        put and announced urgently so the restoring worker's pull finds
        the location — and only the 16-byte object id crosses the
        control plane; the GCS frees the object after the restore."""
        groups = []
        if "ray_tpu_torch.util.collective.collective" in sys.modules:
            from ray_tpu_torch.util.collective import collective as col_mod

            groups = col_mod.local_group_memberships()
        inst = self.actor_instance
        ck = getattr(inst, "__rt_checkpoint__", None) if inst else None
        restore = getattr(inst, "__rt_restore__", None) if inst else None
        if not callable(ck) or not callable(restore):
            return {"supported": False, "blob": None, "groups": groups}
        loop = asyncio.get_running_loop()
        # Capture fence: seal admission BEFORE the hook runs, then wait
        # for every already-admitted execution to finish.  Admitted calls
        # complete and their effects land in the capture (their replies
        # stay valid); calls arriving after the seal park unreplied and
        # die with this worker, becoming retries against the RESTORED
        # actor.  Without the fence, a call slipping in between capture
        # and the kill executes+acks here but its effects are absent from
        # the migrated state — an acked-but-lost mutation.  The
        # quiescence wait (not FIFO ordering) is what makes this hold for
        # async actors, threaded sync actors, and concurrency-group
        # methods too, whose executions do not serialize through
        # self._exec.  Unbounded on purpose — the outer drain deadline is
        # the bound, and every successful-capture path ends in this
        # worker's death, so sealing cannot strand callers.
        self._ckpt_sealed = True
        # ONE persistent event, cleared on seal — never replaced: calls
        # parked during an earlier capture must wake on ANY later unseal
        # (a swapped-in fresh event would strand them forever)
        self._ckpt_unseal.clear()
        try:
            # bounded: a re-entrant call chain (m1 awaiting self.m2 —
            # the inner call is parked on the fence m1 is counted
            # against) can never quiesce; proceeding with a possibly
            # torn capture after the budget beats burning the whole
            # drain deadline into the hard-death fallback
            quiesce_end = (
                time.monotonic() + cfg.actor_ckpt_quiesce_timeout_s
            )
            while self._actor_exec_inflight:
                if time.monotonic() >= quiesce_end:
                    logger.warning(
                        "actor %s capture proceeding with %d calls "
                        "still in flight after %.0fs quiescence wait "
                        "(re-entrant call pattern?); their effects may "
                        "miss the migrated state", self.actor_id,
                        self._actor_exec_inflight,
                        cfg.actor_ckpt_quiesce_timeout_s,
                    )
                    break
                await asyncio.sleep(0.02)
            state = await loop.run_in_executor(self._exec, ck)
            # the capture now owns re-delivery: stop this doomed
            # process's p2p channel streaming (in-flight sends are
            # cancelled, reform listeners deregistered) — the restored
            # twin's checkpointed outbox re-offers on reform, and
            # without the teardown the old incarnation keeps pushing
            # chunks it already captured, burning the drain window on
            # dead traffic.  Ordered AFTER the capture (the outbox
            # snapshot must precede the cancel) and BEFORE serialize.
            if "ray_tpu_torch.util.collective.channel" in sys.modules:
                from ray_tpu_torch.util.collective import channel as channel_mod

                channel_mod.drain_teardown()
            s = self.rt.serialize(state)
            # a previous capture's object-plane blob was never consumed
            # (its reply was lost, or that drain fell over before the
            # restore): this process is still alive, so that migration
            # never happened — free the orphan instead of leaking a
            # protected primary in the node arena, whatever size THIS
            # capture turns out to be (double-free of a consumed blob is
            # a benign tombstone hit).  Swap-then-free, NOT
            # check-free-clear: the free awaits GCS, and a concurrent
            # capture (rpc retry after a lost reply) or abort runs on
            # this same loop during that await — clearing AFTER it acts
            # on a stale pre-await read and stomps whatever they set,
            # orphaning a tracked blob (rtlint RT302)
            orphan, self._ckpt_blob_oid = self._ckpt_blob_oid, None
            await self._free_ckpt_blob(orphan)
            if s.total_bytes > cfg.actor_ckpt_inline_max_bytes:
                from ray_tpu_torch.common.ids import ObjectID

                oid = ObjectID.random().binary()
                # executor, not the loop: the arena write may need the
                # spill-and-retry path, which must not block the io loop
                await loop.run_in_executor(
                    self._exec,
                    lambda: self.rt._write_to_store(oid, s,
                                                    urgent_announce=True),
                )
                # same swap discipline as above: a concurrent capture may
                # have tracked ITS blob during the store await; free it
                # as we take over tracking, or it leaks untracked
                stale, self._ckpt_blob_oid = self._ckpt_blob_oid, oid
                await self._free_ckpt_blob(stale)
                logger.info(
                    "actor %s checkpoint blob (%d bytes) stored in the "
                    "object plane as %s", self.actor_id, s.total_bytes,
                    oid.hex()[:12],
                )
                return {"supported": True, "blob": None, "blob_ref": oid,
                        "blob_bytes": s.total_bytes, "groups": groups}
            return {"supported": True, "blob": s.to_bytes(),
                    "groups": groups}
        except BaseException:
            # a failed capture degrades to a fresh migration (or, with no
            # restart budget, to serving until the kill) — lift the fence
            # AND release the calls parked on it, so "keeps serving" does
            # not become "hangs until node death"
            self._ckpt_sealed = False
            self._ckpt_unseal.set()
            raise

    async def _free_ckpt_blob(self, oid: Optional[bytes]) -> None:
        """Best-effort free of an orphaned checkpoint blob.  Callers
        must have already swapped the oid out of ``_ckpt_blob_oid``
        BEFORE awaiting this (so a concurrent capture/abort never sees
        — and double-handles — an oid that is being freed)."""
        if oid is None:
            return
        try:
            await self.rt.gcs.call(
                "free_objects", {"object_ids": [oid]}, timeout=10.0
            )
        except Exception:
            # unreachable GCS: the node's death still bounds the orphan
            pass

    async def handle_checkpoint_abort(self) -> bool:
        """GCS → worker: the migration this capture was for is NOT
        happening (checkpoint rpc failed GCS-side and the actor is being
        left to serve) — lift the capture fence, release parked calls,
        and free the now-orphaned object-plane blob (nothing will ever
        consume it, and as a protected primary it would pin arena space
        for the node's remaining life).  Idempotent; a no-op on a
        never-sealed worker."""
        if self._ckpt_sealed:
            logger.info(
                "actor %s capture fence aborted by GCS; resuming service",
                self.actor_id,
            )
        self._ckpt_sealed = False
        self._ckpt_unseal.set()
        oid, self._ckpt_blob_oid = self._ckpt_blob_oid, None
        if oid is not None:
            try:
                await self.rt.gcs.call(
                    "free_objects", {"object_ids": [oid]}, timeout=10.0
                )
            except Exception:
                # unreachable GCS: the next capture's self-cleanup (or
                # the node's death) still bounds the orphan
                self._ckpt_blob_oid = oid
        return True

    async def handle_push_actor_task(self, spec, conn=None) -> dict:
        """Per-caller submission ordering, enforced by sequence number.

        Calls are ADMITTED in `seq` order (buffered while earlier seqs are
        in flight over a reconnecting transport).  Default sync actors
        then enter a single executor thread in admission order — which
        gives per-caller execution order even when a retry races fresh
        calls on a new TCP connection.  Threaded sync actors
        (max_concurrency > 1) keep only admission order: executions run
        on a thread pool and may overlap/complete out of order, the same
        relaxation the reference documents for threaded actors.  Retries of a task that already ran (or is running) are
        deduplicated by task_id and answered from the reply cache instead of
        re-executing — exactly-once against an alive actor (reference:
        ActorSchedulingQueue sequence numbers + duplicate suppression).
        Async methods run concurrently under the semaphore (admission order
        only), like the reference's out-of-order queue for async actors."""
        caller = spec.get("caller_id", b"")
        seq = spec.get("seq")
        epoch = spec.get("seq_epoch", 0)
        tid = spec["task_id"]
        if spec.get("job"):
            self.rt._current_job_hex = spec["job"]
        cs = self._callers.get(caller)
        if cs is None:
            cs = self._callers[caller] = {
                "epochs": {},     # epoch -> {"next_seq", "waiters", "dead"}
                "max_epoch": -1,
                "inflight": {},   # task_id -> Future(reply)
                "replies": {},    # task_id -> reply (cross-epoch dedupe)
            }
        if seq is not None:
            if epoch > cs["max_epoch"]:
                cs["max_epoch"] = epoch
                # the caller reconnected: abandon ordering state of older
                # epochs (their unadmitted calls are re-pushed under the
                # new epoch; parked coroutines must not wait forever)
                for old in list(cs["epochs"]):
                    if old < epoch:
                        es = cs["epochs"].pop(old)
                        es["dead"] = True
                        for ev in es["waiters"].values():
                            ev.set()
            elif epoch < cs["max_epoch"]:
                return self._error_reply(
                    RuntimeError(
                        f"stale actor call from abandoned connection epoch "
                        f"{epoch} (current {cs['max_epoch']})"
                    ),
                    spec,
                )
            es = cs["epochs"].get(epoch)
            if es is None:
                es = cs["epochs"][epoch] = {
                    "next_seq": 0, "waiters": {}, "dead": False,
                }
            if seq < es["next_seq"]:
                # duplicate delivery of an already-admitted seq: answer
                # from the reply cache (or share the running execution) —
                # never re-execute
                if tid in cs["replies"]:
                    return cs["replies"][tid]
                fut = cs["inflight"].get(tid)
                if fut is not None:
                    return await asyncio.shield(fut)
                # no record: the reply aged out of the cache — it already
                # executed; report rather than rerun
                return self._error_reply(
                    RuntimeError(
                        f"duplicate actor call (seq {seq} already executed, "
                        f"reply no longer cached)"
                    ),
                    spec,
                )
            while seq > es["next_seq"] and not es["dead"]:
                # park keyed by OUR seq; the predecessor wakes exactly us
                ev = es["waiters"].setdefault(seq, asyncio.Event())
                await ev.wait()
                ev.clear()
            if es["dead"]:
                return self._error_reply(
                    RuntimeError("connection epoch abandoned mid-wait"), spec
                )
            # admit: bump next_seq BEFORE executing so the successor can
            # queue into the executor right behind us (FIFO thread = order)
            es["next_seq"] = seq + 1
            es["waiters"].pop(seq, None)
            nxt = es["waiters"].get(es["next_seq"])
            if nxt is not None:
                nxt.set()

        # Retry dedupe AFTER seq admission: a re-pushed call must still
        # consume its slot in the new epoch (or its successors would park
        # forever), but must not re-execute — completed → cached reply;
        # still running → share its outcome.
        if tid in cs["replies"]:
            return cs["replies"][tid]
        fut = cs["inflight"].get(tid)
        if fut is not None:
            return await asyncio.shield(fut)

        while self._ckpt_sealed:
            # drain-migration capture fence (see handle_checkpoint_actor):
            # this actor's state is being captured for migration — park
            # so the call dies UNREPLIED with this worker and is retried
            # against the restored actor.  Cached replies above still
            # serve (their effects are in the capture).  A failed or
            # aborted capture sets the (persistent) unseal event,
            # releasing the parked calls to execute normally.
            await self._ckpt_unseal.wait()

        # Method / instance / concurrency-group resolution ALL happen
        # after seq admission and before the inflight future exists: an
        # error return earlier would leave the failed call's seq slot
        # unconsumed (every later call from this caller parks on
        # `seq > next_seq` forever — and h.typo.remote() is reachable by
        # any user, ActorHandle does no client-side method validation);
        # an error return after registering reply_fut would leave a
        # never-resolved future that a retried push awaits forever.
        if self.actor_instance is None:
            return self._cache_reply(cs, tid, self._error_reply(
                RuntimeError("actor instance not created on this worker"),
                spec,
            ))
        if spec["method"] == "__rt_apply__":
            # generic in-actor apply (reference: __ray_call__): first arg
            # is a function called as fn(instance, *rest) — the compiled
            # DAG exec loop rides this, as can any diagnostic.
            inst = self.actor_instance

            def method(__fn, *a, **kw):
                return __fn(inst, *a, **kw)
        else:
            try:
                method = getattr(self.actor_instance, spec["method"])
            except AttributeError as e:
                return self._cache_reply(cs, tid, self._error_reply(e, spec))

        # concurrency group: explicit per-call choice, else the method's
        # declared group, else the default (flat) limits.  An unknown
        # name is an ERROR — silently falling back would strip the limit
        # the caller asked for (the reference raises too).
        gname = spec.get("concurrency_group") or self._method_groups.get(
            spec["method"]
        )
        cg = self._concurrency_groups.get(gname) if gname else None
        if gname and cg is None:
            return self._cache_reply(cs, tid, self._error_reply(
                ValueError(
                    f"unknown concurrency group {gname!r}; declared "
                    f"groups: {sorted(self._concurrency_groups)}"
                ),
                spec,
            ))

        reply_fut: asyncio.Future = asyncio.get_running_loop().create_future()
        cs["inflight"][tid] = reply_fut
        # counted for the capture fence's quiescence wait; no await sits
        # between the fence check above and this increment, so a sealing
        # checkpoint either sees the call here or it parks on the fence
        self._actor_exec_inflight += 1
        try:
            if spec.get("streaming"):
                try:
                    args, kwargs = await self.rt.unpack_args(spec["args"])
                except Exception as e:
                    reply = self._error_reply(e, spec)
                else:
                    reply = await self._run_streaming(
                        conn, spec, method, args, kwargs,
                        (cg["pool"] if cg else None)
                        or self._actor_thread_pool or self._exec,
                        sem=(cg["sem"] if cg else self._actor_sem),
                    )
            elif inspect.iscoroutinefunction(method):
                try:
                    args, kwargs = await self.rt.unpack_args(spec["args"])
                except Exception as e:
                    reply = self._error_reply(e, spec)
                else:
                    async with (cg["sem"] if cg else self._actor_sem):
                        self._running_tasks[tid] = {
                            "task_id": tid.hex(),
                            "name": spec.get("name")
                            or spec.get("method")
                            or "<async method>",
                            "start_time": time.time(),
                        }
                        try:
                            with _maybe_execute_span(spec):
                                result = await method(*args, **kwargs)
                            reply = self._exec_pack(spec, result)
                        except Exception as e:
                            reply = self._error_reply(e, spec)
                        finally:
                            self._running_tasks.pop(tid, None)
            else:
                reply = None if cg else self._maybe_execute_inline(
                    method, spec
                )
                if reply is not None:
                    self._exec_counts[0] += 1
                else:
                    pool = (
                        cg["pool"] if cg
                        else self._actor_thread_pool or self._exec
                    )
                    self._exec_counts[1] += 1
                    self._sync_exec_inflight += 1
                    try:
                        # streak noted inside _execute_sync_method with
                        # PURE execution time — see handle_push_task
                        reply = await asyncio.get_running_loop().run_in_executor(
                            pool, self._execute_sync_method, method, spec
                        )
                    finally:
                        self._sync_exec_inflight -= 1
        except BaseException as e:
            reply = self._error_reply(
                e if isinstance(e, Exception) else RuntimeError(repr(e)), spec
            )
        finally:
            self._actor_exec_inflight -= 1
        cs["inflight"].pop(tid, None)
        self._cache_reply(cs, tid, reply)
        if not reply_fut.done():
            reply_fut.set_result(reply)
        return reply

    def _cache_reply(self, cs, tid, reply) -> dict:
        """Insert into the per-caller reply cache with the size bound
        applied (every insertion path must trim, or a caller repeatedly
        hitting an error path grows the cache without bound)."""
        cs["replies"][tid] = reply
        while len(cs["replies"]) > self._REPLY_CACHE_PER_CALLER:
            cs["replies"].pop(next(iter(cs["replies"])))
        return reply

    def _maybe_execute_inline(self, method, spec) -> Optional[dict]:
        """Run a proven-fast sync method directly on the io loop, skipping
        the executor's two context switches.  Inline is taken only when it
        cannot be observed: the actor is serial (no thread pool), nothing
        is running on the executor (so executions can't overlap), the args
        are ref-free (resolving a ref needs the loop), and the method's
        recent-execution-time EMA is under _INLINE_EMA_S.  First calls
        always go through the pool, so a blocking method never runs
        inline.  The tail risk — a promoted method whose NEXT run turns
        slow blocks the loop for that one run, and cancellation cannot
        interrupt it — is bounded by demotion: any run past
        _INLINE_DEMOTE_S (50 ms) bans the method from inline permanently,
        and a sustained slowdown drags the EMA over the bar.
        Returns None when the pool must be used."""
        if (
            self._actor_thread_pool is not None
            or self._sync_exec_inflight
            or self._inline_disabled_reason
        ):
            return None
        mname = spec["method"]
        if mname == "__rt_apply__":
            # generic apply carries a DIFFERENT callable per call under
            # one stats key: past sub-2ms calls predict nothing about
            # the next one (e.g. collective init bridging into this
            # very loop) — promotion is unsound here by construction
            return None
        st = self._method_stats.get(mname)
        if (
            st is None or st[1] or st[0] < self._INLINE_AFTER
            or st[2] >= self._INLINE_EMA_S
        ):
            return None
        unpacked = self.rt.unpack_args_sync(spec["args"])
        if unpacked is None:
            return None
        tid = spec["task_id"]
        if tid in self._cancelled:
            self._cancelled.discard(tid)
            return self._error_reply(TaskCancelledError("cancelled"), spec)
        try:
            args, kwargs = unpacked
            # time ONLY the method call (matches the pool path's
            # estimator — timing pack here too made the EMA disagree
            # between paths and flap promote/demote); noted in a finally
            # so slow raising runs demote/ban as well
            t0 = time.perf_counter()
            try:
                result = method(*args, **kwargs)
            finally:
                self._note_method_time(mname, time.perf_counter() - t0)
            reply = self._exec_pack(spec, result)
        except TaskCancelledError as e:
            reply = self._error_reply(e, spec)
        except BaseException as e:
            reply = self._error_reply(
                e if isinstance(e, Exception) else RuntimeError(repr(e)), spec
            )
        finally:
            self._cancelled.discard(tid)
        return reply

    def _note_method_time(self, mname: str, dt: float):
        # [samples, banned, ema].  An EMA (not a consecutive-fast streak)
        # so one OS-preemption spike — routine on a loaded host, and the
        # r4 regression: a single >2ms measurement de-promoted the method
        # and locked pipelined windows onto the pool — cannot flip a
        # genuinely fast method back to the executor.  A single run past
        # the demote bound still bans inline outright.
        st = self._method_stats.get(mname)
        if st is None:
            st = self._method_stats[mname] = [1, False, dt]
        else:
            st[0] += 1
            st[2] += 0.125 * (dt - st[2])
        if dt > self._INLINE_DEMOTE_S:
            st[1] = True

    def _execute_sync_method(self, method, spec) -> dict:
        tid = spec["task_id"]
        if tid in self._cancelled:
            self._cancelled.discard(tid)
            return self._error_reply(TaskCancelledError("cancelled"), spec)
        self._running_task_threads[tid] = threading.get_ident()
        self._running_tasks[tid] = {
            "task_id": tid.hex(),
            "name": spec.get("name") or spec.get("method") or "<actor method>",
            "start_time": time.time(),
        }
        try:
            unpacked = self.rt.unpack_args_sync(spec["args"])
            if unpacked is None:  # ObjectRef args: resolve on the io loop
                unpacked = self.rt._run(self.rt.unpack_args(spec["args"]))
            args, kwargs = unpacked
            t0p = time.perf_counter()
            try:
                with _maybe_execute_span(spec):
                    result = method(*args, **kwargs)
            finally:
                # finally: slow raising runs must demote/ban too
                self._note_method_time(
                    spec["method"], time.perf_counter() - t0p
                )
            return self._exec_pack(spec, result)
        except TaskCancelledError as e:
            return self._error_reply(e, spec)
        except BaseException as e:
            if tid in self._cancelled:
                return self._error_reply(TaskCancelledError(str(e)), spec)
            return self._error_reply(e, spec)
        finally:
            self._running_task_threads.pop(tid, None)
            self._running_tasks.pop(tid, None)
            self._cancelled.discard(tid)


def _maybe_execute_span(spec):
    """Execute-side span parented under the submitter's context (the
    TaskSpec's trace_ctx carrier); a no-op context when tracing is off
    or the caller sent no context."""
    if tracing.enabled() and spec.get("trace_ctx"):
        return tracing.span(
            f"execute {spec.get('method') or spec.get('name') or 'task'}",
            carrier=spec["trace_ctx"],
            task_id=spec["task_id"].hex(),
        )
    return contextlib.nullcontext()


def _exit_soon():
    time.sleep(0.1)
    from ray_tpu_torch.util.profiling import dump_profile

    dump_profile()
    os._exit(0)


def _bind_cuda(env: dict) -> None:
    """Bind this worker to the cards its lease names.

    CUDA reads ``CUDA_VISIBLE_DEVICES`` once, when it initialises in the
    process, so the variable is set here, before any code of the lease
    runs; a lease without GPUs sets it to "" and sees no card.  A
    GPU-leased worker makes card 0 of its set the current device as soon
    as torch is imported.  Where CUDA was already initialised under
    another set, carrying on would run on the wrong card: that raises
    (the reference only warns when it is too late to move jax).
    """
    want = env.get("CUDA_VISIBLE_DEVICES")
    if want is None:
        return
    torch = sys.modules.get("torch")
    have = os.environ.get("CUDA_VISIBLE_DEVICES")
    if torch is not None and torch.cuda.is_initialized() and have != want:
        raise RuntimeError(
            f"CUDA is already initialised in this worker with "
            f"CUDA_VISIBLE_DEVICES={have!r}; it cannot be bound to {want!r}"
        )
    os.environ["CUDA_VISIBLE_DEVICES"] = want
    if not want:
        return
    if torch is not None:
        _set_leased_device(torch)
    elif not any(isinstance(f, _AfterTorchImport) for f in sys.meta_path):
        sys.meta_path.insert(0, _AfterTorchImport(_set_leased_device))


def _set_leased_device(torch) -> None:
    if torch.cuda.is_available():
        torch.cuda.set_device(0)
    else:
        logger.warning(
            "leased GPU(s) %s, but torch finds no CUDA device",
            os.environ.get("CUDA_VISIBLE_DEVICES"),
        )


class _AfterTorchImport:
    """A ``sys.meta_path`` finder that runs ``fn(torch)`` once the first
    ``import torch`` has executed, then leaves ``sys.meta_path``."""

    def __init__(self, fn):
        self._fn = fn

    def find_spec(self, name, path=None, target=None):
        if name != "torch":
            return None
        sys.meta_path.remove(self)
        import importlib.util

        spec = importlib.util.find_spec("torch")
        if spec is None or spec.loader is None:
            return spec
        exec_module, fn = spec.loader.exec_module, self._fn

        def exec_then_bind(module):
            exec_module(module)
            fn(module)

        spec.loader.exec_module = exec_then_bind
        return spec


def main():
    logging.basicConfig(
        level=logging.INFO, format="[worker %(process)d] %(levelname)s %(message)s"
    )
    worker_id = WorkerID.from_hex(os.environ["RT_WORKER_ID"])
    raylet_addr = os.environ["RT_RAYLET_ADDR"]
    gcs_addr = os.environ["RT_GCS_ADDR"]
    node_id = os.environ["RT_NODE_ID"]
    store_path = os.environ["RT_STORE_PATH"]

    # partition plane: a worker shares its node's logical endpoint — a
    # node partition cuts the workers' links too (common/faults.py)
    from ray_tpu_torch.common import faults as _faults

    _faults.set_local_endpoint(node_id)

    rt = Runtime(
        gcs_address=gcs_addr,
        node_id=node_id,
        raylet_address=raylet_addr,
        store_path=store_path,
        mode="worker",
        worker_id=worker_id,
    )
    set_runtime(rt)
    from ray_tpu_torch.core import log_streaming

    log_streaming.install_worker_tee(rt)
    server = WorkerServer(rt)
    rt._worker_server = server

    async def boot():
        await server.start()
        raylet_conn = await rpc.connect(
            raylet_addr, server._handle, name="worker->raylet"
        )
        await raylet_conn.call(
            "worker_ready",
            {"worker_id": worker_id.binary(), "address": server.server.address},
        )
        return raylet_conn

    rt.connect()
    if os.environ.get("RT_PROFILE_DIR"):
        # profiled runs: SIGTERM (raylet teardown) must still dump
        import signal
        from ray_tpu_torch.util.profiling import dump_profile as _dump

        def _term(_sig, _frm):
            _dump()
            os._exit(0)

        signal.signal(signal.SIGTERM, _term)
    raylet_conn = asyncio.run_coroutine_threadsafe(boot(), rt._loop).result(30)

    # Block the main thread forever; exit when the raylet connection drops
    # (our parent died) — a worker must never outlive its raylet.
    try:
        while not raylet_conn.closed and not rt.raylet.closed:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    from ray_tpu_torch.util.profiling import dump_profile

    dump_profile()
    os._exit(0)


if __name__ == "__main__":
    main()
