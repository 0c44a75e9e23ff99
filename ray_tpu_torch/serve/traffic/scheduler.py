"""SLO-aware request scheduler: the serve-routing twin of the batched
task plane's per-tick accumulator (core/rpc.py `_send_soon` /
core/runtime.py `_submit_to_loop`).

Requests submitted within one event-loop tick accumulate into a
deadline-ordered queue and dispatch together in ONE flush callback —
so a burst of proxy requests rides the rpc layer's per-tick BATCH
frame coalescing to the replicas (every `.remote()` issued inside the
flush lands in the same tick, hence the same wire frame per
connection), and the flush can order by deadline before anything
commits to a replica.  Latency-neutral at depth 1 by the same
construction as the task plane: the flush runs via ``loop.call_soon``
before the loop can sleep, never on a timer.

Differences from the pow-2 router (handle.py) this sits in front of:

- **central queue, full knowledge**: the scheduler owns per-replica
  in-flight counts for every request IT dispatched, picks the least
  loaded replica, and holds requests past ``max_ongoing_requests``
  per replica in a bounded queue instead of piling them onto the
  replica's mailbox (the Podracer central-batcher shape).
- **EDF order**: dispatch is earliest-deadline-first, so a tight-SLO
  request admitted behind a lax one overtakes it at the queue.
- **deadline expiry**: a request whose deadline passes while queued is
  shed (fast 503) rather than dispatched — the replica never spends
  compute on a response the client already gave up on.
- **bounded everything**: admission (admission.py) refuses requests
  past the depth cap or predicted-delay budget, which is what honors
  the transport's `send_backlog` discipline at this layer — load is
  shed at the door instead of buffered without bound anywhere below.

Backpressure audit (RT110/RT111): the scheduler never enqueues onto
``Connection.call_soon`` itself — dispatch rides ``.remote()``, whose
actor pump polices ``send_backlog`` (the baselined runtime.py site) —
and its own queue is bounded by admission, so no unbounded buffering
is introduced above the transport either.
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
import logging
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.serve.traffic.admission import AdmissionController
from ray_tpu_torch.serve.traffic.config import (
    DEADLINE_KWARG,
    RequestShedError,
    TrafficConfig,
)

logger = logging.getLogger(__name__)

#: replica snapshot staleness bound (mirrors handle.ROUTE_REFRESH_S)
_SNAPSHOT_REFRESH_S = 1.0


class _QueuedRequest:
    __slots__ = (
        "deadline", "seq", "method", "args", "kwargs", "future",
        "enqueue_t",
    )

    def __init__(self, deadline, seq, method, args, kwargs, future,
                 enqueue_t):
        self.deadline = deadline
        self.seq = seq
        self.method = method
        self.args = args
        self.kwargs = kwargs
        self.future = future
        self.enqueue_t = enqueue_t

    def __lt__(self, other):  # heapq ordering: EDF, FIFO within a tie
        return (self.deadline, self.seq) < (other.deadline, other.seq)


class RequestScheduler:
    """Per-deployment, per-process scheduler.  Loop-only: every method
    except the stats snapshot must run on the event loop that created
    it (the proxy actor's io loop, or a composing replica's)."""

    def __init__(self, router, controller, app: str, deployment: str,
                 config: TrafficConfig):
        self._loop = asyncio.get_running_loop()
        self._router = router  # handle.Router: replica list + refresh
        self._controller = controller
        self._app = app
        self._deployment = deployment
        self.config = config
        self.admission = AdmissionController(config, deployment)
        self._heap: List[_QueuedRequest] = []
        self._seq = itertools.count()
        # controller-side stats key: several routing processes report
        # the same deployment, and the controller sums across reporters
        # — id(self) would be a per-process heap address that can
        # collide across processes and silently clobber
        self._reporter_id = uuid.uuid4().hex
        # wire dict this scheduler's config was built from; the handle
        # layer compares it against the router's current entry (identity
        # first) and applies redeploy-time policy changes in place
        self._wire_config: Optional[dict] = None
        self._inflight: Dict[Any, int] = {}  # replica -> scheduler-dispatched
        self._flush_scheduled = False
        self._expiry_timer: Optional[asyncio.TimerHandle] = None
        self._refreshing = False
        self._last_snapshot_t = 0.0
        self._last_stats_push = 0.0
        self._last_pushed: dict = {}

    # -- submit (the handle calls this on the loop) ----------------------
    def submit(self, method: str, args, kwargs,
               slo_ms: Optional[float] = None) -> "asyncio.Future":
        """Admit (or shed) one request; returns a future resolving to
        ``(replica, ref)`` at dispatch time.  Raises RequestShedError
        synchronously when admission refuses."""
        self.admission.check()  # raises RequestShedError on refusal
        now = time.monotonic()
        budget_s = (slo_ms if slo_ms is not None
                    else self.config.slo_ms) / 1000.0
        req = _QueuedRequest(
            deadline=now + budget_s,
            seq=next(self._seq),
            method=method,
            args=args,
            kwargs=kwargs,
            future=asyncio.get_running_loop().create_future(),
            enqueue_t=now,
        )
        heapq.heappush(self._heap, req)
        self.admission.on_admit()
        self._schedule_flush()
        return req.future

    # -- per-tick flush --------------------------------------------------
    def _schedule_flush(self) -> None:
        if not self._flush_scheduled:
            # loop-confined despite the sync signature: submit() runs on
            # the loop (get_running_loop above) and _flush rides
            # call_soon on that same loop — rtrace's caller-plane seed
            # for public sync methods over-approximates here
            # rtlint: disable-next=RT301
            self._flush_scheduled = True
            asyncio.get_running_loop().call_soon(self._flush)

    def _flush(self) -> None:
        """Dispatch everything dispatchable, EDF order: shed expired
        requests, fill replica capacity least-loaded-first, leave the
        rest queued for the next capacity release / deadline sweep."""
        # loop-confined; see _schedule_flush
        # rtlint: disable-next=RT301
        self._flush_scheduled = False
        now = time.monotonic()
        replicas = self._replica_snapshot(now)
        max_ongoing = getattr(self._router, "max_ongoing", 100) or 100
        while self._heap:
            req = self._heap[0]
            if req.future.done():  # caller went away (cancelled)
                heapq.heappop(self._heap)
                self.admission.queued -= 1
                continue
            if req.deadline <= now:
                heapq.heappop(self._heap)
                self.admission.on_expire()
                req.future.set_exception(RequestShedError(
                    "deadline expired after "
                    f"{(now - req.enqueue_t) * 1000:.0f}ms in queue",
                    retry_after_s=self.admission.expired_retry_after(),
                    deployment=self._deployment,
                ))
                continue
            replica = self._pick(replicas, max_ongoing)
            if replica is None:
                break  # no capacity: stays queued, EDF order preserved
            heapq.heappop(self._heap)
            self._dispatch(req, replica, now)
        self._arm_expiry_timer(now)
        self._maybe_push_stats(now)

    def _pick(self, replicas: list, max_ongoing: int):
        """Least-loaded replica with a free slot (central-batcher pick:
        the scheduler knows every in-flight it created, so it beats
        pow-2 sampling at equalizing load under fan-in)."""
        best = None
        best_n = max_ongoing
        for r in replicas:
            n = self._inflight.get(r, 0)
            if n < best_n:
                best, best_n = r, n
        return best

    def _dispatch(self, req: _QueuedRequest, replica, now: float) -> None:
        kwargs = dict(req.kwargs)
        kwargs[DEADLINE_KWARG] = req.deadline - now  # remaining budget
        try:
            ref = replica.handle_request.remote(
                req.method, req.args, kwargs
            )
        except Exception as e:  # noqa: BLE001 — surfaced to the caller
            self.admission.queued -= 1
            if not req.future.done():
                req.future.set_exception(e)
            return
        self._inflight[replica] = self._inflight.get(replica, 0) + 1
        self._router.note_dispatch(replica)  # pow-2 load signal parity
        self.admission.on_dispatch()
        if not req.future.done():
            req.future.set_result((replica, ref))
        # completion waiter: releases the slot + feeds the service-rate
        # EWMA + re-flushes (the continuous-batching admit edge) without
        # materializing the value in this process
        asyncio.get_running_loop().create_task(
            self._await_completion(replica, ref)
        )

    async def _await_completion(self, replica, ref) -> None:
        from ray_tpu_torch.core.runtime import get_runtime

        rt = get_runtime()
        try:
            if asyncio.get_running_loop() is rt._loop:
                await rt.await_ref_completion(ref)
            else:
                # scheduler on a foreign loop (driver asyncio.run): the
                # runtime's completion futures are bound to its io loop,
                # so bridge through the thread-safe future
                await asyncio.wrap_future(asyncio.run_coroutine_threadsafe(
                    rt.await_ref_completion(ref), rt._loop
                ))
        except Exception:
            pass  # errored completion still frees the slot
        n = self._inflight.get(replica, 0)
        if n <= 1:
            self._inflight.pop(replica, None)
        else:
            self._inflight[replica] = n - 1
        self.admission.on_complete()
        if self._heap:
            self._schedule_flush()

    # -- replica snapshot (never blocks the loop) ------------------------
    def _replica_snapshot(self, now: float) -> list:
        with self._router._lock:
            replicas = list(self._router._replicas)
        if not replicas or now - self._last_snapshot_t > _SNAPSHOT_REFRESH_S:
            self._last_snapshot_t = now
            if not self._refreshing:
                self._refreshing = True
                loop = asyncio.get_running_loop()

                def _refresh():
                    try:
                        self._router._refresh(force=not replicas)
                    except Exception:
                        logger.debug("route refresh failed", exc_info=True)

                fut = loop.run_in_executor(None, _refresh)

                def _done(_f):
                    self._refreshing = False
                    if self._heap:
                        self._schedule_flush()

                fut.add_done_callback(_done)
        return replicas

    def drop_replica(self, replica) -> None:
        """Replica died: forget its slots (failover redispatch is the
        response's job; the scheduler only frees capacity)."""
        self._inflight.pop(replica, None)
        if self._heap:
            self._schedule_flush()

    def drop_replica_threadsafe(self, replica) -> None:
        """Off-loop twin (the router's failover path runs on driver /
        executor threads)."""
        try:
            self._loop.call_soon_threadsafe(self.drop_replica, replica)
        except RuntimeError:
            pass  # loop closing

    # -- deadline sweep --------------------------------------------------
    def _arm_expiry_timer(self, now: float) -> None:
        if self._expiry_timer is not None:
            self._expiry_timer.cancel()
            self._expiry_timer = None
        if not self._heap:
            return
        delay = max(0.001, self._heap[0].deadline - now)
        self._expiry_timer = asyncio.get_running_loop().call_later(
            delay, self._expiry_sweep
        )

    def _expiry_sweep(self) -> None:
        self._expiry_timer = None
        self._schedule_flush()

    # -- autoscaling signal ----------------------------------------------
    def _maybe_push_stats(self, now: float) -> None:
        """Throttled fire-and-forget depth/rate report to the
        controller — the queue-driven autoscaling signal.  Rides a
        plain actor call on the batched task plane; losing one report
        is harmless (the next flush resends)."""
        if self._controller is None:
            return
        if now - self._last_stats_push < self.config.stats_push_interval_s:
            return
        snap = self.admission.snapshot()
        if snap == self._last_pushed and snap["queued"] == 0:
            return  # idle steady state: nothing to say
        self._last_stats_push = now
        self._last_pushed = snap
        try:
            # telemetry push, audited fire-and-forget: the reply is
            # nothing, errors only mean a controller restart (the next
            # push re-reports), and awaiting would serialize the flush
            # on a controller round trip
            # rtlint: disable-next=RT105
            self._controller.report_traffic_stats.remote(
                self._app, self._deployment, self._reporter_id, snap
            )
        except Exception:
            logger.debug("traffic stats push failed", exc_info=True)

    def stats(self) -> dict:
        """Thread-safe-enough snapshot for benches/tests."""
        out = self.admission.snapshot()
        out["scheduler_inflight"] = sum(self._inflight.values())
        return out
