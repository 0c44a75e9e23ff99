"""Deployment handles and the replica router.

Role-equivalent of ray: python/ray/serve/handle.py:711 (DeploymentHandle)
+ serve/_private/replica_scheduler/pow_2_scheduler.py:49.  The router
keeps a cached replica list (refreshed from the controller on a version
poll) and picks per request by power-of-two-choices over its own
in-flight counts — two random replicas, route to the lighter one.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Any, Dict, List, Optional

import ray_tpu_torch

ROUTE_REFRESH_S = 1.0


class Router:
    def __init__(self, controller, app_name: str, deployment_name: str):
        self._controller = controller
        self._app = app_name
        self._deployment = deployment_name
        self._replicas: List[Any] = []
        self._version = -1
        self._inflight: Dict[Any, int] = {}
        self._suspect_ids: set = set()  # actor hexes on suspect nodes
        self._last_refresh = 0.0
        self._lock = threading.Lock()
        # deployment policy, learned on refresh: concurrency cap per
        # replica and the traffic plane's wire config (None = traffic
        # plane inactive, direct dispatch)
        self.max_ongoing: int = 100
        self.traffic: Optional[dict] = None
        # one RequestScheduler per deployment per process, shared by
        # every handle.options() copy (they share this Router)
        self._traffic_scheduler = None

    def _refresh(self, force: bool = False):
        now = time.monotonic()
        if not force and now - self._last_refresh < ROUTE_REFRESH_S:
            return
        self._last_refresh = now
        routes = ray_tpu_torch.get(
            self._controller.get_routes.remote(), timeout=30
        )
        entry = routes["apps"].get(self._app, {}).get(self._deployment)
        if entry is None:
            raise RuntimeError(
                f"deployment {self._deployment!r} not found in app "
                f"{self._app!r}"
            )
        with self._lock:
            self._version = routes["version"]
            self._replicas = entry["replicas"]
            self.max_ongoing = entry.get("max_ongoing", 100)
            self.traffic = entry.get("traffic")
            # health plane: replicas on failure-suspected nodes — the
            # pow-2 pick avoids them while any healthy replica exists
            # (penalty, not removal: a transient stall must not turn
            # into a failover)
            self._suspect_ids = set(entry.get("suspect") or ())
            self._inflight = {
                r: self._inflight.get(r, 0) for r in self._replicas
            }

    def pick(self):
        """Pow-2 choices over local in-flight counts."""
        self._refresh()
        deadline = time.monotonic() + 30
        while True:
            with self._lock:
                replicas = list(self._replicas)
            if replicas:
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"no replicas for {self._deployment!r} after 30s"
                )
            time.sleep(0.1)
            self._refresh(force=True)
        with self._lock:
            # suspect penalty: sample from healthy replicas while any
            # exist; an all-suspect deployment degrades to the plain
            # pow-2 pick (penalized capacity beats no capacity)
            if self._suspect_ids:
                healthy = [
                    r for r in replicas
                    if r._actor_id.hex() not in self._suspect_ids
                ]
                if healthy:
                    replicas = healthy
            if len(replicas) == 1:
                chosen = replicas[0]
            else:
                a, b = random.sample(replicas, 2)
                chosen = (
                    a if self._inflight.get(a, 0) <= self._inflight.get(b, 0)
                    else b
                )
            self._inflight[chosen] = self._inflight.get(chosen, 0) + 1
        return chosen

    def done(self, replica):
        with self._lock:
            if replica in self._inflight:
                self._inflight[replica] = max(
                    0, self._inflight[replica] - 1
                )

    def note_dispatch(self, replica):
        """An external dispatcher (the traffic scheduler) routed a
        request to `replica`: count it in the pow-2 load signal, so
        direct-path picks see scheduler-created load AND so the
        response's _settle() done() call has a matching increment
        (without this, every scheduled completion would erase one
        DIRECT request's in-flight count)."""
        with self._lock:
            self._inflight[replica] = self._inflight.get(replica, 0) + 1

    def drop(self, replica):
        """Replica died mid-call: drop it until the next refresh."""
        with self._lock:
            self._replicas = [r for r in self._replicas if r != replica]
            self._inflight.pop(replica, None)
        self._last_refresh = 0.0
        sched = self._traffic_scheduler
        if sched is not None:
            sched.drop_replica_threadsafe(replica)


class DeploymentResponse:
    """Lazy result of a handle call (ray: serve DeploymentResponse).

    Replica death surfaces at result-fetch time (actor errors are stored
    on the ref, not raised by .remote()), so failover lives HERE: on
    ActorDiedError the router drops the replica and the request is
    re-dispatched to another one.
    """

    def __init__(
        self, router: Router, replica, ref, redispatch, attempts=3,
    ):
        self._router = router
        self._replica = replica
        self._ref = ref  # None = lazy (dispatch deferred off the io loop)
        self._redispatch = redispatch  # () -> (replica, ref)
        self._attempts = attempts
        self._done = False
        self._dispatch_lock = threading.Lock()

    def _ensure_dispatched(self):
        """Blocking first dispatch of a lazy response.  Called from the
        driver thread or an executor thread — NEVER the io loop (the
        router's route refresh blocks on a controller get, and blocking
        a replica's io loop starves the very reply it waits for).
        Locked: concurrent awaiters of one lazy response (gather, or
        await + chain) must not double-execute the request."""
        with self._dispatch_lock:
            if self._ref is None:
                self._replica, self._ref = self._redispatch()

    def result(self, timeout_s: Optional[float] = 60.0):
        from ray_tpu_torch.core.errors import ActorDiedError, GetTimeoutError

        self._ensure_dispatched()
        while True:
            try:
                value = ray_tpu_torch.get(self._ref, timeout=timeout_s)
            except GetTimeoutError:
                # request still occupies the replica: keep its in-flight
                # count so pow-2 doesn't pile more load onto it
                raise
            except ActorDiedError:
                # no _settle() here: drop() erases the dead replica's
                # in-flight entry wholesale, and _done must stay False
                # so the eventual settle releases the RETRY's pick —
                # settling now would leak the new replica's count
                # forever (Router._refresh preserves counts)
                self._router.drop(self._replica)
                self._attempts -= 1
                if self._attempts <= 0:
                    self._settle()
                    raise
                # under _dispatch_lock like _ensure_dispatched: a lazy
                # response can be consumed from a driver thread AND the
                # io loop at once (gather + chain), and two unlocked
                # failovers would both redispatch — the losing rebind's
                # request is orphaned and its in-flight count leaks
                with self._dispatch_lock:
                    self._replica, self._ref = self._redispatch()
                continue
            except Exception:
                self._settle()
                raise
            self._settle()
            return value

    async def result_async(self):
        """Async twin of result() with the same replica-death failover —
        awaits on the io loop instead of blocking a thread (used by the
        HTTP proxy so slow replicas can't exhaust its executor threads).
        Redispatch (which blocks on route refresh) runs in an executor.
        Loop-agnostic: on the runtime's own io loop (proxy/replica
        actors) the await is direct; any other asyncio loop (driver
        code under asyncio.run) bridges via the thread-safe future —
        the runtime's futures are bound to ITS loop and cannot be
        awaited across loops."""
        import asyncio

        from ray_tpu_torch.core.errors import ActorDiedError
        from ray_tpu_torch.core.runtime import get_runtime

        rt = get_runtime()
        on_rt_loop = asyncio.get_running_loop() is rt._loop
        if self._ref is None:
            await asyncio.get_running_loop().run_in_executor(
                None, self._ensure_dispatched
            )
        while True:
            try:
                if on_rt_loop:
                    value = await rt.await_ref(self._ref)
                else:
                    value = await asyncio.wrap_future(
                        rt.as_future(self._ref)
                    )
            except ActorDiedError:
                # mirror of result(): drop() cleans up the dead replica;
                # settling before the redispatch would strand the
                # retry's pick increment (see there)
                self._router.drop(self._replica)
                self._attempts -= 1
                if self._attempts <= 0:
                    self._settle()
                    raise
                loop = asyncio.get_running_loop()

                def _failover():
                    # rebind in the executor thread under _dispatch_lock
                    # (see result()): serializes against a concurrent
                    # sync-path failover or first dispatch
                    with self._dispatch_lock:
                        self._replica, self._ref = self._redispatch()

                await loop.run_in_executor(None, _failover)
                continue
            except Exception:
                self._settle()
                raise
            self._settle()
            return value

    def _settle(self):
        if not self._done:
            self._done = True
            self._router.done(self._replica)

    def _settle_when_resolved(self):
        """Release the upstream replica's in-flight slot only when its
        result actually lands, not at chain time — the pow-2 router's
        load signal must keep counting a still-executing request
        (chaining hands the wait to the downstream task's arg
        resolution, so nobody else will fetch this ref)."""
        if self._done:
            return
        try:
            from ray_tpu_torch.core.runtime import get_runtime

            rt = get_runtime()

            async def waiter():
                try:
                    # completion only — fetching the value would pull a
                    # possibly-huge chained intermediate into THIS
                    # process purely for load accounting
                    await rt.await_ref_completion(self._ref)
                except Exception:
                    pass
                finally:
                    self._settle()

            rt._spawn(waiter())
        except Exception:
            self._settle()  # never leak the in-flight count

    def __await__(self):
        """`await handle.remote(...)` inside an async deployment — the
        composition idiom (reference: DeploymentResponse.__await__)."""
        return self.result_async().__await__()

    @property
    def ref(self):
        self._ensure_dispatched()
        return self._ref


class _ScheduledResponse(DeploymentResponse):
    """DeploymentResponse whose FIRST dispatch rides the traffic
    scheduler: construction enqueued the request (EDF-ordered, bounded,
    shed-on-overload); the submit future resolves to (replica, ref) at
    dispatch time or raises RequestShedError.  Failover after a replica
    death falls back to the direct dispatch closure — the retry is one
    request, not a burst, so it skips the queue."""

    def __init__(self, router: Router, submit_fut, redispatch):
        import concurrent.futures

        super().__init__(router, None, None, redispatch)
        self._submit_fut = submit_fut  # asyncio.Future on the scheduler loop
        # mirror for sync callers (result()/.ref from non-loop threads);
        # the scheduler's expiry sweep guarantees resolution by deadline
        self._mirror: "concurrent.futures.Future" = (
            concurrent.futures.Future()
        )

        def _copy(f):
            if f.cancelled():
                self._mirror.cancel()
                return
            exc = f.exception()
            if exc is not None:
                self._mirror.set_exception(exc)
            else:
                self._mirror.set_result(f.result())

        submit_fut.add_done_callback(_copy)

    def _ensure_dispatched(self):
        with self._dispatch_lock:
            if self._ref is None:
                self._replica, self._ref = self._mirror.result()

    async def result_async(self):
        if self._ref is None:
            # loop-native wait for the scheduler's dispatch: no executor
            # thread parks per queued request, so an overload backlog
            # cannot exhaust the shared pool (the admission queue holds
            # the requests; this coroutine holds ~nothing).  Caller
            # cancellation propagates to the submit future, which the
            # scheduler's flush skips and un-counts.
            replica, ref = await self._submit_fut
            with self._dispatch_lock:
                if self._ref is None:
                    self._replica, self._ref = replica, ref
        return await super().result_async()


class DeploymentResponseGenerator:
    """Streaming handle result, backed by the core streaming-generator
    transport (ObjectRefGenerator), matching ray: serve's
    DeploymentResponseGenerator.  Iteration yields VALUES; replica death
    mid-stream raises (generator state is not reconstructible on another
    replica)."""

    def __init__(self, router: Router, replica, gen, start=None):
        self._router = router
        self._replica = replica
        self._gen = gen  # None = lazy (dispatch deferred off the io loop)
        self._start = start  # () -> (replica, gen)
        self._done = False
        self._settled = False
        self._start_lock = threading.Lock()

    def _ensure_started(self):
        """Blocking first dispatch of a lazy stream (same io-loop
        starvation hazard as DeploymentResponse._ensure_dispatched)."""
        with self._start_lock:
            if self._gen is None:
                self._replica, self._gen = self._start()

    def __iter__(self):
        return self

    def __next__(self):
        self._ensure_started()
        try:
            ref = next(self._gen)
        except StopIteration:
            self._done = True
            self._settle()
            raise
        except BaseException:
            self._settle()
            raise
        try:
            return ray_tpu_torch.get(ref)
        except BaseException:
            self._settle()
            raise

    async def _next_async(self):
        """Loop-native next + value fetch (no parked threads): used by the
        HTTP proxy's streaming path.  Raises StopAsyncIteration at end."""
        from ray_tpu_torch.core.runtime import get_runtime

        if self._gen is None:
            import asyncio

            await asyncio.get_running_loop().run_in_executor(
                None, self._ensure_started
            )
        try:
            ref = await self._gen.__anext__()
        except StopAsyncIteration:
            self._done = True
            self._settle()
            raise
        except BaseException:
            self._settle()
            raise
        try:
            return await get_runtime().await_ref(ref)
        except BaseException:
            self._settle()
            raise

    def cancel(self):
        if not self._done and self._gen is not None:
            try:
                ray_tpu_torch.cancel(self._gen)
            except Exception:
                pass
        self._done = True
        self._settle()

    def _settle(self):
        if not self._settled:
            self._settled = True
            self._router.done(self._replica)

    def __del__(self):
        # abandoned mid-iteration (break without cancel): free the
        # replica's stream state and ongoing-count, or the autoscaling
        # signal counts a phantom in-flight request forever
        try:
            if not self._done:
                self.cancel()
            else:
                self._settle()
        except Exception:
            pass


class DeploymentHandle:
    def __init__(
        self,
        controller,
        app_name: str,
        deployment_name: str,
        method_name: str = "__call__",
        stream: bool = False,
        multiplexed_model_id: str = "",
        slo_ms: Optional[float] = None,
    ):
        self._controller = controller
        self._app = app_name
        self._deployment = deployment_name
        self._method = method_name
        self._stream = stream
        self._model_id = multiplexed_model_id
        self._slo_ms = slo_ms  # per-handle SLO override (traffic plane)
        # proxies set this on their cached handles: args parsed from an
        # HTTP/gRPC body can never contain a DeploymentResponse, so the
        # chained-arg deep scan in remote() (O(payload)) is skipped
        self._args_known_plain = False
        self._router = Router(controller, app_name, deployment_name)

    def options(
        self,
        method_name: Optional[str] = None,
        stream: Optional[bool] = None,
        multiplexed_model_id: Optional[str] = None,
        slo_ms: Optional[float] = None,
    ) -> "DeploymentHandle":
        h = DeploymentHandle(
            self._controller,
            self._app,
            self._deployment,
            method_name if method_name is not None else self._method,
            stream if stream is not None else self._stream,
            multiplexed_model_id
            if multiplexed_model_id is not None else self._model_id,
            slo_ms if slo_ms is not None else self._slo_ms,
        )
        h._router = self._router  # share routing state
        h._args_known_plain = self._args_known_plain
        return h

    @property
    def traffic_config(self) -> Optional[dict]:
        """The deployment's wire-form TrafficConfig, learned from the
        route table (None until the router first refreshes, and for
        deployments without a traffic plane)."""
        return self._router.traffic

    def _scheduler(self):
        """The shared per-deployment RequestScheduler bound to the
        RUNNING loop, or None when the traffic plane is inactive or the
        scheduler belongs to a different loop (fall back to direct
        dispatch rather than cross loops)."""
        import asyncio

        tc_wire = self._router.traffic
        if tc_wire is None:
            return None
        from ray_tpu_torch.serve.traffic import RequestScheduler, TrafficConfig

        loop = asyncio.get_running_loop()
        sched = self._router._traffic_scheduler
        if sched is not None and sched._loop.is_closed():
            # the loop the scheduler was born on is gone (driver code
            # under a finished asyncio.run): rebuild on the current one
            # instead of silently disabling admission control forever —
            # anything still queued there was already dead with its loop
            sched = None
            self._router._traffic_scheduler = None
        if sched is None:
            sched = RequestScheduler(
                self._router, self._controller, self._app,
                self._deployment, TrafficConfig.from_wire(tc_wire),
            )
            sched._wire_config = tc_wire
            self._router._traffic_scheduler = sched
        elif sched._wire_config is not tc_wire:
            # the router refreshed (new wire dict object): if a redeploy
            # changed the policy, apply it to the live scheduler in
            # place (rebuilding would lose the in-flight accounting for
            # requests already dispatched).  The identity guard keeps
            # the per-request cost at one `is`; the deep compare runs
            # once per route refresh.
            if sched._wire_config != tc_wire:
                cfg = TrafficConfig.from_wire(tc_wire)
                sched.config = cfg
                sched.admission.config = cfg
            sched._wire_config = tc_wire
        return sched if sched._loop is loop else None

    @staticmethod
    def _contains_response(v) -> bool:
        """Chained-arg probe: scheduler dispatch must not have to block
        on a nested response's lazy dispatch (loop-deadlock hazard), so
        chained calls keep the direct executor-dispatched path."""
        if isinstance(v, DeploymentResponse):
            return True
        if isinstance(v, (list, tuple)):
            return any(DeploymentHandle._contains_response(x) for x in v)
        if isinstance(v, dict):
            return any(
                DeploymentHandle._contains_response(x) for x in v.values()
            )
        return False

    def remote(self, *args, **kwargs):
        import asyncio

        if self._model_id:
            from ray_tpu_torch.serve.multiplex import MODEL_ID_KWARG

            kwargs = {**kwargs, MODEL_ID_KWARG: self._model_id}

        def materialize_chained():
            # DeploymentResponse args chain by REFERENCE: the downstream
            # replica receives the upstream result without the caller
            # materializing it (reference: passing DeploymentResponses
            # into other handle calls).  Recurses into containers, like
            # the graph-build substitution — a response nested in a list
            # would otherwise hit the serializer raw (its Router holds a
            # threading.Lock).  Runs inside dispatch — off the io loop —
            # because a lazy inner response may need its own blocking
            # first dispatch here.
            def chain(v):
                if isinstance(v, DeploymentResponse):
                    ref = v.ref  # ensures dispatched
                    v._settle_when_resolved()
                    return ref
                if isinstance(v, list):
                    return [chain(x) for x in v]
                if isinstance(v, tuple):
                    return tuple(chain(x) for x in v)
                if isinstance(v, dict):
                    return {k: chain(x) for k, x in v.items()}
                return v

            return (
                tuple(chain(a) for a in args),
                {k: chain(v) for k, v in kwargs.items()},
            )

        try:
            asyncio.get_running_loop()
            on_loop = True
        except RuntimeError:
            on_loop = False

        if self._stream:
            def start():
                a2, k2 = materialize_chained()
                replica = self._router.pick()
                try:
                    gen = replica.handle_request_stream.options(
                        num_returns="streaming"
                    ).remote(self._method, a2, k2)
                except BaseException:
                    self._router.done(replica)  # keep accounting sane
                    raise
                return replica, gen

            if on_loop:
                # a replica composing a streaming call over this handle:
                # first dispatch must not block the loop — defer it
                return DeploymentResponseGenerator(
                    self._router, None, None, start
                )
            replica, gen = start()
            return DeploymentResponseGenerator(
                self._router, replica, gen, start
            )

        def dispatch():
            a2, k2 = materialize_chained()
            replica = self._router.pick()
            ref = replica.handle_request.remote(self._method, a2, k2)
            return replica, ref

        if on_loop:
            # traffic plane: deployments with a TrafficConfig route
            # through the SLO-aware scheduler (admission + EDF + bounded
            # queue) — loop-native, non-blocking, sheds synchronously
            # with RequestShedError.  Chained-response args keep the
            # direct path (their lazy inner dispatch may block).
            if self._args_known_plain or not (
                any(map(self._contains_response, args))
                or any(map(self._contains_response, kwargs.values()))
            ):
                sched = self._scheduler()
                if sched is not None:
                    fut = sched.submit(
                        self._method, args, kwargs, self._slo_ms
                    )
                    return _ScheduledResponse(self._router, fut, dispatch)
            # inside an event loop (a replica composing over this handle,
            # or any async caller): dispatch must not block the loop —
            # defer it; result_async/await runs it on an executor thread
            return DeploymentResponse(self._router, None, None, dispatch)
        replica, ref = dispatch()
        return DeploymentResponse(self._router, replica, ref, dispatch)
