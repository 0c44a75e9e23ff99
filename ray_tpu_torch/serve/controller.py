"""Serve controller: reconciles deployment specs to replica actors.

Role-equivalent of ray: python/ray/serve/_private/controller.py:86
(ServeController) + deployment_state.py (DeploymentStateManager:2307) +
autoscaling_state.py (get_decision_num_replicas:261).  A detached named
actor: holds app → deployment → replica state; a background reconcile
THREAD creates/kills replicas to match targets, replaces dead ones, and
computes autoscaling decisions from replica ongoing-request counts.
(A thread, not an asyncio task: actor creation and ray_tpu_torch.get are
blocking calls, which must never run on the worker's io loop.)
Handles/proxies poll `get_routes` (versioned) instead of the reference's
long-poll channel — same effect, simpler transport.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List

import ray_tpu_torch
from ray_tpu_torch.serve.replica import ReplicaActor

logger = logging.getLogger(__name__)

CONTROLLER_NAME = "SERVE_CONTROLLER"

#: GCS pubsub channel for route-table version bumps: proxies subscribe
#: and fetch the full table only when the version moves, instead of an
#: unbatched get_routes read per 1 s poll (the bump notify rides the
#: same batched rpc plane as every other GCS push)
ROUTES_CHANNEL = "serve:routes"


class _DeploymentState:
    def __init__(self, app_name: str, deployment):
        self.app_name = app_name
        self.deployment = deployment
        self.replicas: List[Any] = []  # ActorHandles
        # scale-down victims finishing in-flight work: (handle, stop
        # deadline).  Excluded from get_routes, so routers stop picking
        # them; killed once idle or past the drain timeout.
        self.draining: List[tuple] = []
        # queue-depth reports from traffic-plane schedulers:
        # reporter id -> (monotonic timestamp, snapshot dict)
        self.traffic_reports: Dict[Any, tuple] = {}
        self.target = (
            deployment.autoscaling_config.min_replicas
            if deployment.autoscaling_config
            else deployment.num_replicas
        )
        self.last_scale_up = 0.0
        self.last_scale_down = 0.0

    @property
    def name(self) -> str:
        return self.deployment.name

    def traffic_wire(self):
        tc = getattr(self.deployment, "traffic_config", None)
        if tc is None:
            return None
        return tc.to_wire() if hasattr(tc, "to_wire") else dict(tc)

    def drain_timeout_s(self) -> float:
        tc = getattr(self.deployment, "traffic_config", None)
        return getattr(tc, "drain_timeout_s", 30.0) if tc else 30.0


@ray_tpu_torch.remote
class ServeControllerActor:
    def __init__(self):
        self._apps: Dict[str, Dict[str, _DeploymentState]] = {}
        # HTTP route table lives HERE, not in any driver process (the
        # reference keeps route state in the controller too:
        # serve/_private/controller.py) — so a second driver or a driver
        # restart can't clobber routes installed by others.
        self._http_routes: Dict[str, tuple] = {}  # prefix -> (app, deployment)
        # prefixes whose target class carries @serve.ingress (ASGI): the
        # HTTP proxy dispatches those through the ASGI adapter instead of
        # the method-call convention
        self._asgi_prefixes: set = set()
        self._app_roots: Dict[str, str] = {}  # app -> ingress deployment
        self._routes_version = 0
        self._lock = threading.RLock()
        # serializes whole reconcile passes (the loop thread and
        # deploy_application both call _reconcile_once; interleaved passes
        # would double-create replicas)
        self._reconcile_mutex = threading.Lock()
        self._interval = 0.5
        self._stop = threading.Event()
        # nodes with a graceful drain in flight (GCS "nodes" pubsub):
        # replicas on them enter the drain-then-stop flow — replaced and
        # routed around BEFORE the node dies — instead of dying with it
        self._draining_nodes: set = set()
        # failure-SUSPECTED nodes (health plane): replicas there are NOT
        # killed or replaced — they are only penalized in the routers'
        # pow-2 pick via the route table's per-deployment suspect set,
        # so a transient stall costs routing preference, not a failover
        self._suspect_nodes: set = set()
        self._suspect_replicas: Dict[tuple, tuple] = {}  # (app, dep) -> ids
        try:
            from ray_tpu_torch.core.runtime import get_runtime

            get_runtime().subscribe("nodes", self._on_node_event)
            # seed with drains/suspicions already in flight: their events
            # were published before this controller subscribed (controller
            # restart / serve.start during a preemption window)
            for n in get_runtime().nodes():
                if n.get("draining"):
                    self._draining_nodes.add(n["node_id"])
                if n.get("suspect"):
                    self._suspect_nodes.add(n["node_id"])
        except Exception:
            logger.warning("node-event subscribe failed", exc_info=True)
        self._thread = threading.Thread(
            target=self._reconcile_loop, name="serve-reconcile", daemon=True
        )
        self._thread.start()

    def _on_node_event(self, msg: dict):
        """GCS pubsub callback (io loop): track draining and
        failure-suspected nodes."""
        nid = msg.get("node_id")
        if nid is None:
            return
        event = msg.get("event")
        if event == "draining":
            self._draining_nodes.add(nid)
        elif event in ("dead", "alive"):
            self._draining_nodes.discard(nid)
            self._suspect_nodes.discard(nid)
        if event == "suspect":
            self._suspect_nodes.add(nid)
        elif event == "recovered":
            self._suspect_nodes.discard(nid)

    # -- deploy API ------------------------------------------------------
    def deploy_application(
        self, app_name: str, deployments: list, root_name: str = None
    ) -> bool:
        """Deploy/update an app (list of Deployment objects).

        ``root_name`` marks the ingress deployment of a composed graph
        (children are listed before parents, so "first in list" is NOT
        the ingress); defaults to the first deployment for single-node
        apps and config-file deploys."""
        with self._lock:
            self._app_roots[app_name] = (
                root_name if root_name is not None
                else (deployments[0].name if deployments else None)
            )
            states = self._apps.setdefault(app_name, {})
            new_names = {d.name for d in deployments}
            for name in list(states):
                if name not in new_names:
                    self._drain(states.pop(name))
            for d in deployments:
                existing = states.get(d.name)
                if existing is not None:
                    # redeploy: replace spec, restart replicas
                    self._drain(existing)
                states[d.name] = _DeploymentState(app_name, d)
            self._routes_version += 1
        self._reconcile_once()
        self._publish_routes_version()
        return True

    def get_app_root(self, app_name: str):
        with self._lock:
            return self._app_roots.get(app_name)

    def get_replica_actors(self, name: str, app_name: str = "default"):
        """Live replica actor handles for one deployment (draining
        victims excluded) — the target set for a collective weight
        push (serve.weights.push_deployment_weights)."""
        with self._lock:
            states = self._apps.get(app_name, {})
            st = states.get(name)
            if st is None:
                raise KeyError(
                    f"no deployment {name!r} in app {app_name!r} "
                    f"(known: {sorted(states)})"
                )
            return list(st.replicas)

    def delete_application(self, app_name: str) -> bool:
        with self._lock:
            self._app_roots.pop(app_name, None)
            states = self._apps.pop(app_name, {})
            for st in states.values():
                self._drain(st)
            for prefix, (app, _d) in list(self._http_routes.items()):
                if app == app_name:
                    del self._http_routes[prefix]
                    self._asgi_prefixes.discard(prefix)
            self._routes_version += 1
        self._publish_routes_version()
        return True

    def set_route_prefix(
        self, prefix: str, app_name: str, deployment_name: str
    ) -> bool:
        with self._lock:
            self._http_routes[prefix] = (app_name, deployment_name)
            st = self._apps.get(app_name, {}).get(deployment_name)
            if st is not None and getattr(
                st.deployment.func_or_class, "__rt_is_asgi__", False
            ):
                self._asgi_prefixes.add(prefix)
            else:
                self._asgi_prefixes.discard(prefix)
            self._routes_version += 1
        self._publish_routes_version()
        return True

    def remove_route_prefix(self, prefix: str) -> bool:
        with self._lock:
            removed = self._http_routes.pop(prefix, None) is not None
            self._asgi_prefixes.discard(prefix)
            if removed:
                self._routes_version += 1
        if removed:
            self._publish_routes_version()
        return removed

    def _publish_routes_version(self):
        """Push the current route version on the GCS pubsub plane so
        proxies refresh on change instead of polling with a full
        get_routes read every second (the push itself coalesces into
        the per-tick BATCH frames like any other GCS notify)."""
        from ray_tpu_torch.core.runtime import get_runtime

        with self._lock:
            v = self._routes_version
        try:
            get_runtime().publish(ROUTES_CHANNEL, {"version": v})
        except Exception:
            logger.debug("routes version publish failed", exc_info=True)

    def _drain(self, st: _DeploymentState):
        for r in st.replicas:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        st.replicas = []
        # app deleted / redeployed: draining replicas lose their grace
        for r, _deadline in st.draining:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass
        st.draining = []

    # -- reconcile -------------------------------------------------------
    def _reconcile_loop(self):
        while not self._stop.wait(self._interval):
            try:
                self._reconcile_once()
                self._autoscale()
            except Exception:
                logger.exception("reconcile failed")

    def _snapshot(self) -> List[_DeploymentState]:
        with self._lock:
            return [
                st
                for states in self._apps.values()
                for st in states.values()
            ]

    def _is_current(self, st: _DeploymentState) -> bool:
        with self._lock:
            return self._apps.get(st.app_name, {}).get(st.name) is st

    def _check_health(self, replicas: List[Any]) -> List[Any]:
        """Batched health probe: errored replicas are dead; replicas that
        simply haven't answered within the window get the benefit of the
        doubt (busy, not dead) — one hung replica must not stall
        reconciliation for everyone (single reconcile thread)."""
        if not replicas:
            return []
        refs = [r.check_health.remote() for r in replicas]
        ready, _pending = ray_tpu_torch.wait(
            refs, num_returns=len(refs), timeout=10.0, fetch_local=True
        )
        ready_set = set(ready)
        alive = []
        for r, ref in zip(replicas, refs):
            if ref not in ready_set:
                alive.append(r)  # slow, assumed busy
                continue
            try:
                ray_tpu_torch.get(ref, timeout=1)
                alive.append(r)
            except Exception:
                pass  # dead
        return alive

    def _reconcile_once(self):
        with self._reconcile_mutex:
            changed = self._reconcile_locked()
        if changed:
            self._publish_routes_version()

    def _actor_nodes(self) -> Dict[str, str]:
        """actor_id hex -> node_id hex for every live actor (one GCS
        read per reconcile pass, and only while a node is draining)."""
        from ray_tpu_torch.core.runtime import get_runtime

        rt = get_runtime()
        rows = rt._run(rt.gcs.call("list_actors", {}))
        return {
            r["actor_id"]: r["node_id"]
            for r in rows
            if r.get("node_id") and r["state"] == "ALIVE"
        }

    def _reconcile_locked(self) -> bool:
        changed = False
        draining_nodes = set(self._draining_nodes)
        suspect_nodes = set(self._suspect_nodes)
        actor_nodes: Dict[str, str] = (
            self._actor_nodes()
            if (draining_nodes or suspect_nodes
                or self._suspect_replicas) else {}
        )
        for st in self._snapshot():
            alive = self._check_health(st.replicas)
            if draining_nodes:
                # replicas on a draining node: drain-then-stop NOW — they
                # leave the route table (and get replaced below via
                # to_create) while the node is still alive to finish
                # their in-flight requests, instead of dying with it
                evacuating = [
                    r for r in alive
                    if actor_nodes.get(r._actor_id.hex()) in draining_nodes
                ]
                if evacuating:
                    alive = [r for r in alive if r not in evacuating]
                    with self._lock:
                        if self._is_current(st):
                            deadline = (
                                time.monotonic() + st.drain_timeout_s()
                            )
                            for r in evacuating:
                                st.draining.append((r, deadline))
                            logger.info(
                                "deployment %s: %d replica(s) on draining "
                                "node(s) entered drain-then-stop",
                                st.name, len(evacuating),
                            )
            with self._lock:
                if not self._is_current(st):
                    continue  # redeployed/deleted while we probed
                if st.replicas != alive:
                    st.replicas = alive
                    changed = True
                d = st.deployment
                to_create = st.target - len(st.replicas)
                to_remove = len(st.replicas) - st.target
            for _ in range(max(0, to_create)):
                opts = dict(d.ray_actor_options)
                handle = ReplicaActor.options(
                    num_cpus=opts.get("num_cpus", 0.1),
                    # one card a GPU replica (a fractional request gets a
                    # whole card, as the raylet leases them); a TPU
                    # request was refused when the deployment was made
                    num_gpus=opts.get("num_gpus"),
                    resources=opts.get("resources"),
                    max_restarts=0,
                    # this controller owns replica relocation (the
                    # drain-then-stop flow above); the GCS drain plane
                    # must not also checkpoint/restart-migrate them
                    on_drain="ignore",
                ).remote(
                    d.func_or_class, d.init_args, d.init_kwargs, None,
                    st.app_name,
                )
                with self._lock:
                    if self._is_current(st):
                        st.replicas.append(handle)
                        changed = True
                        handle = None
                if handle is not None:
                    # state was drained while we created: don't leak
                    try:
                        ray_tpu_torch.kill(handle)
                    except Exception:
                        pass
            for _ in range(max(0, to_remove)):
                # drain-then-stop: the victim leaves the route table NOW
                # (routers stop picking it on their next refresh) but
                # keeps running until its in-flight requests finish —
                # scale-down must never turn admitted requests into
                # replica-death errors
                with self._lock:
                    victim = (
                        st.replicas.pop()
                        if self._is_current(st) and st.replicas
                        else None
                    )
                    if victim is not None:
                        st.draining.append((
                            victim,
                            time.monotonic() + st.drain_timeout_s(),
                        ))
                if victim is not None:
                    changed = True
            # health plane: replicas hosted on failure-SUSPECTED nodes
            # stay in the route table (nothing is failed over for a
            # suspicion) but are marked so routers penalize them in the
            # pow-2 pick; set changes bump the routes version
            key = (st.app_name, st.name)
            suspect_ids = tuple(sorted(
                r._actor_id.hex()
                for r in st.replicas
                if actor_nodes.get(r._actor_id.hex()) in suspect_nodes
            )) if (suspect_nodes or self._suspect_replicas.get(key)) else ()
            with self._lock:
                if self._is_current(st) and (
                    self._suspect_replicas.get(key, ()) != suspect_ids
                ):
                    if suspect_ids:
                        self._suspect_replicas[key] = suspect_ids
                    else:
                        self._suspect_replicas.pop(key, None)
                    changed = True
            if st.draining:
                # NOT folded into `changed`: a drained victim already
                # left the route table when draining began, so killing
                # it must not bump the version and fan a fleet-wide
                # get_routes re-read out to every proxy
                self._sweep_draining(st)
        if changed:
            with self._lock:
                self._routes_version += 1
        return changed

    def _sweep_draining(self, st: _DeploymentState) -> None:
        """Stop draining replicas that are idle (queue_len 0), dead, or
        past their drain deadline.  Probes are batched like
        _check_health — one busy draining replica must not stall the
        single reconcile thread for everyone; a replica that doesn't
        answer within the window just stays draining until the next
        sweep (or its deadline)."""
        with self._lock:
            draining = list(st.draining)
        if not draining:
            return
        now = time.monotonic()
        refs = [r.queue_len.remote() for r, _ in draining]
        ready, _pending = ray_tpu_torch.wait(
            refs, num_returns=len(refs), timeout=5.0, fetch_local=True
        )
        ready_set = set(ready)
        stopped = []
        for (replica, deadline), ref in zip(draining, refs):
            stop = now >= deadline
            if not stop and ref in ready_set:
                try:
                    stop = ray_tpu_torch.get(ref, timeout=1) == 0
                except Exception:
                    stop = True  # dead already
            if stop:
                try:
                    ray_tpu_torch.kill(replica)
                except Exception:
                    pass
                stopped.append(replica)
        if not stopped:
            return
        with self._lock:
            st.draining = [
                (r, d) for r, d in st.draining if r not in stopped
            ]

    def _queued_depth(self, st: _DeploymentState, now: float) -> float:
        """Sum of queued (admitted, undispatched) requests across the
        traffic-plane schedulers that reported recently.  Stale
        reporters (a proxy that died or went idle) age out so a
        vanished queue cannot pin the deployment scaled up."""
        tc = getattr(st.deployment, "traffic_config", None)
        horizon = 3.0 * getattr(tc, "stats_push_interval_s", 0.5) + 2.0
        total = 0.0
        with self._lock:
            for reporter, (t, snap) in list(st.traffic_reports.items()):
                if now - t > horizon:
                    del st.traffic_reports[reporter]
                    continue
                total += float(snap.get("queued", 0))
        return total

    def _autoscale(self):
        now = time.monotonic()
        for st in self._snapshot():
            asc = st.deployment.autoscaling_config
            if asc is None or not st.replicas:
                continue
            try:
                lens = ray_tpu_torch.get(
                    [r.queue_len.remote() for r in st.replicas], timeout=30
                )
            except Exception:
                continue
            # autoscaling signal = replica-ongoing PLUS scheduler queue
            # depth: under admission control replicas never see more
            # than max_ongoing at once, so the queue — where overload
            # actually accumulates — must drive the scale-up
            total = float(sum(lens)) + self._queued_depth(st, now)
            desired = max(
                asc.min_replicas,
                min(
                    asc.max_replicas,
                    int(-(-total // asc.target_ongoing_requests)),
                ),
            )
            with self._lock:
                if desired > st.target:
                    if now - st.last_scale_up >= asc.upscale_delay_s:
                        st.target = desired
                        st.last_scale_up = now
                elif desired < st.target:
                    if now - st.last_scale_down >= asc.downscale_delay_s:
                        st.target = max(desired, asc.min_replicas)
                        st.last_scale_down = now
                else:
                    st.last_scale_up = now
                    st.last_scale_down = now

    # -- traffic-plane stats ingest --------------------------------------
    def report_traffic_stats(
        self, app_name: str, deployment_name: str, reporter, snapshot: dict
    ) -> bool:
        """Fire-and-forget depth/rate push from a RequestScheduler
        (one per routing process).  Reports are keyed by reporter so
        several proxies sum, not clobber."""
        with self._lock:
            st = self._apps.get(app_name, {}).get(deployment_name)
            if st is None:
                return False
            st.traffic_reports[reporter] = (time.monotonic(), dict(snapshot))
        return True

    # -- discovery (handles / proxies poll this) -------------------------
    def get_routes(self) -> dict:
        with self._lock:
            out = {}
            for app_name, states in self._apps.items():
                out[app_name] = {
                    name: {
                        "replicas": list(st.replicas),
                        "max_ongoing": st.deployment.max_ongoing_requests,
                        "traffic": st.traffic_wire(),
                        # replica actor-id hexes on failure-suspected
                        # nodes: routers penalize, never drop
                        "suspect": list(
                            self._suspect_replicas.get((app_name, name), ())
                        ),
                    }
                    for name, st in states.items()
                }
            return {
                "version": self._routes_version,
                "apps": out,
                "http_routes": dict(self._http_routes),
                "asgi_prefixes": list(self._asgi_prefixes),
            }

    def get_status(self) -> dict:
        with self._lock:
            return {
                app_name: {
                    name: {
                        "target_replicas": st.target,
                        "running_replicas": len(st.replicas),
                        "draining_replicas": len(st.draining),
                    }
                    for name, st in states.items()
                }
                for app_name, states in self._apps.items()
            }

    def ping(self) -> bool:
        return True


def get_or_create_controller():
    """The controller is a detached named actor, one per cluster."""
    handle = ServeControllerActor.options(
        name=CONTROLLER_NAME,
        get_if_exists=True,
        lifetime="detached",
        num_cpus=0.1,
    ).remote()
    return handle
