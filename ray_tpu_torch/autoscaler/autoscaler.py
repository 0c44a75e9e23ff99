"""The reconcile loop: pending demand -> node launches, idle -> drains.

Role-equivalent of the reference's autoscaler v2 scheduler + reconciler
(ray: python/ray/autoscaler/v2/scheduler.py:624 ResourceDemandScheduler,
instance_manager/reconciler.py:53) in one deliberate pass:

    demand  = pending leases + unplaced PG bundles       (from the GCS)
    supply  = running nodes + launches still registering
    plan    = first-fit-decreasing bin-pack of unmet demand onto the
              cheapest node types that fit (STRICT_PACK bundles must
              land whole on one node — a slice shape)
    action  = launch plan nodes; drain nodes idle > idle_timeout over
              their type's min_workers

GPU framing: a node type is a host shape ({"CPU": 8, "GPU": 1}, and
``GPU-<kind>`` where its cards are of a known kind, accelerators/gpu.py),
so "scale up for this pending one-card lease" means "launch another host
with a card".  Each pass tells the GCS the node types it can launch
(``get_autoscaler_state``'s ``node_types``): a lease that no live node
but one of these types could hold then queues as demand, as in Ray,
instead of being refused as infeasible.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ray_tpu_torch.common.resources import ResourceSet
from ray_tpu_torch.core import rpc

logger = logging.getLogger(__name__)


@dataclass
class NodeTypeConfig:
    name: str
    resources: Dict[str, float]
    min_workers: int = 0
    max_workers: int = 100
    labels: Dict[str, str] = field(default_factory=dict)
    #: relative $/node-second — the launch planner prefers the cheaper
    #: of two types that both fit a demand (spot-fleet economics)
    price: float = 1.0
    #: preemptible capacity: the provider may revoke it with a notice
    #: (soak.spot drives the seeded revocation process); the fleet's
    #: answer to churn is the drain plane + min_workers replacement
    preemptible: bool = False

    def __post_init__(self):
        if any(k == "TPU" or k.startswith("TPU-") for k in self.resources):
            # as the runtime's resource check (core/remote_function.py)
            raise ValueError(
                f"node type {self.name!r}: the PyTorch/CUDA runtime "
                "schedules no TPU resource; give it GPU instead"
            )


@dataclass
class AutoscalerConfig:
    node_types: List[NodeTypeConfig]
    idle_timeout_s: float = 60.0
    interval_s: float = 1.0
    max_launch_batch: int = 8
    # graceful idle-drain budget: the GCS evacuates sole-copy objects
    # (an "idle" node holds no leases/actors but may still hold the only
    # copy of live objects) before the provider terminates the node
    idle_drain_deadline_s: float = 15.0


class Autoscaler:
    """Drives a NodeProvider from GCS demand.  Run via `start()` inside
    an asyncio loop (the monitor process) or step manually with
    `reconcile()` (tests)."""

    def __init__(self, gcs_address: str, provider, config: AutoscalerConfig):
        self.gcs_address = gcs_address
        self.provider = provider
        self.config = config
        self.gcs: Optional[rpc.ReconnectingConnection] = None
        self._idle_since: Dict[str, float] = {}  # node_id_hex -> ts
        # drain-then-terminate in flight: provider_id -> (pn, nids,
        # settle deadline).  Checked once per reconcile pass instead of
        # blocking the single reconcile coroutine for the whole drain.
        self._pending_terminations: Dict[str, tuple] = {}
        self._task: Optional[asyncio.Task] = None
        self._stopped = False

    async def start(self):
        self.gcs = rpc.ReconnectingConnection(
            self.gcs_address, name="autoscaler->gcs"
        )
        self._task = asyncio.get_running_loop().create_task(self._loop())

    async def stop(self):
        self._stopped = True
        if self._task:
            self._task.cancel()
        if self.gcs:
            await self.gcs.close()

    async def _loop(self):
        while not self._stopped:
            try:
                await self.reconcile()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("autoscaler reconcile failed")
            await asyncio.sleep(self.config.interval_s)

    # ---- the pass ------------------------------------------------------

    async def reconcile(self):
        state = await self.gcs.call(
            "get_autoscaler_state",
            {"node_types": [tc.resources for tc in self.config.node_types]},
        )
        demands = self._unmet_demands(state)
        launches = self._plan_launches(demands, state)
        for node_type in launches:
            tc = self._type(node_type)
            # provider CRUD is blocking by contract (a real cloud API
            # polls a queued resource to READY for minutes) — it must
            # never run on the monitor's event loop
            await asyncio.to_thread(
                self.provider.create_node, node_type, tc.resources,
                tc.labels,
            )
        await self._drain_idle(state)
        await self._reap_drained()

    def _type(self, name: str) -> NodeTypeConfig:
        for tc in self.config.node_types:
            if tc.name == name:
                return tc
        raise KeyError(name)

    def _unmet_demands(self, state) -> List[ResourceSet]:
        """Demand that existing capacity cannot absorb.

        PG bundles are gang demand: each unplaced bundle is one unit that
        must fit whole on some node (matches the GCS's per-bundle atomic
        placement).  Pending leases are singles.
        """
        # draining nodes (idle teardown or a preemption notice) are not
        # supply: counting them would suppress the replacement launch
        # that proactive evacuation needs capacity for.  SUSPECT nodes
        # (health plane) DO count: the scheduler merely deprioritizes
        # them, so their queued demand is transient — launching
        # replacement capacity for every load stall would turn each
        # suspicion into a billable scale-up/scale-down flap
        free = [
            ResourceSet(n["resources_available"])
            for n in state["nodes"]
            if n["alive"] and not n.get("draining")
        ]
        # launches still registering count as supply, or every reconcile
        # pass while a node boots would launch another copy
        registered = {n["node_id"] for n in state["nodes"] if n["alive"]}
        for pn in self.provider.non_terminated_nodes():
            if pn.node_id_hex not in registered:
                free.append(ResourceSet(self._type(pn.node_type).resources))
        unmet: List[ResourceSet] = []

        def absorb(demand: ResourceSet) -> bool:
            for i, f in enumerate(free):
                if f.covers(demand):
                    free[i] = f.subtract(demand)
                    return True
            return False

        units: List[ResourceSet] = []
        for pl in state["pending_leases"]:
            units.append(ResourceSet(pl["demand"]))
        for pgb in state["pending_pg_bundles"]:
            units.extend(ResourceSet(b) for b in pgb["bundles"])
        # big first: gang bundles should claim fresh nodes before smalls
        units.sort(key=lambda r: -sum(r.to_dict().values()))
        for d in units:
            if not absorb(d):
                unmet.append(d)
        return unmet

    def _plan_launches(self, unmet: List[ResourceSet], state) -> List[str]:
        """First-fit-decreasing onto the smallest node type that fits."""
        if not unmet:
            return self._min_workers_topup(state)
        counts = self._current_counts(state, exclude_draining=True)
        plan: List[str] = []
        # virtual free pools of nodes we are about to launch
        virtual: List[ResourceSet] = []

        # smallest that fits, and among equal sizes the CHEAPER type —
        # with a discounted preemptible type configured this is the
        # spot-fleet bet: provision cheap churny capacity and let the
        # drain plane + min_workers replacement absorb the revocations
        types_small_first = sorted(
            self.config.node_types,
            key=lambda t: (sum(t.resources.values()), t.price),
        )
        for d in unmet:
            placed = False
            for i, f in enumerate(virtual):
                if f.covers(d):
                    virtual[i] = f.subtract(d)
                    placed = True
                    break
            if placed:
                continue
            for tc in types_small_first:
                full = ResourceSet(tc.resources)
                if not full.covers(d):
                    continue
                if counts.get(tc.name, 0) >= tc.max_workers:
                    continue
                if len(plan) >= self.config.max_launch_batch:
                    break
                plan.append(tc.name)
                counts[tc.name] = counts.get(tc.name, 0) + 1
                virtual.append(full.subtract(d))
                placed = True
                break
            if not placed and not any(
                ResourceSet(t.resources).covers(d)
                for t in self.config.node_types
            ):
                logger.warning(
                    "demand %s fits no configured node type", d.to_dict()
                )
        return plan + self._min_workers_topup(state, counts)

    def _min_workers_topup(self, state, counts=None) -> List[str]:
        if counts is None:
            counts = self._current_counts(state, exclude_draining=True)
        plan = []
        for tc in self.config.node_types:
            have = counts.get(tc.name, 0)
            for _ in range(max(0, tc.min_workers - have)):
                plan.append(tc.name)
                counts[tc.name] = counts.get(tc.name, 0) + 1
        return plan

    def _current_counts(self, state=None,
                        exclude_draining: bool = False) -> Dict[str, int]:
        """Provider-side node counts by type.  ``exclude_draining``
        drops nodes the GCS reports mid-drain — a preemption-noticed
        node is walking dead, and counting it would suppress the
        replacement launch until AFTER the kill (a full blackout of
        provisioning latency instead of an overlap).  Idle drains never
        flap under this: they only start while counts exceed
        min_workers, so the excluded victim still leaves >= min."""
        draining = set()
        if exclude_draining and state is not None:
            draining = {
                n["node_id"] for n in state["nodes"]
                if n["alive"] and n.get("draining")
            }
        counts: Dict[str, int] = {}
        for pn in self.provider.non_terminated_nodes():
            nids = pn.meta.get("node_ids") or [pn.node_id_hex]
            if draining and all(nid in draining for nid in nids):
                continue
            counts[pn.node_type] = counts.get(pn.node_type, 0) + 1
        return counts

    async def _drain_idle(self, state):
        now = time.monotonic()
        idle_ids = set()
        for n in state["nodes"]:
            if not n["alive"]:
                continue
            if n.get("suspect"):
                # a failure-suspected node is unreachable-ish right now:
                # its idle drain would stall on the evacuation pulls and
                # fall back to a hard kill — let the health plane decide
                # its fate first (the idle clock also resets: suspicion
                # usually means the idleness read is stale)
                self._idle_since.pop(n["node_id"], None)
                continue
            if n["idle"]:
                idle_ids.add(n["node_id"])
                self._idle_since.setdefault(n["node_id"], now)
            else:
                self._idle_since.pop(n["node_id"], None)
        # drop tracking for nodes that disappeared
        for nid in list(self._idle_since):
            if nid not in idle_ids:
                self._idle_since.pop(nid)
        counts = self._current_counts(state)
        dead_ids = {
            n["node_id"] for n in state["nodes"] if not n["alive"]
        }
        for pn in self.provider.non_terminated_nodes():
            nids = pn.meta.get("node_ids") or [pn.node_id_hex]
            if len(nids) > 1 and any(nid in dead_ids for nid in nids):
                # a partially-dead slice can never serve its gang
                # resource again: replace it instead of holding it
                # (billed, counted, unschedulable) forever
                logger.warning(
                    "terminating broken slice %s: host(s) dead",
                    pn.provider_id,
                )
                await asyncio.to_thread(self.provider.terminate_node, pn)
                counts[pn.node_type] = counts.get(pn.node_type, 1) - 1
                for nid in nids:
                    self._idle_since.pop(nid, None)
                continue
            # a multi-host provider node (a slice) drains only when
            # EVERY host has been idle past the timeout — a gang resource
            # with one busy host is a busy slice
            sinces = [self._idle_since.get(x) for x in nids]
            if any(
                s is None or now - s < self.config.idle_timeout_s
                for s in sinces
            ):
                continue
            tc = self._type(pn.node_type)
            # nodes queued for termination still show in provider counts
            # until their drain settles — subtract them, or successive
            # passes drain one node per tick straight through min_workers
            pending_same_type = sum(
                1 for (ppn, _n, _d) in self._pending_terminations.values()
                if ppn.node_type == pn.node_type
            )
            if counts.get(pn.node_type, 0) - pending_same_type <= tc.min_workers:
                continue
            if pn.provider_id in self._pending_terminations:
                continue  # drain already in flight
            logger.info(
                "draining idle node %s (%s)", pn.provider_id, pn.node_type
            )
            # deadline-based graceful drain: the GCS evacuates sole-copy
            # objects off the node inside the budget; termination happens
            # on a LATER reconcile pass once every host's drain settles
            # (drained/failed) or the budget lapses — blocking here would
            # stall scale-up for the whole drain (the hard node-death
            # fallback covers whatever the drain did not finish)
            budget = self.config.idle_drain_deadline_s
            for nid in nids:
                try:
                    await self.gcs.call(
                        "drain_node",
                        {"node_id": nid, "reason": "idle",
                         "deadline_s": budget},
                    )
                except Exception:
                    logger.exception("drain_node rpc failed")
            self._pending_terminations[pn.provider_id] = (
                pn, nids, time.monotonic() + budget + 1.0
            )
            counts[pn.node_type] -= 1
            for nid in nids:
                self._idle_since.pop(nid, None)

    async def _reap_drained(self):
        """Terminate drain-then-stop victims whose drain settled (or
        whose settle deadline lapsed).  One non-blocking status check per
        reconcile pass."""
        settled_states = ("drained", "failed", "dead", "none", "unknown")
        for pid, (pn, nids, deadline) in list(
            self._pending_terminations.items()
        ):
            if time.monotonic() < deadline:
                try:
                    states = [
                        (await self.gcs.call(
                            "get_drain_status", {"node_id": nid}
                        ) or {}).get("state")
                        for nid in nids
                    ]
                except Exception:
                    continue  # GCS hiccup: re-check next pass
                if not all(s in settled_states for s in states):
                    continue  # still draining inside the budget
            del self._pending_terminations[pid]
            await asyncio.to_thread(self.provider.terminate_node, pn)


def main():
    """Monitor entrypoint: `python -m ray_tpu_torch.autoscaler.autoscaler
    --gcs HOST:PORT --node-type "name=gpu1;resources=CPU:8,GPU:1" ...`"""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--gcs", required=True)
    ap.add_argument("--session-dir", required=True)
    ap.add_argument("--interval", type=float, default=1.0)
    ap.add_argument("--idle-timeout", type=float, default=60.0)
    ap.add_argument(
        "--node-type", action="append", default=[],
        help='"name=gpu1;resources=CPU:8,GPU:1;min=0;max=4"',
    )
    ap.add_argument(
        "--cluster-config", default=None,
        help="cluster.yaml (ray_tpu_torch up): node types AND provider come "
             "from the file; --node-type is ignored",
    )
    args = ap.parse_args()

    logging.basicConfig(level=logging.INFO,
                        format="[autoscaler] %(levelname)s %(message)s")

    if args.cluster_config:
        from ray_tpu_torch.autoscaler import launcher

        ccfg = launcher.load_cluster_config(args.cluster_config)
        node_types = launcher.node_type_configs(ccfg)
        provider = launcher.build_provider(
            ccfg, args.gcs, args.session_dir
        )
    else:
        node_types = []
        for spec in args.node_type:
            fields = dict(f.split("=", 1) for f in spec.split(";"))
            resources = {
                k: float(v)
                for k, v in (
                    kv.split(":") for kv in fields["resources"].split(",")
                )
            }
            node_types.append(
                NodeTypeConfig(
                    fields["name"],
                    resources,
                    int(fields.get("min", 0)),
                    int(fields.get("max", 100)),
                    price=float(fields.get("price", 1.0)),
                    preemptible=fields.get(
                        "preemptible", "false"
                    ).lower() in ("1", "true", "yes"),
                )
            )

        from ray_tpu_torch.autoscaler.node_provider import LocalSubprocessProvider

        provider = LocalSubprocessProvider(args.gcs, args.session_dir)
    cfg = AutoscalerConfig(
        node_types=node_types,
        idle_timeout_s=args.idle_timeout,
        interval_s=args.interval,
    )

    async def run():
        a = Autoscaler(args.gcs, provider, cfg)
        await a.start()
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
