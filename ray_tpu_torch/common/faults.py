"""Deterministic fault injection: named sites + seeded plans + chaos driver.

The runtime's recovery paths (lease breaks, pull retries, GCS restarts,
collective poisoning/re-formation) are only trustworthy if a failure can
be injected *at a named site, on a chosen hit, reproducibly*.  This
module is that plane:

- **Sites** are string-named hooks threaded through the hot paths
  (``rpc.send.frame``, ``rpc.recv.msg``, ``raylet.lease.grant``,
  ``store.put``, ``collective.peer_conn``, ``node.preempt`` — the
  raylet's preemption watcher polls the last one, so a seeded plan
  delivers a spot-termination notice deterministically, with
  ``delay_s`` carrying the announced drain deadline; the full registry
  is in docs/architecture.md).  ``store.put`` fires once per reserve
  attempt whichever sub-path serves it — the data-plane-v2 inline slab
  and the vectored create path hit the same
  ``ShmStore._put_fault_check`` the v1 ``create`` call guarded, so
  seeded put traces survived the rebuild bit-identically (pinned in
  test_zz_dataplane.py).  Each site guards itself with
  ``if faults.ACTIVE is not None:`` — with ``RT_FAULTS`` unset the hook
  is a single module-attribute None check: no allocation, no branch
  taken, pinned by an alloc assertion in test_taskplane_batching.py.

- **FaultPlan** selects when a site fires: exact ``site`` name, an
  optional ``match`` substring against the site's context string, an
  ``nth``-matching-hit window (``nth``/``count``) or a seeded
  probability ``p``.  Decisions consume a per-plan ``random.Random(seed)``
  only on *matching* hits, so the same plan over the same hit sequence
  fires identically — bit-for-bit — across runs.

- **Actions** are interpreted by the site: ``drop`` (message/frame
  vanishes), ``delay`` (re-delivered after ``delay_s``), ``dup``
  (delivered twice), ``error`` (the call fails with an injected
  RpcError / the store raises StoreFullError), ``reset`` (transport
  aborted), ``kill`` (the granted worker is hard-killed).

Activation: programmatic ``install(plans)`` in-process, or the
``RT_FAULTS`` environment variable carrying a JSON list of plan dicts —
the env form is inherited by raylet/worker/GCS subprocesses, so a test
can arm a fault inside a process it never touches directly.  Every
firing is recorded; ``trace()`` is the determinism contract tests
assert on.

``ChaosController`` is the driver-side half for process-level faults a
site hook cannot express (GCS kill/restart, whole-node kill) — it wraps
a ``cluster_utils.Cluster`` and logs every event it applies, so a chaos
schedule is replayable from its log.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

__all__ = [
    "ACTIVE",
    "ChaosController",
    "FaultController",
    "FaultPlan",
    "LINKS_ACTIVE",
    "LOCAL_ENDPOINT",
    "SITES",
    "SITE_COLLECTIVE_P2P",
    "SITE_COLLECTIVE_PEER_CONN",
    "SITE_NODE_PREEMPT",
    "SITE_RAYLET_LEASE_GRANT",
    "SITE_RPC_RECV_MSG",
    "SITE_RPC_SEND_FRAME",
    "SITE_STORE_PUT",
    "clear",
    "cut_link",
    "heal_link",
    "install",
    "link_is_cut",
    "link_log",
    "plans_from_json",
    "plans_to_json",
    "set_local_endpoint",
    "trace",
]

ENV_VAR = "RT_FAULTS"

# The canonical injection-site registry.  Every runtime hit() call
# guards one of these names, the docs/architecture.md site table is
# asserted against this tuple in tests, and rtproto's RT404 flags any
# hit site, plan, or registry entry that drifts from the others.  Add a
# site here WHEN you add its runtime check — a registered-but-unchecked
# name arms plans that never fire.
SITE_RPC_SEND_FRAME = "rpc.send.frame"
SITE_RPC_RECV_MSG = "rpc.recv.msg"
SITE_STORE_PUT = "store.put"
SITE_RAYLET_LEASE_GRANT = "raylet.lease.grant"
SITE_NODE_PREEMPT = "node.preempt"
SITE_COLLECTIVE_PEER_CONN = "collective.peer_conn"
SITE_COLLECTIVE_P2P = "collective.p2p"

SITES = (
    SITE_RPC_SEND_FRAME,
    SITE_RPC_RECV_MSG,
    SITE_STORE_PUT,
    SITE_RAYLET_LEASE_GRANT,
    SITE_NODE_PREEMPT,
    SITE_COLLECTIVE_PEER_CONN,
    SITE_COLLECTIVE_P2P,
)


@dataclass(frozen=True)
class FaultPlan:
    """One deterministic fault: where, when, and what to inject.

    ``site``    exact injection-site name (see the registry in docs).
    ``action``  drop | delay | dup | error | reset | kill — interpreted
                by the site.  Firing is traced at SELECTION time, so
                keep the action matched to what the site implements
                (the registry in docs/architecture.md lists each
                site's supported actions); a selected-but-unsupported
                action is a no-op at the site yet still appears in
                ``trace()``.
    ``match``   optional substring the site's context string must
                contain for the hit to count (e.g. an rpc method name).
    ``nth``     1-based matching-hit number the window opens at.
    ``count``   how many consecutive matching hits fire from ``nth``.
    ``p``       when > 0, replaces the window: each matching hit at or
                past ``nth`` fires with probability ``p`` drawn from the
                plan's own ``random.Random(seed)`` stream.
    ``delay_s`` delay for ``action="delay"``.
    """

    site: str
    action: str = "error"
    match: Optional[str] = None
    nth: int = 1
    count: int = 1
    p: float = 0.0
    seed: int = 0
    delay_s: float = 0.05

    def to_dict(self) -> dict:
        d = {"site": self.site, "action": self.action, "nth": self.nth,
             "count": self.count, "seed": self.seed}
        if self.match is not None:
            d["match"] = self.match
        if self.p:
            d["p"] = self.p
        # any non-default delay_s round-trips: "delay" uses it as the
        # re-delivery lag, "preempt" as the announced drain deadline —
        # dropping it for non-delay actions silently rewrote a chaos
        # plan's deadline through plans_to_json/RT_FAULTS
        if self.action == "delay" or self.delay_s != type(self).delay_s:
            d["delay_s"] = self.delay_s
        return d

    _FIELDS = ("site", "action", "match", "nth", "count", "p", "seed",
               "delay_s")

    @classmethod
    def from_dict(cls, d: dict) -> "FaultPlan":
        unknown = set(d) - set(cls._FIELDS)
        if unknown:
            # a typo'd field (e.g. "mach" for "match") silently widening
            # or disarming a plan makes the chaos test lie — fail loudly,
            # matching the RT_FAULTS malformed-plan contract
            raise ValueError(
                f"FaultPlan has no field(s) {sorted(unknown)}; "
                f"valid fields: {list(cls._FIELDS)}"
            )
        site = d.get("site")
        if site is not None and site not in SITES:
            # the wire path (RT_FAULTS env / scenario JSON) validates
            # against the canonical registry: a typo'd site arms a plan
            # that never fires, which is exactly a chaos test that lies.
            # Direct FaultPlan(...) construction stays free-form so
            # unit tests can use synthetic site names.
            raise ValueError(
                f"unknown fault site {site!r}; registered sites: "
                f"{list(SITES)}"
            )
        return cls(**{k: d[k] for k in cls._FIELDS if k in d})


class _Armed:
    """Mutable per-plan firing state (hit counter + seeded rng)."""

    __slots__ = ("plan", "hits", "rng")

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self.hits = 0
        self.rng = random.Random(plan.seed)


class FaultController:
    """Evaluates every armed plan at each site hit; records firings.

    Thread-safe: hits arrive from io-loop threads and caller threads of
    every runtime in the process.  The lock is only ever taken while a
    controller is installed — the disabled path never reaches here.
    """

    def __init__(self, plans: Sequence[FaultPlan]):
        self._armed: List[_Armed] = [_Armed(p) for p in plans]
        self._trace: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def hit(self, site: str, ctx: str = "") -> Optional[FaultPlan]:
        """Register one hit at ``site``; returns the plan to apply (the
        first armed plan whose selector fires) or None.

        EVERY matching plan counts the hit (and, in ``p`` mode, draws
        from its rng) even when an earlier plan already fired — each
        plan's firing schedule is a pure function of the matching-hit
        sequence, independent of which other plans are armed."""
        fired: Optional[FaultPlan] = None
        with self._lock:
            for a in self._armed:
                plan = a.plan
                if plan.site != site:
                    continue
                if plan.match is not None and plan.match not in ctx:
                    continue
                a.hits += 1
                if plan.p > 0.0:
                    fire = a.hits >= plan.nth and a.rng.random() < plan.p
                else:
                    fire = plan.nth <= a.hits < plan.nth + plan.count
                if fire and fired is None:
                    fired = plan
                    self._trace.append({
                        "site": site,
                        "ctx": ctx,
                        "hit": a.hits,
                        "action": plan.action,
                        "ts": time.monotonic(),
                    })
        return fired

    def trace(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [dict(e) for e in self._trace]


# The one module-level switch every site checks.  None = disabled; the
# site guard is then a single LOAD + is-None test with zero allocations.
ACTIVE: Optional[FaultController] = None


def install(plans: Sequence[FaultPlan]) -> FaultController:
    """Arm ``plans`` in this process (replaces any prior controller;
    counters and trace start fresh)."""
    global ACTIVE
    ACTIVE = FaultController(plans)
    return ACTIVE


def clear() -> None:
    """Disarm fault injection in this process."""
    global ACTIVE
    ACTIVE = None


def trace() -> List[Dict[str, Any]]:
    """Firings recorded by the installed controller ([] when disabled)."""
    return ACTIVE.trace() if ACTIVE is not None else []


def plans_to_json(plans: Sequence[FaultPlan]) -> str:
    return json.dumps([p.to_dict() for p in plans])


def plans_from_json(text: str) -> List[FaultPlan]:
    return [FaultPlan.from_dict(d) for d in json.loads(text)]


def _activate_from_env() -> None:
    text = os.environ.get(ENV_VAR)
    if not text:
        return
    # a malformed plan must fail LOUDLY: chaos silently disabled by a
    # typo'd env var is a test that stops testing anything
    install(plans_from_json(text))


_activate_from_env()


# ---------------------------------------------------------------------------
# Network partitions: a directional link-cut registry
# ---------------------------------------------------------------------------
#
# A partition is NOT a FaultPlan: it is silence, not an error — frames
# between two logical endpoints simply stop arriving, in one direction
# or both, until the link heals.  The registry below is keyed by
# (src_endpoint, dst_endpoint); the rpc layer consults it at the
# ``rpc.link`` site (outbound in Connection._write_frames, inbound in
# Connection._dispatch_msg) whenever both endpoints of a connection are
# known.  Endpoints are logical names: "gcs" for the control plane, the
# node id hex for a raylet and every worker/driver attached to that
# node.  Cuts carry heal-after semantics (a monotonic deadline) so a
# scripted transient partition self-heals bit-reproducibly; every
# cut/heal (including auto-heals) is recorded in ``link_log()`` — the
# replayable half of the determinism contract.

#: (src, dst) -> monotonic heal deadline (math.inf = until heal_link)
_LINKS: Dict[tuple, float] = {}
_LINKS_LOCK = threading.Lock()
_LINK_LOG: List[Dict[str, Any]] = []

#: fast-path flag: when False the rpc.link site is one module-attr
#: load + branch (same zero-alloc discipline as ACTIVE)
LINKS_ACTIVE: bool = False

#: this process's logical endpoint ("gcs", a node id hex, ...); set
#: once by the process entrypoint (gcs/raylet/worker main, or
#: Runtime.connect for drivers).  None = unlabeled: never cut.
LOCAL_ENDPOINT: Optional[str] = None


def set_local_endpoint(name: str, force: bool = False) -> None:
    """Label this process for the link-cut site.  First writer wins
    unless ``force`` — an in-process Raylet/Runtime pair must not
    relabel the process its entrypoint already named."""
    global LOCAL_ENDPOINT
    if LOCAL_ENDPOINT is None or force:
        LOCAL_ENDPOINT = name


def cut_link(src: str, dst: str, duration_s: Optional[float] = None) -> None:
    """Cut the directional link src -> dst: frames from ``src`` to
    ``dst`` are dropped.  ``duration_s`` arms auto-heal after that many
    seconds; None cuts until ``heal_link``."""
    global LINKS_ACTIVE
    deadline = (
        float("inf") if duration_s is None
        else time.monotonic() + duration_s
    )
    with _LINKS_LOCK:
        _LINKS[(src, dst)] = deadline
        _LINK_LOG.append({"event": "cut", "src": src, "dst": dst,
                          "duration_s": duration_s,
                          "ts": time.monotonic()})
        LINKS_ACTIVE = True


def heal_link(src: Optional[str] = None, dst: Optional[str] = None) -> None:
    """Heal cut links: both endpoints named heals EXACTLY that one
    direction (src -> dst; the asymmetric-route scenarios depend on
    healing one leg of a bidirectional cut); one endpoint named heals
    every cut touching it; neither heals all."""
    global LINKS_ACTIVE
    with _LINKS_LOCK:
        for key in list(_LINKS):
            s, d = key
            if src is not None and dst is not None:
                match = (s, d) == (src, dst)
            elif src is not None:
                match = src in (s, d)
            elif dst is not None:
                match = dst in (s, d)
            else:
                match = True
            if match:
                del _LINKS[key]
                _LINK_LOG.append({"event": "heal", "src": s, "dst": d,
                                  "ts": time.monotonic()})
        if not _LINKS:
            LINKS_ACTIVE = False


def link_is_cut(src: Optional[str], dst: Optional[str]) -> bool:
    """True when frames src -> dst are currently dropped.  Auto-heals
    (and logs) cuts whose deadline lapsed — heal-after needs no timer."""
    global LINKS_ACTIVE
    if src is None or dst is None:
        return False
    with _LINKS_LOCK:
        deadline = _LINKS.get((src, dst))
        if deadline is None:
            return False
        if time.monotonic() >= deadline:
            del _LINKS[(src, dst)]
            _LINK_LOG.append({"event": "auto_heal", "src": src, "dst": dst,
                              "ts": time.monotonic()})
            if not _LINKS:
                LINKS_ACTIVE = False
            return False
        return True


def link_log() -> List[Dict[str, Any]]:
    """Ordered cut/heal/auto-heal events applied in this process."""
    with _LINKS_LOCK:
        return [dict(e) for e in _LINK_LOG]


def clear_links() -> None:
    """Drop every cut and the log (test teardown)."""
    global LINKS_ACTIVE
    with _LINKS_LOCK:
        _LINKS.clear()
        _LINK_LOG.clear()
        LINKS_ACTIVE = False


# ---------------------------------------------------------------------------
# ChaosController: driver-side process-level faults
# ---------------------------------------------------------------------------


@dataclass
class _ChaosEvent:
    event: str
    detail: dict = field(default_factory=dict)
    ts: float = 0.0


class ChaosController:
    """Scripted process-level chaos against a ``cluster_utils.Cluster``.

    Site hooks cover in-process faults; killing whole processes (the
    GCS, a raylet and its workers) is driven from here.  Every applied
    event is appended to ``log`` in order, so a chaos schedule is
    reproducible: same seed + same method sequence ⇒ same victims.
    """

    def __init__(self, cluster, seed: int = 0):
        self.cluster = cluster
        self.rng = random.Random(seed)
        self.log: List[dict] = []

    def _record(self, event: str, **detail) -> None:
        self.log.append({"event": event, "detail": detail,
                         "ts": time.monotonic()})

    def record_external(self, event: str, **detail) -> None:
        """Log a storm event applied by an outside driver (e.g. a
        spot-fleet preemption issued through the autoscaler's provider
        rather than through this controller) so the unified
        ``storm_log()`` still covers it."""
        self._record(event, **detail)

    def storm_log(self) -> List[Dict[str, Any]]:
        """The ONE replayable storm record: the controller's own event
        log, the link-cut log, and the fault-injection trace of this
        process, merged and monotonically ordered.

        Before this existed a composed chaos scenario recorded in three
        places with three schemas; attributing an availability dip to
        "the partition, not the lease fault" meant hand-joining them.
        Every entry is normalized to the pinned schema
        ``{"ts", "source", "event", "detail"}`` with ``source`` one of
        ``"chaos"`` (process-level events driven from here), ``"link"``
        (partition cut/heal/auto-heal), ``"fault"`` (site-hook firings —
        NOTE: only firings in THIS process; sites armed via RT_FAULTS in
        raylet/worker subprocesses trace in those processes).  ``ts`` is
        ``time.monotonic()`` of this process; entries sort by it, ties
        keep insertion order (stable sort)."""
        entries: List[Dict[str, Any]] = []
        for e in self.log:
            entries.append({
                "ts": e["ts"],
                "source": "chaos",
                "event": e["event"],
                "detail": dict(e["detail"]),
            })
        for e in link_log():
            detail = {k: v for k, v in e.items()
                      if k not in ("event", "ts")}
            entries.append({
                "ts": e.get("ts", 0.0),
                "source": "link",
                "event": e["event"],
                "detail": detail,
            })
        for e in trace():
            entries.append({
                "ts": e.get("ts", 0.0),
                "source": "fault",
                "event": e["action"],
                "detail": {"site": e["site"], "ctx": e["ctx"],
                           "hit": e["hit"]},
            })
        entries.sort(key=lambda e: e["ts"])
        return entries

    # -- GCS (head) faults ----------------------------------------------
    def kill_gcs(self) -> None:
        """kill -9 the control plane (clients hold ReconnectingConnections
        and must ride the outage)."""
        self.cluster.kill_gcs()
        self._record("gcs_kill")

    def restart_gcs(self, timeout: float = 30.0) -> None:
        """Restart the GCS on the same port/session dir; state restores
        from the WAL + checkpoint and clients re-attach."""
        self.cluster.restart_gcs(timeout=timeout)
        self._record("gcs_restart")

    def gcs_outage(self, down_s: float = 0.5, timeout: float = 30.0) -> None:
        """kill -9, hold the control plane down for ``down_s``, restart."""
        self.kill_gcs()
        time.sleep(down_s)
        self.restart_gcs(timeout=timeout)

    # -- node faults -----------------------------------------------------
    def _pick_node(self, node=None):
        if node is not None:
            return node
        pool = [n for n in self.cluster._nodes
                if n is not self.cluster.head_node]
        pool = pool or list(self.cluster._nodes)
        if not pool:
            raise RuntimeError("no nodes to kill")
        return self.rng.choice(pool)

    def preempt_node(self, node=None, deadline_s: float = 5.0,
                     kill: bool = True, poll_s: float = 0.1):
        """Deliver a spot-preemption notice to a node, then (``kill``)
        hard-kill it once its graceful drain settles or the deadline
        lapses — the full GCE preemption sequence, seeded and replayable
        (``node=None`` picks a seeded-random non-head victim).

        Returns ``(node, drain_state)`` where ``drain_state`` is the
        GCS's final drain verdict ("drained", "failed", "dead", ...)."""
        import asyncio

        from ray_tpu_torch.core import rpc

        node = self._pick_node(node)

        async def drive():
            # one connection for the notice AND the whole status poll —
            # a fresh dial per 0.1 s poll would hammer the GCS's accept
            # path exactly while it is busy driving the drain
            conn = await rpc.connect(self.cluster.address,
                                     name="chaos->gcs")
            try:
                reply = await conn.call("drain_node", {
                    "node_id": node.node_id,
                    "reason": "preemption",
                    "deadline_s": deadline_s,
                })
                accepted = bool(
                    isinstance(reply, dict) and reply.get("accepted")
                )
                state = (
                    reply.get("state") if isinstance(reply, dict) else None
                )
                if not kill:
                    return accepted, state
                # the provider kills at the announced deadline
                # regardless; polling just shortens the wait when the
                # drain finishes early (and records what it achieved)
                end = time.monotonic() + deadline_s + 2.0
                while time.monotonic() < end:
                    st = await conn.call(
                        "get_drain_status", {"node_id": node.node_id}
                    ) or {}
                    state = st.get("state")
                    if state in ("drained", "failed", "dead", "unknown"):
                        break
                    await asyncio.sleep(poll_s)
                return accepted, state
            finally:
                await conn.close()

        accepted, state = asyncio.run(drive())
        self._record("node_preempt", node_id=node.node_id,
                     deadline_s=deadline_s, accepted=accepted)
        if not kill:
            return node, state
        self.cluster.remove_node(node, allow_graceful=False)
        self._record("node_kill", node_id=node.node_id, graceful=False,
                     drain_state=state)
        return node, state

    def kill_node(self, node=None, graceful: bool = False):
        """Kill a raylet (and its workers).  ``node=None`` picks a
        seeded-random victim among the non-head nodes (falling back to
        the head when it is the only node)."""
        node = self._pick_node(node)
        self.cluster.remove_node(node, allow_graceful=graceful)
        self._record("node_kill", node_id=node.node_id, graceful=graceful)
        return node

    # -- network partitions ----------------------------------------------
    def _endpoint_of(self, x) -> str:
        """Resolve a partition side to its logical endpoint: "gcs", a
        ClusterNode, or a node-id hex string."""
        if x == "gcs":
            return "gcs"
        nid = getattr(x, "node_id", None)
        return nid if nid is not None else str(x)

    def _chaos_call(self, address: str, method: str, payload: dict) -> bool:
        """One-shot rpc to a cluster process (best-effort: a process
        already dead just misses the install, which is what a real
        partition would do to it too)."""
        import asyncio

        from ray_tpu_torch.core import rpc

        async def drive():
            conn = await rpc.connect(address, name="chaos->proc",
                                     timeout=5.0)
            try:
                return await conn.call(method, payload, timeout=5.0)
            finally:
                await conn.close()

        try:
            asyncio.run(drive())
            return True
        except Exception:
            return False

    def _broadcast_chaos(self, method: str, payload: dict) -> None:
        """Install a link-cut table change in EVERY cluster process:
        the GCS, each raylet (which fans out to its workers), and this
        process (the driver).  Installing a cut in an uninvolved
        process is harmless — the registry only matches by endpoint."""
        self._chaos_call(self.cluster.address, method, payload)
        for n in list(self.cluster._nodes):
            self._chaos_call(n.address, method, payload)
        # this (driver) process applies the change in-process
        if method == "chaos_partition":
            cut_link(payload["src"], payload["dst"],
                     payload.get("duration_s"))
        else:
            heal_link(payload.get("src"), payload.get("dst"))

    def partition(self, a, b="gcs",
                  duration_s: Optional[float] = None) -> tuple:
        """Cut the network between ``a`` and ``b`` in BOTH directions
        (a, b: ClusterNode, node-id hex, or "gcs").  Frames between the
        two endpoints — raylet<->GCS, worker<->GCS, raylet<->raylet
        transfers, driver<->worker pushes — are silently dropped (real
        partition semantics: silence, not errors) until ``heal()`` or
        the ``duration_s`` auto-heal.  Returns (endpoint_a, endpoint_b).

        A process spawned AFTER the cut does not inherit it (the
        registry is per-process state); partition before spawning, or
        re-issue."""
        ea, eb = self._endpoint_of(a), self._endpoint_of(b)
        for src, dst in ((ea, eb), (eb, ea)):
            self._broadcast_chaos(
                "chaos_partition",
                {"src": src, "dst": dst, "duration_s": duration_s},
            )
        self._record("partition", a=ea, b=eb, duration_s=duration_s)
        return ea, eb

    def cut(self, src, dst, duration_s: Optional[float] = None) -> tuple:
        """Directional half of partition(): only src -> dst frames drop
        (dst still reaches src) — the asymmetric-route failure mode."""
        es, ed = self._endpoint_of(src), self._endpoint_of(dst)
        self._broadcast_chaos(
            "chaos_partition",
            {"src": es, "dst": ed, "duration_s": duration_s},
        )
        self._record("cut", src=es, dst=ed, duration_s=duration_s)
        return es, ed

    def heal(self, a=None, b=None) -> None:
        """Heal partitions: both sides named heals that pair (BOTH
        directions — the inverse of partition()), one side heals every
        cut touching it, none heals everything.  Directional heals of a
        single leg go through ``heal_link`` on the target processes
        directly (the ``cut()`` twin)."""
        ea = self._endpoint_of(a) if a is not None else None
        eb = self._endpoint_of(b) if b is not None else None
        if ea is not None and eb is not None:
            # heal_link with both endpoints is exact-direction: undo
            # the bidirectional partition() install leg by leg
            for src, dst in ((ea, eb), (eb, ea)):
                self._broadcast_chaos("chaos_heal",
                                      {"src": src, "dst": dst})
        else:
            self._broadcast_chaos("chaos_heal", {"src": ea, "dst": eb})
        self._record("heal", a=ea, b=eb)
