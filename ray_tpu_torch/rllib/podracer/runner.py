"""PodracerRunner: free-running vectorized env fleet + central learner
(port of ``ray_tpu/rllib/podracer/runner.py``).

The Podracer/Sebulba shape (arXiv 2104.06272) on this runtime's three
perf planes:

- **task plane** — every runner has exactly one in-flight
  ``sample_podracer`` actor call (spec-skeleton submit, per-tick frame
  coalescing); the driver relaunches it the moment a fragment lands, so
  runners never idle on the driver and there is no per-step coroutine.
- **data plane** — the fragment payload is a single shm put inside the
  runner (vectored write / inline slab); the driver sees only
  ``(meta, ref)`` and forwards the ref to the learner, whose arg-unpack
  resolves it over the direct-shm get path.  Zero payload bytes through
  the driver.
- **collective plane** — weight fan-out is one ``col.broadcast_tree``
  over a standing group (learner = rank 0, runner i = rank i+1), with
  opt-in ``wire_dtype="int8"`` (~4x fewer wire bytes).  Runners join a
  fan-out generation at their next fragment boundary, so the fleet
  keeps sampling while the push propagates.

The learner actor leases what its learner's device needs: one card on
``"cuda"`` (``PodracerConfig.learner_device``, the default), one CPU
otherwise; a node without a card refuses a card learner where the runner
is made, before any process starts.  The env runners stay on the CPU.

Failure model: a dead runner is replaced (fresh actor, decorrelated
seed, collective group re-formed with the replacement under the dead
rank) without the learner ever observing the death — its in-flight
fragments are simply lost.  A SUSPECT runner keeps sampling but its
fragments are deprioritized in the learner queue.  The learner is the
only stateful member and is drain-checkpointable.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.common.config import cfg
from ray_tpu_torch.rllib.podracer.learner import PodracerLearnerActor


@dataclasses.dataclass
class PodracerConfig:
    rollout_fragment_length: int = 32
    # fragments stacked (along the env axis) into one training batch
    batch_fragments: int = 2
    # staleness bound K: a fragment sampled > K learner updates ago
    # never trains (dropped at ingest or batch-assembly time)
    max_policy_lag: int = 4
    # learner updates between weight fan-outs (1 = push every update)
    weight_sync_period: int = 1
    # None/"fp32" = exact; "bf16"/"int8" = block-quantized fan-out
    weight_wire_dtype: Optional[str] = None
    # route fan-out through the collective plane.  False pushes the
    # learner's get_weights ref to each runner instead (no barrier, the
    # learner never blocks; per-caller ordering lands it before the
    # runner's next fragment) — wire_dtype is a collective-path feature
    collective_fanout: bool = True
    # cap on forwarded-but-unconsumed fragments before runners pause
    # (free-running sampling that the learner will only drop wastes the
    # very cores the learner needs).  None = queue_factor * batch size
    max_inflight_fragments: Optional[int] = None
    epsilon: Optional[float] = None  # e-greedy knob for DQN-family
    replace_dead_runners: bool = True
    # None = cfg.podracer_progress_timeout_s
    progress_timeout_s: Optional[float] = None
    # the device ``learner_factory`` builds its learner on: "cuda" leases
    # the learner actor a card (the AlgorithmConfig default), "cpu" a CPU
    learner_device: str = "cuda"


def check_learner_card(device) -> None:
    """Refuse, where the run is made, a learner on ``"cuda"`` on a node
    with no card (the lease could never be granted)."""
    from ray_tpu_torch.rllib.learner_group import check_learner_cards

    check_learner_cards(1, device, what="a podracer learner")


def _learner_lease(device) -> dict:
    import torch

    if torch.device(device).type == "cuda":
        return {"num_cpus": 1, "num_gpus": 1}
    return {"num_cpus": 1}


class PodracerRunner:
    """Driver-side orchestrator.  Owns the learner actor and drives the
    ``EnvRunnerGroup``'s actors as a free-running fleet."""

    def __init__(
        self,
        env_runner_group,
        learner_factory: Callable[[], Any],
        batch_from_fragments: Callable[[List[dict]], Dict[str, np.ndarray]],
        config: Optional[PodracerConfig] = None,
        *,
        train: bool = True,
        keep_fragment_refs: bool = False,
    ):
        import uuid

        self.config = config or PodracerConfig()
        check_learner_card(self.config.learner_device)
        self.group = env_runner_group
        self.learner = PodracerLearnerActor.options(
            **_learner_lease(self.config.learner_device)
        ).remote(
            learner_factory,
            batch_from_fragments,
            self.config.batch_fragments,
            self.config.max_policy_lag,
            train,
        )
        self._train = train
        self._keep_refs = keep_fragment_refs
        self._inflight_cap = (
            int(self.config.max_inflight_fragments)
            if self.config.max_inflight_fragments is not None
            else cfg.podracer_queue_factor * self.config.batch_fragments
        )
        self.fragment_log: List[tuple] = []  # (idx, meta, ref) if kept
        self._incarnation = [0] * len(self.group.runners)
        # ref bookkeeping: sample meta-ref -> runner idx; ingest ref ->
        # frag ref (kept alive until the learner consumed it)
        self._sample_refs: Dict[Any, int] = {}
        self._ingest_refs: Dict[Any, Any] = {}
        self._bcast: Optional[dict] = None
        # fan-out trigger state: versions, NOT acked updates.  The
        # learner can train ahead of what the driver has acked (drain
        # consumes acks silently; stale-dropped ingests train nothing
        # but still advance nothing) — keying the push off acked update
        # counts can deadlock the fleet at lag > K with no push pending
        self._learner_version = 0
        self._pushed_version = 0
        self._last_bcast_ms: Optional[float] = None
        self._replaced_runners = 0
        self._fragments_lost = 0
        self._suspect: frozenset = frozenset()
        self._suspect_at = float("-inf")
        self._node_of: Dict[int, Optional[str]] = {}
        self._col_group: Optional[str] = None
        if self.config.collective_fanout:
            self._col_group = f"podracer-{uuid.uuid4().hex[:8]}"
            self._create_group()
        # initial weight push: every runner starts bit-identical to the
        # learner (put path — runners are idle, no fragment boundary to
        # piggyback a collective join on yet)
        self._put_sync_all()
        self._refresh_node_map()

    # -- group / fleet plumbing -----------------------------------------
    def _members(self):
        return [self.learner] + list(self.group.runners)

    def _create_group(self):
        from ray_tpu_torch.util import collective as col

        col.create_collective_group(
            self._members(), group_name=self._col_group
        )

    def _put_sync_all(self, indices: Optional[List[int]] = None):
        """Fallback/initial weight sync: one put, N borrowers."""
        w, v = ray_tpu_torch.get(
            [self.learner.get_weights.remote(),
             self.learner.stats.remote()],
        )
        ref = ray_tpu_torch.put(w)
        runners = self.group.runners
        idxs = range(len(runners)) if indices is None else indices
        ray_tpu_torch.get([
            runners[i].set_weights_versioned.remote(
                ref, v["policy_version"]
            )
            for i in idxs
        ])
        self._learner_version = max(
            self._learner_version, int(v["policy_version"])
        )
        if indices is None:
            self._pushed_version = self._learner_version

    def _refresh_node_map(self):
        """actor -> node mapping for the suspect-deprioritization path."""
        from ray_tpu_torch.core.runtime import get_runtime

        try:
            rt = get_runtime()
            rows = rt._run(rt.gcs.call("list_actors", {}), timeout=10.0)
            by_id = {r["actor_id"]: r.get("node_id") for r in rows}
            for i, r in enumerate(self.group.runners):
                self._node_of[i] = by_id.get(r._actor_id.hex())
        except Exception:
            pass  # placement metadata is advisory

    def _suspect_nodes(self) -> frozenset:
        now = time.monotonic()
        if now - self._suspect_at >= cfg.collective_suspect_refresh_s:
            from ray_tpu_torch.core.runtime import get_runtime

            try:
                rt = get_runtime()
                rows = rt._run(rt.gcs.call("node_health", {}), timeout=5.0)
                self._suspect = frozenset(
                    nid for nid, r in rows.items() if r.get("suspect")
                )
            except Exception:
                pass  # keep the stale view; health is advisory here
            self._suspect_at = now
        return self._suspect

    # -- sampling --------------------------------------------------------
    def _launch_sample(self, idx: int):
        c = self.config
        ref = self.group.runners[idx].sample_podracer.remote(
            c.rollout_fragment_length, c.epsilon
        )
        self._sample_refs[ref] = idx

    def _launch_all_idle(self):
        busy = set(self._sample_refs.values())
        if self._bcast is not None:
            busy |= self._bcast["pending"]
        for i in range(len(self.group.runners)):
            if i not in busy:
                self._launch_sample(i)

    # -- weight fan-out --------------------------------------------------
    def _initiate_broadcast(self):
        """Start a fan-out generation: the learner (root) enters the
        broadcast now; each runner joins at its next fragment boundary.
        The fleet never stops sampling."""
        c = self.config
        root_ref = self.learner.serve_weight_broadcast.remote(
            self._col_group, 0, c.weight_wire_dtype
        )
        self._bcast = {
            "root_ref": root_ref,
            "member_refs": {},     # ref -> runner idx
            "pending": set(),      # runner idx joined, ref in flight
            "waiting": set(range(len(self.group.runners))),
            "t0": time.monotonic(),
            "failed": False,
        }
        # the root serves its version AT EXECUTION (>= this), so this
        # marker is conservative — never claims a push it didn't make
        self._pushed_version = self._learner_version
        # a parked (backpressured) runner has no in-flight fragment and
        # so no upcoming boundary — it is AT one; join it immediately or
        # the generation never completes
        sampling = set(self._sample_refs.values())
        for idx in list(self._bcast["waiting"]):
            if idx not in sampling:
                self._join_broadcast(idx)

    def _join_broadcast(self, idx: int):
        b = self._bcast
        c = self.config
        ref = self.group.runners[idx].join_weight_broadcast.remote(
            self._col_group, 0, c.weight_wire_dtype
        )
        b["member_refs"][ref] = idx
        b["waiting"].discard(idx)
        b["pending"].add(idx)

    def _broadcast_refs(self):
        b = self._bcast
        if b is None:
            return []
        refs = list(b["member_refs"])
        if b["root_ref"] is not None:
            refs.append(b["root_ref"])
        return refs

    def _finish_broadcast_ref(self, ref) -> bool:
        """Returns True when the generation completed (or aborted)."""
        b = self._bcast
        try:
            ray_tpu_torch.get(ref, timeout=1.0)
        except Exception:
            b["failed"] = True
        if ref in b["member_refs"]:
            idx = b["member_refs"].pop(ref)
            b["pending"].discard(idx)
            if not b["failed"] and not self._backpressured():
                self._launch_sample(idx)
        else:
            b["root_ref"] = None
        if b["failed"]:
            self._abort_broadcast()
            return True
        if b["root_ref"] is None and not b["waiting"] and not b["pending"]:
            self._last_bcast_ms = (time.monotonic() - b["t0"]) * 1e3
            self._bcast = None
            if not self._backpressured():
                self._launch_all_idle()
            return True
        return False

    def _abort_broadcast(self):
        """A member died (or an op failed) mid-generation: settle the
        outstanding refs, re-form the group, and restore fleet-wide
        weight consistency over the put path.  The learner actor itself
        is untouched — no learner-step failure."""
        b, self._bcast = self._bcast, None
        for ref in list(b["member_refs"]) + (
            [b["root_ref"]] if b["root_ref"] is not None else []
        ):
            try:
                ray_tpu_torch.get(ref, timeout=60.0)
            except Exception:
                pass
        self._repair_fleet()
        self._put_sync_all()
        self._launch_all_idle()

    # -- failure handling ------------------------------------------------
    def _repair_fleet(self):
        """Replace dead runners and re-form the collective group with
        replacements joining under the dead ranks."""
        dead = []
        for i, r in enumerate(self.group.runners):
            try:
                ray_tpu_torch.get(r.ping.remote(), timeout=60.0)
            except Exception:
                dead.append(i)
        if not dead:
            return
        if not self.config.replace_dead_runners:
            raise RuntimeError(f"env runners {dead} died")
        replaced_ranks = []
        for i in dead:
            self._incarnation[i] += 1
            self.group.replace_runner(i, incarnation=self._incarnation[i])
            self._replaced_runners += 1
            replaced_ranks.append(i + 1)  # learner holds rank 0
            # drop any bookkeeping that still points at the old handle
            self._sample_refs = {
                ref: idx for ref, idx in self._sample_refs.items()
                if idx != i
            }
        if self._col_group is not None:
            from ray_tpu_torch.util import collective as col

            members = self._members()
            ranks = [
                r if r in replaced_ranks else None
                for r in range(len(members))
            ]
            try:
                col.reform_collective_group(
                    len(members), group_name=self._col_group,
                    actors=members, ranks=ranks,
                )
            except Exception:
                # poisoned beyond reform: rebuild from scratch
                try:
                    col.destroy_collective_group(
                        self._col_group, actors=members
                    )
                except Exception:
                    pass
                self._create_group()
        self._put_sync_all(indices=dead)
        self._refresh_node_map()

    def _on_dead_sample(self, idx: int):
        self._fragments_lost += 1
        if self._bcast is not None and (
            idx in self._bcast["waiting"] or idx in self._bcast["pending"]
        ):
            # the generation can never complete; abort repairs the fleet
            self._abort_broadcast()
            return
        self._repair_fleet()
        self._launch_all_idle()

    # -- the loop --------------------------------------------------------
    def run(
        self,
        *,
        min_updates: int = 1,
        min_fragments: int = 0,
        max_seconds: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Pump the fleet until ``min_updates`` learner updates (or, with
        training off, ``min_fragments`` fragments) completed.  Returns
        aggregated control-plane stats; payload bytes never surface
        here."""
        c = self.config
        progress_s = (
            c.progress_timeout_s
            if c.progress_timeout_s is not None
            else cfg.podracer_progress_timeout_s
        )
        deadline = time.monotonic() + (
            max_seconds if max_seconds is not None else progress_s
        )
        out: Dict[str, Any] = {
            "updates": 0, "fragments": 0, "env_steps_sampled": 0,
            "episode_returns": [],
        }
        last_train: Dict[str, Any] = {}
        self._launch_all_idle()
        while (
            out["updates"] < min_updates
            if self._train
            else out["fragments"] < min_fragments
        ):
            # control-plane refs (broadcast legs, ingest acks) come FIRST:
            # on a loaded host a short-fragment fleet keeps a sample ref
            # ready at every wait, and a samples-first ordering starves
            # the learner acks the loop needs to count updates at all
            refs = (
                self._broadcast_refs()
                + list(self._ingest_refs)
                + list(self._sample_refs)
            )
            budget = deadline - time.monotonic()
            if budget <= 0:
                raise TimeoutError(
                    f"podracer made no sufficient progress in "
                    f"{progress_s}s ({out})"
                )
            ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=budget)
            if not ready:
                continue
            # drain EVERY ready ref before re-waiting; handlers mutate
            # the bookkeeping (abort settles broadcast legs, repair drops
            # sample refs), so each ref re-checks membership here
            for ref in ready:
                if ref in self._sample_refs:
                    self._on_sample_ready(ref, out)
                elif ref in self._ingest_refs:
                    self._on_ingest_ready(ref, out, last_train)
                elif self._bcast is not None and (
                    ref in self._bcast["member_refs"]
                    or ref == self._bcast["root_ref"]
                ):
                    self._finish_broadcast_ref(ref)
        out.update(last_train)
        out["replaced_runners"] = self._replaced_runners
        out["fragments_lost"] = self._fragments_lost
        if self._last_bcast_ms is not None:
            out["weight_broadcast_ms"] = self._last_bcast_ms
        return out

    def _on_sample_ready(self, ref, out):
        idx = self._sample_refs.pop(ref)
        try:
            meta, frag_ref = ray_tpu_torch.get(ref, timeout=60.0)
        except Exception:
            # runner died mid-fragment: replace it, learner unaffected
            self._on_dead_sample(idx)
            return
        node = self._node_of.get(idx)
        meta["suspect"] = bool(node and node in self._suspect_nodes())
        meta["runner_index"] = idx
        meta["incarnation"] = self._incarnation[idx]
        ingest_ref = self.learner.ingest.remote(frag_ref, meta)
        # frag_ref stays pinned until the learner consumed it
        self._ingest_refs[ingest_ref] = frag_ref
        if self._keep_refs:
            self.fragment_log.append((idx, dict(meta), frag_ref))
        out["fragments"] += 1
        out["env_steps_sampled"] += int(meta["env_steps"])
        # a pending fan-out generation is joined BEFORE the next sample
        # (per-caller ordering makes the relaunch run under new weights)
        if self._bcast is not None and idx in self._bcast["waiting"]:
            self._join_broadcast(idx)
        elif not self._backpressured():
            self._launch_sample(idx)
        # else: runner parks idle; an ingest completion relaunches it

    def _backpressured(self) -> bool:
        return len(self._ingest_refs) >= self._inflight_cap

    def _on_ingest_ready(self, ref, out, last_train):
        self._ingest_refs.pop(ref)
        try:
            res = ray_tpu_torch.get(ref, timeout=60.0)
        except Exception:
            # the fragment ref failed to resolve (its runner died after
            # handoff): the fragment is lost, the learner is fine
            self._fragments_lost += 1
            return
        finally:
            # a consumed fragment frees queue room: wake parked runners
            if not self._backpressured():
                self._launch_all_idle()
        out["episode_returns"].extend(res["episode_returns"])
        self._learner_version = max(
            self._learner_version, int(res.get("version", 0))
        )
        stats = res["train"]
        if stats is not None:
            out["updates"] += 1
            last_train.update(stats)
        if (
            self._learner_version - self._pushed_version
            >= self.config.weight_sync_period
        ):
            if self._col_group is not None:
                if self._bcast is None:
                    self._initiate_broadcast()
            else:
                self._put_fanout(self._learner_version)

    def _put_fanout(self, version: int):
        """Barrier-free fan-out: each runner resolves the learner's
        ``get_weights`` ref over direct shm — the learner never blocks
        and per-caller ordering lands the push before the runner's next
        relaunch.  The trade vs the collective path: N unicast pulls
        (no tree, no wire quantization), zero generation latency."""
        wref = self.learner.get_weights.remote()
        for r in self.group.runners:
            # dropped ref is safe: a set_weights failure surfaces
            # through that runner's next tracked sample ref
            # rtlint: disable-next=RT105
            r.set_weights_versioned.remote(wref, int(version))
        self._pushed_version = int(version)

    # -- control-plane helpers ------------------------------------------
    def broadcast_weights(
        self, wire_dtype: Optional[str] = None
    ) -> float:
        """Synchronous fan-out (fleet must be idle — no in-flight
        samples); returns elapsed ms.  The bench's fp32-vs-int8 A/B
        row."""
        assert not self._sample_refs and self._bcast is None
        t0 = time.monotonic()
        refs = [
            self.learner.serve_weight_broadcast.remote(
                self._col_group, 0, wire_dtype
            )
        ] + [
            r.join_weight_broadcast.remote(self._col_group, 0, wire_dtype)
            for r in self.group.runners
        ]
        ray_tpu_torch.get(refs, timeout=cfg.collective_op_timeout_s)
        return (time.monotonic() - t0) * 1e3

    def drain_in_flight(self, timeout: float = 120.0):
        """Let in-flight work land without relaunching (pause the
        fleet); used between interleaved bench windows."""
        deadline = time.monotonic() + timeout
        while self._sample_refs or self._ingest_refs or self._bcast:
            refs = (
                self._broadcast_refs() + list(self._ingest_refs)
                + list(self._sample_refs)
            )
            ready, _ = ray_tpu_torch.wait(
                refs, num_returns=1,
                timeout=max(0.1, deadline - time.monotonic()),
            )
            if not ready:
                raise TimeoutError("podracer drain timed out")
            ref = ready[0]
            if ref in self._sample_refs:
                idx = self._sample_refs.pop(ref)
                try:
                    meta, frag_ref = ray_tpu_torch.get(ref, timeout=60.0)
                except Exception:
                    self._fragments_lost += 1
                    continue
                if self._bcast is not None and idx in self._bcast["waiting"]:
                    self._join_broadcast(idx)
            elif ref in self._ingest_refs:
                self._ingest_refs.pop(ref)
                try:
                    ray_tpu_torch.get(ref, timeout=60.0)
                except Exception:
                    self._fragments_lost += 1
            elif self._bcast is not None:
                b = self._bcast
                try:
                    ray_tpu_torch.get(ref, timeout=60.0)
                except Exception:
                    b["failed"] = True
                if ref in b["member_refs"]:
                    b["pending"].discard(b["member_refs"].pop(ref))
                else:
                    b["root_ref"] = None
                if b["failed"]:
                    self._abort_broadcast()
                    # abort relaunches; cancel those for the drain
                    self._sample_refs.clear()
                elif (
                    b["root_ref"] is None and not b["waiting"]
                    and not b["pending"]
                ):
                    self._bcast = None

    def get_weights(self):
        return ray_tpu_torch.get(
            self.learner.get_weights.remote(), timeout=120.0
        )

    def learner_stats(self) -> Dict[str, Any]:
        return ray_tpu_torch.get(self.learner.stats.remote(), timeout=120.0)

    def stop(self):
        self._sample_refs.clear()
        self._ingest_refs.clear()
        self._bcast = None
        if self._col_group is not None:
            from ray_tpu_torch.util import collective as col

            try:
                col.destroy_collective_group(
                    self._col_group, actors=self._members()
                )
            except Exception:
                pass  # a dead member mustn't block teardown
            self._col_group = None
        try:
            ray_tpu_torch.kill(self.learner)
        except Exception:
            pass
