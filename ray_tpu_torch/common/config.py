"""Central config/flag registry.

Role-equivalent of the reference's RAY_CONFIG registry (ray:
src/ray/common/ray_config_def.h — 218 flags overridable via env vars), done
the Python way: one declarative table, values overridable via ``RT_<NAME>``
environment variables, importable everywhere as ``from ray_tpu_torch.common.config
import cfg``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Callable, Dict

from ray_tpu_torch.common.constants import session_root


def _parse_bool(v: str) -> bool:
    return v.strip().lower() in ("1", "true", "yes", "on")


class _Config:
    _DEFS: Dict[str, tuple[type, Any]] = {}

    def __init__(self):
        self._values: Dict[str, Any] = {}

    @classmethod
    def define(cls, name: str, typ: type, default: Any) -> None:
        cls._DEFS[name] = (typ, default)

    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._DEFS:
            raise AttributeError(f"unknown config flag: {name}")
        if name not in self._values:
            typ, default = self._DEFS[name]
            env = os.environ.get(f"RT_{name.upper()}")
            if env is None:
                self._values[name] = default
            elif typ is bool:
                self._values[name] = _parse_bool(env)
            elif typ in (dict, list):
                self._values[name] = json.loads(env)
            else:
                self._values[name] = typ(env)
        return self._values[name]

    def override(self, name: str, value: Any) -> None:
        if name not in self._DEFS:
            raise AttributeError(f"unknown config flag: {name}")
        self._values[name] = value

    def reset(self) -> None:
        self._values.clear()


D = _Config.define

# --- wire protocol / rpc ---
D("rpc_max_frame_bytes", int, 512 * 1024 * 1024)
# per-tick frame coalescing: messages queued on one connection within a
# single event-loop tick ride one BATCH frame; a burst past this count
# flushes mid-tick so send_backlog policing sees the bytes
D("rpc_batch_max_msgs", int, 128)
# ...and a byte cap on the same accumulator: coalescing must never build
# a frame the peer rejects (rpc_max_frame_bytes), so ticks carrying large
# payloads (object chunks, big inline args) flush in small groups
D("rpc_batch_max_bytes", int, 8 * 1024 * 1024)
# flush window for buffered object-directory GCS notifications
# (add_object_location & co.): non-urgent announces wait up to this long
# (or gcs_notify_flush_max entries) for one batched rpc; any ref export
# or local get-miss flushes immediately (visibility unchanged)
D("gcs_notify_flush_window_s", float, 0.01)
D("gcs_notify_flush_max", int, 64)
D("rpc_connect_timeout_s", float, 30.0)
D("rpc_call_timeout_s", float, 120.0)
D("heartbeat_interval_s", float, 1.0)
D("node_death_timeout_s", float, 10.0)

# --- adaptive failure detection (common/health.py phi-accrual detector;
# reference role: GcsHealthCheckManager) ---
# suspicion level (phi = -log10 P(silence)) at which a node enters
# SUSPECT: deprioritized for new leases / pulls / serve routing, but
# nothing is killed, reformed, or restarted
D("health_phi_suspect", float, 3.0)
# suspicion level that CONFIRMS death (with the wall-clock floor/cap
# below): recovery machinery (fencing, actor restart, reform) fires
D("health_phi_death", float, 8.0)
# rolling inter-heartbeat history window per node
D("health_window", int, 64)
# std-deviation floor as a fraction of the mean interval: keeps a
# metronome-regular history (std ~ 0) from exploding phi on the first
# late beat — the dominant false-positive mode of accrual detectors
D("health_min_std_frac", float, 0.35)
# heartbeats of history required before the adaptive verdict applies
# (below it, the fixed node_death_timeout_s path decides alone)
D("health_min_samples", int, 5)
# wall-clock death FLOOR as a fraction of node_death_timeout_s: phi can
# confirm death no earlier than this much silence (a whole-process GC /
# CPU stall on the GCS host must not mass-kill fast-heartbeat nodes);
# node_death_timeout_s itself remains the hard CAP regardless of phi
D("health_death_floor_frac", float, 0.5)
# how long clients (raylets, drivers, workers) keep re-dialing a dead GCS
# before declaring the cluster lost
D("gcs_reconnect_max_downtime_s", float, 60.0)
# debounce for GCS snapshot flushes (fault-tolerance checkpoint)
# Snapshot compaction cadence.  Durability does NOT ride this: critical
# mutations are WAL-appended before their ack (see CheckpointStore), so a
# longer debounce only lengthens the WAL replayed at restart — while each
# snapshot pickles the full control-plane state, which at high PG/actor
# churn was ~15% of GCS CPU at 50 ms.
D("gcs_checkpoint_debounce_s", float, 0.25)
# how often each process ships its util.metrics registry to the GCS
D("metrics_push_interval_s", float, 5.0)
# node-to-node object transfer: chunk size + pipelined chunks in flight
# (ray analogue: object_manager 64MB chunks / ObjectBufferPool)
D("transfer_chunk_bytes", int, 8 * 1024 * 1024)
D("transfer_inflight_chunks", int, 4)
# timeline ring size per process (api.timeline())
D("timeline_max_events", int, 10_000)

# --- object store ---
D("object_store_bytes", int, 0)  # 0 = auto (30% of /dev/shm free, capped)
D("object_store_auto_cap_bytes", int, 8 * 1024 * 1024 * 1024)
D("inline_object_max_bytes", int, 100 * 1024)  # small results ride the RPC reply
# get() of a shm object this large deserializes zero-copy off the arena
# (pinned, read-only views) instead of copying out (plasma mmap-read role)
D("zerocopy_get_min_bytes", int, 1024 * 1024)
# put-side inline fast path (data plane v2): serialized payloads up to
# this size land in a per-process slab of pre-registered, pre-faulted
# arena slots — one shard-lock publish instead of a create/seal round
# trip.  0 disables the slab (every put rides the create path).
D("put_inline_max_bytes", int, 16 * 1024)
# slots reserved per slab refill batch (one allocator-lock acquisition +
# one touch-ahead pass amortized across the whole batch); the C-side
# per-client ledger caps total reserved slots at rt_store_max_slab_slots
D("put_inline_slab_slots", int, 32)
D("object_chunk_bytes", int, 16 * 1024 * 1024)  # node-to-node transfer chunk

# --- pip runtime envs (reference: runtime_env/pip.py role)
D("pip_env_install_timeout_s", float, 600.0)
# conda executable for conda runtime envs ("" = auto: conda/mamba/
# micromamba on PATH); container runtime for container runtime envs
# ("" = auto: podman/docker on PATH)
D("conda_exe", str, "")
D("container_runtime", str, "")

# --- runtime collectives (util/collective; reference: ray.util.collective)
# per-hop transfer chunk size — the named knob the selection layer and
# the bench matrix sweep; GroupOptions.chunk_bytes overrides per group
D("collective_chunk_bytes", int, 4 * 1024 * 1024)  # ring transfer chunk
# messages at or under this ride the latency-optimal algorithms when
# selection is on (auto): recursive doubling for allreduce (pow2
# worlds), binomial tree for broadcast
D("collective_small_max_bytes", int, 64 * 1024)
# elements per quantization block for the int8 wire codec (per-block
# f32 absmax scale + int8 payload; quantize.py)
D("collective_quant_block", int, 2048)
# how stale the cached SUSPECT-node set may get before the algorithm
# selection layer re-reads node_health (0 disables the health input)
D("collective_suspect_refresh_s", float, 1.0)
# co-hosted ranks hand chunks through the shm arena past this size
# (below it, the pickle5 oob-buffer wire path is cheaper than an
# arena create/seal/delete round trip)
D("collective_shm_min_bytes", int, 64 * 1024)
D("collective_op_timeout_s", float, 120.0)  # per-wait peer-traffic budget
D("collective_rendezvous_timeout_s", float, 60.0)
# podracer plane: abort a run() that made no sufficient progress in this
# window (a wedged fleet must surface as an error, not a silent hang)
D("podracer_progress_timeout_s", float, 300.0)
# podracer learner queue cap as a multiple of batch_fragments (beyond
# it the oldest queued fragment is shed — backpressure on sampling
# transiently outpacing training)
D("podracer_queue_factor", int, 4)
# peer-conn loss on a SUSPECT node defers poisoning until the GCS
# confirms the node's fate (dead -> poison, recovered -> no-op); this
# bounds the wait (unresolved past it poisons — fail-safe), with
# collective_confirm_poll_s the re-check cadence
D("collective_confirm_death_timeout_s", float, 15.0)
D("collective_confirm_poll_s", float, 0.25)

# --- streaming generator returns (reference: num_returns="streaming")
D("streaming_backpressure_items", int, 64)  # unacked items before the
#   producing worker pauses the generator

# --- object spilling (reference role: local_object_manager + external_storage)
D("object_spill_enabled", int, 1)
D("object_spill_high_frac", float, 0.8)  # arena fill ratio that triggers spill
D("object_spill_low_frac", float, 0.6)   # spill until back under this ratio
D("object_spill_max_restore_bytes", int, 0)  # 0 = no cap on restore size

# --- scheduler ---
D("sched_spread_threshold", float, 0.5)
# pending-lease wake scan: max non-placeable requests scanned (rotated
# to the tail) and max waiters woken per pass — bounds each pass at
# O(window) instead of O(backlog); grant-chaining re-kicks keep large
# capacity releases draining
D("sched_kick_scan_window", int, 64)
# actor-push flow control: once a connection's unsent transport buffer
# exceeds this, submissions queue behind the pump's drain() await
# instead of buffering unboundedly via call_soon
D("rpc_send_backlog_limit_bytes", int, 1 << 20)
D("sched_max_pending_lease_s", float, 60.0)
# in-flight lease requests per scheduling class: requests beyond this
# just park at the GCS (it grants as capacity frees and every grant
# re-pumps), while each parked request costs a call's coroutine/future
# machinery — unbounded, a 1000-deep task window parked ~1000 of them
D("sched_max_lease_requests_per_class", int, 16)
D("worker_pool_prestart", int, 0)
D("worker_idle_timeout_s", float, 300.0)
D("max_tasks_in_flight_per_worker", int, 1)  # >1 pipelines (uniform tasks)

# --- workers ---
D("worker_start_timeout_s", float, 60.0)
D("worker_nice", int, 0)

# --- logging / observability ---
D("log_dir", str, "")  # empty = <session_dir>/logs
D("event_buffer_size", int, 10000)
D("metrics_export_interval_s", float, 5.0)

# --- accelerators ---
D("gpu_count_override", int, -1)  # -1 = autodetect (accelerators/gpu.py)

# --- task execution ---
D("task_max_retries_default", int, 3)
D("actor_max_restarts_default", int, 0)

# --- data streaming ---
D("data_streaming_window", int, 8)  # max blocks in production at once

# --- memory monitor (OOM protection) ---
D("memory_usage_threshold", float, 0.95)  # kill workers above this
D("memory_monitor_interval_s", float, 1.0)  # 0 disables the monitor
D("memory_monitor_kill_grace_s", float, 3.0)  # min spacing between kills
D("memory_monitor_fake_usage_file", str, "")  # test override

# --- workflows ---
D("workflow_storage", str, os.path.join(session_root(), "workflows"))

# --- refcounting / lineage ---
D("ref_flush_interval_s", float, 0.05)  # batch window for holder updates
D("lineage_reconstruction_max", int, 3)  # re-executions per lost task
D("gcs_free_delay_s", float, 0.5)  # grace before freeing unreferenced objects

# --- retry/backoff (common/backoff.py: the one shared exponential-
# backoff-with-jitter policy; every knob below parameterizes a call
# site of it — no retry loop hand-rolls its own schedule, rtlint RT112
# flags the unbounded-no-backoff shape) ---
D("backoff_base_s", float, 0.05)
D("backoff_mult", float, 2.0)
D("backoff_max_s", float, 2.0)
D("backoff_jitter_frac", float, 0.1)
# client-side object pull retries in Runtime._resolve_one (previously
# the literal `failed_pulls < 8` and `sleep(min(0.2*n, 2.0))` ladder)
D("pull_retry_max", int, 8)
D("pull_retry_base_s", float, 0.2)
D("pull_retry_max_s", float, 2.0)
# failed pulls tolerated before an infinite-deadline wait (ray_tpu_torch.wait)
# surfaces the object as lost (was a literal 4)
D("pull_retry_infinite_max", int, 4)
# deadline-bounded get() retry poll (was a literal asyncio.sleep(0.05))
D("get_retry_poll_s", float, 0.05)
# ReconnectingConnection dial loop (was 0.1 doubling to a literal 2.0)
D("reconnect_backoff_base_s", float, 0.1)
D("reconnect_backoff_max_s", float, 2.0)

# --- graceful drain / preemption (gcs.py drain protocol v2) ---
# default drain budget when the caller names none (idle autoscaler
# drains and preemption notices without an announced deadline)
D("drain_deadline_default_s", float, 30.0)
# concurrent evacuation pulls per draining node (each is a target-node
# pull_object of a sole-copy object)
D("drain_evac_concurrency", int, 8)
# share of the drain budget spent waiting for in-flight task leases to
# return before proceeding to the kill-adjacent phases
D("drain_lease_wait_frac", float, 0.5)
# raylet preemption-watcher poll cadence (node.preempt chaos site +
# the GCE metadata stub); 0 disables the watcher
D("preempt_poll_interval_s", float, 0.25)
# actor-migration state blobs at most this large ride inline over the
# worker conn into GCS KV (the original path, bit-for-bit); larger
# blobs (pipeline-stage params + optimizer state) are stored in the
# shm object plane and only the object id crosses the control plane
D("actor_ckpt_inline_max_bytes", int, 256 * 1024)
# restore-side fetch budget for an object-plane checkpoint blob; on
# expiry the actor restarts fresh (the same degradation as a failed
# checkpoint capture) instead of wedging create_actor forever
D("actor_ckpt_fetch_timeout_s", float, 60.0)
# capture-fence quiescence budget: how long a drain checkpoint waits
# for already-admitted actor calls to finish before capturing anyway.
# A re-entrant call pattern (m1 awaiting self.m2 — rtflow RT201
# territory) can never quiesce once the fence parks the inner call; on
# expiry the capture proceeds (logged) rather than burning the whole
# drain deadline into the hard-death fallback
D("actor_ckpt_quiesce_timeout_s", float, 20.0)

cfg = _Config()
