"""Declarative cluster launcher: ``python -m ray_tpu_torch up/down cluster.yaml``.

Role-equivalent of ray: `ray up` / `ray down`
(python/ray/scripts/scripts.py:1279, autoscaler/_private/commands.py:221)
— node types are host shapes (CPUs, cards), and the head + autoscaler
monitor come up with one command.

YAML schema::

    cluster_name: demo
    provider:
      type: local | kuberay
      # kuberay:  namespace, kuberay_cluster_name?, api_base_url?
    head:
      resources: {CPU: 4}
    available_node_types:
      gpu1:
        resources: {CPU: 8, GPU: 1}
        min_workers: 1
        max_workers: 4
    idle_timeout_s: 60
    autoscaler_interval_s: 1.0

``up`` starts the head (GCS + raylet), spawns the autoscaler monitor as
a daemon process driving the declared provider, and records the cluster
under ``<session root>/clusters/<name>.json`` (``common/constants.py``
``session_root()``).  ``down`` terminates every provider node, the
monitor, and the head, then deletes the record.  A node's ``GPU`` are
cards of this host, given as ``Cluster.add_node`` gives them
(``node_provider.split_cards``).

The reference's ``gce_tpu`` provider (TPU slices through the Cloud TPU
API) is refused: this runtime schedules no TPU, and its GPU counterpart is
ROADMAP A4.  PyYAML is imported where a file is read.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.autoscaler import NodeTypeConfig
from ray_tpu_torch.common.constants import session_root

logger = logging.getLogger(__name__)

#: the reference's TPU-slice provider, refused here
GCE_TPU_REFUSAL = (
    "provider.type gce_tpu provisions Cloud TPU slices, whose TPU "
    "resources this runtime does not schedule; its GPU counterpart is "
    "ROADMAP A4 (tpu_provider.py / gce_tpu_api.py)"
)


def _state_dir() -> str:
    return os.path.join(session_root(), "clusters")


class ClusterConfigError(ValueError):
    pass


def load_cluster_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    if not isinstance(cfg, dict):
        raise ClusterConfigError(f"{path}: top level must be a mapping")
    for key in ("cluster_name", "provider", "available_node_types"):
        if key not in cfg:
            raise ClusterConfigError(f"{path}: missing required key {key!r}")
    ptype = (cfg["provider"] or {}).get("type")
    if ptype not in ("local", "gce_tpu", "kuberay"):
        raise ClusterConfigError(
            f"{path}: provider.type must be local|gce_tpu|kuberay, "
            f"got {ptype!r}"
        )
    if ptype == "gce_tpu":
        raise ClusterConfigError(f"{path}: {GCE_TPU_REFUSAL}")
    for name, nt in cfg["available_node_types"].items():
        if not isinstance(nt, dict) or "resources" not in nt:
            raise ClusterConfigError(
                f"{path}: node type {name!r} needs a resources mapping"
            )
        if int(nt.get("min_workers", 0)) > int(nt.get("max_workers", 100)):
            raise ClusterConfigError(
                f"{path}: node type {name!r} has min_workers > max_workers"
            )
    return cfg


def node_type_configs(cfg: Dict[str, Any]) -> List[NodeTypeConfig]:
    return [
        NodeTypeConfig(
            name,
            {k: float(v) for k, v in nt["resources"].items()},
            int(nt.get("min_workers", 0)),
            int(nt.get("max_workers", 100)),
            dict(nt.get("labels") or {}),
        )
        for name, nt in cfg["available_node_types"].items()
    ]


def build_provider(cfg: Dict[str, Any], gcs_address: str, session_dir: str):
    """Instantiate the NodeProvider the config declares.  Used by the
    monitor process (autoscaler.main --cluster-config) and by down()."""
    p = cfg["provider"]
    ptype = p["type"]
    if ptype == "local":
        from ray_tpu_torch.autoscaler.node_provider import LocalSubprocessProvider

        return LocalSubprocessProvider(gcs_address, session_dir)
    if ptype == "kuberay":
        from ray_tpu_torch.autoscaler.k8s_provider import (
            KubeRayProvider,
            RestKubeApi,
        )

        api = RestKubeApi(
            base_url=p.get("api_base_url"),
            token_fn=(lambda: p["api_token"]) if p.get("api_token") else None,
        )
        return KubeRayProvider(
            api,
            p.get("namespace", "default"),
            p.get("kuberay_cluster_name", cfg["cluster_name"]),
        )
    raise ClusterConfigError(f"unknown provider type {ptype!r}")


# ---- cluster state records -------------------------------------------------

def _state_path(cluster_name: str) -> str:
    return os.path.join(_state_dir(), f"{cluster_name}.json")


def _save_state(cluster_name: str, state: Dict[str, Any]) -> None:
    os.makedirs(_state_dir(), exist_ok=True)
    with open(_state_path(cluster_name), "w") as f:
        json.dump(state, f, indent=2)


def load_state(cluster_name: str) -> Optional[Dict[str, Any]]:
    try:
        with open(_state_path(cluster_name)) as f:
            return json.load(f)
    except FileNotFoundError:
        return None


# ---- up / down -------------------------------------------------------------

def up(config_path: str, wait_min_workers_s: float = 0.0) -> Dict[str, Any]:
    """Provision the declared cluster: head + autoscaler monitor.

    Returns the cluster state record.  With ``wait_min_workers_s`` > 0,
    blocks until every node type reached min_workers (or the deadline).
    """
    from ray_tpu_torch.autoscaler.node_provider import split_cards
    from ray_tpu_torch.cluster_utils import host_gpus
    from ray_tpu_torch.core import node as node_mod

    cfg = load_cluster_config(config_path)
    name = cfg["cluster_name"]
    if load_state(name) is not None:
        raise ClusterConfigError(
            f"cluster {name!r} is already up (state file "
            f"{_state_path(name)}); run `python -m ray_tpu_torch down` first"
        )

    host = host_gpus()
    head_res, head_gpus = split_cards(
        (cfg.get("head") or {}).get("resources") or {"CPU": 4.0}, host, []
    )
    monitor_env = dict(os.environ)
    if head_gpus:
        # the monitor's provider hands out the cards the head left
        monitor_env["CUDA_VISIBLE_DEVICES"] = ",".join(
            g for g in host if g not in head_gpus
        )
    session_dir = node_mod.default_session_dir()
    gcs_proc, gcs_address = node_mod.start_gcs(session_dir)
    try:
        raylet_proc, _raylet_addr, head_node_id, _store = (
            node_mod.start_raylet(
                gcs_address, session_dir, head_res,
                labels={"ray_tpu_torch.head": "1"},
                extra_env={node_mod.GPU_SET_ENV: ",".join(head_gpus)},
            )
        )
    except BaseException:
        gcs_proc.terminate()
        raise

    # the monitor daemon rebuilds the provider from the SAME yaml —
    # one source of truth, survives launcher exit
    monitor = subprocess.Popen(
        [
            sys.executable, "-m", "ray_tpu_torch.autoscaler.autoscaler",
            "--gcs", gcs_address,
            "--session-dir", session_dir,
            "--cluster-config", os.path.abspath(config_path),
            "--interval", str(cfg.get("autoscaler_interval_s", 1.0)),
            "--idle-timeout", str(cfg.get("idle_timeout_s", 60.0)),
        ],
        stdout=open(os.path.join(session_dir, "autoscaler.log"), "ab"),
        stderr=subprocess.STDOUT,
        env=monitor_env,
    )
    state = {
        "cluster_name": name,
        "config_path": os.path.abspath(config_path),
        "gcs_address": gcs_address,
        "session_dir": session_dir,
        "head_node_id": head_node_id,
        "gcs_pid": gcs_proc.pid,
        "raylet_pid": raylet_proc.pid,
        "monitor_pid": monitor.pid,
        "started_at": time.time(),
    }
    _save_state(name, state)
    if wait_min_workers_s > 0:
        _wait_min_workers(cfg, gcs_address, wait_min_workers_s)
    return state


def _wait_min_workers(cfg, gcs_address: str, timeout_s: float) -> None:
    """Poll the GCS until every node type's min_workers are alive: each
    live node labelled ``ray_tpu_torch.node_type`` counts once (no
    provider of this runtime makes a node of several hosts)."""
    want = {
        name: int(nt.get("min_workers", 0))
        for name, nt in cfg["available_node_types"].items()
        if int(nt.get("min_workers", 0)) > 0
    }
    if not want:
        return
    deadline = time.monotonic() + timeout_s
    counts: Dict[str, int] = {}
    while time.monotonic() < deadline:
        counts = {}
        for n in _query_nodes(gcs_address):
            nt = (n.get("labels") or {}).get("ray_tpu_torch.node_type")
            if n.get("alive") and nt:
                counts[nt] = counts.get(nt, 0) + 1
        if all(counts.get(k, 0) >= v for k, v in want.items()):
            return
        time.sleep(0.5)
    raise TimeoutError(
        f"cluster did not reach min_workers within {timeout_s:.0f}s "
        f"(want {want}, have {counts})"
    )


def _query_nodes(gcs_address: str) -> List[dict]:
    import asyncio

    from ray_tpu_torch.core import rpc

    async def q():
        conn = await rpc.connect(gcs_address, timeout=5.0)
        try:
            return await conn.call("get_nodes", {})
        finally:
            await conn.close()

    return asyncio.run(q())


def _notify_raylet(address: str, method: str) -> None:
    import asyncio

    from ray_tpu_torch.core import rpc

    async def q():
        conn = await rpc.connect(address, timeout=5.0)
        try:
            await conn.call(method, {}, timeout=10.0)
        finally:
            await conn.close()

    asyncio.run(q())


def down(config_path: str) -> Dict[str, int]:
    """Tear the cluster down: every provider node, the monitor, the head.

    Idempotent: a missing state file only skips the pid kills; provider
    resources are still enumerated and deleted."""
    cfg = load_cluster_config(config_path)
    name = cfg["cluster_name"]
    state = load_state(name)
    stats = {"provider_nodes": 0, "processes": 0}

    # monitor FIRST — it would otherwise relaunch nodes as we delete them
    if state:
        for key in ("monitor_pid",):
            stats["processes"] += _kill(state.get(key))

    gcs_address = (state or {}).get("gcs_address", "")
    session_dir = (state or {}).get("session_dir", session_root())

    # drain every registered raylet via RPC — works for nodes whose pids
    # live in the (now dead) monitor or on OTHER hosts entirely
    if gcs_address:
        head_id = (state or {}).get("head_node_id")
        try:
            for n in _query_nodes(gcs_address):
                if not n.get("alive") or n.get("node_id") == head_id:
                    continue
                try:
                    _notify_raylet(n["address"], "shutdown_node")
                    stats["provider_nodes"] += 1
                except Exception:
                    logger.debug("drain of %s failed", n.get("address"))
        except Exception:
            logger.debug("GCS at %s unreachable during down", gcs_address)

    provider = build_provider(cfg, gcs_address, session_dir)
    for node in provider.non_terminated_nodes():
        try:
            provider.terminate_node(node)
            stats["provider_nodes"] += 1
        except Exception:
            logger.exception("terminating %s failed", node.provider_id)

    if state:
        for key in ("raylet_pid", "gcs_pid"):
            stats["processes"] += _kill(state.get(key))
        try:
            os.unlink(_state_path(name))
        except FileNotFoundError:
            pass
    return stats


def _kill(pid: Optional[int]) -> int:
    if not pid:
        return 0
    try:
        os.kill(pid, signal.SIGTERM)
        return 1
    except ProcessLookupError:
        return 0
