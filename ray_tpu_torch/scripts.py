"""CLI: cluster lifecycle + state inspection.

Role-equivalent of ray: python/ray/scripts/scripts.py:568 (`ray start`,
`ray stop`, `ray status`) and the `ray list ...` state commands —
argparse instead of click (no extra deps) and a session file under the
runtime's session root (``common/constants.py`` ``session_root()``)
instead of a process table.

    python -m ray_tpu_torch start --head [--num-cpus N] [--num-gpus N]
    python -m ray_tpu_torch start --address HOST:PORT   # join as a worker node
    python -m ray_tpu_torch stop
    python -m ray_tpu_torch status [--address HOST:PORT]
    python -m ray_tpu_torch list actors|nodes|tasks|objects|workers|pgs
    python -m ray_tpu_torch metrics

A node started with ``--num-gpus N`` is given the first N of the host's
cards (``cluster_utils.host_gpus``): its raylet leases them, and the GCS
of a head hands them to submitted jobs' drivers (``job_submission.py``).
No command here imports torch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

from ray_tpu_torch.common.constants import session_root


def _session_file() -> str:
    return os.path.join(session_root(), "latest_cli_session.json")


def _save_session(info: dict) -> None:
    path = _session_file()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(info, f)


def _load_session() -> Optional[dict]:
    try:
        with open(_session_file()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _resolve_address(args) -> str:
    if getattr(args, "address", None):
        return args.address
    env = os.environ.get("RT_ADDRESS")
    if env:
        return env
    sess = _load_session()
    if sess:
        return sess["gcs_address"]
    sys.exit(
        "no cluster address: pass --address, set RT_ADDRESS, or start one "
        "with `python -m ray_tpu_torch start --head`"
    )


def _record_cards(num_gpus: float) -> None:
    """Name the node's cards for the processes it starts: the first
    ``num_gpus`` of the host's, in ``RT_GPU_VISIBLE_DEVICES``, where the
    raylet numbers its leases' cards and the GCS reads a job driver's.
    An explicit setting is kept, and a host with fewer cards than declared
    names none (its leases then number cards from 0)."""
    from ray_tpu_torch.cluster_utils import host_gpus
    from ray_tpu_torch.core import node as node_mod

    cards = host_gpus()[:int(num_gpus)]
    if num_gpus and len(cards) == num_gpus:
        os.environ.setdefault(node_mod.GPU_SET_ENV, ",".join(cards))


def cmd_start(args) -> None:
    from ray_tpu_torch.core import node as node_mod

    if args.num_tpus:
        raise ValueError(
            "the PyTorch/CUDA runtime schedules no TPU resource; "
            "pass --num-gpus instead"
        )
    session_dir = node_mod.default_session_dir()
    resources = node_mod.detect_resources(
        num_cpus=args.num_cpus, num_gpus=args.num_gpus
    )
    # before the GCS starts: it hands these cards to job drivers
    _record_cards(resources.get("GPU", 0))
    if args.head:
        gcs_proc, gcs_address = node_mod.start_gcs(session_dir)
    else:
        if not args.address:
            sys.exit("--address required to join an existing cluster")
        gcs_proc, gcs_address = None, args.address
    raylet_proc, raylet_addr, node_id, _store = node_mod.start_raylet(
        gcs_address, session_dir, resources
    )
    prev = _load_session() or {}
    _save_session({
        "gcs_address": gcs_address,
        "session_dir": session_dir,
        # a joining worker node must not clobber the recorded head pid
        "gcs_pid": gcs_proc.pid if gcs_proc else prev.get("gcs_pid"),
        "raylet_pids": prev.get("raylet_pids", []) + [raylet_proc.pid],
    })
    print(f"ray_tpu_torch {'head' if args.head else 'worker node'} started")
    print(f"  GCS address: {gcs_address}")
    print(f"  node id:     {node_id}")
    print(f"  session dir: {session_dir}")
    if resources.get("GPU"):
        cards = os.environ.get(node_mod.GPU_SET_ENV, "numbered from 0")
        print(f"  GPUs:        {resources['GPU']:g} (cards: {cards})")
    print(f"connect with ray_tpu_torch.init(address={gcs_address!r})")


def cmd_stop(args) -> None:
    import signal

    sess = _load_session()
    if not sess:
        sys.exit("no recorded CLI session")
    killed = 0
    for pid in sess.get("raylet_pids", []) + (
        [sess["gcs_pid"]] if sess.get("gcs_pid") else []
    ):
        try:
            os.kill(pid, signal.SIGTERM)
            killed += 1
        except ProcessLookupError:
            pass
    os.unlink(_session_file())
    print(f"stopped {killed} control-plane processes")


def cmd_up(args) -> None:
    from ray_tpu_torch.autoscaler import launcher

    state = launcher.up(args.config, wait_min_workers_s=args.wait)
    print(f"cluster {state['cluster_name']!r} is up")
    print(f"  GCS address: {state['gcs_address']}")
    print(f"  session dir: {state['session_dir']}")
    print(f"  monitor pid: {state['monitor_pid']}")
    print(
        f"connect with ray_tpu_torch.init(address={state['gcs_address']!r}); "
        f"tear down with `python -m ray_tpu_torch down {args.config}`"
    )


def cmd_down(args) -> None:
    from ray_tpu_torch.autoscaler import launcher

    stats = launcher.down(args.config)
    print(
        f"cluster down: {stats['provider_nodes']} provider nodes removed, "
        f"{stats['processes']} control-plane processes stopped"
    )


def _connect(args):
    import ray_tpu_torch

    ray_tpu_torch.init(address=_resolve_address(args))


def cmd_status(args) -> None:
    from ray_tpu_torch.util import state

    _connect(args)
    s = state.summarize()
    print("======== cluster status ========")
    print(f"nodes:  {s['nodes_alive']}/{s['nodes_total']} alive")
    print(f"actors: {s['actors_alive']}/{s['actors_total']} alive")
    print("resources:")
    total, avail = s["resources_total"], s["resources_available"]
    for k in sorted(total):
        used = total[k] - avail.get(k, 0)
        print(f"  {used:g}/{total[k]:g} {k}")
    if s["pending_leases"] or s["pending_pg_bundles"]:
        print(
            f"pending demand: {s['pending_leases']} leases, "
            f"{s['pending_pg_bundles']} PG bundles"
        )


def cmd_list(args) -> None:
    from ray_tpu_torch.util import state

    _connect(args)
    fn = {
        "actors": state.list_actors,
        "nodes": state.list_nodes,
        "tasks": state.list_tasks,
        "objects": state.list_objects,
        "workers": state.list_workers,
        "pgs": state.list_placement_groups,
    }[args.what]
    rows = fn()
    print(json.dumps(rows, indent=2, default=str))


def cmd_metrics(args) -> None:
    from ray_tpu_torch.util import state

    _connect(args)
    print(json.dumps(state.get_metrics(), indent=2))


def cmd_stacks(args) -> None:
    """Per-thread Python stacks of a live worker (py-spy role)."""
    from ray_tpu_torch.util import state

    _connect(args)
    if args.worker:
        dump = state.worker_stacks(args.worker)
        print(f"pid {dump['pid']}")
        for name, stack in dump["stacks"].items():
            print(f"\n--- {name} ---\n{stack}")
    else:
        for w in state.list_workers():
            print(json.dumps(
                {k: w.get(k) for k in ("worker_id", "pid", "actor_class")}
            ))


def cmd_memory(args) -> None:
    from ray_tpu_torch.util import state

    _connect(args)
    print(json.dumps(state.memory_summary(), indent=2, default=str))


def cmd_events(args) -> None:
    from ray_tpu_torch.util import events

    _connect(args)
    print(json.dumps(
        events.list_events(severity=args.severity), indent=2, default=str
    ))


def cmd_timeline(args) -> None:
    import ray_tpu_torch

    _connect(args)
    trace = ray_tpu_torch.timeline()
    if args.output:
        with open(args.output, "w") as f:
            json.dump(trace, f)
        print(f"wrote {len(trace)} events to {args.output}")
    else:
        print(json.dumps(trace, default=str))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ray_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("start", help="start a head or worker node")
    p.add_argument("--head", action="store_true")
    p.add_argument("--address", help="GCS address to join (worker node)")
    p.add_argument("--num-cpus", type=float, default=None)
    p.add_argument(
        "--num-gpus", type=float, default=None,
        help="cards this node leases (default: the cards detected)",
    )
    # the reference's option, refused with the runtime's TPU message
    p.add_argument("--num-tpus", type=float, default=None,
                   help=argparse.SUPPRESS)
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("stop", help="stop CLI-started nodes")
    p.set_defaults(fn=cmd_stop)

    p = sub.add_parser(
        "up", help="provision a cluster from cluster.yaml (head + "
                   "autoscaler monitor + min_workers)",
    )
    p.add_argument("config", help="path to cluster.yaml")
    p.add_argument(
        "--wait", type=float, default=0.0,
        help="block until min_workers are up (seconds)",
    )
    p.set_defaults(fn=cmd_up)

    p = sub.add_parser(
        "down", help="tear a cluster down (provider nodes, monitor, head)"
    )
    p.add_argument("config", help="path to cluster.yaml")
    p.set_defaults(fn=cmd_down)

    p = sub.add_parser("status", help="cluster summary")
    p.add_argument("--address")
    p.set_defaults(fn=cmd_status)

    p = sub.add_parser("memory", help="per-node object store usage")
    p.add_argument("--address")
    p.set_defaults(fn=cmd_memory)

    p = sub.add_parser("events", help="structured cluster events")
    p.add_argument("--severity", default=None)
    p.add_argument("--address")
    p.set_defaults(fn=cmd_events)

    p = sub.add_parser("timeline", help="chrome-trace timeline export")
    p.add_argument("--output", "-o", default=None)
    p.add_argument("--address")
    p.set_defaults(fn=cmd_timeline)

    p = sub.add_parser("list", help="list cluster entities")
    p.add_argument(
        "what",
        choices=["actors", "nodes", "tasks", "objects", "workers", "pgs"],
    )
    p.add_argument("--address")
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser("metrics", help="aggregated application metrics")
    p.add_argument("--address")
    p.set_defaults(fn=cmd_metrics)

    p = sub.add_parser(
        "stacks",
        help="dump a live worker's thread stacks (no arg: list workers)",
    )
    p.add_argument("worker", nargs="?", help="worker id (hex)")
    p.add_argument("--address")
    p.set_defaults(fn=cmd_stacks)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
