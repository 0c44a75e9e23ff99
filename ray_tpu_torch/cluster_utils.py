"""Multi-node cluster harness: many raylets on one machine.

Role-equivalent of ray: python/ray/cluster_utils.py:135 (Cluster,
add_node:201) — the workhorse of the reference's scheduler/failover tests.
Each add_node() starts a real raylet subprocess with its own shm store and
resource set, all registered to one GCS, so multi-node scheduling, object
transfer, placement groups, and node-death paths run for real on a single
host (e.g. CPU-only CI, or one GPU machine).

Cards: every raylet numbers its cards from 0 (``core/raylet.py``), so two
nodes on one host that both declared ``GPU`` would lease the same card.
``add_node(num_gpus=n)`` therefore gives each node its own n of the host's
cards (``host_gpus``), through ``RT_GPU_VISIBLE_DEVICES`` in the raylet's
environment: its lease k gets the k-th of them as ``CUDA_VISIBLE_DEVICES``.
A node asking for more cards than the host has left raises, and
``remove_node`` hands the node's cards back.
"""

from __future__ import annotations

import subprocess
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.core import node as node_mod


def host_gpus() -> List[str]:
    """The host's cards as ``CUDA_VISIBLE_DEVICES`` names: the entries of
    this process's ``CUDA_VISIBLE_DEVICES`` where it is set, else 0..n-1
    for the n cards detected (``accelerators/gpu.py``, which also reads
    ``RT_GPU_COUNT_OVERRIDE``)."""
    from ray_tpu_torch.accelerators.gpu import (
        GPUAcceleratorManager,
        visible_devices,
    )

    n = GPUAcceleratorManager().num_gpus()
    visible = visible_devices()
    names = visible if visible is not None else [str(i) for i in range(n)]
    return names[:n]


def node_resources(
    num_cpus: float,
    num_gpus: float,
    resources: Optional[Dict[str, float]],
    host: Sequence[str],
    taken: Sequence[str],
    num_tpus: float = 0,
) -> Tuple[Dict[str, float], List[str]]:
    """A new node's resources and the host cards it is given: the first
    ``num_gpus`` of ``host`` not in ``taken``.  Raises for a TPU (as the
    runtime's resource check, ``core/remote_function.py``), for cards given
    as ``resources["GPU"]``, for a fraction of a card, and where the host
    has too few cards left."""
    res = dict(resources or {})
    if num_tpus or any(k == "TPU" or k.startswith("TPU-") for k in res):
        raise ValueError(
            "the PyTorch/CUDA runtime schedules no TPU resource; "
            "ask for num_gpus instead"
        )
    if "GPU" in res:
        raise ValueError(
            "give a node's cards as num_gpus, not as resources['GPU']"
        )
    if num_gpus < 0 or num_gpus != int(num_gpus):
        raise ValueError(
            f"num_gpus must be a whole number of cards, got {num_gpus}"
        )
    res["CPU"] = float(num_cpus)
    free = [g for g in host if g not in set(taken)]
    if len(free) < num_gpus:
        raise ValueError(
            f"a node with num_gpus={num_gpus:g} asked for, but the host "
            f"has {len(free)} of its {len(host)} card(s) left "
            f"(taken: {','.join(taken) or 'none'})"
        )
    gpus = free[:int(num_gpus)]
    if gpus:
        res["GPU"] = float(len(gpus))
    return res, gpus


@dataclass
class ClusterNode:
    node_id: str
    address: str
    store_path: str
    proc: subprocess.Popen
    resources: Dict[str, float]
    gpus: List[str] = field(default_factory=list)  # host card names

    def kill(self, graceful: bool = True):
        if self.proc.poll() is None:
            if graceful:
                self.proc.terminate()
            else:
                self.proc.kill()
        try:
            self.proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=5)


class Cluster:
    def __init__(
        self,
        initialize_head: bool = False,
        connect: bool = False,
        head_node_args: Optional[dict] = None,
    ):
        self.session_dir = node_mod.default_session_dir()
        self.gcs_proc, self.address = node_mod.start_gcs(self.session_dir)
        self._nodes: List[ClusterNode] = []
        self._host_gpus: Optional[List[str]] = None
        self.head_node: Optional[ClusterNode] = None
        self._connected = False
        if initialize_head:
            self.head_node = self.add_node(**(head_node_args or {}))
            if connect:
                self.connect()

    @property
    def gcs_address(self) -> str:
        return self.address

    def add_node(
        self,
        num_cpus: float = 1,
        num_gpus: float = 0,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        object_store_bytes: int = 0,
        num_tpus: float = 0,
    ) -> ClusterNode:
        if num_gpus and self._host_gpus is None:
            self._host_gpus = host_gpus()
        res, gpus = node_resources(
            num_cpus, num_gpus, resources, self._host_gpus or [],
            [g for n in self._nodes for g in n.gpus], num_tpus,
        )
        proc, address, node_id, store_path = node_mod.start_raylet(
            self.address,
            self.session_dir,
            res,
            labels=labels,
            store_capacity=object_store_bytes,
            # a node without cards names none: its leases see no card
            extra_env={node_mod.GPU_SET_ENV: ",".join(gpus)},
        )
        node = ClusterNode(
            node_id=node_id,
            address=address,
            store_path=store_path,
            proc=proc,
            resources=res,
            gpus=gpus,
        )
        self._nodes.append(node)
        if self.head_node is None:
            self.head_node = node
        return node

    def remove_node(self, node: ClusterNode, allow_graceful: bool = True):
        """Kill a raylet (and its workers); the GCS sees a node death.
        The node's cards go back to the host's free set."""
        node.kill(graceful=allow_graceful)
        if node in self._nodes:
            self._nodes.remove(node)
        if self.head_node is node:
            self.head_node = self._nodes[0] if self._nodes else None

    def wait_for_nodes(self, timeout: float = 30.0) -> None:
        """Block until every added node is alive in the GCS view."""
        import ray_tpu_torch

        deadline = time.monotonic() + timeout
        want = {n.node_id for n in self._nodes}
        alive: set = set()
        while time.monotonic() < deadline:
            if self._connected:
                alive = {
                    n["node_id"] for n in ray_tpu_torch.nodes() if n["alive"]
                }
            else:
                alive = set(self._query_alive())
            if want <= alive:
                return
            time.sleep(0.1)
        raise TimeoutError(
            f"nodes never all registered: want {want}, alive {alive}"
        )

    def _query_alive(self) -> List[str]:
        import asyncio

        from ray_tpu_torch.core import rpc

        async def go():
            conn = await rpc.connect(self.address)
            try:
                nodes = await conn.call("get_nodes", {})
            finally:
                await conn.close()
            return [n["node_id"] for n in nodes if n["alive"]]

        return asyncio.run(go())

    def connect(self):
        """Attach this process as a driver to the cluster."""
        import ray_tpu_torch

        ray_tpu_torch.init(address=self.address)
        self._connected = True

    def kill_gcs(self):
        """kill -9 the GCS process (head fault injection)."""
        if self.gcs_proc.poll() is None:
            self.gcs_proc.kill()
            self.gcs_proc.wait(timeout=5)

    def restart_gcs(self, timeout: float = 30.0):
        """Restart the GCS on the SAME port with the same session dir, so
        raylets/drivers holding ReconnectingConnections re-attach and the
        checkpoint restores cluster state (ray: GCS FT with external Redis;
        here the CheckpointStore under the session dir)."""
        self.kill_gcs()
        host, port_s = self.address.rsplit(":", 1)
        deadline = time.monotonic() + timeout
        last_exc: Optional[BaseException] = None
        while time.monotonic() < deadline:
            try:
                self.gcs_proc, addr = node_mod.start_gcs(
                    self.session_dir, host=host, port=int(port_s)
                )
                assert addr == self.address, (addr, self.address)
                return
            except Exception as e:  # port may linger in TIME_WAIT briefly
                last_exc = e
                time.sleep(0.3)
        raise RuntimeError(f"GCS restart failed: {last_exc!r}")

    def shutdown(self):
        """Tear down all raylets and the GCS."""
        for node in list(self._nodes):
            node.kill(graceful=True)
        self._nodes.clear()
        self.head_node = None
        if self.gcs_proc.poll() is None:
            self.gcs_proc.terminate()
            try:
                self.gcs_proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.gcs_proc.kill()
