"""Node providers: how the autoscaler actually creates/destroys nodes.

Role-equivalent of the reference's NodeProvider plugin surface (ray:
python/ray/autoscaler/node_provider.py:23) with the launch-config
machinery dropped: a provider maps (node_type -> running raylet) and the
autoscaler owns all policy.  `LocalSubprocessProvider` is the
FakeMultiNodeProvider analogue (ray: autoscaler/_private/fake_multi_node/
node_provider.py) — it spawns real raylet subprocesses on this host, so
autoscaling tests exercise the same node lifecycle as production.

A node type with ``GPU`` gets its own cards from the host's, as
``Cluster.add_node`` gives them (``cluster_utils.node_resources`` and
``host_gpus``): the raylet's ``RT_GPU_VISIBLE_DEVICES`` names them, so its
lease k sees the k-th as ``CUDA_VISIBLE_DEVICES``, and a terminated node's
cards go back to the provider.
"""

from __future__ import annotations

import logging
import subprocess
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


@dataclass
class ProviderNode:
    provider_id: str
    node_type: str
    node_id_hex: Optional[str] = None  # raylet's cluster node id, once known
    proc: Optional[subprocess.Popen] = None
    meta: dict = field(default_factory=dict)


def split_cards(resources: Dict[str, float], host: List[str],
                taken: List[str]) -> Tuple[Dict[str, float], List[str]]:
    """A node's resources as a raylet takes them, and the host cards it is
    given: ``resources["GPU"]`` of ``host`` not in ``taken``
    (``cluster_utils.node_resources``, which also refuses a TPU, a
    fraction of a card and a host with too few cards left)."""
    from ray_tpu_torch.cluster_utils import node_resources

    rest = dict(resources)
    num_cpus = rest.pop("CPU", 0)
    res, gpus = node_resources(
        num_cpus, rest.pop("GPU", 0), rest, host, taken
    )
    if "CPU" not in resources:
        res.pop("CPU")
    return res, gpus


class NodeProvider:
    """Interface the autoscaler drives.  Implementations: local
    subprocesses (below), KubeRay worker groups (k8s_provider.py)."""

    def create_node(self, node_type: str, resources: Dict[str, float],
                    labels: Dict[str, str]) -> ProviderNode:
        raise NotImplementedError

    def terminate_node(self, node: ProviderNode) -> None:
        raise NotImplementedError

    def non_terminated_nodes(self) -> List[ProviderNode]:
        raise NotImplementedError


class LocalSubprocessProvider(NodeProvider):
    """Raylet subprocesses on the local host (tests / a single GPU host)."""

    def __init__(self, gcs_address: str, session_dir: str):
        self.gcs_address = gcs_address
        self.session_dir = session_dir
        self._nodes: Dict[str, ProviderNode] = {}
        self._counter = 0
        self._lock = threading.Lock()
        self._host_gpus: Optional[List[str]] = None

    def create_node(self, node_type, resources, labels) -> ProviderNode:
        from ray_tpu_torch.cluster_utils import host_gpus
        from ray_tpu_torch.core import node as node_mod

        labels = dict(labels)
        labels["ray_tpu_torch.node_type"] = node_type
        # one launch at a time: a node's cards are taken before the next
        # launch picks its own
        with self._lock:
            if resources.get("GPU") and self._host_gpus is None:
                self._host_gpus = host_gpus()
            res, gpus = split_cards(
                resources, self._host_gpus or [],
                [g for pn in self._nodes.values() for g in pn.meta["gpus"]],
            )
            proc, address, node_id, _store = node_mod.start_raylet(
                self.gcs_address,
                self.session_dir,
                res,
                labels=labels,
                # a node without cards names none: its leases see no card
                extra_env={node_mod.GPU_SET_ENV: ",".join(gpus)},
            )
            self._counter += 1
            pn = ProviderNode(
                provider_id=f"local-{self._counter}",
                node_type=node_type,
                node_id_hex=node_id,
                proc=proc,
                meta={"gpus": gpus},
            )
            self._nodes[pn.provider_id] = pn
        logger.info("provider launched %s (%s) as node %s",
                    pn.provider_id, node_type, node_id)
        return pn

    def terminate_node(self, node: ProviderNode) -> None:
        with self._lock:
            self._nodes.pop(node.provider_id, None)
        if node.proc is not None and node.proc.poll() is None:
            node.proc.terminate()
            try:
                node.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                node.proc.kill()
        logger.info("provider terminated %s", node.provider_id)

    def non_terminated_nodes(self) -> List[ProviderNode]:
        with self._lock:
            out = []
            for pn in list(self._nodes.values()):
                if pn.proc is not None and pn.proc.poll() is not None:
                    del self._nodes[pn.provider_id]  # crashed out of band
                else:
                    out.append(pn)
            return out

    def shutdown(self):
        for pn in self.non_terminated_nodes():
            self.terminate_node(pn)
