"""Kubernetes node provider: declarative scaling through a cluster CRD.

Role-equivalent of the reference's KubeRay integration (ray:
python/ray/autoscaler/batching_node_provider.py — scale via one
declarative patch per reconcile batch, never imperative instance CRUD —
plus python/ray/autoscaler/kuberay/): the autoscaler expresses "this
group should have N workers, minus these specific pods" by patching an
``RtCluster`` custom resource; an in-cluster operator owns the pod
lifecycle.  A worker group is a HOST SHAPE (every pod of a group asks
for the same CPUs and cards), so an autoscaler node type is a group.

The provider is accelerator-free, and its wire format is the
reference's byte for byte: the CRD group ``ray-tpu.io``, version,
plural, request paths, headers and merge-patch bodies are unchanged, so
an operator written for the reference's ``RtCluster`` serves this
runtime's autoscaler as well.

The CRD shape this provider reads/writes::

    apiVersion: ray-tpu.io/v1
    kind: RtCluster
    metadata: {name, namespace}
    spec:
      workerGroups:
        - name: gpu1             # == autoscaler node_type
          replicas: 2
          workersToDelete: []    # pod names pending scale-down
          template: {...}        # operator-owned pod template

Pods carry labels ``ray-tpu.io/cluster`` and ``ray-tpu.io/group`` and
an annotation ``ray-tpu.io/node-id`` (set by the raylet once attached)
so provider pods can be matched to GCS nodes.

Transport is ``KubeApi``: the real ``RestKubeApi`` speaks the k8s REST
API with in-cluster service-account auth; tests run it byte-for-byte
against a local fixture server (no egress).
"""

from __future__ import annotations

import json
import logging
import os
import ssl
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider, ProviderNode

logger = logging.getLogger(__name__)

GROUP = "ray-tpu.io"
VERSION = "v1"
PLURAL = "rtclusters"

_SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class KubeApiError(RuntimeError):
    def __init__(self, status: int, method: str, path: str, body: str):
        self.status = status
        super().__init__(f"{method} {path} -> HTTP {status}: {body[:500]}")


class KubeApi:
    """Minimal transport the provider needs.  ``patch`` is a JSON merge
    patch (RFC 7386) — the declarative write primitive."""

    def get(self, path: str) -> dict:
        raise NotImplementedError

    def patch(self, path: str, body: dict) -> dict:
        raise NotImplementedError


class RestKubeApi(KubeApi):
    """In-cluster k8s REST client: bearer token + CA from the mounted
    service account (the operator deployment path), or injected
    ``base_url``/``token_fn`` (fixture tests, kubeconfig wrappers)."""

    def __init__(
        self,
        base_url: Optional[str] = None,
        token_fn: Optional[Callable[[], str]] = None,
        ca_file: Optional[str] = None,
    ):
        if base_url is None:
            host = os.environ.get("KUBERNETES_SERVICE_HOST")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not host:
                raise RuntimeError(
                    "not in a kubernetes pod (KUBERNETES_SERVICE_HOST "
                    "unset) and no base_url injected"
                )
            base_url = f"https://{host}:{port}"
        self.base_url = base_url.rstrip("/")
        self._token_fn = token_fn
        if self.base_url.startswith("https://"):
            sa_ca = os.path.join(_SA_DIR, "ca.crt")
            if ca_file is not None:
                self._ssl = ssl.create_default_context(cafile=ca_file)
            elif os.path.exists(sa_ca):  # in-cluster: the mounted CA
                self._ssl = ssl.create_default_context(cafile=sa_ca)
            else:  # off-cluster https (kubeconfig wrapper): system CAs
                self._ssl = ssl.create_default_context()
        else:  # http fixture server in tests
            self._ssl = None

    def _token(self) -> str:
        if self._token_fn is not None:
            return self._token_fn()
        with open(os.path.join(_SA_DIR, "token")) as f:
            return f.read().strip()

    def _request(self, method: str, path: str, body: Optional[dict] = None,
                 content_type: str = "application/json"):
        url = self.base_url + path
        data = None
        headers = {
            "Authorization": f"Bearer {self._token()}",
            "Accept": "application/json",
        }
        if body is not None:
            data = json.dumps(body, sort_keys=True).encode()
            headers["Content-Type"] = content_type
        req = urllib.request.Request(
            url, data=data, headers=headers, method=method
        )
        try:
            with urllib.request.urlopen(
                req, timeout=60, context=self._ssl
            ) as r:
                payload = r.read()
        except urllib.error.HTTPError as e:
            raise KubeApiError(
                e.code, method, path, e.read().decode(errors="replace")
            ) from None
        return json.loads(payload) if payload else {}

    def get(self, path: str) -> dict:
        return self._request("GET", path)

    def patch(self, path: str, body: dict) -> dict:
        # JSON merge patch: replaces exactly the named fields — the
        # provider sends the whole workerGroups array in one write
        return self._request(
            "PATCH", path, body, content_type="application/merge-patch+json"
        )


def cr_path(namespace: str, name: str) -> str:
    return (
        f"/apis/{GROUP}/{VERSION}/namespaces/{namespace}/{PLURAL}/{name}"
    )


def pods_path(namespace: str, cluster: str) -> str:
    sel = urllib.parse.quote(f"{GROUP}/cluster={cluster}")
    return f"/api/v1/namespaces/{namespace}/pods?labelSelector={sel}"


class KubeRayProvider(NodeProvider):
    """Scale worker groups of an RtCluster CR declaratively.

    Unlike the subprocess provider, nodes are not born from
    ``create_node`` — the operator materializes pods after a replicas
    patch.  ``create_node`` therefore returns a PENDING placeholder
    (no node_id yet), which the autoscaler already treats as
    capacity-in-flight; ``non_terminated_nodes`` reports live pods
    plus one placeholder per not-yet-manifested replica.
    """

    def __init__(self, api: KubeApi, namespace: str, cluster_name: str):
        self.api = api
        self.namespace = namespace
        self.cluster_name = cluster_name
        self._lock = threading.Lock()

    # -- CR access -------------------------------------------------------
    def _get_cr(self) -> dict:
        return self.api.get(cr_path(self.namespace, self.cluster_name))

    def _groups(self, cr: dict) -> List[dict]:
        return (cr.get("spec") or {}).get("workerGroups") or []

    def _patch_groups(self, cr: dict, groups: List[dict]) -> None:
        # Optimistic concurrency: echo the read CR's resourceVersion so
        # the apiserver rejects (409) a write that would clobber a
        # concurrent writer's update (e.g. the operator consuming a
        # workersToDelete entry between our read and patch).
        body: dict = {"spec": {"workerGroups": groups}}
        rv = (cr.get("metadata") or {}).get("resourceVersion")
        if rv is not None:
            body["metadata"] = {"resourceVersion": rv}
        self.api.patch(cr_path(self.namespace, self.cluster_name), body)

    def _mutate_groups(self, mutate) -> Optional[dict]:
        """get → ``mutate(groups)`` → patch, retrying the whole
        read-modify-write on 409 conflict.  ``mutate`` returns the
        touched group dict, or None to abort (no patch sent).

        The provider lock covers each ATTEMPT, not the backoff sleeps —
        every attempt re-reads the CR anyway, so correctness is per-RMW,
        and sleeping under the lock would convoy concurrent scale ops
        behind one retry storm for seconds."""
        last: Optional[KubeApiError] = None
        for attempt in range(8):
            with self._lock:
                cr = self._get_cr()
                groups = self._groups(cr)
                g = mutate(groups)
                if g is None:
                    return None
                try:
                    self._patch_groups(cr, groups)
                    return g
                except KubeApiError as e:
                    if e.status != 409:
                        raise
                    last = e  # stale resourceVersion: re-read and retry
            # any CR write (operator status updates included) bumps
            # resourceVersion; back off so a reconcile storm can't
            # exhaust back-to-back retries
            time.sleep(min(0.05 * (2 ** attempt), 1.0))
        raise last  # type: ignore[misc]

    def _pods(self) -> List[dict]:
        resp = self.api.get(pods_path(self.namespace, self.cluster_name))
        return resp.get("items", [])

    # -- NodeProvider surface -------------------------------------------
    def create_node(self, node_type, resources, labels) -> ProviderNode:
        """Ask for one more replica of ``node_type``'s group.  One CR
        read + one merge patch; the operator does the rest."""
        def bump(groups: List[dict]) -> dict:
            for g in groups:
                if g.get("name") == node_type:
                    g["replicas"] = int(g.get("replicas", 0)) + 1
                    return g
            raise KeyError(
                f"RtCluster {self.cluster_name} has no worker group "
                f"{node_type!r} (groups: "
                f"{[g.get('name') for g in groups]})"
            )

        g = self._mutate_groups(bump)
        logger.info(
            "scaled group %s of %s to %s replicas",
            node_type, self.cluster_name, g["replicas"],
        )
        return ProviderNode(
            provider_id=f"pending-{node_type}-{g['replicas']}",
            node_type=node_type,
            meta={"pending": True},
        )

    def terminate_node(self, node: ProviderNode) -> None:
        """Name the pod in workersToDelete AND drop replicas by one in
        the same patch — the operator deletes exactly that pod instead
        of a random scale-down victim (the batching provider's
        scale_request shape)."""
        if node.meta.get("pending"):
            # never manifested: just lower the replica count
            pod_name = None
        else:
            pod_name = node.provider_id
        def drop(groups: List[dict]) -> Optional[dict]:
            for g in groups:
                if g.get("name") == node.node_type:
                    g["replicas"] = max(0, int(g.get("replicas", 0)) - 1)
                    if pod_name is not None:
                        wtd = list(g.get("workersToDelete") or [])
                        if pod_name not in wtd:
                            wtd.append(pod_name)
                        g["workersToDelete"] = wtd
                    return g
            return None  # group vanished: nothing to do

        g = self._mutate_groups(drop)
        if g is None:
            return
        logger.info(
            "descaled group %s of %s to %s replicas (deleting %s)",
            node.node_type, self.cluster_name, g["replicas"], pod_name,
        )

    def non_terminated_nodes(self) -> List[ProviderNode]:
        cr = self._get_cr()
        pods = self._pods()
        out: List[ProviderNode] = []
        per_group_live: Dict[str, int] = {}
        deleting = {
            name
            for g in self._groups(cr)
            for name in (g.get("workersToDelete") or [])
        }
        for pod in pods:
            meta = pod.get("metadata", {})
            name = meta.get("name", "")
            phase = (pod.get("status") or {}).get("phase", "")
            if phase in ("Succeeded", "Failed") or name in deleting:
                continue
            group = (meta.get("labels") or {}).get(f"{GROUP}/group", "")
            node_id = (meta.get("annotations") or {}).get(
                f"{GROUP}/node-id"
            )
            per_group_live[group] = per_group_live.get(group, 0) + 1
            out.append(
                ProviderNode(
                    provider_id=name,
                    node_type=group,
                    node_id_hex=node_id,
                    meta={"phase": phase},
                )
            )
        # replicas the operator has not manifested yet count as pending
        # supply, or every reconcile pass would launch another copy
        for g in self._groups(cr):
            want = int(g.get("replicas", 0))
            have = per_group_live.get(g.get("name", ""), 0)
            for i in range(max(0, want - have)):
                out.append(
                    ProviderNode(
                        provider_id=f"pending-{g.get('name')}-{i}",
                        node_type=g.get("name", ""),
                        meta={"pending": True},
                    )
                )
        return out
