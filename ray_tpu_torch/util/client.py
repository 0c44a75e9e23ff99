"""Remote-driver client surface.

Role-equivalent of ray: python/ray/util/client/ (the ``ray://`` proxy).
The reference needs a dedicated gRPC proxy because its driver must
co-locate with a raylet; this runtime's driver attaches to the GCS over
plain TCP and leases workers on whatever node has capacity
(core/api.py init(address=...)), so the client role collapses to a
context-managed connect/disconnect around the same first-class
protocol — no second serialization layer, no proxy server to babysit.

    from ray_tpu_torch.util.client import connect

    with connect("10.0.0.5:6379") as ctx:
        ref = some_remote_fn.remote(...)
        value = ray_tpu_torch.get(ref)

The driver binds no card of its own: cards go only to the leases of the
tasks and actors it submits.  A driver run on the head as a submitted job
(``ray_tpu_torch.job_submission``) sees the head's cards instead.
"""

from __future__ import annotations


class ClientContext:
    """Handle for a remote-driver connection (ray: ClientContext)."""

    def __init__(self, info: dict, address: str):
        self.info = info
        self.address = address
        self._disconnected = False

    def disconnect(self) -> None:
        if not self._disconnected:
            self._disconnected = True
            import ray_tpu_torch

            ray_tpu_torch.shutdown()

    def __enter__(self) -> "ClientContext":
        return self

    def __exit__(self, *exc) -> None:
        self.disconnect()

    def __repr__(self) -> str:
        return f"ClientContext(address={self.address!r})"


def connect(address: str) -> ClientContext:
    """Attach this process as a driver to a running cluster."""
    import ray_tpu_torch

    info = ray_tpu_torch.init(address=address)
    return ClientContext(info, address)
