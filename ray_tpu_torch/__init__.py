"""ray_tpu_torch: the PyTorch/CUDA port of ray_tpu's compute layers.

A package of its own beside ``ray_tpu``, which stays the reference: it
imports torch and numpy, never jax and nothing of ``ray_tpu``.  Models live
in ``ray_tpu_torch.models``, attention ops and their CUDA kernels in
``ray_tpu_torch.ops`` (sources under ``csrc/``, built with nvcc on first use,
never at import), the training step in ``ray_tpu_torch.parallel``, serving in
``ray_tpu_torch.serve`` (the reference's control plane on this runtime,
the continuous-batching LLM engine and its deployment, the weight push)
and the runtime collectives in ``ray_tpu_torch.util.collective``.  Entry
points run on CUDA unless the caller passes ``device="cpu"``.

The single-node runtime is the reference's, copied: ``init(num_gpus=...)``
starts a GCS and a raylet, ``@remote`` tasks and actors run in worker
processes that the raylet leases, and ``put``/``get`` move objects, CPU
tensors included, through a shared-memory store.  A lease with GPUs sees
exactly its cards through ``CUDA_VISIBLE_DEVICES``; every other lease sees
none (``core/raylet.py``).
"""

from ray_tpu_torch._version import version as __version__


def __getattr__(name):
    # Lazy core-API import: importing `ray_tpu_torch` must stay cheap (and
    # free of torch) so control-plane processes can use the package without
    # pulling in the full runtime.
    if name in (
        "init",
        "shutdown",
        "is_initialized",
        "remote",
        "get",
        "put",
        "wait",
        "kill",
        "cancel",
        "get_actor",
        "get_runtime_context",
        "available_resources",
        "cluster_resources",
        "nodes",
        "method",
        "ObjectRef",
        "ObjectRefGenerator",
        "ActorHandle",
        "timeline",
    ):
        from ray_tpu_torch.core import api

        return getattr(api, name)
    if name in (
        "RayTpuError",
        "TaskError",
        "WorkerCrashedError",
        "ActorError",
        "ActorDiedError",
        "ObjectLostError",
        "GetTimeoutError",
        "TaskCancelledError",
        "RuntimeEnvSetupError",
        "NodeDiedError",
        "FencedError",
    ):
        # error types at the package top level, like ray.exceptions'
        # re-exports (ray: python/ray/exceptions.py)
        from ray_tpu_torch.core import errors

        return getattr(errors, name)
    raise AttributeError(f"module 'ray_tpu_torch' has no attribute {name!r}")
