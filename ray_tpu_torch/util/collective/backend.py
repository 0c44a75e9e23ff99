"""Collective backend registry: one name → implementation table for the
runtime (out-of-program) collectives.

Role-equivalent of ray: python/ray/util/collective/collective.py's
backend dispatch (nccl/gloo): entries are lazy ``"module:attr"`` strings,
so registering the RPC ring backend does not import numpy until a group
is actually created.

``runtime`` backends implement the async op surface of
:class:`RuntimeBackend` and move data between processes at runtime (RPC
plane + shm arena, or a ``torch.distributed`` gang: ``"nccl"``).  The
``in_program`` backend ``"device_mesh"`` names the collectives over a
mesh's axes inside the program every rank runs
(``ray_tpu_torch.parallel.collectives``); ``init_collective_group``
refuses it for runtime groups with a pointer to the right usage.  The
reference's names for its JAX counterparts (``"jax"``, ``"mesh"``,
``"xla"``, ``"ici"``) raise ``CollectiveError`` naming the torch backend
that takes their place.
"""

from __future__ import annotations

import importlib
from typing import Any, Dict

from ray_tpu_torch.util.collective.types import CollectiveError, GroupSpec


class RuntimeBackend:
    """Op surface every runtime backend implements (async, numpy in/out).

    Instances are per-group, created by the manager on the runtime's io
    loop; all methods run on that loop.
    """

    kind = "runtime"

    def __init__(self, spec: GroupSpec, manager: Any):
        self.spec = spec
        self.manager = manager

    # -- collective ops --------------------------------------------------
    # wire_dtype / algorithm are the Collectives v2 per-op overrides
    # (quantized payload codec, selection-table override); a backend
    # that cannot honor a non-None value must raise CollectiveError,
    # never silently ignore it
    async def allreduce(self, arr, op, *, wire_dtype=None, algorithm=None):
        raise NotImplementedError

    async def allgather(self, arr):
        raise NotImplementedError

    async def reducescatter(self, arr, op, *, wire_dtype=None):
        raise NotImplementedError

    async def broadcast(self, arr, root: int, *, wire_dtype=None,
                        algorithm=None):
        raise NotImplementedError

    async def broadcast_object(self, obj, root: int):
        raise NotImplementedError

    async def barrier(self):
        raise NotImplementedError

    # -- point to point --------------------------------------------------
    async def send(self, arr, dst: int):
        raise NotImplementedError

    async def recv(self, arr, src: int):
        raise NotImplementedError

    async def shutdown(self):
        pass


class _Entry:
    __slots__ = ("target", "kind", "resolved")

    def __init__(self, target, kind):
        self.target = target  # "module:attr" string or a callable/class
        self.kind = kind
        self.resolved = None


_REGISTRY: Dict[str, _Entry] = {}
_ALIASES: Dict[str, str] = {}


def register_backend(name: str, target, *, kind: str = "runtime",
                     aliases: tuple = ()) -> None:
    """Register a backend under ``name``.  ``target`` is either the class
    itself or a lazy ``"module:attr"`` string resolved on first use."""
    _REGISTRY[name] = _Entry(target, kind)
    for a in aliases:
        _ALIASES[a] = name


def available_backends() -> Dict[str, str]:
    """name → kind for everything registered (built-ins included)."""
    return {name: e.kind for name, e in _REGISTRY.items()}


def resolve_backend(name: str):
    """The backend class/adapter for ``name``; raises with the full menu
    on an unknown name."""
    canonical = _ALIASES.get(name, name)
    entry = _REGISTRY.get(canonical)
    if entry is None:
        _refuse_not_ported(name)
        raise CollectiveError(
            f"unknown collective backend {name!r}; registered: "
            f"{sorted(set(_REGISTRY) | set(_ALIASES))}"
        )
    if entry.resolved is None:
        if isinstance(entry.target, str):
            mod_name, _, attr = entry.target.partition(":")
            mod = importlib.import_module(mod_name)
            entry.resolved = getattr(mod, attr)
        else:
            entry.resolved = entry.target
    return entry.resolved


def backend_kind(name: str) -> str:
    canonical = _ALIASES.get(name, name)
    entry = _REGISTRY.get(canonical)
    if entry is None:
        _refuse_not_ported(name)
        raise CollectiveError(f"unknown collective backend {name!r}")
    return entry.kind


# The reference's names for its JAX backends, by name and alias: what
# each stands for, and the torch backend that takes its place.
_GANG = ("a jax.distributed gang", "nccl")
_IN_PROGRAM = ("in-program XLA collectives", "device_mesh")
_JAX_ONLY = {"jax": _GANG, "mesh": _GANG, "xla": _IN_PROGRAM, "ici": _IN_PROGRAM}


def _refuse_not_ported(name: str) -> None:
    if name in _JAX_ONLY:
        what, torch_name = _JAX_ONLY[name]
        raise CollectiveError(
            f"collective backend {name!r}, {what}, is JAX's; its torch "
            f"counterpart is {torch_name!r} (or 'rpc', alias 'gloo', for "
            f"arbitrary runtime groups)"
        )


# Built-ins (lazy: nothing heavy imports until a group is created).
register_backend(
    "rpc", "ray_tpu_torch.util.collective.rpc_backend:RpcRingBackend",
    aliases=("gloo",),
)
register_backend("nccl", "ray_tpu_torch.util.collective.nccl_backend:NcclGangBackend")
register_backend(
    "device_mesh", "ray_tpu_torch.parallel.collectives:MeshInProgramBackend",
    kind="in_program",
)
