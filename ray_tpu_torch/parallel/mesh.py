"""Device meshes over the ranks of a ``torch.distributed`` process group
(port of ``ray_tpu/parallel/mesh.py``).

The reference runs SPMD in one process over many devices and names six mesh
axes, outer to inner:

  dp    data parallelism (parameters replicated, gradients summed)
  fsdp  fully-sharded data parallelism (parameters sharded, gathered per
        use; gradients reduce-scattered)
  ep    expert parallelism (MoE experts sharded)
  pp    pipeline parallelism (layer stages)
  sp    sequence parallelism (ring attention neighbours)
  tp    tensor parallelism (heads, MLP columns and the vocabulary sharded)

torch runs one process per device, so a mesh here is built over the ranks of
an initialised default process group: rank r sits at the row-major
coordinate r of the mesh's shape, the last axis varying fastest.  The
six-axis :class:`MeshConfig` stays the logical layer, and every axis is
named in :class:`Mesh`'s ``shape``; but torch's ``DeviceMesh`` is handed only
the axes larger than 1.  DTensor's sharding propagation grows exponentially
with the number of mesh dimensions even where all but one have size 1, so a
mesh with all six would make every operation on a sharded tensor crawl.  A
mesh whose axes are all 1 is one rank over ``"dp"``, so that one device runs
the same code.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple, Union

DP_AXIS = "dp"
FSDP_AXIS = "fsdp"
EP_AXIS = "ep"
PP_AXIS = "pp"
SP_AXIS = "sp"
TP_AXIS = "tp"

#: Mesh axes ordered outer→inner. dp/fsdp vary slowest (their collectives
#: tolerate the most latency: once-per-step gradient reductions), tp varies
#: fastest (per-layer collectives want nearest neighbours).
AXIS_ORDER = (DP_AXIS, FSDP_AXIS, EP_AXIS, PP_AXIS, SP_AXIS, TP_AXIS)

#: Axes over which a gradient sum runs for data parallelism.
DATA_AXES = (DP_AXIS, FSDP_AXIS)

#: Outermost axis of a multi-slice mesh: in the reference it crosses the
#: data-center network between TPU slices, so only once-per-step collectives
#: (data-parallel gradient sums) map onto it.
DCN_AXIS = "dcn"

AxisName = Union[str, Sequence[str]]


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical shape of the device mesh.

    ``-1`` for at most one axis means "absorb all remaining devices".
    """

    dp: int = -1
    fsdp: int = 1
    ep: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1

    def resolve(self, n_devices: int) -> "MeshConfig":
        sizes = {"dp": self.dp, "fsdp": self.fsdp, "ep": self.ep,
                 "pp": self.pp, "sp": self.sp, "tp": self.tp}
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {wild}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wild:
            if n_devices % fixed:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}"
                )
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices, have {n_devices}"
            )
        return MeshConfig(**sizes)

    @property
    def shape(self) -> tuple:
        return (self.dp, self.fsdp, self.ep, self.pp, self.sp, self.tp)

    def describe(self) -> str:
        return "x".join(
            f"{a}={s}" for a, s in zip(AXIS_ORDER, self.shape) if s != 1
        ) or "single-device"


class Mesh:
    """A logical mesh: every named axis with its size (``shape``, in mesh
    order), this rank's coordinate on each, and the torch ``DeviceMesh``
    (``torch_mesh``) over the axes larger than 1 (``torch_axes``), or over
    ``"dp"`` alone where every axis is 1.

    ``Mesh.unsharded()`` is the mesh of an unsharded model: no process
    group, every axis of size 1, so every collective over it is the
    identity.
    """

    def __init__(self, shape: Dict[str, int], torch_mesh=None, device_type: str = "cuda",
                 coords: Optional[Dict[str, int]] = None):
        self.shape = dict(shape)
        self.axis_names = tuple(self.shape)
        self.torch_mesh = torch_mesh
        self.device_type = device_type
        self.coords = dict(coords or {a: 0 for a in self.axis_names})
        self.torch_axes = tuple(torch_mesh.mesh_dim_names) if torch_mesh is not None else ()

    @staticmethod
    def unsharded() -> "Mesh":
        return Mesh({a: 1 for a in AXIS_ORDER})

    def size(self, axes: AxisName) -> int:
        """The product of the sizes of ``axes`` (an axis this mesh does not
        name has size 1)."""
        if isinstance(axes, str):
            axes = (axes,)
        return math.prod(self.shape.get(a, 1) for a in axes)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords.get(axis, 0)

    def group(self, axis: str):
        """The process group of this rank's line along ``axis`` (size > 1)."""
        return self.torch_mesh.get_group(axis)

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """The axes a batch is split over: ``dcn`` (when named), dp, fsdp."""
        return tuple(a for a in (DCN_AXIS,) + DATA_AXES if a in self.shape)

    def describe(self) -> str:
        return "x".join(f"{a}={s}" for a, s in self.shape.items() if s != 1) or "single-device"

    def __repr__(self):
        return f"Mesh({self.describe()}, torch axes {self.torch_axes}, {self.device_type})"


#: Process-wide active mesh, set by make_mesh / set_current_mesh.  Library
#: code (ring attention, the sharded flash path) that needs the concrete mesh
#: fetches it here rather than threading it through every call.
_CURRENT_MESH: Optional[Mesh] = None


def set_current_mesh(mesh: Optional[Mesh]) -> None:
    global _CURRENT_MESH
    _CURRENT_MESH = mesh


def current_mesh() -> Optional[Mesh]:
    return _CURRENT_MESH


@contextlib.contextmanager
def use(mesh: Optional[Mesh]):
    """Bind ``mesh`` as the current mesh for the ``with`` block."""
    prev = _CURRENT_MESH
    set_current_mesh(mesh)
    try:
        yield mesh
    finally:
        set_current_mesh(prev)


def _world(device_type: str):
    """The default group's world size and rank; raises where there is none,
    or where ``device_type`` is cuda and no card is present."""
    import torch
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh builds over the ranks of a process group: call "
            "torch.distributed.init_process_group first (nccl for cuda, gloo for cpu)"
        )
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh(device_type='cuda'): no CUDA device is available")
    return dist.get_world_size(), dist.get_rank()


def _build(names: Tuple[str, ...], sizes: Tuple[int, ...], device_type: str) -> Mesh:
    """A :class:`Mesh` of ``names``/``sizes`` over the default group."""
    from torch.distributed.device_mesh import init_device_mesh

    n, rank = _world(device_type)
    if math.prod(sizes) != n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {math.prod(sizes)} ranks, "
                         f"the process group has {n}")
    coords, r = {}, rank
    for a, s in reversed(list(zip(names, sizes))):
        coords[a], r = r % s, r // s
    torch_names = tuple(a for a, s in zip(names, sizes) if s > 1) or (DP_AXIS,)
    torch_sizes = tuple(s for s in sizes if s > 1) or (1,)
    torch_mesh = init_device_mesh(device_type, torch_sizes, mesh_dim_names=torch_names)
    return Mesh(dict(zip(names, sizes)), torch_mesh, device_type, coords)


def make_mesh(config: Optional[MeshConfig] = None, *, device_type: str = "cuda") -> Mesh:
    """Build the six-axis mesh over the ranks of the default process group
    and make it current, with the default rule table active.

    ``device_type`` is ``"cuda"`` (an NCCL group, one card a rank) unless
    the caller asks for ``"cpu"`` (a gloo group); cuda raises where there is
    no card.
    """
    n, _ = _world(device_type)
    config = (config or MeshConfig()).resolve(n)
    mesh = _build(AXIS_ORDER, config.shape, device_type)
    set_current_mesh(mesh)
    from ray_tpu_torch.parallel import sharding as _sharding

    _sharding.set_active_rules(_sharding.DEFAULT_RULES)
    return mesh


def make_multislice_mesh(n_slices: int, config: Optional[MeshConfig] = None, *,
                         device_type: str = "cuda") -> Mesh:
    """A dcn × ici product mesh over ``n_slices`` slices of the process
    group's ranks: ``dcn`` is the outermost axis, so slice s is ranks
    s·per_slice .. (s+1)·per_slice - 1 (a process has no ``slice_index``;
    its slice is ``RANK // per_slice``).  Every model axis stays inside a
    slice, and the batch splits across slices under ``MULTISLICE_RULES``,
    which this installs."""
    n, _ = _world(device_type)
    if n % n_slices:
        raise ValueError(f"{n} ranks not divisible into {n_slices} slices")
    config = (config or MeshConfig()).resolve(n // n_slices)
    mesh = _build((DCN_AXIS,) + AXIS_ORDER, (n_slices,) + config.shape, device_type)
    set_current_mesh(mesh)
    # model-internal constrain() calls must see the dcn-aware "batch" rule
    from ray_tpu_torch.parallel import sharding as _sharding

    _sharding.set_active_rules(_sharding.MULTISLICE_RULES)
    return mesh
