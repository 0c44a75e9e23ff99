"""Logical-axis sharding rules (port of ``ray_tpu/parallel/sharding.py``).

Model code names every parameter dim with a *logical* axis ("embed",
"heads", "batch", ...); a rule table maps logical names to mesh axes.
Switching between pure DP, FSDP, TP and their products is a rule-table swap,
with no model change.  A *spec* is a tuple of logical names (or None), one
per tensor dim:

    ("batch", "seq", "embed")       activations
    ("embed", "mlp")                MLP kernel
    (None,)                         bias replicated everywhere

``logical_to_spec`` turns a spec into a :class:`PartitionSpec` of mesh axes,
the same one the reference computes; ``spec_placements`` turns that into
DTensor placements over a :class:`~ray_tpu_torch.parallel.mesh.Mesh`'s torch
axes: ``Shard(d)`` on each mesh axis that shards tensor dim d (a dim named by
several axes, such as "batch" → ("dp", "fsdp"), is sharded on each, outer
axis first), ``Replicate()`` on the rest.  Axes of size 1 are not in the
torch mesh and drop out.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

from ray_tpu_torch.parallel.mesh import (
    DCN_AXIS,
    DP_AXIS,
    EP_AXIS,
    FSDP_AXIS,
    SP_AXIS,
    TP_AXIS,
    Mesh,
    current_mesh,
)

LogicalSpec = Tuple[Optional[str], ...]
Rules = Tuple[Tuple[str, Union[str, Tuple[str, ...], None]], ...]

#: Default rule table, tuned for a decoder-only LM:
#:  - batch splits over both data axes,
#:  - params shard their largest dim over fsdp and their "parallel" dim
#:    (heads / mlp / vocab) over tp — the Megatron layout,
#:  - sequence dims of activations split over sp for context parallelism.
DEFAULT_RULES: Rules = (
    ("batch", (DP_AXIS, FSDP_AXIS)),
    ("seq", SP_AXIS),
    ("embed", FSDP_AXIS),
    ("heads", TP_AXIS),
    ("kv", None),
    ("mlp", TP_AXIS),
    ("vocab", TP_AXIS),
    ("layers", None),
    ("expert", EP_AXIS),
)

#: Multi-slice variant: the batch additionally splits over the dcn axis
#: (data parallelism across slices).
MULTISLICE_RULES: Rules = (
    ("batch", (DCN_AXIS, DP_AXIS, FSDP_AXIS)),
) + tuple(r for r in DEFAULT_RULES if r[0] != "batch")

#: Process-wide ACTIVE rule table; mesh construction installs the right one
#: (make_multislice_mesh swaps in MULTISLICE_RULES).
_active_rules: Rules = DEFAULT_RULES


def set_active_rules(rules: Rules) -> None:
    global _active_rules
    _active_rules = rules


def active_rules() -> Rules:
    return _active_rules


class PartitionSpec(tuple):
    """Mesh axes per tensor dim: None, an axis name, or a tuple of names
    (JAX's ``PartitionSpec``, which is also a tuple)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


def logical_to_spec(logical: Sequence[Optional[str]], rules: Optional[Rules] = None) -> PartitionSpec:
    """Map a tuple of logical axis names to a PartitionSpec via ``rules``
    (default: the process-wide active table)."""
    table = dict(rules if rules is not None else _active_rules)
    used = set()
    out = []
    for name in logical:
        mesh_axes = table.get(name) if name is not None else None
        if mesh_axes is None:
            out.append(None)
            continue
        if isinstance(mesh_axes, str):
            mesh_axes = (mesh_axes,)
        # A mesh axis may only shard one dim of a given array.
        free = tuple(a for a in mesh_axes if a not in used)
        used.update(free)
        if not free:
            out.append(None)
        elif len(free) == 1:
            out.append(free[0])
        else:
            out.append(free)
    while out and out[-1] is None:
        out.pop()
    return PartitionSpec(*out)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_placements(mesh: Mesh, spec: Sequence) -> tuple:
    """DTensor placements over ``mesh``'s torch axes for a PartitionSpec.

    DTensor shards a dim split by several mesh axes in mesh order, outer
    axis first, which is JAX's order for a tuple entry listed outer axis
    first (as every rule table's is); an entry that lists them otherwise
    raises, since plain ``Shard`` cannot express it."""
    from torch.distributed.tensor import Replicate, Shard

    out = {a: Replicate() for a in mesh.torch_axes}
    for d, entry in enumerate(spec):
        axes = [a for a in _axes(entry) if mesh.size(a) > 1]
        order = [mesh.torch_axes.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry} of dim {d} lists mesh axes out of mesh order "
                             f"{mesh.torch_axes}")
        for a in axes:
            out[a] = Shard(d)
    return tuple(out[a] for a in mesh.torch_axes)


def tree_shardings(mesh: Mesh, logical: Dict[str, LogicalSpec],
                   rules: Optional[Rules] = None) -> Dict[str, tuple]:
    """Map ``{parameter name: logical spec}`` (a model's
    ``param_logical_axes``, keyed like its ``named_parameters``) to
    ``{parameter name: DTensor placements}`` over ``mesh``."""
    return {name: spec_placements(mesh, logical_to_spec(spec, rules))
            for name, spec in logical.items()}


_constraints_disabled = False


class no_constraints:
    """Scope that turns `constrain` into identity."""

    def __enter__(self):
        global _constraints_disabled
        self._prev = _constraints_disabled
        _constraints_disabled = True

    def __exit__(self, *exc):
        global _constraints_disabled
        _constraints_disabled = self._prev


def constrain(x, logical: Sequence[Optional[str]], rules: Optional[Rules] = None):
    """Lay a DTensor ``x`` out by logical names under the current mesh
    (``redistribute``); identity for a plain tensor or outside a mesh.

    It is the reference's public API, kept for callers that hold DTensor
    activations.  The port's own models never reach it: they run on each
    rank's local blocks, with the collectives written out where the
    reference constrains a layout."""
    from torch.distributed.tensor import DTensor

    mesh = current_mesh()
    if _constraints_disabled or mesh is None or not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, spec_placements(mesh, logical_to_spec(logical, rules)))


def replicated(mesh: Mesh) -> tuple:
    """Placements of a tensor replicated over the whole mesh."""
    return spec_placements(mesh, PartitionSpec())
