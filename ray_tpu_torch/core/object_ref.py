"""ObjectRef: a future handle to a (possibly remote) object.

Role-equivalent of ray: python/ray/_raylet.pyx ObjectRef.  Serializing a ref
(into task args or any container) goes through a custom reducer registered by
the runtime, which promotes the value to the shared store so any process can
resolve it (ray's borrowing protocol, collapsed to promote-on-escape).
"""

from __future__ import annotations

from typing import Optional

from ray_tpu_torch.common.ids import ObjectID

# Lazily-bound runtime module (circular import: runtime.py imports this
# module at load).  Bound once on first ref construction — an in-function
# import would pay the import-machinery lookup on EVERY ref create/delete,
# which is measurable on the submission hot path.
_rt_mod = None


def _bind_runtime():
    global _rt_mod
    from ray_tpu_torch.core import runtime as _rt

    _rt_mod = _rt
    return _rt


class ObjectRef:
    __slots__ = ("object_id", "_owner_hint", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_hint: Optional[str] = None):
        self.object_id = object_id
        self._owner_hint = owner_hint  # node hint for locality-aware pulls
        m = _rt_mod
        if m is None:
            m = _bind_runtime()
        rt = m._global_runtime
        if rt is not None:
            rt.on_ref_created(object_id)

    def hex(self) -> str:
        return self.object_id.hex()

    def binary(self) -> bytes:
        return self.object_id.binary()

    def __hash__(self):
        return hash(self.object_id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.object_id == self.object_id

    def __repr__(self):
        return f"ObjectRef({self.object_id.hex()[:16]})"

    def future(self):
        """concurrent.futures.Future resolving to the object's value."""
        m = _rt_mod or _bind_runtime()
        return m.get_runtime().as_future(self)

    def __await__(self):
        """Allow `await ref` inside async actors."""
        m = _rt_mod or _bind_runtime()
        return m.get_runtime().await_ref(self).__await__()

    def __reduce__(self):
        # Plain pickle path (no runtime mediation): carry id + hint.
        return (ObjectRef, (self.object_id, self._owner_hint))

    def __del__(self):
        try:
            m = _rt_mod
            if m is None:
                return  # no runtime ever existed: nothing to release
            rt = m._global_runtime
            if rt is not None:
                rt.on_ref_deleted(self.object_id)
        except Exception:
            pass  # interpreter teardown
