"""Object serialization: cloudpickle + out-of-band (pickle protocol 5) buffers.

Role-equivalent of the reference's SerializationContext (ray:
python/ray/_private/serialization.py:111).  Large contiguous buffers (numpy
arrays, tensors, bytes) are carried out-of-band so they can be written
straight into shared memory without an extra copy, and reads off shared memory
are zero-copy memoryviews.

``torch.Tensor`` (see ``_reduce_tensor``): a CPU tensor of 64 KiB or more,
of any dtype (bf16 and float8 included), carries its bytes out of band and
is restored as a CPU tensor that owns a copy of them.  A CUDA tensor is
copied to the host and arrives as a CPU tensor: the counterpart of the
reference's jax.Array -> numpy, not Ray's semantics (Ray keeps the device).

Wire layout of a serialized object:

    [u32 meta_len][meta pickle][u32 nbufs]
    ([u64 buf_len][buf bytes]) * nbufs

The metadata pickle references the buffers positionally via
pickle.PickleBuffer out-of-band serialization.
"""

from __future__ import annotations

import logging
import pickle
import struct
import sys
import types
from typing import Any, Callable, List, Optional, Sequence

import cloudpickle

logger = logging.getLogger(__name__)

_HEADER = struct.Struct("<I")
_BUFHDR = struct.Struct("<Q")
_BYTES_OOB_THRESHOLD = 64 * 1024

#: Copy-trace instrumentation for the single-pass put invariant (data
#: plane v2): write_into() bumps these once per call.  A put is one
#: serialize pass over the payload iff payload_bytes grows by exactly the
#: payload size per put — the deterministic check bench/tests pin instead
#: of trusting wall-clock (see tests/test_zz_dataplane.py).  Plain int
#: adds; nothing here allocates.
COPY_TRACE = {"writes": 0, "payload_bytes": 0, "meta_bytes": 0}


class SerializedObject:
    """A serialized object: one metadata pickle plus N out-of-band buffers.

    ``meta`` may be any bytes-like (the serializer hands over the pickle
    scratch as a memoryview — no intermediate ``bytes`` materialization on
    the put path); ``buffers`` are zero-copy views of the payload's large
    contiguous regions.  ``write_into`` is the ONE pass that touches
    payload bytes: headers, meta and every buffer are written straight
    into the destination (an arena reservation, a wire scratch) as
    vectored segment writes."""

    __slots__ = ("meta", "buffers", "_total")

    def __init__(self, meta, buffers: List[memoryview]):
        self.meta = meta
        self.buffers = buffers
        self._total = 0

    @property
    def total_bytes(self) -> int:
        n = self._total
        if n == 0:
            n = _HEADER.size + len(self.meta) + _HEADER.size
            for b in self.buffers:
                n += _BUFHDR.size + b.nbytes
            self._total = n
        return n

    def write_into(self, dest: memoryview) -> int:
        """Write wire format into `dest`; returns bytes written.  The
        single payload pass: each out-of-band buffer is memcpy'd exactly
        once, directly into the destination."""
        off = 0
        meta_len = len(self.meta)
        _HEADER.pack_into(dest, off, meta_len)
        off += _HEADER.size
        dest[off : off + meta_len] = self.meta
        off += meta_len
        _HEADER.pack_into(dest, off, len(self.buffers))
        off += _HEADER.size
        payload = 0
        for b in self.buffers:
            _BUFHDR.pack_into(dest, off, b.nbytes)
            off += _BUFHDR.size
            dest[off : off + b.nbytes] = b.cast("B") if b.format != "B" else b
            off += b.nbytes
            payload += b.nbytes
        COPY_TRACE["writes"] += 1
        COPY_TRACE["payload_bytes"] += payload
        COPY_TRACE["meta_bytes"] += meta_len
        return off

    def to_bytes(self) -> bytes:
        out = bytearray(self.total_bytes)
        self.write_into(memoryview(out))
        return bytes(out)


def _restore_ext_ndarray(dtype, shape, buf):
    """Rebuild an extension-dtype ndarray from its out-of-band buffer.

    Zero-copy like numpy's builtin-dtype pickle-5 restore: the array is
    a read-only view over the buffer (whose .base chain keeps an arena
    pin alive on the shm zero-copy path)."""
    import numpy as np

    return np.frombuffer(buf, dtype=dtype).reshape(shape)


def _restore_tensor(dtype, shape, requires_grad, buf):
    """Rebuild a tensor from its raw bytes.  The bytes are copied once into
    memory the tensor owns: a tensor cannot be made read-only, and a view of
    the shared arena would let one reader's in-place op change the object
    under every other reader (the reference's numpy restore gives read-only
    views instead)."""
    # unpickling the dtype argument (``torch.bfloat16``) imported torch, so
    # the control plane's modules need no torch import of their own
    torch = sys.modules["torch"]
    data = bytearray(buf)
    if not data:  # frombuffer refuses an empty buffer
        t = torch.empty(shape, dtype=dtype)
    else:
        t = torch.frombuffer(data, dtype=torch.uint8).view(dtype).reshape(shape)
    return t.requires_grad_() if requires_grad else t


def _reduce_tensor(t, torch):
    """Reduce a strided ``torch.Tensor`` to its dtype, shape and bytes.

    The bytes are taken from a host tensor that is contiguous, detached and
    has its conjugate and negative bits resolved: a CUDA tensor is copied to
    the host, a non-contiguous one is made contiguous (a copy), and one that
    requires grad travels without its graph, restored as a leaf that
    requires grad.  At ``_BYTES_OOB_THRESHOLD`` and above the bytes go out of
    band as a ``PickleBuffer`` over a uint8 view (no copy for a contiguous
    CPU tensor); below it they are pickled in the metadata, as small numpy
    arrays are."""
    requires_grad = t.requires_grad
    h = t.detach().cpu().resolve_conj().resolve_neg().contiguous()
    raw = h.reshape(-1).view(torch.uint8).numpy()
    if raw.nbytes >= _BYTES_OOB_THRESHOLD:
        payload = pickle.PickleBuffer(raw)
    else:
        payload = raw.tobytes()
    return (_restore_tensor, (h.dtype, tuple(h.shape), requires_grad, payload))


def _restore_arrow_table(buf):
    import pyarrow as pa

    return pa.ipc.open_stream(pa.py_buffer(buf)).read_all()


_by_value_checked: set = set()


def _maybe_register_by_value(module_name: Optional[str]) -> None:
    """Serialize functions/classes from *user-code* modules by value.

    A module-level function defined in the driver's own script or test file
    pickles by reference under plain cloudpickle, and the worker — which
    does not share the driver's sys.path — fails with ModuleNotFoundError.
    The reference solves this with working_dir runtime envs; the more
    robust default here is: any module that is not installed (not under
    sys.prefix/site-packages or the stdlib) and is not the framework
    itself is registered with cloudpickle's pickle-by-value registry, so
    its code travels with the task (ray: python/ray/_private/
    serialization.py role; cloudpickle.register_pickle_by_value).
    """
    if not module_name or module_name in _by_value_checked:
        return
    _by_value_checked.add(module_name)
    if module_name in ("__main__", "__mp_main__"):  # already by-value
        return
    if module_name.split(".", 1)[0] == "ray_tpu_torch":
        return
    mod = sys.modules.get(module_name)
    f = getattr(mod, "__file__", None)
    if mod is None or f is None:  # builtin / namespace pkg
        return
    import os
    import site
    import sysconfig

    path = os.path.abspath(f)
    roots = {
        sysconfig.get_paths().get(k)
        for k in ("stdlib", "platstdlib", "purelib", "platlib")
    }
    try:  # user site + any system site-packages a venv exposes
        roots.update(site.getsitepackages())
        roots.add(site.getusersitepackages())
    except Exception:  # site may be absent under some embedded interpreters
        pass
    roots.discard(None)
    if any(path.startswith(os.path.abspath(r) + os.sep) for r in roots):
        return  # installed package: importable on workers by reference
    try:
        cloudpickle.register_pickle_by_value(mod)
    except Exception as e:
        logger.warning(
            "could not register module %r for by-value pickling (%s); "
            "functions from it will pickle by reference and workers "
            "without it on sys.path will fail to import it",
            module_name,
            e,
        )


class _Pickler(cloudpickle.CloudPickler):
    """Cloudpickle with isinstance-based custom reducers (handles torch
    tensors anywhere inside a container graph)."""

    def __init__(self, file, custom_reducers, **kw):
        super().__init__(file, **kw)
        self._custom = custom_reducers

    def reducer_override(self, obj):
        torch = sys.modules.get("torch")
        # plain strided tensors only: a subclass (nn.Parameter) reduces
        # through its own __reduce_ex__, whose plain .data lands here;
        # sparse and quantized layouts keep torch's own pickle
        if (
            torch is not None
            and type(obj) is torch.Tensor
            and obj.layout == torch.strided
            and not obj.is_quantized
        ):
            return _reduce_tensor(obj, torch)
        np_mod = sys.modules.get("numpy")
        if np_mod is not None and isinstance(obj, np_mod.ndarray):
            d = obj.dtype
            # Extension-dtype arrays (ml_dtypes bfloat16/fp8): numpy's own
            # protocol-5 reduce covers only builtin dtypes, so these
            # would serialize via tobytes() INTO the meta pickle — a
            # full extra payload copy the put path never sees.  Route
            # large contiguous ones out-of-band ourselves.
            if (
                d.isbuiltin != 1          # 2 = user-registered (ml_dtypes)
                and not d.hasobject
                and obj.flags.c_contiguous
                and obj.nbytes >= _BYTES_OOB_THRESHOLD
            ):
                # extension dtypes refuse the buffer protocol ("cannot
                # include dtype 'E' in a buffer") — export the raw
                # bytes through a zero-copy uint8 view instead
                return (
                    _restore_ext_ndarray,
                    (d, obj.shape,
                     pickle.PickleBuffer(obj.view(np_mod.uint8))),
                )
        pa = sys.modules.get("pyarrow")
        if pa is not None and isinstance(obj, pa.Table):
            # Arrow IPC, not arrow's own pickle: pickling a SLICED table
            # ships every chunk's entire parent buffer (a 1 MB slice of a
            # 25 MB block serializes as 25 MB; a shuffle reduce that
            # concats K slices ships K parents).  The IPC writer trims
            # buffers to the slice.  The payload rides out-of-band.
            sink = pa.BufferOutputStream()
            with pa.ipc.new_stream(sink, obj.schema) as w:
                w.write_table(obj)
            return (
                _restore_arrow_table,
                (pickle.PickleBuffer(sink.getvalue()),),
            )
        for typ, red in self._custom.items():
            if isinstance(obj, typ):
                return red(obj)
        if isinstance(obj, (types.FunctionType, type)):
            _maybe_register_by_value(getattr(obj, "__module__", None))
        return super().reducer_override(obj)


class _LargeBytes:
    """Wrapper that moves a big bytes/bytearray payload out-of-band.

    The C pickler serializes primitive bytes with a dedicated opcode
    BEFORE consulting reducer_override, embedding the payload in the
    metadata stream (a full extra copy through the put path) — so the
    top-level raw-buffer case (`put(b"...")`, ray's plasma raw-buffer
    analogue) is wrapped here instead.  Deserialization pays the one
    unavoidable copy (`bytes(buffer)` owns its memory).
    """

    __slots__ = ("data",)

    def __init__(self, data):
        self.data = data

    def __reduce_ex__(self, protocol):
        ctor = bytearray if isinstance(self.data, bytearray) else bytes
        return (ctor, (pickle.PickleBuffer(self.data),))


# value types safe to memoize by (type, value): immutable, hashable, and
# equality implies identical wire bytes.  float is EXCLUDED on purpose:
# -0.0 == 0.0 would alias two different payloads, and NaN keys never hit.
_MEMO_TYPES = frozenset((int, str, bytes, bool, type(None)))
_MEMO_MAX_VALUE_LEN = 512   # memoized str/bytes size cap
_MEMO_MAX_ENTRIES = 4096


class SerializationContext:
    """Pickles python objects with out-of-band buffer extraction."""

    def __init__(self):
        self._custom_reducers = {}
        # (type, value) -> wire bytes for small immutable arguments that
        # repeat across task submissions (spec-template arg memo)
        self._small_memo: dict = {}

    def register_reducer(self, typ: type, reducer: Callable) -> None:
        self._custom_reducers[typ] = reducer

    def serialize_small(self, obj: Any) -> Optional[bytes]:
        """Memoized wire bytes for a small immutable value, or None when
        the value is not memoizable (caller falls back to serialize()).
        Repeated small args (status strings, small ints, flags) then cost
        one dict hit per submission instead of a pickle pass."""
        t = type(obj)
        if t not in _MEMO_TYPES:
            return None
        if (t is str or t is bytes) and len(obj) > _MEMO_MAX_VALUE_LEN:
            return None
        key = (t, obj)
        b = self._small_memo.get(key)
        if b is None:
            b = self.serialize(obj).to_bytes()
            if len(self._small_memo) >= _MEMO_MAX_ENTRIES:
                self._small_memo.clear()
            self._small_memo[key] = b
        return b

    def serialize(self, obj: Any) -> SerializedObject:
        import io

        if (
            isinstance(obj, (bytes, bytearray))
            and len(obj) >= _BYTES_OOB_THRESHOLD
        ):
            obj = _LargeBytes(obj)
        buffers: List[memoryview] = []

        def cb(pb: pickle.PickleBuffer):
            buffers.append(pb.raw())
            return False  # buffer handled out-of-band

        meta_io = io.BytesIO()
        pickler = _Pickler(
            meta_io, self._custom_reducers, protocol=5, buffer_callback=cb
        )
        pickler.dump(obj)
        # getbuffer, not getvalue: the meta pickle is handed over as a view
        # of the scratch (which the view keeps alive) — the put path then
        # writes it straight into the arena reservation instead of paying
        # a bytes materialization first (RT115 bytes-copy-on-hot-path)
        return SerializedObject(meta_io.getbuffer(), buffers)

    def deserialize(
        self, data: memoryview | bytes, owner: Any = None
    ) -> Any:
        """Reconstruct an object; out-of-band buffers come back as views
        into ``data``.

        With ``owner`` set (the shm-store zero-copy path), every
        out-of-band buffer is wrapped in an :class:`_OwnedBuffer` that
        keeps ``owner`` (a PinnedBuffer) alive through the consumer's
        base chain — e.g. an ndarray's ``.base`` — so the store cannot
        evict or reuse the range while any deserialized view survives
        (ray: plasma client pins mapped objects until the last Buffer
        is destructed, plasma/client.cc)."""
        if owner is not None and not SUPPORTS_ZEROCOPY_OWNER:
            raise RuntimeError(
                "zero-copy deserialize (owner=) requires CPython >= 3.12 "
                "(PEP 688 __buffer__); gate callers on "
                "serialization.SUPPORTS_ZEROCOPY_OWNER"
            )
        mv = memoryview(data)
        off = 0
        (meta_len,) = _HEADER.unpack_from(mv, off)
        off += _HEADER.size
        meta = mv[off : off + meta_len]
        off += meta_len
        (nbufs,) = _HEADER.unpack_from(mv, off)
        off += _HEADER.size
        buffers: List[Any] = []
        for _ in range(nbufs):
            (blen,) = _BUFHDR.unpack_from(mv, off)
            off += _BUFHDR.size
            b = mv[off : off + blen]
            buffers.append(b if owner is None else _OwnedBuffer(b, owner))
            off += blen
        # pickle.loads accepts any buffer: parsing the meta view in place
        # saves a bytes copy per get (objects created during the parse own
        # their memory, so nothing retains the view past the call)
        return pickle.loads(meta, buffers=buffers)


# PEP 688 ``__buffer__`` is honored by CPython >= 3.12 only; on older
# interpreters _OwnedBuffer would raise TypeError inside pickle, so
# callers gate the owner= zero-copy path on this and fall back to a copy.
SUPPORTS_ZEROCOPY_OWNER = sys.version_info >= (3, 12)


class _OwnedBuffer:
    """A buffer-protocol view that keeps an owner object alive.

    memoryview slices reference the bottom exporter (the arena mmap),
    not the pin that blocks eviction — so zero-copy deserialization
    routes buffers through this wrapper instead (PEP 688 ``__buffer__``,
    Python ≥3.12).  A consumer such as ``np.frombuffer`` records the
    wrapper as ``.base``, chaining the pin to the array's lifetime.
    """

    __slots__ = ("_view", "_owner")

    def __init__(self, view: memoryview, owner: Any):
        self._view = view
        self._owner = owner

    def __buffer__(self, flags):
        return memoryview(self._view)

    def __len__(self):
        return self._view.nbytes


_default_context: Optional[SerializationContext] = None


def get_context() -> SerializationContext:
    global _default_context
    if _default_context is None:
        _default_context = SerializationContext()
    return _default_context


def serialize(obj: Any) -> SerializedObject:
    return get_context().serialize(obj)


def deserialize(data: memoryview | bytes) -> Any:
    return get_context().deserialize(data)
