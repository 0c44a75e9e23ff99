"""Python client for the native shared-memory object store.

ctypes bindings over ``shm_store.cc`` (the plasma-equivalent; see that file's
header comment).  The C library owns allocation and the object index; the
data plane is a plain ``mmap`` of the same arena file, giving zero-copy
``memoryview`` reads of sealed objects (ray: plasma client.cc mmap-and-read
analogue, minus the socket protocol).
"""

from __future__ import annotations

import ctypes
import hashlib
import mmap
import os
import subprocess
import threading
from typing import Optional

from ray_tpu_torch.common import faults

_SRC = os.path.join(os.path.dirname(__file__), "shm_store.cc")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
_CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-pthread")

RT_OK = 0
RT_EXISTS = -1
RT_NOT_FOUND = -2
RT_NO_SPACE = -3
RT_ERR = -4
RT_NOT_SEALED = -5
RT_PINNED = -6
RT_TOO_MANY_PINS = -7
RT_NO_CLIENT_SLOT = -8

_RC_NAMES = {
    RT_OK: "OK",
    RT_EXISTS: "EXISTS",
    RT_NOT_FOUND: "NOT_FOUND",
    RT_NO_SPACE: "NO_SPACE",
    RT_ERR: "ERR",
    RT_NOT_SEALED: "NOT_SEALED",
    RT_PINNED: "PINNED",
    RT_TOO_MANY_PINS: "TOO_MANY_PINS",
    RT_NO_CLIENT_SLOT: "NO_CLIENT_SLOT",
}


def _rc_name(rc: int) -> str:
    return _RC_NAMES.get(rc, str(rc))


class StoreError(Exception):
    pass


class ObjectExistsError(StoreError):
    pass


class ObjectNotFoundError(StoreError):
    pass


class StoreFullError(StoreError):
    pass


def library_path() -> str:
    """Where the store's library is built: ``ray_tpu_torch/_build/``, under
    a name that hashes the source and the flags, so an edited source is
    rebuilt and a stale library is never loaded.  No library is kept in
    the repository."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_CXX_FLAGS).encode())
    return os.path.join(_BUILD_DIR, f"libshm_store-{h.hexdigest()[:16]}.so")


def _build_library() -> str:
    """Compile the library on first use (flock-guarded, so that concurrent
    workers build it once) and return its path."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(so + ".lock", "w") as lf:
        import fcntl

        fcntl.flock(lf, fcntl.LOCK_EX)
        if os.path.exists(so):
            return so
        tmp = f"{so}.tmp{os.getpid()}"
        subprocess.run(
            ["g++", *_CXX_FLAGS, _SRC, "-o", tmp], check=True, capture_output=True
        )
        os.replace(tmp, so)
    return so


_lib = None
_lib_lock = threading.Lock()


def _get_lib():
    global _lib
    if _lib is None:
        with _lib_lock:
            if _lib is None:
                lib = ctypes.CDLL(_build_library())
                lib.rt_store_create.restype = ctypes.c_void_p
                lib.rt_store_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
                lib.rt_store_attach.restype = ctypes.c_void_p
                lib.rt_store_attach.argtypes = [ctypes.c_char_p]
                lib.rt_store_detach.argtypes = [ctypes.c_void_p]
                lib.rt_store_create_object.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
                    ctypes.POINTER(ctypes.c_uint64),
                ]
                lib.rt_store_seal.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
                lib.rt_store_seal2.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                ]
                lib.rt_store_reserve_slots.restype = ctypes.c_uint64
                lib.rt_store_reserve_slots.argtypes = [
                    ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
                    ctypes.POINTER(ctypes.c_uint64),
                ]
                lib.rt_store_release_slots.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
                    ctypes.c_uint64,
                ]
                lib.rt_store_publish_slot.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
                    ctypes.c_uint64, ctypes.c_int,
                ]
                lib.rt_store_max_slab_slots.restype = ctypes.c_uint64
                lib.rt_store_max_slab_slots.argtypes = []
                lib.rt_store_abort.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
                lib.rt_store_get.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p,
                    ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
                ]
                lib.rt_store_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
                lib.rt_store_unpin.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
                lib.rt_store_delete.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
                lib.rt_store_stats.argtypes = [ctypes.c_void_p] + [
                    ctypes.POINTER(ctypes.c_uint64)
                ] * 4
                lib.rt_store_protect.argtypes = [
                    ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                ]
                lib.rt_store_list_spillable.restype = ctypes.c_uint64
                lib.rt_store_list_spillable.argtypes = [
                    ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
                    ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
                ]
                lib.rt_store_base.restype = ctypes.c_void_p
                lib.rt_store_base.argtypes = [ctypes.c_void_p]
                lib.rt_store_map_size.restype = ctypes.c_uint64
                lib.rt_store_map_size.argtypes = [ctypes.c_void_p]
                lib.rt_store_reap.argtypes = [ctypes.c_void_p]
                lib.rt_store_min_size.restype = ctypes.c_uint64
                lib.rt_store_min_size.argtypes = []
                lib.rt_store_max_pins.restype = ctypes.c_uint64
                lib.rt_store_max_pins.argtypes = []
                _lib = lib
    return _lib


def _check_id(object_id: bytes) -> bytes:
    """The C side reads exactly 16 bytes; anything else is an OOB read."""
    if not isinstance(object_id, (bytes, bytearray)) or len(object_id) != 16:
        raise ValueError(
            f"object id must be exactly 16 bytes, got "
            f"{type(object_id).__name__} of length "
            f"{len(object_id) if hasattr(object_id, '__len__') else '?'}"
        )
    return bytes(object_id)


class PinnedBuffer:
    """Zero-copy view of a sealed object; unpins on release/del."""

    __slots__ = ("store", "object_id", "view", "_released")

    def __init__(self, store: "ShmStore", object_id: bytes, view: memoryview):
        self.store = store
        self.object_id = object_id
        self.view = view
        self._released = False

    def release(self):
        if not self._released:
            self._released = True
            self.view.release()
            self.store._unpin(self.object_id)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()

    def __del__(self):
        try:
            self.release()
        except Exception:
            pass


class ShmStore:
    """One node's shared-memory object store (create or attach)."""

    def __init__(self, path: str, capacity_bytes: int = 0, create: bool = False):
        self.path = path
        self._lib = _get_lib()
        if create:
            min_size = self._lib.rt_store_min_size()
            if capacity_bytes < min_size:
                raise StoreError(
                    f"store capacity {capacity_bytes} below minimum {min_size} "
                    "(metadata + 16MB data floor)"
                )
            self._h = self._lib.rt_store_create(
                path.encode(), ctypes.c_uint64(capacity_bytes)
            )
            if not self._h:
                raise StoreError(f"failed to create store arena at {path}")
        else:
            self._h = self._lib.rt_store_attach(path.encode())
            if not self._h:
                raise StoreError(
                    f"failed to attach store arena at {path} "
                    "(missing, corrupt, or client slots exhausted)"
                )
        fd = os.open(path, os.O_RDWR)
        try:
            self._mm = mmap.mmap(fd, 0)
        finally:
            os.close(fd)
        self._mv = memoryview(self._mm)
        self._closed = False
        # pins outstanding in THIS client (zero-copy get() views the user
        # still holds).  The C ledger caps pins+creates at
        # kMaxPinsPerClient=1024; callers consult pin_headroom() to fall
        # back to copy-out gets before the ledger fills.  The lock fences
        # pin finalizers (any thread) against close()'s detach — unpin on
        # a detached handle would be use-after-free.
        self._pins_outstanding = 0
        # RLock, not Lock: critical sections allocate (int boxing, ctypes
        # marshalling), any allocation can trigger cyclic GC, and a
        # collected cycle can finalize a PinnedBuffer whose __del__ ->
        # _unpin re-enters this lock on the SAME thread.  Re-entrant
        # sections are interleave-safe (counter updates are complete
        # statements; after close() sets _closed the C call is skipped).
        self._pin_lock = threading.RLock()
        self._max_pins = int(self._lib.rt_store_max_pins())
        self._created_views: dict = {}  # object_id -> writable view until seal
        # First-touch page faults dominate large writes into fresh arena
        # regions (~0.7 GB/s trap-per-page vs ~6 GB/s on resident pages).
        # MADV_POPULATE_WRITE batch-faults a fresh range in-kernel; the
        # high-water mark keeps the steady state (recycled offsets, pages
        # already resident) at zero madvise overhead.
        self._populate_hw = 0
        self._can_populate = True
        # Inline-put slot slab (data plane v2): per-process batches of
        # pre-registered, pre-faulted fixed-size blocks in power-of-two
        # size classes (256 B .. put_inline_max_bytes, waste ≤ 2x).  A
        # payload under the threshold skips the create/seal round trip
        # entirely — write into a free slot of the smallest fitting
        # class, publish the sealed entry under ONE shard-lock
        # acquisition (rt_store_publish_slot).  Replenished in batches so
        # the allocator lock and the first-touch page faults are paid once
        # per batch, not per put (BENCH.md multi-client terms (a)+(b)).
        self._slab_lock = threading.Lock()
        self._slab_classes: dict = {}       # slot_size -> [free offsets]
        self._slab_pending: dict = {}       # oid -> (off, view, slot_size)
        self._slab_max = -1                 # -1 until sized from config
        self._slab_disabled = False         # arena pressure: fall back
        self._slab_misses = 0               # skips since disable (re-probe)
        self._slab_hits = 0                 # reservations served by slab

    # -- write path ------------------------------------------------------
    def _put_fault_check(self, object_id: bytes) -> None:
        """Chaos site ``store.put``: fires once per put/reserve attempt —
        the same point v1's create() fired — so seeded traces are
        unchanged by the vectored/inline rebuild."""
        fault_ctl = faults.ACTIVE  # bind once: clear() races the check
        if fault_ctl is not None:
            # an injected arena-pressure failure — callers must survive
            # it exactly like a genuinely full arena (spill request +
            # bounded retry in _write_to_store)
            plan = fault_ctl.hit(faults.SITE_STORE_PUT, object_id.hex())
            if plan is not None and plan.action == "error":
                raise StoreFullError(
                    f"injected arena put failure for {object_id.hex()[:12]}"
                )

    def create(self, object_id: bytes, size: int) -> memoryview:
        """Reserve space; returns a writable view. Must seal() or abort()."""
        object_id = _check_id(object_id)
        self._put_fault_check(object_id)
        return self._create_raw(object_id, size)

    def _create_raw(self, object_id: bytes, size: int) -> memoryview:
        off = ctypes.c_uint64()
        rc = self._lib.rt_store_create_object(
            self._h, object_id, ctypes.c_uint64(size), ctypes.byref(off)
        )
        if rc == RT_EXISTS:
            raise ObjectExistsError(object_id.hex())
        if rc == RT_NO_SPACE:
            raise StoreFullError(
                f"object of {size} bytes does not fit (capacity {self.capacity})"
            )
        if rc != RT_OK:
            raise StoreError(f"create failed: {_rc_name(rc)}")
        end = off.value + size
        if self._can_populate and end > self._populate_hw:
            start = max(off.value, self._populate_hw) & ~0xFFF
            try:
                # MADV_POPULATE_WRITE == 23 (Linux 5.14+); mmap.py lacks
                # the constant on this Python build
                self._mm.madvise(23, start, min(len(self._mm), end) - start)
            except (OSError, ValueError):
                self._can_populate = False  # older kernel: fall back to traps
            self._populate_hw = end
        view = self._mv[off.value : off.value + size]
        self._created_views[bytes(object_id)] = view
        return view

    def seal(self, object_id: bytes) -> None:
        object_id = _check_id(object_id)
        rc = self._lib.rt_store_seal(self._h, object_id)
        if rc != RT_OK:
            raise StoreError(f"seal failed: {_rc_name(rc)}")
        v = self._created_views.pop(bytes(object_id), None)
        if v is not None:
            v.release()

    def abort(self, object_id: bytes) -> None:
        object_id = _check_id(object_id)
        with self._slab_lock:
            pend = self._slab_pending.pop(object_id, None)
            if pend is not None:
                # slab reservation: the slot goes back to the freelist —
                # nothing was published, the index never saw the id
                off, view, slot_size = pend
                view.release()
                self._slab_classes.setdefault(slot_size, []).append(off)
                return
        self._lib.rt_store_abort(self._h, object_id)
        v = self._created_views.pop(bytes(object_id), None)
        if v is not None:
            v.release()

    # -- vectored single-pass put path (data plane v2) --------------------
    #
    # reserve() → write payload into the returned view → commit().  Small
    # payloads ride the pre-registered inline slab (one shard-lock publish,
    # no create/seal round trip, pages pre-faulted at batch-reserve time);
    # everything else rides create + the atomic protect+seal (seal2).  The
    # ``store.put`` chaos site fires once per reserve attempt, exactly
    # where v1's create() fired.

    _SLAB_MIN_CLASS = 256  # smallest slot class (bytes)

    def _slab_threshold(self) -> int:
        if self._slab_max >= 0:
            return self._slab_max
        from ray_tpu_torch.common.config import cfg

        self._slab_max = max(0, cfg.put_inline_max_bytes)
        return self._slab_max

    @classmethod
    def _slab_class(cls, size: int) -> int:
        """Smallest power-of-two slot class holding ``size`` (waste
        stays under 2x the payload, not a full max-size slot)."""
        c = cls._SLAB_MIN_CLASS
        while c < size:
            c <<= 1
        return c

    def _slab_refill_locked(self, slot_size: int) -> bool:
        """Reserve a fresh batch of ``slot_size`` slots (caller holds
        _slab_lock)."""
        from ray_tpu_torch.common.config import cfg

        batch = max(1, cfg.put_inline_slab_slots)
        offs = (ctypes.c_uint64 * batch)()
        got = self._lib.rt_store_reserve_slots(
            self._h, slot_size, batch, offs,
        )
        if not got:
            # arena pressure or ledger full: disable, re-probe after a
            # while (puts fall back to the evicting create path meanwhile)
            self._slab_disabled = True
            self._slab_misses = 0
            return False
        free = self._slab_classes.setdefault(slot_size, [])
        for i in range(got):
            off = offs[i]
            # touch-ahead: batch-fault the slot's pages ONCE here so no
            # put ever pays a first-touch trap (multi-client term (a)).
            # Gated on the same populate high-water mark the create path
            # keeps: recycled offsets are already resident, and an
            # madvise syscall per refilled slot on resident pages was
            # measurable against the slab's own win.
            end = off + slot_size
            if self._can_populate and end > self._populate_hw:
                try:
                    start = max(off, self._populate_hw) & ~0xFFF
                    self._mm.madvise(
                        23, start, min(len(self._mm), end) - start,
                    )
                except (OSError, ValueError):
                    self._can_populate = False
                self._populate_hw = end
            free.append(off)
        return True

    def set_slab_enabled(self, enabled: bool) -> None:
        """Force the inline slab off (sticky — no pressure re-probe) or
        re-arm it; the bench matrix's `_noinline` twin and tests use
        this to isolate the fast path."""
        if not enabled:
            self.shrink_slab()
            self._slab_forced_off = True
        else:
            self._slab_forced_off = False
            with self._slab_lock:
                self._slab_disabled = False
                self._slab_misses = 0

    _slab_forced_off = False

    def _slab_reserve(self, object_id: bytes, size: int):
        """A writable slot view for a small payload, or None (fall back)."""
        if self._slab_forced_off:
            return None
        with self._slab_lock:
            if self._slab_disabled:
                self._slab_misses += 1
                if self._slab_misses < 512:
                    return None
                # re-probe: pressure may have passed (spill/eviction)
                self._slab_disabled = False
            slot_size = self._slab_class(size)
            free = self._slab_classes.get(slot_size)
            if not free:
                if not self._slab_refill_locked(slot_size):
                    return None
                free = self._slab_classes[slot_size]
            off = free.pop()
            view = self._mv[off : off + size]
            self._slab_pending[object_id] = (off, view, slot_size)
            self._slab_hits += 1
            return view

    def shrink_slab(self) -> int:
        """Give free (unused) reserved slots back to the allocator —
        called under arena pressure before asking the raylet to spill.
        Returns the number of slots released."""
        with self._slab_lock:
            slots = [
                off for free in self._slab_classes.values() for off in free
            ]
            self._slab_classes.clear()
            self._slab_disabled = True
            self._slab_misses = 0
            if not slots:
                return 0
            offs = (ctypes.c_uint64 * len(slots))(*slots)
        self._lib.rt_store_release_slots(self._h, offs, len(slots))
        return len(slots)

    def reserve(self, object_id: bytes, size: int) -> memoryview:
        """Reserve space for a put; write the payload into the returned
        view, then commit() (or abort()).  Small payloads land in a
        pre-faulted inline slab slot; large ones in a fresh allocation."""
        object_id = _check_id(object_id)
        self._put_fault_check(object_id)
        if 0 < size <= self._slab_threshold():
            view = self._slab_reserve(object_id, size)
            if view is not None:
                return view
        return self._create_raw(object_id, size)

    def commit(self, object_id: bytes, *, protect: bool = False) -> None:
        """Make a reserved object visible: slab reservations publish the
        sealed entry in one shard-lock acquisition; created ones seal with
        the primary-copy flag applied atomically (no protect-vs-evict
        window, one lock round trip instead of protect + seal)."""
        object_id = _check_id(object_id)
        with self._slab_lock:
            pend = self._slab_pending.pop(object_id, None)
        if pend is not None:
            off, view, slot_size = pend
            size = view.nbytes
            rc = self._lib.rt_store_publish_slot(
                self._h, object_id, off, size, 1 if protect else 0,
            )
            if rc == RT_OK:
                view.release()
                return
            if rc == RT_EXISTS:
                # the slot went back to our slab ledger C-side; surface
                # the duplicate like create() would have
                view.release()
                with self._slab_lock:
                    self._slab_classes.setdefault(
                        slot_size, []
                    ).append(off)
                raise ObjectExistsError(object_id.hex())
            if rc == RT_NO_SPACE:
                # shard sub-table full: fall back through the evicting
                # create path.  The slot returns to the freelist only
                # AFTER the payload is copied out of it (a concurrent
                # reserve must not recycle it mid-read), and on a packed
                # arena (StoreFullError from create) the pending entry is
                # restored so the caller can spill and retry commit().
                try:
                    buf = self._create_raw(object_id, size)
                except StoreFullError:
                    with self._slab_lock:
                        self._slab_pending[object_id] = pend
                    raise
                except BaseException:
                    # duplicate/hard failure: commit is over either way,
                    # so the slot goes home
                    view.release()
                    with self._slab_lock:
                        self._slab_classes.setdefault(
                            slot_size, []
                        ).append(off)
                    raise
                try:
                    buf[:] = self._mv[off : off + size]
                    self._seal2(object_id, protect)
                finally:
                    view.release()
                    with self._slab_lock:
                        self._slab_classes.setdefault(
                            slot_size, []
                        ).append(off)
                return
            raise StoreError(f"publish failed: {_rc_name(rc)}")
        self._seal2(object_id, protect)

    def _seal2(self, object_id: bytes, protect: bool) -> None:
        rc = self._lib.rt_store_seal2(
            self._h, object_id, 1 if protect else 0
        )
        if rc != RT_OK:
            raise StoreError(f"seal failed: {_rc_name(rc)}")
        v = self._created_views.pop(bytes(object_id), None)
        if v is not None:
            v.release()

    def put(self, object_id: bytes, data, *, protect: bool = False) -> None:
        """One-shot single-pass put: reserve + one copy + commit (the
        single-segment case of ``put_vectored``).  ``protect=True``
        applies the primary-copy flag atomically with the seal/publish,
        so the entry is never LRU-evictable in between."""
        self.put_vectored(object_id, (data,), protect=protect)

    def put_vectored(self, object_id: bytes, segments, *,
                     protect: bool = False) -> int:
        """Single-pass put of one or more buffer segments written back to
        back through the reserve→write→commit flow, never concatenated
        into an intermediate bytes.  ``put`` (raylet pulls, spill
        restore, collective shm handoff) is the one-segment case.
        Returns total bytes written."""
        views = [
            m if m.format == "B" and m.ndim == 1 else m.cast("B")
            for m in map(memoryview, segments)
        ]
        total = sum(v.nbytes for v in views)
        buf = self.reserve(object_id, total)
        try:
            off = 0
            for v in views:
                buf[off : off + v.nbytes] = v
                off += v.nbytes
        except BaseException:
            self.abort(object_id)
            raise
        self.commit(object_id, protect=protect)
        return total

    # -- read path -------------------------------------------------------
    def get(self, object_id: bytes) -> Optional[PinnedBuffer]:
        """Zero-copy pinned view of a sealed object, or None if absent."""
        object_id = _check_id(object_id)
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        rc = self._lib.rt_store_get(
            self._h, object_id, ctypes.byref(off), ctypes.byref(size)
        )
        if rc in (RT_NOT_FOUND, RT_NOT_SEALED):
            return None
        if rc != RT_OK:
            raise StoreError(f"get failed: {_rc_name(rc)}")
        view = self._mv[off.value : off.value + size.value]
        pin = PinnedBuffer(self, object_id, view)
        with self._pin_lock:
            self._pins_outstanding += 1
        return pin

    def pin_headroom(self) -> int:
        """Ledger slots left before pins would starve creates.  The C
        ledger is shared by held pins AND unsealed creates
        (rt_store_max_pins slots per client), so both count."""
        with self._pin_lock:
            return (
                self._max_pins
                - self._pins_outstanding
                - len(self._created_views)
            )

    def contains(self, object_id: bytes) -> bool:
        object_id = _check_id(object_id)
        return bool(self._lib.rt_store_contains(self._h, object_id))

    def delete(self, object_id: bytes) -> bool:
        object_id = _check_id(object_id)
        rc = self._lib.rt_store_delete(self._h, object_id)
        return rc == RT_OK

    def _unpin(self, object_id: bytes) -> None:
        # under the lock: a finalizer-thread unpin racing close() must
        # not reach the C handle after rt_store_detach munmaps it
        with self._pin_lock:
            self._pins_outstanding -= 1
            if not self._closed:
                self._lib.rt_store_unpin(self._h, object_id)

    # -- admin -----------------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.stats()["capacity"]

    def stats(self) -> dict:
        cap, used, objs, evs = (ctypes.c_uint64() for _ in range(4))
        self._lib.rt_store_stats(
            self._h, ctypes.byref(cap), ctypes.byref(used),
            ctypes.byref(objs), ctypes.byref(evs),
        )
        return {
            "capacity": cap.value,
            "used": used.value,
            "objects": objs.value,
            "evictions": evs.value,
            # process-local: inline-slab reservations served since open
            # (the data-plane pin for "small puts ride the slab")
            "slab_hits": self._slab_hits,
        }

    def reap(self) -> int:
        """Release pins held by dead client processes; returns clients reaped."""
        return self._lib.rt_store_reap(self._h)

    def protect(self, object_id: bytes, on: bool = True) -> bool:
        """Mark/unmark an object as a primary copy: LRU eviction skips
        protected entries, so the only copy of a value can never vanish
        silently — the raylet's spill manager writes protected entries to
        disk under memory pressure instead (reference role:
        local_object_manager.h pinned-primary + spill).

        Returns True iff the flag was applied.  False means the object is
        gone (deleted/evicted between create and protect, or a bad id) —
        callers that rely on the primary surviving LRU must check."""
        object_id = _check_id(object_id)
        rc = self._lib.rt_store_protect(self._h, object_id, 1 if on else 0)
        return rc == 0

    def list_spillable(self, max_n: int = 4096) -> list:
        """(object_id, size) of sealed, unpinned, protected entries in
        LRU order — the spill manager's victim candidates."""
        ids = (ctypes.c_uint8 * (16 * max_n))()
        sizes = (ctypes.c_uint64 * max_n)()
        n = self._lib.rt_store_list_spillable(
            self._h, ids, sizes, ctypes.c_uint64(max_n)
        )
        raw = bytes(ids)
        return [(raw[i * 16:(i + 1) * 16], sizes[i]) for i in range(n)]

    def close(self) -> None:
        if self._closed:
            return
        # Outstanding pins back zero-copy get() views the USER still
        # holds — do not force-release them; their owners' GC will (and
        # after _closed is set, their _unpin becomes a no-op).  Plasma
        # has the same contract: buffers read after client disconnect
        # are valid only until another attached client reuses the range
        # (a standalone shutdown tears the whole store down, so the
        # common case stays safe).
        for v in self._created_views.values():
            v.release()
        self._created_views.clear()
        with self._slab_lock:
            # unpublished slab reservations + free slots: views must drop
            # before the mmap closes; the block offsets themselves are
            # reclaimed by rt_store_detach's client-ledger release
            for _off, v, _cls in self._slab_pending.values():
                v.release()
            self._slab_pending.clear()
            self._slab_classes.clear()
        try:
            self._mv.release()
            self._mm.close()
        except BufferError:
            # live zero-copy views export the map; it must outlive them.
            # Leave it to process teardown — detaching the client ledger
            # below is what releases store-side state.
            pass
        with self._pin_lock:
            self._closed = True
            self._lib.rt_store_detach(self._h)

    def destroy(self) -> None:
        self.close()
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


def default_store_path(node_id_hex: str) -> str:
    return f"/dev/shm/rt_store_{node_id_hex[:12]}"


def default_capacity() -> int:
    from ray_tpu_torch.common.config import cfg

    if cfg.object_store_bytes:
        size = cfg.object_store_bytes
    else:
        try:
            st = os.statvfs("/dev/shm")
            avail = st.f_bavail * st.f_frsize
        except OSError:
            avail = 1 << 30
        size = min(int(avail * 0.3), cfg.object_store_auto_cap_bytes)
    return max(size, _get_lib().rt_store_min_size())
