"""Mutable shared-memory channels for compiled DAG execution.

Role-equivalent of the reference's experimental mutable-object channels
(ray: src/ray/core_worker/experimental_mutable_object_manager.cc,
python/ray/experimental/channel/shared_memory_channel.py): a reusable
fixed-capacity shm segment written and read in place every DAG
iteration, skipping the per-call task-submission path entirely.

Design differences from the reference (daemon-less):
- A channel is a plain file in ``/dev/shm`` mmapped by both ends -- no
  raylet involvement, matching the port's daemon-less shm arena design
  (`ray_tpu_torch/_native/shm_store.cc`).
- Single-producer / single-consumer with a seqlock-style header; fan-out
  is expressed as one channel per consumer edge (the compiler allocates
  them), mirroring how the reference registers one reader ref per
  downstream actor.
- Channels carry host bytes and are host-local: a CUDA tensor crosses one
  as a CPU tensor (the serializer copies it to the host), and the
  reference's NCCL channel variant has no counterpart here.

The wire format is the JAX package's byte for byte (a channel written by
one package reads in the other).

Wire format per slot::

    header (32 B): u32 state | u32 pad | u64 length | u64 seq | u64 cap
    payload (cap B)

state transitions: EMPTY -w-> FULL -r-> EMPTY; either side -> CLOSED.
"""

from __future__ import annotations

import mmap
import os
import struct
import time
import uuid
from typing import Optional

_HDR = struct.Struct("<IIQQQ")
HEADER_BYTES = _HDR.size  # 32

EMPTY, FULL, CLOSED = 0, 1, 2

_SHM_DIR = "/dev/shm"


class ChannelClosedError(RuntimeError):
    """The peer closed the channel (DAG teardown or actor death)."""


class ChannelTimeoutError(TimeoutError):
    pass


def _poll_sleep(i: int) -> None:
    # spin briefly, then back off to bounded sleeps: DAG iterations are
    # sub-millisecond when hot, but a blocked pipeline should not burn a
    # core indefinitely.
    if i < 200:
        time.sleep(0)
    elif i < 2000:
        time.sleep(50e-6)
    else:
        time.sleep(1e-3)


class Channel:
    """One SPSC mutable channel. Create once (driver), open anywhere."""

    def __init__(self, name: str, capacity: int, create: bool = False):
        self.name = name
        self.capacity = capacity
        self.path = os.path.join(_SHM_DIR, name)
        total = HEADER_BYTES + capacity
        if create:
            fd = os.open(self.path, os.O_CREAT | os.O_EXCL | os.O_RDWR, 0o600)
            try:
                os.ftruncate(fd, total)
                self._mm = mmap.mmap(fd, total)
            finally:
                os.close(fd)
            _HDR.pack_into(self._mm, 0, EMPTY, 0, 0, 0, capacity)
        else:
            fd = os.open(self.path, os.O_RDWR)
            try:
                self._mm = mmap.mmap(fd, total)
            finally:
                os.close(fd)

    # -- header access ------------------------------------------------

    def _state(self) -> int:
        return _HDR.unpack_from(self._mm, 0)[0]

    def _set_state(self, s: int) -> None:
        struct.pack_into("<I", self._mm, 0, s)

    # -- data path ----------------------------------------------------

    def write(self, data: bytes, timeout: Optional[float] = None,
              liveness=None) -> None:
        """Block until the slot is EMPTY, then publish `data`.

        `liveness`, if given, is called periodically while blocked and may
        raise (used by the driver to surface a dead exec loop instead of
        hanging forever on a channel nobody will drain).
        """
        n = len(data)
        if n > self.capacity:
            raise ValueError(
                f"value of {n} bytes exceeds channel capacity "
                f"{self.capacity}; recompile the DAG with a larger "
                f"buffer_size_bytes"
            )
        deadline = None if timeout is None else time.monotonic() + timeout
        i = 0
        while True:
            st = self._state()
            if st == CLOSED:
                raise ChannelClosedError(f"channel {self.name} is closed")
            if st == EMPTY:
                break
            if deadline is not None and time.monotonic() > deadline:
                raise ChannelTimeoutError(
                    f"timed out writing channel {self.name}"
                )
            if liveness is not None and i and i % 4000 == 0:
                liveness()
            _poll_sleep(i)
            i += 1
        self._mm[HEADER_BYTES:HEADER_BYTES + n] = data
        _, _, _, seq, cap = _HDR.unpack_from(self._mm, 0)
        _HDR.pack_into(self._mm, 0, EMPTY, 0, n, seq + 1, cap)
        # state flips last: payload+length are in place before FULL is
        # visible (x86/ARM store ordering through a single mmap is enough
        # for this SPSC handoff under the GIL's sequential execution).
        self._set_state(FULL)

    def wait_empty(self, timeout: Optional[float] = None,
                   liveness=None) -> None:
        """Block until the slot is EMPTY.  Used by the driver to make a
        multi-channel publish atomic: once every input channel of a DAG
        is EMPTY, the subsequent writes cannot block (the driver is the
        only writer), so a timeout can never leave a partial publish."""
        deadline = None if timeout is None else time.monotonic() + timeout
        i = 0
        while True:
            st = self._state()
            if st == EMPTY:
                return
            if st == CLOSED:
                raise ChannelClosedError(f"channel {self.name} is closed")
            if deadline is not None and time.monotonic() > deadline:
                raise ChannelTimeoutError(
                    f"timed out waiting for channel {self.name} to drain"
                )
            if liveness is not None and i and i % 4000 == 0:
                liveness()
            _poll_sleep(i)
            i += 1

    def read(self, timeout: Optional[float] = None, liveness=None) -> bytes:
        deadline = None if timeout is None else time.monotonic() + timeout
        i = 0
        while True:
            st = self._state()
            if st == FULL:
                break
            if st == CLOSED:
                raise ChannelClosedError(f"channel {self.name} is closed")
            if deadline is not None and time.monotonic() > deadline:
                raise ChannelTimeoutError(
                    f"timed out reading channel {self.name}"
                )
            if liveness is not None and i and i % 4000 == 0:
                liveness()
            _poll_sleep(i)
            i += 1
        length = _HDR.unpack_from(self._mm, 0)[2]
        data = bytes(self._mm[HEADER_BYTES:HEADER_BYTES + length])
        self._set_state(EMPTY)
        return data

    # -- lifecycle ----------------------------------------------------

    def close(self) -> None:
        try:
            self._set_state(CLOSED)
        except ValueError:  # mmap already closed
            pass

    def detach(self) -> None:
        try:
            self._mm.close()
        except Exception:
            pass

    def unlink(self) -> None:
        self.detach()
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


def make_channel_name() -> str:
    return f"rtdag-{uuid.uuid4().hex[:16]}"
