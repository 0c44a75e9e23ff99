"""Unique identifiers for cluster entities.

Equivalent in role to the reference's ID types (ray: src/ray/common/id.h) but
designed fresh: every ID is a 16-byte value; the kind lives in the Python
type (and in message field position on the wire), not in the bytes.
ObjectIDs are *derived* from the producing TaskID plus a return index, which
keeps lineage reconstruction possible without a separate table (ray:
common/id.h ObjectID::FromIndex analogue).
"""

from __future__ import annotations

import hashlib
import os
import struct

_ID_LEN = 16  # bytes on the wire (kind lives in the Python type only)


class BaseID:
    """Immutable 16-byte identifier."""

    KIND = 0x00
    __slots__ = ("_bin",)

    def __init__(self, binary: bytes):
        if len(binary) != _ID_LEN:
            raise ValueError(
                f"{type(self).__name__} requires {_ID_LEN} bytes, got {len(binary)}"
            )
        self._bin = bytes(binary)

    @classmethod
    def random(cls) -> "BaseID":
        return cls(os.urandom(_ID_LEN))

    @classmethod
    def nil(cls) -> "BaseID":
        return cls(b"\x00" * _ID_LEN)

    @classmethod
    def from_hex(cls, h: str) -> "BaseID":
        return cls(bytes.fromhex(h))

    def is_nil(self) -> bool:
        return self._bin == b"\x00" * _ID_LEN

    def binary(self) -> bytes:
        return self._bin

    def hex(self) -> str:
        return self._bin.hex()

    def __hash__(self):
        return hash((self.KIND, self._bin))

    def __eq__(self, other):
        return (
            isinstance(other, BaseID)
            and other.KIND == self.KIND
            and other._bin == self._bin
        )

    def __lt__(self, other):
        return self._bin < other._bin

    def __repr__(self):
        return f"{type(self).__name__}({self._bin.hex()[:12]}…)"

    def __reduce__(self):
        return (type(self), (self._bin,))


class JobID(BaseID):
    __slots__ = ()  # no per-instance dict (ids are hot-path objects)
    KIND = 0x01


class NodeID(BaseID):
    __slots__ = ()  # no per-instance dict (ids are hot-path objects)
    KIND = 0x02


class WorkerID(BaseID):
    __slots__ = ()  # no per-instance dict (ids are hot-path objects)
    KIND = 0x03


class ActorID(BaseID):
    __slots__ = ()  # no per-instance dict (ids are hot-path objects)
    KIND = 0x04


class TaskID(BaseID):
    __slots__ = ()  # no per-instance dict (ids are hot-path objects)
    KIND = 0x05

    @classmethod
    def for_actor_creation(cls, actor_id: ActorID) -> "TaskID":
        d = hashlib.blake2b(b"actor_creation:" + actor_id.binary(), digest_size=_ID_LEN)
        return cls(d.digest())


def task_return_binary(task_id: bytes, index: int) -> bytes:
    """Raw bytes of ObjectID.for_task_return without constructing either
    ID instance — the submission hot path derives return oids straight
    from the 16-byte task id it already holds."""
    return hashlib.blake2b(
        task_id + struct.pack("<I", index), digest_size=_ID_LEN
    ).digest()


class ObjectID(BaseID):
    __slots__ = ()  # no per-instance dict (ids are hot-path objects)
    KIND = 0x06

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        return cls(task_return_binary(task_id.binary(), index))

    @classmethod
    def for_put(cls, worker_id: WorkerID, put_index: int) -> "ObjectID":
        d = hashlib.blake2b(
            b"put:" + worker_id.binary() + struct.pack("<Q", put_index),
            digest_size=_ID_LEN,
        )
        return cls(d.digest())


class PlacementGroupID(BaseID):
    __slots__ = ()  # no per-instance dict (ids are hot-path objects)
    KIND = 0x07
