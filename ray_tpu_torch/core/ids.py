"""Unique identifiers for objects, tasks, actors, nodes, jobs and workers.

TPU-native analogue of the reference's ID scheme (reference:
``src/ray/common/id.h`` and ``src/ray/design_docs/id_specification.md``).
We keep the load-bearing property — IDs are fixed-width random byte strings,
cheap to hash, copy and ship over the wire — but drop the reference's
task-index/put-index bit-packing: object identity here is purely random
because ownership metadata travels alongside the ref (see
``ray_tpu_torch.core.object_ref.ObjectRef``).
"""

from __future__ import annotations

import os
import threading

_ID_NBYTES = 16


class BaseID:
    """A fixed-width, immutable, hashable identifier."""

    __slots__ = ("_bytes", "_hash")

    NBYTES = _ID_NBYTES

    def __init__(self, id_bytes: bytes):
        if not isinstance(id_bytes, bytes) or len(id_bytes) != self.NBYTES:
            raise ValueError(
                f"{type(self).__name__} requires {self.NBYTES} bytes, got {id_bytes!r}"
            )
        self._bytes = id_bytes
        self._hash = hash((type(self).__name__, id_bytes))

    @classmethod
    def from_random(cls):
        return cls(os.urandom(cls.NBYTES))

    @classmethod
    def from_hex(cls, hex_str: str):
        return cls(bytes.fromhex(hex_str))

    @classmethod
    def nil(cls):
        return cls(b"\x00" * cls.NBYTES)

    def is_nil(self) -> bool:
        return self._bytes == b"\x00" * self.NBYTES

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        return self._bytes.hex()

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return type(other) is type(self) and other._bytes == self._bytes

    def __repr__(self):
        return f"{type(self).__name__}({self._bytes.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class ObjectID(BaseID):
    pass


class TaskID(BaseID):
    pass


class ActorID(BaseID):
    pass


class NodeID(BaseID):
    pass


class JobID(BaseID):
    NBYTES = 4


class WorkerID(BaseID):
    pass


class PlacementGroupID(BaseID):
    pass


class _Counter:
    """Thread-safe monotonically increasing counter (for seq numbers)."""

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._value += 1
            return self._value
