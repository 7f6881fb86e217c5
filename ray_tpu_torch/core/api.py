"""The object plane's stand-in: ``put``, ``get`` and ``free`` within the
calling process.

Same contract as ``ray_tpu/core/api.py``'s ``put`` / ``get`` / ``free``,
restricted to one process: ``put`` stores a value and returns a small
picklable ``ObjectRef``; ``get`` returns the value of a ref (or a list of
values for a list of refs); ``free`` drops the values behind refs eagerly.
A ref carries only its id, never the value, so a descriptor holding refs
pickles to a few hundred bytes whatever the payload. ``get`` of a freed
ref raises ``ObjectFreedError`` and of a ref this process never stored
``ObjectLostError``: that is how the decode half of a handoff meets a dead
lease.

The runtime copy (ROADMAP.md queue 1, item 4) replaces the bodies of
these functions with its object store; this module adds no API the JAX
package lacks.
"""

from __future__ import annotations

import itertools
import threading
from collections import OrderedDict
from typing import Any, Dict, Optional

from ray_tpu_torch.core.errors import ObjectFreedError, ObjectLostError


class ObjectRef:
    """Handle of one stored value: its id, nothing else."""

    __slots__ = ("id",)

    def __init__(self, object_id: str):
        self.id = object_id

    def __reduce__(self):
        return (ObjectRef, (self.id,))

    def __eq__(self, other) -> bool:
        return isinstance(other, ObjectRef) and other.id == self.id

    def __hash__(self) -> int:
        return hash(self.id)

    def __repr__(self) -> str:
        return f"ObjectRef({self.id})"


class _Store:
    """The process's values by ref id, and the last ``tombstones`` ids
    freed (a late ``get`` of an older one reads as lost: it raises
    either way)."""

    def __init__(self, tombstones: int = 4096):
        self._lock = threading.Lock()
        self._values: Dict[str, Any] = {}
        self._freed: "OrderedDict[str, None]" = OrderedDict()
        self._tombstones = tombstones
        self._ids = itertools.count(1)

    def put(self, value: Any) -> ObjectRef:
        with self._lock:
            oid = f"obj-{next(self._ids)}"
            self._values[oid] = value
        return ObjectRef(oid)

    def get(self, ref: ObjectRef) -> Any:
        with self._lock:
            if ref.id in self._values:
                return self._values[ref.id]
            if ref.id in self._freed:
                raise ObjectFreedError(f"Object {ref.id} was freed")
        raise ObjectLostError(f"Object {ref.id} is not in this process")

    def free(self, ref: ObjectRef) -> None:
        with self._lock:
            if ref.id in self._values:
                del self._values[ref.id]
                self._freed[ref.id] = None
                if len(self._freed) > self._tombstones:
                    self._freed.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._values)


_store = _Store()


def put(value: Any) -> ObjectRef:
    """Store ``value`` and return its ref."""
    return _store.put(value)


def get(refs, timeout: Optional[float] = None):
    """The value behind ``refs`` (one ref), or the list of values (a list
    of refs). ``timeout`` is accepted for the runtime's contract: a value
    of this process is either stored or gone, so nothing waits."""
    if isinstance(refs, ObjectRef):
        return _store.get(refs)
    return [_store.get(r) for r in refs]


def free(refs) -> None:
    """Eagerly release the values behind ``refs`` (one ref or a list;
    ``None`` entries are skipped). Freeing twice is a no-op."""
    if isinstance(refs, ObjectRef):
        refs = [refs]
    for ref in refs:
        if ref is not None:
            _store.free(ref)

