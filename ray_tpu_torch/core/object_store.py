"""Owner-side in-process object store.

Analogue of the reference's ``CoreWorkerMemoryStore``
(``src/ray/core_worker/store_provider/memory_store/memory_store.h:43``): every
process holds the values it owns (task returns, ``put`` objects) — or, for
values that landed in the node's shared-memory store, a locator — and serves
them to remote borrowers over its RPC server. Entries are created *pending*
at task-submission time and fulfilled when the task replies, so ``get`` is a
wait on an event, and remote processes can long-poll the owner.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

from ray_tpu_torch.core.errors import ObjectFreedError, GetTimeoutError
from ray_tpu_torch.core.ids import ObjectID


class _Entry:
    __slots__ = ("event", "data", "shm_ref", "shm_view", "shm_pin", "error",
                 "freed", "owned", "refcount", "holders", "zero_since",
                 "nested")

    def __init__(self):
        self.event = threading.Event()
        self.data: Optional[bytes] = None      # serialized frame (inline path)
        self.shm_ref = None                    # shm locator dict (shm path)
        self.shm_view = None                   # pinned local ShmView, if open
        self.shm_pin = None                    # owner's primary-copy pin
        self.error: Optional[BaseException] = None  # submission-level failure
        self.freed = False
        self.owned = False        # True: this process owns the object
        self.refcount = 0         # cluster-wide handle count (owner-side)
        # The same count split by the process that sent it (its RPC
        # address): refcount is their sum, and a holder that dies has its
        # share dropped (drop_holder).
        self.holders: Dict[Any, int] = {}
        self.zero_since: Optional[float] = None  # when refcount hit <= 0
        # ObjectRefs nested inside this entry's serialized frame: held as
        # live handles so the inner objects can't be freed while the frame
        # is alive (cleared on free/drop).
        self.nested = None


class MemoryStore:
    def __init__(self):
        self._entries: Dict[ObjectID, _Entry] = {}
        self._lock = threading.Lock()
        # Inline serialized bytes held by this store (shm-resident
        # values are accounted by the node store). Maintained at the
        # put/free/drop sites so the metrics collector reads a plain
        # int instead of walking every entry.
        self._data_bytes = 0

    def data_bytes(self) -> int:
        with self._lock:
            return self._data_bytes

    def _entry(self, oid: ObjectID) -> _Entry:
        with self._lock:
            entry = self._entries.get(oid)
            if entry is None:
                entry = _Entry()
                self._entries[oid] = entry
            return entry

    def create_pending(self, oid: ObjectID) -> None:
        self._entry(oid).owned = True

    def reset_pending(self, oid: ObjectID) -> None:
        """Re-arm an entry for reconstruction: the producing task will be
        re-executed and fulfil it again (reference:
        object_recovery_manager.h:96 resubmit path)."""
        with self._lock:
            entry = self._entries.get(oid)
            if entry is None:
                entry = _Entry()
                self._entries[oid] = entry
            entry.owned = True
            if entry.data is not None:
                self._data_bytes -= len(entry.data)
            entry.data = None
            entry.shm_ref = None
            if entry.shm_view is not None:
                entry.shm_view.release()
                entry.shm_view = None
            if entry.shm_pin is not None:
                entry.shm_pin.release()
                entry.shm_pin = None
            entry.error = None
            entry.freed = False
            entry.nested = None
            entry.event.clear()

    def apply_ref_update(self, oid: ObjectID, delta: int,
                         sender=None) -> None:
        """Owner-side handle-count update from a borrower process (or this
        process's own tracker); ``sender`` is the RPC address of the
        process whose handles the delta counts."""
        with self._lock:
            entry = self._entries.get(oid)
            if entry is None:
                if delta <= 0:
                    return
                entry = _Entry()
                self._entries[oid] = entry
            entry.refcount += delta
            key = tuple(sender) if sender is not None else None
            n = entry.holders.get(key, 0) + delta
            if n:
                entry.holders[key] = n
            else:
                entry.holders.pop(key, None)
            self._arm_zero_clock(entry)

    @staticmethod
    def _arm_zero_clock(entry: _Entry) -> None:
        # delta == 0 means a handle lived and died within one tracker
        # flush window: the touch still (re)arms the zero clock.
        if entry.refcount <= 0:
            if entry.zero_since is None:
                entry.zero_since = time.monotonic()
        else:
            entry.zero_since = None

    def drop_holder(self, addr) -> int:
        """Forget every handle the process at ``addr`` held: it died, so it
        will never send their decrements (reference: the owner's
        ReferenceCounter dropping a dead borrower's references). Returns
        how many entries it held."""
        key = tuple(addr)
        hit = 0
        with self._lock:
            for entry in self._entries.values():
                n = entry.holders.pop(key, 0)
                if n:
                    hit += 1
                    entry.refcount -= n
                    self._arm_zero_clock(entry)
        return hit

    def sweep_dead_refs(self, grace_s: float):
        """Collect owned, ready objects whose handle count has been zero for
        longer than ``grace_s``. Returns the freed entries' (oid, shm_ref)
        pairs so the caller can propagate the free to the node store."""
        now = time.monotonic()
        victims = []
        with self._lock:
            for oid, entry in list(self._entries.items()):
                if (entry.owned and not entry.freed
                        and entry.refcount <= 0
                        and entry.zero_since is not None
                        and now - entry.zero_since > grace_s
                        and entry.event.is_set()):
                    victims.append((oid, entry.shm_ref))
        return victims

    def put_serialized(self, oid: ObjectID, data: bytes) -> None:
        entry = self._entry(oid)
        with self._lock:
            if entry.data is not None:
                self._data_bytes -= len(entry.data)
            entry.data = data
            self._data_bytes += len(data)
        entry.event.set()

    def put_shm(self, oid: ObjectID, shm_ref) -> None:
        entry = self._entry(oid)
        entry.shm_ref = shm_ref
        entry.event.set()

    def put_error(self, oid: ObjectID, error: BaseException) -> None:
        entry = self._entry(oid)
        entry.error = error
        entry.event.set()

    def is_ready(self, oid: ObjectID) -> bool:
        with self._lock:
            entry = self._entries.get(oid)
        return entry is not None and entry.event.is_set()

    def contains(self, oid: ObjectID) -> bool:
        with self._lock:
            return oid in self._entries

    def wait_ready(self, oid: ObjectID, timeout: Optional[float]) -> _Entry:
        entry = self._entry(oid)
        if not entry.event.wait(timeout):
            raise GetTimeoutError(
                f"Object {oid.hex()} not ready within {timeout}s")
        if entry.freed:
            raise ObjectFreedError(f"Object {oid.hex()} was freed")
        if entry.error is not None:
            raise entry.error
        return entry

    def put_shm_ref(self, oid: ObjectID, shm_ref: dict) -> None:
        entry = self._entry(oid)
        entry.shm_ref = shm_ref
        entry.event.set()

    def mark_owned(self, oid: ObjectID) -> None:
        self._entry(oid).owned = True

    def free(self, oid: ObjectID) -> None:
        with self._lock:
            entry = self._entries.get(oid)
            if entry is None:
                return
            if entry.data is not None:
                self._data_bytes -= len(entry.data)
            entry.data = None
            entry.shm_ref = None
            if entry.shm_view is not None:
                entry.shm_view.release()
                entry.shm_view = None
            if entry.shm_pin is not None:
                entry.shm_pin.release()
                entry.shm_pin = None
            entry.nested = None
            entry.freed = True
            if entry.zero_since is None:
                entry.zero_since = time.monotonic()
            entry.event.set()

    def drop(self, oid: ObjectID) -> None:
        """Release a borrower-cache entry entirely (pins, views, dict slot) so
        a later get re-pulls from the owner. No-op for owned objects."""
        with self._lock:
            entry = self._entries.get(oid)
            if entry is None or entry.owned:
                return
            if entry.shm_view is not None:
                entry.shm_view.release()
                entry.shm_view = None
            if entry.shm_pin is not None:
                entry.shm_pin.release()
                entry.shm_pin = None
            if entry.data is not None:
                self._data_bytes -= len(entry.data)
            entry.nested = None
            del self._entries[oid]

    def delete(self, oid: ObjectID) -> None:
        with self._lock:
            entry = self._entries.pop(oid, None)
            if entry is not None and entry.data is not None:
                self._data_bytes -= len(entry.data)

    def set_nested(self, oid: ObjectID, refs) -> None:
        if refs:
            self._entry(oid).nested = list(refs)

    def purge_freed(self, ttl_s: float) -> None:
        """Remove long-freed tombstones. A freed object's cluster-wide count
        was zero, so nothing should ask for it again; the tombstone only
        exists to turn late (out-of-band) gets into ObjectFreedError rather
        than a hang, and a TTL bounds that courtesy."""
        now = time.monotonic()
        with self._lock:
            dead = [oid for oid, e in self._entries.items()
                    if e.freed and e.zero_since is not None
                    and now - e.zero_since > ttl_s]
            for oid in dead:
                del self._entries[oid]

    def size(self) -> int:
        with self._lock:
            return len(self._entries)


def wait_any(
    store: MemoryStore,
    oids,
    num_ready: int,
    timeout: Optional[float],
    poll=None,
):
    """Block until ``num_ready`` of ``oids`` are ready locally (or ``poll``
    reports them ready remotely). Returns (ready, not_ready) preserving order.
    Used by ``api.wait`` (reference: ``CoreWorker::Wait``, core_worker.h:804).
    """
    deadline = None if timeout is None else time.monotonic() + timeout
    interval = 0.005
    while True:
        ready = []
        not_ready = []
        for oid in oids:
            if store.is_ready(oid) or (poll is not None and poll(oid)):
                ready.append(oid)
            else:
                not_ready.append(oid)
        done = len(ready) >= num_ready or not not_ready
        if not done and deadline is not None and time.monotonic() >= deadline:
            done = True
        if done:
            # Reference semantics (CoreWorker::Wait): the ready list holds at
            # most num_ready entries; both lists preserve input order.
            chosen = set(ready[:num_ready])
            return ([o for o in oids if o in chosen],
                    [o for o in oids if o not in chosen])
        time.sleep(interval)
        interval = min(interval * 1.5, 0.05)
