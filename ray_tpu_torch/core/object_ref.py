"""ObjectRef: a future for a value in the distributed object store.

Analogue of the reference's ``ObjectRef`` (``python/ray/includes/object_ref.pxi``)
with the load-bearing architectural invariant preserved: **ownership**
(reference: SURVEY §1 — the worker that creates a ref by ``.remote()`` or
``put()`` is its owner; it stores the value or knows where it is, and serves
location/value queries). A deserialized ref therefore carries the owner's RPC
address so any process can resolve it without a central directory.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional, Tuple

from ray_tpu_torch.core.ids import ObjectID

logger = logging.getLogger(__name__)

Addr = Tuple[str, int]


class _RefTracker:
    """Per-process ObjectRef handle tracker (the distributed-ref-counting
    client half; reference: ``src/ray/core_worker/reference_count.h:61``).

    Counts live ``ObjectRef`` instances per (owner, object). When a process's
    count for an object goes 0 -> 1 it reports +1 to the owner; 1 -> 0
    reports -1 (so the owner's count is "number of processes holding
    handles"). Updates are batched and flushed by a daemon thread — the
    owner-side free grace period absorbs the flush latency. On a local
    1 -> 0 for a *borrowed* object the borrower also drops its cached copy,
    releasing the pinned shm view."""

    _instance: Optional["_RefTracker"] = None
    _instance_lock = threading.Lock()

    def __init__(self):
        import collections

        self._lock = threading.Lock()
        self._counts: Dict[Tuple[Addr, bytes], int] = {}
        self._dirty: Dict[Addr, Dict[bytes, int]] = {}
        # Decrements from __del__ land here WITHOUT taking any lock: a
        # destructor can fire from the GC in the middle of a thread that
        # already holds self._lock (deque.append is atomic under the GIL).
        self._pending_decs = collections.deque()
        self._send_failures: Dict[Addr, int] = {}
        self._wake = threading.Event()
        # Live-handle gauge published at snapshot time: monotonic growth
        # of this number is the ref-leak signature `ray_tpu doctor`
        # attributes back to the owning process.
        from ray_tpu_torch.util import metrics as um

        um.add_collector(self._collect_metrics)
        self._thread = threading.Thread(
            target=self._flush_loop, name="ref-tracker", daemon=True)
        self._thread.start()

    def _collect_metrics(self) -> None:
        from ray_tpu_torch.core.config import config
        from ray_tpu_torch.core.coremetrics import OBJ_LIVE_REFS

        if config.core_metrics_enabled:
            with self._lock:
                n = len(self._counts)
            OBJ_LIVE_REFS.set(float(n))

    @classmethod
    def get(cls) -> "_RefTracker":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    def inc(self, owner: Addr, oid: bytes) -> None:
        apply_local = False
        with self._lock:
            key = (owner, oid)
            n = self._counts.get(key, 0) + 1
            self._counts[key] = n
            if n == 1:
                if self._is_local_owner(owner):
                    # Owner-local +1 applies SYNCHRONOUSLY, not via the
                    # batched flush: under full-suite load the flush
                    # thread can be starved past ref_free_grace_s, and a
                    # borrower's net-zero touch (+1/-1 in one window)
                    # would then arm the owner's zero-clock while our own
                    # +1 still sat in _dirty — the sweeper frees an
                    # object the driver is about to get()
                    # (ObjectFreedError under load). Matching decs stay
                    # batched: they only ever run after this inc.
                    apply_local = True
                else:
                    d = self._dirty.setdefault(owner, {})
                    d[oid] = d.get(oid, 0) + 1
        if apply_local:
            self._apply_local(owner, {oid: 1})

    def dec(self, owner: Addr, oid: bytes) -> None:
        """GC-safe: only enqueues; the flush thread does the bookkeeping.
        Decrements NEVER apply synchronously — a batched -1 only delays
        a free, while a batched +1 can lose a race against the owner's
        grace sweeper (see inc)."""
        self._pending_decs.append((owner, oid))
        self._wake.set()

    @staticmethod
    def _is_local_owner(owner: Addr) -> bool:
        from ray_tpu_torch.core import runtime

        core = runtime._core_worker
        return core is not None and tuple(owner) == tuple(core.addr)

    def _apply_local(self, owner: Addr, deltas: Dict[bytes, int]) -> None:
        """Apply owner-local deltas straight to the store; fall back to
        the batched dirty map if the core vanished mid-flight (shutdown
        between the locked check and this call)."""
        from ray_tpu_torch.core import runtime

        core = runtime._core_worker
        if core is not None and tuple(owner) == tuple(core.addr):
            try:
                core.apply_ref_updates(deltas)
                return
            # store mid-teardown (interpreter exit): falling through to
            # the batched path below is the handling — the flush loop
            # retries or abandons with the owner.
            # graftlint: disable=swallowed-exception
            except Exception:
                pass
        with self._lock:
            d = self._dirty.setdefault(owner, {})
            for oid, delta in deltas.items():
                d[oid] = d.get(oid, 0) + delta

    def _drain_decs(self) -> None:
        while True:
            try:
                owner, oid = self._pending_decs.popleft()
            except IndexError:
                return
            drop_cache = False
            with self._lock:
                key = (owner, oid)
                n = self._counts.get(key, 0) - 1
                if n <= 0:
                    self._counts.pop(key, None)
                    d = self._dirty.setdefault(owner, {})
                    d[oid] = d.get(oid, 0) - 1
                    drop_cache = True
                else:
                    self._counts[key] = n
            if drop_cache:
                self._drop_borrower_cache(owner, oid)

    def _drop_borrower_cache(self, owner: Addr, oid: bytes) -> None:
        from ray_tpu_torch.core import runtime

        core = runtime._core_worker
        if core is None or owner == core.addr:
            return
        try:
            core.store.drop(ObjectID(oid))
        except Exception:
            from ray_tpu_torch.util.ratelimit import log_every

            # Failure leaves a stale borrower-cache entry (memory, not
            # correctness) — but systematic failure means store trouble.
            log_every("object_ref.cache_drop", 60.0, logger,
                      "borrower cache drop failed", exc_info=True)

    def _flush_loop(self) -> None:
        from ray_tpu_torch.core.config import config

        while True:
            self._wake.wait(config.ref_flush_interval_s)
            self._wake.clear()
            self.flush()

    def flush(self) -> None:
        from ray_tpu_torch.core import runtime

        from ray_tpu_torch.core.rpc import RpcConnectError

        self._drain_decs()
        with self._lock:
            dirty, self._dirty = self._dirty, {}
        core = runtime._core_worker
        if core is None:
            return
        # Owner-local deltas apply FIRST: shipping to a remote owner can
        # block ~1 s per dead peer in the dial-retry loop (stale owners
        # from torn-down sessions accumulate under test/driver churn),
        # and the local grace sweeper must never wait behind that — a
        # starved local -1 holds an owned object beyond its lifetime, a
        # starved local +1 was the ObjectFreedError flake.
        owners = sorted(dirty, key=lambda o: o != core.addr)
        for owner in owners:
            deltas = dirty[owner]
            # Net-zero deltas still ship: a ref born and dropped inside one
            # flush window must mark the object as touched-then-released on
            # the owner, or it would never become sweepable.
            if not deltas:
                continue
            try:
                if owner == core.addr:
                    core.apply_ref_updates(deltas)
                else:
                    core.clients.get(owner).notify("ref_update", deltas,
                                                   core.holder_id)
                self._send_failures.pop(owner, None)
            except RpcConnectError:
                # The owner process cannot even be dialed: it is gone,
                # and its objects died with it — abandon the deltas NOW
                # instead of burning a ~1 s dial x 25 retries per dead
                # session (which starved the flush thread and every
                # queued dec behind it).
                self._send_failures.pop(owner, None)
                self._count_abandon()
            except Exception:
                # Transient failure: merge the deltas back for retry; a
                # dropped +1/-1 would silently corrupt the owner's count.
                # After repeated failures the owner is dead — its objects
                # die with it, so the deltas can be abandoned.
                fails = self._send_failures.get(owner, 0) + 1
                self._send_failures[owner] = fails
                if fails <= 25:
                    with self._lock:
                        d = self._dirty.setdefault(owner, {})
                        for oid, delta in deltas.items():
                            d[oid] = d.get(oid, 0) + delta
                else:
                    self._count_abandon()

    @staticmethod
    def _count_abandon() -> None:
        from ray_tpu_torch.core.config import config
        from ray_tpu_torch.core.coremetrics import OBJ_FLUSH_ABANDONED

        if config.core_metrics_enabled:
            OBJ_FLUSH_ABANDONED.inc()


def _tracking_enabled() -> bool:
    from ray_tpu_torch.core.config import config

    return config.ref_counting_enabled


class ObjectRef:
    __slots__ = ("id", "owner_addr", "_tracked", "_weakly_referenced",
                 "__weakref__")

    def __init__(self, object_id: ObjectID, owner_addr: Optional[Addr] = None):
        self.id = object_id
        self.owner_addr = tuple(owner_addr) if owner_addr else None
        self._tracked = False
        if self.owner_addr is not None and _tracking_enabled():
            _RefTracker.get().inc(self.owner_addr, object_id.binary())
            self._tracked = True

    def __del__(self):
        if getattr(self, "_tracked", False):
            try:
                _RefTracker.get().dec(self.owner_addr, self.id.binary())
            except Exception:  # graftlint: disable=swallowed-exception
                # __del__ may run during interpreter teardown, when the
                # tracker (or logging itself) is already dismantled.
                pass

    def hex(self) -> str:
        return self.id.hex()

    def binary(self) -> bytes:
        return self.id.binary()

    def __hash__(self):
        return hash(self.id)

    def __eq__(self, other):
        return isinstance(other, ObjectRef) and other.id == self.id

    def __repr__(self):
        return f"ObjectRef({self.id.hex()})"

    def __reduce__(self):
        from ray_tpu_torch.core import serialization

        serialization.record_serialized_ref(self)
        return (ObjectRef, (self.id, self.owner_addr))

    def future(self):
        """Return a concurrent.futures.Future resolving to get(self)."""
        from concurrent.futures import Future
        import threading

        from ray_tpu_torch.core import api

        fut: Future = Future()

        def _resolve():
            try:
                fut.set_result(api.get(self))
            except BaseException as e:  # noqa: BLE001
                fut.set_exception(e)

        threading.Thread(target=_resolve, daemon=True).start()
        return fut

    def __await__(self):
        """Allow ``await ref`` inside async actors (reference:
        ``ObjectRef.__await__`` in ``object_ref.pxi``)."""
        import asyncio

        return asyncio.wrap_future(
            asyncio.get_event_loop().run_in_executor(None, _blocking_get, self)
        ).__await__()


def _blocking_get(ref: "ObjectRef"):
    from ray_tpu_torch.core import api

    return api.get(ref)
