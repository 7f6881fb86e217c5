"""CoreWorker: the per-process runtime embedded in every driver and worker.

Analogue of the reference's core worker (``src/ray/core_worker/core_worker.h:295``)
— the single most load-bearing component. Every process (driver or worker)
embeds one: it owns the in-process object store, serves owned objects to
borrowers, submits tasks (normal + actor) with owner-side dependency
resolution, and executes pushed tasks.

Key protocol decisions mirrored from the reference:

* **Ownership** — the submitting process owns task returns and ``put``
  objects; return values flow back to the owner and are served from its
  store (``task_manager.h:208``, ``memory_store.h:43``).
* **Lease-based direct transport** — the submitter resolves dependencies
  *first* (``dependency_resolver.h`` — this ordering is what prevents the
  classic hold-a-worker-while-waiting-for-deps deadlock), then asks the
  cluster scheduler for a node, leases a worker from that node's pool, and
  pushes the task spec directly owner->worker
  (``direct_task_transport.h:75``).
* **Ordered actor calls** — per-caller sequence numbers; the actor executes
  calls from each caller in submission order unless ``max_concurrency > 1``
  or the actor is async (``direct_actor_task_submitter.h:74``,
  ``ActorSchedulingQueue``).
* **Task retries** — owner-side retry on worker crash
  (``task_manager.h:269`` RetryTaskIfPossible).
"""

from __future__ import annotations

import hashlib
import heapq
import logging
import os
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.config import config
from ray_tpu_torch.util import tracing
from ray_tpu_torch.util.ratelimit import log_every

logger = logging.getLogger(__name__)
from ray_tpu_torch.core.errors import (
    ActorDiedError,
    ObjectLostError,
    OutOfMemoryError,
    RayTpuError,
    TaskError,
    WorkerCrashedError,
)
from ray_tpu_torch.core.ids import ActorID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.object_store import MemoryStore, wait_any
from ray_tpu_torch.core.pubsub import DEAD_HOLDERS_CHANNEL, DEAD_HOLDERS_KEY
from ray_tpu_torch.core.rpc_stubs import ControllerStub
from ray_tpu_torch.core.rpc import (
    ClientPool,
    ReconnectingClient,
    RemoteCallError,
    RpcError,
    RpcServer,
)

# How often an owner that holds counts from other processes reads the
# controller's dead-holder notices (core/pubsub.py DEAD_HOLDERS_CHANNEL).
_DEAD_HOLDER_POLL_S = 1.0
# The poll's own RPC deadline, and the pause after a failed poll.
_DEAD_HOLDER_POLL_TIMEOUT_S = 1.0
_DEAD_HOLDER_BACKOFF_S = 5.0

Addr = Tuple[str, int]

_core_worker: Optional["CoreWorker"] = None
_core_worker_lock = threading.Lock()

# How long an actor's ordered queue waits for a missing sequence number
# before treating it as skipped (see ActorExecutionRuntime._run_ordered).
_GAP_WAIT_S = 30.0


class _PinnedFrame:
    """A frame that lives in the store, exported as a buffer together with
    the ``ObjectRef`` it was read for. The arrays and tensors that
    ``deserialize`` builds over the frame hold views of it, and through
    them the reference: the owner frees an object only after its last
    reference has gone, so the store cannot hand the bytes under a live
    value to another object (the reference's plasma keeps a buffer's
    object until the buffer is released)."""

    __slots__ = ("_view", "_ref")

    def __init__(self, view: memoryview, ref: ObjectRef):
        self._view = view
        self._ref = ref

    def __buffer__(self, flags: int) -> memoryview:
        return self._view


def _dump_stacks() -> str:
    from ray_tpu_torch.util.tracing import dump_stacks

    return dump_stacks()


def _profile_cpu(duration_s: float = 3.0, hz: float = 100.0):
    from ray_tpu_torch.util.profiling import sample_stacks

    return sample_stacks(duration_s, hz)


def _profile_heap(top_n: int = 25):
    from ray_tpu_torch.util.profiling import heap_profile

    return heap_profile(top_n)


def _profile_heap_stop():
    from ray_tpu_torch.util.profiling import stop_heap_profile

    return stop_heap_profile()


def get_core_worker() -> "CoreWorker":
    if _core_worker is None:
        raise RayTpuError(
            "ray_tpu_torch has not been initialized; call ray_tpu_torch.init() first.")
    return _core_worker


def set_core_worker(worker: Optional["CoreWorker"]) -> None:
    global _core_worker
    with _core_worker_lock:
        _core_worker = worker


def is_initialized() -> bool:
    return _core_worker is not None


class CoreWorker:
    def __init__(
        self,
        mode: str,  # "driver" | "worker"
        controller_addr: Addr,
        node_addr: Addr,
        node_id: NodeID,
        worker_id: Optional[WorkerID] = None,
    ):
        self.mode = mode
        self.worker_id = worker_id or WorkerID.from_random()
        self.node_id = node_id
        self.node_addr = tuple(node_addr)
        self.controller_addr = tuple(controller_addr)

        self.store = MemoryStore()
        self.clients = ClientPool()
        # Controller link retries through reconnects, so a head restart
        # (controller FT) stalls control-plane calls briefly instead of
        # failing in-flight tasks (reference: gcs_rpc_client.h retries).
        self.controller = ReconnectingClient(tuple(controller_addr))
        # Lazily opened shared-memory stores: our own node's (for writes) and
        # any local store we read from. {path: ShmStore}
        self._shm_stores: Dict[str, Any] = {}
        self._shm_lock = threading.Lock()
        self._fn_cache: Dict[str, Callable] = {}
        self._fn_cache_lock = threading.Lock()
        self._actor_runtime: Optional[ActorExecutionRuntime] = None
        self._current_task_desc = threading.local()
        self._shutdown = threading.Event()
        # Work counters, reported in worker_ping so the node can reclaim
        # leases whose grant or return was lost on the network (the
        # worker would otherwise sit leased forever).
        self.tasks_received = 0
        self.active_tasks = 0

        # Owner-kept task lineage for object reconstruction: return oid ->
        # shared record of the producing task (reference: task_manager.h:215
        # lineage, object_recovery_manager.h:41).
        self._lineage: Dict[ObjectID, Dict[str, Any]] = {}
        self._lineage_lock = threading.Lock()
        # Streaming-generator returns: task id bytes -> stream state
        # (items: ObjectRefs in yield order; total set when the task ends).
        self._streams: Dict[bytes, Dict[str, Any]] = {}
        self._streams_cond = threading.Condition()
        # Admission control for remote object pulls (reference: PullManager's
        # memory budget, pull_manager.h:52): bounded chunk slots.
        slots = max(1, config.max_pull_bytes_in_flight
                    // config.object_transfer_chunk_bytes)
        self._pull_slots = threading.BoundedSemaphore(slots)
        # Owner-side broadcast trees (reference: push_manager.h:30 push
        # dedup, generalized): per big object, the set of replica
        # locations and the leased pull slots per source.
        self._bcast: Dict[bytes, Dict[str, Any]] = {}
        self._bcast_cond = threading.Condition()

        self.server = RpcServer(
            handlers={
                "get_object": self._handle_get_object,
                "wait_object": self._handle_wait_object,
                "peek_object": self._handle_peek_object,
                # remote-free entry point for external tooling (the
                # owner frees its own objects via free_object directly)
                "free_object": self._handle_free_object,
                "pull_done": self._handle_pull_done,
                "pull_failed": self._handle_pull_failed,
                "ref_update": self._handle_ref_update,
                "reconstruct_object": self._handle_reconstruct,
                "push_task": self._handle_push_task,
                "push_task_batch": self._handle_push_task_batch,
                "stream_item": self._handle_stream_item,
                "start_actor": self._handle_start_actor,
                "push_actor_task": self._handle_push_actor_task,
                # graceful-stop hook (nodes SIGTERM workers today);
                # reserved for drain-before-kill
                # graftlint: disable=rpc-dead-endpoint
                "shutdown_worker": self._handle_shutdown,
                "dump_stacks": _dump_stacks,
                # On-demand profiling (reference: profile_manager.py:79
                # py-spy CPU + :190 memray heap — native equivalents).
                "profile_cpu": _profile_cpu,
                "profile_heap": _profile_heap,
                "profile_heap_stop": _profile_heap_stop,
                "ping": lambda: "pong",
            },
            name=f"{mode}-core",
            max_workers=128,
            inline_methods={"peek_object", "free_object", "ref_update",
                            # Broadcast slot releases must make progress
                            # while the pool is saturated with blocked
                            # get_object long-polls — else each tree round
                            # stalls a full long-poll window. Replies are
                            # queued (never sent blocking) by the reactor
                            # write path, so inlining is safe even when a
                            # peer reads slowly; ping rides inline so
                            # liveness probes skip the pool hop entirely.
                            "pull_done", "pull_failed", "ping"},
        )
        self.addr: Addr = self.server.addr
        # Who this process is to the owners it sends handle counts to:
        # its address and pid (the node reports the same triple when the
        # process dies, and a later process on a reused port is another
        # holder).
        self.holder_id = (*self.addr, os.getpid())
        self._holders_abroad = False  # some other process sent counts
        self._dead_version = 0        # dead-holder channel version seen
        # Notices stamped before this process started name processes that
        # could never have sent it a count.
        self._dead_seen = int(time.time() * 1e6)
        self._dead_polled_at = 0.0
        self.submitter = TaskSubmitter(self)
        # Owner-side task state-transition buffer (reference:
        # TaskEventBuffer, task_event_buffer.h:206): flushed to the
        # controller by the sweeper thread, bounded by event_buffer_max.
        self._task_events: List[Dict[str, Any]] = []
        self._task_events_lock = threading.Lock()
        from ray_tpu_torch.util import metrics as um

        um.add_collector(self._collect_core_metrics)
        self._sweeper = threading.Thread(
            target=self._sweep_loop, name="ref-sweeper", daemon=True)
        self._sweeper.start()

    def _collect_core_metrics(self) -> None:
        """Snapshot-time store gauges (weakly registered — dies with the
        core worker)."""
        if not config.core_metrics_enabled:
            return
        from ray_tpu_torch.core import coremetrics as cmx

        cmx.OBJ_STORE_ENTRIES.set(float(self.store.size()))
        cmx.OBJ_STORE_BYTES.set(float(self.store.data_bytes()))

    # -------------------------------------------------- shared-memory store

    def _open_shm(self, path: str):
        with self._shm_lock:
            store = self._shm_stores.get(path)
            if store is None:
                from ray_tpu_torch._native.objstore import ShmStore

                # One-time per-path init (may compile the native .so on
                # first use). Serializing it is the point: two threads
                # must not mmap/build the same store concurrently, and
                # after the first call it's a dict hit.
                # graftlint: disable=lock-held-blocking
                store = ShmStore(path)
                self._shm_stores[path] = store
            return store

    def _shm_locator(self, oid: ObjectID) -> Dict[str, Any]:
        from ray_tpu_torch.core.node import shm_store_path

        return {
            "path": shm_store_path(self.node_id),
            "node_id": self.node_id.binary(),
            "node_addr": self.node_addr,
            "oid": oid.binary(),
        }

    def _try_put_frame(self, oid: ObjectID, total: int,
                       write) -> Optional[Dict]:
        """Reserve ``total`` bytes in this node's store and let ``write``
        fill them in place (single copy: pickle buffers -> shm mmap); falls
        back to the node's spill directory when the store can't fit it
        (reference: local_object_manager.h:110 spill-to-fs — spilling
        happens at write time because pinned primary copies are not
        evictable). Returns the locator, or None only when both fail."""
        try:
            from ray_tpu_torch.core.node import shm_store_path

            store = self._open_shm(shm_store_path(self.node_id))
            buf = store.create_buffer(oid.binary(), total)
            if buf is not None:
                write(buf)
                # Owner holds the primary-copy pin until free: without it,
                # LRU eviction under pressure could drop the only copy of a
                # live object (ObjectLostError on a later get).
                self.store._entry(oid).shm_pin = store.seal(
                    oid.binary(), pin=True)
                loc = self._shm_locator(oid)
                loc["total"] = total  # lets the owner pick broadcast mode
                return loc
        except OSError:
            pass
        return self._try_spill(oid, total, write)

    def _try_spill(self, oid: ObjectID, total: int, write) -> Optional[Dict]:
        """Write the frame into a file in this node's spill dir (mmap-backed,
        same single-copy discipline) and return a locator the node's object
        server can resolve (read_shm_* check the spill dir)."""
        import mmap as _mmap

        try:
            from ray_tpu_torch.core.node import spill_dir, spill_file

            os.makedirs(spill_dir(self.node_id), exist_ok=True)
            path = spill_file(self.node_id, oid.binary())
            tmp = path + ".tmp"
            with open(tmp, "wb+") as f:
                if total:
                    # Allocate blocks up front: ENOSPC surfaces here as
                    # OSError (caught below) instead of a SIGBUS when the
                    # mmap write faults on a sparse hole.
                    os.posix_fallocate(f.fileno(), 0, total)
                    with _mmap.mmap(f.fileno(), total) as m:
                        write(memoryview(m))
            os.rename(tmp, path)
            loc = self._shm_locator(oid)
            loc["spill"] = path
            loc["total"] = total
            return loc
        except OSError:
            return None

    def _resolve_shm(self, locator: Dict[str, Any], cache_oid: ObjectID):
        """Resolve a locator to a frame buffer. Local node: a pinned
        zero-copy view (pin held by the store entry until freed — this is the
        'primary copy pinned' discipline that keeps numpy views into the
        mmap valid), falling back to the spill file. Remote node: chunked
        fetch via the node's object server with admission control."""
        if locator["node_id"] == self.node_id.binary():
            try:
                store = self._open_shm(locator["path"])
                view = store.get_view(locator["oid"])
            except OSError:  # store file gone (node supervisor died)
                view = None
            if view is not None:
                entry = self.store._entry(cache_oid)
                entry.shm_view = view
                # Read-only: sealed objects are immutable (plasma
                # semantics); numpy arrays deserialized over this buffer are
                # zero-copy views and must not scribble on the mapping.
                return view.data.toreadonly()
            spill = locator.get("spill")
            if spill is None:
                from ray_tpu_torch.core.node import spill_file

                spill = spill_file(self.node_id, locator["oid"])
            try:
                with open(spill, "rb") as f:
                    return f.read()
            except OSError:
                raise ObjectLostError(
                    f"object {cache_oid.hex()} evicted from the local store"
                ) from None
        payload = self._pull_remote(locator, cache_oid)
        self.store.put_serialized(cache_oid, payload)
        return payload

    def _pull_remote_replicate(self, locator: Dict[str, Any],
                               cache_oid: ObjectID):
        """Broadcast-tree pull: fetch the object's chunks STRAIGHT into a
        buffer in THIS node's store (one copy on this host), seal it
        UNPINNED (LRU-evictable — replicas are cache, not primaries) and
        serve a zero-copy view. Returns (frame, new_locator|None); falls
        back to a plain in-process pull when the store has no room."""
        total = locator.get("total", 0)
        store = buf = None
        try:
            from ray_tpu_torch.core.node import shm_store_path

            store = self._open_shm(shm_store_path(self.node_id))
            buf = store.create_buffer(cache_oid.binary(), total)
        except OSError:
            buf = None
        if buf is None:
            payload = self._pull_remote(locator, cache_oid)
            self.store.put_serialized(cache_oid, payload)
            return payload, None
        try:
            self._pull_remote_into(locator, cache_oid, buf, total)
        except BaseException:
            try:
                store.seal(cache_oid.binary(), pin=False)
                store.delete(cache_oid.binary())
            except Exception:  # graftlint: disable=swallowed-exception
                # Best-effort shm cleanup while the pull failure is
                # already propagating — must not mask it.
                pass
            raise
        store.seal(cache_oid.binary(), pin=False)
        view = store.get_view(cache_oid.binary())
        if view is None:  # evicted before we could even view it
            payload = self._pull_remote(locator, cache_oid)
            self.store.put_serialized(cache_oid, payload)
            return payload, None
        entry = self.store._entry(cache_oid)
        entry.shm_view = view
        loc = self._shm_locator(cache_oid)
        loc["total"] = total
        return view.data.toreadonly(), loc

    def _pull_remote_into(self, locator: Dict[str, Any],
                          cache_oid: ObjectID, buf, total: int,
                          start: int = 0) -> None:
        """Chunked pull written at-offset into ``buf`` from ``start``
        (disjoint ranges; parallel chunk threads never overlap), gated by
        the pull-slot memory budget (reference: ObjectManager 64 MiB chunk
        pulls, object_manager.h:117 / pull_manager.h:52). The remaining
        chunks fan out on a dedicated pool (NOT _io_pool: multi-ref get()
        already saturates that pool, and fanning out from inside it would
        deadlock)."""
        node_client = self.clients.get(tuple(locator["node_addr"]))
        chunk = config.object_transfer_chunk_bytes
        oid = locator["oid"]

        def fetch(offset: int) -> None:
            with self._pull_slots:
                got = node_client.call("read_shm_chunk", oid, offset, chunk)
            if got is None:
                raise ObjectLostError(
                    f"object {cache_oid.hex()} evicted from remote store "
                    f"mid-pull at offset {offset}")
            rtotal, data = got
            if rtotal != total:
                raise ObjectLostError(
                    f"object {cache_oid.hex()} size changed mid-pull")
            if config.core_metrics_enabled:
                from ray_tpu_torch.core.coremetrics import OBJ_TRANSFER_BYTES

                OBJ_TRANSFER_BYTES.inc(float(len(data)))
            buf[offset:offset + len(data)] = data

        try:
            offsets = list(range(start, total, chunk))
            if offsets:
                list(self._chunk_pool().map(fetch, offsets))
        except (RpcError, RemoteCallError, TimeoutError) as e:
            raise ObjectLostError(
                f"node holding {cache_oid.hex()} unreachable: {e}") from e

    def _pull_remote(self, locator: Dict[str, Any],
                     cache_oid: ObjectID) -> bytes:
        """Chunked node-to-node pull into process memory. One chunk learns
        the size, the rest delegate to ``_pull_remote_into`` (same
        admission control and error mapping as the replicating path)."""
        node_client = self.clients.get(tuple(locator["node_addr"]))
        chunk = config.object_transfer_chunk_bytes
        try:
            with self._pull_slots:
                got = node_client.call("read_shm_chunk", locator["oid"], 0,
                                       chunk)
        except (RpcError, RemoteCallError, TimeoutError) as e:
            raise ObjectLostError(
                f"node holding {cache_oid.hex()} unreachable: {e}") from e
        if got is None:
            raise ObjectLostError(
                f"object {cache_oid.hex()} evicted from remote store "
                f"mid-pull at offset 0")
        total, data = got
        if config.core_metrics_enabled:
            from ray_tpu_torch.core.coremetrics import OBJ_TRANSFER_BYTES

            OBJ_TRANSFER_BYTES.inc(float(len(data)))
        if total <= len(data):
            return bytes(data)
        buf = bytearray(total)
        buf[:len(data)] = data
        self._pull_remote_into(locator, cache_oid, buf, total,
                               start=len(data))
        return bytes(buf)

    # ------------------------------------------------------------ put/get

    def put(self, value: Any) -> ObjectRef:
        t0 = time.perf_counter()
        t0_wall = time.time()
        oid = ObjectID.from_random()
        self.store.mark_owned(oid)
        with serialization.capture_refs() as nested:
            total, write = serialization.build_frame(value)
        self.store.set_nested(oid, nested)  # pin refs inside the frame
        ref = None
        if total > config.inline_object_max_bytes:
            locator = self._try_put_frame(oid, total, write)
            if locator is not None:
                self.store.put_shm_ref(oid, locator)
                ref = ObjectRef(oid, self.addr)
        if ref is None:
            out = bytearray(total)
            write(out)
            self.store.put_serialized(oid, bytes(out))
            ref = ObjectRef(oid, self.addr)
        if config.core_metrics_enabled:
            from ray_tpu_torch.core import coremetrics as cm

            cm.OBJ_PUT_BYTES.inc(float(total))
            cm.OBJ_PUT_S.observe(time.perf_counter() - t0)
            # Object-plane hop in the request's trace (no-op without an
            # active span): `ray_tpu timeline` shows a serve/RL request's
            # puts alongside its RPC and engine spans.
            tracing.record_span("object:put", t0_wall, time.time(),
                                bytes=total, oid=oid.hex()[:8])
        return ref

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ObjectRef)
        ref_list: List[ObjectRef] = [refs] if single else list(refs)
        for r in ref_list:
            if not isinstance(r, ObjectRef):
                raise TypeError(f"get() expects ObjectRef(s), got {type(r)}")
        if len(ref_list) > 1:
            pool = self._io_pool()
            values = list(pool.map(
                lambda r: self._get_one(r, timeout), ref_list))
        else:
            values = [self._get_one(r, timeout) for r in ref_list]
        return values[0] if single else values

    _io_pool_inst: Optional[ThreadPoolExecutor] = None
    _chunk_pool_inst: Optional[ThreadPoolExecutor] = None
    _io_pool_lock = threading.Lock()

    def _io_pool(self) -> ThreadPoolExecutor:
        with self._io_pool_lock:
            if self._io_pool_inst is None:
                self._io_pool_inst = ThreadPoolExecutor(
                    max_workers=16, thread_name_prefix="core-io")
            return self._io_pool_inst

    def _chunk_pool(self) -> ThreadPoolExecutor:
        with self._io_pool_lock:
            if self._chunk_pool_inst is None:
                self._chunk_pool_inst = ThreadPoolExecutor(
                    max_workers=8, thread_name_prefix="chunk-pull")
            return self._chunk_pool_inst

    def _value_frame(self, ref: ObjectRef, timeout: Optional[float]):
        """``_get_frame``, with a view of the store tied to ``ref`` (see
        :class:`_PinnedFrame`)."""
        frame = self._get_frame(ref, timeout)
        if isinstance(frame, memoryview):
            return memoryview(_PinnedFrame(frame, ref))
        return frame

    def _get_one(self, ref: ObjectRef, timeout: Optional[float]):
        if not config.core_metrics_enabled:
            frame = self._value_frame(ref, timeout)
            value = serialization.deserialize(frame)
            if isinstance(value, TaskError):
                raise value
            return value
        t0 = time.perf_counter()
        t0_wall = time.time()
        local = (ref.owner_addr in (None, self.addr)
                 or self.store.is_ready(ref.id))
        frame = self._value_frame(ref, timeout)
        value = serialization.deserialize(frame)
        from ray_tpu_torch.core import coremetrics as cmx

        path = "local" if local else "remote"
        cmx.OBJ_GET_S.observe(time.perf_counter() - t0, {"path": path})
        tracing.record_span("object:get", t0_wall, time.time(),
                            path=path, oid=ref.hex()[:8])
        if isinstance(value, TaskError):
            raise value
        return value

    def _get_frame(self, ref: ObjectRef, timeout: Optional[float]):
        """Fetch the serialized frame for ``ref``: local store (zero-copy shm
        view when the value lives in this node's store) or owner pull. Lost
        objects (evicted / node died) are reconstructed by re-executing the
        producing task when lineage is known (object_recovery_manager.h:41)."""
        if ref.owner_addr in (None, self.addr):
            attempts = 0
            deadline = (None if timeout is None
                        else time.monotonic() + timeout)
            while True:
                left = (None if deadline is None
                        else max(0.0, deadline - time.monotonic()))
                entry = self.store.wait_ready(ref.id, left)
                try:
                    if entry.data is not None:
                        return entry.data
                    if entry.shm_ref is not None:
                        return self._resolve_shm(entry.shm_ref, ref.id)
                    raise ObjectLostError(
                        f"object {ref.hex()} has no data")
                except ObjectLostError:
                    attempts += 1
                    if (attempts > config.reconstruction_max_attempts
                            or not self._try_reconstruct(ref.id)):
                        raise
        if self.store.contains(ref.id):
            entry = self.store.wait_ready(ref.id, timeout)
            try:
                if entry.data is not None:
                    return entry.data
                if entry.shm_ref is not None:
                    return self._resolve_shm(entry.shm_ref, ref.id)
            except ObjectLostError:
                # Cached locator went stale (node died): drop the cache and
                # fall through to the owner pull below.
                self.store.drop(ref.id)
        # Borrower path: long-poll the owner, then resolve/cache locally.
        # An owner that cannot be dialed is a dead owner, whose objects
        # died with it: the same ObjectLostError as a mid-call failure.
        try:
            owner = self.clients.get(ref.owner_addr)
        except RpcError as e:
            raise ObjectLostError(
                f"owner of {ref.hex()} at {ref.owner_addr} unreachable: {e}"
            ) from e
        recon_asked = 0
        src_fails = 0
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            step = 5.0 if deadline is None else min(5.0, deadline - time.monotonic())
            if step <= 0:
                from ray_tpu_torch.core.errors import GetTimeoutError
                raise GetTimeoutError(f"object {ref.hex()} not ready in time")
            try:
                result = owner.call("get_object", ref.id.binary(), step,
                                    self.node_id.binary(),
                                    timeout=step + 10.0)
            except RemoteCallError as e:
                # The owner re-raised a stored error (put_error): surface the
                # real exception, not the transport wrapper.
                raise e.cause from None
            except (RpcError, TimeoutError) as e:
                raise ObjectLostError(
                    f"owner of {ref.hex()} at {ref.owner_addr} unreachable: {e}"
                ) from e
            if result is None:
                continue
            kind, payload = result
            if kind == "inline":
                self.store.put_serialized(ref.id, payload)
                return payload
            if kind == "shm":
                # src_key present = the owner leased us a broadcast pull
                # slot on that source (tree distribution); we must report
                # done/failed so the slot frees and our replica joins the
                # tree.
                src_key = payload.pop("src_key", None)
                slot_token = payload.pop("slot_token", None)
                remote = payload["node_id"] != self.node_id.binary()
                try:
                    if src_key is not None and remote:
                        frame, new_loc = self._pull_remote_replicate(
                            payload, ref.id)
                    else:
                        frame = self._resolve_shm(payload, ref.id)
                        new_loc = None
                except ObjectLostError:
                    self.store.drop(ref.id)
                    if src_key is not None:
                        try:
                            owner.notify("pull_failed", ref.id.binary(),
                                         src_key, payload["node_id"],
                                         slot_token)
                        except Exception:
                            # Owner unreachable: it will reap the pull
                            # slot by timeout instead.
                            log_every("runtime.pull_notify", 10.0, logger,
                                      "pull_failed notify to owner "
                                      "failed", exc_info=True)
                        src_fails += 1
                        if src_fails <= 3:
                            # A broadcast tree has alternative sources:
                            # the owner pruned the bad one, re-poll for
                            # another copy before escalating to lineage
                            # reconstruction. (Without a tree there is
                            # only the dead primary — reconstruct NOW.)
                            continue
                    recon_asked += 1
                    if recon_asked > config.reconstruction_max_attempts:
                        raise
                    try:
                        if not owner.call("reconstruct_object",
                                          ref.id.binary()):
                            raise
                    except (RpcError, RemoteCallError, TimeoutError):
                        raise ObjectLostError(
                            f"owner of {ref.hex()} unreachable for "
                            f"reconstruction") from None
                    continue
                if src_key is not None:
                    try:
                        owner.notify("pull_done", ref.id.binary(), src_key,
                                     new_loc, slot_token)
                    except Exception:
                        log_every("runtime.pull_notify", 10.0, logger,
                                  "pull_done notify to owner failed",
                                  exc_info=True)
                self.store.put_shm_ref(ref.id, new_loc or payload)
                return frame
            raise ObjectLostError(f"unknown get_object reply kind {kind!r}")

    def get_serialized(self, ref: ObjectRef, timeout: Optional[float]) -> bytes:
        """Like _get_frame but always materializes bytes (for RPC shipping)."""
        frame = self._get_frame(ref, timeout)
        return frame if isinstance(frame, bytes) else bytes(frame)

    def wait_ready(self, ref: ObjectRef, timeout: Optional[float]) -> None:
        """Block until ``ref`` is ready, without transferring its value —
        used by owner-side dependency resolution (dependency_resolver.h
        resolves availability, not bytes)."""
        if self.store.contains(ref.id) or ref.owner_addr in (None, self.addr):
            self.store.wait_ready(ref.id, timeout)
            return
        owner = self.clients.get(ref.owner_addr)
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            step = 5.0 if deadline is None else min(5.0, deadline - time.monotonic())
            if step <= 0:
                from ray_tpu_torch.core.errors import GetTimeoutError

                raise GetTimeoutError(f"object {ref.hex()} not ready in time")
            try:
                if owner.call("wait_object", ref.id.binary(), step,
                              timeout=step + 10.0):
                    return
            except RemoteCallError as e:
                raise e.cause from None
            except (RpcError, TimeoutError) as e:
                raise ObjectLostError(
                    f"owner of {ref.hex()} at {ref.owner_addr} unreachable: {e}"
                ) from e

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None):
        ids = [r.id for r in refs]
        by_id = {r.id: r for r in refs}

        def poll(oid: ObjectID) -> bool:
            ref = by_id[oid]
            if ref.owner_addr in (None, self.addr):
                return False
            try:
                ready = self.clients.get(ref.owner_addr).call(
                    "peek_object", oid.binary(), timeout=5.0)
            except (RpcError, TimeoutError):
                return False
            return bool(ready)

        ready_ids, pending_ids = wait_any(
            self.store, ids, num_returns, timeout, poll=poll)
        return ([by_id[i] for i in ready_ids], [by_id[i] for i in pending_ids])

    # ------------------------------------------------- owned-object server

    def _handle_get_object(self, oid_bytes: bytes, timeout: float,
                           borrower_node: Optional[bytes] = None):
        """Long-poll: returns ("inline", frame) / ("shm", locator), or None
        on timeout. Owners hand out shm locators rather than bytes so the
        borrower can read node-locally (owner-based object directory,
        ownership_based_object_directory.h).

        Big objects (>= object_broadcast_min_bytes) distribute as a
        binomial TREE: the owner caps concurrent pulls per source copy
        (object_broadcast_fanout) and pullers that finish register their
        node's copy as a new source (``pull_done``), so N-node broadcast
        costs O(log N) serial transfer rounds instead of N pulls off one
        node (reference envelope: 1 GiB -> 50+ nodes,
        release/benchmarks/README.md:20; push dedup push_manager.h:30)."""
        oid = ObjectID(oid_bytes)
        deadline = time.monotonic() + timeout
        try:
            entry = self.store.wait_ready(oid, timeout)
        except Exception as e:
            from ray_tpu_torch.core.errors import GetTimeoutError
            if isinstance(e, GetTimeoutError):
                return None
            raise
        primary = entry.shm_ref
        if primary is None:
            if entry.data is None:
                raise ObjectLostError(f"object {oid.hex()} has no data")
            return ("inline", entry.data)
        total = primary.get("total", 0)
        if (config.object_broadcast_fanout <= 0
                or total < config.object_broadcast_min_bytes):
            return ("shm", primary)
        return self._assign_pull_source(oid_bytes, primary, borrower_node,
                                        deadline)

    def _assign_pull_source(self, oid_bytes: bytes, primary: Dict[str, Any],
                            borrower_node: Optional[bytes],
                            deadline: float):
        """Pick a source copy with a free pull slot, blocking (within the
        long-poll window) until one frees. Same-node copies need no slot —
        they are zero-copy local reads."""
        fanout = max(1, config.object_broadcast_fanout)
        lease = config.object_pull_slot_lease_s
        with self._bcast_cond:
            track = self._bcast.setdefault(
                oid_bytes, {"secondaries": {}, "slots": {}})
            while True:
                locs = {primary["node_id"]: primary}
                locs.update(track["secondaries"])
                if borrower_node is not None and borrower_node in locs:
                    return ("shm", locs[borrower_node])  # local: no slot
                now = time.monotonic()
                best_key, best_load = None, None
                for key, loc in locs.items():
                    live = {tok: t
                            for tok, t in track["slots"].get(key, {}).items()
                            if t > now}
                    track["slots"][key] = live
                    if len(live) < fanout and (best_load is None
                                               or len(live) < best_load):
                        best_key, best_load = key, len(live)
                if best_key is not None:
                    # Per-grant token: done/failed releases THIS lease, so
                    # a pull completing past its expiry (already pruned)
                    # can't pop another puller's live slot and transiently
                    # exceed the fanout budget.
                    token = os.urandom(8)
                    track["slots"].setdefault(best_key, {})[token] = (
                        now + lease)
                    loc = dict(locs[best_key])
                    loc["src_key"] = best_key
                    loc["slot_token"] = token
                    return ("shm", loc)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None  # borrower re-polls
                self._bcast_cond.wait(min(remaining, 1.0))

    def _release_pull_slot_locked(self, track: Dict[str, Any],
                                  src_key: bytes,
                                  slot_token: Optional[bytes]) -> None:
        slots = track["slots"].get(src_key)
        if not slots:
            return
        if slot_token is not None:
            slots.pop(slot_token, None)  # absent = already expiry-pruned
        else:
            slots.pop(next(iter(slots)), None)

    def _handle_pull_done(self, oid_bytes: bytes, src_key: bytes,
                          new_locator: Optional[Dict[str, Any]],
                          slot_token: Optional[bytes] = None) -> None:
        """A puller finished: release its source slot and (when it managed
        to replicate into its node's store) add that copy as a new source."""
        with self._bcast_cond:
            track = self._bcast.get(oid_bytes)
            if track is None:
                return
            self._release_pull_slot_locked(track, src_key, slot_token)
            if new_locator is not None:
                track["secondaries"][new_locator["node_id"]] = new_locator
            self._bcast_cond.notify_all()

    def _handle_pull_failed(self, oid_bytes: bytes,
                            src_key: Optional[bytes],
                            bad_key: bytes,
                            slot_token: Optional[bytes] = None) -> None:
        """A source failed mid-pull/read: release the leased slot (when one
        was leased — local reads lease none) and forget the secondary (a
        dead PRIMARY is the reconstruction path's business)."""
        with self._bcast_cond:
            track = self._bcast.get(oid_bytes)
            if track is None:
                return
            if src_key is not None:
                self._release_pull_slot_locked(track, src_key, slot_token)
            track["secondaries"].pop(bad_key, None)
            self._bcast_cond.notify_all()

    def _handle_wait_object(self, oid_bytes: bytes, timeout: float) -> bool:
        try:
            self.store.wait_ready(ObjectID(oid_bytes), timeout)
            return True
        except Exception as e:
            from ray_tpu_torch.core.errors import GetTimeoutError
            if isinstance(e, GetTimeoutError):
                return False
            return True  # ready-with-error counts as ready

    def _handle_peek_object(self, oid_bytes: bytes) -> bool:
        return self.store.is_ready(ObjectID(oid_bytes))

    def _handle_free_object(self, oid_bytes: bytes) -> None:
        self.free_object(ObjectID(oid_bytes))

    # -------------------------------------------- distributed ref counting

    def _handle_ref_update(self, deltas: Dict[bytes, int],
                           sender=None) -> None:
        self.apply_ref_updates(deltas, sender)

    def apply_ref_updates(self, deltas: Dict[bytes, int],
                          sender=None) -> None:
        """Apply handle-count deltas that the process ``sender`` (its
        ``holder_id``; this process when None) counted."""
        if sender is None:
            sender = self.holder_id
        else:
            sender = tuple(sender)
            if sender != self.holder_id:
                self._holders_abroad = True
        for oid_bytes, delta in deltas.items():
            self.store.apply_ref_update(ObjectID(oid_bytes), delta, sender)

    def _drop_dead_holders(self) -> None:
        """Drop the counts of holders that died: the controller publishes
        each worker process its nodes' reapers found gone (or that died
        with its node), and this owner forgets the handles they held, so
        the sweep below frees what only they kept. A holder that is just
        slow keeps its counts: the evidence is the reaper, never a missed
        RPC. Polled without parking, and only once some other process
        has sent counts here."""
        now = time.monotonic()
        if (not self._holders_abroad
                or now - self._dead_polled_at < _DEAD_HOLDER_POLL_S):
            return
        self._dead_polled_at = now
        got = ControllerStub(self.controller).psub_poll(
            DEAD_HOLDERS_CHANNEL, DEAD_HOLDERS_KEY, self._dead_version,
            0.0, timeout=_DEAD_HOLDER_POLL_TIMEOUT_S)
        if not got:
            return
        self._dead_version, notices = got
        newest = self._dead_seen
        for stamp, holder in notices:
            holder = tuple(holder)
            if stamp > self._dead_seen and holder != self.holder_id:
                self.store.drop_holder(holder)
            newest = max(newest, stamp)
        self._dead_seen = newest

    def _sweep_loop(self) -> None:
        """Owner-side lifetime sweeper: frees owned objects whose
        cluster-wide handle count has stayed at zero past the grace period
        (reference: ReferenceCounter deleting out-of-scope objects,
        reference_count.h:61). Doubles as the task-event flusher."""
        while not self._shutdown.wait(max(0.2, config.ref_free_grace_s / 4)):
            try:
                if config.ref_counting_enabled:
                    for oid, _loc in self.store.sweep_dead_refs(
                            config.ref_free_grace_s):
                        self.free_object(oid)
                    # Freed tombstones don't live forever (a long-running
                    # owner would otherwise accumulate one per dead object).
                    self.store.purge_freed(max(60.0,
                                               config.ref_free_grace_s * 30))
                self._flush_task_events()
            except Exception:
                # A sweeper that dies silently means owned objects are
                # never freed — keep the loop alive but leave a trail.
                log_every("runtime.sweep", 30.0, logger,
                          "ref sweeper pass failed", exc_info=True)
            if config.ref_counting_enabled:
                # After the sweep and in a try of its own: a controller
                # that is slow or restarting only postpones dropping a
                # dead holder's counts.
                try:
                    self._drop_dead_holders()
                except Exception:
                    self._dead_polled_at = (time.monotonic()
                                            + _DEAD_HOLDER_BACKOFF_S)
                    log_every("runtime.dead_holders", 30.0, logger,
                              "dead-holder poll failed", exc_info=True)

    def record_task_event(self, event: Dict[str, Any]) -> None:
        with self._task_events_lock:
            self._task_events.append(event)
            if len(self._task_events) > config.event_buffer_max:
                del self._task_events[:len(self._task_events) // 2]

    def _flush_task_events(self) -> None:
        with self._task_events_lock:
            events, self._task_events = self._task_events, []
        if events:
            try:
                self.controller.notify("push_task_events", events)
            except Exception:
                log_every("runtime.task_events", 30.0, logger,
                          "task-event flush (%d events) failed",
                          len(events), exc_info=True)

    def free_object(self, oid: ObjectID) -> None:
        """Full owner-side free: in-process entry, primary shm copy (pin +
        slot), spill file, and lineage."""
        with self.store._lock:
            entry = self.store._entries.get(oid)
            locator = entry.shm_ref if entry is not None else None
        self.store.free(oid)
        if locator is not None:
            try:
                self.clients.get(tuple(locator["node_addr"])).notify(
                    "free_shm_object", locator["oid"])
            except Exception:
                # Usually the node is simply gone (its store died with
                # it); a live node failing frees would leak shm slots.
                log_every("runtime.free_shm", 30.0, logger,
                          "free of primary shm copy failed",
                          exc_info=True)
        with self._bcast_cond:
            track = self._bcast.pop(oid.binary(), None)
        if track:
            # Secondary copies are unpinned (LRU-evictable), but free them
            # eagerly anyway — a freed object's replicas are pure waste.
            for loc in track["secondaries"].values():
                try:
                    self.clients.get(tuple(loc["node_addr"])).notify(
                        "free_shm_object", loc["oid"])
                except Exception:
                    log_every("runtime.free_shm", 30.0, logger,
                              "free of replica shm copy failed",
                              exc_info=True)
        with self._lineage_lock:
            self._lineage.pop(oid, None)

    # ---------------------------------------------- lineage/reconstruction

    def record_lineage(self, return_ids: List[ObjectID],
                       spec: Dict[str, Any], options: Dict[str, Any]) -> None:
        """Owner-kept lineage: remember how to re-produce these objects
        (reference: TaskManager lineage, task_manager.h:215). Bounded FIFO."""
        record = {"spec": spec, "options": options,
                  "return_ids": list(return_ids), "lock": threading.Lock(),
                  "attempts": 0}
        with self._lineage_lock:
            for oid in return_ids:
                self._lineage[oid] = record
            while len(self._lineage) > config.max_lineage_entries:
                self._lineage.pop(next(iter(self._lineage)))

    def _try_reconstruct(self, oid: ObjectID) -> bool:
        """Re-execute the producing task of a lost object (reference:
        ObjectRecoveryManager, object_recovery_manager.h:41,96-106). Returns
        False when no lineage is known (e.g. a put object)."""
        with self._lineage_lock:
            record = self._lineage.get(oid)
        if record is None:
            return False
        with record["lock"]:
            # If another thread already reset this entry, just wait on it.
            if not self.store.is_ready(oid):
                return True
            if record["attempts"] >= config.reconstruction_max_attempts:
                return False
            record["attempts"] += 1
            for rid in record["return_ids"]:
                self.store.reset_pending(rid)
            arg_refs = _collect_top_level_refs(
                *serialization.deserialize(record["spec"]["args_blob"]))
            self.submitter.submit(record["spec"], record["options"],
                                  record["return_ids"], arg_refs)
        return True

    def _handle_reconstruct(self, oid_bytes: bytes) -> bool:
        """Borrower-requested reconstruction of an owned object."""
        return self._try_reconstruct(ObjectID(oid_bytes))

    # -------------------------------------------------- task submission

    def submit_task(self, func_key: str, desc: str,
                    args: tuple, kwargs: dict, options: Dict[str, Any]
                    ) -> List[ObjectRef]:
        task_id = TaskID.from_random()
        num_returns = options.get("num_returns", 1)
        streaming = num_returns == "streaming"
        if streaming:
            num_returns = 0
        return_ids = [ObjectID.from_random() for _ in range(num_returns)]
        refs = [ObjectRef(oid, self.addr) for oid in return_ids]
        for oid in return_ids:
            self.store.create_pending(oid)
        arg_refs = _collect_top_level_refs(args, kwargs)
        # Function body travels via the controller KV (exported once per
        # cluster, fetched once per worker) — not with every task spec.
        # All refs pickled into args (any nesting depth) are captured and
        # kept alive by the submitter until the task replies, so the owner
        # can't free them while the task is in flight.
        with serialization.capture_refs() as held_refs:
            args_blob = serialization.serialize((args, kwargs))
        spec = {
            "task_id": task_id.binary(),
            "func_key": func_key,
            "desc": desc,
            "args_blob": args_blob,
            "return_ids": [o.binary() for o in return_ids],
            "owner_addr": self.addr,
        }
        if not options.get("inline_results", True):
            spec["force_shm"] = True
        from ray_tpu_torch.util import tracing

        trace_ctx = tracing.context_for_spec()
        if trace_ctx is not None:
            spec["trace"] = trace_ctx
        if streaming:
            spec["streaming"] = True
            self._stream_state(task_id.binary())  # exists before items land
            self.submitter.submit(spec, options, return_ids, arg_refs,
                                  held_refs)
            return ObjectRefGenerator(self, task_id.binary(), desc)
        if options.get("max_retries", 3) > 0:
            self.record_lineage(return_ids, spec, options)
        self.submitter.submit(spec, options, return_ids, arg_refs,
                              held_refs)
        return refs

    # ---------------------------------------------------- task execution

    def _load_function(self, func_key: str, func_blob: Optional[bytes]):
        with self._fn_cache_lock:
            fn = self._fn_cache.get(func_key)
        if fn is not None:
            return fn
        if func_blob is None:
            func_blob = self.controller.call("kv_get", func_key)
            if func_blob is None:
                raise RayTpuError(f"function {func_key} not found in KV")
        fn = serialization.loads_function(func_blob)
        with self._fn_cache_lock:
            self._fn_cache[func_key] = fn
        return fn

    def _resolve_args(self, args_blob: bytes):
        args, kwargs = serialization.deserialize(args_blob)
        args = tuple(
            self._get_one(a, None) if isinstance(a, ObjectRef) else a
            for a in args)
        kwargs = {
            k: self._get_one(v, None) if isinstance(v, ObjectRef) else v
            for k, v in kwargs.items()}
        return args, kwargs

    def _handle_push_task(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        """Execute a normal task; reply carries serialized results.

        Reference: the PushTask execution path in ``_raylet.pyx:2259``
        (task_execution_handler) minus the Cython; results return in-band to
        the owner (reference inlines <100KB returns the same way)."""
        # A push that arrives near/past the lease-reclamation window may
        # race a reclaim-and-re-grant: running it would execute two leases'
        # tasks concurrently on one pooled worker (resources double-booked).
        # Validate against the node's CURRENT lease_seq only in that rare
        # late window — the common path (push within seconds of the grant,
        # which reclamation provably cannot have touched) stays RPC-free.
        lease_seq = spec.get("lease_seq")
        lease_ts = spec.get("lease_ts")  # node monotonic; same host as us
        if (lease_seq is not None and lease_ts is not None
                and config.lease_undelivered_timeout_s > 0
                and time.monotonic() - lease_ts
                > max(0.5, config.lease_undelivered_timeout_s - 2.0)):
            try:
                still_mine = self.clients.get(self.node_addr).call(
                    "validate_lease", self.worker_id.binary(), lease_seq,
                    timeout=5.0)
            except Exception:
                still_mine = True  # node unreachable: keep pre-check behavior
            if not still_mine:
                return {"ok": False, "stale_lease": True}
        self.tasks_received += 1
        self.active_tasks += 1
        try:
            fn = self._load_function(spec["func_key"], spec.get("func_blob"))
            args, kwargs = self._resolve_args(spec["args_blob"])
            self._current_task_desc.value = spec.get("desc", "")
            from ray_tpu_torch.util import tracing

            with tracing.activate(spec.get("trace"),
                                  name=f"task:{spec.get('desc', '')}"):
                result = fn(*args, **kwargs)
                if spec.get("streaming"):
                    # Streaming-generator task: push each yielded item to
                    # the owner as it is produced (reference: streaming
                    # returns, ReportGeneratorItemReturns); the reply
                    # carries only the final count. Iteration runs the
                    # USER's generator body, so it stays inside the trace
                    # context.
                    owner = self.clients.get(spec["owner_addr"])
                    count = 0
                    for item in result:
                        owner.call("stream_item", spec["task_id"], count,
                                   self._pack_results([item])[0])
                        count += 1
                    return {"ok": True, "results": [],
                            "stream_len": count}
            n = len(spec["return_ids"])
            if n == 0:
                results = []
            elif n == 1:
                results = [result]
            else:
                result = tuple(result)
                if len(result) != n:
                    raise ValueError(
                        f"task {spec['desc']} declared num_returns={n} but "
                        f"returned {len(result)} values")
                results = list(result)
            return {"ok": True, "results": self._pack_results(
                results, force_shm=spec.get("force_shm", False))}
        except BaseException as e:  # noqa: BLE001 — shipped to the owner
            err = TaskError(e, task_desc=spec.get("desc", ""))
            return {"ok": False,
                    "error_frame": serialization.serialize(err)}
        finally:
            self._current_task_desc.value = None
            self.active_tasks -= 1

    def _handle_push_task_batch(self, specs: List[Dict[str, Any]]):
        """Execute a pipelined batch serially on this worker: one RPC for
        N same-lease tasks (the owner's lease-pipelining runner batches
        small ready tasks — per-task RPC overhead is the throughput
        ceiling for fine-grained work). All specs share one lease; the
        late-push staleness check runs once."""
        first = specs[0]
        lease_seq = first.get("lease_seq")
        lease_ts = first.get("lease_ts")
        if (lease_seq is not None and lease_ts is not None
                and config.lease_undelivered_timeout_s > 0
                and time.monotonic() - lease_ts
                > max(0.5, config.lease_undelivered_timeout_s - 2.0)):
            try:
                still_mine = self.clients.get(self.node_addr).call(
                    "validate_lease", self.worker_id.binary(), lease_seq,
                    timeout=5.0)
            except Exception:
                still_mine = True
            if not still_mine:
                return {"stale_lease": True}
        replies = []
        for spec in specs:
            spec.pop("lease_seq", None)  # checked once above
            spec.pop("lease_ts", None)
            replies.append(self._handle_push_task(spec))
        return replies

    def _pack_results(self, results: List[Any],
                      force_shm: bool = False) -> List[tuple]:
        """Serialize task returns; large frames go into this node's shm store
        and ship as locators (reference: small returns in-band to the owner's
        memory store, large returns plasma-put — core_worker task reply
        path). Each element is ("inline", bytes, nested_refs) or
        ("shm", locator, nested_refs); nested_refs are the ObjectRefs pickled
        inside the frame — the owner pins them for the frame's lifetime.

        ``force_shm`` (task option ``inline_results=False``) routes even
        small returns through the node store: an all-to-all exchange emits
        P^2 sub-threshold slices whose inline copies would otherwise pile
        up O(dataset) in the owner's heap while the exchange is in flight
        (the reference keeps shuffle chunks in plasma for the same
        reason)."""
        packed = []
        for r in results:
            with serialization.capture_refs() as nested:
                total, write = serialization.build_frame(r)
            if force_shm or total > config.inline_object_max_bytes:
                oid = ObjectID.from_random()
                locator = self._try_put_frame(oid, total, write)
                if locator is not None:
                    packed.append(("shm", locator, nested))
                    continue
            out = bytearray(total)
            write(out)
            packed.append(("inline", bytes(out), nested))
        return packed

    # ------------------------------------------------ streaming generators

    def _stream_state(self, task_id: bytes) -> Optional[Dict[str, Any]]:
        """Live stream state, creating it on first touch. ``None`` means
        the consumer dropped the stream (tombstone): late pushes must NOT
        resurrect it (they would pin refs forever)."""
        with self._streams_cond:
            if task_id in self._streams:
                return self._streams[task_id]  # may be a None tombstone
            state = {"items": {}, "arrived": set(), "total": None,
                     "error": None}
            self._streams[task_id] = state
            return state

    def _handle_stream_item(self, task_id: bytes, index: int,
                            packed: tuple) -> None:
        """Owner-side: one yielded item from a streaming-generator task
        (reference: ReportGeneratorItemReturns, core_worker.proto — items
        stream back before the task finishes). The arrival check-and-claim
        is atomic under the stream condition, so concurrent duplicate
        pushes (original worker + retry) fulfil each index exactly once."""
        state = self._stream_state(task_id)
        if state is None:
            return  # consumer dropped the stream; discard late pushes
        with self._streams_cond:
            if index in state["arrived"]:
                return  # duplicate from a retry
            state["arrived"].add(index)
        oid = ObjectID(
            hashlib.sha256(task_id + index.to_bytes(4, "little")).digest()
            [:ObjectID.NBYTES])
        self.store.create_pending(oid)
        self.fulfil_result(oid, packed)
        with self._streams_cond:
            # Holding the ref in the state keeps the item alive until the
            # consumer takes it (the ref sweeper frees unreferenced ids).
            state["items"][index] = ObjectRef(oid, self.addr)
            self._streams_cond.notify_all()

    def _finish_stream(self, task_id: bytes, total: Optional[int],
                       error: Optional[BaseException]) -> None:
        state = self._stream_state(task_id)
        if state is None:
            return
        with self._streams_cond:
            state["total"] = (total if total is not None
                              else len(state["arrived"]))
            state["error"] = error
            self._streams_cond.notify_all()

    def stream_next(self, task_id: bytes, index: int,
                    timeout: Optional[float] = None):
        """Block until item ``index`` exists; returns its ObjectRef or
        raises StopIteration/the task error. Single-consumer: the handed-
        over ref is removed from the state (the caller's ref is the live
        handle), so consumed items free as the consumer releases them
        instead of accumulating for the stream's lifetime."""
        state = self._stream_state(task_id)
        if state is None:
            raise StopIteration
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._streams_cond:
            while True:
                if index in state["items"]:
                    return state["items"].pop(index)
                if state["error"] is not None:
                    raise state["error"]
                if state["total"] is not None and index >= state["total"]:
                    raise StopIteration
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    from ray_tpu_torch.core.errors import GetTimeoutError

                    raise GetTimeoutError(
                        f"stream item {index} not ready in {timeout}s")
                self._streams_cond.wait(
                    1.0 if remaining is None else min(remaining, 1.0))

    def drop_stream(self, task_id: bytes) -> None:
        """Release a stream's state (its held item refs free via the normal
        refcount path) — called when the consuming generator is GC'd. A
        bounded tombstone remains so late pushes from the still-running
        task are discarded instead of resurrecting the state."""
        with self._streams_cond:
            self._streams[task_id] = None
            tombstones = [k for k, v in self._streams.items() if v is None]
            for k in tombstones[:-256]:
                del self._streams[k]

    def fulfil_result(self, oid: ObjectID, packed: tuple) -> None:
        """Owner-side: record a packed task result; refs nested in the frame
        (already re-materialized by the RPC deserializer, so their handles
        are registered) stay pinned by the entry."""
        kind, payload = packed[0], packed[1]
        if len(packed) > 2 and packed[2]:
            self.store.set_nested(oid, packed[2])
        if kind == "shm":
            self.store.put_shm_ref(oid, payload)
        else:
            self.store.put_serialized(oid, payload)

    # -------------------------------------------------------- actor side

    def _handle_start_actor(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        self.tasks_received += 1
        # active_tasks covers the WHOLE __init__: the node's lease reaper
        # must see this worker as busy while a slow constructor (model
        # load) runs, or it would reclaim a delivered actor lease.
        self.active_tasks += 1
        try:
            cls = self._load_function(spec["cls_key"], spec.get("cls_blob"))
            args, kwargs = self._resolve_args(spec["args_blob"])
            instance = cls(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001
            err = TaskError(e, task_desc=f"{spec.get('desc', '')}.__init__")
            return {"ok": False, "error_frame": serialization.serialize(err)}
        finally:
            self.active_tasks -= 1
        self._actor_runtime = ActorExecutionRuntime(
            self, instance,
            max_concurrency=spec.get("max_concurrency", 1),
        )
        return {"ok": True}

    def _handle_push_actor_task(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        if self._actor_runtime is None:
            raise ActorDiedError(reason="actor not started on this worker")
        return self._actor_runtime.execute(spec)

    def _handle_shutdown(self) -> None:
        self._shutdown.set()

    # --------------------------------------------------------- lifecycle

    def shutdown(self) -> None:
        self._shutdown.set()
        self.submitter.stop()
        self.controller.close()
        self.clients.close_all()
        self.server.stop()


# --------------------------------------------------------------------------
# Submitter
# --------------------------------------------------------------------------


class TaskSubmitter:
    """Owner-side async task submitter (reference:
    ``CoreWorkerDirectTaskSubmitter``, direct_task_transport.h:75)."""

    def __init__(self, core: CoreWorker):
        self._core = core
        self._pool = ThreadPoolExecutor(max_workers=32,
                                        thread_name_prefix="submit")
        self._stopped = False
        # Lease pipelining: ready same-shape tasks queue here and a
        # BOUNDED set of runner threads drains them, each holding one
        # lease (see submit/_runner). Unbounded runners would degenerate
        # to one-lease-per-task (every pool thread grabs its own item).
        self._reuse_lock = threading.Lock()
        self._reuse_queues: Dict[tuple, deque] = {}
        self._runners: Dict[tuple, int] = {}

    _RUNNER_CAP = 16  # max concurrent pipelining leases per shape

    def submit(self, spec, options, return_ids: List[ObjectID],
               arg_refs: List[ObjectRef],
               held_refs: Optional[List[ObjectRef]] = None) -> None:
        # held_refs: every ref serialized into the args (incl. nested) —
        # passing them through the work item keeps their handles
        # registered until execution finishes, exactly the in-flight
        # window.
        core = self._core
        key = self._reuse_key(spec, options)
        # RETRIABLE items whose deps are ALREADY ready enter the shared
        # pipeline: runner threads execute queued items back-to-back on
        # leased workers (one push per task instead of
        # pick+lease+push+return). Anything with unresolved deps takes
        # the solo path, which may block on them without holding a lease
        # (the original no-lease-holding-deadlock rule); non-retriable
        # tasks also go solo — a reused worker that died since its last
        # task would convert their never-executed push into a terminal
        # crash, where the solo path's fresh lease gets a live worker.
        if (key is not None
                and options.get("max_retries", 3) > 0
                and options.get("retry_on_crash", True)
                and all(core.store.is_ready(r.id) for r in arg_refs)):
            item = (spec, options, return_ids, arg_refs, held_refs)
            with self._reuse_lock:
                q = self._reuse_queues.setdefault(key, deque())
                q.append(item)
                n_runners = self._runners.get(key, 0)
                spawn = (n_runners < self._RUNNER_CAP
                         and (n_runners == 0
                              or len(q) > 4 * n_runners))
                if spawn:
                    self._runners[key] = n_runners + 1
            if spawn:
                self._pool.submit(self._runner, key)
            return
        self._pool.submit(self._run_item, spec, options, return_ids,
                          arg_refs, held_refs, None, False)

    def stop(self) -> None:
        self._stopped = True
        self._pool.shutdown(wait=False, cancel_futures=True)

    def _fail(self, return_ids: List[ObjectID], err: BaseException) -> None:
        for oid in return_ids:
            self._core.store.put_error(oid, err)

    def _return_worker_safely(self, node_addr, worker_id, resources,
                              bundle, dead: bool,
                              lease_seq: Optional[int] = None) -> None:
        """Return a lease without letting a transport blip become the
        TASK's error: one fresh-socket retry, then give up — the node's
        reaper reclaims the lease anyway once the worker self-reports
        idle past lease_undelivered_timeout_s (_reclaim_undelivered_
        leases), so a doubly-lost return degrades to a short capacity dip,
        not a leak. The lease_seq makes the retry idempotent — a first
        attempt that was APPLIED but whose reply was lost cannot
        double-credit/double-pool (the node's generation check no-ops the
        duplicate)."""
        for attempt in range(2):
            try:
                self._core.clients.get(tuple(node_addr)).call(
                    "return_worker", worker_id, resources, bundle, dead,
                    lease_seq, timeout=10.0)
                return
            except (RpcError, RemoteCallError, TimeoutError):
                self._core.clients.invalidate(tuple(node_addr))

    # ------------------------------------------------ lease pipelining

    @staticmethod
    def _reuse_key(spec, options):
        """Tasks that can share a leased worker back-to-back (reference:
        direct_task_transport's lease reuse + pipelining): plain tasks
        only — no PG bundle, no scheduling strategy, no runtime env. The
        key is the resource shape the lease was granted for."""
        if (options.get("placement") is not None
                or options.get("scheduling_strategy") is not None
                or options.get("runtime_env") is not None):
            return None
        res = options.get("resources", {"CPU": 1.0})
        return tuple(sorted(res.items()))

    _BATCH_MAX = 16

    def _runner(self, key) -> None:
        """Pool entry for one pipelining runner (accounted in
        self._runners). The exit race — runner sees an empty queue and
        leaves exactly as an enqueuer declines to spawn because it saw
        this runner alive — is healed in the finally: the LAST runner out
        respawns itself if items remain."""
        try:
            self._drain_pipeline(key)
        finally:
            respawn = False
            with self._reuse_lock:
                self._runners[key] = self._runners.get(key, 1) - 1
                q = self._reuse_queues.get(key)
                if q and self._runners[key] == 0:
                    self._runners[key] = 1
                    respawn = True
            if respawn:
                self._pool.submit(self._runner, key)

    def _drain_pipeline(self, key) -> None:
        """Runner: pop queued same-shape items and execute them on ONE
        leased worker until the queue drains (then return the lease).
        Once a lease is held, RETRIABLE items ship as push_task_batch
        groups (one RPC per up-to-16 tasks). Concurrency comes from the
        pool: up to pool-width runners per shape, each with its own
        lease."""
        state = None
        try:
            while True:
                with self._reuse_lock:
                    q = self._reuse_queues.get(key)
                    item = q.popleft() if q else None
                if item is None:
                    return
                if state is None:
                    spec, options, return_ids, arg_refs, held_refs = item
                    state = self._run_item(spec, options, return_ids,
                                           arg_refs, held_refs, None,
                                           True)
                    continue
                def batchable(it):
                    # Non-retriable tasks never batch (a mid-batch crash
                    # can't attribute execution); streaming replies need
                    # the solo reply shape.
                    return (it[1].get("max_retries", 3) > 0
                            and it[1].get("retry_on_crash", True)
                            and not it[0].get("streaming"))

                batch = [item]
                if batchable(item):
                    with self._reuse_lock:
                        q = self._reuse_queues.get(key)
                        while (q and len(batch) < self._BATCH_MAX
                               and batchable(q[0])):
                            batch.append(q.popleft())
                if len(batch) == 1:
                    spec, options, return_ids, arg_refs, held_refs = item
                    state = self._run_item(spec, options, return_ids,
                                           arg_refs, held_refs, state,
                                           True)
                else:
                    state = self._push_batch(batch, state)
        finally:
            if state is not None:
                self._return_worker_safely(
                    state["node_addr"], state["worker_id"],
                    state["resources"], None, False, state["lease_seq"])

    def _push_batch(self, batch, state):
        """Ship a batch of retriable items to the held worker in one RPC.
        Any transport failure or stale lease falls back to per-item solo
        execution (their normal retry budgets intact)."""
        core = self._core
        t_submit = time.time()
        specs = []
        for spec, _o, _r, _a, _h in batch:
            spec["lease_seq"] = state["lease_seq"]
            spec["lease_ts"] = state["lease_ts"]
            specs.append(spec)
        try:
            replies = core.clients.get(state["worker_addr"]).call(
                "push_task_batch", specs, timeout=None)
        except (RpcError, RemoteCallError, TimeoutError):
            self._return_worker_safely(
                state["node_addr"], state["worker_id"],
                state["resources"], None, True, state["lease_seq"])
            core.clients.invalidate(state["worker_addr"])
            self._resubmit_solo(batch)
            return None
        if isinstance(replies, dict) and replies.get("stale_lease"):
            self._resubmit_solo(batch)
            return None
        t_done = time.time()
        worker_hex = WorkerID(state["worker_id"]).hex()
        for (spec, _o, return_ids, _a, _h), reply in zip(batch, replies):
            if reply["ok"]:
                for oid, packed in zip(return_ids, reply["results"]):
                    core.fulfil_result(oid, packed)
            else:
                for oid in return_ids:
                    core.store.put_serialized(oid, reply["error_frame"])
            core.record_task_event({
                "task_id": TaskID(spec["task_id"]).hex(),
                "desc": spec.get("desc", ""),
                "state": "FINISHED" if reply["ok"] else "FAILED",
                "submitted_ts": t_submit, "lease_ts": t_submit,
                "end_ts": t_done, "worker": worker_hex,
                "owner": core.addr,
                "trace_id": (spec.get("trace") or {}).get("trace_id")})
        return state

    def _resubmit_solo(self, batch) -> None:
        for spec, options, return_ids, arg_refs, held_refs in batch:
            self._pool.submit(self._run_item, spec, options, return_ids,
                              arg_refs, held_refs, None, False)

    def _run_item(self, spec, options, return_ids, arg_refs,
                  held_refs, state, keep_lease: bool):
        """Execute one task. ``state`` (from a previous item) short-cuts
        pick+lease and pushes straight to the already-leased worker; any
        failure there falls back to the full path with normal retry
        semantics. Returns the (possibly new) lease state when
        ``keep_lease`` and the push succeeded, else None."""
        core = self._core
        t_submit = time.time()
        t_lease = t_run = None
        worker_hex = None
        new_state = None
        try:
            # 1. Resolve dependencies BEFORE leasing a worker
            #    (dependency_resolver.h — avoids lease-holding deadlock).
            #    Readiness only; the executor pulls values itself.
            for ref in arg_refs:
                core.wait_ready(ref, None)
            retries_left = options.get("max_retries", 3)
            excluded: List[bytes] = []
            lease_attempts = 0
            stale_leases = 0
            deadline = time.monotonic() + config.worker_lease_timeout_s
            while True:
                reused = state is not None
                if reused:
                    # Lease-reuse fast path: the runner already holds a
                    # compatible worker.
                    node_addr = state["node_addr"]
                    worker_id = state["worker_id"]
                    worker_addr = state["worker_addr"]
                    lease_seq = state["lease_seq"]
                    lease_ts_val = state["lease_ts"]
                    bundle = None
                    node_client = core.clients.get(tuple(node_addr))
                    state = None  # consumed; errors below re-lease fresh
                else:
                    # 2. Cluster-level node selection. Transport errors to
                    #    the controller (lossy network, head blip) are
                    #    retried within the lease deadline like any other
                    #    transient — the ReconnectingClient reopens the
                    #    socket underneath.
                    placement = options.get("placement")
                    picked_node_id: Optional[bytes] = None
                    try:
                        if placement is not None:
                            target = core.controller.call(
                                "get_placement_group", placement[0])
                        else:
                            pick = core.controller.call(
                                "pick_node",
                                options.get("resources", {"CPU": 1.0}),
                                options.get("scheduling_strategy"),
                                core.node_id.binary(), excluded)
                    except (RpcError, TimeoutError):
                        if time.monotonic() > deadline:
                            raise
                        time.sleep(0.2)
                        continue
                    if placement is not None:
                        if (target is None
                                or placement[1] not in target["placement"]):
                            raise RayTpuError(
                                f"placement group bundle {placement} "
                                f"not ready")
                        node_addr = target["placement"][placement[1]][1]
                        bundle = (placement[0], placement[1])
                    else:
                        if pick is None:
                            if time.monotonic() > deadline:
                                raise RayTpuError(
                                    f"no feasible node for resources "
                                    f"{options.get('resources')}")
                            time.sleep(0.2)
                            excluded = []
                            continue
                        node_addr = pick["addr"]
                        picked_node_id = pick["node_id"]
                        bundle = None
                    # 3. Worker lease from the chosen node. Transport
                    #    errors (node died between pick and lease) count
                    #    as lease failures: exclude the node and re-pick.
                    # Spillback (reference: hybrid_scheduling_policy.cc
                    # redirects): the first two lease attempts use a SHORT
                    # patience — if the picked node is busy, the quick
                    # "lease timeout" reply excludes it and re-picks
                    # another node instead of queueing behind a stale
                    # choice. Later attempts wait out the owner's
                    # remaining deadline (genuinely saturated cluster).
                    # Both are clamped to that deadline.
                    remaining = max(0.2, deadline - time.monotonic())
                    early_attempt = lease_attempts < 2 and bundle is None
                    patience = (min(5.0, remaining) if early_attempt
                                else remaining)
                    lease_attempts += 1
                    try:
                        node_client = core.clients.get(node_addr)
                        lease = node_client.call(
                            "lease_worker",
                            options.get("resources", {"CPU": 1.0}),
                            bundle, patience, False,
                            options.get("runtime_env"),
                            {"retriable": retries_left > 0
                                and options.get("retry_on_crash", True),
                             "owner": core.node_id.hex()},
                            # Early attempts may be spillback-rejected by
                            # a backlogged node (re-pick elsewhere); later
                            # attempts settle into the queue so a
                            # saturated or single-node cluster still makes
                            # progress.
                            early_attempt,
                            # Track the attempt's patience, not the global
                            # lease deadline: a LOST REPLY on a
                            # 5s-patience spillback probe must not block
                            # 40s (one lost packet would eat the whole
                            # lease budget).
                            timeout=patience + 10.0)
                    except (RpcError, RemoteCallError, TimeoutError) as e:
                        core.clients.invalidate(tuple(node_addr))
                        lease = {"error": f"node unreachable: {e}"}
                    if "error" in lease:
                        if picked_node_id is not None:
                            excluded.append(picked_node_id)
                        if (lease.get("permanent")
                                or time.monotonic() > deadline):
                            raise RayTpuError(
                                f"worker lease failed: {lease['error']}")
                        # PG-bundle leases don't go through the pick_node
                        # backoff above; sleep here so a busy node isn't
                        # RPC-hammered.
                        time.sleep(0.2)
                        continue
                    worker_id = lease["worker_id"]
                    worker_addr = lease["addr"]
                    lease_seq = lease.get("lease_seq")
                    lease_ts_val = lease.get("lease_ts")
                spec["lease_seq"] = lease_seq
                spec["lease_ts"] = lease_ts_val
                t_lease = time.time()
                worker_hex = WorkerID(worker_id).hex()
                # 4. Direct push to the leased worker.
                try:
                    reply = core.clients.get(worker_addr).call(
                        "push_task", spec, timeout=None)
                except (RpcError, RemoteCallError, TimeoutError) as e:
                    self._return_worker_safely(
                        node_addr, worker_id,
                        options.get("resources", {"CPU": 1.0}), bundle,
                        True, lease_seq)
                    core.clients.invalidate(worker_addr)
                    if (retries_left > 0
                            and options.get("retry_on_crash", True)):
                        retries_left -= 1
                        time.sleep(config.task_retry_delay_ms / 1000.0)
                        deadline = (time.monotonic()
                                    + config.worker_lease_timeout_s)
                        continue
                    # Terminal attempt: was this a node-initiated kill
                    # (memory monitor)? Surface the recorded cause
                    # instead of a generic crash.
                    try:
                        cause = node_client.call("worker_death_cause",
                                                 worker_id, timeout=2.0)
                    except Exception:
                        cause = None
                    if cause and "memory" in cause:
                        raise OutOfMemoryError(
                            f"task {spec['desc']} was killed by the node "
                            f"memory monitor: {cause}") from e
                    raise WorkerCrashedError(
                        f"worker died executing {spec['desc']}: {e}") from e
                if reply.get("stale_lease"):
                    # The node reclaimed this lease while the push crawled
                    # over the network; the worker refused to run it. The
                    # lease credit already happened at reclamation — take
                    # a fresh lease and push again, but BOUNDED: a link
                    # whose every push outlives the reclamation window
                    # would otherwise livelock here forever.
                    stale_leases += 1
                    if stale_leases > 5:
                        raise RayTpuError(
                            f"task {spec['desc']}: {stale_leases} leases "
                            "reclaimed before their push arrived — link "
                            "slower than lease_undelivered_timeout_s "
                            f"({config.lease_undelivered_timeout_s}s)")
                    time.sleep(0.2 * stale_leases)
                    deadline = (time.monotonic()
                                + config.worker_lease_timeout_s)
                    continue
                if keep_lease and bundle is None:
                    # The runner keeps this lease for the next queued
                    # item (returned below); the node sees continuous
                    # task progress through worker_ping, which exempts
                    # the lease from idle reclamation.
                    new_state = {"node_addr": node_addr,
                                 "worker_id": worker_id,
                                 "worker_addr": worker_addr,
                                 "lease_seq": lease_seq,
                                 "lease_ts": lease_ts_val,
                                 "resources": options.get(
                                     "resources", {"CPU": 1.0})}
                else:
                    # Best-effort with one fresh-socket retry: the task
                    # already SUCCEEDED — a lossy link must not convert a
                    # lost lease return into a task failure (the node's
                    # reaper re-credits the lease when the worker idles
                    # out or dies).
                    self._return_worker_safely(
                        node_addr, worker_id,
                        options.get("resources", {"CPU": 1.0}), bundle,
                        False, lease_seq)
                t_run = time.time()
                break
            # 5. Fulfil owned return objects.
            if reply["ok"]:
                for oid, packed in zip(return_ids, reply["results"]):
                    core.fulfil_result(oid, packed)
                if spec.get("streaming"):
                    core._finish_stream(spec["task_id"],
                                        reply.get("stream_len"), None)
            else:
                for oid in return_ids:
                    self._core.store.put_serialized(oid,
                                                    reply["error_frame"])
                if spec.get("streaming"):
                    core._finish_stream(
                        spec["task_id"], None,
                        serialization.deserialize(reply["error_frame"]))
            core.record_task_event({
                "task_id": TaskID(spec["task_id"]).hex(),
                "desc": spec.get("desc", ""),
                "state": "FINISHED" if reply["ok"] else "FAILED",
                "submitted_ts": t_submit, "lease_ts": t_lease,
                "end_ts": t_run, "worker": worker_hex,
                "owner": core.addr,
                "trace_id": (spec.get("trace") or {}).get("trace_id")})
            return new_state
        except BaseException as e:  # noqa: BLE001
            core.record_task_event({
                "task_id": TaskID(spec["task_id"]).hex(),
                "desc": spec.get("desc", ""), "state": "FAILED",
                "submitted_ts": t_submit, "lease_ts": t_lease,
                "end_ts": time.time(), "worker": worker_hex,
                "owner": core.addr, "error": repr(e)})
            self._fail(return_ids, e)
            if spec.get("streaming"):
                core._finish_stream(spec["task_id"], None, e)
            return None


class ObjectRefGenerator:
    """Iterator over a streaming-generator task's yielded ObjectRefs
    (reference: ``ObjectRefGenerator``/``StreamingObjectRefGenerator`` from
    ``num_returns="streaming"``). ``next()`` blocks until the next item has
    streamed back from the still-running task; iteration ends when the task
    returns, and raises the task's error if it failed."""

    def __init__(self, core: "CoreWorker", task_id: bytes, desc: str):
        self._core = core
        self._task_id = task_id
        self._desc = desc
        self._index = 0

    def __iter__(self) -> "ObjectRefGenerator":
        return self

    def __next__(self) -> ObjectRef:
        ref = self._core.stream_next(self._task_id, self._index)
        self._index += 1
        return ref

    def next_ready(self, timeout: float) -> ObjectRef:
        """Like ``next()`` but bounded by ``timeout`` (GetTimeoutError)."""
        ref = self._core.stream_next(self._task_id, self._index, timeout)
        self._index += 1
        return ref

    def __repr__(self) -> str:
        return (f"ObjectRefGenerator({self._desc}, "
                f"consumed={self._index})")

    def __del__(self):
        core = getattr(self, "_core", None)
        if core is not None:
            try:
                core.drop_stream(self._task_id)
            except Exception:  # graftlint: disable=swallowed-exception
                # __del__ during interpreter teardown: anything (even
                # logging) may already be torn down. Stay silent.
                pass


# --------------------------------------------------------------------------
# Actor-side execution runtime
# --------------------------------------------------------------------------


class ActorExecutionRuntime:
    """Executes actor tasks with per-caller ordering.

    Reference: ``ActorSchedulingQueue`` (in-order by sequence number per
    caller) vs ``OutOfOrderActorSchedulingQueue`` for ``max_concurrency > 1``
    and async actors (``direct_actor_task_submitter.h``, ``fiber.h``).
    """

    def __init__(self, core: CoreWorker, instance: Any, max_concurrency: int = 1):
        self.core = core
        self.instance = instance
        self.max_concurrency = max(1, int(max_concurrency))
        self.is_async = _has_async_methods(instance)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._exec_lock = threading.Lock()  # single-threaded actor body
        # per-caller ordering state: owner addr -> [next expected seq, heap]
        self._order: Dict[Addr, List[Any]] = {}
        if self.is_async:
            import asyncio

            self._loop = asyncio.new_event_loop()
            self._loop_thread = threading.Thread(
                target=self._loop.run_forever, name="actor-asyncio", daemon=True)
            self._loop_thread.start()
        elif self.max_concurrency > 1:
            self._exec_pool = ThreadPoolExecutor(
                max_workers=self.max_concurrency, thread_name_prefix="actor")

    def execute(self, spec: Dict[str, Any]) -> Dict[str, Any]:
        method_name = spec["method"]
        desc = spec.get("desc", method_name)
        try:
            from ray_tpu_torch.util import tracing

            method = getattr(self.instance, method_name)
            args, kwargs = self.core._resolve_args(spec["args_blob"])
            with tracing.activate(spec.get("trace"),
                                  name=f"actor:{method_name}"):
                if self.is_async:
                    result = self._run_async(method, args, kwargs)
                elif self.max_concurrency > 1:
                    # Copy the handler thread's context (incl. the active
                    # trace span) onto the pool thread running user code.
                    import contextvars as _cv

                    ctx = _cv.copy_context()
                    # graftlint: disable=unbounded-blocking-call (the wait IS the actor task: user code owns its duration, and the CALLER'S RpcClient timeout is the bound — a local cap here would kill legitimate long tasks)
                    result = self._exec_pool.submit(
                        lambda: ctx.run(method, *args, **kwargs)).result()
                else:
                    result = self._run_ordered(spec, method, args, kwargs)
            n = len(spec["return_ids"])
            if n == 0:
                results = []
            elif n == 1:
                results = [result]
            else:
                results = list(tuple(result))
                if len(results) != n:
                    raise ValueError(
                        f"actor method {desc} declared num_returns={n} but "
                        f"returned {len(results)} values")
            return {"ok": True, "results": self.core._pack_results(results)}
        except BaseException as e:  # noqa: BLE001
            err = TaskError(e, task_desc=desc)
            return {"ok": False, "error_frame": serialization.serialize(err)}

    def _run_async(self, method, args, kwargs):
        import asyncio
        import inspect

        if inspect.iscoroutinefunction(method):
            from ray_tpu_torch.util import tracing

            trace = tracing.current()  # handler thread's active span

            async def wrapped():
                # The event-loop thread has no trace context; re-enter the
                # caller's span inside the coroutine's own context.
                if trace is None:
                    return await method(*args, **kwargs)
                token = tracing._ctx.set(trace)
                try:
                    return await method(*args, **kwargs)
                finally:
                    tracing._ctx.reset(token)

            fut = asyncio.run_coroutine_threadsafe(wrapped(), self._loop)
            # graftlint: disable=unbounded-blocking-call (same contract as the pool branch: the coroutine IS the actor task and the caller's RPC timeout bounds it end-to-end)
            return fut.result()
        return method(*args, **kwargs)

    def _run_ordered(self, spec, method, args, kwargs):
        """Execute in per-caller submission order (seq numbers).

        Ordering state is keyed by (caller, epoch) — the epoch is the actor
        incarnation the caller believed it was talking to, so a restarted
        actor starts a fresh seq stream per caller. A seq *gap* (an earlier
        call failed before its push, or the caller's epoch view was stale)
        would otherwise wait forever; after ``_GAP_WAIT_S`` the queue gives up
        on the missing seq and proceeds — degraded ordering beats deadlock
        (the reference bounds this differently: failed submissions send
        negative acks to the scheduling queue)."""
        owner = (tuple(spec["owner_addr"]), spec.get("epoch", 0))
        seq = spec.get("seq")
        if seq is None:
            with self._exec_lock:
                return method(*args, **kwargs)
        deadline = time.monotonic() + _GAP_WAIT_S
        with self._cond:
            state = self._order.setdefault(owner, [0, []])
            while state[0] < seq:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    state[0] = seq  # skip the missing seq(s)
                    break
                self._cond.wait(min(remaining, 1.0))
                state = self._order.setdefault(owner, [0, []])
        try:
            with self._exec_lock:
                return method(*args, **kwargs)
        finally:
            with self._cond:
                state = self._order.setdefault(owner, [0, []])
                if seq >= state[0]:
                    state[0] = seq + 1
                self._cond.notify_all()


def _has_async_methods(instance) -> bool:
    import inspect

    for name in dir(instance):
        if name.startswith("__"):
            continue
        try:
            attr = getattr(instance, name)
        except Exception:
            continue
        if inspect.iscoroutinefunction(attr):
            return True
    return False


def _collect_top_level_refs(args: tuple, kwargs: dict) -> List[ObjectRef]:
    refs = [a for a in args if isinstance(a, ObjectRef)]
    refs += [v for v in kwargs.values() if isinstance(v, ObjectRef)]
    return refs
