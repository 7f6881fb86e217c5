"""Node supervisor: per-node scheduler daemon + worker pool (raylet equivalent;
copy of ``ray_tpu/core/node.py``).

GPU leases follow the JAX package's rule for TPU leases: a lease holding a
``GPU`` resource always gets a freshly spawned interpreter (``Popen``),
never a fork of the warm template, so no worker inherits a parent's CUDA
state; CPU-leased workers and the template run with ``accel_env_vars``
(``CUDA_VISIBLE_DEVICES``) emptied, so they cannot see the card.

A GPU lease names its cards, by upstream Ray's ``CUDA_VISIBLE_DEVICES`` rule
(``python/ray/_private/accelerators/nvidia_gpu.py``): the node keeps its
``GPU`` indices (mapped through its own ``CUDA_VISIBLE_DEVICES`` when that
names enough cards; a node that declares more ``GPU`` than the machine shows
is a test setup, and its indices reach the environment unchanged) and what
is free of each. A lease of whole cards takes whole free cards; a fractional
lease packs onto the fullest card it fits. The worker starts with
``CUDA_VISIBLE_DEVICES`` narrowed to those cards, so its ``cuda:0`` is the
first card it holds; the shares go back when the lease ends, and a pooled
GPU worker is reused only by a lease on the same cards.

Analogue of the reference's raylet (``src/ray/raylet/node_manager.h:119`` +
``worker_pool.h:159``): grants *worker leases* against the node's resource
pool (the local half of the two-level scheduler — cluster-level node selection
lives in the controller), forks and pools Python worker processes, reaps idle
and dead workers, reserves placement-group bundles (the node half of the 2PC
in ``placement_group_resource_manager.h``), and gossips its available
resources to the controller via heartbeats (standing in for the reference's
``RaySyncer`` resource-view stream, ``ray_syncer.h:88``).

Lease protocol (reference: ``node_manager.proto`` RequestWorkerLease /
ReturnWorker): a caller leases a worker, pushes task specs to it directly
(owner->worker, like the reference's direct task transport), and returns the
lease when its pipeline for that scheduling key drains. Leases block FIFO-ish
on the resource condition variable; ``return_worker`` and bundle ops are
inline RPC methods so they always make progress while lease calls wait.
"""

from __future__ import annotations

import logging
import math
import os
import pickle
import select
import signal
import struct
import subprocess
import sys
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core import resources as resmath
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.ids import NodeID, WorkerID
from ray_tpu_torch.core.rpc import ClientPool, ReconnectingClient, RpcServer
from ray_tpu_torch.core.rpc_stubs import ControllerStub
from ray_tpu_torch.util.ratelimit import log_every

logger = logging.getLogger(__name__)

Addr = Tuple[str, int]
BundleKey = Tuple[bytes, int]  # (placement group id, bundle index)


def shm_store_path(node_id: NodeID) -> str:
    """Deterministic store-file path for a node (all processes derive it)."""
    return os.path.join(config.object_store_fallback_dir, "ray_tpu_torch",
                        f"{node_id.hex()}.store")


def spill_dir(node_id: NodeID) -> str:
    """Per-node directory for objects spilled to disk when the shm store is
    full (reference: ``local_object_manager.h:110`` spill-to-filesystem; one
    dir per node keeps the multi-node-in-one-machine fixture honest)."""
    return os.path.join(config.object_spill_dir, node_id.hex())


def spill_file(node_id: NodeID, oid_bytes: bytes) -> str:
    return os.path.join(spill_dir(node_id), oid_bytes.hex() + ".bin")


CARD_ENV = "CUDA_VISIBLE_DEVICES"


def node_card_ids(count: int, env: Optional[Dict[str, str]] = None
                  ) -> List[str]:
    """The ids of a node's ``count`` cards: the first ``count`` entries of
    its ``CUDA_VISIBLE_DEVICES`` (``env`` first, then this process's) when
    that names as many, else ``0 .. count-1``."""
    visible = (env or {}).get(CARD_ENV, os.environ.get(CARD_ENV))
    ids = [x.strip() for x in (visible or "").split(",") if x.strip()]
    if len(ids) < count:
        return [str(i) for i in range(count)]
    return ids[:count]


def _runtime_env_hash(runtime_env: Optional[Dict[str, Any]]) -> str:
    if not runtime_env:
        return ""
    import hashlib
    import json

    return hashlib.sha1(
        json.dumps(runtime_env, sort_keys=True, default=str).encode()
    ).hexdigest()[:16]


def _kill_and_reap(proc: subprocess.Popen, force: bool) -> None:
    """Kill a worker process and reap it so no zombie lingers in the
    (long-lived) driver process hosting this node supervisor."""
    try:
        if force:
            proc.kill()
        else:
            proc.terminate()
    except OSError:
        pass
    try:
        proc.wait(timeout=5.0)
    except (subprocess.TimeoutExpired, OSError):
        pass


class _ForkserverError(Exception):
    """Template process unavailable/failed — callers fall back to spawn."""


class _PendingProc:
    """Placeholder proc while a forkserver child's pid reply is in flight.
    The handle must already be in the worker table (the warm child can hit
    ``register_worker`` within ms of ``os.fork``), and the reaper may look
    at it before the real ``_ForkedProc`` is swapped in."""

    pid = -1
    returncode: Optional[int] = None

    def poll(self) -> Optional[int]:
        return None

    def terminate(self) -> None:
        pass

    def kill(self) -> None:
        pass

    def wait(self, timeout: Optional[float] = None) -> int:
        raise subprocess.TimeoutExpired("pending-forked-worker", timeout or 0)


class _ForkedProc:
    """``subprocess.Popen``-shaped handle for a forkserver child.

    The worker is the FORKSERVER's child, not ours, so ``waitpid`` is not
    available here. Liveness and signalling go through a pidfd
    (``pidfd_open`` works for non-children; the fd pins the process
    identity, so PID reuse can neither fake liveness nor misdirect a
    kill — a recycled PID would otherwise leak the dead worker's lease
    forever). Fallback when pidfds are unavailable: /proc scraping (the
    forkserver reaps children via SIGCHLD, so a dead worker's /proc entry
    disappears; zombie state means the forkserver itself died first).
    Exit codes are unknown either way — any "gone" is reported as 1,
    which every caller treats the same as a crash."""

    def __init__(self, pid: int):
        self.pid = pid
        self.returncode: Optional[int] = None
        self._pidfd: Optional[int] = None
        # poll()/_signal()/__del__ race from reaper, lease, and
        # memory-monitor threads; the lock keeps the close-and-None
        # transition atomic so no thread touches a stale fd number.
        self._fd_lock = threading.Lock()
        try:
            self._pidfd = os.pidfd_open(pid)
        except (AttributeError, OSError):
            # Already exited (ESRCH) or pre-5.3 kernel: poll() decides via
            # /proc below.
            pass

    def poll(self) -> Optional[int]:
        with self._fd_lock:
            if self.returncode is not None:
                return self.returncode
            if self._pidfd is not None:
                # A pidfd becomes readable exactly when the process exits.
                # select.poll, not select.select: pidfds allocated past
                # FD_SETSIZE (1024 — easily reached by a worker surge in a
                # multi-node driver) would blow up select().
                p = select.poll()
                p.register(self._pidfd, select.POLLIN)
                if p.poll(0):
                    self.returncode = 1
                    os.close(self._pidfd)
                    self._pidfd = None
                return self.returncode
            # /proc fallback stays under the SAME lock: the returncode
            # transition must be atomic with _signal()'s dead-check, or a
            # worker that died (and had its PID recycled) between that
            # check and os.kill could deliver a stray signal to an
            # unrelated process.
            try:
                with open(f"/proc/{self.pid}/stat", "rb") as f:
                    stat = f.read()
                # Field 3, after the parenthesised comm (may hold spaces).
                state = stat.rsplit(b")", 1)[1].split()[0]
            except (OSError, IndexError):
                self.returncode = 1
                return self.returncode
            if state == b"Z":
                self.returncode = 1
                return self.returncode
            return None

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired("forked-worker", timeout)
            time.sleep(0.02)
        return self.returncode

    def _signal(self, sig: int) -> None:
        try:
            with self._fd_lock:
                if self._pidfd is not None:
                    signal.pidfd_send_signal(self._pidfd, sig)
                elif self.returncode is None:
                    os.kill(self.pid, sig)
                # else: already observed dead — a raw os.kill here could
                # hit an unrelated process that recycled the PID.
        except OSError:
            pass

    def terminate(self) -> None:
        self._signal(signal.SIGTERM)

    def kill(self) -> None:
        self._signal(signal.SIGKILL)

    def __del__(self):
        with self._fd_lock:
            if self._pidfd is not None:
                try:
                    os.close(self._pidfd)
                except OSError:
                    pass
                self._pidfd = None


class _LeaseWaiter:
    """One queued lease request. Granting reserves resources on behalf of the
    waiter before waking it, so grants are FIFO per resource pool and no
    waiter can be starved by lock-acquisition races (raylets queue tasks the
    same way: leases dispatch in order per scheduling class)."""

    __slots__ = ("resources", "bundle", "event", "granted", "cards")

    def __init__(self, resources: Dict[str, float], bundle):
        self.resources = resources
        self.bundle = bundle
        self.event = threading.Event()
        self.granted = False
        self.cards: List[Tuple[str, float]] = []  # (card id, share) granted


class _InFlight:
    """Counts RPC handlers that are using the node's store, so ``stop`` can
    close it after they finish (the handler pool is shut without waiting)."""

    def __init__(self):
        self._cv = threading.Condition()
        self._n = 0

    def __enter__(self):
        with self._cv:
            self._n += 1

    def __exit__(self, *exc):
        with self._cv:
            self._n -= 1
            if self._n == 0:
                self._cv.notify_all()

    def wait_idle(self, timeout: float) -> bool:
        with self._cv:
            return self._cv.wait_for(lambda: self._n == 0, timeout)


class WorkerHandle:
    def __init__(self, worker_id: WorkerID, proc: subprocess.Popen):
        self.worker_id = worker_id
        self.proc = proc
        self.addr: Optional[Addr] = None
        self.pid: Optional[int] = None  # the worker's own, at registration
        self.registered = threading.Event()
        self.idle = False
        self.dedicated = False  # actor workers are never pooled
        self.gpu = False        # spawned with the card visible (see _fork_worker)
        self.cards: List[str] = []  # its CUDA_VISIBLE_DEVICES, for life
        self.env_hash = ""      # runtime-env identity for pool matching
        self.env_dirs: List[str] = []  # cache dirs pinned against env GC
        self.tasks_received = 0        # worker-reported (worker_ping)
        self.reported_active = -1      # worker-reported in-flight tasks
        self.actor_started = False     # worker-reported actor runtime up
        self.last_ping_ts = 0.0        # when that report arrived
        self.last_progress_ts = 0.0    # when tasks_received last advanced
        self.lease_ts = 0.0            # when the current lease was granted
        # Lease generation: bumped on every grant AND reclamation, echoed
        # in return_worker so a duplicated or stale return (lost reply
        # retry, post-reclaim stragglers) can never credit someone else's
        # lease or double-pool the worker.
        self.lease_seq = 0
        self.last_used = time.monotonic()
        # Resources held by the current lease; credited back exactly once
        # (on lease return, worker kill, or death-reap — whichever first).
        self.lease_resources: Optional[Dict[str, float]] = None
        self.lease_bundle = None
        self.lease_cards: List[Tuple[str, float]] = []  # card shares held
        # Lease-time task metadata ({"retriable": bool, "owner": str}) used
        # by the memory monitor's worker-killing policies.
        self.task_meta: Optional[Dict[str, Any]] = None


class Node:
    def __init__(
        self,
        controller_addr: Addr,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        host: str = "127.0.0.1",
        env: Optional[Dict[str, str]] = None,
    ):
        self.node_id = NodeID.from_random()
        self.controller_addr = tuple(controller_addr)
        if resources is None:
            resources = {"CPU": float(os.cpu_count() or 1)}
        resources.setdefault("CPU", float(os.cpu_count() or 1))
        # Pod-slice topology: a node on a TPU slice (or opted into a
        # virtual slice via RAY_TPU_VIRTUAL_SLICE on the dev box)
        # advertises its slice shape at registration and exposes the
        # chip count as scalar `chips` / `slice:<id>` resources — the
        # controller's TopologyView schedules ICI-contiguous sub-slices
        # against the same totals.
        from ray_tpu_torch.core import topology as topo

        # Virtual slices key on the NODE id: in the multi-node-in-one-
        # machine fixture every node shares the host string, and two
        # nodes must advertise two distinct 8-chip slices, not co-own
        # one grid. Real slices key on pod metadata instead.
        self.slice_info = topo.detect_slice(resources,
                                            self.node_id.hex()[:12])
        if self.slice_info is not None:
            per_host = self.slice_info.chips / self.slice_info.hosts
            resources.setdefault(resmath.CHIPS, per_host)
            resources.setdefault(
                resmath.slice_key(self.slice_info.slice_id), per_host)
        self.total_resources = dict(resources)
        self.labels = dict(labels or {})
        self._extra_env = dict(env or {})
        self._card_ids = node_card_ids(
            int(math.ceil(resources.get("GPU", 0))), self._extra_env)
        self._card_free = {c: 1.0 for c in self._card_ids}

        # Per-node shared-memory object store (plasma equivalent). The path
        # is derived from the node id so every process on the node can open
        # it without plumbing (reference: plasma socket under the session
        # dir). One store file per node keeps the multi-node-in-one-machine
        # fixture honest: cross-node reads go through read_shm_object RPC.
        self.store_path = shm_store_path(self.node_id)
        from ray_tpu_torch._native.objstore import ShmStore

        self._shm = ShmStore.create(self.store_path,
                                    config.object_store_memory_bytes)
        self._store_users = _InFlight()

        self._lock = threading.Lock()
        self._available = dict(resources)
        self._bundles: Dict[BundleKey, Dict[str, Dict[str, float]]] = {}
        self._workers: Dict[WorkerID, WorkerHandle] = {}
        self._idle: List[WorkerHandle] = []
        self._waiters: List[_LeaseWaiter] = []  # FIFO lease queue
        self._queue_len = 0
        self._general_queue_len = 0  # waiters on the general (non-PG) pool
        self._death_causes: Dict[bytes, str] = {}
        # Worker processes (address and pid) started and gone since the
        # last report to the controller, which tells every owner to drop
        # the handle counts the gone ones held (``_report_workers``).
        # A handle leaves the table before its process may have exited
        # (an owner returns a worker as dead after a missed RPC): it waits
        # in ``_exit_watch`` until the reaper sees the process gone.
        self._started_report: List[Tuple[str, int, int]] = []
        self._dead_report: List[Tuple[str, int, int]] = []
        self._exit_watch: List[WorkerHandle] = []
        self._stopped = threading.Event()
        # Worker forkserver (lazy): one pre-imported template process that
        # os.fork()s default-env CPU workers in ~10 ms (worker_pool.h:357
        # PrestartWorkers-era economics on a 1-core box).
        self._fs_lock = threading.Lock()
        self._fs_proc: Optional[subprocess.Popen] = None

        self._server = RpcServer(
            handlers={
                "lease_worker": self.lease_worker,
                "return_worker": self.return_worker,
                "register_worker": self.register_worker,
                "create_actor_worker": self.create_actor_worker,
                "kill_worker": self.kill_worker,
                "reserve_bundle": self.reserve_bundle,
                "release_bundle": self.release_bundle,
                # whole-object read fallback for peers without chunked
                # pull; kept for external/debug tooling
                # graftlint: disable=rpc-dead-endpoint
                "read_shm_object": self.read_shm_object,
                "read_shm_chunk": self.read_shm_chunk,
                "free_shm_object": self.free_shm_object,
                "worker_death_cause": self.worker_death_cause,
                "list_workers": self.list_workers,
                # reference-parity PrestartWorkers hook, reserved for
                # the autoscaler's warm-up path
                # graftlint: disable=rpc-dead-endpoint
                "prestart_workers": self.prestart_workers,
                "get_info": self.get_info,
                "ping": lambda: "pong",
                "worker_ping": self.worker_ping,
                "validate_lease": self.validate_lease,
            },
            host=host,
            name="node",
            max_workers=128,
            # All quick map/list updates; the reactor write path queues
            # their replies (non-blocking sendmsg flush), so a stalled
            # peer can no longer freeze the node's reactor for 15 s per
            # reply — inlining is bounded by handler CPU only.
            inline_methods={"return_worker", "register_worker",
                            "worker_ping", "validate_lease", "reserve_bundle",
                            "release_bundle", "kill_worker",
                            "worker_death_cause", "ping"},
        )
        self.address: Addr = self._server.addr

        # Survives controller restarts: calls retry through a fresh socket
        # (head fault tolerance — the raylet outlives the GCS).
        self._controller = ReconnectingClient(self.controller_addr)
        self._controller.call(
            "register_node", self.node_id.binary(), self.address,
            self.total_resources, self.labels,
            self.slice_info.to_dict() if self.slice_info else None)
        self._heartbeat_thread = threading.Thread(
            target=self._heartbeat_loop, name="node-heartbeat", daemon=True)
        self._heartbeat_thread.start()
        # Cluster metrics pipeline: push this process's registry to the
        # controller on the heartbeat cadence when no core-worker
        # flusher owns the push (standalone `ray_tpu start` supervisors;
        # see core/metrics_agent.py for the single-pusher arbitration).
        from ray_tpu_torch.core.metrics_agent import MetricsAgent

        self.metrics_agent = MetricsAgent(self._controller,
                                          self.node_id.binary())
        self._reaper_thread = threading.Thread(
            target=self._reaper_loop, name="node-reaper", daemon=True)
        self._reaper_thread.start()
        self.memory_monitor = None
        if config.memory_monitor_refresh_s > 0:
            from ray_tpu_torch.core.memory_monitor import MemoryMonitor

            self.memory_monitor = MemoryMonitor(self)
        self.log_monitor = None
        if config.log_to_driver:
            from ray_tpu_torch.core.log_monitor import LogMonitor

            self.log_monitor = LogMonitor(self)

    # ----------------------------------------------------------- leasing

    def _pool_for(self, bundle: Optional[BundleKey]) -> Optional[Dict[str, float]]:
        if bundle is None:
            return self._available
        entry = self._bundles.get(tuple(bundle))
        return None if entry is None else entry["available"]

    def lease_worker(
        self,
        resources: Dict[str, float],
        bundle: Optional[BundleKey] = None,
        timeout: Optional[float] = None,
        dedicated: bool = False,
        runtime_env: Optional[Dict[str, Any]] = None,
        task_meta: Optional[Dict[str, Any]] = None,
        allow_spillback: bool = True,
    ) -> Dict[str, Any]:
        """Block until resources are free, then hand out a pooled or freshly
        forked worker. Returns {worker_id, addr} or {error}. ``dedicated``
        leases (actors) claim a matching warm pooled worker when available
        and fork otherwise — the worker holds the actor for life either way
        (reference: leases matched from pooled/prestarted workers,
        worker_pool.h:357; the forkserver refills the pool fast enough that
        actors can no longer starve the task pool).
        ``runtime_env`` (env_vars / working_dir) selects — or forks — a
        worker built with that environment (reference: the per-node
        runtime-env agent building envs for the worker pool,
        runtime_env_agent.py:162; pooled workers are matched by env like
        worker_pool.h's runtime_env_hash)."""
        timeout = timeout if timeout is not None else config.worker_lease_timeout_s
        bundle = tuple(bundle) if bundle is not None else None
        waiter = _LeaseWaiter(dict(resources), bundle)
        with self._lock:
            if self._pool_for(bundle) is None:
                return {"error": f"unknown bundle {bundle}"}
            depth = config.lease_spillback_queue_depth
            if (allow_spillback and not dedicated and bundle is None
                    and depth and self._general_queue_len >= depth):
                # Instant spillback: the caller re-picks with this node
                # excluded rather than queueing behind a deep backlog on
                # the GENERAL pool (bundle waiters don't contend with it)
                # (reference: hybrid policy spillback redirects).
                return {"error": f"spillback: lease queue depth "
                        f"{self._general_queue_len}"}
            self._waiters.append(waiter)
            self._queue_len += 1
            if bundle is None:
                self._general_queue_len += 1
            self._drain_waiters_locked()
        granted = waiter.event.wait(timeout)
        with self._lock:
            self._queue_len -= 1
            if bundle is None:
                self._general_queue_len -= 1
            if not waiter.granted:
                # Timed out (or lost a race): withdraw from the queue. The
                # granted flag is only ever set under this lock, so this
                # check-and-remove cannot miss a concurrent grant.
                if waiter in self._waiters:
                    self._waiters.remove(waiter)
                if not waiter.granted:
                    return {"error": "lease timeout"}
        needs_gpu = resources.get("GPU", 0) > 0
        env_hash = _runtime_env_hash(runtime_env)
        cards = [c for c, _ in waiter.cards]
        try:
            if dedicated:
                # Actors claim a warm pooled worker ONLY when the
                # forkserver can refill that kind in ~10 ms (default-env
                # CPU workers); GPU / custom-env workers cost seconds to
                # respawn, so handing those to an actor for life would
                # starve the task pool — they always fork (reference:
                # leases matched from prestarted workers, worker_pool.h:357).
                handle = None
                if (config.worker_forkserver_enabled and not needs_gpu
                        and not env_hash):
                    handle = self._take_idle_worker(needs_gpu, env_hash,
                                                    claim_dedicated=True)
                if handle is None:
                    handle = self._fork_worker(dedicated=True,
                                               needs_gpu=needs_gpu,
                                               runtime_env=runtime_env,
                                               cards=cards)
            else:
                handle = self._take_or_fork_worker(needs_gpu, runtime_env,
                                                   env_hash, cards)
        except Exception as e:
            self._credit(resources, bundle, waiter.cards)
            from ray_tpu_torch.runtime_env import RuntimeEnvBuildError

            # Permanent = the same spec fails identically on every node
            # (bad pip requirement, missing image root): callers abort
            # instead of retrying until their lease deadline.
            return {"error": f"worker start failed: {e!r}",
                    "permanent": isinstance(e, RuntimeEnvBuildError)}
        with self._lock:
            handle.lease_resources = dict(resources)
            handle.lease_bundle = bundle
            handle.lease_cards = waiter.cards
            handle.task_meta = dict(task_meta) if task_meta else None
            handle.last_used = time.monotonic()
            handle.lease_ts = time.monotonic()
            handle.lease_seq += 1
            lease_seq = handle.lease_seq
        return {"worker_id": handle.worker_id.binary(), "addr": handle.addr,
                "lease_seq": lease_seq, "lease_ts": handle.lease_ts}

    def _credit(self, resources: Dict[str, float], bundle,
                cards: List[Tuple[str, float]] = ()) -> None:
        with self._lock:
            pool = self._pool_for(bundle)
            if pool is not None:
                resmath.credit(pool, resources)
            self._return_cards_locked(cards)
            self._drain_waiters_locked()

    def _credit_lease_locked(self, handle: WorkerHandle) -> None:
        if handle.lease_resources is None:
            return
        pool = self._pool_for(handle.lease_bundle)
        if pool is not None:
            resmath.credit(pool, handle.lease_resources)
        self._return_cards_locked(handle.lease_cards)
        handle.lease_resources = None
        handle.lease_bundle = None
        handle.lease_cards = []

    def _take_cards_locked(self, amount: float
                           ) -> Optional[List[Tuple[str, float]]]:
        """Card shares for a lease of ``amount`` GPU, or None when none
        fit: whole free cards for a whole lease, the fullest card with room
        for a fractional one."""
        eps = 1e-9
        if amount <= 0:
            return []
        if amount < 1:
            fits = [c for c in self._card_ids
                    if self._card_free[c] >= amount - eps]
            if not fits:
                return None
            card = min(fits, key=lambda c: self._card_free[c])
            self._card_free[card] -= amount
            return [(card, amount)]
        free = [c for c in self._card_ids if self._card_free[c] >= 1 - eps]
        need = int(math.ceil(amount - eps))
        if len(free) < need:
            return None
        for c in free[:need]:
            self._card_free[c] = 0.0
        return [(c, 1.0) for c in free[:need]]

    def _return_cards_locked(self, cards) -> None:
        for card, share in cards:
            self._card_free[card] = min(1.0, self._card_free[card] + share)

    def _drain_waiters_locked(self) -> None:
        """Grant queued leases FIFO per resource pool. A blocked head only
        blocks later waiters on the *same* pool (general vs per-bundle), so
        placement-group leases can't wedge the general queue or vice versa."""
        blocked_pools = set()
        still_waiting: List[_LeaseWaiter] = []
        for waiter in self._waiters:
            pool_key = waiter.bundle  # None = general pool
            if pool_key in blocked_pools:
                still_waiting.append(waiter)
                continue
            pool = self._pool_for(waiter.bundle)
            cards = (self._take_cards_locked(waiter.resources.get("GPU", 0))
                     if pool is not None else None)
            if cards is not None and not resmath.take(pool,
                                                      waiter.resources):
                self._return_cards_locked(cards)
                cards = None
            if cards is not None:
                waiter.cards = cards
                waiter.granted = True
                waiter.event.set()
            else:
                blocked_pools.add(pool_key)
                still_waiting.append(waiter)
        self._waiters = still_waiting

    def return_worker(self, worker_id_bytes: bytes,
                      resources: Dict[str, float],
                      bundle: Optional[BundleKey] = None,
                      dead: bool = False,
                      lease_seq: Optional[int] = None) -> None:
        worker_id = WorkerID(worker_id_bytes)
        bundle = tuple(bundle) if bundle is not None else None
        with self._lock:
            handle = self._workers.get(worker_id)
            if handle is not None:
                if lease_seq is not None and lease_seq != handle.lease_seq:
                    # Stale or duplicated return (retried over a lossy
                    # link, or the lease was already reclaimed/re-granted):
                    # acting on it would credit the CURRENT holder's lease
                    # or double-pool the worker.
                    return
                self._credit_lease_locked(handle)
                handle.task_meta = None
                if dead or handle.proc.poll() is not None:
                    self._remove_worker_locked(handle)
                elif not handle.dedicated and not handle.idle:
                    handle.idle = True
                    handle.last_used = time.monotonic()
                    self._idle.append(handle)
            # Unknown handle => kill_worker or the reaper already credited
            # this lease; crediting again here would double-count.
            self._drain_waiters_locked()

    def _take_idle_worker(self, needs_gpu: bool, env_hash: str,
                          claim_dedicated: bool = False,
                          cards: List[str] = ()) -> Optional[WorkerHandle]:
        with self._lock:
            kept: List[WorkerHandle] = []
            found = None
            while self._idle:
                handle = self._idle.pop()
                if handle.proc.poll() is not None:
                    self._remove_worker_locked(handle)
                elif (found is None and handle.gpu == needs_gpu
                        and handle.cards == list(cards)
                        and handle.env_hash == env_hash):
                    handle.idle = False
                    # Claimed-for-actor transition happens UNDER the lock:
                    # the chaos kill hook picks pooled victims by this flag
                    # and must never see a just-claimed actor worker as fair
                    # game.
                    if claim_dedicated:
                        handle.dedicated = True
                    found = handle
                else:
                    kept.append(handle)
            self._idle.extend(kept)
            return found

    def _take_or_fork_worker(self, needs_gpu: bool = False,
                             runtime_env: Optional[Dict[str, Any]] = None,
                             env_hash: str = "",
                             cards: List[str] = ()) -> WorkerHandle:
        found = self._take_idle_worker(needs_gpu, env_hash, cards=cards)
        if found is not None:
            return found
        return self._fork_worker(needs_gpu=needs_gpu,
                                 runtime_env=runtime_env, cards=cards)

    def _fork_worker(self, dedicated: bool = False,
                     needs_gpu: bool = False,
                     runtime_env: Optional[Dict[str, Any]] = None,
                     cards: List[str] = ()) -> WorkerHandle:
        if (config.worker_forkserver_enabled and not needs_gpu
                and not runtime_env):
            try:
                return self._fork_worker_fs(dedicated)
            except _ForkserverError:
                # Template unavailable/crashed: fall back to a fresh spawn.
                # Post-fork failures (registration timeout, child death)
                # propagate — they are worker failures, not template ones,
                # and retrying them would double the caller's wait.
                pass
        worker_id = WorkerID.from_random()
        workdir = None
        python_exe = sys.executable
        env_paths: List[str] = []
        extra_vars: Optional[Dict[str, str]] = None
        env_dirs: List[str] = []
        if runtime_env:
            # Full env build (working_dir + py_modules + pip venv); any
            # failure raises and becomes the lease error (reference: the
            # raylet failing leases on runtime-env agent build errors).
            from ray_tpu_torch.runtime_env import build_env

            built = build_env(runtime_env, self._controller)
            extra_vars = built["env_vars"]
            workdir = built["cwd"]
            env_paths = [p for p in built["pythonpath"] if p != workdir]
            env_dirs = built.get("env_dirs", [])
            if built["python"]:
                python_exe = built["python"]
        env = self._spawn_env(hide_accel=not needs_gpu,
                              extra_vars=extra_vars,
                              cards=cards if needs_gpu else None)
        front = ([workdir] if workdir else []) + env_paths
        if front:
            # working_dir + py_modules go FIRST so they shadow base-env
            # modules of the same name.
            env["PYTHONPATH"] = os.pathsep.join(
                front + [p for p in env.get("PYTHONPATH", "").split(
                    os.pathsep) if p])
        stdout = stderr = None
        try:
            if config.log_to_driver:
                # Unbuffered so task prints reach the log files (and thus
                # the driver) promptly rather than on process exit.
                env["PYTHONUNBUFFERED"] = "1"
                # Redirect worker output to per-worker session log files;
                # the log monitor tails them and streams lines to drivers
                # (reference: default_worker.py stdout/stderr files under
                # session_latest/logs + log_monitor.py).
                from ray_tpu_torch.core.log_monitor import worker_log_paths

                out_path, err_path = worker_log_paths(self.node_id.hex(),
                                                      worker_id.hex())
                stdout = open(out_path, "ab", buffering=0)
                stderr = open(err_path, "ab", buffering=0)
            proc = subprocess.Popen(
                [python_exe, "-m", "ray_tpu_torch.core.worker_main",
                 "--node-host", self.address[0],
                 "--node-port", str(self.address[1]),
                 "--controller-host", self.controller_addr[0],
                 "--controller-port", str(self.controller_addr[1]),
                 "--node-id", self.node_id.hex(),
                 "--worker-id", worker_id.hex()],
                env=env,
                cwd=workdir or None,
                stdout=stdout,
                stderr=stderr,
            )
        finally:
            # The child holds its own copies of the fds.
            for f in (stdout, stderr):
                if f is not None:
                    f.close()
        handle = WorkerHandle(worker_id, proc)
        handle.dedicated = dedicated
        handle.gpu = needs_gpu
        handle.cards = list(cards) if needs_gpu else []
        handle.env_hash = _runtime_env_hash(runtime_env)
        handle.env_dirs = env_dirs
        if env_dirs:
            # HOST-global GC pins (ENV_ROOT is shared across same-host
            # nodes): any node's GC honors this worker's pid.
            from ray_tpu_torch.runtime_env import pin_env_dir

            for d in env_dirs:
                pin_env_dir(d, worker_id.hex(), proc.pid)
        with self._lock:
            self._workers[worker_id] = handle
        self._wait_registered(handle)
        return handle

    def _wait_registered(self, handle: WorkerHandle) -> None:
        """Fail FAST if the process dies before registering (chaos kill, bad
        env): waiting out the full timeout would eat the caller's whole
        lease deadline and turn one crash into a task failure."""
        proc = handle.proc
        worker_id = handle.worker_id
        deadline = time.monotonic() + config.worker_start_timeout_s
        while not handle.registered.wait(0.2):
            if proc.poll() is not None:
                with self._lock:
                    self._workers.pop(worker_id, None)
                raise RuntimeError(
                    f"worker {worker_id.hex()} died before registering "
                    f"(exit {proc.returncode})")
            if time.monotonic() > deadline:
                proc.kill()
                with self._lock:
                    self._workers.pop(worker_id, None)
                raise TimeoutError(
                    f"worker {worker_id.hex()} failed to register")

    def _spawn_env(self, hide_accel: bool,
                   extra_vars: Optional[Dict[str, str]] = None,
                   cards: Optional[List[str]] = None) -> Dict[str, str]:
        """Base environment for worker AND template processes: node extras,
        optionally the card hidden, user runtime-env vars, then repo +
        sys.path merged onto PYTHONPATH.

        ``hide_accel``: CPU-only workers (and the forkserver template
        they fork from) get every ``accel_env_vars`` entry set to the
        empty string, so ``CUDA_VISIBLE_DEVICES=""`` keeps them off the
        card: no CUDA context, no device memory, whatever the task's
        code calls. ``cards``: a GPU lease's worker sees only the cards
        it holds (``CUDA_VISIBLE_DEVICES`` narrowed to them).

        ``extra_vars`` land BEFORE the PYTHONPATH merge, so a
        user-supplied PYTHONPATH joins the inherited tail instead of
        clobbering the pkg-root entry the worker needs to import
        ray_tpu_torch."""
        env = dict(os.environ)
        env.update(self._extra_env)
        if hide_accel:
            for var in config.accel_env_vars.split(","):
                if var.strip():
                    env[var.strip()] = ""
        if cards is not None:
            env[CARD_ENV] = ",".join(cards)
        if extra_vars:
            env.update(extra_vars)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        extra_paths = [pkg_root] + [p for p in sys.path if p]
        inherited = [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                     if p]
        env["PYTHONPATH"] = os.pathsep.join(
            dict.fromkeys(extra_paths + inherited))
        return env

    # ------------------------------------------------------- forkserver

    def _fork_worker_fs(self, dedicated: bool) -> WorkerHandle:
        """Fork a default-env CPU worker from the warm template process."""
        worker_id = WorkerID.from_random()
        req: Dict[str, Any] = {"worker_id": worker_id.hex(), "env": {},
                               "stdout": None, "stderr": None}
        if config.log_to_driver:
            from ray_tpu_torch.core.log_monitor import worker_log_paths

            out_path, err_path = worker_log_paths(self.node_id.hex(),
                                                  worker_id.hex())
            req["stdout"], req["stderr"] = out_path, err_path
            req["env"]["PYTHONUNBUFFERED"] = "1"
        # Reserve the handle BEFORE forking: the warm child can reach
        # register_worker within ms of os.fork() — before the pid reply is
        # read — and an unknown worker_id would be rejected, killing it.
        handle = WorkerHandle(worker_id, _PendingProc())
        handle.dedicated = dedicated
        with self._lock:
            self._workers[worker_id] = handle
        try:
            handle.proc = _ForkedProc(self._forkserver_request(req))
        except Exception:
            with self._lock:
                self._workers.pop(worker_id, None)
            raise
        self._wait_registered(handle)
        return handle

    def _forkserver_request(self, req: Dict[str, Any]) -> int:
        """One fork round-trip on the template's pipe. Serialized — forks
        are ~10 ms, so a single in-flight request is not the bottleneck.
        All failures surface as ``_ForkserverError`` (the caller's signal
        to fall back to a fresh interpreter spawn)."""
        with self._fs_lock:
            try:
                if self._fs_proc is None or self._fs_proc.poll() is not None:
                    # Spawning the forkserver under _fs_lock is the
                    # design: the pipe protocol allows exactly one
                    # in-flight request, and a second starter would
                    # orphan the first template process.
                    # graftlint: disable=lock-held-blocking
                    self._start_forkserver_locked()
                proc = self._fs_proc
                blob = pickle.dumps(req, protocol=5)
                proc.stdin.write(struct.pack("!I", len(blob)) + blob)
                proc.stdin.flush()
                header = self._read_fs(proc, 4)
                (n,) = struct.unpack("!I", header)
                reply = pickle.loads(self._read_fs(proc, n))
            except Exception as e:
                if self._fs_proc is not None:
                    _kill_and_reap(self._fs_proc, force=True)
                    self._fs_proc = None
                raise _ForkserverError(str(e)) from e
            if "error" in reply:
                raise _ForkserverError(reply["error"])
            return reply["pid"]

    @staticmethod
    def _read_fs(proc: subprocess.Popen, n: int) -> bytes:
        """Read exactly n reply bytes with a deadline. An untimed read
        here would wedge _fs_lock forever on a descheduled/SIGSTOPped
        template — blocking every later lease AND Node.stop()."""
        deadline = time.monotonic() + config.worker_start_timeout_s
        fd = proc.stdout.fileno()
        buf = b""
        poller = select.poll()
        poller.register(fd, select.POLLIN)
        while len(buf) < n:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError("forkserver reply timed out")
            if poller.poll(min(remaining, 1.0) * 1000):
                chunk = os.read(fd, n - len(buf))
                if not chunk:
                    raise RuntimeError("forkserver pipe closed")
                buf += chunk
        return buf

    def _start_forkserver_locked(self) -> None:
        if self._stopped.is_set():
            # A lease racing stop() must not respawn the template after
            # stop() killed it — that would leak a process per stopped node.
            raise RuntimeError("node is stopped")
        env = self._spawn_env(hide_accel=True)
        stderr: Any = subprocess.DEVNULL
        if config.log_to_driver:
            d = os.path.join(config.worker_log_dir, self.node_id.hex())
            os.makedirs(d, exist_ok=True)
            stderr = open(os.path.join(d, "forkserver.log"), "ab",
                          buffering=0)
        try:
            self._fs_proc = subprocess.Popen(
                [sys.executable, "-m", "ray_tpu_torch.core.forkserver",
                 "--node-host", self.address[0],
                 "--node-port", str(self.address[1]),
                 "--controller-host", self.controller_addr[0],
                 "--controller-port", str(self.controller_addr[1]),
                 "--node-id", self.node_id.hex()],
                env=env,
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                stderr=stderr,
            )
        finally:
            if stderr is not subprocess.DEVNULL:
                stderr.close()

    def prestart_workers(self, count: int) -> int:
        """Fork ``count`` default-env workers into the idle pool, in the
        background (reference: ``PrestartWorkers``, worker_pool.h:357 —
        fire-and-forget warm-up ahead of a burst of leases/actors)."""

        def _prestart() -> None:
            failures = 0
            for _ in range(count):
                if self._stopped.is_set():
                    return
                try:
                    handle = self._fork_worker()
                except Exception as e:
                    # One bad fork must not abort the whole warm-up, but
                    # persistent failure shouldn't hot-loop either.
                    failures += 1
                    print(f"prestart fork failed ({e}); "
                          f"{failures} consecutive", file=sys.stderr)
                    if failures >= 3:
                        return
                    continue
                failures = 0
                with self._lock:
                    handle.idle = True
                    handle.last_used = time.monotonic()
                    self._idle.append(handle)

        threading.Thread(target=_prestart, name="prestart-workers",
                         daemon=True).start()
        return count

    def worker_ping(self, worker_id_bytes: bytes,
                    tasks_received: int = -1, active_tasks: int = -1,
                    actor_started: bool = False) -> Dict[str, bool]:
        """Liveness ping that also answers "does this node still know me?".
        A worker whose handle is gone from the table (lost forkserver pid
        reply, reaper false positive, any future leak path) self-terminates
        instead of orphaning — the table is the single source of truth.

        The worker self-reports its work state so the reaper can reclaim
        leases orphaned by a LOSSY NETWORK: a lost grant reply (the caller
        never learned its worker id) or a lost lease return (the task
        finished but the credit never landed) both look the same from
        here — a lease held while the worker sits demonstrably idle."""
        with self._lock:
            handle = self._workers.get(WorkerID(worker_id_bytes))
            if handle is not None and tasks_received >= 0:
                if tasks_received != handle.tasks_received:
                    # The worker executed something since the last ping:
                    # a pipelined lease (owner pushes task after task on
                    # one grant) is ALIVE, however old its lease_ts.
                    handle.last_progress_ts = time.monotonic()
                handle.tasks_received = tasks_received
                handle.reported_active = active_tasks
                handle.actor_started = actor_started
                handle.last_ping_ts = time.monotonic()
            # Fleet-size-adaptive cadence: 2,000 workers at the default
            # 2 s interval is 1,000 pings/s on one supervisor — pings
            # starve, workers count misses, and the orphan-suicide guard
            # kills LIVE actors (the envelope-scale cascade). Capping the
            # aggregate rate at ~50/s keeps the control plane flat at any
            # fleet size.
            interval = self._suggested_ping_interval_locked()
        return {"known": handle is not None, "interval": interval}

    def _suggested_ping_interval_locked(self) -> float:
        return max(2.0, 0.02 * len(self._workers))

    def validate_lease(self, worker_id_bytes: bytes, lease_seq: int) -> bool:
        """Is ``lease_seq`` still the worker's CURRENT lease? Late task
        pushes (delayed past the reclamation window on a chaos-slow link)
        call this before executing: a reclaimed-then-re-granted worker must
        not run the stale push concurrently with the new lease's task —
        the seq token protects accounting, this check protects execution."""
        with self._lock:
            handle = self._workers.get(WorkerID(worker_id_bytes))
            return handle is not None and handle.lease_seq == lease_seq

    def register_worker(self, worker_id_bytes: bytes, addr: Addr,
                        pid: Optional[int] = None) -> Dict[str, Any]:
        worker_id = WorkerID(worker_id_bytes)
        with self._lock:
            handle = self._workers.get(worker_id)
            if handle is not None:
                handle.addr = tuple(addr)
                handle.pid = pid
                if pid is not None:
                    self._started_report.append((*handle.addr, pid))
        if handle is None:
            return {"error": "unknown worker"}
        handle.registered.set()
        return {"ok": True}

    def create_actor_worker(self, resources: Dict[str, float],
                            bundle: Optional[BundleKey] = None,
                            timeout: Optional[float] = None,
                            runtime_env: Optional[Dict[str, Any]] = None
                            ) -> Dict[str, Any]:
        """Lease a dedicated worker for an actor — warm pooled worker when
        one matches, else a ~10 ms forkserver fork."""
        return self.lease_worker(resources, bundle=bundle, timeout=timeout,
                                 dedicated=True, runtime_env=runtime_env)

    def kill_worker(self, worker_id_bytes: bytes, force: bool = True,
                    reason: Optional[str] = None) -> None:
        worker_id = WorkerID(worker_id_bytes)
        with self._lock:
            handle = self._workers.get(worker_id)
            if reason is not None:
                self._death_causes[worker_id_bytes] = reason
                while len(self._death_causes) > 256:
                    self._death_causes.pop(next(iter(self._death_causes)))
        if handle is None:
            return
        _kill_and_reap(handle.proc, force)
        with self._lock:
            self._credit_lease_locked(handle)
            self._remove_worker_locked(handle)
            self._drain_waiters_locked()

    def worker_death_cause(self, worker_id_bytes: bytes) -> Optional[str]:
        """Why a worker was killed by the node itself (e.g. the memory
        monitor) — lets a task owner turn a generic worker-crash into
        :class:`OutOfMemoryError` (reference: the raylet attaches a death
        cause to disconnect replies)."""
        with self._lock:
            return self._death_causes.get(worker_id_bytes)

    def _remove_worker_locked(self, handle: WorkerHandle) -> None:
        if (self._workers.pop(handle.worker_id, None) is not None
                and handle.addr is not None and handle.pid is not None):
            self._exit_watch.append(handle)
        if handle in self._idle:
            self._idle.remove(handle)
        if handle.env_dirs:
            from ray_tpu_torch.runtime_env import unpin_env_dir

            for d in handle.env_dirs:
                unpin_env_dir(d, handle.worker_id.hex())
        if handle.proc.poll() is not None:
            try:
                handle.proc.wait(timeout=0)
            except (subprocess.TimeoutExpired, OSError):
                pass

    # ----------------------------------------------------------- bundles

    def reserve_bundle(self, pg_id: bytes, index: int,
                       resources: Dict[str, float]) -> bool:
        with self._lock:
            if (pg_id, index) in self._bundles:
                return True  # idempotent: already reserved here
            if not resmath.take(self._available, resources):
                return False
            self._bundles[(pg_id, index)] = {
                "resources": dict(resources),
                "available": dict(resources),
            }
            return True

    def release_bundle(self, pg_id: bytes, index: int) -> None:
        with self._lock:
            entry = self._bundles.pop((pg_id, index), None)
            if entry is not None:
                resmath.credit(self._available, entry["resources"])
            self._drain_waiters_locked()

    # --------------------------------------------------------- lifecycle

    def _heartbeat_loop(self) -> None:
        """Delta-style resource sync (the reference's RaySyncer streams
        versioned deltas, ray_syncer.h:88 — polling full views doesn't
        scale): the availability payload ships only when it CHANGED since
        the last beat, with a periodic full refresh as the safety net;
        unchanged beats are liveness-only. At thousands of mostly-idle
        nodes this cuts the controller's per-beat work to a timestamp
        touch."""
        last_sent = None
        beats_since_full = 0
        seq = 0
        while not self._stopped.wait(config.heartbeat_period_s):
            try:
                if config.faultinject_path:
                    # Chaos: a delay rule here PAUSES this node's beats
                    # (the controller declares it dead past the health
                    # threshold); an error rule drops individual beats.
                    from ray_tpu_torch.util import faultinject

                    faultinject.check("node.heartbeat")
                with self._lock:
                    available = dict(self._available)
                    queue_len = self._queue_len
                state = (available, queue_len)
                beats_since_full += 1
                if (state == last_sent and beats_since_full
                        < config.heartbeat_full_refresh_beats):
                    payload = None  # liveness-only delta
                else:
                    payload = available
                # Monotonic sync version: each beat snapshots the view at a
                # strictly later point, so the controller can drop reordered
                # (stale) beats (ray_syncer.h:88 versioned NodeState).
                seq += 1
                t_hb = time.perf_counter()
                reply = self._controller.call(
                    "heartbeat", self.node_id.binary(), payload, queue_len,
                    seq, timeout=5.0)
                if config.core_metrics_enabled:
                    from ray_tpu_torch.core import coremetrics as cm

                    # Node-id label: the intended per-node grain — series
                    # are bounded by live membership (the controller drops
                    # a dead node's series with the node), not request
                    # volume.
                    # graftlint: disable=metrics-label-cardinality
                    cm.NODE_HEARTBEAT_RTT.observe(
                        time.perf_counter() - t_hb,
                        {"node": self.node_id.hex()[:8]})
                if payload is not None:
                    # Only a DELIVERED full beat counts as sent: a failed
                    # RPC must retry the payload next beat, or the
                    # controller schedules on stale availability for the
                    # whole refresh window.
                    last_sent = state
                    beats_since_full = 0
                if reply and not reply.get("known", True):
                    # A restarted controller doesn't know us: re-register
                    # (membership is heartbeat-driven, not persisted), and
                    # follow with a full state refresh.
                    self._controller.call(
                        "register_node", self.node_id.binary(), self.address,
                        self.total_resources, self.labels,
                        self.slice_info.to_dict() if self.slice_info
                        else None, timeout=5.0)
                    last_sent = None
            except Exception:
                # Miss enough beats and the head declares this node dead
                # — the operator needs the trail on THIS side too.
                log_every("node.heartbeat", 15.0, logger,
                          "heartbeat to controller failed", exc_info=True)

    def _reaper_loop(self) -> None:
        last_env_gc = time.monotonic()
        while not self._stopped.wait(5.0):
            now = time.monotonic()
            if (config.runtime_env_cache_bytes > 0
                    and now - last_env_gc > 60.0):
                last_env_gc = now
                self._gc_runtime_envs()
            self._reclaim_undelivered_leases(now)
            with self._lock:
                # Dead workers anywhere (incl. dedicated actor workers whose
                # process crashed): credit their lease and forget them.
                for handle in list(self._workers.values()):
                    if handle.proc.poll() is not None:
                        self._credit_lease_locked(handle)
                        self._remove_worker_locked(handle)
                # Idle-too-long pooled workers.
                keep: List[WorkerHandle] = []
                for handle in self._idle:
                    if handle.worker_id not in self._workers:
                        continue
                    if now - handle.last_used > config.idle_worker_keep_s:
                        _kill_and_reap(handle.proc, force=False)
                        self._remove_worker_locked(handle)
                    else:
                        keep.append(handle)
                self._idle = keep
                self._drain_waiters_locked()
                # Only a process that has exited is a dead holder: a live
                # one keeps its handle counts however it left the table.
                running = []
                for handle in self._exit_watch:
                    if handle.proc.poll() is None:
                        running.append(handle)
                    else:
                        self._dead_report.append((*handle.addr, handle.pid))
                self._exit_watch = running
            self._report_workers()

    def _report_workers(self) -> None:
        """Tell the controller which worker processes started and which
        exited since the last report (the reaper's finding, never a
        missed RPC). It publishes the gone ones, and every owner drops the
        handle counts they held; the started ones let it publish a whole
        node's workers when the node dies."""
        with self._lock:
            started, self._started_report = self._started_report, []
            dead, self._dead_report = self._dead_report, []
        if not (started or dead):
            return
        try:
            ControllerStub(self._controller).report_workers(
                self.node_id.binary(), started, dead,
                timeout=config.ctrl_call_timeout_s)
        except Exception:
            with self._lock:  # the next tick retries
                self._started_report[:0] = started
                self._dead_report[:0] = dead
            log_every("node.report_workers", 15.0, logger,
                      "worker report to controller failed", exc_info=True)

    def _reclaim_undelivered_leases(self, now: float) -> None:
        """Reclaim leases orphaned by a lossy network. Two shapes, both
        detected through the worker's own reports (worker_ping):

        * POOLED worker leased but demonstrably IDLE (active==0 reported
          well after the grant, lease old): either the grant reply never
          reached the caller (no push will ever come — deps resolve
          before leasing, so a heard grant is pushed within an RPC) or
          the task finished and the lease RETURN was lost. Credit the
          lease and re-pool. A pathologically late push still executes
          fine (the worker accepts it; the lease GENERATION token keeps
          its eventual return from corrupting accounting).
        * DEDICATED fork whose actor runtime NEVER started (the
          create_actor_worker reply was lost; the controller retried
          elsewhere): credit and kill. Uses 3x the window — a live
          actor's start_actor is pushed right after the lease, but
          controller storms deserve slack. Actors that DID start are
          never touched (they hold their lease for life, however idle).

        Reclamation requires the idle report to POSTDATE the grant: when
        pings themselves starve (overloaded node) we cannot distinguish
        lost-grant from busy-with-stale-report — do nothing."""
        timeout_s = config.lease_undelivered_timeout_s
        if timeout_s <= 0:
            return
        victims: List[WorkerHandle] = []
        with self._lock:
            ping_fresh = max(6.0, 3 * self._suggested_ping_interval_locked())
            for handle in list(self._workers.values()):
                if (handle.lease_resources is None or not handle.lease_ts
                        or handle.reported_active != 0
                        or handle.last_ping_ts < handle.lease_ts + 2.0
                        or now - handle.last_ping_ts > ping_fresh
                        or handle.proc.poll() is not None):
                    continue
                if (not handle.dedicated
                        and now - handle.lease_ts > timeout_s
                        # A pipelined lease (owner pushes task after task
                        # on one grant) shows recent execution progress —
                        # it is alive however old the grant is.
                        and now - handle.last_progress_ts > timeout_s):
                    self._credit_lease_locked(handle)
                    handle.lease_ts = 0.0
                    handle.lease_seq += 1  # invalidate straggler returns
                    if not handle.idle:
                        handle.idle = True
                        handle.last_used = now
                        self._idle.append(handle)
                elif (handle.dedicated and not handle.actor_started
                        and now - handle.lease_ts > 3 * timeout_s):
                    self._credit_lease_locked(handle)
                    handle.lease_ts = 0.0
                    handle.lease_seq += 1
                    self._remove_worker_locked(handle)
                    victims.append(handle)
            if victims or self._waiters:
                self._drain_waiters_locked()
        for handle in victims:
            _kill_and_reap(handle.proc, force=True)

    def _gc_runtime_envs(self) -> None:
        """Evict LRU runtime-env cache dirs past the budget, pinning every
        dir a live worker was built from (reference: the runtime-env
        agent's URI refcounting + cache eviction, runtime_env/plugin.py)."""
        from ray_tpu_torch.runtime_env import gc_envs

        with self._lock:
            in_use = {d for h in self._workers.values()
                      for d in h.env_dirs if h.proc.poll() is None}
        try:
            gc_envs(config.runtime_env_cache_bytes, in_use)
        except Exception:
            # A gc pass that always fails fills the disk with dead venvs.
            log_every("node.env_gc", 60.0, logger,
                      "runtime-env cache gc failed", exc_info=True)

    def read_shm_object(self, oid_bytes: bytes) -> Optional[bytes]:
        """Serve a whole object from this node's store (or its spill dir) to
        a remote reader — the small-object node-to-node path (reference:
        ObjectManager Push/Pull, object_manager.h:117). Large objects go
        through read_shm_chunk."""
        with self._store_users:
            view = self._shm.get_view(oid_bytes)
            if view is not None:
                try:
                    return bytes(view.data)
                finally:
                    view.release()
        return self._read_spill(oid_bytes)

    def read_shm_chunk(self, oid_bytes: bytes, offset: int,
                       length: int) -> Optional[Tuple[int, bytes]]:
        """Chunked node-to-node transfer: returns (total_size, chunk bytes)
        for the requested range, or None when the object is gone (evicted and
        not spilled). The object is pinned only for the duration of the copy,
        so a many-chunk pull never wedges eviction (reference: 64 MiB chunked
        pulls, object_manager.h:117 / pull_manager.h:52)."""
        with self._store_users:
            view = self._shm.get_view(oid_bytes)
            if view is not None:
                try:
                    total = len(view.data)
                    # One defensive copy (the view is released before the
                    # RPC reply ships), wrapped as a PickleBuffer so the
                    # transport sends it out-of-band — no further pickle
                    # copy on either end (PEP 574 framing in rpc.py).
                    chunk = bytes(view.data[offset:offset + length])
                finally:
                    view.release()
                return total, pickle.PickleBuffer(chunk)
        path = spill_file(self.node_id, oid_bytes)
        try:
            total = os.path.getsize(path)
            with open(path, "rb") as f:
                f.seek(offset)
                return total, pickle.PickleBuffer(f.read(length))
        except OSError:
            return None

    def _read_spill(self, oid_bytes: bytes) -> Optional[bytes]:
        try:
            with open(spill_file(self.node_id, oid_bytes), "rb") as f:
                return f.read()
        except OSError:
            return None

    def free_shm_object(self, oid_bytes: bytes) -> None:
        """Owner-driven free: reclaim the object's store slot and any spill
        file (reference: FreeObjects in node_manager.proto; with automatic
        ref counting the owner calls this when the cluster-wide handle count
        hits zero)."""
        with self._store_users:
            self._shm.delete(oid_bytes)
        try:
            os.unlink(spill_file(self.node_id, oid_bytes))
        except OSError:
            pass

    def kill_random_pooled_worker(self, rng) -> bool:
        """Chaos/testing hook: SIGKILL one random pooled (non-actor) worker
        process. Keeps worker-table invariants inside Node (the reaper
        credits the lease and forgets the corpse)."""
        import signal

        with self._lock:
            # pid > 0 excludes _PendingProc placeholders (pid -1):
            # os.kill(-1, SIGKILL) would massacre every signallable process.
            victims = [h for h in self._workers.values()
                       if not h.dedicated and h.proc.pid > 0
                       and h.proc.poll() is None]
        if not victims:
            return False
        victim = rng.choice(victims)
        try:
            os.kill(victim.proc.pid, signal.SIGKILL)
            return True
        except OSError:
            return False

    def list_workers(self) -> List[Dict[str, Any]]:
        """Registered worker processes (for the state CLI's stack dumps —
        the py-spy-equivalent introspection path)."""
        with self._lock:
            return [{
                "worker_id": h.worker_id.hex(),
                "addr": h.addr,
                "pid": h.proc.pid,
                "idle": h.idle,
                "dedicated": h.dedicated,
            } for h in self._workers.values() if h.addr is not None]

    def get_info(self) -> Dict[str, Any]:
        # Disk scan outside the scheduling lock: an observability RPC must
        # never stall lease/return paths behind slow IO.
        spilled = self._spilled_bytes()
        with self._lock:
            return {
                "node_id": self.node_id.hex(),
                "addr": self.address,
                "resources": dict(self.total_resources),
                "available": dict(self._available),
                "labels": dict(self.labels),
                "num_workers": len(self._workers),
                "num_idle": len(self._idle),
                "num_oom_kills": (self.memory_monitor.total_kills
                                  if self.memory_monitor else 0),
                "store_used_bytes": self._shm.used_bytes(),
                "store_capacity_bytes": self._shm.capacity(),
                "spilled_bytes": spilled,
            }

    def _spilled_bytes(self) -> int:
        total = 0
        try:
            with os.scandir(spill_dir(self.node_id)) as it:
                for entry in it:
                    try:
                        total += entry.stat().st_size
                    except OSError:
                        pass
        except OSError:
            pass
        return total

    def stop(self) -> None:
        self._stopped.set()
        self.metrics_agent.stop()
        if self.memory_monitor is not None:
            self.memory_monitor.stop()
        if self.log_monitor is not None:
            self.log_monitor.stop()
        with self._lock:
            workers = list(self._workers.values())
        for handle in workers:
            _kill_and_reap(handle.proc, force=True)
        with self._fs_lock:
            if self._fs_proc is not None:
                _kill_and_reap(self._fs_proc, force=True)
                self._fs_proc = None
        try:
            self._controller.call("unregister_node", self.node_id.binary(),
                                  timeout=2.0)
        except Exception:  # graftlint: disable=swallowed-exception
            # Best-effort goodbye at shutdown: the head reaps us by
            # heartbeat timeout regardless.
            pass
        self._controller.close()
        self._server.stop()
        # The server shuts its handler pool without waiting: let handlers
        # that are reading or freeing objects finish before the store
        # closes (a later one finds it closed and returns empty).
        self._store_users.wait_idle(timeout=10.0)
        try:
            self._shm.close()
            os.unlink(self.store_path)
        except OSError:
            pass
        import shutil

        shutil.rmtree(spill_dir(self.node_id), ignore_errors=True)
        shutil.rmtree(os.path.join(config.worker_log_dir,
                                   self.node_id.hex()), ignore_errors=True)
