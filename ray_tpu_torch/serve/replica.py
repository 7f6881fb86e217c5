"""ReplicaActor: hosts the user callable + multiplexed model cache.

Analogue of the reference's ``ReplicaActor`` + ``UserCallableWrapper``
(``serve/_private/replica.py:231,750``) and the replica half of model
multiplexing (``serve/multiplex.py`` — per-replica LRU of loaded models,
residency reported to the controller for model-aware routing).
"""

from __future__ import annotations

import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

_current_model_id = threading.local()
_current_deadline = threading.local()

# Which deployment/replica THIS worker process hosts — set by
# ReplicaActor.__init__ before the user class is constructed, so a
# DecodeEngine built inside it labels its SLO metrics by deployment
# without the engine ever knowing the serve plane exists. A process
# hosts at most one replica (replicas are dedicated actors).
_replica_ident: Dict[str, str] = {"deployment": "", "replica_id": ""}


def replica_ident() -> Dict[str, str]:
    """{'deployment', 'replica_id'} of the replica hosted by this
    process (empty strings outside a replica worker)."""
    return dict(_replica_ident)


def get_multiplexed_model_id() -> str:
    """Inside a replica: the model id of the in-flight request (reference:
    ``serve.get_multiplexed_model_id``)."""
    return getattr(_current_model_id, "value", "")


def request_deadline_s() -> Optional[float]:
    """Inside a replica: seconds remaining on the in-flight request's
    deadline, or None when the caller set none. The deadline is
    propagated as a RELATIVE duration at every hop (proxy -> handle ->
    replica) so it never depends on cross-process clock agreement; here
    it is re-anchored to this process's monotonic clock on arrival."""
    deadline = getattr(_current_deadline, "value", None)
    if deadline is None:
        return None
    return deadline - time.monotonic()


class _MultiplexCache:
    """Per-replica LRU of loaded models (multiplex.py's model cache)."""

    def __init__(self, loader, capacity: int):
        self._loader = loader
        self._capacity = max(1, capacity)
        self._models: "OrderedDict[str, Any]" = OrderedDict()
        self._lock = threading.Lock()

    def get(self, instance, model_id: str):
        with self._lock:
            if model_id in self._models:
                self._models.move_to_end(model_id)
                return self._models[model_id]
        model = self._loader(instance, model_id)
        with self._lock:
            self._models[model_id] = model
            self._models.move_to_end(model_id)
            while len(self._models) > self._capacity:
                old_id, old = self._models.popitem(last=False)
                del old
        return model

    def loaded(self) -> List[str]:
        with self._lock:
            return list(self._models)


def multiplexed(max_num_models_per_replica: int = 3):
    """``@serve.multiplexed`` — wraps a ``get_model(self, model_id)`` loader
    with a per-replica LRU cache (reference: ``serve/multiplex.py``). The
    cache is created lazily on the instance (decoration-time state would
    make the user class unpicklable — it ships to replicas by value)."""

    def wrap(loader):
        attr = f"__mux_cache_{loader.__name__}"

        def cached(self, model_id: Optional[str] = None):
            cache = getattr(self, attr, None)
            if cache is None:
                cache = _MultiplexCache(loader, max_num_models_per_replica)
                setattr(self, attr, cache)
            if model_id is None:
                model_id = get_multiplexed_model_id()
            return cache.get(self, model_id)

        cached._is_multiplexed = True
        return cached

    return wrap


def loaded_model_ids(instance) -> List[str]:
    """All model ids resident in ``instance``'s multiplex caches."""
    out: List[str] = []
    for name, value in vars(instance).items():
        if name.startswith("__mux_cache_") and isinstance(
                value, _MultiplexCache):
            out.extend(value.loaded())
    return out


def join_mesh(mesh_rank: Dict[str, Any]) -> None:
    """Make this process rank ``mesh_rank["rank"]`` of a mesh replica's
    ``mesh_rank["world"]`` ranks: the default process group, before the
    deployment builds its engine. Rank 0 reserves the rendezvous address
    (a free port on its host) and publishes it under ``mesh_rank["key"]``
    in the cluster KV; the other ranks wait for it. NCCL on cards, gloo on
    the CPU (``parallel/mesh.py::backend_for``); a rank on a card drives
    its first leased card."""
    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.core.rpc_stubs import ControllerStub
    from ray_tpu_torch.core.runtime import get_core_worker
    from ray_tpu_torch.parallel.mesh import init_distributed

    rank, world = int(mesh_rank["rank"]), int(mesh_rank["world"])
    device_type = mesh_rank["device_type"]
    local_rank = 0 if device_type == "cuda" else None
    if world == 1:
        init_distributed(0, 1, None, device_type, local_rank=local_rank)
        return
    core = get_core_worker()
    kv = ControllerStub(core.controller)
    key = mesh_rank["key"]
    if rank == 0:
        import socket

        host = core.addr[0]
        with socket.socket() as sock:
            sock.bind((host, 0))
            port = sock.getsockname()[1]
        url = f"tcp://{host}:{port}"
        kv.kv_put(key, url.encode(), timeout=config.ctrl_call_timeout_s)
    else:
        deadline = time.monotonic() + mesh_rank.get("timeout_s", 120.0)
        while True:
            got = kv.kv_get(key, timeout=config.ctrl_call_timeout_s)
            if got:
                url = bytes(got).decode()
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"rank {rank} of mesh replica found no rendezvous "
                    f"address under {key!r}")
            time.sleep(0.05)
    init_distributed(rank, world, url, device_type,
                     timeout_s=mesh_rank.get("timeout_s", 120.0),
                     local_rank=local_rank)
    if rank == 0:
        # Every rank has joined the group, so none reads the key again.
        kv.kv_del(key, timeout=config.ctrl_call_timeout_s)


def _host_identity(replica_id: str) -> None:
    # Before the user class runs: its __init__ may build the engine that
    # reads this identity for metric labels.
    _replica_ident["replica_id"] = replica_id
    _replica_ident["deployment"] = replica_id.rsplit("#", 1)[0]


class MeshRankActor:
    """Rank 1.. of a mesh replica: hosts the same deployment as rank 0's
    :class:`ReplicaActor` and follows its control messages
    (``serve/spmd.py::Lockstep``). The router never sees it and it answers
    no request; rank 0's ``shutdown`` stops it, and the serve controller
    stops every rank of a replica together."""

    def __init__(self, cls_blob: bytes, args: tuple, kwargs: dict,
                 replica_id: str, mesh_rank: Dict[str, Any]):
        from ray_tpu_torch.core import serialization

        _host_identity(replica_id)
        join_mesh(mesh_rank)
        cls = serialization.loads_function(cls_blob)
        self._instance = cls(*args, **kwargs)


class ReplicaActor:
    def __init__(self, cls_blob: bytes, args: tuple, kwargs: dict,
                 replica_id: str = "", owner_epoch: int = 0,
                 role: str = "",
                 mesh_rank: Optional[Dict[str, Any]] = None):
        """``mesh_rank`` makes this actor rank 0 of a mesh replica that
        spans one process a rank (``join_mesh``); the other ranks are
        ``MeshRankActor`` actors."""
        from ray_tpu_torch.core import serialization

        # Disaggregated posture ("prefill" / "decode" / "" = colocated):
        # routing-plane metadata, reported back through stats() so
        # serve.status() shows each replica's role. The hosted class is
        # identical either way — role never changes engine behavior.
        self._role = role
        if replica_id:
            _host_identity(replica_id)
        if mesh_rank is not None:
            join_mesh(mesh_rank)
        cls = serialization.loads_function(cls_blob)
        self._instance = cls(*args, **kwargs)
        self._sub_slice: Optional[Dict[str, Any]] = None
        self._ongoing = 0
        self._total = 0
        self._lock = threading.Lock()
        self._started = time.monotonic()
        # The controller epoch that owns this replica: assigned at
        # spawn, re-pushed by a restarted controller when it ADOPTS the
        # replica (set_owner_epoch). Exported as the serve_replica_epoch
        # gauge so `ray_tpu doctor` can flag replicas no live controller
        # epoch owns (orphan-replica).
        self._owner_epoch = int(owner_epoch)
        if replica_id:
            from ray_tpu_torch.util import metrics as um

            um.add_collector(self._collect_epoch)

    def _collect_epoch(self) -> None:
        from ray_tpu_torch.serve import metrics as smetrics

        smetrics.REPLICA_EPOCH.set(
            float(self._owner_epoch),
            {"deployment": _replica_ident["deployment"]})

    def set_owner_epoch(self, epoch: int) -> None:
        """Adoption handshake from a restarted controller: monotonic —
        a zombie's stale push can't regress the owning epoch."""
        self._owner_epoch = max(self._owner_epoch, int(epoch))

    def handle_request(self, method: str, args: tuple, kwargs: dict,
                       multiplexed_model_id: str = "",
                       deadline_s: Optional[float] = None):
        with self._lock:
            self._ongoing += 1
            self._total += 1
        _current_model_id.value = multiplexed_model_id
        _current_deadline.value = (time.monotonic() + deadline_s
                                   if deadline_s is not None else None)
        try:
            target = (self._instance if method == "__call__"
                      else getattr(self._instance, method))
            return target(*args, **kwargs)
        finally:
            _current_model_id.value = ""
            _current_deadline.value = None
            with self._lock:
                self._ongoing -= 1

    # ------------------------------------------------- streaming sessions
    #
    # A generator-returning callable streams INCREMENTALLY: the consumer
    # pulls batches with next_chunks (actor calls), so the generator is
    # suspended between pulls and production is backpressured by the
    # consumer (reference: proxy.py's streaming responses over
    # ASGI receive/send; here the handle is the transport).

    def start_stream(self, method: str, args: tuple, kwargs: dict,
                     multiplexed_model_id: str = "",
                     deadline_s: Optional[float] = None) -> str:
        import uuid

        with self._lock:
            self._ongoing += 1
            self._total += 1
        _current_model_id.value = multiplexed_model_id
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        _current_deadline.value = deadline
        try:
            target = (self._instance if method == "__call__"
                      else getattr(self._instance, method))
            result = target(*args, **kwargs)
            iterator = iter(result)
        except BaseException:
            with self._lock:
                self._ongoing -= 1
            raise
        finally:
            _current_model_id.value = ""
            _current_deadline.value = None
        sid = uuid.uuid4().hex[:16]
        self._streams = getattr(self, "_streams", {})
        self._streams[sid] = (iterator, multiplexed_model_id, deadline)
        return sid

    def next_chunks(self, stream_id: str, max_items: int = 16,
                    deadline_s: float = 2.0):
        """Pull up to ``max_items``, returning EARLY with whatever arrived
        once ``deadline_s`` elapses — a slow-but-healthy producer must
        stream partial batches, not stall the consumer's RPC timeout until
        the full batch exists. Returns (items, done); the stream's ongoing
        slot frees when the iterator is exhausted."""
        entry = getattr(self, "_streams", {}).get(stream_id)
        if entry is None:
            raise KeyError(f"unknown stream {stream_id}")
        iterator, model_id, req_deadline = entry
        items = []
        done = False
        deadline = time.monotonic() + deadline_s
        _current_model_id.value = model_id  # generator body resumes here
        _current_deadline.value = req_deadline
        try:
            for _ in range(max_items):
                items.append(next(iterator))
                if time.monotonic() > deadline:
                    break
        except StopIteration:
            done = True
        except BaseException:
            self.cancel_stream(stream_id)
            raise
        finally:
            _current_model_id.value = ""
            _current_deadline.value = None
        if done:
            self.cancel_stream(stream_id)
        return items, done

    def cancel_stream(self, stream_id: str) -> None:
        entry = getattr(self, "_streams", {}).pop(stream_id, None)
        if entry is not None:
            try:
                entry[0].close()
            except Exception:
                from ray_tpu_torch.util.ratelimit import log_every

                # close() runs the generator's cleanup (engine cancel,
                # slot free) — a failure here can strand engine state.
                log_every("replica.stream_close", 10.0, logger,
                          "closing stream generator failed",
                          exc_info=True)
            with self._lock:
                self._ongoing -= 1

    def set_topology(self, assignment: Dict[str, Any]) -> None:
        """Sub-slice assignment from the serve controller (which chips
        of which slice this replica spans). Stored here and forwarded to
        the user instance when it cares (e.g. LlamaDecodeDeployment
        reports it through replica_metrics; a multi-card replica would
        select its devices by the assignment's chip coords)."""
        self._sub_slice = dict(assignment)
        fwd = getattr(self._instance, "set_topology", None)
        if callable(fwd):
            fwd(assignment)

    def set_admission(self, queue_max: int) -> bool:
        """Admission-cap override from the serve controller (the
        autopilot shed-tenant action): forwarded to the user instance's
        ``set_admission`` when it implements one, else applied to a
        hosted ``engine``'s ``queue_max`` directly. Returns whether
        anything applied (a deployment with no bounded queue has
        nothing to shed)."""
        fwd = getattr(self._instance, "set_admission", None)
        if callable(fwd):
            fwd(int(queue_max))
            return True
        eng = getattr(self._instance, "engine", None)
        if eng is not None and hasattr(eng, "queue_max"):
            eng.queue_max = max(1, int(queue_max))
            return True
        return False

    def engine_timeline(self) -> Dict[str, Any]:
        """The hosted instance's step-timeline dump (empty for non-engine
        deployments): phase rows + page/compile events, merged by
        ``ray_tpu timeline --serve`` into the cross-process trace."""
        fn = getattr(self._instance, "timeline", None)
        if callable(fn):
            try:
                return dict(fn())
            except Exception:
                from ray_tpu_torch.util.ratelimit import log_every

                log_every("replica.timeline", 30.0, logger,
                          "instance timeline dump failed", exc_info=True)
        return {"rows": []}

    def stats(self) -> Dict[str, Any]:
        models = loaded_model_ids(self._instance)
        # Instance-reported metrics (e.g. a DecodeEngine's backlog as
        # "load" and its prefix-cache residency as "prefixes"): merged in
        # so the controller autoscales on decode backlog — a full decode
        # queue behind idle HTTP concurrency is NOT zero load — and the
        # router can steer shared prefixes to the replica holding them.
        out: Dict[str, Any] = {}
        metrics = getattr(self._instance, "replica_metrics", None)
        if callable(metrics):
            try:
                out = dict(metrics())
            except Exception:
                out = {}
        with self._lock:
            out.update({"ongoing": self._ongoing, "total": self._total,
                        "models": models,
                        "uptime_s": time.monotonic() - self._started})
        if self._role:
            out["role"] = self._role
        return out

    def ping(self) -> str:
        return "pong"
