"""Thin-client protocol: drive a cluster from outside it (copy of
``ray_tpu/client.py``).

Analogue of the reference's Ray Client (``python/ray/util/client/`` +
``ray_client.proto``; design doc ``util/client/ARCHITECTURE.md``):
``ray_tpu_torch.init(address="ray-tpu://host:port")`` connects a *thin*
client —
the local process never joins the cluster, owns no objects, and needs only
one outbound TCP connection (NAT/laptop friendly). A :class:`ClientServer`
running inside the cluster hosts the real driver state: it owns every
object/actor the client creates and proxies get/put/task/actor calls.

Where the reference runs one proxied driver *process* per client, sessions
here share the hosting process's core worker (a design choice the
serverless runtime allows); per-session bookkeeping still scopes cleanup —
disconnecting releases the session's object refs and kills its unnamed
actors, exactly like a departing driver.

Client-side refs/handles pickle into resolver calls
(``__reduce__`` -> :func:`_resolve_ref`), so arbitrarily nested refs in
task args rebuild into real refs server-side during deserialization — no
argument-tree walking.

A thin client imports torch (the package does) but creates no CUDA context:
it runs no task, and values it puts or gets are serialized on the host (a
tensor put through it reads back as the store's CPU view, as any put does).
"""

from __future__ import annotations

import logging
import threading
import uuid
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.errors import RayTpuError
from ray_tpu_torch.core.rpc import RpcClient, RpcServer
from ray_tpu_torch.util.ratelimit import log_every

logger = logging.getLogger(__name__)

Addr = Tuple[str, int]

# ------------------------------------------------------------------ server

_resolving = threading.local()  # .session set while deserializing a request


def _resolve_ref(ref_id: bytes):
    session = getattr(_resolving, "session", None)
    if session is None:
        raise RayTpuError("client ref deserialized outside a client session")
    ref = session.refs.get(ref_id)
    if ref is None:
        raise RayTpuError(f"client ref {ref_id.hex()} unknown "
                          f"(released or from another session)")
    return ref


def _resolve_actor(actor_key: str):
    session = getattr(_resolving, "session", None)
    if session is None:
        raise RayTpuError("client actor handle deserialized outside a session")
    handle = session.actors.get(actor_key)
    if handle is None:
        raise RayTpuError(f"client actor {actor_key} unknown")
    return handle


class _Session:
    def __init__(self):
        self.refs: Dict[bytes, Any] = {}      # ref id -> real ObjectRef
        self.actors: Dict[str, Any] = {}      # actor key -> real handle
        self.named_actors: set = set()        # keys NOT killed on disconnect
        self.lock = threading.Lock()
        import time

        self.last_seen = time.monotonic()


class ClientServer:
    """Hosts thin-client sessions inside the cluster.

    Runs wherever a driver can run (the head process, a process of its
    own, or a test). Uses the hosting process's core worker, which must be
    initialized first.
    """

    def __init__(self, host: str = "0.0.0.0"):
        from ray_tpu_torch.core.runtime import get_core_worker

        self._core = get_core_worker()
        if self._core is None:
            raise RayTpuError("ClientServer requires ray_tpu_torch.init() "
                              "first")
        self._sessions: Dict[str, _Session] = {}
        self._lock = threading.Lock()
        self._stopped = threading.Event()
        self._server = RpcServer(
            handlers={
                "client_connect": self._connect,
                "client_disconnect": self._disconnect,
                "client_put": self._put,
                "client_get": self._get,
                "client_wait": self._wait,
                "client_task": self._task,
                "client_actor_create": self._actor_create,
                "client_actor_call": self._actor_call,
                "client_get_actor": self._get_named_actor,
                "client_kill": self._kill,
                "client_release": self._release,
                "client_cluster_resources": self._cluster_resources,
                "client_ping": self._ping,
                "ping": lambda: "pong",
            },
            host=host,
            name="client-server",
            max_workers=64,
        )
        self.address: Addr = self._server.addr
        # Crashed clients never call disconnect: reap sessions whose
        # keepalive went quiet (the reference's proxied driver dies when the
        # client's data channel drops).
        self._reaper = threading.Thread(
            target=self._reap_loop, name="client-session-reaper", daemon=True)
        self._reaper.start()

    # -- session plumbing

    def _session(self, sid: str) -> _Session:
        import time

        with self._lock:
            session = self._sessions.get(sid)
            if session is None:
                raise RayTpuError(f"unknown client session {sid}")
            session.last_seen = time.monotonic()
            return session

    def _ping(self, sid: str) -> bool:
        self._session(sid)
        return True

    def _reap_loop(self) -> None:
        import time

        from ray_tpu_torch.core.config import config

        while not self._stopped.wait(5.0):
            cutoff = time.monotonic() - config.client_session_timeout_s
            with self._lock:
                stale = [sid for sid, s in self._sessions.items()
                         if s.last_seen < cutoff]
            for sid in stale:
                self._disconnect(sid)

    def _connect(self) -> str:
        sid = uuid.uuid4().hex
        with self._lock:
            self._sessions[sid] = _Session()
        return sid

    def _disconnect(self, sid: str) -> None:
        with self._lock:
            session = self._sessions.pop(sid, None)
        if session is None:
            return
        # A departing driver's unnamed actors die with it; named actors are
        # the reference's detached-ish survivors.
        for key, handle in session.actors.items():
            if key not in session.named_actors:
                try:
                    handle.kill(no_restart=True)
                except Exception:
                    log_every("client.session_actor_kill", 10.0, logger,
                              "killing session actor failed",
                              exc_info=True)
        session.refs.clear()
        session.actors.clear()

    def _deserialize(self, session: _Session, frame: bytes):
        _resolving.session = session
        try:
            return serialization.deserialize(frame)
        finally:
            _resolving.session = None

    def _track(self, session: _Session, ref) -> bytes:
        rid = ref.id.binary()
        with session.lock:
            session.refs[rid] = ref
        return rid

    # -- data plane

    # NOTE: handlers go straight to the core worker, NEVER through
    # ray_tpu_torch.core.api — the api layer routes to the active thin
    # client, so a ClientServer co-hosted with a connected client (tests,
    # notebooks) would recurse over its own RPC.

    def _put(self, sid: str, frame: bytes) -> bytes:
        session = self._session(sid)
        value = self._deserialize(session, frame)
        return self._track(session, self._core.put(value))

    def _get(self, sid: str, ref_ids: List[bytes],
             timeout: Optional[float]) -> Dict[str, Any]:
        session = self._session(sid)
        try:
            refs = [_resolve_with(session, rid) for rid in ref_ids]
            values = self._core.get(refs, timeout)
        except BaseException as e:  # noqa: BLE001 — shipped to the client
            return {"error": serialization.serialize(e)}
        return {"values": serialization.serialize(values)}

    def _wait(self, sid: str, ref_ids: List[bytes], num_returns: int,
              timeout: Optional[float]) -> Tuple[List[bytes], List[bytes]]:
        session = self._session(sid)
        refs = [_resolve_with(session, rid) for rid in ref_ids]
        ready, pending = self._core.wait(refs, num_returns, timeout)
        return ([r.id.binary() for r in ready],
                [r.id.binary() for r in pending])

    def _release(self, sid: str, ref_ids: List[bytes]) -> None:
        try:
            session = self._session(sid)
        except RayTpuError:
            return
        with session.lock:
            for rid in ref_ids:
                session.refs.pop(rid, None)

    # -- tasks / actors

    def _task(self, sid: str, fn_blob: bytes, args_frame: bytes,
              options: Dict[str, Any]) -> List[bytes]:
        from ray_tpu_torch.core.remote_function import RemoteFunction

        session = self._session(sid)
        fn = serialization.loads_function(fn_blob)
        args, kwargs = self._deserialize(session, args_frame)
        refs = RemoteFunction(fn, options).remote(*args, **kwargs)
        refs = refs if isinstance(refs, list) else [refs]
        return [self._track(session, r) for r in refs]

    def _actor_create(self, sid: str, cls_blob: bytes, args_frame: bytes,
                      options: Dict[str, Any]) -> str:
        from ray_tpu_torch.core.actor import ActorClass

        session = self._session(sid)
        cls = serialization.loads_function(cls_blob)
        args, kwargs = self._deserialize(session, args_frame)
        handle = ActorClass(cls, options).remote(*args, **kwargs)
        key = handle._actor_id.hex()
        with session.lock:
            session.actors[key] = handle
            if options.get("name"):
                session.named_actors.add(key)
        return key

    def _actor_call(self, sid: str, actor_key: str, method: str,
                    args_frame: bytes, num_returns: int) -> List[bytes]:
        session = self._session(sid)
        handle = session.actors.get(actor_key)
        if handle is None:
            raise RayTpuError(f"unknown actor {actor_key}")
        args, kwargs = self._deserialize(session, args_frame)
        bound = getattr(handle, method)
        if num_returns != 1:
            bound = bound.options(num_returns=num_returns)
        refs = bound.remote(*args, **kwargs)
        refs = refs if isinstance(refs, list) else [refs]
        return [self._track(session, r) for r in refs]

    def _get_named_actor(self, sid: str, name: str) -> str:
        from ray_tpu_torch.core.actor import get_actor  # core-level, not api

        session = self._session(sid)
        handle = get_actor(name)
        key = handle._actor_id.hex()
        with session.lock:
            session.actors[key] = handle
            session.named_actors.add(key)  # looked up, not owned: never kill
        return key

    def _kill(self, sid: str, actor_key: str, no_restart: bool) -> None:
        session = self._session(sid)
        handle = session.actors.get(actor_key)
        if handle is not None:
            handle.kill(no_restart=no_restart)

    def _cluster_resources(self) -> Dict[str, float]:
        return self._core.controller.call("cluster_resources")

    def stop(self) -> None:
        self._stopped.set()
        with self._lock:
            sids = list(self._sessions)
        for sid in sids:
            self._disconnect(sid)
        self._server.stop()


def _resolve_with(session: _Session, rid: bytes):
    _resolving.session = session
    try:
        return _resolve_ref(rid)
    finally:
        _resolving.session = None


# ------------------------------------------------------------------ client

_current_client: Optional["ClientCore"] = None


def current_client() -> Optional["ClientCore"]:
    return _current_client


class ClientObjectRef:
    """Client-side surrogate for a server-owned ObjectRef."""

    __slots__ = ("id", "_client", "__weakref__")

    def __init__(self, rid: bytes, client: "ClientCore"):
        self.id = rid
        self._client = client

    def hex(self) -> str:
        return self.id.hex()

    def __reduce__(self):
        # Inside task args shipped to the server, rebuild the REAL ref.
        return (_resolve_ref, (self.id,))

    def __repr__(self) -> str:
        return f"ClientObjectRef({self.id.hex()[:16]})"

    def __hash__(self) -> int:
        return hash(self.id)

    def __eq__(self, other) -> bool:
        return isinstance(other, ClientObjectRef) and other.id == self.id

    def __del__(self):
        client = self._client
        if client is not None:
            client._queue_release(self.id)


class ClientRemoteFunction:
    def __init__(self, fn, options: Dict[str, Any]):
        self._fn = fn
        self._options = dict(options)
        self._blob = serialization.dumps_function(fn)

    def options(self, **overrides) -> "ClientRemoteFunction":
        merged = dict(self._options)
        merged.update(overrides)
        return ClientRemoteFunction(self._fn, merged)

    def remote(self, *args, **kwargs):
        client = current_client()
        if client is None:
            raise RayTpuError("client not connected")
        rids = client._call("client_task", self._blob,
                            client._pack_args(args, kwargs), self._options)
        refs = [ClientObjectRef(rid, client) for rid in rids]
        return refs[0] if self._options.get("num_returns", 1) == 1 else refs

    def __call__(self, *a, **k):
        raise TypeError("Remote function cannot be called directly; "
                        "use .remote().")


class ClientActorMethod:
    def __init__(self, handle: "ClientActorHandle", name: str,
                 num_returns: int = 1):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns

    def options(self, num_returns: int = 1) -> "ClientActorMethod":
        return ClientActorMethod(self._handle, self._name, num_returns)

    def remote(self, *args, **kwargs):
        client = self._handle._client
        rids = client._call(
            "client_actor_call", self._handle._key, self._name,
            client._pack_args(args, kwargs), self._num_returns)
        refs = [ClientObjectRef(rid, client) for rid in rids]
        return refs[0] if self._num_returns == 1 else refs


class ClientActorHandle:
    def __init__(self, key: str, client: "ClientCore"):
        self._key = key
        self._client = client

    def __getattr__(self, name: str) -> ClientActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ClientActorMethod(self, name)

    def __reduce__(self):
        return (_resolve_actor, (self._key,))

    def __repr__(self) -> str:
        return f"ClientActorHandle({self._key[:16]})"


class ClientActorClass:
    def __init__(self, cls, options: Dict[str, Any]):
        self._cls = cls
        self._options = dict(options)
        self._blob = serialization.dumps_function(cls)

    def options(self, **overrides) -> "ClientActorClass":
        merged = dict(self._options)
        merged.update(overrides)
        return ClientActorClass(self._cls, merged)

    def remote(self, *args, **kwargs) -> ClientActorHandle:
        client = current_client()
        if client is None:
            raise RayTpuError("client not connected")
        key = client._call("client_actor_create", self._blob,
                           client._pack_args(args, kwargs), self._options)
        return ClientActorHandle(key, client)


class ClientCore:
    """The thin client itself (what ``init(address="ray-tpu://…")``
    returns). One outbound RPC connection; all state lives server-side."""

    def __init__(self, addr: Addr):
        self._rpc = RpcClient(tuple(addr))
        self._sid = self._rpc.call("client_connect")
        self._released: List[bytes] = []
        self._release_lock = threading.Lock()
        self._closed = False
        # Keepalive: the server reaps sessions whose pings stop (crashed
        # clients). A dedicated connection so pings never queue behind a
        # long blocking get on the main connection.
        self._ping_rpc = RpcClient(tuple(addr))
        self._stop_ping = threading.Event()
        self._ping_thread = threading.Thread(
            target=self._ping_loop, name="client-keepalive", daemon=True)
        self._ping_thread.start()

    def _ping_loop(self) -> None:
        from ray_tpu_torch.core.config import config

        period = max(1.0, config.client_session_timeout_s / 6.0)
        while not self._stop_ping.wait(period):
            try:
                self._ping_rpc.call("client_ping", self._sid, timeout=10.0)
            except Exception:
                # Enough missed pings and the server reaps the session —
                # the user deserves a trail before that happens.
                log_every("client.ping", period * 3, logger,
                          "client keepalive ping failed", exc_info=True)

    # -- plumbing

    def _call(self, method: str, *args, timeout: Optional[float] = None):
        self._flush_releases()
        return self._rpc.call(method, self._sid, *args, timeout=timeout)

    def _pack_args(self, args, kwargs) -> bytes:
        return serialization.serialize((tuple(args), dict(kwargs)))

    def _queue_release(self, rid: bytes) -> None:
        if self._closed:
            return
        with self._release_lock:
            self._released.append(rid)

    def _flush_releases(self) -> None:
        with self._release_lock:
            batch, self._released = self._released, []
        if batch and not self._closed:
            try:
                self._rpc.call("client_release", self._sid, batch)
            except Exception:
                # The dropped batch leaks server-side refs until session
                # teardown — tolerable, but never silent.
                log_every("client.release", 10.0, logger,
                          "releasing %d client refs failed", len(batch),
                          exc_info=True)

    # -- public surface (mirrors core worker usage in api.py)

    def get(self, refs, timeout: Optional[float] = None):
        single = isinstance(refs, ClientObjectRef)
        batch = [refs] if single else list(refs)
        reply = self._call("client_get", [r.id for r in batch], timeout,
                           timeout=None if timeout is None else timeout + 30)
        if "error" in reply:
            raise serialization.deserialize(reply["error"])
        values = serialization.deserialize(reply["values"])
        return values[0] if single else values

    def put(self, value: Any) -> ClientObjectRef:
        rid = self._call("client_put", serialization.serialize(value))
        return ClientObjectRef(rid, self)

    def wait(self, refs: Sequence[ClientObjectRef], num_returns: int,
             timeout: Optional[float]):
        by_id = {r.id: r for r in refs}
        ready, pending = self._call("client_wait", [r.id for r in refs],
                                    num_returns, timeout)
        return ([by_id[i] for i in ready], [by_id[i] for i in pending])

    def kill(self, handle: ClientActorHandle, no_restart: bool = True):
        self._call("client_kill", handle._key, no_restart)

    def get_actor(self, name: str) -> ClientActorHandle:
        key = self._call("client_get_actor", name)
        return ClientActorHandle(key, self)

    def cluster_resources(self) -> Dict[str, float]:
        return self._rpc.call("client_cluster_resources")

    def disconnect(self) -> None:
        global _current_client
        if self._closed:
            return
        self._closed = True
        self._stop_ping.set()
        try:
            self._rpc.call("client_disconnect", self._sid, timeout=10.0)
        except Exception:
            # Best-effort goodbye; the server reaps the session on ping
            # timeout anyway.
            log_every("client.disconnect", 10.0, logger,
                      "clean disconnect failed", level=logging.INFO,
                      exc_info=True)
        self._rpc.close()
        self._ping_rpc.close()
        if _current_client is self:
            _current_client = None


def connect(address: str, ignore_reinit_error: bool = False) -> ClientCore:
    """Connect this process as a thin client. ``address`` is
    ``ray-tpu://host:port`` of a :class:`ClientServer`."""
    global _current_client
    if _current_client is not None:
        if ignore_reinit_error:
            return _current_client
        raise RayTpuError("already connected as a client; pass "
                          "ignore_reinit_error=True to allow")
    hostport = address[len("ray-tpu://"):]
    host, _, port = hostport.rpartition(":")
    client = ClientCore((host, int(port)))
    _current_client = client
    return client
