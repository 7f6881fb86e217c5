"""RPC transport: length-prefixed pickle frames over localhost TCP.

Fills the role of the reference's gRPC layer (``src/ray/rpc/grpc_server.h``,
``grpc_client.h``) for every process boundary in the runtime: driver <->
controller, node <-> controller, owner <-> worker (task push), worker <->
node. The wire format is deliberately minimal — an 8-byte big-endian length
prefix followed by a pickled message dict — because on a TPU VM every hop is
localhost or DCN-with-TLS-terminated-elsewhere; there is no cross-language
requirement (the reference needs protobuf for its Java/C++ frontends).

Concurrency model: ``RpcServer`` is a single-threaded reactor. ONE selector
thread accepts and reads every connection; inline methods run on the reactor,
the rest dispatch to a shared thread pool so a blocking handler (e.g. task
execution) never head-of-line-blocks control messages on the same connection.

Write model: the reactor owns the writes (the async-gRPC / asio
``async_write`` discipline). Handlers never send on the socket themselves —
they ENQUEUE serialized reply parts on the connection's outbound queue and
the queue is flushed with non-blocking scatter-gather ``sendmsg`` (one
syscall covers the length header, any number of small frames, and large
out-of-band buffers straight from their backing memory). A flush that would
block arms ``EVENT_WRITE`` and resumes when the kernel says the socket is
writable, so a stalled peer parks ITS OWN queue while every other
connection's round-trips continue unimpeded. Queues are capped
(``config.rpc_outbound_cap_bytes``, ~64 MiB): a peer that stops reading past
the cap is dropped. Every teardown — read EOF, read error, flush error,
over-cap, handler-thread failure — routes through ``_drop`` so the selector
can never retain a stale fd (fd reuse after an un-unregistered close would
kill the reactor). ``RpcClient`` multiplexes concurrent in-flight calls over
one socket with a response-reader thread, mirroring the async client-call
pattern of ``src/ray/rpc/client_call.h``; its sends are blocking
scatter-gather ``sendmsg`` on the caller's thread.
"""

from __future__ import annotations

import pickle
import selectors
import socket
import struct
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import cloudpickle

from ray_tpu_torch.core.config import config
from ray_tpu_torch.core import coremetrics as cm
from ray_tpu_torch.util import faultinject
from ray_tpu_torch.util import metrics as um

Addr = Tuple[str, int]

_LEN = struct.Struct(">Q")

# iovec window per sendmsg: far under Linux's UIO_MAXIOV (1024), large
# enough that a header + meta + a dozen OOB buffers go in one syscall.
_IOV_CAP = 64


def dumps(obj: Any) -> bytes:
    """Pickle with cloudpickle fallback for closures/lambdas/local classes."""
    try:
        return pickle.dumps(obj, protocol=5)
    except Exception:
        return cloudpickle.dumps(obj, protocol=5)


def loads(data) -> Any:
    return pickle.loads(data)


# Out-of-band frame layout (PEP 574): MAGIC | u32 meta_len | u32 n_bufs |
# u64 sizes[n] | meta | raw buffers. Large buffer-protocol payloads (numpy
# chunks, actor args) skip the pickle byte-copy on BOTH ends: the sender
# scatter-writes the raw buffers, the receiver reconstructs zero-copy
# views into the single recv buffer. \xff can never begin a plain pickle
# (those start with \x80 PROTO), so the magic is unambiguous.
_OOB_MAGIC = b"\xffRTB1"


def dumps_parts(obj: Any) -> list:
    """Serialize to a list of send buffers (scatter-gather). Falls back to
    one in-band pickle part for cloudpickle payloads and non-contiguous
    buffers."""
    bufs: list = []
    try:
        meta = pickle.dumps(obj, protocol=5, buffer_callback=bufs.append)
        raws = [b.raw() for b in bufs]
    except Exception:
        return [dumps(obj)]
    if not raws:
        return [meta]
    head = b"".join([_OOB_MAGIC,
                     struct.pack("<II", len(meta), len(raws)),
                     struct.pack(f"<{len(raws)}Q",
                                 *(r.nbytes for r in raws)),
                     meta])
    return [head] + raws


def loads_frame(frame) -> Any:
    view = memoryview(frame)
    if bytes(view[:len(_OOB_MAGIC)]) != _OOB_MAGIC:
        return pickle.loads(view)
    off = len(_OOB_MAGIC)
    meta_len, n = struct.unpack_from("<II", view, off)
    off += 8
    sizes = struct.unpack_from(f"<{n}Q", view, off)
    off += 8 * n
    meta = view[off:off + meta_len]
    off += meta_len
    buffers = []
    for s in sizes:
        buffers.append(view[off:off + s])
        off += s
    return pickle.loads(meta, buffers=buffers)


def _byte_view(p) -> memoryview:
    mv = p if isinstance(p, memoryview) else memoryview(p)
    if mv.ndim != 1 or mv.format != "B":
        mv = mv.cast("B")
    return mv


def _sendmsg_all(sock: socket.socket, bufs: List[memoryview]) -> None:
    """Blocking scatter-gather send of every buffer, in order. Handles
    partial sends and iovec windows; zero copies on the Python side."""
    idx, off = 0, 0
    n = len(bufs)
    while idx < n:
        window: List[memoryview] = []
        total = 0
        i, cur_off = idx, off
        while i < n and len(window) < _IOV_CAP and total < (8 << 20):
            mv = bufs[i]
            if cur_off:
                mv = mv[cur_off:]
                cur_off = 0
            window.append(mv)
            total += mv.nbytes
            i += 1
        sent = sock.sendmsg(window)
        while sent > 0:
            rem = bufs[idx].nbytes - off
            if sent >= rem:
                sent -= rem
                idx += 1
                off = 0
            else:
                off += sent
                sent = 0


def send_frame(sock: socket.socket, payload) -> None:
    """Client-side framed send: ONE scatter-gather ``sendmsg`` covers the
    length header and every payload part (header copy eliminated; large
    OOB buffers go straight from their backing memory, e.g. an mmap'd
    store chunk never lands in an intermediate bytearray)."""
    if isinstance(payload, (bytes, bytearray, memoryview)):
        payload = [payload]
    bufs: List[memoryview] = []
    total = 0
    for p in payload:
        mv = _byte_view(p)
        if mv.nbytes:
            bufs.append(mv)
            total += mv.nbytes
    _chaos_gate(sock, total)
    _sendmsg_all(sock, [memoryview(_LEN.pack(total))] + bufs)


def recv_exact(sock: socket.socket, n: int) -> memoryview:
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], min(n - got, 8 << 20))
        if r == 0:
            raise ConnectionError("socket closed mid-frame")
        got += r
    return view


def recv_frame(sock: socket.socket) -> memoryview:
    header = recv_exact(sock, _LEN.size)
    (length,) = _LEN.unpack(header)
    return recv_exact(sock, length)


# Network-chaos injection seam (reference: tc-based latency/bandwidth
# chaos, tests/chaos/chaos_network_delay.yaml + chaos_network_bandwidth
# .yaml — here in-process so the multi-node-in-one-machine fixture can
# exercise slow/lossy links without root/tc). Client sends apply it as a
# blocking gate on the caller's thread; server replies apply it as
# NON-BLOCKING per-connection pacing in the reactor flush (delay and
# bandwidth push out the conn's next_send_t, drop severs the conn), so a
# throttled peer never stalls the reactor for other connections.
_chaos = {"delay_s": 0.0, "jitter_s": 0.0, "drop_prob": 0.0, "rng": None,
          "bandwidth_bps": 0.0}


def set_network_chaos(delay_ms: float = 0.0, jitter_ms: float = 0.0,
                      drop_prob: float = 0.0,
                      bandwidth_mbps: float = 0.0, seed: int = 0) -> None:
    """Inject latency/jitter/loss/bandwidth limits into every outbound RPC
    of THIS process. ``drop_prob`` drops the send by severing the
    connection (the peer sees a reset — exercising the same reconnect
    paths a flaky network does). Zero everything to disable."""
    import random as _random

    _chaos.update(delay_s=delay_ms / 1e3, jitter_s=jitter_ms / 1e3,
                  drop_prob=drop_prob,
                  bandwidth_bps=bandwidth_mbps * 125_000.0,
                  rng=_random.Random(seed))


def _chaos_gate(sock: socket.socket, nbytes: int) -> None:
    if _chaos["rng"] is None:
        return
    if _chaos["drop_prob"] and _chaos["rng"].random() < _chaos["drop_prob"]:
        try:
            sock.close()
        except OSError:
            pass
        raise OSError("chaos: connection dropped")
    delay = _chaos["delay_s"]
    if _chaos["jitter_s"]:
        delay += _chaos["rng"].uniform(0.0, _chaos["jitter_s"])
    if _chaos["bandwidth_bps"]:
        delay += nbytes / _chaos["bandwidth_bps"]
    if delay > 0:
        time.sleep(delay)


class RpcError(Exception):
    """Transport-level failure (peer died, connection refused)."""


class RpcConnectError(RpcError):
    """The peer could not be dialed at all (connect retries exhausted).
    Distinct from a mid-call transport failure so callers can tell "the
    process at this address is gone" (its state died with it — safe to
    abandon per-peer work) from "the connection hiccuped" (retry)."""


class RpcTimeout(RpcError, TimeoutError):
    """A bounded call's reply did not land within its timeout. Also a
    ``TimeoutError``, so pre-existing ``except TimeoutError`` callers
    keep working; the RpcError base lets transport-failure handlers
    treat a timed-out peer like a dead one (same recovery: re-resolve,
    retry, or raise the typed refusal)."""


class RemoteCallError(Exception):
    """The handler on the peer raised; carries the remote exception."""

    def __init__(self, cause: BaseException):
        self.cause = cause
        super().__init__(repr(cause))


# Selector-key sentinel for the reactor's self-wake socket.
_WAKE = object()


class RpcServer:
    """Reactor request/response server.

    ``handlers`` maps method name -> callable(*args, **kwargs). Handlers run
    on a thread pool (or inline on the reactor for ``inline_methods``); their
    return value (or raised exception) is shipped back to the caller. A
    request with ``id is None`` is a one-way notification. Replies are queued
    per connection and flushed by the reactor with non-blocking ``sendmsg``
    (see module docstring) — no code path ever blocks in ``send`` on the
    reactor thread.
    """

    def __init__(
        self,
        handlers: Dict[str, Callable],
        host: str = "127.0.0.1",
        port: int = 0,
        name: str = "rpc",
        max_workers: int = 64,
        inline_methods: Optional[set] = None,
        outbound_cap_bytes: Optional[int] = None,
    ):
        self._handlers = dict(handlers)
        # Methods run directly on the connection reader thread instead of the
        # shared pool. Use for quick, never-blocking handlers that must make
        # progress even when the pool is saturated with blocking calls (e.g.
        # a node's return_worker while many lease_worker calls wait). Since
        # replies are enqueued (never sent blocking), an inline handler can
        # reply to an arbitrarily slow peer without stalling the reactor.
        self._inline = set(inline_methods or ())
        self._name = name
        self._out_cap = (outbound_cap_bytes if outbound_cap_bytes is not None
                         else config.rpc_outbound_cap_bytes)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(256)
        self.addr: Addr = self._sock.getsockname()
        self._pool = ThreadPoolExecutor(max_workers=max_workers,
                                        thread_name_prefix=f"{name}-h")
        self._stopped = threading.Event()
        self._conns: list[socket.socket] = []
        self._conns_lock = threading.Lock()
        # Reactor, not thread-per-connection: ONE selector thread reads
        # every connection (a 5,000-worker fleet means 5,000 inbound
        # sockets on a node/controller — a reader thread each breaks the
        # process's thread/mmap budget long before CPU does). Inline
        # methods run on the reactor; the rest dispatch to the pool.
        self._selector = selectors.DefaultSelector()
        # The listening socket lives in the same selector (data=None
        # marks it): one thread accepts AND reads — at 5,000 workers per
        # box, every thread per process counts against kernel.pid_max.
        self._sock.setblocking(False)
        self._selector.register(self._sock, selectors.EVENT_READ, None)
        # Self-wake pipe: handler threads post selector work (arm a
        # conn's EVENT_WRITE, drop a conn) to _ops and poke the reactor.
        # Only the reactor touches the selector — stdlib selectors are
        # not thread-safe for concurrent modify/select.
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._selector.register(self._wake_r, selectors.EVENT_READ, _WAKE)
        self._ops: deque = deque()
        self._ops_lock = threading.Lock()
        # Connections with queued data deferred by chaos pacing
        # (reactor-private; see _flush).
        self._paced: List[RpcServer._Conn] = []
        # Write-path observability: plain counters on the conn state
        # (updated under st.lock, which the write path already holds)
        # and reactor-private fold-in totals — the reactor and handler
        # threads NEVER touch the metrics registry. _collect_metrics
        # publishes at snapshot time (weakly registered: the collector
        # dies with the server).
        self._conn_states: Dict[RpcServer._Conn, None] = {}
        self._m_closed_frames = 0
        self._m_closed_bytes = 0
        self._m_closed_bp = 0
        self._m_conn_drops = 0
        self._m_flush_samples: deque = deque(maxlen=512)
        self._m_deltas = um.CounterDeltas()
        um.add_collector(self._collect_metrics)
        self._reactor_thread = threading.Thread(
            target=self._reactor, name=f"{name}-reactor", daemon=True)
        self._reactor_thread.start()

    def _collect_metrics(self) -> None:
        """Snapshot-time publisher for the write-path counters (runs on
        the metrics flusher/agent thread, never the reactor)."""
        if not config.core_metrics_enabled or self._stopped.is_set():
            return
        with self._conns_lock:
            live = list(self._conn_states)
        frames, nbytes, bp = (self._m_closed_frames, self._m_closed_bytes,
                              self._m_closed_bp)
        q_bytes = 0
        q_conns = 0
        for st in live:
            # st.lock per conn: an unlocked read can land between the
            # reactor's sendmsg and its out_bytes decrement and report
            # phantom queue bytes. This is a snapshot-cadence path; the
            # reactor holds each lock only for one non-blocking flush.
            with st.lock:
                frames += st.m_frames
                nbytes += st.m_bytes
                bp += st.m_bp
                out_bytes = st.out_bytes
            if out_bytes > 0:
                q_bytes += out_bytes
                q_conns += 1
        tags = {"server": self._name}
        cm.RPC_OUT_QUEUE_BYTES.set(float(q_bytes), tags)
        cm.RPC_OUT_QUEUE_CONNS.set(float(q_conns), tags)
        self._m_deltas.inc_to(cm.RPC_TX_FRAMES, "frames", frames, tags)
        self._m_deltas.inc_to(cm.RPC_TX_BYTES, "bytes", nbytes, tags)
        self._m_deltas.inc_to(cm.RPC_BACKPRESSURE_DROPS, "bp", bp, tags)
        self._m_deltas.inc_to(cm.RPC_CONN_DROPS, "drops",
                              self._m_conn_drops, tags)
        samples = []
        while True:
            try:
                samples.append(self._m_flush_samples.popleft())
            except IndexError:
                break
        if samples:
            cm.RPC_FLUSH_S.observe_many(samples, tags)

    def register(self, method: str, fn: Callable) -> None:
        self._handlers[method] = fn

    class _Conn:
        __slots__ = ("sock", "buf", "out", "out_bytes", "lock", "writing",
                     "dead", "next_send_t", "m_frames", "m_bytes", "m_bp")

        def __init__(self, sock):
            self.sock = sock
            self.buf = bytearray()          # inbound partial frames
            self.out = deque()              # outbound memoryviews
            self.out_bytes = 0
            self.lock = threading.Lock()    # guards out/out_bytes/dead
            self.writing = False            # EVENT_WRITE armed (reactor-only)
            self.dead = False
            self.next_send_t = 0.0          # chaos pacing gate
            self.m_frames = 0               # metrics (under lock; folded
            self.m_bytes = 0                # into the server's closed
            self.m_bp = 0                   # totals by _drop)

    # ----------------------------------------------------------- accept/read

    def _accept(self) -> None:
        while True:
            try:
                conn, _ = self._sock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.setblocking(False)
            st = RpcServer._Conn(conn)
            with self._conns_lock:
                self._conns.append(conn)
                self._conn_states[st] = None
            try:
                self._selector.register(conn, selectors.EVENT_READ, st)
            except KeyError:
                # A stale key under this fd number means some teardown
                # bypassed _drop (must not happen — but a dead entry here
                # would otherwise kill the reactor on the NEXT register).
                # Evict it and retry.
                try:
                    self._selector.unregister(conn)
                except (KeyError, OSError, ValueError):
                    pass
                try:
                    self._selector.register(conn, selectors.EVENT_READ, st)
                except (KeyError, OSError, ValueError):
                    self._drop(st)
            except (OSError, ValueError):
                self._drop(st)

    def _drop(self, st: "_Conn") -> None:
        """The single teardown path: marks the conn dead, clears its queue,
        unregisters it, closes it. Reactor-thread only (handler threads
        post a 'drop' op instead)."""
        with st.lock:
            st.dead = True
            st.out.clear()
            st.out_bytes = 0
        if st in self._paced:
            self._paced.remove(st)
        try:
            self._selector.unregister(st.sock)
        except (KeyError, OSError, ValueError):
            pass
        try:
            st.sock.close()
        except OSError:
            pass
        with self._conns_lock:
            if st.sock in self._conns:
                self._conns.remove(st.sock)
            if st in self._conn_states:
                # Fold the dead conn's counters into the server totals so
                # the collector's cumulative view never goes backwards.
                del self._conn_states[st]
                self._m_closed_frames += st.m_frames
                self._m_closed_bytes += st.m_bytes
                self._m_closed_bp += st.m_bp
                self._m_conn_drops += 1

    # ------------------------------------------------------------- wake/ops

    def _wake(self) -> None:
        try:
            self._wake_w.send(b"\x00")
        except (BlockingIOError, OSError):
            pass  # wake buffer full => reactor is already waking

    def _post_op(self, op: str, st: "_Conn") -> None:
        with self._ops_lock:
            self._ops.append((op, st))
        self._wake()

    def _drain_ops(self) -> None:
        while True:
            with self._ops_lock:
                if not self._ops:
                    return
                op, st = self._ops.popleft()
            if op == "drop":
                self._drop(st)
            elif not st.dead:  # "arm": flush now; arm/pace as needed
                self._flush(st)

    # ---------------------------------------------------------------- reactor

    def _reactor(self) -> None:
        while not self._stopped.is_set():
            self._drain_ops()
            timeout = 0.5
            if self._paced:
                now = time.monotonic()
                due = [st for st in self._paced
                       if st.dead or st.next_send_t <= now]
                for st in due:
                    self._paced.remove(st)
                    if not st.dead:
                        self._flush(st)
                if self._paced:
                    soonest = min(st.next_send_t for st in self._paced)
                    timeout = min(timeout,
                                  max(0.001, soonest - time.monotonic()))
            try:
                events = self._selector.select(timeout=timeout)
            except OSError:
                return
            for key, mask in events:
                st = key.data
                if st is None:  # the listening socket
                    self._accept()
                    continue
                if st is _WAKE:
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                    self._drain_ops()
                    continue
                if st.dead:  # dropped earlier in this event batch
                    continue
                if mask & selectors.EVENT_WRITE:
                    self._flush(st)
                if (mask & selectors.EVENT_READ) and not st.dead:
                    self._read(st)

    def _read(self, st: "_Conn") -> None:
        try:
            data = st.sock.recv(1 << 20)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._drop(st)
            return
        if not data:
            self._drop(st)
            return
        st.buf += data
        self._pump(st)

    def _pump(self, st: "_Conn") -> None:
        """Dispatch every complete frame buffered on the connection."""
        hdr = _LEN.size
        while not st.dead:
            if len(st.buf) < hdr:
                return
            (length,) = _LEN.unpack_from(st.buf)
            if len(st.buf) < hdr + length:
                return
            frame = bytes(st.buf[hdr:hdr + length])
            del st.buf[:hdr + length]
            try:
                msg = loads_frame(memoryview(frame))
            except Exception:
                self._drop(st)
                return
            if msg.get("method") in self._inline:
                self._handle(st, msg)
            else:
                try:
                    self._pool.submit(self._handle, st, msg)
                except RuntimeError:
                    # Pool shut down while a request was in flight:
                    # server stopping, or interpreter exit (the
                    # concurrent.futures atexit hook kills all pools
                    # before daemon threads die). Drop the request.
                    self._drop(st)
                    return

    # ------------------------------------------------------------ write path

    def _handle(self, st: "_Conn", msg) -> None:
        req_id = msg.get("id")
        try:
            if config.faultinject_path:
                # Named-endpoint fault injection (chaos tests only; the
                # flag gate keeps the hot path one attribute read). A
                # delay rule here CAN stall the reactor for inline
                # methods — deliberately: that's how a test simulates a
                # wedged control plane.
                faultinject.check(
                    f"rpc.server.{self._name}.{msg.get('method')}")
            handler = self._handlers[msg["method"]]
            result = handler(*msg.get("args", ()), **msg.get("kwargs", {}))
            reply = {"id": req_id, "ok": True, "result": result}
        except faultinject.FaultDropped:
            return  # injected lost reply: the caller's timeout governs
        except BaseException as e:  # noqa: BLE001 — errors must reach the caller
            reply = {"id": req_id, "ok": False, "error": e}
        if req_id is None:
            return
        try:
            parts = dumps_parts(reply)
        except Exception as e:
            parts = [dumps({"id": req_id, "ok": False,
                            "error": RpcError(f"unpicklable reply: {e!r}")})]
        self._send_reply(st, parts)

    def _send_reply(self, st: "_Conn", parts: list) -> None:
        """Enqueue one framed reply on the connection's outbound queue and
        flush opportunistically (non-blocking). Residue is flushed by the
        reactor on EVENT_WRITE. Never raises; never blocks."""
        # Zero-length parts (e.g. the 0-byte OOB PickleBuffer an empty
        # numpy array yields) must never reach the queue: sendmsg consumes
        # 0 bytes of them, so an unfiltered one would sit at the queue
        # head forever and wedge the flush loop.
        bufs = [mv for mv in map(_byte_view, parts) if mv.nbytes]
        total = sum(mv.nbytes for mv in bufs)
        rng = _chaos["rng"]
        if rng is not None:
            if _chaos["drop_prob"] and rng.random() < _chaos["drop_prob"]:
                with st.lock:
                    st.dead = True
                self._post_op("drop", st)
                return
            delay = _chaos["delay_s"]
            if _chaos["jitter_s"]:
                delay += rng.uniform(0.0, _chaos["jitter_s"])
        else:
            delay = 0.0
        with st.lock:
            if st.dead:
                return
            if st.out_bytes + _LEN.size + total > self._out_cap:
                # Backpressure: the peer stopped reading and its queue hit
                # the cap. A partial frame may already be on the wire, so
                # the stream is torn either way — drop the conn.
                st.dead = True
                st.m_bp += 1
                status = "error"
            else:
                st.out.append(memoryview(_LEN.pack(total)))
                st.out.extend(bufs)
                st.out_bytes += _LEN.size + total
                st.m_frames += 1
                st.m_bytes += _LEN.size + total
                if delay > 0:
                    st.next_send_t = max(st.next_send_t,
                                         time.monotonic() + delay)
                status = self._flush_locked(st)
        if status == "error":
            self._post_op("drop", st)
        elif status != "drained":
            self._post_op("arm", st)

    def _flush_locked(self, st: "_Conn") -> str:
        """Send as much queued data as the socket (and chaos pacing) allows.
        Caller holds ``st.lock``. Returns 'drained' | 'blocked' | 'paced' |
        'error'; on 'error' the conn is marked dead (caller routes to
        _drop). Never blocks: the socket is non-blocking."""
        bps = _chaos["bandwidth_bps"] if _chaos["rng"] is not None else 0.0
        while st.out:
            now = time.monotonic()
            if now < st.next_send_t:
                return "paced"
            window: List[memoryview] = []
            total = 0
            limit = max(4096, int(bps * 0.05)) if bps else (8 << 20)
            for mv in st.out:
                if total + mv.nbytes > limit and window:
                    break
                if mv.nbytes > limit - total:
                    mv = mv[:limit - total]
                window.append(mv)
                total += mv.nbytes
                if len(window) >= _IOV_CAP:
                    break
            try:
                sent = st.sock.sendmsg(window)
            except (BlockingIOError, InterruptedError):
                return "blocked"
            except OSError:
                st.dead = True
                return "error"
            st.out_bytes -= sent
            if bps:
                st.next_send_t = max(st.next_send_t, now) + sent / bps
            # `sent >= head.nbytes` holds for a 0-byte head even when
            # sent == 0, so stray empty views can never pin the queue.
            while sent > 0 or (st.out and st.out[0].nbytes == 0):
                head = st.out[0]
                if sent >= head.nbytes:
                    sent -= head.nbytes
                    st.out.popleft()
                else:
                    st.out[0] = head[sent:]
                    sent = 0
        return "drained"

    def _flush(self, st: "_Conn") -> None:
        """Reactor-side flush + interest-set bookkeeping."""
        timed = config.core_metrics_enabled
        t0 = time.perf_counter() if timed else 0.0
        with st.lock:
            status = self._flush_locked(st)
        if timed:
            # Bounded ring, drained by the snapshot-time collector; cost
            # on the reactor is two clock reads and a deque append.
            self._m_flush_samples.append(time.perf_counter() - t0)
        if status == "error":
            self._drop(st)
        elif status == "drained":
            self._set_writing(st, False)
        elif status == "blocked":
            self._set_writing(st, True)
        else:  # paced: park off the selector so a writable socket doesn't spin
            self._set_writing(st, False)
            if not st.dead and st not in self._paced:
                self._paced.append(st)

    def _set_writing(self, st: "_Conn", on: bool) -> None:
        if st.writing == on or st.dead:
            return
        mask = selectors.EVENT_READ | (selectors.EVENT_WRITE if on else 0)
        try:
            self._selector.modify(st.sock, mask, st)
        except (KeyError, OSError, ValueError):
            self._drop(st)
            return
        st.writing = on

    def stop(self) -> None:
        self._stopped.set()
        self._wake()  # pop the reactor out of select() immediately
        self._reactor_thread.join(timeout=2.0)
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            for c in self._conns:
                try:
                    c.close()
                except OSError:
                    pass
        if not self._reactor_thread.is_alive():
            # Only reap the wake fds and selector once the reactor has
            # actually exited: a reactor wedged past the join timeout
            # would otherwise select() on closed — soon reused — fds.
            for s in (self._wake_r, self._wake_w):
                try:
                    s.close()
                except OSError:
                    pass
            try:
                self._selector.close()
            except (OSError, RuntimeError):
                pass
        self._pool.shutdown(wait=False)


class RpcClient:
    """Client multiplexing concurrent calls over one TCP connection."""

    def __init__(self, addr: Addr, connect_timeout: Optional[float] = None,
                 role: str = "peer"):
        self.addr = tuple(addr)
        self._role = role  # dial-metrics label: controller | peer
        self._sock = _connect(self.addr, connect_timeout, role)
        self._send_lock = threading.Lock()
        self._next_id = 0
        self._id_lock = threading.Lock()
        self._pending: Dict[int, _PendingCall] = {}
        self._pending_lock = threading.Lock()
        self._closed = False
        self._pool_evicted = False
        self._lifecycle_lock = threading.Lock()
        self._reader = threading.Thread(target=self._read_loop,
                                        args=(self._sock,),
                                        name="rpc-client-read", daemon=True)
        self._reader.start()

    def _read_loop(self, sock: socket.socket) -> None:
        try:
            while True:
                msg = loads_frame(recv_frame(sock))
                with self._pending_lock:
                    call = self._pending.pop(msg["id"], None)
                if call is not None:
                    call.complete(msg)
        except (ConnectionError, OSError):
            # A stale reader (of a socket that a re-dial has replaced)
            # must not fail the fresh connection's calls: ``_fail_all``
            # checks under ``_lifecycle_lock``, which the re-dial holds,
            # that ``sock`` is still the current one.
            self._fail_all(RpcError(f"connection to {self.addr} lost"),
                           sock)

    def _fail_all(self, err: Exception,
                  sock: Optional[socket.socket] = None) -> None:
        """Close the client and fail every pending call; with ``sock``,
        only while ``sock`` is still the client's socket. The check, the
        close and taking the pending calls are one step under
        ``_lifecycle_lock`` (like close/_evict/_ensure_open): a reader
        that saw its socket current and then failed the calls a re-dial
        had already registered would lose a retried call."""
        with self._lifecycle_lock:
            if sock is not None and sock is not self._sock:
                return
            self._closed = True
            with self._pending_lock:
                pending, self._pending = self._pending, {}
        for call in pending.values():
            call.fail(err)

    def _ensure_open(self) -> None:
        # Double-checked fast path: a stale read here only costs one
        # trip into the locked re-check below, never a wrong decision.
        # graftlint: disable=unguarded-field-access
        if not self._closed:
            return
        with self._lifecycle_lock:
            if not self._closed:
                return
            if not self._pool_evicted:
                raise RpcError(f"client to {self.addr} is closed")
            # The pool reclaimed this idle connection while a caller still
            # held the handle (the get()/call() race): transparently
            # re-dial. Eviction requires no in-flight calls, so nothing is
            # lost; any stragglers were failed by the old reader. The dial
            # happens under _lifecycle_lock ON PURPOSE: it serializes
            # against _evict/close so eviction can never shut a half-built
            # fresh socket (see _evict's docstring).
            # graftlint: disable=lock-held-blocking
            self._sock = _connect(self.addr, None, self._role)
            self._pool_evicted = False
            self._closed = False
            self._reader = threading.Thread(target=self._read_loop,
                                            args=(self._sock,),
                                            name="rpc-client-read",
                                            daemon=True)
            self._reader.start()

    def call(self, method: str, *args, timeout: Optional[float] = None, **kwargs):
        if config.faultinject_path:
            # Client-side endpoint faults: error = typed failure the
            # caller handles (NOT retried by ReconnectingClient), drop =
            # torn-connection semantics (retried/reconnected).
            faultinject.check(f"rpc.client.{method}")
        self._ensure_open()
        with self._id_lock:
            self._next_id += 1
            req_id = self._next_id
        payload = dumps_parts({"id": req_id, "method": method,
                               "args": args, "kwargs": kwargs})
        for attempt in (0, 1):
            # Fresh per attempt: a failure is sticky on _PendingCall, and
            # the evicted socket's dying reader may have failed the first
            # registration via _fail_all before the retry resends.
            call = _PendingCall()
            with self._pending_lock:
                self._pending[req_id] = call
            try:
                # _send_lock held across the blocking send BY DESIGN:
                # its entire purpose is to serialize frame writes so two
                # threads can't interleave torn frames on the wire.
                # Client sends are caller-thread blocking (module
                # docstring); only the server reactor is non-blocking.
                # The unlocked _sock read is part of the protocol too: a
                # racing _evict closes it and the OSError arm below
                # re-dials and resends.
                with self._send_lock:
                    # graftlint: disable=lock-held-blocking, unguarded-field-access
                    send_frame(self._sock, payload)
                break
            except OSError as e:
                with self._pending_lock:
                    self._pending.pop(req_id, None)
                # Racy read by design: _evict flips the flag BEFORE
                # closing the socket, so a send that failed because of
                # eviction always sees it set; a stale False just
                # surfaces the send error to a caller that raced close().
                # graftlint: disable=unguarded-field-access
                if attempt == 0 and self._pool_evicted:
                    # Eviction closed the socket between our open-check
                    # and the send: re-dial and resend. Any partial frame
                    # died with the old connection, so no duplicate.
                    self._ensure_open()
                    continue
                self._fail_all(RpcError(f"send to {self.addr} failed: {e}"))
                raise RpcError(f"send to {self.addr} failed: {e}") from e
        try:
            return call.wait(timeout)
        except TimeoutError:
            with self._pending_lock:
                self._pending.pop(req_id, None)
            raise

    def notify(self, method: str, *args, **kwargs) -> None:
        """Fire-and-forget one-way message."""
        self._ensure_open()
        payload = dumps_parts({"id": None, "method": method,
                               "args": args, "kwargs": kwargs})
        for attempt in (0, 1):
            try:
                # Same frame-write serialization (and deliberate racy
                # _sock read) as call() above.
                with self._send_lock:
                    # graftlint: disable=lock-held-blocking, unguarded-field-access
                    send_frame(self._sock, payload)
                return
            except OSError as e:
                # Same deliberate racy read as call() above.
                # graftlint: disable=unguarded-field-access
                if attempt == 0 and self._pool_evicted:
                    self._ensure_open()  # send overlapped pool eviction
                    continue
                raise RpcError(f"send to {self.addr} failed: {e}") from e

    def close(self) -> None:
        """Permanent close (owner teardown, pool invalidate/close_all).
        Serialized with ``_ensure_open``'s re-dial via ``_lifecycle_lock``
        so it can never clobber a half-built fresh connection; pool
        eviction goes through ``_evict`` instead and stays re-dialable."""
        with self._lifecycle_lock:
            self._pool_evicted = False
            self._closed = True
            try:
                self._sock.close()
            except OSError:
                pass

    def _evict(self) -> None:
        """Pool-side close of an idle client a caller may still hold.
        The evicted mark and the socket close happen atomically under
        ``_lifecycle_lock``: a holder's re-dial can only run before this
        (impossible — only ``_evict`` sets ``_pool_evicted``) or after the
        OLD socket is closed, so eviction can never shut a fresh socket
        and strand the client permanently closed."""
        with self._lifecycle_lock:
            if self._closed:
                return  # already dead (connection loss or real close)
            self._pool_evicted = True
            self._closed = True
            try:
                self._sock.close()
            except OSError:
                pass


class _PendingCall:
    __slots__ = ("_event", "_msg", "_err")

    def __init__(self):
        self._event = threading.Event()
        self._msg = None
        self._err = None

    def complete(self, msg) -> None:
        self._msg = msg
        self._event.set()

    def fail(self, err: Exception) -> None:
        self._err = err
        self._event.set()

    def wait(self, timeout: Optional[float]):
        if not self._event.wait(timeout):
            raise RpcTimeout("RPC call timed out")
        if self._err is not None:
            raise self._err
        if not self._msg["ok"]:
            err = self._msg["error"]
            raise RemoteCallError(err) from err
        return self._msg["result"]


def _connect(addr: Addr, timeout: Optional[float],
             role: str = "peer") -> socket.socket:
    if config.faultinject_path:
        # Partition injection: an error/drop rule on this peer's address
        # makes every dial from this process fail — a one-way partition.
        faultinject.check(f"rpc.dial.{addr[0]}:{addr[1]}")
    retries = config.rpc_connect_retries
    instrumented = config.core_metrics_enabled
    deadline = None if timeout is None else time.monotonic() + timeout
    last_err: Optional[Exception] = None
    for _ in range(max(1, retries)):
        try:
            sock = socket.create_connection(addr, timeout=5.0)
        except OSError as e:
            # Every failed attempt counts: a dead address under active
            # redial shows up as a failure STORM in the cluster view,
            # which is exactly the reconnect-storm signature ray_tpu
            # doctor detects. Label is the peer ROLE (bounded), never
            # the address (ephemeral ports = unbounded cardinality).
            if instrumented:
                cm.RPC_DIAL_FAILURES.inc(1.0, {"role": role})
            last_err = e
            if deadline is not None and time.monotonic() > deadline:
                break
            time.sleep(0.05)
            continue
        try:
            sock.settimeout(None)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if instrumented:
                cm.RPC_DIALS.inc(1.0, {"role": role})
            return sock
        except OSError as e:
            # Post-connect setup failing must not orphan the connected
            # fd — one leaked socket per retry adds up under a flapping
            # peer (graftlint: resource-leak-path).
            sock.close()
            last_err = e
            if deadline is not None and time.monotonic() > deadline:
                break
            time.sleep(0.05)
    raise RpcConnectError(f"could not connect to {addr}: {last_err}")


class ReconnectingClient:
    """Controller-facing client that survives peer restarts.

    The reference's GCS client retries RPCs with backoff while the GCS is
    down and reconnects when it returns (``gcs_rpc_client.h`` retry loop);
    this is that behavior for the framed-pickle transport: on a transport
    error the socket is re-established and the call retried until
    ``retry_window_s`` elapses. Only use against the controller — its
    handlers are idempotent by design (re-register, kv_put, heartbeat,
    create_placement_group 2PC)."""

    def __init__(self, addr: Addr, retry_window_s: float = 10.0,
                 role: str = "controller"):
        self.addr = tuple(addr)
        self._window = retry_window_s
        self._role = role
        self._client: Optional[RpcClient] = None
        self._lock = threading.Lock()
        self._closed = False

    @staticmethod
    def _backoff_s(attempt: int) -> float:
        """Retry pause for the ``attempt``-th consecutive transport
        failure: base * 2^attempt, capped, with +/-50% jitter. The first
        retry stays FAST (base default 50 ms — a controller blip heals
        within one beat) while a dead controller decays to a capped
        trickle instead of the flat 0.2 s loop every client in the
        fleet used to synchronize on — that tight loop IS the
        reconnect-storm signature ``ray_tpu doctor`` flags, and the
        clients were its biggest in-tree source."""
        import random

        base = config.rpc_reconnect_backoff_base_ms / 1e3
        cap = config.rpc_reconnect_backoff_cap_ms / 1e3
        return min(cap, base * (2 ** attempt)) * (0.5 + random.random())

    def _get(self) -> RpcClient:
        with self._lock:
            if self._closed:
                raise RpcError(f"client to {self.addr} is closed")
            client = self._client
        if client is not None and not client._closed:
            return client
        # Dial OUTSIDE the lock: a peer that is down costs a connect
        # retry loop (seconds), and holding _lock across it would wedge
        # every concurrent call/notify/close on this handle behind one
        # stuck re-dial (graftlint: lock-held-blocking). Concurrent
        # re-dials are possible and cheap; first one in wins.
        fresh = RpcClient(self.addr, role=self._role)
        with self._lock:
            if self._closed:
                winner = None
            elif self._client is None or self._client._closed:
                self._client = fresh
                winner = fresh
            else:
                winner = self._client
        if winner is not fresh:
            fresh.close()
        if winner is None:
            raise RpcError(f"client to {self.addr} is closed")
        return winner

    def call(self, method: str, *args, timeout: Optional[float] = None,
             **kwargs):
        deadline = time.monotonic() + self._window
        attempt = 0
        while True:
            try:
                return self._get().call(method, *args, timeout=timeout,
                                        **kwargs)
            except TimeoutError:
                # A per-call timeout on a healthy connection is the
                # caller's latency bound, not a transport failure —
                # resending would both break the bound and duplicate the
                # request (TimeoutError subclasses OSError since 3.10, so
                # this arm must precede the transport arm).
                raise
            except (RpcError, ConnectionError, OSError):
                # Unlocked read: the worst a stale value costs is one
                # extra jittered retry against a just-closed handle, and
                # _get() re-checks _closed under _lock before dialing.
                # graftlint: disable=unguarded-field-access
                if self._closed or time.monotonic() > deadline:
                    raise
                if config.core_metrics_enabled:
                    cm.RPC_RECONNECT_RETRIES.inc(1.0, {"role": self._role})
                # Jittered exponential backoff between re-dials: fast
                # first retry, capped decay against a dead peer, and
                # the jitter de-synchronizes a fleet of clients that
                # all lost the same controller at the same instant.
                time.sleep(self._backoff_s(attempt))
                attempt += 1

    def notify(self, method: str, *args, **kwargs) -> None:
        """Best-effort one-way send (no retry: notifications are periodic)."""
        self._get().notify(method, *args, **kwargs)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            if self._client is not None:
                self._client.close()


class ClientPool:
    """Caches one RpcClient per address; thread-safe, LRU-capped.

    Mirrors the reference's per-address gRPC client caching in the core
    worker (``core_worker_client_pool.h``, incl. its idle-connection
    reclaim). The cap matters at actor-surge scale: every cached client
    owns a reader THREAD, and a driver talking to thousands of actor workers
    would otherwise hold 5,000 threads/connections — past
    vm.max_map_count that breaks thread creation process-wide. Only
    clients with no in-flight calls are evicted, and an evicted client a
    caller still holds re-dials transparently on its next call (the pool
    marks it ``_pool_evicted`` — closing the get()/call() preemption race
    where eviction used to fail a healthy caller).
    """

    def __init__(self, max_clients: int = 1024):
        from collections import OrderedDict

        self._clients: "OrderedDict[Addr, RpcClient]" = OrderedDict()
        self._max = max_clients
        self._lock = threading.Lock()

    def get(self, addr: Addr) -> RpcClient:
        import time as _time

        addr = tuple(addr)
        now = _time.monotonic()
        with self._lock:
            client = self._clients.get(addr)
            if client is not None and not client._closed:
                self._clients.move_to_end(addr)
                client._last_handout = now
                return client
        # Dial OUTSIDE the pool lock. The connect path retries with
        # sleeps for seconds when the peer is down; under _lock that
        # head-of-line-blocked every get() for every OTHER (healthy)
        # address in the process — on the serve path, one dead replica
        # wedged the whole router (graftlint: lock-held-blocking).
        # Concurrent gets for the same addr may each dial; the first to
        # re-check under the lock wins and the rest close their socket.
        fresh = RpcClient(addr)
        evicted: List[RpcClient] = []
        now = _time.monotonic()
        with self._lock:
            client = self._clients.get(addr)
            if client is not None and not client._closed:
                self._clients.move_to_end(addr)
                client._last_handout = now
            else:
                client = fresh
                client._last_handout = now
                self._clients[addr] = client
                if len(self._clients) > self._max:
                    for key in list(self._clients):
                        if len(self._clients) <= self._max:
                            break
                        if key == addr:
                            continue
                        cand = self._clients[key]
                        # Evict only clients that are idle AND haven't
                        # been handed out recently: a thread that just
                        # got this client may not have registered its
                        # call yet, and a point-in-time _pending check
                        # alone would close the connection under it.
                        if (not cand._pending
                                and now - getattr(cand, "_last_handout",
                                                  0.0) > 5.0):
                            del self._clients[key]
                            evicted.append(cand)
        if client is not fresh:
            fresh.close()  # lost the insert race; drop the spare socket
        for c in evicted:
            c._evict()  # mark+close atomically; holders re-dial
        return client

    def invalidate(self, addr: Addr) -> None:
        with self._lock:
            client = self._clients.pop(tuple(addr), None)
        if client is not None:
            client.close()

    def close_all(self) -> None:
        with self._lock:
            clients, self._clients = list(self._clients.values()), {}
        for c in clients:
            c.close()
