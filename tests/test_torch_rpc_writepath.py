"""The port's RPC write path (``ray_tpu_torch.core.rpc``): the 15 cases
of ``tests/test_rpc_writepath.py`` under the same names and settings.

Covers: scatter-gather ``sendmsg`` framing (mixed in-band/OOB payloads),
head-of-line-blocking elimination (a stalled peer parks its own outbound
queue while other connections stay fast), the per-connection backpressure
cap, teardown-through-``_drop`` (fd reuse after a torn send must not kill
the reactor), per-connection chaos bandwidth pacing, and the ClientPool
eviction race fix (transparent re-dial).
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest

from ray_tpu_torch.core.rpc import (_LEN, ClientPool, RpcClient, RpcError,
                              RpcServer, dumps, dumps_parts, loads,
                              loads_frame, recv_frame, send_frame,
                              set_network_chaos)


def _server(**kw):
    return RpcServer({"ping": lambda: "pong",
                      "blob": lambda n: b"x" * n,
                      "echo": lambda x: x},
                     name="t", inline_methods={"ping", "blob"}, **kw)


def _raw_request(addr, method, *args, rcvbuf=4096):
    """A misbehaving peer: sends one request and never reads the reply."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    if rcvbuf:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcvbuf)
    s.connect(addr)
    req = dumps({"id": 1, "method": method, "args": args})
    s.sendall(_LEN.pack(len(req)) + req)
    return s


# --------------------------------------------------------------- framing


def test_sendmsg_framing_roundtrip_mixed_payloads():
    """One scatter-gather frame carrying in-band pickle + OOB buffers
    round-trips exactly."""
    a, b = socket.socketpair()
    try:
        payload = {"small": b"abc",
                   "big": np.arange(100_000, dtype=np.int64),
                   "nested": [np.ones((64, 64), np.float32), "txt", 7]}
        parts = dumps_parts(payload)
        assert len(parts) > 1  # OOB buffers took the scatter path
        box = {}
        reader = threading.Thread(
            target=lambda: box.update(v=loads_frame(recv_frame(b))))
        reader.start()  # frame outgrows the socketpair buffer
        send_frame(a, parts)
        reader.join(timeout=30)
        assert not reader.is_alive()
        got = box["v"]
        assert got["small"] == b"abc"
        np.testing.assert_array_equal(got["big"], payload["big"])
        np.testing.assert_array_equal(got["nested"][0],
                                      payload["nested"][0])
        assert got["nested"][1:] == ["txt", 7]
        # Plain in-band frames still round-trip.
        send_frame(a, dumps({"x": 1}))
        assert loads(recv_frame(b)) == {"x": 1}
    finally:
        a.close()
        b.close()


def test_sendmsg_many_buffers_partial_sends():
    """More OOB buffers than one iovec window, bigger than the socket
    buffer: exercises window splitting and partial-send resumption."""
    a, b = socket.socketpair()
    try:
        payload = {"many": [np.full((70_000,), i % 250, np.uint8)
                            for i in range(100)]}
        parts = dumps_parts(payload)
        assert len(parts) > 64  # spans multiple sendmsg windows
        got = {}
        reader = threading.Thread(
            target=lambda: got.update(v=loads_frame(recv_frame(b))))
        reader.start()
        send_frame(a, parts)
        reader.join(timeout=30)
        assert not reader.is_alive()
        assert len(got["v"]["many"]) == 100
        for i, arr in enumerate(got["v"]["many"]):
            np.testing.assert_array_equal(
                arr, np.full((70_000,), i % 250, np.uint8))
    finally:
        a.close()
        b.close()


def test_server_roundtrip_mixed_payload():
    srv = _server()
    try:
        cli = RpcClient(srv.addr)
        arr = np.arange(200_000, dtype=np.int64)
        got = cli.call("echo", {"a": arr, "b": b"small", "c": [1, 2]})
        np.testing.assert_array_equal(got["a"], arr)
        assert got["b"] == b"small" and got["c"] == [1, 2]
        assert cli.call("blob", 8 << 20) == b"x" * (8 << 20)
        cli.close()
    finally:
        srv.stop()


def test_zero_length_oob_reply_does_not_wedge_connection():
    """Regression (REVIEW high): an empty numpy array pickles to a 0-byte
    OOB buffer. Enqueued unfiltered, it sat at the outbound queue head
    forever — sendmsg consumes 0 bytes of it — spinning the flush loop at
    100% CPU under st.lock and wedging every later call on the conn."""
    empty = np.array([], dtype=np.float64)
    parts = dumps_parts({"id": 1, "ok": True, "result": empty})
    assert any(memoryview(p).nbytes == 0 for p in parts)  # premise holds
    srv = _server()
    try:
        cli = RpcClient(srv.addr)
        got = cli.call("echo", empty, timeout=5.0)
        assert got.shape == (0,)
        got = cli.call("echo", {"e": np.array([], np.int32), "x": 1},
                       timeout=5.0)
        assert got["e"].shape == (0,) and got["x"] == 1
        for _ in range(3):  # the connection must still be healthy
            assert cli.call("ping", timeout=5.0) == "pong"
        cli.close()
    finally:
        srv.stop()


# ------------------------------------------------- head-of-line blocking


def test_stalled_peer_does_not_head_of_line_block():
    """A peer that requests a multi-MB INLINE reply and never reads it
    parks the reply in its own outbound queue; other connections' RTTs
    stay in the low milliseconds (the old blocking-sendall design froze
    the reactor — and every connection — for up to 15 s)."""
    srv = _server()
    try:
        stalled = _raw_request(srv.addr, "blob", 8 << 20)
        time.sleep(0.3)  # reply is queued behind the 4 KiB rcvbuf
        cli = RpcClient(srv.addr)
        lats = []
        for _ in range(30):
            t0 = time.perf_counter()
            assert cli.call("ping", timeout=5.0) == "pong"
            lats.append(time.perf_counter() - t0)
        lats.sort()
        assert lats[len(lats) // 2] < 0.05, f"median {lats[len(lats)//2]}"
        assert lats[-1] < 2.0, f"worst ping {lats[-1]:.3f}s: reactor stalled"
        stalled.close()
        cli.close()
    finally:
        srv.stop()


@pytest.mark.chaos
def test_stalled_peer_delays_no_ping_past_100ms():
    """Write-path audit regression: with the queued
    write path there is NO residual blocking send anywhere in the server
    — inline handlers reply through _send_reply (non-blocking sendmsg +
    EVENT_WRITE residue), so a peer that requests a multi-MB INLINE
    reply and never reads can delay an unrelated ping by at most one
    reactor pass. Bound EVERY ping at 100 ms (one scheduler outlier
    tolerated), not just the median — the seed design blocked 15 s under
    SO_SNDTIMEO on the FIRST stalled send."""
    srv = _server()
    try:
        cli = RpcClient(srv.addr)
        assert cli.call("ping", timeout=5.0) == "pong"  # warm the path
        stalled = []
        for _ in range(3):  # several stalled peers, replies all parked
            stalled.append(_raw_request(srv.addr, "blob", 8 << 20))
        time.sleep(0.2)
        lats = []
        for _ in range(50):
            t0 = time.perf_counter()
            assert cli.call("ping", timeout=5.0) == "pong"
            lats.append(time.perf_counter() - t0)
        lats.sort()
        assert lats[-2] < 0.1, (
            f"ping delayed {lats[-2] * 1e3:.1f} ms by a stalled peer "
            f"(worst {lats[-1] * 1e3:.1f} ms)")
        for s in stalled:
            s.close()
        cli.close()
    finally:
        srv.stop()


def test_backpressure_cap_drops_connection():
    """A peer that stops reading accumulates replies up to the cap, then
    its connection is dropped; the server keeps serving everyone else."""
    srv = _server(outbound_cap_bytes=1 << 20)
    try:
        stalled = _raw_request(srv.addr, "blob", 512 << 10)
        req_frames = b""
        for i in range(2, 10):
            r = dumps({"id": i, "method": "blob", "args": (512 << 10,)})
            req_frames += _LEN.pack(len(r)) + r
        stalled.sendall(req_frames)  # ~4.5 MiB of replies vs a 1 MiB cap
        time.sleep(0.5)
        stalled.settimeout(10.0)
        dead = False
        deadline = time.time() + 15
        try:
            while time.time() < deadline:
                if not stalled.recv(1 << 20):
                    dead = True
                    break
        except (ConnectionError, OSError):
            dead = True
        assert dead, "over-cap connection was not dropped"
        cli = RpcClient(srv.addr)
        assert cli.call("ping", timeout=5.0) == "pong"
        cli.close()
    finally:
        srv.stop()


def test_torn_send_teardown_and_fd_reuse_reactor_survives():
    """Regression for the ADVICE high finding: a reply-send failure must
    route through _drop (unregister + close). Each round tears a
    connection mid-flush with an RST, then immediately dials new
    connections so the kernel reuses the fd number — with the old
    close-without-unregister path, the stale selector key made the next
    register raise KeyError and killed the reactor cluster-wide."""
    srv = _server()
    try:
        for _ in range(5):
            s = _raw_request(srv.addr, "blob", 4 << 20)
            time.sleep(0.1)  # reply queued, partially flushed
            s.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                         struct.pack("ii", 1, 0))
            s.close()  # RST: the reactor's next flush hits ECONNRESET
            cli = RpcClient(srv.addr)
            assert cli.call("ping", timeout=5.0) == "pong"
            cli.close()
        assert srv._reactor_thread.is_alive()
        # Torn conns were unregistered: no stale fds accumulate (closed
        # RpcClient conns may linger while their reader thread holds the
        # socket, so compare against a small constant, not exact size).
        assert len(srv._selector.get_map()) <= 2 + 5
    finally:
        srv.stop()


def test_chaos_bandwidth_throttles_one_conn_not_others():
    """Server-side chaos bandwidth is applied as NON-BLOCKING per-
    connection pacing: the throttled transfer dribbles out at the
    configured rate while other connections' RTTs stay fast."""
    srv = _server()
    try:
        set_network_chaos(bandwidth_mbps=2.0)  # 250 KB/s per connection
        big = RpcClient(srv.addr)
        res = {}
        th = threading.Thread(target=lambda: res.update(
            blob=big.call("blob", 256 << 10, timeout=30.0)))
        t0 = time.time()
        th.start()
        time.sleep(0.2)
        cli = RpcClient(srv.addr)
        lats = []
        for _ in range(20):
            t1 = time.perf_counter()
            assert cli.call("ping", timeout=5.0) == "pong"
            lats.append(time.perf_counter() - t1)
        th.join(30)
        elapsed = time.time() - t0
        assert res.get("blob") == b"x" * (256 << 10)  # paced reply intact
        lats.sort()
        assert lats[len(lats) // 2] < 0.05  # others unaffected
        assert elapsed > 0.5  # the big transfer actually was throttled
    finally:
        set_network_chaos()
        srv.stop()


# ------------------------------------------------------------ client pool


def test_client_pool_eviction_redials_transparently():
    """ADVICE low: a caller that got a client from the pool, was
    preempted, and calls after the pool evicted+closed it must succeed
    (transparent re-dial), not fail on a healthy address."""
    srv1, srv2 = _server(), _server()
    try:
        pool = ClientPool(max_clients=1)
        c1 = pool.get(srv1.addr)
        assert c1.call("ping") == "pong"
        c1._last_handout = 0.0  # look idle long enough to be evictable
        c2 = pool.get(srv2.addr)  # evicts + closes c1 under the caller
        assert c1._closed
        assert c1.call("ping", timeout=5.0) == "pong"  # re-dials
        assert c1.notify("ping") is None  # notify path re-dials too
        assert c2.call("ping") == "pong"
        pool.close_all()
        # A client closed for real (not pool eviction) still raises.
        with pytest.raises(RpcError):
            c2.call("ping")
    finally:
        srv1.stop()
        srv2.stop()


def test_eviction_between_open_check_and_send_retries():
    """Regression (REVIEW medium): a holder whose send overlaps eviction
    — eviction lands after _ensure_open's check but before send_frame —
    must retry on a fresh connection instead of failing with RpcError."""
    srv = _server()
    try:
        pool = ClientPool(max_clients=1)
        c = pool.get(srv.addr)
        assert c.call("ping") == "pong"
        orig = c.__class__._ensure_open
        fired = []

        def hooked(self=c):
            orig(self)
            if not fired:  # evict exactly once, right after the check
                fired.append(1)
                self._evict()

        c._ensure_open = hooked
        assert c.call("ping", timeout=5.0) == "pong"  # retried, not failed
        assert c.notify("ping") is None
        c.close()
    finally:
        srv.stop()


def test_evict_is_noop_on_closed_client():
    """_evict after a real close (or connection loss) must not resurrect
    the client as re-dialable."""
    srv = _server()
    try:
        c = RpcClient(srv.addr)
        assert c.call("ping") == "pong"
        c.close()
        c._evict()
        assert not c._pool_evicted
        with pytest.raises(RpcError):
            c.call("ping")
    finally:
        srv.stop()


def test_stop_with_wedged_reactor_keeps_selector_fds_open():
    """Regression (REVIEW low): stop() must not close the wake socketpair
    and selector while the reactor thread is still alive — a wedged
    reactor would then select() on closed (and soon reused) fds."""
    srv = _server()
    real = srv._reactor_thread
    wedge = threading.Event()
    dummy = threading.Thread(target=wedge.wait, daemon=True)
    dummy.start()
    srv._reactor_thread = dummy  # simulate a reactor stuck past the join
    try:
        srv.stop()
        assert srv._wake_r.fileno() != -1 and srv._wake_w.fileno() != -1
        assert srv._selector.get_map() is not None
    finally:
        wedge.set()
        dummy.join(5)
        real.join(5)  # _stopped is set; the real reactor exits promptly
        srv._reactor_thread = real
        srv.stop()  # second stop reaps the selector and wake fds
        assert srv._wake_r.fileno() == -1 and srv._wake_w.fileno() == -1


def test_connect_closes_socket_when_setup_fails(monkeypatch):
    """Regression (found by graftlint resource-leak-path): post-
    connect setup (settimeout/setsockopt) raising inside _connect's
    retry loop must close the just-connected socket — pre-fix each retry
    orphaned one fd against a flapping peer."""
    from ray_tpu_torch.core import rpc as rpc_mod

    made = []

    class FakeSock:
        def __init__(self):
            self.closed = False

        def settimeout(self, t):
            raise OSError("setup blows up")

        def setsockopt(self, *a):
            pass

        def close(self):
            self.closed = True

    def fake_create_connection(addr, timeout=None):
        s = FakeSock()
        made.append(s)
        return s

    monkeypatch.setattr(rpc_mod.socket, "create_connection",
                        fake_create_connection)
    monkeypatch.setattr(rpc_mod.config, "rpc_connect_retries", 3)
    with pytest.raises(rpc_mod.RpcError):
        rpc_mod._connect(("127.0.0.1", 1), timeout=0.5)
    assert made and all(s.closed for s in made), \
        f"{sum(not s.closed for s in made)}/{len(made)} sockets leaked"


def test_ref_flush_abandons_undialable_owners(monkeypatch):
    """Regression: ref_update deltas for an owner that cannot
    even be DIALED are abandoned immediately (its objects died with it)
    instead of entering the 25-retry merge-back loop — pre-fix each dead
    session cost ~1 s of flush-thread stall per pass for up to 25
    passes, starving every queued local dec behind it (the
    test_data.py ObjectFreedError flake's second half)."""
    import collections
    import threading

    from ray_tpu_torch.core import object_ref as orf
    from ray_tpu_torch.core import runtime as rt
    from ray_tpu_torch.core.rpc import RpcConnectError

    dials = []

    class FakeClients:
        def get(self, addr):
            dials.append(addr)
            raise RpcConnectError(f"could not connect to {addr}")

    class FakeCore:
        addr = ("127.0.0.1", 4242)
        clients = FakeClients()

        def apply_ref_updates(self, deltas):
            pass

    monkeypatch.setattr(rt, "_core_worker", FakeCore())

    tracker = orf._RefTracker.__new__(orf._RefTracker)
    tracker._lock = threading.Lock()
    tracker._counts = {}
    tracker._dirty = {("127.0.0.1", 9999): {b"oid1": -1}}
    tracker._pending_decs = collections.deque()
    tracker._send_failures = {}
    tracker._wake = threading.Event()

    tracker.flush()
    assert dials == [("127.0.0.1", 9999)]
    assert tracker._dirty == {}, "undialable owner's deltas merged back"
    assert tracker._send_failures == {}
    tracker.flush()  # and they stay gone: no retry storm
    assert dials == [("127.0.0.1", 9999)]
