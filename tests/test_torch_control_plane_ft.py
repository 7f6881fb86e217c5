"""Control-plane fault tolerance on the port (``ray_tpu_torch.serve.
controller``, ``util/faultinject.py``, ``core/rpc.py``): the 14 cases of
``tests/test_control_plane_ft.py`` other than its four doctor cases
(those are in ``tests/test_torch_doctor.py``), under the same names and
settings, the ``slow`` mark of the outage soak included.

The serve controller's death is a non-event: its state checkpoints
through the core KV on every mutating op, a restarted controller adopts
still-alive replicas, an epoch lease fences the zombie predecessor's
writes, and the data plane keeps serving from cached snapshots while the
controller is down. One difference follows the port: the chaos case's
mesh deployment is a (1, 1) mesh, since the port's ``serve.run`` refuses
a mesh of more than one rank until the mesh replica is ported.
"""

import os
import signal
import threading
import time

import pytest

import ray_tpu_torch
from ray_tpu_torch import serve
from ray_tpu_torch.core.config import config
from ray_tpu_torch.serve.controller import (EPOCH_NAME, STATE_KEY,
                                      ServeController)
from ray_tpu_torch.util import faultinject
from ray_tpu_torch.util.faultinject import FaultInjected, Faults
from ray_tpu_torch.util.metrics import _Registry
from torch_fixtures import ray_start_regular  # noqa: F401


def _agg(source="n1/node/pid1"):
    """This process's registry as a one-source cluster aggregation."""
    return {source: _Registry.get().snapshot()}


# ------------------------------------------------ faultinject harness


@pytest.fixture
def faults_file(tmp_path, monkeypatch):
    path = str(tmp_path / "faults.json")
    monkeypatch.setattr(config, "faultinject_path", path)
    faultinject.reset_counters()
    yield path
    faultinject.reset_counters()


def test_faultinject_disabled_is_noop(monkeypatch):
    monkeypatch.setattr(config, "faultinject_path", "")
    faultinject.check("any.site.at.all")  # must not raise or stat


def test_faultinject_error_delay_counters(faults_file):
    with Faults(faults_file) as f:
        f.add("plane.op", "error", after=1, times=2)
        faultinject.check("plane.op")  # skipped: after=1
        with pytest.raises(FaultInjected):
            faultinject.check("plane.op")
        with pytest.raises(FaultInjected):
            faultinject.check("plane.op")
        faultinject.check("plane.op")  # times exhausted
        # glob sites + delay action
        f.add("rpc.server.*.slowme", "delay", delay_s=0.15)
        t0 = time.monotonic()
        faultinject.check("rpc.server.controller.slowme")
        assert time.monotonic() - t0 >= 0.14
        faultinject.check("rpc.server.controller.other")  # no match
    # context exit cleared the file: nothing fires any more
    faultinject.check("plane.op")
    faultinject.check("rpc.server.controller.slowme")


def test_faultinject_once_global_fuse(faults_file):
    with Faults(faults_file) as f:
        rule = f.add("fuse.site", "error", once_global=True,
                     rule_id="fuse-test")
        assert not f.marker_fired(rule)
        with pytest.raises(FaultInjected):
            faultinject.check("fuse.site")
        assert f.marker_fired(rule)
        # The cross-process fuse blew: no process fires it again, even
        # though this process's counter would allow it.
        faultinject.check("fuse.site")
    assert not os.path.exists(faults_file + ".fuse-test.fired")


def test_faultinject_server_drop_and_client_error(faults_file):
    """The wired-in sites: a server-side drop eats the reply (caller
    timeout governs), a client-side error raises typed pre-send."""
    from ray_tpu_torch.core.rpc import RpcClient, RpcServer

    srv = RpcServer({"echo": lambda x: x}, name="ftinj")
    try:
        cli = RpcClient(srv.addr)
        assert cli.call("echo", 1) == 1
        with Faults(faults_file) as f:
            drop = f.add("rpc.server.ftinj.echo", "drop")
            with pytest.raises(TimeoutError):
                cli.call("echo", 2, timeout=0.5)
            f.remove(drop)
            f.add("rpc.client.echo", "error")
            with pytest.raises(FaultInjected):
                cli.call("echo", 3, timeout=5.0)
        assert cli.call("echo", 4, timeout=5.0) == 4  # rules cleared
        cli.close()
    finally:
        srv.stop()


# ------------------------------------- ReconnectingClient backoff


def test_reconnecting_backoff_exponential_capped(monkeypatch):
    from ray_tpu_torch.core.rpc import ReconnectingClient

    monkeypatch.setattr("random.random", lambda: 0.5)  # jitter x1.0
    base = config.rpc_reconnect_backoff_base_ms / 1e3
    cap = config.rpc_reconnect_backoff_cap_ms / 1e3
    pauses = [ReconnectingClient._backoff_s(a) for a in range(12)]
    assert pauses[0] == pytest.approx(base)  # first retry stays FAST
    for a in range(1, 12):
        assert pauses[a] == pytest.approx(min(cap, base * 2 ** a))
    assert pauses[-1] == pytest.approx(cap)  # dead peer: capped trickle
    # jitter bounds: 0.5x..1.5x of the deterministic value
    monkeypatch.undo()
    for a in (0, 3, 11):
        want = min(cap, base * 2 ** a)
        got = ReconnectingClient._backoff_s(a)
        assert 0.5 * want <= got <= 1.5 * want


def test_reconnecting_client_retries_through_window(monkeypatch):
    """Dead peer: the call keeps (backed-off) retrying until the window
    closes, then surfaces the transport error."""
    import socket as _socket

    from ray_tpu_torch.core.rpc import ReconnectingClient, RpcError

    s = _socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()
    s.close()
    monkeypatch.setattr(config, "rpc_connect_retries", 1)
    monkeypatch.setattr(config, "rpc_reconnect_backoff_base_ms", 5)
    monkeypatch.setattr(config, "rpc_reconnect_backoff_cap_ms", 40)
    cli = ReconnectingClient(dead, retry_window_s=0.6)
    t0 = time.monotonic()
    with pytest.raises((RpcError, OSError)):
        cli.call("ping", timeout=5.0)
    elapsed = time.monotonic() - t0
    assert elapsed >= 0.55  # kept retrying through the window
    cli.close()


def test_reconnect_storm_still_detected_with_backoff(monkeypatch):
    """Satellite guard: the backoff must NOT starve the doctor's
    reconnect-storm signature — a client courting a dead controller
    still burns enough real dials inside one window (each re-dial is
    `rpc_connect_retries` failed connects, all counted)."""
    import socket as _socket

    from ray_tpu_torch import doctor
    from ray_tpu_torch.core.rpc import ReconnectingClient, RpcError

    s = _socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()
    s.close()
    monkeypatch.setattr(config, "rpc_connect_retries", 4)
    monkeypatch.setattr(config, "rpc_reconnect_backoff_base_ms", 2)
    monkeypatch.setattr(config, "rpc_reconnect_backoff_cap_ms", 50)
    before = _agg()
    cli = ReconnectingClient(dead, retry_window_s=0.8,
                             role="controller")
    with pytest.raises((RpcError, OSError)):
        cli.call("ping", timeout=5.0)
    cli.close()
    findings = doctor.diagnose(before, _agg(), 1.0)
    storm = [f for f in findings if f["signature"] == "reconnect-storm"]
    assert storm and storm[0]["severity"] == "critical"
    assert "never answers" in storm[0]["summary"]


# ------------------------------------------------ epoch lease fencing


def test_epoch_bump_and_fenced_kv_write():
    from ray_tpu_torch.core.controller import Controller
    from ray_tpu_torch.core.rpc import RpcClient
    from ray_tpu_torch.core.rpc_stubs import ControllerStub

    c = Controller()
    try:
        stub = ControllerStub(RpcClient(c.address))
        e1 = stub.epoch_bump("ft_test")
        e2 = stub.epoch_bump("ft_test")
        assert e2 == e1 + 1
        assert stub.kv_put_fenced("ft:k", b"new", e2, "ft_test") is True
        # The zombie (deposed epoch) write is REJECTED, not applied.
        assert stub.kv_put_fenced("ft:k", b"old", e1, "ft_test") is False
        assert stub.kv_get("ft:k") == b"new"
    finally:
        c.stop()


def test_pubsub_hub_fences_stale_epoch_publish():
    from ray_tpu_torch.core.pubsub import Pubsub

    hub = Pubsub()
    v1 = hub.publish("chan", "k", {"who": "new"}, epoch=2)
    assert v1 == 1
    assert hub.publish("chan", "k", {"who": "zombie"}, 99, 1) is None
    assert hub.snapshot("chan")["k"][1]["who"] == "new"
    # equal/newer epochs keep publishing; epoch-less keys stay unfenced
    assert hub.publish("chan", "k", {"who": "new2"}, epoch=2) == 2
    assert hub.publish("chan", "other", "x") == 1


def test_router_ignores_zombie_epoch_snapshot():
    from ray_tpu_torch.core.ids import ActorID
    from ray_tpu_torch.serve.deployment import _Router

    r = _Router.__new__(_Router)
    r.name = "fence-test"
    r._lock = threading.Lock()
    r._replicas = []
    r._inflight = {}
    r._version = 0
    r._ctrl_epoch = 0
    r._have_snapshot = threading.Event()
    r._max_ongoing = 8
    r._deleted = False
    rep = {"actor_id": ActorID.from_random().binary(),
           "replica_id": "a#0"}
    r._apply(5, {"epoch": 2, "replicas": [rep],
                 "max_ongoing_requests": 8})
    assert len(r._replicas) == 1 and r._ctrl_epoch == 2
    # zombie snapshot (older epoch, higher version): ignored, but the
    # version clock advances so the poll loop stays live
    r._apply(6, {"epoch": 1, "replicas": [], "deleted": True})
    assert len(r._replicas) == 1 and not r._deleted
    assert r._version == 6
    # the successor's snapshot applies
    r._apply(7, {"epoch": 3, "replicas": [rep, rep],
                 "max_ongoing_requests": 8})
    assert len(r._replicas) == 2 and r._ctrl_epoch == 3


# ------------------------------------ restart-with-adoption (logical)


@pytest.fixture
def serve_cluster(ray_start_regular):
    yield ray_start_regular
    try:
        serve.shutdown()
    except Exception:
        pass


@pytest.fixture
def slice_faults_cluster(tmp_path, monkeypatch):
    """Cluster whose node advertises a virtual 2x4 slice, with fault
    injection plumbed into every process (env set before init)."""
    path = str(tmp_path / "faults.json")
    monkeypatch.setenv("RAY_TPU_VIRTUAL_SLICE", "2x4")
    monkeypatch.setenv("RAY_TPU_FAULTINJECT_PATH", path)
    monkeypatch.setattr(config, "faultinject_path", path)
    faultinject.reset_counters()
    core = ray_tpu_torch.init(num_cpus=4)
    yield core, path
    try:
        serve.shutdown()
    except Exception:
        pass
    ray_tpu_torch.shutdown()
    faultinject.reset_counters()


def _quiesce(ctl: ServeController) -> None:
    """Simulated death of a DIRECT controller instance: loops stop,
    state stays exactly where the 'crash' left it."""
    ctl._stop.set()
    time.sleep(0.05)


def _epoch(core) -> int:
    blob = core.controller.call("kv_get", f"__epoch__:{EPOCH_NAME}")
    return int(blob) if blob else 0


@pytest.mark.timeout_s(240)
def test_restart_adopts_live_replicas_and_fences_zombie(serve_cluster):
    """The core adoption contract, on direct controller instances (no
    process kill — the SIGKILL path is the chaos test below): a
    successor restores the checkpoint, ADOPTS both replicas (same actor
    ids — no respawn), bumps the epoch, and the predecessor's next
    checkpoint write self-fences."""
    from ray_tpu_torch.core import serialization

    class Echo:
        def __call__(self, req):
            return {"pid": os.getpid()}

        def pid(self, _=None):
            return os.getpid()

    c1 = ServeController()
    assert c1._epoch >= 1
    v = c1.deploy("adopt_app", serialization.dumps_function(Echo), (),
                  {}, {"num_replicas": 2})
    assert v is not None
    ids1 = sorted(r.handle.actor_id.hex()
                  for r in c1._deployments["adopt_app"].replicas)
    assert len(ids1) == 2
    _quiesce(c1)

    c2 = ServeController()
    try:
        assert c2._epoch == c1._epoch + 1
        ids2 = sorted(r.handle.actor_id.hex()
                      for r in c2._deployments["adopt_app"].replicas)
        # Adopted in place: SAME actor ids — no respawn, no cold start.
        assert ids2 == ids1
        # Requests route through the adopted set.
        handle = serve.get_deployment_handle("adopt_app")
        out = handle.remote({"x": 1}).result(timeout=60)
        assert "pid" in out
        # The router applied the successor's epoch-stamped snapshot.
        from ray_tpu_torch.serve.deployment import _Router

        deadline = time.monotonic() + 10
        router = _Router.get("adopt_app")
        while router._ctrl_epoch < c2._epoch:
            assert time.monotonic() < deadline, router._ctrl_epoch
            time.sleep(0.05)
        # ZOMBIE: the predecessor wakes up and tries to checkpoint —
        # the fenced KV write is rejected and it ceases mutation.
        c1._fenced = False
        c1._stop.clear()
        c1._save_state()
        assert c1._fenced and c1._stop.is_set()
        # ... and its snapshot publishes are refused by the hub.
        assert c1._publish(c1._deployments["adopt_app"]) is None
    finally:
        _quiesce(c2)
        serve.delete("adopt_app")


@pytest.mark.timeout_s(240)
def test_pending_release_survives_restart(slice_faults_cluster):
    """Satellite regression: a controller that dies with a QUEUED
    sub-slice release (the release RPC failed) must free the chips
    after restart — the queue is checkpointed and the successor's
    reconcile loop resumes the retries."""
    core, faults_path = slice_faults_cluster
    from ray_tpu_torch.core import serialization

    class MeshStub:
        def __init__(self, mesh_shape=None):
            self.mesh_shape = mesh_shape

        def __call__(self, req):
            return {"ok": True}

    def topo():
        return core.controller.call("topology_state")

    c1 = ServeController()
    c1.deploy("meshapp", serialization.dumps_function(MeshStub), (), {},
              {"num_replicas": 1, "mesh_shape": [1, 2]})
    (slice_state,) = topo()["slices"].values()
    assert len(slice_state["reservations"]) == 1
    assert slice_state["chips_free"] == 6

    with Faults(faults_path) as faults:
        faults.add("rpc.client.release_subslice", "error")
        # Delete kills the replica; the injected release failure queues
        # the reservation id — and the queue checkpoints immediately.
        c1.delete("meshapp")
        with c1._lock:
            assert c1._pending_releases, "release was not queued"
        # Controller dies with the release still queued (the rule keeps
        # every retry failing until then).
        _quiesce(c1)
    # Successor restores the queue and its retries now succeed.
    c2 = ServeController()
    try:
        deadline = time.monotonic() + 15
        while True:
            (slice_state,) = topo()["slices"].values()
            if (not slice_state["reservations"]
                    and slice_state["chips_free"] == 8):
                break
            assert time.monotonic() < deadline, slice_state
            time.sleep(0.1)
        assert "meshapp" not in c2.status()
    finally:
        _quiesce(c2)


# --------------------------------------------- chaos acceptance (E2E)


@pytest.mark.chaos
@pytest.mark.timeout_s(300)
def test_chaos_sigkill_controller_mid_decode(slice_faults_cluster):
    """Acceptance: SIGKILL the serve controller actor (via the
    fault harness, at a named site) while decode streams are in flight
    and autoscaling is active —

    * zero in-flight stream failures (tokens keep flowing throughout);
    * the restarted controller ADOPTS live replicas without respawn
      (actor ids unchanged) and replaces only the dead one (a replica
      SIGKILLed during the outage — the overlapping-death case);
    * no double-reserved or leaked sub-slices (`topology_state` shows
      the SAME single reservation before and after);
    * routing snapshots resume within `serve_mttr_bound_s`;
    * a fenced zombie-epoch write is rejected.
    """
    core, faults_path = slice_faults_cluster
    from ray_tpu_torch.core.rpc_stubs import ControllerStub
    from ray_tpu_torch.serve.deployment import AutoscalingConfig, _Router

    class Streamer:
        """CPU 'decode' loop: slow enough that streams straddle the
        controller outage; shape mirrors a token stream."""

        def __call__(self, req):
            for i in range(int(req["n"])):
                time.sleep(0.04)
                yield i

        def pid(self, _=None):
            return os.getpid()

    class MeshStub:
        def __init__(self, mesh_shape=None):
            self.mesh_shape = mesh_shape

        def __call__(self, req):
            return {"ok": True}

    serve.run(
        serve.deployment(
            Streamer, num_replicas=2,
            autoscaling_config=AutoscalingConfig(
                min_replicas=2, max_replicas=3,
                target_ongoing_requests=16.0, upscale_delay_s=30.0,
                downscale_delay_s=600.0)).options(
            max_concurrency=16, max_ongoing_requests=32),
        name="llm_ft")
    # A (1, 1) mesh: the port's ``serve.run`` refuses a mesh of more
    # than one rank until the mesh replica is ported, and one rank still
    # reserves a sub-slice of the virtual slice for adoption to keep.
    serve.run(serve.deployment(MeshStub, num_replicas=1,
                               mesh_shape=(1, 1)), name="mesh_ft")
    handle = serve.get_deployment_handle("llm_ft")

    # Pre-kill ground truth: replica pids, actor ids, topology.
    pids = set()
    deadline = time.monotonic() + 60
    while len(pids) < 2 and time.monotonic() < deadline:
        pids.add(handle.options(method_name="pid").remote(None)
                 .result(timeout=60))
    assert len(pids) == 2
    st0 = serve.status(timeout=30)
    names0 = set(st0["llm_ft"]["replica_ids"])
    router = _Router.get("llm_ft")
    with router._lock:
        actor_ids0 = {r["id"]: r["handle"].actor_id.hex()
                      for r in router._replicas}
    (slice0,) = core.controller.call("topology_state")["slices"].values()
    assert len(slice0["reservations"]) == 1
    (resv0,) = slice0["reservations"].keys()
    e0 = _epoch(core)

    # In-flight streams that straddle the whole outage (~4 s each).
    results, errors = [], []

    def client(i):
        try:
            results.append(list(handle.stream({"n": 100})))
        except Exception as e:  # noqa: BLE001
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(6)]
    for t in threads:
        t.start()
    time.sleep(0.4)  # streams admitted and mid-"decode"

    with Faults(faults_path) as faults:
        kill = faults.add("serve.controller.reconcile_tick", "die",
                          once_global=True, rule_id="kill-ctl")
        deadline = time.monotonic() + 30
        while not faults.marker_fired(kill):
            assert time.monotonic() < deadline, "controller kill never fired"
            time.sleep(0.05)
        faults.clear()

    # Zero in-flight stream failures: the streams run to completion
    # while NO controller exists (nothing here pokes the dead actor,
    # so the restart has not even begun) — controller death is a
    # non-event for the data plane.
    for t in threads:
        t.join()
    assert not errors, errors
    assert len(results) == 6
    assert all(r == list(range(100)) for r in results)

    # Overlapping death: one replica dies while the controller is
    # STILL down. The restarted controller must adopt the survivor and
    # replace only this one.
    victim_pid = next(iter(pids))
    os.kill(victim_pid, signal.SIGKILL)

    # First status probe reports the dead controller -> restart ->
    # restore -> adoption; poll until the control plane reconverges.
    # MTTR clock starts at DETECTION (this probe): in production the
    # proxies' route refresh detects within ~2 s; here the test idled
    # the cluster deliberately while the streams drained.
    t_detect = time.monotonic()
    deadline = t_detect + float(config.serve_mttr_bound_s) + 60
    while True:
        st = serve.status(timeout=5)
        rec = st.get("llm_ft") or {}
        if (not rec.get("degraded") and _epoch(core) > e0
                and len(rec.get("replica_ids", ())) == 2):
            break
        assert time.monotonic() < deadline, st
        time.sleep(0.25)

    # Routing snapshots resumed (epoch-stamped) within the MTTR bound.
    deadline = t_detect + float(config.serve_mttr_bound_s)
    while router._ctrl_epoch <= e0:
        assert time.monotonic() < deadline, \
            f"snapshots not flowing within {config.serve_mttr_bound_s}s"
        time.sleep(0.05)
    mttr = time.monotonic() - t_detect
    assert mttr <= config.serve_mttr_bound_s

    # Adoption: the surviving replica kept its ACTOR (id unchanged —
    # no respawn); only the SIGKILLed one was replaced.
    st = serve.status(timeout=30)
    names_now = set(st["llm_ft"]["replica_ids"])
    survivors = names0 & names_now
    assert survivors, (names0, names_now)
    with router._lock:
        actor_ids_now = {r["id"]: r["handle"].actor_id.hex()
                         for r in router._replicas}
    adopted = [n for n in survivors
               if actor_ids_now.get(n) == actor_ids0.get(n)]
    assert adopted, (actor_ids0, actor_ids_now)
    # The mesh replica was adopted with its reservation: same single
    # reservation id, same free-chip count — nothing double-reserved,
    # nothing leaked.
    (slice1,) = core.controller.call("topology_state")["slices"].values()
    assert list(slice1["reservations"].keys()) == [resv0]
    assert slice1["chips_free"] == slice0["chips_free"]
    assert set(st["mesh_ft"]["replica_ids"]) \
        == set(st0["mesh_ft"]["replica_ids"])

    # Fenced zombie-epoch write: the pre-kill epoch can no longer
    # touch the checkpoint.
    assert ControllerStub(core.controller).kv_put_fenced(
        STATE_KEY, b"zombie", e0, EPOCH_NAME) is False


@pytest.mark.chaos
@pytest.mark.timeout_s(240)
@pytest.mark.slow  # 11s: outage soak; chaos sigkill test keeps the
# controller-FT path in tier-1
def test_serve_during_outage_http_and_soft_status(slice_faults_cluster):
    """Satellite: routers and proxies keep serving from their cached
    snapshot while the controller is DOWN (restart stretched to a
    multi-second window via an injected init delay): streaming requests
    complete through the real HTTP proxy, and `serve.status()` degrades
    soft (cached view, `degraded: True`) instead of raising."""
    import json as _json
    import urllib.request

    core, faults_path = slice_faults_cluster

    class Streamer:
        def __call__(self, req):
            for i in range(int(req["n"])):
                time.sleep(0.03)
                yield i

    serve.run(serve.deployment(Streamer, num_replicas=2).options(
        max_concurrency=8, max_ongoing_requests=16), name="out_app")
    host, port = serve.start_http()

    def post_stream(n, timeout=60):
        req = urllib.request.Request(
            f"http://{host}:{port}/out_app",
            data=_json.dumps({"n": n}).encode(),
            headers={"X-Serve-Stream": "1"})
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            items = [_json.loads(line) for line in resp if line.strip()]
        return items

    assert post_stream(3) == [0, 1, 2]  # warm (routes cached too)
    e0 = _epoch(core)

    with Faults(faults_path) as faults:
        # The restarted controller's __init__ stalls 8 s: the outage
        # becomes an observable window instead of a ~1 s blip.
        faults.add("serve.controller.init", "delay", delay_s=8.0,
                   times=1, rule_id="slow-restart")
        kill = faults.add("serve.controller.reconcile_tick", "die",
                          once_global=True, rule_id="kill-ctl2")
        deadline = time.monotonic() + 30
        while not faults.marker_fired(kill):
            assert time.monotonic() < deadline
            time.sleep(0.05)
        # DURING the outage: the data plane serves. The status probe
        # both degrades soft AND doubles as the failure report that
        # starts the (delayed) restart.
        st = serve.status(timeout=2)
        assert st.get("out_app", {}).get("degraded") is True, st
        assert st["out_app"]["replicas"] == 2
        assert post_stream(10) == list(range(10))  # through the proxy
        # Handle creation during the outage works off cached snapshots.
        h = serve.get_deployment_handle("out_app")
        assert list(h.stream({"n": 4})) == [0, 1, 2, 3]
        # Still down after the data-plane traffic: proves the streams
        # above really ran inside the outage window, not after it.
        st = serve.status(timeout=2)
        assert st.get("out_app", {}).get("degraded") is True, st
        faults.clear()

    # Recovery: controller back, same replicas, status un-degrades.
    deadline = time.monotonic() + 60
    while True:
        st = serve.status(timeout=5)
        rec = st.get("out_app") or {}
        if not rec.get("degraded") and len(rec.get("replica_ids",
                                                   ())) == 2:
            break
        assert time.monotonic() < deadline, st
        time.sleep(0.25)
    assert _epoch(core) > e0
    assert post_stream(3) == [0, 1, 2]
