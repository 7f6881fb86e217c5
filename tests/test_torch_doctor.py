"""The port's doctor (``ray_tpu_torch/doctor.py``) and the CLI's pure
builders, held against the JAX package's and on the port's runtime
components:

- the 10 cases of ``tests/test_flightrec.py`` on the port's flight
  recorder and ``doctor.post_mortem``;
- the 6 doctor cases of ``tests/test_core_observability.py`` (faults
  injected into the port's RPC server and client, pubsub hub and ref
  tracker) and the 4 of ``tests/test_control_plane_ft.py`` (the port's
  serve epoch gauges);
- parity: the same snapshots, dumps and event lists, made from a seed, give
  the same ``diagnose`` / ``post_mortem`` findings and ``render`` /
  ``render_post_mortem`` text on both packages, up to the CLI name in the
  remedies (``python -m ray_tpu_torch <cmd>`` against ``ray_tpu <cmd>``),
  and the same ``scripts._table``, ``_fmt_summary``, ``build_chrome_trace``
  and ``train_trace_summary``; ``usage.collect()`` agrees on a live
  cluster of each package, times aside."""

import copy
import json
import os
import socket
import time
import uuid

import numpy as np
import pytest

from ray_tpu import doctor as jdoctor
from ray_tpu import scripts as jscripts
from ray_tpu_torch import doctor
from ray_tpu_torch import scripts as tscripts
from ray_tpu_torch.core.config import config
from ray_tpu_torch.util import flightrec
from ray_tpu_torch.util.metrics import _Registry, counter_totals


def _snapshot_agg(source="n1/node/pid1"):
    """This process's registry as a one-source cluster aggregation."""
    return {source: _Registry.get().snapshot()}


def _counter_total(agg, name):
    return sum(counter_totals(agg, name).values())


# ------------------------------------------- tests/test_flightrec.py


@pytest.fixture()
def fr_dir(tmp_path):
    saved_dir = config.flightrec_dir
    saved_ring = config.flightrec_ring
    config.flightrec_dir = str(tmp_path)
    flightrec.reset()
    yield str(tmp_path)
    flightrec.reset()
    config.flightrec_dir = saved_dir
    config.flightrec_ring = saved_ring


def test_ring_is_bounded_and_ordered(fr_dir):
    config.flightrec_ring = 16
    flightrec.reset()
    for i in range(100):
        flightrec.record("t.tick", n=i)
    events = flightrec.dump()
    assert len(events) == 16
    assert [e["n"] for e in events] == list(range(84, 100))
    assert all(e["ev"] == "t.tick" and "ts" in e for e in events)


def test_disabled_recorder_is_a_noop(fr_dir):
    config.flightrec_enabled = False
    try:
        flightrec.reset()
        flightrec.record("t.tick", n=1)
        assert flightrec.dump() == []
    finally:
        config.flightrec_enabled = True


def test_flush_and_dump_all_roundtrip(fr_dir):
    flightrec.record("t.alpha", n=1)
    flightrec.record("t.beta", n=2)
    path = flightrec.flush_now()
    assert path and os.path.exists(path)
    # Torn/foreign files are skipped, not fatal.
    with open(os.path.join(fr_dir, "fr-99999.json"), "w") as f:
        f.write("{not json")
    with open(os.path.join(fr_dir, "unrelated.txt"), "w") as f:
        f.write("hi")
    dumps = flightrec.dump_all(fr_dir)
    assert len(dumps) == 1
    (source, doc), = dumps.items()
    assert doc["pid"] == os.getpid()
    assert [e["ev"] for e in doc["events"]] == ["t.alpha", "t.beta"]
    assert f"pid{os.getpid()}" in source
    # max_age_s drops stale sessions (this one is fresh).
    assert flightrec.dump_all(fr_dir, max_age_s=60.0)
    assert flightrec.dump_all(fr_dir, max_age_s=-1.0) == {}


def test_record_survives_unwritable_dir(fr_dir):
    config.flightrec_dir = "/proc/definitely/not/writable"
    flightrec.record("t.alpha", n=1)
    assert flightrec.flush_now() is None  # refused, not raised
    assert [e["ev"] for e in flightrec.dump()] == ["t.alpha"]


def test_cluster_dump_includes_own_ring(fr_dir):
    flightrec.record("t.alpha", n=1)
    dumps = flightrec.cluster_dump()
    assert any(e["ev"] == "t.alpha"
               for doc in dumps.values() for e in doc["events"])


def _gang_death_dumps(t0=1000.0, dead="host-1", dead_stage=1,
                      injected=True, reformed=True):
    """A synthetic crash history: ``dead`` of pipe 'pm' is SIGKILLed by
    a faultinject die rule at its beat site; the monitor reconciles the
    epoch-1 gang and (``reformed``) a fresh one forms under epoch 2."""
    alive = "host-0" if dead == "host-1" else "host-1"
    alive_stage = 1 - dead_stage
    driver = [
        {"ev": "gang.register", "ts": t0, "group": "pm-gang",
         "epoch": 1, "hosts": 2},
        {"ev": "gang.form", "ts": t0 + 0.2, "group": "pm-gang",
         "epoch": 1, "hosts": 2},
        {"ev": "pipe.step.start", "ts": t0 + 1.0, "pipeline": "pm",
         "step": 0, "mbs": 4},
        {"ev": "pipe.clock.drift", "ts": t0 + 2.0, "pipeline": "pm",
         "step": 1, "clocks": "2,1"},
        {"ev": "gang.reconcile", "ts": t0 + 3.0, "group": "pm-gang",
         "epoch": 1, "dead": dead, "coordinator_died": dead == "host-0"},
    ]
    if reformed:
        driver += [
            {"ev": "gang.register", "ts": t0 + 3.5, "group": "pm-gang",
             "epoch": 2, "hosts": 2},
            {"ev": "gang.form", "ts": t0 + 4.0, "group": "pm-gang",
             "epoch": 2, "hosts": 2}]
    else:
        driver.append({"ev": "gang.dead", "ts": t0 + 3.6,
                       "group": "pm-gang", "epoch": 1,
                       "cause": "restart budget exhausted"})
    dead_events = [
        {"ev": "gang.member.up", "ts": t0 + 0.1, "group": "pm-gang",
         "member": dead, "epoch": 1},
        {"ev": "pipe.stage.begin", "ts": t0 + 1.1, "pipeline": "pm",
         "stage": dead_stage, "step": 0, "asked": 0}]
    if injected:
        dead_events.append(
            {"ev": "fault.fired", "ts": t0 + 2.8,
             "site": f"multihost.member.pm-gang.{dead}.beat",
             "action": "die"})
    return {
        "driver-pid1": {"pid": 1, "role": "driver", "events": driver},
        "worker-pid2": {"pid": 2, "role": "worker", "events": [
            {"ev": "gang.member.up", "ts": t0 + 0.1, "group": "pm-gang",
             "member": alive, "epoch": 1},
            {"ev": "pipe.stage.begin", "ts": t0 + 1.1, "pipeline": "pm",
             "stage": alive_stage, "step": 0, "asked": 0},
            {"ev": "pipe.stage.apply", "ts": t0 + 2.5, "pipeline": "pm",
             "stage": alive_stage, "step": 1},
            {"ev": "pipe.stage.begin", "ts": t0 + 6.0, "pipeline": "pm",
             "stage": alive_stage, "step": 1, "asked": 1},
        ]},
        "worker-pid3": {"pid": 3, "role": "worker", "events": dead_events},
    }


def test_post_mortem_names_first_dying_member_and_surviving_epoch():
    findings = doctor.post_mortem(_gang_death_dumps())
    deaths = [f for f in findings if f["signature"] == "gang-death"]
    assert len(deaths) == 1
    d = deaths[0]
    assert d["evidence"]["first_dying"] == "host-1"
    assert d["evidence"]["surviving_epoch"] == 2
    assert d["evidence"]["injected"] is True
    assert "host-1" in d["summary"]
    assert "epoch 2" in d["summary"]
    # Member <-> stage correlation: host-1 hosts stage s1 of 'pm'.
    assert "s1" in d["summary"]
    assert "SIGKILL" in d["summary"]


def test_post_mortem_names_stopped_stage_clock():
    findings = doctor.post_mortem(_gang_death_dumps())
    stops = [f for f in findings
             if f["signature"] == "stage-clock-stop"]
    assert len(stops) == 1
    s = stops[0]
    assert s["evidence"]["stopped_stages"] == ["s1"]
    assert s["evidence"]["stage_clocks"] == {"s0": 1, "s1": 0}
    assert "s1" in s["summary"]


def test_post_mortem_reports_double_apply_guard_and_faults():
    findings = doctor.post_mortem(_gang_death_dumps())
    guards = [f for f in findings
              if f["signature"] == "double-apply-guard"]
    assert len(guards) == 1
    assert guards[0]["evidence"] == {"step": 1, "clocks": "2,1"}
    assert "double-apply guard FIRED" in guards[0]["summary"]
    faults = [f for f in findings
              if f["signature"] == "fault-injection"]
    assert len(faults) == 1
    assert faults[0]["evidence"]["fires"][0]["action"] == "die"


def test_post_mortem_quiet_on_orderly_history():
    dumps = {"driver-pid1": {"pid": 1, "role": "driver", "events": [
        {"ev": "gang.register", "ts": 1.0, "group": "g", "epoch": 1,
         "hosts": 2},
        {"ev": "pipe.step.commit", "ts": 2.0, "pipeline": "p",
         "step": 0},
        {"ev": "gang.shutdown", "ts": 3.0, "group": "g", "epoch": 1},
    ]}}
    assert doctor.post_mortem(dumps) == []
    text = doctor.render_post_mortem([], dumps)
    assert "no deaths or stalls" in text


def test_post_mortem_render_and_gang_dead_outcome():
    dumps = _gang_death_dumps(reformed=False)
    findings = doctor.post_mortem(dumps)
    d = [f for f in findings if f["signature"] == "gang-death"][0]
    assert d["evidence"]["surviving_epoch"] is None
    assert "DEAD" in d["summary"]
    text = doctor.render_post_mortem(findings, dumps)
    assert "gang-death" in text and "post-mortem over 3" in text
    json.dumps(findings)  # --json path stays serializable


# ------------------- tests/test_core_observability.py doctor signatures


def test_doctor_detects_injected_backpressure():
    """Signature 1: a stalled peer fills its outbound queue past the cap."""
    from ray_tpu_torch.core.rpc import RpcClient, RpcError, RpcServer

    before = _snapshot_agg()
    srv = RpcServer({"blob": lambda n: b"x" * n}, name="obs-bp",
                    inline_methods={"blob"},
                    outbound_cap_bytes=1 << 20)
    try:
        cli = RpcClient(srv.addr)
        # A 2 MiB reply against a 1 MiB cap trips backpressure at
        # enqueue; the conn is torn, so the call fails.
        with pytest.raises((RpcError, TimeoutError)):
            cli.call("blob", 2 << 20, timeout=5.0)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if _counter_total(_snapshot_agg(),
                              "rpc_backpressure_drops_total") > \
                    _counter_total(before,
                                   "rpc_backpressure_drops_total"):
                break
            time.sleep(0.05)
        cli.close()
    finally:
        srv.stop()
    findings = doctor.diagnose(before, _snapshot_agg(), 1.0)
    bp = [f for f in findings if f["signature"] == "rpc-backpressure"]
    assert bp and bp[0]["severity"] == "critical"
    assert "stopped reading" in bp[0]["summary"]


def test_doctor_detects_injected_reconnect_storm(monkeypatch):
    """Signature 2: redialing an address that never answers."""
    from ray_tpu_torch.core.rpc import RpcClient, RpcConnectError

    # A port that is closed NOW (bind+close; nothing listens after).
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = s.getsockname()
    s.close()
    monkeypatch.setattr(config, "rpc_connect_retries", 10)
    before = _snapshot_agg()
    with pytest.raises(RpcConnectError):
        RpcClient(dead)
    findings = doctor.diagnose(before, _snapshot_agg(), 1.0)
    storm = [f for f in findings if f["signature"] == "reconnect-storm"]
    assert storm and storm[0]["severity"] == "critical"
    assert "never answers" in storm[0]["summary"]


def test_doctor_detects_injected_pubsub_lag():
    """Signature 3: subscribers skipping versions faster than they poll."""
    from ray_tpu_torch.core.pubsub import Pubsub

    before = _snapshot_agg()
    hub = Pubsub()
    chan = f"lag-{uuid.uuid4().hex[:6]}"
    for i in range(40):
        hub.publish(chan, "w", i)
    for _ in range(4):  # four polls that each skipped 40 versions
        hub.poll(chan, "w", 0, timeout=1.0)
    findings = doctor.diagnose(before, _snapshot_agg(), 1.0)
    lag = [f for f in findings if f["signature"] == "pubsub-lag"
           and chan in f["source"]]
    assert lag and "consumers poll slower" in lag[0]["summary"]


def test_doctor_detects_injected_ref_growth():
    """Signature 4: monotonic live-ref growth with owner attribution."""
    from ray_tpu_torch.core.object_ref import _RefTracker

    tracker = _RefTracker.get()
    owner = ("127.0.0.1", 65431)
    before = _snapshot_agg()
    oids = [f"leak-{uuid.uuid4().hex}-{i}".encode() for i in range(250)]
    for oid in oids:
        tracker.inc(owner, oid)
    nodes = [{"node_id": "n1aaaaaa" + "0" * 56,
              "addr": ("127.0.0.1", 4321), "alive": True}]
    findings = doctor.diagnose(before, _snapshot_agg(), 1.0, nodes=nodes,
                               thresholds={"ref_growth": 200})
    leak = [f for f in findings if f["signature"] == "ref-leak"]
    assert leak and "leak suspect" in leak[0]["summary"]
    # Owner attribution: source key resolved through the node table.
    assert "on node n1 (127.0.0.1:4321)" in leak[0]["summary"]
    for oid in oids:  # release so later growth checks start clean
        tracker.dec(owner, oid)
    tracker._drain_decs()


def _rtt(node, fast, slow):
    buckets = (0.0005, 0.001, 0.005, 0.01, 0.1, 0.5, 1.0)
    counts = [0, fast, 0, 0, 0, slow, 0, 0]
    return {"name": "node_heartbeat_rtt_s", "kind": "histogram",
            "tags": {"node": node}, "buckets": list(buckets),
            "counts": counts, "sum": 0.001 * fast + 1.0 * slow,
            "count": fast + slow}


def test_doctor_detects_heartbeat_rtt_outlier():
    """Signature 5: one node's control-plane RTT far off the fleet
    median (metrics-level injection: four nodes, one sick)."""
    before = {f"n{i}/node/pid{i}": [_rtt(f"n{i}", 0, 0)] for i in range(4)}
    after = {f"n{i}/node/pid{i}": [_rtt(f"n{i}", 10, 0)] for i in range(3)}
    after["n3/node/pid3"] = [_rtt("n3", 0, 10)]
    findings = doctor.diagnose(before, after, 2.0)
    out = [f for f in findings if f["signature"] == "heartbeat-rtt-outlier"]
    assert out and out[0]["source"] == "node:n3"
    assert "fleet median" in out[0]["summary"]


def test_doctor_healthy_cluster_is_quiet():
    snap = _snapshot_agg()
    assert doctor.diagnose(snap, snap, 2.0) == []
    assert "no failure signatures" in doctor.render([])


# -------------------- tests/test_control_plane_ft.py doctor signatures


def test_doctor_detects_controller_flapping():
    from ray_tpu_torch.serve import metrics as sm

    sm.CONTROLLER_EPOCH.set(3.0)
    before = _snapshot_agg()
    sm.CONTROLLER_EPOCH.set(6.0)  # three bumps inside one window
    findings = doctor.diagnose(before, _snapshot_agg(), 2.0)
    flap = [f for f in findings
            if f["signature"] == "controller-flapping"]
    assert flap and flap[0]["severity"] == "critical"
    assert "crash-looping" in flap[0]["summary"]
    # one bump (a normal restart) stays quiet
    sm.CONTROLLER_EPOCH.set(7.0)
    after = _snapshot_agg()
    sm.CONTROLLER_EPOCH.set(7.0)
    quiet = doctor.diagnose(after, _snapshot_agg(), 2.0)
    assert not [f for f in quiet
                if f["signature"] == "controller-flapping"]


def test_doctor_detects_orphan_replica():
    from ray_tpu_torch.serve import metrics as sm

    sm.CONTROLLER_EPOCH.set(7.0)
    sm.REPLICA_EPOCH.set(2.0, {"deployment": "dft"})
    snap = _snapshot_agg()
    # Persistent across the window (same stale epoch in both
    # snapshots) -> orphan; the summary names the deployment.
    findings = doctor.diagnose(snap, snap, 2.0)
    orphan = [f for f in findings if f["signature"] == "orphan-replica"]
    assert orphan and "'dft'" in orphan[0]["summary"]
    assert "no controller reconciles" in orphan[0]["summary"]
    # Adoption heals it: replica re-pushed to the live epoch -> quiet.
    sm.REPLICA_EPOCH.set(7.0, {"deployment": "dft"})
    healed = _snapshot_agg()
    assert not [f for f in doctor.diagnose(healed, healed, 2.0)
                if f["signature"] == "orphan-replica"]


def test_doctor_adoption_transient_is_not_orphan():
    """A replica that lags ONE window behind (the adopt push raced the
    snapshot) must not page anyone: the condition has to hold in BOTH
    snapshots."""
    from ray_tpu_torch.serve import metrics as sm

    sm.CONTROLLER_EPOCH.set(9.0)
    sm.REPLICA_EPOCH.set(9.0, {"deployment": "dft"})
    before = _snapshot_agg()  # healthy
    sm.CONTROLLER_EPOCH.set(10.0)  # restart happened mid-window
    sm.REPLICA_EPOCH.set(9.0, {"deployment": "dft"})  # not yet adopted
    after = _snapshot_agg()
    assert not [f for f in doctor.diagnose(before, after, 2.0)
                if f["signature"] == "orphan-replica"]
    # leave the registry consistent for the healthy-cluster gates
    sm.REPLICA_EPOCH.set(10.0, {"deployment": "dft"})


def test_doctor_new_signatures_quiet_on_healthy_and_in_catalog():
    from ray_tpu_torch.serve import metrics as sm

    sm.CONTROLLER_EPOCH.set(11.0)
    sm.REPLICA_EPOCH.set(11.0, {"deployment": "dft"})
    snap = _snapshot_agg()
    findings = doctor.diagnose(snap, snap, 2.0)
    assert not [f for f in findings
                if f["signature"] in ("controller-flapping",
                                      "orphan-replica")]
    text = doctor.render([])
    assert "controller-flapping" in text and "orphan-replica" in text


# ------------------------------------------------ parity with ray_tpu

SEEDS = range(6)


def _as_reference(obj):
    """The port's findings with its CLI name as the JAX package writes it
    (the remedies' one deliberate difference)."""
    if isinstance(obj, str):
        return obj.replace("python -m ray_tpu_torch ", "ray_tpu ")
    if isinstance(obj, dict):
        return {k: _as_reference(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_as_reference(v) for v in obj)
    return obj


def _hist(name, tags, buckets, counts):
    counts = [int(c) for c in counts]
    return {"name": name, "kind": "histogram", "tags": dict(tags),
            "buckets": list(buckets), "counts": counts,
            "sum": float(sum(c * (i + 0.5) for i, c in enumerate(counts))),
            "count": int(sum(counts))}


def _random_window(seed):
    """Two cluster snapshots from a seed, with series for every live
    signature: counters that grow or not, gauges that diverge or not,
    histograms whose window crosses the thresholds or not."""
    rng = np.random.default_rng(seed)
    before, after = {}, {}
    hosts = [f"{i:x}" * 8 for i in range(1, 5)]
    for i, node in enumerate(hosts):
        for role, pid in (("node", 10 + i), ("worker", 100 + i)):
            src = f"{node}/{role}/pid{pid}"
            b, a = [], []
            drops = float(rng.integers(0, 3))
            b.append({"name": "rpc_backpressure_drops_total",
                      "kind": "counter", "tags": {"server": "s"},
                      "value": 1.0})
            a.append(dict(b[-1], value=1.0 + drops))
            q = float(rng.choice([0.0, 1e6, 64e6]))
            for snap in (b, a):
                snap.append({"name": "rpc_outbound_queue_bytes",
                             "kind": "gauge", "tags": {"server": "s"},
                             "value": q})
            fails = float(rng.choice([0, 3, 20]))
            for r in ("controller", "peer"):
                b.append({"name": "rpc_dial_failures_total",
                          "kind": "counter", "tags": {"role": r},
                          "value": 2.0})
                a.append(dict(b[-1], value=2.0 + fails * (r == "peer")))
            lag_b = rng.integers(0, 3, 6)
            lag_a = lag_b + rng.integers(0, 5, 6) * rng.integers(0, 2)
            for snap, counts in ((b, lag_b), (a, lag_a)):
                snap.append(_hist("psub_sub_lag", {"channel": f"c{i}"},
                                  (1, 5, 10, 25, 50), counts))
            refs = float(rng.integers(0, 50))
            b.append({"name": "obj_live_refs", "kind": "gauge", "tags": {},
                      "value": refs})
            a.append(dict(b[-1], value=refs + float(rng.choice([0, 5, 400]))))
            if role == "node":
                slow = int(rng.integers(0, 12)) * (i == 3)
                b.append(_rtt(f"n{i}", 0, 0))
                a.append(_rtt(f"n{i}", int(rng.integers(5, 15)), slow))
            before[src], after[src] = b, a
    ctl = f"{hosts[0]}/worker/pid900"
    ep = float(rng.integers(1, 5))
    bump = float(rng.choice([0, 1, 3]))
    before[ctl] = [{"name": "serve_controller_epoch", "kind": "gauge",
                    "tags": {}, "value": ep}]
    after[ctl] = [dict(before[ctl][0], value=ep + bump)]
    for d, dep in enumerate(("chat", "embed")):
        rep = ep + bump - float(rng.integers(0, 2))
        for snap in (before[ctl], after[ctl]):
            snap.append({"name": "serve_replica_epoch", "kind": "gauge",
                         "tags": {"deployment": dep}, "value": rep})
        lb = rng.integers(0, 4, 7)
        la = lb + rng.integers(0, 6, 7) * np.array(
            [1, 1, 1, 1, 1, d + rng.integers(0, 3), rng.integers(0, 4)])
        for snap, counts in ((before[ctl], lb), (after[ctl], la)):
            snap.append(_hist("serve_http_request_s", {"deployment": dep},
                              (0.1, 0.5, 1.0, 2.5, 5.0, 10.0), counts))
    for g in range(2):
        parked = rng.integers(0, 2, 4)
        for snap in (before[ctl], after[ctl]):
            for m in range(4):
                snap.append({"name": "mh_barrier_entered", "kind": "gauge",
                             "tags": {"group": f"gang-{g}",
                                      "member": f"host-{m}"},
                             "value": float(parked[m])})
    for p in range(2):
        base = rng.uniform(0.0, 2.0, 3)
        for snap in (before[ctl], after[ctl]):
            idle = base * rng.uniform(0.8, 1.2, 3)
            for s in range(3):
                snap.append({"name": "pipeline_stage_idle_s",
                             "kind": "gauge",
                             "tags": {"pipeline": f"p{p}", "stage": f"s{s}"},
                             "value": float(idle[s])})
    nodes = [{"node_id": h + "0" * 56, "addr": ("10.0.0.%d" % i, 4000 + i),
              "alive": True} for i, h in enumerate(hosts)]
    return before, after, nodes


def _diagnose_both(seed):
    """Both packages' findings and text on one seeded window; returns the
    signatures that fired."""
    before, after, nodes = _random_window(seed)
    th = {"ref_growth": 100, "slo_min_requests": 4, "slo_http_p99_s": 2.0}
    got = doctor.diagnose(copy.deepcopy(before), copy.deepcopy(after), 2.0,
                          nodes=nodes, thresholds=th)
    want = jdoctor.diagnose(before, after, 2.0, nodes=nodes, thresholds=th)
    assert _as_reference(got) == want
    assert _as_reference(doctor.render(got)) == jdoctor.render(want)
    fired = {f["signature"] for f in want}
    for f in got:
        if "ray_tpu" in f["remedy"]:
            assert "python -m ray_tpu_torch " in f["remedy"]
    return fired


@pytest.mark.parametrize("seed", SEEDS)
def test_diagnose_and_render_match_jax(seed):
    _diagnose_both(seed)


def test_parity_windows_fire_every_live_signature():
    """The seeded windows drive every live signature of the catalog."""
    fired = set()
    for seed in SEEDS:
        fired |= _diagnose_both(seed)
    assert fired >= {"rpc-backpressure", "reconnect-storm", "pubsub-lag",
                     "ref-leak", "heartbeat-rtt-outlier",
                     "controller-flapping", "orphan-replica", "gang-hang",
                     "slo-burn"}, fired


def _random_dumps(seed):
    rng = np.random.default_rng(seed)
    dumps = _gang_death_dumps(
        t0=float(rng.uniform(1e3, 1e6)),
        dead=str(rng.choice(["host-0", "host-1"])),
        dead_stage=int(rng.integers(0, 2)),
        injected=bool(rng.integers(0, 2)),
        reformed=bool(rng.integers(0, 2)))
    for doc in dumps.values():  # noise the post-mortem must ignore
        t = doc["events"][0]["ts"]
        for k in range(int(rng.integers(0, 4))):
            doc["events"].append({"ev": "t.noise", "ts": t + k, "n": k})
        rng.shuffle(doc["events"])
    return dumps


@pytest.mark.parametrize("seed", SEEDS)
def test_post_mortem_and_render_match_jax(seed):
    dumps = _random_dumps(seed)
    got = doctor.post_mortem(copy.deepcopy(dumps))
    want = jdoctor.post_mortem(dumps)
    assert got and _as_reference(got) == want
    assert (_as_reference(doctor.render_post_mortem(got, dumps))
            == jdoctor.render_post_mortem(want, dumps))


def _random_events(seed):
    """Task events and spans from a seed: plain tasks, a serve request's
    span chain across processes, and two pipelines' 1F1B cells."""
    rng = np.random.default_rng(seed)
    t0 = float(rng.uniform(1e3, 1e4))
    events = []
    for i in range(int(rng.integers(3, 8))):
        s = t0 + float(rng.uniform(0, 5))
        events.append({"task_id": f"task{i:04d}" * 2, "desc": f"f{i % 3}",
                       "state": str(rng.choice(["FINISHED", "FAILED"])),
                       "lease_ts": s, "end_ts": s + float(rng.uniform(0, 1)),
                       "owner": f"proc{i % 2}", "worker": f"w{i}"})
    events.append({"task_id": "nolease", "desc": "pending",
                   "state": "PENDING"})
    parent = None
    for k, desc in enumerate(("http", "router:chat", "attempt", "replica")):
        s = t0 + 0.1 * k
        events.append({"task_id": f"s{k}", "desc": desc, "state": "SPAN",
                       "trace_id": "tr", "span_id": f"s{k}",
                       "parent_span": parent, "lease_ts": s,
                       "end_ts": s + 1.0 - 0.1 * k,
                       "owner": f"proc{k % 3}", "worker": f"w{k}",
                       "attrs": {"attempt": 0} if desc == "attempt" else {}})
        parent = f"s{k}"
    for p in range(2):
        trace_id = f"pipe{p}"
        s0 = t0 + 10 * p
        events.append({"task_id": f"step{p}", "desc": "pipe:step",
                       "state": "SPAN", "trace_id": trace_id,
                       "span_id": f"root{p}", "lease_ts": s0,
                       "end_ts": s0 + 4.0, "owner": "driver",
                       "attrs": {"pipeline": f"pl{p}"}})
        for stage in range(2):
            for mb in range(int(rng.integers(1, 4))):
                for kind in ("fwd", "bwd"):
                    s = s0 + float(rng.uniform(0, 3))
                    d = float(rng.uniform(0.05, 0.5))
                    events.append({
                        "task_id": f"c{p}{stage}{mb}{kind}",
                        "desc": f"cell:{kind}", "state": "SPAN",
                        "trace_id": trace_id, "span_id": f"c{p}{stage}{mb}",
                        "parent_span": f"root{p}", "lease_ts": s,
                        "end_ts": s + d, "owner": "driver",
                        "attrs": {"stage": stage, "mb": mb}})
                    events.append({
                        "task_id": f"x{p}{stage}{mb}{kind}", "desc": kind,
                        "state": "SPAN", "trace_id": trace_id,
                        "span_id": f"x{p}{stage}{mb}{kind}",
                        "lease_ts": s, "end_ts": s + d / 2,
                        "owner": f"stage{p}{stage}",
                        "attrs": {"stage": stage, "mb": mb}})
            events.append({"task_id": f"a{p}{stage}", "desc": "apply",
                           "state": "SPAN", "trace_id": trace_id,
                           "span_id": f"a{p}{stage}", "lease_ts": s0 + 3.5,
                           "end_ts": s0 + 3.6, "owner": f"stage{p}{stage}",
                           "attrs": {"stage": stage}})
    order = rng.permutation(len(events))
    return [events[i] for i in order], t0


@pytest.mark.parametrize("seed", SEEDS)
def test_chrome_trace_and_train_summary_match_jax(seed):
    events, t0 = _random_events(seed)
    timelines = {"dep": {"dep#0": {"rows": [
        {"step": s, "t0": t0 + s, "t1": t0 + s + 0.01,
         "phases": [{"phase": "decode", "t0": t0 + s, "t1": t0 + s + 0.01,
                     "batch": 2, "k": 1}],
         "active": 2, "prefilling": 0, "queued": s % 2,
         "events": [{"kind": "page-alloc", "ts": t0 + s, "n": 1}]}
        for s in range(3)]}}}
    got = tscripts.build_chrome_trace(copy.deepcopy(events),
                                      copy.deepcopy(timelines))
    assert got == jscripts.build_chrome_trace(events, timelines)
    assert json.loads(json.dumps(got)) == got
    summary = tscripts.train_trace_summary(copy.deepcopy(events))
    assert summary == jscripts.train_trace_summary(events)
    assert set(summary) == {"pl0", "pl1"}
    assert all(0.0 <= r["bubble_fraction"] <= 1.0
               for r in summary.values())


@pytest.mark.parametrize("seed", SEEDS)
def test_table_and_fmt_summary_match_jax(seed):
    rng = np.random.default_rng(seed)
    cols = [f"c{i}" for i in range(int(rng.integers(1, 5)))]
    rows = [{c: ("x" * int(rng.integers(0, 12)) if rng.integers(0, 2)
                 else float(rng.uniform(-1e3, 1e3)))
             for c in cols if rng.integers(0, 4)}
            for _ in range(int(rng.integers(0, 5)))]
    assert tscripts._table(rows, cols) == jscripts._table(rows, cols)
    for unit in ("ms", "B"):
        count = int(rng.integers(0, 3))
        s = {"count": count, "mean": float(rng.uniform(0, 1)),
             "p50": float(rng.uniform(0, 1)),
             "p99": None if rng.integers(0, 2) else float(rng.uniform(0, 2))}
        for summary in (s, None, {}):
            assert (tscripts._fmt_summary(summary, unit)
                    == jscripts._fmt_summary(summary, unit))
    for name in ("pipeline_desc_bytes", "serve_ttft_s"):
        assert (tscripts._summary_unit(name)
                == jscripts._summary_unit(name))


def test_usage_collect_matches_jax():
    """``collect()`` on a live one-node cluster of each package (never
    both up): the same keys, and the same values but the time."""
    import ray_tpu
    import ray_tpu_torch
    from ray_tpu import usage as jusage
    from ray_tpu_torch import usage as tusage

    out = {}
    for name, pkg, usage in (("jax", ray_tpu, jusage),
                             ("torch", ray_tpu_torch, tusage)):
        pkg.init(num_cpus=2)
        try:
            usage.record_feature("parity.feature")
            out[name] = usage.collect()
        finally:
            pkg.shutdown()  # writes the report and resets the features
    for report in out.values():
        report.pop("ts")
    assert out["torch"] == out["jax"]
    assert out["torch"]["features"] == ["parity.feature"]
    assert out["torch"]["nodes"] == 1
    assert tusage.REPORT_DIR != jusage.REPORT_DIR
