"""``tests/test_autopilot.py`` on the port's autopilot
(``ray_tpu_torch/autopilot.py``), under the same names: hysteresis, token
buckets, epoch fencing (stale evidence must no-op with an audit record,
never double-kill), dry-run, the kill-switch OFF path, the gang
already-remediated guard, MTTR accounting, the doctor's machine-readable
remediation schema, and the severity-aware doctor exit codes. Everything
here runs against injected fakes (client / serve surface / clock)."""

import json

import pytest

from ray_tpu_torch.autopilot import ACTION_CLASSES, Autopilot, TokenBucket
from ray_tpu_torch.core.config import config
from ray_tpu_torch.util.metrics import _Registry, counter_totals


def _agg():
    return {"n1/test/pid1": _Registry.get().snapshot()}


def _counter(name, reason=None, action=None, outcome=None):
    want = {}
    if reason is not None:
        want["reason"] = reason
    if action is not None:
        want["action"] = action
    if outcome is not None:
        want["outcome"] = outcome
    total = 0.0
    for key, val in counter_totals(_agg(), name).items():
        tags = dict(key)
        if all(tags.get(k) == v for k, v in want.items()):
            total += val
    return total


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


class FakeClient:
    """Scripted .call transport: records every RPC the autopilot makes
    so tests can assert exactly which control surfaces were touched."""

    def __init__(self):
        self.calls = []
        self.nodes = []
        self.group = None
        self.put_result = {"ok": True, "epoch": 0}

    def call(self, method, *args, **kwargs):
        kwargs.pop("timeout", None)
        self.calls.append((method, args, kwargs))
        if method == "list_nodes":
            return self.nodes
        if method == "mh_group_state":
            return self.group
        if method == "mh_group_put":
            return self.put_result
        if method == "kv_put":
            return True
        if method == "taint_host":
            return {"node": args[0], "ttl_s": 120.0}
        if method == "taint_state":
            return {}
        raise KeyError(method)

    def methods(self):
        return [m for m, _a, _k in self.calls]


class FakeServe:
    def __init__(self, epoch=7):
        self.epoch = epoch
        self.resizes = []
        self.sheds = []
        self.deployments = {"llama": {"load": 20.0, "replicas": 1}}

    def status(self):
        return self.deployments

    def autopilot_resize(self, deployment, delta, epoch):
        if int(epoch) != self.epoch:
            return {"ok": False, "reason": "stale-epoch"}
        self.resizes.append((deployment, delta))
        return {"ok": True, "target": 2, "epoch": epoch}

    def autopilot_shed(self, deployment, queue_max, epoch):
        if int(epoch) != self.epoch:
            return {"ok": False, "reason": "stale-epoch"}
        self.sheds.append((deployment, queue_max))
        return {"ok": True, "queue_max": queue_max, "replicas": 1,
                "epoch": epoch}


def slo_finding(dep="llama"):
    return {"signature": "slo-burn", "severity": "warning",
            "source": f"deployment:{dep}",
            "summary": "p99 over objective", "evidence": {"p99_s": 9.0},
            "remediation": {"action": "resize-deployment", "target": dep,
                            "evidence_keys": ["p99_s"]},
            "remedy": "add replicas"}


def rtt_finding(prefix="aabbccdd"):
    return {"signature": "heartbeat-rtt-outlier", "severity": "warning",
            "source": f"node:{prefix}", "summary": "rtt outlier",
            "evidence": {"node_p99_s": 1.0},
            "remediation": {"action": "taint-host", "target": prefix,
                            "evidence_keys": ["node_p99_s"]},
            "remedy": "drain the host"}


def gang_finding(group="g1", victim="host-1", old_epoch=3):
    return {"signature": "gang-death", "severity": "critical",
            "source": f"group:{group}", "summary": "member died",
            "evidence": {"first_dying": victim, "old_epoch": old_epoch},
            "remediation": {"action": "reschedule-gang", "target": group,
                            "evidence_keys": ["first_dying"]},
            "remedy": "check the host"}


def make_pilot(monkeypatch, clock=None, serve=None, client=None,
               enabled=True, dry_run=False, burst=2, rate=2.0):
    monkeypatch.setattr(config, "autopilot_enabled", enabled)
    monkeypatch.setattr(config, "autopilot_dry_run", dry_run)
    monkeypatch.setattr(config, "autopilot_burst", burst)
    monkeypatch.setattr(config, "autopilot_rate_per_min", rate)
    return Autopilot(client=client or FakeClient(),
                     serve=serve or FakeServe(),
                     clock=clock or FakeClock())


# ------------------------------------------------------------ hysteresis


def test_single_window_takes_no_action(monkeypatch):
    """A signature seen in ONE doctor window must not trigger anything
    (hysteresis >= 2 windows): transient blips are not incidents."""
    serve = FakeServe()
    pilot = make_pilot(monkeypatch, serve=serve)
    before = _counter("autopilot_suppressed_total", reason="hysteresis")
    records = pilot.step([slo_finding()], serve_epoch=7)
    assert records == []
    assert serve.resizes == []
    assert _counter("autopilot_suppressed_total",
                    reason="hysteresis") == before + 1
    # Second consecutive window: the damper opens and the action fires.
    records = pilot.step([slo_finding()], serve_epoch=7)
    assert [r["outcome"] for r in records] == ["applied"]
    assert serve.resizes == [("llama", 1)]


def test_signature_gap_resets_streak(monkeypatch):
    """Present, absent, present again = two one-window blips, not a
    two-window streak — no action fires."""
    serve = FakeServe()
    pilot = make_pilot(monkeypatch, serve=serve)
    pilot.step([slo_finding()], serve_epoch=7)
    pilot.step([], serve_epoch=7)
    records = pilot.step([slo_finding()], serve_epoch=7)
    assert records == [] and serve.resizes == []


# ------------------------------------------------------------ rate limit


def test_rate_limit_exhaustion_suppresses_with_metric(monkeypatch):
    """Burst of 1: the second same-class action in a window is
    suppressed and counted — remediation storms must degrade to
    alerts, not cascade."""
    serve = FakeServe()
    serve.deployments["gpt"] = {"load": 12.0, "replicas": 1}
    pilot = make_pilot(monkeypatch, serve=serve, burst=1, rate=0.0)
    two = [slo_finding("llama"), slo_finding("gpt")]
    pilot.step(two, serve_epoch=7)
    before = _counter("autopilot_suppressed_total", reason="rate-limit")
    records = pilot.step(two, serve_epoch=7)
    assert [r["outcome"] for r in records] == ["applied"]
    assert len(serve.resizes) == 1
    assert _counter("autopilot_suppressed_total",
                    reason="rate-limit") == before + 1


def test_token_bucket_refills_on_injected_clock():
    clock = FakeClock()
    bucket = TokenBucket(rate_per_min=60.0, burst=2, clock=clock)
    assert bucket.take() and bucket.take() and not bucket.take()
    clock.advance(1.0)  # 60/min == 1 token/s
    assert bucket.take() and not bucket.take()


# ------------------------------------------------------------ fencing


def test_stale_serve_epoch_noops_with_audit(monkeypatch):
    """Evidence observed against serve epoch 3; the controller is at 7
    (it restarted since) — the action must no-op AND leave an audit
    record naming the refusal."""
    serve = FakeServe(epoch=7)
    pilot = make_pilot(monkeypatch, serve=serve)
    pilot.step([slo_finding()], serve_epoch=3)
    records = pilot.step([slo_finding()], serve_epoch=3)
    assert [r["outcome"] for r in records] == ["stale-epoch"]
    assert serve.resizes == []
    audit = pilot.status()["audit"]
    assert audit and audit[-1]["signature"] == "slo-burn"
    assert audit[-1]["action"] == "resize-deployment"
    assert audit[-1]["outcome"] == "stale-epoch"


def test_stale_gang_epoch_never_double_kills(monkeypatch):
    """The group registry refuses the eviction write (the gang already
    re-registered under a newer epoch == it self-healed): outcome is
    stale-epoch, audited, and no second eviction is attempted."""
    client = FakeClient()
    client.group = {"group_id": "g1", "epoch": 4,
                    "members": {"host-0": {}, "host-1": {}}}
    client.put_result = {"ok": False, "reason": "stale_epoch", "epoch": 5}
    pilot = make_pilot(monkeypatch, client=client)
    pilot.step([gang_finding()])
    records = pilot.step([gang_finding()])
    assert [r["outcome"] for r in records] == ["stale-epoch"]
    assert records[0]["reason"] == "stale_epoch"
    # The fenced write was attempted exactly once and refused.
    assert client.methods().count("mh_group_put") == 1
    assert pilot._gang_acted == {}


def test_gang_already_remediated_guard(monkeypatch):
    """After the autopilot evicts at epoch E, its OWN eviction shows up
    as a fresh gang-death next pass — the acted-epoch guard must stop
    the loop; a genuinely new death (epoch > E) acts again."""
    client = FakeClient()
    client.group = {"group_id": "g1", "epoch": 4,
                    "members": {"host-0": {}, "host-1": {}}}
    client.put_result = {"ok": True, "epoch": 4}
    pilot = make_pilot(monkeypatch, client=client, burst=8)
    pilot.step([gang_finding()])
    records = pilot.step([gang_finding()])
    assert [r["outcome"] for r in records] == ["applied"]
    assert records[0]["detail"]["victim"] == "host-1"
    assert pilot._gang_acted == {"g1": 4}
    # Same epoch re-observed (our own reconcile's echo): no-op.
    pilot.step([gang_finding()])
    records = pilot.step([gang_finding()])
    assert [r["outcome"] for r in records] == ["stale-epoch"]
    assert records[0]["reason"] == "already-remediated"
    assert client.methods().count("mh_group_put") == 1
    # The gang died AGAIN after re-forming (epoch moved on): act. The
    # streak is already past the damper (the stale-epoch dispatch does
    # not re-arm it), so the very next window acts.
    client.group = {"group_id": "g1", "epoch": 6,
                    "members": {"host-0": {}, "host-1": {}}}
    records = pilot.step([gang_finding(old_epoch=5)])
    assert [r["outcome"] for r in records] == ["applied"]
    assert client.methods().count("mh_group_put") == 2


def test_taint_fence_requires_live_node(monkeypatch):
    """The RTT evidence names a node by metric-label prefix; if no
    LIVE node resolves it (died / replaced since diagnosis), the taint
    must no-op as stale."""
    client = FakeClient()
    client.nodes = [{"node_id": "aabbccdd" + "0" * 56, "alive": False}]
    pilot = make_pilot(monkeypatch, client=client)
    pilot.step([rtt_finding()])
    records = pilot.step([rtt_finding()])
    assert [r["outcome"] for r in records] == ["stale-epoch"]
    assert "taint_host" not in client.methods()


def test_taint_applies_to_resolved_live_node(monkeypatch):
    client = FakeClient()
    full = "aabbccdd" + "0" * 56
    client.nodes = [{"node_id": full, "alive": True}]
    pilot = make_pilot(monkeypatch, client=client)
    pilot.step([rtt_finding()])
    records = pilot.step([rtt_finding()])
    assert [r["outcome"] for r in records] == ["applied"]
    assert records[0]["target"] == full
    assert "taint_host" in client.methods()
    assert records[0]["mttr_s"] >= 0.0


# ------------------------------------------------------------- dry run


def test_dry_run_takes_zero_actions(monkeypatch):
    """--dry-run evaluates fences and reports what WOULD fire but
    mutates nothing anywhere."""
    client = FakeClient()
    client.nodes = [{"node_id": "aabbccdd" + "0" * 56, "alive": True}]
    client.group = {"group_id": "g1", "epoch": 4,
                    "members": {"host-0": {}, "host-1": {}}}
    serve = FakeServe()
    pilot = make_pilot(monkeypatch, client=client, serve=serve,
                       dry_run=True, burst=8)
    findings = [slo_finding(), rtt_finding(), gang_finding()]
    pilot.step(findings, serve_epoch=7)
    records = pilot.step(findings, serve_epoch=7)
    assert sorted(r["outcome"] for r in records) == ["dry-run"] * 3
    for mutator in ("taint_host", "mh_group_put", "kv_put"):
        assert mutator not in client.methods()
    assert serve.resizes == [] and serve.sheds == []


# --------------------------------------------------------- kill switch


def test_kill_switch_off_touches_nothing(monkeypatch):
    """autopilot_enabled=False (the default): no fence probe, no RPC,
    no serve call — indistinguishable from no autopilot at all."""
    from ray_tpu_torch.core.config import _FLAG_DEFS

    assert _FLAG_DEFS["autopilot_enabled"][1] is False
    client = FakeClient()
    serve = FakeServe()
    pilot = make_pilot(monkeypatch, client=client, serve=serve,
                       enabled=False)
    before = _counter("autopilot_suppressed_total", reason="disabled")
    for _ in range(3):
        records = pilot.step(
            [slo_finding(), rtt_finding(), gang_finding()],
            serve_epoch=7)
        assert records == []
    assert client.calls == []
    assert serve.resizes == [] and serve.sheds == []
    assert _counter("autopilot_suppressed_total",
                    reason="disabled") == before + 9


# ------------------------------------------------- applied bookkeeping


def test_applied_action_records_mttr_and_rearms(monkeypatch):
    """Applied: MTTR = first-seen -> applied on the injected clock, the
    gauge is set, and the streak re-arms so the SAME streak cannot
    refire next window while the cluster converges."""
    from ray_tpu_torch.util.metrics import gauge_totals

    clock = FakeClock(100.0)
    serve = FakeServe()
    pilot = make_pilot(monkeypatch, serve=serve, clock=clock)
    pilot.step([slo_finding()], serve_epoch=7)
    clock.advance(5.0)
    records = pilot.step([slo_finding()], serve_epoch=7)
    assert records[0]["outcome"] == "applied"
    assert records[0]["mttr_s"] == pytest.approx(5.0)
    mttr = {dict(k).get("action"): v for k, v in
            gauge_totals(_agg(), "autopilot_mttr_s").items()}
    assert mttr.get("resize-deployment") == pytest.approx(5.0)
    # Next window: streak restarted at 1 -> hysteresis suppresses.
    assert pilot.step([slo_finding()], serve_epoch=7) == []
    assert len(serve.resizes) == 1


def test_shed_resolves_tenant_and_halves_queue(monkeypatch):
    serve = FakeServe()
    pilot = make_pilot(monkeypatch, serve=serve)
    finding = {"signature": "rpc-backpressure", "severity": "critical",
               "source": "n1/serve_proxy/pid9", "summary": "queue",
               "evidence": {"queued_bytes": 1 << 26},
               "remediation": {"action": "shed-tenant",
                               "target": "n1/serve_proxy/pid9",
                               "evidence_keys": ["queued_bytes"]},
               "remedy": "shed"}
    pilot.step([finding], serve_epoch=7)
    records = pilot.step([finding], serve_epoch=7)
    assert [r["outcome"] for r in records] == ["applied"]
    # Process key resolved to the busiest deployment; cap = load // 2.
    assert serve.sheds == [("llama", 10)]


def test_actions_counter_labels(monkeypatch):
    before = _counter("autopilot_actions_total",
                      action="resize-deployment", outcome="applied")
    serve = FakeServe()
    pilot = make_pilot(monkeypatch, serve=serve)
    pilot.step([slo_finding()], serve_epoch=7)
    pilot.step([slo_finding()], serve_epoch=7)
    assert _counter("autopilot_actions_total",
                    action="resize-deployment",
                    outcome="applied") == before + 1


# ------------------------------------------- remediation hint schema


def test_remediation_schema_is_pinned():
    """Every doctor finding carries the machine-readable remediation
    contract the autopilot executes against: {action, target,
    evidence_keys} with action in REMEDIATION_ACTIONS or None, and
    evidence_keys sorted + a subset of the evidence dict. JSON
    round-trip stable (the --json consumers parse this)."""
    from ray_tpu_torch import doctor

    assert doctor.REMEDIATION_ACTIONS == tuple(ACTION_CLASSES)

    buckets = (0.0005, 0.001, 0.005, 0.01, 0.1, 0.5, 1.0)

    def rtt(node, fast, slow):
        counts = [0, fast, 0, 0, 0, slow, 0, 0]
        return {"name": "node_heartbeat_rtt_s", "kind": "histogram",
                "tags": {"node": node}, "buckets": list(buckets),
                "counts": counts, "sum": 0.001 * fast + 1.0 * slow,
                "count": fast + slow}

    before = {f"n{i}/node/pid{i}": [rtt(f"n{i}", 0, 0)]
              for i in range(4)}
    after = {f"n{i}/node/pid{i}": [rtt(f"n{i}", 10, 0)]
             for i in range(3)}
    after["n3/node/pid3"] = [rtt("n3", 0, 10)]
    findings = doctor.diagnose(before, after, 2.0)
    assert findings
    for f in json.loads(json.dumps(findings, default=str)):
        rem = f["remediation"]
        assert set(rem) == {"action", "target", "evidence_keys"}
        assert rem["action"] is None \
            or rem["action"] in doctor.REMEDIATION_ACTIONS
        assert rem["evidence_keys"] == sorted(rem["evidence_keys"])
        assert set(rem["evidence_keys"]) <= set(f["evidence"])
    out = [f for f in findings
           if f["signature"] == "heartbeat-rtt-outlier"]
    assert out and out[0]["remediation"]["action"] == "taint-host"
    assert out[0]["remediation"]["target"] == "n3"


def test_slo_burn_finding_carries_resize_hint():
    from ray_tpu_torch import doctor

    hist = {"name": "serve_http_request_s", "kind": "histogram",
            "tags": {"deployment": "llama"},
            "buckets": [0.1, 1.0, 10.0],
            "counts": [0, 0, 20, 0], "sum": 160.0, "count": 20}
    before = {"n1/proxy/p1": [dict(hist, counts=[0, 0, 0, 0],
                                   sum=0.0, count=0)]}
    after = {"n1/proxy/p1": [hist]}
    findings = doctor.diagnose(before, after, 2.0)
    out = [f for f in findings if f["signature"] == "slo-burn"]
    assert out and out[0]["source"] == "deployment:llama"
    rem = out[0]["remediation"]
    assert rem["action"] == "resize-deployment"
    assert rem["target"] == "llama"


# ------------------------------------------------- doctor exit codes


def test_doctor_exit_codes_distinguish_severity():
    from ray_tpu_torch.scripts import _findings_exit_code

    crit = [{"severity": "critical"}]
    warn = [{"severity": "warning"}]
    assert _findings_exit_code([], True) == 0
    assert _findings_exit_code(warn, True) == 1
    assert _findings_exit_code(crit, True) == 2
    assert _findings_exit_code(warn + crit, True) == 2
    assert _findings_exit_code(crit, False) == 0
