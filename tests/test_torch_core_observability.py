"""Core-plane observability on the port (``ray_tpu_torch``): the 22 cases
of ``tests/test_core_observability.py`` other than its six doctor cases
(those are in ``tests/test_torch_doctor.py``), under the same names and
settings: RPC / object / pubsub / controller instruments, the per-node
MetricsAgent and the cluster merge (two nodes merge, a re-push never
double-counts, a node's death drops its series, a controller restart
leaves the agent alive), the controller's Prometheus endpoint, the
``metrics`` and ``doctor`` CLI, object-plane spans in the Chrome trace,
the ``log_suppressed_total`` counter, and graftlint's
metrics-label-cardinality and flight-recorder rules, read over fixture
modules written against the port and over the whole ``ray_tpu_torch``
package (``tests/torch_lint.py``). The two live cases share one
module-scoped ``init(num_cpus=4)``."""

import json
import logging
import threading
import time
import urllib.request
import uuid

import numpy as np
import pytest

from ray_tpu_torch.util.metrics import (_Registry, delta_aggregated,
                                        merge_histograms, prometheus_text)
from torch_lint import lint_project, port_findings, run_metrics_lint


def _snapshot_agg(source="n1/node/pid1"):
    """This process's registry as a one-source cluster aggregation."""
    return {source: _Registry.get().snapshot()}


def _counter_total(agg, name):
    from ray_tpu_torch.util.metrics import counter_totals

    return sum(counter_totals(agg, name).values())


# ----------------------------------------------- plane instrumentation


def test_rpc_server_write_path_counters():
    from ray_tpu_torch.core.rpc import RpcClient, RpcServer

    srv = RpcServer({"echo": lambda x: x}, name="obs-t",
                    inline_methods={"echo"})
    try:
        cli = RpcClient(srv.addr)
        for i in range(20):
            assert cli.call("echo", i) == i
        snap = _Registry.get().snapshot()
        mine = {m["name"]: m for m in snap
                if m.get("tags", {}).get("server") == "obs-t"}
        assert mine["rpc_tx_frames_total"]["value"] >= 20
        assert mine["rpc_tx_bytes_total"]["value"] > 0
        assert mine["rpc_outbound_queue_bytes"]["value"] == 0.0
        cli.close()
    finally:
        srv.stop()


def test_rpc_dial_counters_and_roles():
    from ray_tpu_torch.core.rpc import RpcClient, RpcServer

    before = _counter_total(_snapshot_agg(), "rpc_dials_total")
    srv = RpcServer({"ping": lambda: "pong"}, name="obs-d")
    cli = RpcClient(srv.addr, role="peer")
    cli.close()
    srv.stop()
    after_agg = _snapshot_agg()
    assert _counter_total(after_agg, "rpc_dials_total") >= before + 1


def test_metrics_disabled_skips_core_series(monkeypatch):
    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.core.rpc import RpcClient, RpcServer

    monkeypatch.setattr(config, "core_metrics_enabled", False)
    srv = RpcServer({"ping": lambda: "pong"}, name="obs-off")
    try:
        cli = RpcClient(srv.addr)
        cli.call("ping")
        snap = _Registry.get().snapshot()
        assert not any(m.get("tags", {}).get("server") == "obs-off"
                       for m in snap)
        cli.close()
    finally:
        srv.stop()


def test_pubsub_lag_and_delivery_instruments():
    from ray_tpu_torch.core.pubsub import Pubsub

    hub = Pubsub()
    chan = f"obs-{uuid.uuid4().hex[:6]}"
    for i in range(30):
        hub.publish(chan, "k", i)
    # A subscriber that never polled sees version 30 from 0: lag 30.
    for _ in range(3):
        assert hub.poll(chan, "k", 0, timeout=1.0)[0] == 30

    # Delivery latency: poller parks first, publish wakes it.
    got = []

    def parked():
        got.append(hub.poll(chan, "k", 30, timeout=5.0))

    t = threading.Thread(target=parked)
    t.start()
    time.sleep(0.1)
    hub.publish(chan, "k", "late")
    t.join(timeout=5.0)
    assert got and got[0][0] == 31

    agg = _snapshot_agg()
    lag = merge_histograms(agg, "psub_sub_lag")[(("channel", chan),)]
    assert lag["count"] >= 3
    assert lag["counts"][-1] + sum(
        n for e, n in zip(lag["buckets"], lag["counts"]) if e >= 25) >= 3
    deliver = merge_histograms(agg, "psub_deliver_s")[(("channel", chan),)]
    assert deliver["count"] >= 1
    assert _counter_total(agg, "psub_publishes_total") >= 31


def test_log_suppressed_counter():
    from ray_tpu_torch.util import ratelimit

    site = f"obs.site.{uuid.uuid4().hex[:6]}"
    logger = logging.getLogger(__name__)
    ratelimit.reset()
    assert ratelimit.log_every(site, 60.0, logger, "first")
    for _ in range(4):
        assert not ratelimit.log_every(site, 60.0, logger, "flood")
    totals = {tuple(sorted(m["tags"].items())): m["value"]
              for m in _Registry.get().snapshot()
              if m["name"] == "log_suppressed_total"}
    assert totals[(("site", site),)] == 4.0


def test_snapshot_bounded_by_max_series(monkeypatch):
    from ray_tpu_torch.core.config import config

    monkeypatch.setattr(config, "metrics_max_series", 5)
    snap = _Registry.get().snapshot()
    assert len(snap) <= 6  # 5 series + the overflow gauge
    dropped = [m for m in snap if m["name"] == "metrics_series_dropped"]
    assert dropped and dropped[0]["value"] > 0


def test_prometheus_text_splits_cluster_source_labels():
    text = prometheus_text({"ab12cd34/node/pid77": [
        {"name": "x_total", "kind": "counter", "tags": {}, "value": 3.0}]})
    assert 'node="ab12cd34"' in text
    assert 'role="node"' in text
    assert 'pid="77"' in text
    assert 'source="ab12cd34/node/pid77"' in text


# -------------------------------------------- cluster merge semantics


def _hist_entry(name, counts, tags=None, buckets=(0.1, 1.0)):
    counts = list(counts)
    return {"name": name, "kind": "histogram", "tags": dict(tags or {}),
            "buckets": list(buckets), "counts": counts,
            "sum": float(sum(counts)), "count": int(sum(counts))}


@pytest.fixture
def controller():
    from ray_tpu_torch.core.controller import Controller

    c = Controller()
    yield c
    c.stop()


def _push(c, node_bytes, role, pid, snapshot):
    c.push_metrics({"node_id": node_bytes, "role": role, "pid": pid},
                   snapshot)


def test_two_nodes_same_histogram_merge(controller):
    name = f"cm_{uuid.uuid4().hex[:6]}_s"
    _push(controller, b"A" * 16, "node", 1, [_hist_entry(name, [2, 1, 0])])
    _push(controller, b"B" * 16, "node", 2, [_hist_entry(name, [0, 3, 1])])
    agg = controller.list_metrics()
    merged = merge_histograms(agg, name)[()]
    assert merged["counts"] == [2, 4, 1]
    assert merged["count"] == 7


def test_same_source_repush_never_double_counts(controller):
    name = f"cm_{uuid.uuid4().hex[:6]}_total"
    counter = {"name": name, "kind": "counter", "tags": {}, "value": 50.0}
    _push(controller, b"A" * 16, "worker", 9, [counter])
    _push(controller, b"A" * 16, "worker", 9,
          [dict(counter, value=70.0)])  # cumulative re-push (restart-safe)
    assert _counter_total(controller.list_metrics(), name) == 70.0


def test_node_death_drops_its_series(controller):
    from ray_tpu_torch.core.ids import NodeID

    nid = NodeID.from_random()
    controller.register_node(nid.binary(), ("127.0.0.1", 1),
                             {"CPU": 1.0}, {})
    _push(controller, nid.binary(), "node", 3,
          [{"name": "cm_dead_total", "kind": "counter", "tags": {},
            "value": 5.0}])
    other = NodeID.from_random()
    _push(controller, other.binary(), "node", 4,
          [{"name": "cm_dead_total", "kind": "counter", "tags": {},
            "value": 2.0}])
    assert _counter_total(controller.list_metrics(), "cm_dead_total") == 7.0
    controller.unregister_node(nid.binary())
    agg = controller.list_metrics()
    assert _counter_total(agg, "cm_dead_total") == 2.0
    assert not any(k.startswith(nid.hex()[:8]) for k in agg)


def test_metrics_agent_survives_controller_restart():
    """The node-side pusher mirrors the metrics flusher's contract: a head
    restart costs retries, never the agent thread, and cumulative
    re-pushes land in the NEW controller without double-counting."""
    from ray_tpu_torch.core.controller import Controller
    from ray_tpu_torch.core.ids import NodeID
    from ray_tpu_torch.core.metrics_agent import MetricsAgent
    from ray_tpu_torch.core.rpc import ReconnectingClient

    nid = NodeID.from_random()
    c1 = Controller()
    host, port = c1.address
    client = ReconnectingClient((host, port), retry_window_s=2.0)
    agent = MetricsAgent(client, nid.binary(), period_s=0.05)
    try:
        key = f"{nid.hex()[:8]}/node/pid"
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            if any(k.startswith(key) for k in c1.list_metrics()):
                break
            time.sleep(0.05)
        assert any(k.startswith(key) for k in c1.list_metrics())
        c1.stop()
        time.sleep(0.3)  # agent pushes fail against the dead head
        assert agent._thread.is_alive()
        c2 = Controller(port=port)  # head restarts on the same address
        try:
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline:
                if any(k.startswith(key) for k in c2.list_metrics()):
                    break
                time.sleep(0.05)
            assert any(k.startswith(key) for k in c2.list_metrics())
            assert agent._thread.is_alive()
        finally:
            c2.stop()
    finally:
        agent.stop()
        client.close()


def test_single_pusher_arbitration():
    reg = _Registry.get()
    old = reg._pusher
    try:
        reg._pusher = None
        assert reg.claim_pusher("agent-1")
        assert not reg.claim_pusher("agent-2")
        assert reg.claim_pusher("agent-1")  # idempotent re-claim
        assert reg.claim_pusher("core")     # the flusher always wins
        # With no live runtime, a stale 'core' claim is reclaimable.
        assert reg.claim_pusher("agent-2")
        reg.release_pusher("agent-2")
        assert reg.claim_pusher("agent-1")
    finally:
        reg._pusher = old


def test_controller_prometheus_http_endpoint(monkeypatch):
    from ray_tpu_torch.core.config import config
    from ray_tpu_torch.core.controller import Controller

    monkeypatch.setattr(config, "controller_metrics_http_port", 0)
    c = Controller()
    try:
        _push(c, b"H" * 16, "node", 8,
              [{"name": "cm_http_total", "kind": "counter", "tags": {},
                "value": 4.0}])
        assert c.metrics_http_addr is not None
        host, port = c.metrics_http_addr
        text = urllib.request.urlopen(
            f"http://{host}:{port}/metrics", timeout=10.0).read().decode()
        assert 'cm_http_total' in text
        assert 'role="node"' in text
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://{host}:{port}/nope",
                                   timeout=10.0)
    finally:
        c.stop()


# ------------------------------------------ object plane + CLI (live)


@pytest.fixture(scope="module")
def ray_start_regular():
    import ray_tpu_torch

    core = ray_tpu_torch.init(num_cpus=4)
    yield core
    ray_tpu_torch.shutdown()


def test_object_plane_instruments_and_spans(ray_start_regular):
    import ray_tpu_torch as rt
    from ray_tpu_torch.core.runtime import get_core_worker
    from ray_tpu_torch.util import tracing

    core = get_core_worker()
    before = _snapshot_agg()
    with tracing.trace("obs-root"):
        ref = rt.put(np.zeros(256 * 1024, dtype=np.uint8))
        got = rt.get(ref)
    assert got.nbytes == 256 * 1024
    after = _snapshot_agg()
    delta = delta_aggregated(before, after)
    assert _counter_total(delta, "obj_put_bytes_total") >= 256 * 1024
    put_h = merge_histograms(delta, "obj_put_s")
    assert sum(e["count"] for e in put_h.values()) >= 1
    get_h = merge_histograms(delta, "obj_get_s")
    assert sum(e["count"] for e in get_h.values()) >= 1
    # Store gauges come from the core-worker collector.
    names = {m["name"] for m in after["n1/node/pid1"]}
    assert {"obj_store_entries", "obj_store_bytes",
            "obj_live_refs"} <= names

    # The spans land in the task-event buffer -> timeline.
    core._flush_task_events()
    events = core.controller.call("list_task_events", 10000)
    descs = {e.get("desc") for e in events if e.get("state") == "SPAN"}
    assert "object:put" in descs
    assert "object:get" in descs
    from ray_tpu_torch.scripts import build_chrome_trace

    trace = build_chrome_trace(events)
    span_names = {t["name"] for t in trace if t.get("cat") == "span"}
    assert {"object:put", "object:get"} <= span_names
    del ref, got


def test_metrics_and_doctor_cli(ray_start_regular, capsys):
    from ray_tpu_torch.core.runtime import get_core_worker
    from ray_tpu_torch.scripts import main
    from ray_tpu_torch.util.metrics import _Registry

    core = get_core_worker()
    assert _Registry.get().flush_now()
    host, port = core.controller_addr
    addr = f"{host}:{port}"
    assert main(["--address", addr, "metrics"]) == 0
    out = capsys.readouterr().out
    assert "[rpc]" in out and "[objects]" in out and "[control]" in out
    assert "tx_frames" in out
    assert main(["--address", addr, "metrics", "--raw"]) == 0
    assert "rpc_tx_frames_total" in capsys.readouterr().out
    assert main(["--address", addr, "doctor", "--interval", "0.2"]) == 0
    out = capsys.readouterr().out
    assert ("no failure signatures" in out) or ("finding(s)" in out)
    assert main(["--address", addr, "doctor", "--interval", "0.1",
                 "--json"]) == 0
    json.loads(capsys.readouterr().out)


# --------------------------------------- metrics-label-cardinality lint


def test_cardinality_lint_flags_id_shaped_labels():
    project = lint_project(a="""
        from ray_tpu_torch.util.metrics import Counter, Histogram
        C = Counter("card_total")
        H = Histogram("card_s")
        def handle(req, oid):
            C.inc(1.0, {"request": req.request_id})
            H.observe(0.1, tags={"object": oid.hex()})
            C.set_default_tags({"trace": req.trace_id})
        """)
    findings = run_metrics_lint(project)
    assert len(findings) == 3
    assert all(f.rule == "metrics-label-cardinality" for f in findings)
    msgs = " | ".join(f.message for f in findings)
    assert "request_id" in msgs and "hex()" in msgs


def test_cardinality_lint_true_negatives_and_pragma():
    project = lint_project(b="""
        from ray_tpu_torch.util.metrics import Counter, Gauge
        C = Counter("card_tn_total")
        G = Gauge("card_tn_gauge")
        def record(self, status, plane_key, name):
            C.inc(1.0, {"outcome": status, "deployment": name})
            G.set(2.0, {"plane": plane_key})
            G.set(1.0)                      # no tags at all
            x = [].set(1, {"k": name})      # bounded value: fine
            # graftlint: disable=metrics-label-cardinality
            C.inc(1.0, {"node": self.node_id.hex()})
        """)
    assert run_metrics_lint(project) == []


def test_cardinality_lint_repo_is_clean():
    findings = port_findings("metrics-label-cardinality")
    assert findings == [], [f.render() for f in findings]


# ------------------------------------- flight-recorder event lint


def test_flightrec_lint_flags_schema_collision():
    """One event name, one attr-key schema: the post-mortem merges by
    name, so a second site recording 'gang.form' with different keys
    silently breaks every grouping — family #10's name-collision
    check, applied to the event catalog."""
    project = lint_project(fr_a="""
        from ray_tpu_torch.util import flightrec
        def one(group, epoch):
            flightrec.record("fr.formed", group=group, epoch=epoch)
        def two(group):
            flightrec.record("fr.formed", group=group, hosts=2)
        """)
    findings = run_metrics_lint(project)
    assert len(findings) == 1
    assert findings[0].rule == "metrics-name-collision"
    assert "one event name, one schema" in findings[0].message
    assert "fr.formed" in findings[0].message


def test_flightrec_lint_flags_id_shaped_attr_values():
    """Id-shaped attr VALUES flagged exactly like metric labels — and
    the bounded schedule ints ({step, mb, stage, epoch}) are exempt
    even through the same expressions; direct-import spelling and a
    foreign record() are resolved correctly."""
    project = lint_project(fr_b="""
        from ray_tpu_torch.util.flightrec import record
        def bad(req, step):
            record("fr.req", owner=req.request_id, step=step)
        def exempt(self, mb, stage):
            record("fr.cell", step=self._step, mb=mb, stage=stage)
        def foreign(recorder, req):
            recorder.record("fr.other", owner=req.request_id)
        """)
    findings = run_metrics_lint(project)
    assert len(findings) == 1
    assert findings[0].rule == "metrics-label-cardinality"
    assert "flight-recorder event" in findings[0].message
    assert "request_id" in findings[0].message


def test_flightrec_lint_true_negatives_and_pragma():
    project = lint_project(fr_c="""
        from ray_tpu_torch.util import flightrec
        def ok(self, reason, member):
            flightrec.record("fr.ok", cause=reason, member=member)
            flightrec.record("fr.ok2", site="literal")
            # graftlint: disable=metrics-label-cardinality
            flightrec.record("fr.death", actor=self.actor_id.hex())
        """)
    assert run_metrics_lint(project) == []


def test_flightrec_collision_lint_repo_is_clean():
    findings = port_findings("metrics-name-collision")
    assert findings == [], [f.render() for f in findings]
