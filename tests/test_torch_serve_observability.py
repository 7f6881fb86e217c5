"""Serve-plane observability on the port (``ray_tpu_torch``): the 16 cases
of ``tests/test_serve_observability.py`` under the same names and
settings: SLO instruments and aggregation, the metrics flusher across a
controller's death, the port's engine instruments, request spans and step
timeline, trace context across a router retry, the proxy's ``/metrics``
route and ``serve.status()`` SLO summaries, graftlint's
metrics-name-collision rule (over fixture modules written against the port
and over the whole ``ray_tpu_torch`` package, ``tests/torch_lint.py``), and
the timeline CLI's Chrome trace (read by the JAX package's
``trace_demo.validate_trace``, a pure function the port has not carried).
The engine cases run the tiny CPU config with the JAX package's weights
carried in (``torch_parity.tiny_pair``); the cluster cases share one
module-scoped ``init(num_cpus=4)``."""

import json
import threading
import time
import urllib.request
import uuid

import numpy as np
import pytest

from ray_tpu_torch.util.metrics import (Counter, Histogram, _Registry,
                                        counter_totals, histogram_quantile,
                                        histogram_summary, merge_histograms,
                                        prometheus_text)
from torch_lint import lint_project, run_metrics_lint, port_findings
from torch_parity import one_torch_thread, tiny_pair  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _tiny(max_seq_len=256):
    _jcfg, _jp, cfg, params = tiny_pair(max_seq_len=max_seq_len)
    return cfg, params


@pytest.fixture(scope="module")
def ray_start_regular():
    import ray_tpu_torch

    core = ray_tpu_torch.init(num_cpus=4)
    yield core
    ray_tpu_torch.shutdown()


def _drive(eng, reqs, budget=400):
    for _ in range(budget):
        if all(r.done.is_set() for r in reqs):
            return
        eng.step()
    raise AssertionError(f"not done: {[r.status for r in reqs]}")


def _snap(name, deployment):
    """This process's registry entries for one metric + deployment."""
    return [m for m in _Registry.get().snapshot()
            if m["name"] == name
            and m["tags"].get("deployment") == deployment]


# ------------------------------------------------------ registry units


def test_observe_many_matches_repeated_observe():
    dep_a, dep_b = f"a-{uuid.uuid4().hex[:6]}", f"b-{uuid.uuid4().hex[:6]}"
    h = Histogram("obs_many_test_s", boundaries=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 5.0, 50.0):
        h.observe(v, {"deployment": dep_a})
    h.observe_many((0.05, 0.5, 5.0, 50.0), {"deployment": dep_b})
    a = _snap("obs_many_test_s", dep_a)[0]
    b = _snap("obs_many_test_s", dep_b)[0]
    assert a["counts"] == b["counts"] == [1, 1, 1, 1]
    assert a["sum"] == b["sum"] and a["count"] == b["count"] == 4


def test_prometheus_text_emits_cumulative_bucket_ladder():
    dep = f"p-{uuid.uuid4().hex[:6]}"
    h = Histogram("prom_bucket_test_s", boundaries=(0.1, 1.0))
    h.observe_many((0.05, 0.5, 5.0), {"deployment": dep})
    text = prometheus_text({"src": _snap("prom_bucket_test_s", dep)})
    lines = [ln for ln in text.splitlines() if dep in ln]
    assert any('le="0.1"} 1' in ln for ln in lines), lines
    assert any('le="1.0"} 2' in ln for ln in lines), lines
    assert any('le="+Inf"} 3' in ln for ln in lines), lines
    assert any(ln.startswith("prom_bucket_test_s_sum") for ln in lines)
    assert any(ln.startswith("prom_bucket_test_s_count")
               and ln.endswith(" 3") for ln in lines)


def test_histogram_quantile_interpolates_and_clamps():
    entry = {"buckets": [0.1, 1.0, 10.0], "counts": [0, 10, 0, 2],
             "sum": 7.0, "count": 12}
    # p50 -> rank 6 of the 10 obs spread across (0.1, 1.0].
    q50 = histogram_quantile(entry, 0.5)
    assert 0.1 < q50 <= 1.0
    # p99 lands in the +Inf bucket: clamps to the top finite edge.
    assert histogram_quantile(entry, 0.99) == 10.0
    assert histogram_quantile({"buckets": [1], "counts": [0, 0],
                               "sum": 0, "count": 0}, 0.5) is None
    s = histogram_summary(entry)
    assert s["count"] == 12 and s["p50"] == q50


def test_merge_histograms_across_sources_and_slo_summary():
    from ray_tpu_torch.serve.metrics import slo_summary

    dep = f"m-{uuid.uuid4().hex[:6]}"
    entry = {"name": "serve_ttft_s", "kind": "histogram",
             "tags": {"deployment": dep}, "buckets": [0.1, 1.0],
             "counts": [1, 1, 0], "sum": 0.6, "count": 2}
    other = dict(entry, counts=[0, 0, 1], sum=5.0, count=1)
    agg = {"w1": [entry], "w2": [other],
           "w3": [{"name": "serve_requests_total", "kind": "counter",
                   "tags": {"deployment": dep, "outcome": "completed"},
                   "value": 2.0},
                  {"name": "serve_requests_total", "kind": "counter",
                   "tags": {"deployment": dep, "outcome": "shed"},
                   "value": 1.0}]}
    merged = merge_histograms(agg, "serve_ttft_s")
    key = (("deployment", dep),)
    assert merged[key]["count"] == 3
    assert merged[key]["counts"] == [1, 1, 1]
    totals = counter_totals(agg, "serve_requests_total")
    assert totals[(("deployment", dep), ("outcome", "completed"))] == 2.0
    slo = slo_summary(agg)
    assert slo[dep]["ttft_s"]["count"] == 3
    assert slo[dep]["outcomes"] == {"completed": 2, "shed": 1}


# ------------------------------------------- flusher fault tolerance


class _StubController:
    """Controller double: notify() fails while .dead, else stores the
    latest snapshot per source (exactly the real push_metrics shape)."""

    def __init__(self):
        self.dead = True
        self.pushes = 0
        self.latest = None
        self.lock = threading.Lock()

    def notify(self, method, source, snapshot):
        assert method == "push_metrics"
        with self.lock:
            if self.dead:
                raise ConnectionError("controller down")
            self.pushes += 1
            self.latest = snapshot


class _StubCore:
    class _Id:
        def binary(self):
            return b"x" * 8

    def __init__(self):
        self.controller = _StubController()
        self.node_id = self._Id()
        self.worker_id = self._Id()


def test_metrics_flusher_survives_controller_death(monkeypatch):
    """The flusher thread must outlive a dead/restarting controller,
    and because pushes are CUMULATIVE snapshots, a reconnect must not
    double-count anything recorded during the outage."""
    from ray_tpu_torch.core import runtime
    from ray_tpu_torch.core.config import config as rt_config

    stub = _StubCore()
    monkeypatch.setattr(runtime, "_core_worker", stub)
    monkeypatch.setattr(rt_config, "metrics_flush_interval_s", 0.05)

    dep = f"f-{uuid.uuid4().hex[:6]}"
    c = Counter("flush_ft_test_total")
    c.inc(3.0, {"deployment": dep})  # starts/kicks the flusher
    reg = _Registry.get()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:  # let it FAIL a few times
        if reg._flusher is not None:
            time.sleep(0.3)
            break
        time.sleep(0.01)
    assert reg._flusher is not None and reg._flusher.is_alive()

    c.inc(2.0, {"deployment": dep})  # recorded DURING the outage
    with stub.controller.lock:
        stub.controller.dead = False  # controller "restarts"
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        with stub.controller.lock:
            if stub.controller.pushes >= 2:
                break
        time.sleep(0.05)
    with stub.controller.lock:
        assert stub.controller.pushes >= 1, "no push after reconnect"
        mine = [m for m in stub.controller.latest
                if m["name"] == "flush_ft_test_total"
                and m["tags"].get("deployment") == dep]
    # 3 + 2 exactly once — the snapshot supersedes, never adds.
    assert mine and mine[0]["value"] == 5.0
    assert reg._flusher.is_alive()
    assert reg.flush_now()  # synchronous path works against the stub
    monkeypatch.setattr(rt_config, "metrics_flush_interval_s", 5.0)


# ------------------------------------------------- engine instruments


def test_engine_terminal_metrics_and_queue_wait():
    from ray_tpu_torch.serve.decode import DecodeEngine

    cfg, params = _tiny()
    dep = f"eng-{uuid.uuid4().hex[:6]}"
    eng = DecodeEngine(params, cfg, slots=2, capacity=128,
                       prefix_pool_entries=0, device="cpu", queue_max=3,
                       metrics_deployment=dep)
    done = [eng.submit([1, 2, 3], max_new_tokens=4) for _ in range(2)]
    _drive(eng, done)
    # Cancelled-in-queue and shed outcomes (no steps between submits,
    # so everything stays pending until the drain below).
    eng.submit([1] * 4, max_new_tokens=8)
    eng.submit([2] * 4, max_new_tokens=8)
    victim = eng.submit([3] * 4, max_new_tokens=4, deadline_s=30.0)
    eng.cancel(victim.request_id)
    from ray_tpu_torch.core.errors import OverloadedError

    with pytest.raises(OverloadedError):
        for _ in range(8):
            eng.submit([4] * 4, max_new_tokens=4)
    for _ in range(200):
        eng.step()
    totals = counter_totals({"local": _Registry.get().snapshot()},
                            "serve_requests_total")

    def outcome(o):
        return totals.get((("deployment", dep), ("outcome", o)), 0)

    assert outcome("completed") >= 2
    assert outcome("cancelled") >= 1
    assert outcome("shed") >= 1
    ttft = _snap("serve_ttft_s", dep)[0]
    assert ttft["count"] >= 2
    itl = _snap("serve_inter_token_s", dep)[0]
    assert itl["count"] >= 2
    qw = _snap("serve_queue_wait_s", dep)[0]
    assert qw["count"] >= 2
    eng.shutdown()


def test_engine_spans_attach_to_request_trace(ray_start_regular):
    """Spans recorded by the engine's LOOP thread land under the trace
    captured at submit(): queue-wait, prefill, decode, and the
    engine-request outcome span all share the submitting trace."""
    from ray_tpu_torch.serve.decode import DecodeEngine
    from ray_tpu_torch.util import tracing

    core = ray_start_regular
    cfg, params = _tiny()
    eng = DecodeEngine(params, cfg, slots=2, capacity=128,
                       prefix_pool_entries=0, device="cpu")
    with tracing.trace("submit-root") as (trace_id, _):
        req = eng.submit([1, 2, 3, 4], max_new_tokens=4)
    _drive(eng, [req])
    eng.shutdown()
    deadline = time.monotonic() + 30
    names = set()
    while time.monotonic() < deadline:
        core._flush_task_events()
        events = core.controller.call("list_task_events", 10000)
        names = {e["desc"] for e in events
                 if e.get("state") == "SPAN"
                 and e.get("trace_id") == trace_id}
        if {"queue-wait", "prefill", "decode",
                "engine-request"} <= names:
            break
        time.sleep(0.2)
    assert {"queue-wait", "prefill", "decode",
            "engine-request"} <= names, names
    outcome = [e for e in events if e.get("state") == "SPAN"
               and e.get("trace_id") == trace_id
               and e["desc"] == "engine-request"]
    assert outcome[0]["attrs"]["outcome"] == "completed"
    assert outcome[0]["attrs"]["tokens"] == 4


# ----------------------------------------------------- step timeline


def test_step_timeline_ring_bounded_with_phases_and_compiles():
    from ray_tpu_torch.serve.decode import DecodeEngine

    cfg, params = _tiny()
    eng = DecodeEngine(params, cfg, slots=2, capacity=128,
                       prefix_pool_entries=0, device="cpu",
                       step_timeline=8)
    reqs = [eng.submit([1, 2, 3], max_new_tokens=32) for _ in range(2)]
    _drive(eng, reqs, budget=200)
    tl = eng.timeline()
    assert len(tl["rows"]) <= 8
    assert tl["dropped"] > 0  # 32+ steps through an 8-row ring
    phases = {p["phase"] for row in tl["rows"] for p in row["phases"]}
    assert "decode" in phases
    row = tl["rows"][-1]
    assert {"step", "t0", "t1", "active", "prefilling",
            "queued"} <= set(row)
    eng.shutdown()
    # jit-compile events fired for first dispatches (admit ran inside
    # the ring window on the first steps — check the engine saw them).
    assert ("decode",) in eng._compiled


def test_step_timeline_disabled_is_free():
    from ray_tpu_torch.serve.decode import DecodeEngine

    cfg, params = _tiny()
    eng = DecodeEngine(params, cfg, slots=1, capacity=128,
                       prefix_pool_entries=0, device="cpu",
                       step_timeline=0,
                       metrics_enabled=False, trace_spans=False)
    req = eng.submit([1, 2, 3], max_new_tokens=4)
    _drive(eng, [req])
    assert eng.timeline()["rows"] == []
    assert not eng.steplog.enabled
    eng.shutdown()


def test_paged_timeline_records_page_events_and_preempt_counter():
    from ray_tpu_torch.serve.decode import DecodeEngine

    cfg, params = _tiny(max_seq_len=512)
    dep = f"pre-{uuid.uuid4().hex[:6]}"
    rng = np.random.default_rng(7)
    eng = DecodeEngine(params, cfg, slots=4, capacity=256,
                       page_tokens=16, pool_pages=20,
                       prefix_pool_entries=0, device="cpu",
                       step_timeline=4096,
                       metrics_deployment=dep)
    prompts = [rng.integers(0, cfg.vocab_size, 30).tolist()
               for _ in range(4)]
    reqs = [eng.submit(p, max_new_tokens=90) for p in prompts]
    _drive(eng, reqs, budget=3000)
    assert eng.preempted > 0
    kinds = {e["kind"] for row in eng.timeline()["rows"]
             for e in row.get("events", [])}
    assert {"page-alloc", "page-free", "preempt"} <= kinds, kinds
    totals = counter_totals({"local": _Registry.get().snapshot()},
                            "serve_preemptions_total")
    assert totals.get((("deployment", dep),), 0) == eng.preempted
    rows = eng.timeline()["rows"]
    assert any(r.get("pages_free") is not None for r in rows)
    from ray_tpu_torch.serve.steplog import timeline_chrome_events

    ev = timeline_chrome_events(eng.timeline(), pid="engine:t")
    assert any(e["ph"] == "i" and e["name"] == "preempt" for e in ev)
    eng.shutdown()


# ------------------------------------------------ router retry traces


def test_trace_context_survives_router_retry(ray_start_regular):
    """A replica death mid-request retries onto a survivor; both
    attempt spans parent under the SAME router span (one request, one
    trace), tagged with their attempt ordinal and replica."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.deployment import _Router
    from ray_tpu_torch.util import tracing

    core = ray_start_regular

    @serve.deployment(num_replicas=2)
    class Echo:
        def __call__(self, x):
            return x

    handle = serve.run(Echo.bind(), name="retry_trace")
    try:
        router = _Router.get("retry_trace")
        with router._lock:
            assert len(router._replicas) == 2
            dead = router._replicas[0]
        rt.kill(dead["handle"])
        time.sleep(0.5)  # let the kill land (calls now ActorDied)

        orig_pick = router._pick
        picked = {"n": 0}

        def pick_dead_first(model_id, prefix_hashes=None):
            picked["n"] += 1
            if picked["n"] == 1:
                with router._lock:
                    router._inflight[dead["id"]] = (
                        router._inflight.get(dead["id"], 0) + 1)
                return dead
            return orig_pick(model_id, prefix_hashes)

        router._pick = pick_dead_first
        try:
            with tracing.trace("retry-root") as (trace_id, _):
                assert handle.remote(7).result(timeout=60) == 7
        finally:
            router._pick = orig_pick
        assert picked["n"] >= 2, "retry never happened"

        deadline = time.monotonic() + 30
        attempts, router_spans = [], []
        while time.monotonic() < deadline:
            core._flush_task_events()
            events = core.controller.call("list_task_events", 10000)
            spans = [e for e in events if e.get("state") == "SPAN"
                     and e.get("trace_id") == trace_id]
            attempts = sorted(
                (e for e in spans if e["desc"] == "attempt"),
                key=lambda e: e["attrs"]["attempt"])
            router_spans = [e for e in spans
                            if e["desc"] == "router:retry_trace"]
            if len(attempts) >= 2 and router_spans:
                break
            time.sleep(0.2)
        assert len(attempts) >= 2, "expected a retried attempt span"
        assert router_spans, "no router span"
        parent = router_spans[0]["span_id"]
        assert all(a["parent_span"] == parent for a in attempts[:2])
        assert attempts[0]["attrs"]["attempt"] == 0
        assert attempts[1]["attrs"]["attempt"] == 1
        assert (attempts[0]["attrs"]["replica"]
                != attempts[1]["attrs"]["replica"])
    finally:
        serve.delete("retry_trace")


# ------------------------------- proxy /metrics + status slo (e2e)


def test_proxy_metrics_route_and_status_slo(ray_start_regular):
    """One decode deployment behind the real HTTP proxy: /metrics
    serves Prometheus text with per-deployment TTFT and inter-token
    bucket ladders, and serve.status() carries the same numbers as
    slo summaries (one aggregation path)."""
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.decode import LlamaDecodeDeployment

    app = serve.deployment(LlamaDecodeDeployment).bind(
        preset="debug", slots=2, capacity=128, device="cpu")
    serve.run(app, name="slo_app")
    try:
        host, port = serve.start_http()
        url = f"http://{host}:{port}/slo_app"
        for i in range(2):
            req = urllib.request.Request(
                url, data=json.dumps({"tokens": [1, 2, 3 + i],
                                      "max_new_tokens": 4}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as resp:
                out = json.loads(resp.read())
                assert len(out["tokens"]) == 4

        # Replica + proxy flushers push every ~5 s; poll the route.
        def _dep_lines(text, metric):
            return [ln for ln in text.splitlines()
                    if ln.startswith(metric)
                    and 'deployment="slo_app"' in ln]

        deadline = time.monotonic() + 30
        text = ""
        while time.monotonic() < deadline:
            with urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                        timeout=30) as resp:
                assert resp.status == 200
                text = resp.read().decode()
            if (_dep_lines(text, "serve_ttft_s_bucket")
                    and _dep_lines(text, "serve_inter_token_s_bucket")
                    and _dep_lines(text, "serve_http_requests_total")):
                break
            time.sleep(0.5)
        # Per-DEPLOYMENT TTFT and inter-token bucket ladders: the
        # engine inside the replica labeled its observations with the
        # deployment it serves (replica identity threaded at spawn).
        assert _dep_lines(text, "serve_ttft_s_bucket"), text[:2000]
        assert _dep_lines(text, "serve_inter_token_s_bucket")
        assert any('le="+Inf"' in ln
                   for ln in _dep_lines(text, "serve_ttft_s_bucket"))
        assert _dep_lines(text, "serve_queue_wait_s_count")

        # The replica's and the proxy's flushers push on their own ~5 s
        # clocks: wait for both counters, not only the replica's.
        deadline = time.monotonic() + 15
        slo = {}
        while time.monotonic() < deadline:
            slo = serve.status()["slo_app"].get("slo", {})
            if (slo.get("ttft_s", {}).get("count", 0) >= 2
                    and slo.get("http_responses", {}).get("200", 0) >= 2):
                break
            time.sleep(0.5)
        assert slo["ttft_s"]["count"] >= 2
        assert slo["ttft_s"]["p50"] is not None
        assert slo["inter_token_s"]["count"] >= 2
        assert slo["outcomes"].get("completed", 0) >= 2
        assert slo["http_responses"].get("200", 0) >= 2

        # Dashboard agreement: same aggregation helper, same numbers.
        from ray_tpu_torch.core.runtime import get_core_worker
        from ray_tpu_torch.serve.metrics import slo_summary

        agg = get_core_worker().controller.call("list_metrics")
        assert (slo_summary(agg)["slo_app"]["ttft_s"]["count"]
                >= slo["ttft_s"]["count"] - 1)
    finally:
        serve.shutdown()


# --------------------------------------------- metrics-name-collision


def test_metrics_lint_flags_kind_and_bucket_collisions():
    project = lint_project(
        a="""
        from ray_tpu_torch.util.metrics import Counter, Histogram
        REQS = Counter("svc_requests_total")
        LAT = Histogram("svc_latency_s", "d", boundaries=(0.1, 1.0))
        """,
        b="""
        from ray_tpu_torch.util import metrics
        BAD_KIND = metrics.Gauge("svc_requests_total")
        BAD_GRID = metrics.Histogram("svc_latency_s", "d",
                                     boundaries=(0.5, 5.0))
        """)
    findings = run_metrics_lint(project)
    assert len(findings) == 2
    msgs = " | ".join(f.message for f in findings)
    assert "one name, one kind" in msgs
    assert "bucket boundaries" in msgs
    assert all(f.path == "ray_tpu_torch/b.py" for f in findings)


def test_metrics_lint_true_negatives():
    project = lint_project(
        a="""
        from ray_tpu_torch.util.metrics import Counter, Histogram
        GRID = (0.1, 1.0)
        A = Counter("tn_total")
        H1 = Histogram("tn_lat_s", "d", boundaries=GRID)
        """,
        b="""
        from collections import Counter  # NOT the metrics class
        from ray_tpu_torch.util.metrics import Counter as MCounter, Histogram
        c = Counter("tn_total some text".split())  # stdlib: ignored
        B = MCounter("tn_total")                   # same kind: fine
        H2 = Histogram("tn_lat_s", "d", boundaries=GRID)  # same grid
        """)
    assert run_metrics_lint(project) == []


def test_metrics_lint_repo_is_clean():
    findings = port_findings("metrics-name-collision")
    assert findings == [], [f.render() for f in findings]


# ----------------------------------------------- timeline CLI builder


def test_build_chrome_trace_links_and_engine_merge():
    from ray_tpu_torch.scripts import build_chrome_trace

    t0 = 1000.0
    events = [
        {"task_id": "s1", "desc": "parent", "state": "SPAN",
         "trace_id": "t", "span_id": "s1", "parent_span": None,
         "lease_ts": t0, "end_ts": t0 + 1, "owner": "procA",
         "worker": "wa"},
        {"task_id": "s2", "desc": "child", "state": "SPAN",
         "trace_id": "t", "span_id": "s2", "parent_span": "s1",
         "lease_ts": t0 + 0.1, "end_ts": t0 + 0.9, "owner": "procB",
         "worker": "wb", "attrs": {"attempt": 0}},
        {"task_id": "x", "desc": "task", "state": "FINISHED",
         "lease_ts": t0, "end_ts": t0 + 0.5, "owner": "procB",
         "worker": "wb"},
    ]
    timelines = {"dep": {"dep#0": {"rows": [
        {"step": 1, "t0": t0, "t1": t0 + 0.01,
         "phases": [{"phase": "decode", "t0": t0, "t1": t0 + 0.01,
                     "batch": 2, "k": 1}],
         "active": 2, "prefilling": 0, "queued": 0,
         "events": [{"kind": "page-alloc", "ts": t0, "n": 1}]},
    ]}}}
    trace = build_chrome_trace(events, timelines)
    txt = json.dumps(trace)  # must be JSON-serializable
    assert json.loads(txt)
    spans = [t for t in trace if t.get("cat") == "span"]
    assert {s["args"]["span_id"] for s in spans} == {"s1", "s2"}
    child = next(s for s in spans if s["args"]["span_id"] == "s2")
    assert child["args"]["parent_span"] == "s1"
    assert child["args"]["attempt"] == 0
    flows = [t for t in trace if t.get("cat") == "flow"]
    assert {f["ph"] for f in flows} == {"s", "f"}
    engine = [t for t in trace if t.get("cat") == "engine-step"]
    assert engine and engine[0]["pid"] == "engine:dep#0"
    assert any(t.get("ph") == "M" for t in trace)  # process_name meta
    from ray_tpu.serve.trace_demo import validate_trace

    report = validate_trace(trace)
    assert report["cross_process_links"] == [("parent", "child")]
    assert report["engine_slices"] == 1
