"""The port's metrics: ``ray_tpu_torch.util.metrics`` and
``ray_tpu_torch.serve.metrics`` against ``ray_tpu.util.metrics`` and
``ray_tpu.serve.metrics`` on the same observation sequences (snapshots,
Prometheus text, quantiles, summaries, the series cap and collectors must
be equal), and the SLO metrics the port's engine observes against the JAX
package's engine on the same request mix: outcome counts, TTFT,
inter-token and queue-wait observation counts, preemptions and the
speculative totals.

Each test runs on fresh registries of both packages (the process-global
ones swapped out and restored), so other test modules in the worker
cannot change what it reads. Values compare exactly: both registries do
the same float arithmetic on the same inputs. The engines' observed
latencies are host clock readings and differ between engines, so only
their counts compare."""

import logging
import time

import numpy as np
import pytest

from ray_tpu.core import errors as jerrors
from ray_tpu.core.config import config as jconfig
from ray_tpu.serve import metrics as jsm
from ray_tpu.serve.decode import DecodeEngine as JaxEngine
from ray_tpu.util import metrics as jm
from ray_tpu_torch.core.config import config as tconfig
from ray_tpu_torch.core import errors as terrors
from ray_tpu_torch.serve import metrics as tsm
from ray_tpu_torch.serve.decode import DecodeEngine
from ray_tpu_torch.util import metrics as tm
from ray_tpu_torch.util import ratelimit
from torch_parity import one_torch_thread, tiny_pair  # noqa: F401

VOCAB = 61
pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture
def registries(monkeypatch):
    """Fresh process registries of both packages for one test."""
    monkeypatch.setattr(jm._Registry, "_instance", jm._Registry())
    monkeypatch.setattr(tm._Registry, "_instance", tm._Registry())


@pytest.fixture
def max_series():
    """Set ``metrics_max_series`` on both packages; restored after."""
    old = (jconfig.metrics_max_series, tconfig.metrics_max_series)

    def set_(n):
        jconfig.update({"metrics_max_series": n})
        tconfig.update({"metrics_max_series": n})

    yield set_
    jconfig.update({"metrics_max_series": old[0]})
    tconfig.update({"metrics_max_series": old[1]})


def _observe(mod):
    """One fixed observation sequence through ``mod``'s instruments:
    counters with and without tags, a gauge set twice, histograms on the
    default and on custom boundaries, values on bucket edges, past the
    last edge and in bulk, and default tags."""
    c = mod.Counter("t_requests", "d", tag_keys=("dep", "outcome"))
    for i in range(5):
        c.inc(1.0, {"dep": "a", "outcome": "ok" if i % 2 else "shed"})
    c.inc(2.5, {"dep": "b", "outcome": "ok"})
    mod.Counter("t_plain").inc()
    g = mod.Gauge("t_level", tag_keys=("dep",))
    g.set(3.0, {"dep": "a"})
    g.set(7.5, {"dep": "a"})
    h = mod.Histogram("t_latency", boundaries=(0.01, 0.1, 1.0),
                      tag_keys=("dep",))
    for v in (0.005, 0.01, 0.05, 0.1, 0.7, 1.0, 3.0, 0.0):
        h.observe(v, {"dep": "a"})
    h.observe_many([0.02, 0.2, 2.0, 0.001], {"dep": "b"})
    h.observe_many([], {"dep": "c"})  # no series for an empty batch
    mod.Histogram("t_default").observe_many([0.0007, 0.3, 7.0, 100.0])
    d = mod.Counter("t_defaults", tag_keys=("dep", "zone"))
    d.set_default_tags({"zone": "z1"})
    d.inc(4.0, {"dep": "a"})
    d.inc(1.0, {"dep": "a", "zone": "z2"})
    return mod._Registry.get().snapshot()


def test_registry_snapshot_and_text_match_jax(registries):
    j, t = _observe(jm), _observe(tm)
    assert t == j
    for source in ("local", "abcd1234/worker/pid42"):
        assert tm.prometheus_text({source: t}) == \
            jm.prometheus_text({source: j})
    names = {e["name"] for e in t}
    assert "t_latency" in names and len(t) == 10


def test_aggregation_helpers_match_jax(registries):
    j, t = _observe(jm), _observe(tm)
    jagg = {"n1/worker/pid1": j, "n2/head/pid2": j}
    tagg = {"n1/worker/pid1": t, "n2/head/pid2": t}
    for name in ("t_latency", "t_default"):
        jh, th = (jm.merge_histograms(jagg, name),
                  tm.merge_histograms(tagg, name))
        assert th == jh
        for key in th:
            for q in (0.0, 0.1, 0.25, 0.5, 0.9, 0.99, 1.0):
                assert tm.histogram_quantile(th[key], q) == \
                    jm.histogram_quantile(jh[key], q), (name, key, q)
            assert tm.histogram_summary(th[key]) == \
                jm.histogram_summary(jh[key])
    empty = {"buckets": [1.0], "counts": [0, 0], "count": 0, "sum": 0.0}
    assert tm.histogram_quantile(empty, 0.5) is None
    assert tm.histogram_summary(empty) == jm.histogram_summary(empty)
    for name in ("t_requests", "t_plain", "t_defaults"):
        assert tm.counter_totals(tagg, name) == jm.counter_totals(jagg, name)
    assert tm.gauge_totals(tagg, "t_level") == jm.gauge_totals(jagg, "t_level")
    later = {"n1/worker/pid1": _observe(tm)}
    jlater = {"n1/worker/pid1": _observe(jm)}
    assert tm.delta_aggregated(tagg, later) == \
        jm.delta_aggregated(jagg, jlater)
    assert tm.delta_aggregated({}, later) == jm.delta_aggregated({}, jlater)


@pytest.mark.parametrize("cap", [0, 3, 10])
def test_series_cap_matches_jax(registries, max_series, cap):
    """Past ``metrics_max_series`` the snapshot keeps the first series in
    insertion order and reports the rest in ``metrics_series_dropped``
    (0 = no cap)."""
    max_series(cap)
    j, t = _observe(jm), _observe(tm)
    assert t == j
    dropped = [e for e in t if e["name"] == "metrics_series_dropped"]
    if cap and cap < 10:
        assert len(t) == cap + 1 and dropped[0]["value"] == 10 - cap
    else:
        assert not dropped


class _Owner:
    def __init__(self, mod):
        self.gauge = mod.Gauge("t_owned")
        self.n = 0

    def collect(self):
        self.n += 1
        self.gauge.set(float(self.n))


def _collect(mod):
    owner = _Owner(mod)
    deltas = mod.CounterDeltas()
    bytes_total = mod.Counter("t_bytes", tag_keys=("conn",))
    totals = iter([10.0, 25.0, 5.0, 12.0])  # 5.0: the owner restarted

    def publish():
        deltas.inc_to(bytes_total, "c1", next(totals), {"conn": "c1"})

    def broken():
        raise RuntimeError("collector failed")

    mod.add_collector(owner.collect)
    mod.add_collector(publish)
    mod.add_collector(broken)
    snaps = [mod._Registry.get().snapshot() for _ in range(3)]
    del owner  # held weakly: its collector is pruned at the next snapshot
    snaps.append(mod._Registry.get().snapshot())
    return snaps, len(mod._Registry.get()._collectors)


def test_collectors_match_jax(registries, caplog):
    """Snapshot-time collectors: a bound method held weakly (pruned once
    its owner is gone), counter deltas that re-base when a total goes
    backwards, and a failing collector that is logged, rate-limited, and
    never breaks the snapshot."""
    from ray_tpu.util import ratelimit as jratelimit

    jratelimit.reset()
    ratelimit.reset()
    with caplog.at_level(logging.WARNING):
        j = _collect(jm)
        t = _collect(tm)
    # log_every counts the suppressed repeats of the broken collector in
    # each package's own registry, so those series are equal too.
    assert t == j
    snaps, collectors = t
    assert collectors == 2
    owned = [e["value"] for s in snaps for e in s if e["name"] == "t_owned"]
    assert owned == [1.0, 2.0, 3.0, 3.0]
    bytes_ = [e["value"] for s in snaps for e in s if e["name"] == "t_bytes"]
    assert bytes_ == [10.0, 25.0, 25.0, 32.0]
    assert sum("metrics collector failed" in r.getMessage()
               for r in caplog.records) == 2  # once a package


# ------------------------------------------------------- serve metrics


def _instruments(mod):
    return {name: obj for name, obj in vars(mod).items()
            if isinstance(obj, (jm._Metric, tm._Metric))}


def test_serve_instruments_match_jax():
    """Every instrument of ``ray_tpu/serve/metrics.py`` with the same
    name, kind, boundaries and tag keys, and the same summary fields."""
    j, t = _instruments(jsm), _instruments(tsm)
    assert sorted(t) == sorted(j) and len(t) == 17
    for name, jinst in j.items():
        tinst = t[name]
        assert (tinst.kind, tinst._name, tinst._tag_keys) == \
            (jinst.kind, jinst._name, jinst._tag_keys), name
        assert getattr(tinst, "_boundaries", None) == \
            getattr(jinst, "_boundaries", None), name
    assert tsm.OUTCOMES == jsm.OUTCOMES
    assert tsm._HISTOGRAMS == jsm._HISTOGRAMS


def _serve_observations(mod):
    rng = np.random.default_rng(4)
    for dep in ("prefill", "decode", "-"):
        mod.TTFT.observe_many(rng.exponential(0.3, 9).tolist(),
                              {"deployment": dep})
        mod.INTER_TOKEN.observe_many(rng.exponential(0.02, 5).tolist(),
                                     {"deployment": dep})
        mod.QUEUE_WAIT.observe(float(rng.exponential(0.1)),
                               {"deployment": dep})
        for outcome in mod.OUTCOMES:
            mod.REQUESTS.inc(float(rng.integers(0, 4)),
                             {"deployment": dep, "outcome": outcome})
        mod.PREEMPTIONS.inc(2.0, {"deployment": dep})
        mod.SPEC_PROPOSED.inc(40.0, {"deployment": dep})
        mod.SPEC_ACCEPTED.inc(13.0, {"deployment": dep})
        mod.SPEC_ACCEPT.observe(0.325, {"deployment": dep})
        mod.HANDOFF_BYTES.observe(412.0, {"deployment": dep})
        mod.HANDOFF_LATENCY.observe(1.7, {"deployment": dep})
        for event in ("published", "adopted", "aborted", "expired"):
            mod.HANDOFFS.inc(1.0, {"deployment": dep, "event": event})
    mod.HTTP_LATENCY.observe(0.2, {"deployment": "decode"})
    mod.HTTP_REQUESTS.inc(1.0, {"deployment": "decode", "code": "200"})
    mod.RETRIES.inc(1.0, {"deployment": "decode"})


def test_slo_summary_matches_jax(registries):
    _serve_observations(jsm)
    _serve_observations(tsm)
    j = {"local": jm._Registry.get().snapshot()}
    t = {"local": tm._Registry.get().snapshot()}
    assert t == j
    got = tsm.slo_summary(t)
    assert got == jsm.slo_summary(j)
    assert set(got) == {"prefill", "decode", "-"}
    assert got["decode"]["ttft_s"]["count"] == 9
    assert got["decode"]["handoffs"] == {"published": 1, "adopted": 1,
                                         "aborted": 1, "expired": 1}


# ------------------------------------------------------ engine metrics


def _counts(snapshot, dep):
    """The engine's observations under one deployment tag."""
    out = {}
    for name, field in (("serve_ttft_s", "ttft"),
                        ("serve_inter_token_s", "inter_token"),
                        ("serve_queue_wait_s", "queue_wait"),
                        ("serve_spec_accept_rate", "spec_accept")):
        s = tm.merge_histograms({"x": snapshot}, name)
        out[field] = s.get((("deployment", dep),), {}).get("count", 0)
    for name, field in (("serve_preemptions_total", "preemptions"),
                        ("serve_spec_proposed_tokens_total", "proposed"),
                        ("serve_spec_accepted_tokens_total", "accepted")):
        out[field] = tm.counter_totals({"x": snapshot}, name).get(
            (("deployment", dep),), 0.0)
    for key, total in tm.counter_totals({"x": snapshot},
                                        "serve_requests_total").items():
        tags = dict(key)
        if tags.get("deployment") == dep:
            out[tags["outcome"]] = total
    return out


def _drive(eng, reqs, budget=2000):
    for _ in range(budget):
        if all(r.done.is_set() for r in reqs):
            return
        eng.step()
    raise AssertionError(f"requests not done in {budget} steps")


def _mix(eng, prompts, errors):
    """Completed, shed, expired at submit, expired while queued,
    cancelled while queued and cancelled mid-decode, on an engine whose
    small pool forces one recompute preemption. ``errors`` is the
    engine's package's ``core.errors``."""
    shed = expired_at_submit = 0
    a = eng.submit(prompts[0], max_new_tokens=14)
    b = eng.submit(prompts[1], max_new_tokens=14)
    dropped = eng.submit(prompts[3], max_new_tokens=4)
    eng.cancel(dropped.request_id)
    late = eng.submit(prompts[2], max_new_tokens=4, deadline_s=0.01)
    try:
        eng.submit(prompts[4], max_new_tokens=4)
    except errors.OverloadedError:
        shed += 1
    try:
        eng.submit(prompts[4], max_new_tokens=4, deadline_s=0.0)
    except errors.DeadlineExceededError:
        expired_at_submit += 1
    time.sleep(0.02)  # ``late`` expires in the queue
    _drive(eng, [a, b, late, dropped])
    mid = eng.submit(prompts[5], max_new_tokens=20)
    for _ in range(3):
        eng.step()
    eng.cancel(mid.request_id)
    _drive(eng, [mid])
    statuses = [r.status for r in (a, b, late, dropped, mid)]
    assert statuses == ["completed", "completed", "deadline_exceeded",
                        "cancelled", "cancelled"], statuses
    assert (shed, expired_at_submit) == (1, 1)
    return eng


def test_engine_outcomes_match_jax(registries):
    """Same request mix, same tiny weights, same geometry (2 slots, a
    5-page pool of 8 tokens, a queue of 3): equal outcome counts, equal
    TTFT, inter-token and queue-wait observation counts and one
    preemption on both engines."""
    jcfg, jp, tcfg, tp = tiny_pair("f32", max_seq_len=256)
    prompts = [np.random.default_rng(i).integers(0, VOCAB, 10).tolist()
               for i in range(6)]
    kw = dict(slots=2, capacity=64, page_tokens=8, pool_pages=5,
              prefix_pool_entries=0, queue_max=3,
              metrics_deployment="mix")
    jeng = _mix(JaxEngine(jp, jcfg, **kw), prompts, jerrors)
    teng = _mix(DecodeEngine(tp, tcfg, device="cpu", **kw), prompts,
                terrors)
    assert teng.preempted == jeng.preempted == 1
    j = _counts(jm._Registry.get().snapshot(), "mix")
    t = _counts(tm._Registry.get().snapshot(), "mix")
    assert t == j
    # completed a, b; cancelled dropped (no first token) and mid; shed;
    # deadline at submit and in the queue.
    assert t == {"ttft": 3, "inter_token": 2, "queue_wait": 3,
                 "spec_accept": 0, "preemptions": 1.0, "proposed": 0.0,
                 "accepted": 0.0, "completed": 2.0, "cancelled": 2.0,
                 "shed": 1.0, "deadline_exceeded": 2.0}


def test_spec_engine_metrics_match_jax(registries):
    """A speculative engine (the target's weights plus 5% noise as the
    draft, k = 4): equal proposed and accepted totals and one
    accept-rate observation a request, on both engines."""
    import jax
    import jax.numpy as jnp

    from ray_tpu_torch.models import llama as tl

    jcfg, jp, tcfg, tp = tiny_pair("f32", max_seq_len=1024)
    rng = np.random.default_rng(5)
    weights = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * np.asarray(a).std()
        * rng.standard_normal(a.shape).astype(np.float32), jp)
    jdraft = jax.tree.map(jnp.asarray, weights)
    tdraft = tl.params_from_numpy(weights, tcfg, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, VOCAB, n).tolist() for n in (5, 15, 17, 30)]
    kw = dict(slots=4, capacity=256, page_tokens=16, prefix_pool_entries=0,
              spec_k=4, metrics_deployment="spec")
    jeng = JaxEngine(jp, jcfg, spec_draft_params=jdraft,
                     spec_draft_config=jcfg, **kw)
    teng = DecodeEngine(tp, tcfg, spec_draft_params=tdraft,
                        spec_draft_config=tcfg, device="cpu", **kw)
    for eng in (jeng, teng):
        _drive(eng, [eng.submit(p, max_new_tokens=24) for p in prompts])
    j = _counts(jm._Registry.get().snapshot(), "spec")
    t = _counts(tm._Registry.get().snapshot(), "spec")
    assert t == j
    assert t["completed"] == t["spec_accept"] == 4
    assert 0 < t["accepted"] < t["proposed"]
    assert t["proposed"] == teng.stats()["spec"]["proposed_tokens"]


@pytest.mark.parametrize("page_tokens", [0, 8])
def test_registry_calls_do_not_grow_with_steps(registries, monkeypatch,
                                               page_tokens):
    """The engine observes per request, never per token or step: the
    same two requests make the same number of registry calls at 4 and at
    40 new tokens (10x the decode steps)."""
    _, _, tcfg, tp = tiny_pair("f32", max_seq_len=256)
    calls = []
    record_many = tm._Registry.record_many

    def counted(self, *args, **kwargs):
        calls.append(args[0])
        return record_many(self, *args, **kwargs)

    monkeypatch.setattr(tm._Registry, "record_many", counted)
    seen = {}
    for n in (4, 40):
        calls.clear()
        eng = DecodeEngine(tp, tcfg, slots=2, capacity=64,
                           page_tokens=page_tokens, prefix_pool_entries=0,
                           device="cpu")
        _drive(eng, [eng.submit([1 + i, 2, 3], max_new_tokens=n)
                     for i in range(2)])
        seen[n] = (list(calls), eng.steps)
    assert seen[4][0] == seen[40][0]
    assert seen[40][1] >= 10 * seen[4][1] - 10
    # Two requests: one queue-wait batch, then outcome, TTFT and
    # inter-token for each.
    assert sorted(seen[4][0]) == sorted(
        ["serve_queue_wait_s"] + 2 * ["serve_requests_total",
                                      "serve_ttft_s",
                                      "serve_inter_token_s"])


def test_metrics_off_and_relabel(registries):
    """``metrics_enabled=False`` observes nothing; ``set_metrics_deployment``
    relabels what requests observe at their terminal step, and the
    timeline carries the label."""
    _, _, tcfg, tp = tiny_pair("f32", max_seq_len=256)
    off = DecodeEngine(tp, tcfg, slots=2, capacity=64, page_tokens=8,
                       metrics_enabled=False, device="cpu")
    _drive(off, [off.submit([1, 2, 3], max_new_tokens=3)])
    assert tm._Registry.get().snapshot() == []
    eng = DecodeEngine(tp, tcfg, slots=2, capacity=64, page_tokens=8,
                       metrics_deployment="warm", device="cpu")
    _drive(eng, [eng.submit([1, 2, 3], max_new_tokens=3)])
    eng.set_metrics_deployment("measured")
    assert eng.timeline()["deployment"] == "measured"
    _drive(eng, [eng.submit([4, 5], max_new_tokens=3)])
    summary = tsm.slo_summary({"local": tm._Registry.get().snapshot()})
    assert summary["warm"]["outcomes"] == {"completed": 1}
    assert summary["measured"]["outcomes"] == {"completed": 1}
