"""The port's DecodeEngine / LlamaDecodeDeployment on the CPU (tiny float32
model): continuous batching, joins, more requests than slots, the prefix
cache, cancel, deadlines, shedding, streaming, and agreement with the JAX
package's engine on the same weights.

Batched and solo runs sum in different orders, so greedy tokens compare
under the margin rule (``torch_parity.assert_greedy_agrees``) with
tol 1e-4, well above float32 logit differences (~1e-6)."""

import threading
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.core.errors import (DeadlineExceededError,
                                       OverloadedError)
from ray_tpu_torch.serve.decode import DecodeEngine, LlamaDecodeDeployment
from torch_parity import assert_greedy_agrees, greedy_with_margins, tiny_pair
from torch_parity import world_of_one  # noqa: F401

TOL = 1e-4


def _engine(tp, tcfg, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("capacity", 64)
    return DecodeEngine(tp, tcfg, device="cpu", **kw)


def _drive(eng, reqs, max_steps=200):
    for _ in range(max_steps):
        if all(r.done.is_set() for r in reqs):
            return
        eng.step()
    raise AssertionError("requests did not finish")


def _check_solo(tcfg, tp, prompt, req):
    want, margins = greedy_with_margins(tcfg, tp, prompt, req.max_new_tokens)
    assert_greedy_agrees(req.output, want, margins, TOL)


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair("f32")


@pytest.mark.parametrize("decode_chunk", [1, 4])
def test_continuous_batching_matches_solo(tiny, decode_chunk):
    _, _, tcfg, tp = tiny
    prompts = [[5, 9, 2], [7], [11, 3, 4, 8, 1]]
    eng = _engine(tp, tcfg, decode_chunk=decode_chunk)
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    _drive(eng, reqs)
    for p, r in zip(prompts, reqs):
        assert r.status == "completed" and len(r.output) == 6
        _check_solo(tcfg, tp, p, r)


def test_request_joins_mid_stream(tiny):
    _, _, tcfg, tp = tiny
    eng = _engine(tp, tcfg, slots=2)
    first = eng.submit([3, 1, 4], max_new_tokens=10)
    for _ in range(4):
        eng.step()
    assert not first.done.is_set()
    late = eng.submit([9, 9], max_new_tokens=4)
    _drive(eng, [first, late])
    _check_solo(tcfg, tp, [3, 1, 4], first)
    _check_solo(tcfg, tp, [9, 9], late)


def test_more_requests_than_slots(tiny):
    _, _, tcfg, tp = tiny
    eng = _engine(tp, tcfg, slots=2)
    prompts = [[i + 1, i + 2] for i in range(5)]
    reqs = [eng.submit(p, max_new_tokens=3) for p in prompts]
    _drive(eng, reqs)
    for p, r in zip(prompts, reqs):
        _check_solo(tcfg, tp, p, r)
    s = eng.stats()
    assert s["free_slots"] == 2 and s["tokens_out"] == 15


def test_prefix_hit_splices_and_matches(tiny):
    _, _, tcfg, tp = tiny
    eng = _engine(tp, tcfg, prefix_match_min_tokens=4)
    shared = list(np.random.default_rng(0).integers(1, 61, 20))
    a = eng.submit(shared + [3, 5], max_new_tokens=4)
    _drive(eng, [a])
    b = eng.submit(shared + [7, 8, 9], max_new_tokens=4)
    _drive(eng, [b])
    s = eng.stats()
    assert s["prefix"]["hits"] >= 1 and s["suffix_waves"] == 1
    _check_solo(tcfg, tp, shared + [3, 5], a)
    _check_solo(tcfg, tp, shared + [7, 8, 9], b)


def test_cancel_queued_and_active(tiny):
    _, _, tcfg, tp = tiny
    eng = _engine(tp, tcfg, slots=1)
    active = eng.submit([1, 2, 3], max_new_tokens=20)
    queued = eng.submit([4, 5], max_new_tokens=5)
    eng.step()
    assert eng.cancel(queued.request_id)
    assert eng.cancel(active.request_id)
    assert not eng.cancel(active.request_id)  # idempotent
    eng.step()
    assert queued.status == "cancelled" and not queued.output
    assert active.status == "cancelled" and active.generated < 20
    assert eng.stats()["cancelled"] == 2 and eng.stats()["free_slots"] == 1


def test_deadlines(tiny):
    _, _, tcfg, tp = tiny
    eng = _engine(tp, tcfg, slots=1)
    with pytest.raises(DeadlineExceededError):
        eng.submit([1], max_new_tokens=2, deadline_s=0)
    hog = eng.submit([1, 2], max_new_tokens=30)
    late = eng.submit([3], max_new_tokens=2, deadline_s=0.01)
    eng.step()
    time.sleep(0.6)  # the queue purge runs at most every 0.5 s
    eng.step()
    assert late.status == "deadline_exceeded"
    with pytest.raises(DeadlineExceededError):
        late.raise_for_status()
    assert hog.status == "pending"


def test_queue_cap_sheds(tiny):
    _, _, tcfg, tp = tiny
    eng = _engine(tp, tcfg, slots=1, queue_max=1)
    eng.submit([1, 2], max_new_tokens=2)
    with pytest.raises(OverloadedError) as ei:
        eng.submit([3, 4], max_new_tokens=2)
    assert ei.value.retry_after_s > 0 and eng.stats()["shed"] == 1


def test_submit_validates_capacity(tiny):
    _, _, tcfg, tp = tiny
    eng = _engine(tp, tcfg, capacity=16)
    with pytest.raises(ValueError, match="capacity"):
        eng.submit(list(range(1, 17)), max_new_tokens=1)
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit([1, 2], max_new_tokens=15)


def test_deployment_call_and_stream_from_threads(tiny):
    _, _, tcfg, tp = tiny
    dep = LlamaDecodeDeployment(config=tcfg, slots=2, capacity=64,
                                device="cpu")
    try:
        results = {}

        def call(i):
            results[i] = dep({"tokens": [i + 1, 2, 3], "max_new_tokens": 5})

        threads = [threading.Thread(target=call, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        streamed = list(dep({"tokens": [1, 2, 3], "max_new_tokens": 5,
                             "stream": True}))
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        assert streamed == results[0]["tokens"]
        assert all(len(r["tokens"]) == 5 and r["ttft_s"] >= 0
                   for r in results.values())
    finally:
        dep.shutdown()


def test_engine_matches_jax_engine(tiny):
    """Same weights, same prompts: the JAX package's engine and the port's
    emit the same greedy streams (margin rule against the port's solo
    logits)."""
    from ray_tpu.serve.decode import DecodeEngine as JaxEngine

    jcfg, jp, tcfg, tp = tiny
    prompts = [[5, 9, 2, 6], [7, 1], [11, 3, 4, 8, 1, 2]]
    jeng = JaxEngine(jp, jcfg, slots=4, capacity=64)
    jreqs = [jeng.submit(p, max_new_tokens=5) for p in prompts]
    _drive(jeng, jreqs)
    teng = _engine(tp, tcfg)
    treqs = [teng.submit(p, max_new_tokens=5) for p in prompts]
    _drive(teng, treqs)
    for p, jr, tr in zip(prompts, jreqs, treqs):
        _, margins = greedy_with_margins(tcfg, tp, p, 5)
        assert_greedy_agrees(tr.output, jr.output, margins, TOL)


@pytest.mark.parametrize("kw", [dict(mesh_shape=(1, 1)),
                                dict(trace_spans=True)])
def test_unported_engine_knobs_raise(tiny, kw, request):
    """Both knobs raised until they were ported. The decode mesh builds a
    1-rank (1, 1) replica on a gloo group of one, and the trace spans
    (ported with the runtime's request traces) build an engine; each
    engine's streams equal the plain engine's
    (tests/test_torch_sharded_decode.py holds larger meshes,
    ``test_trace_spans_match_jax_engine`` the spans)."""
    _, _, tcfg, tp = tiny
    if "mesh_shape" in kw:
        request.getfixturevalue("world_of_one")
    prompts = [[5, 9, 2], [7], [11, 3, 4, 8, 1]]
    outs = []
    for eng in (_engine(tp, tcfg), _engine(tp, tcfg, **kw)):
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        _drive(eng, reqs)
        outs.append([r.output for r in reqs])
        eng.shutdown()
    assert outs[1] == outs[0]
    if "trace_spans" in kw:
        return
    assert eng.stats()["chips"] == 1 and eng.stats()["mesh_shape"] == [1, 1]


def test_unported_deployment_knobs_raise(tiny, world_of_one):
    """The deployment's mesh knob, which raised until the decode mesh was
    ported, serves on a 1-rank (1, 1) replica what the mesh-less
    deployment serves."""
    _, _, tcfg, tp = tiny
    outs = []
    for kw in ({}, dict(mesh_shape=(1, 1))):
        dep = LlamaDecodeDeployment(config=tcfg, slots=2, capacity=64,
                                    device="cpu", **kw)
        outs.append(dep({"tokens": [5, 9, 2], "max_new_tokens": 5}))
        assert dep.replica_metrics()["mesh_shape"] == (
            [1, 1] if kw else None)
        dep.shutdown()
    assert outs[1]["tokens"] == outs[0]["tokens"]
    # The handoff is ported: a contiguous engine refuses it as the JAX
    # one does (tests/test_torch_handoff.py drives the paged one).
    eng = _engine(tp, tcfg)
    with pytest.raises(ValueError, match="paged"):
        eng.submit([1, 2], prefill_only=True)


def test_engine_rejects_params_on_other_device(tiny):
    _, _, tcfg, tp = tiny
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only refusal path")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(tp, tcfg)


def test_trace_spans_match_jax_engine(tiny, monkeypatch):
    """One request submitted under a trace context: the port's engine
    records the JAX engine's engine-side spans (same names, same
    attribute keys, same order), each parented under the submitter's
    span and inside the trace."""
    from ray_tpu.serve.decode import DecodeEngine as JaxEngine
    from ray_tpu.util import tracing as jtracing
    from ray_tpu_torch.util import tracing as ttracing

    jcfg, jp, tcfg, tp = tiny
    got = {}
    for name, mod, eng in (
            ("jax", jtracing, JaxEngine(jp, jcfg, slots=2, capacity=64,
                                        trace_spans=True)),
            ("port", ttracing, _engine(tp, tcfg, slots=2,
                                       trace_spans=True))):
        events = []
        monkeypatch.setattr(mod, "_record", events.append)
        with mod.trace("client") as (trace_id, span_id):
            req = eng.submit([5, 9, 2, 6], max_new_tokens=4)
        _drive(eng, [req])
        spans = [e for e in events if e["desc"] != "client"]
        assert all(e["trace_id"] == trace_id and e["parent_span"] == span_id
                   and e["lease_ts"] <= e["end_ts"] for e in spans), spans
        got[name] = [(e["desc"], sorted(e["attrs"] or {})) for e in spans]
        assert events[0]["desc"] == "client"  # closed before the engine ran
    assert got["port"] == got["jax"]
    assert [n for n, _ in got["port"]] == ["queue-wait", "prefill",
                                           "decode", "engine-request"]
