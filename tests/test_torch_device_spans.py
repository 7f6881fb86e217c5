"""Device-timed spans (``ray_tpu_torch.util.tracing.device_span``) and
the step timelines that read them: the engine's phases with ``dev_ms``,
``attn_ms``, ``tokens`` and the host-only ``admit`` / ``emit`` phases,
and the train step's ``forward`` / ``backward`` / ``optimizer`` rows with
``lm_head_ce_ms``.

On the CPU a fake event class stands in for ``torch.cuda.Event``: it
counts what is made and recorded, stamps a counter clock, and completes
only when a test opens its gate, so resolution before completion and the
absence of any wait show. One ``cuda`` case checks the engine's phase
times against the profiler's busy time on a card."""

import itertools
import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.ops.optim import adamw
from ray_tpu_torch.parallel import train_step as ts
from ray_tpu_torch.serve import steplog
from ray_tpu_torch.serve.decode import DecodeEngine
from ray_tpu_torch.util import tracing

VOCAB = 61
TINY = dict(vocab_size=VOCAB, dim=32, n_layers=2, n_heads=4, n_kv_heads=2,
            mlp_dim=64, max_seq_len=256)
# The engine's phases before device spans, each timing the host alone.
HOST_PHASES = {"prefill", "suffix-prefill", "prefill-chunk", "decode",
               "draft", "verify", "draft-prefill", "handoff"}
SPAN_KEYS = {"dev_ms", "attn_ms", "tokens"}


class FakeEvents:
    """``torch.cuda.Event`` stand-in: each record stamps the next tick of
    a counter clock (1 ms a tick); ``query`` is the gate; there is no
    ``synchronize`` or ``wait``, so a span that waited would raise."""

    def __init__(self):
        self.made = self.recorded = 0
        self.complete = True
        self.clock = itertools.count()
        fakes = self

        class Event:
            def __init__(self):
                fakes.made += 1
                self.t = None

            def record(self, stream=None):
                fakes.recorded += 1
                self.t = next(fakes.clock)

            def query(self):
                return fakes.complete

            def elapsed_time(self, end):
                assert fakes.complete and self.t is not None
                return float(end.t - self.t)

        self.Event = Event


@pytest.fixture
def fake_cuda(monkeypatch):
    """Every span on a device, the CPU included, gets events from
    :class:`FakeEvents`; the switch ends the test off."""
    fakes = FakeEvents()
    monkeypatch.setattr(tracing, "_new_event", fakes.Event)
    monkeypatch.setattr(tracing, "_stream", lambda index: None)
    monkeypatch.setattr(tracing, "_cuda_index",
                        lambda device: None if device is None else 0)
    monkeypatch.setattr(tracing, "_EVENTS", {})
    yield fakes
    tracing.set_device_spans(False)


@pytest.fixture(scope="module")
def params():
    cfg = tl.LlamaConfig(dtype=torch.float32, **TINY)
    return cfg, tl.init_params(cfg, device="cpu", seed=0)


# ---------------------------------------------------------- the primitive


def test_switch_off_records_nothing(fake_cuda):
    tracing.set_device_spans(False)
    with tracing.device_span("outer", "cuda") as outer:
        with tracing.device_span("attn", "cuda") as inner:
            pass
    assert outer is inner and not isinstance(outer, tracing.DeviceSpan)
    assert not tracing.current_span_stack()
    assert (fake_cuda.made, fake_cuda.recorded) == (0, 0)


def test_spans_nest_and_resolve_once_the_end_event_completes(fake_cuda):
    tracing.set_device_spans(True)
    fake_cuda.complete = False
    with tracing.device_span("phase", "cuda") as outer:
        for _ in range(2):
            with tracing.device_span("attn", "cuda"):
                pass
    assert [c.name for c in outer.children] == ["attn", "attn"]
    assert not tracing.current_span_stack()
    assert outer.t0 <= outer.t1
    assert not outer.resolve() and outer.dev_ms is None
    fake_cuda.complete = True
    assert outer.resolve()
    # Ticks: outer 0..5, the two inner spans 1..2 and 3..4.
    assert outer.dev_ms == 5.0
    assert outer.totals() == {"attn": 2.0}
    # The six events went back to the pool and serve the next spans.
    assert fake_cuda.made == 6 and len(tracing._EVENTS[0]) == 6
    with tracing.device_span("again", "cuda") as again:
        pass
    assert again.resolve() and fake_cuda.made == 6


def test_explicit_parent_and_host_only_spans(fake_cuda):
    tracing.set_device_spans(True)
    with tracing.device_span("phase", "cuda") as outer:
        pass
    stack = tracing.current_span_stack()
    with tracing.device_span("late", "cuda", parent=outer):
        assert stack[-1].name == "late"
    assert [c.name for c in outer.children] == ["late"]
    made = fake_cuda.made
    with tracing.device_span("host", None) as span:
        pass
    assert span.resolve() and span.dev_ms is None
    assert fake_cuda.made == made


def test_timeline_fills_phases_only_after_completion(fake_cuda):
    tracing.set_device_spans(True)
    fake_cuda.complete = False
    tl_ = steplog.StepTimeline(8)
    phase = {"phase": "decode", "t0": 1.0, "t1": 2.0}
    with tracing.device_span("phase", "cuda") as span:
        with tracing.device_span("attn", "cuda"):
            pass
    tl_.record(0, 0.5, 2.5, [phase], active=1, prefilling=0, queued=0,
               spans=[(phase, span)])
    assert "dev_ms" not in tl_.dump()["rows"][0]["phases"][0]
    fake_cuda.complete = True
    got = tl_.dump()["rows"][0]["phases"][0]
    assert got["dev_ms"] == 3.0 and got["attn_ms"] == 1.0
    assert not tl_._spans


def test_dump_from_other_threads_while_rows_resolve(fake_cuda):
    """Readers dump while the recording thread appends rows whose spans
    resolve (and whose phases gain keys): no reader fails, and every
    phase ends with its device time."""
    import sys
    import threading

    tracing.set_device_spans(True)
    tl_ = steplog.StepTimeline(64)
    errors, stop = [], threading.Event()

    def reader():
        try:
            while not stop.is_set():
                for row in tl_.dump()["rows"]:
                    for phase in row["phases"]:
                        for _key in phase:
                            pass
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    readers = [threading.Thread(target=reader) for _ in range(8)]
    try:
        for t in readers:
            t.start()
        for step in range(400):
            fake_cuda.complete = step % 3 != 0
            # Many keys make a reader's walk of a phase long.
            phase = {"phase": "decode", "t0": step, "t1": step + 0.5,
                     **{f"attr{i}": i for i in range(200)}}
            with tracing.device_span("phase", "cuda") as span:
                with tracing.device_span("attn", "cuda"):
                    pass
            tl_.record(step, step, step + 1.0, [phase], active=1,
                       prefilling=0, queued=0, spans=[(phase, span)])
    finally:
        stop.set()
        for t in readers:
            t.join(timeout=30)
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in readers) and not errors
    fake_cuda.complete = True
    rows = tl_.dump()["rows"]
    assert len(rows) == 64 and all(
        p["dev_ms"] == 3.0 and p["attn_ms"] == 1.0
        for r in rows for p in r["phases"])


# ------------------------------------------------------------- the engine


def _drive(eng, reqs, budget=3000):
    for _ in range(budget):
        if all(r.done.is_set() for r in reqs):
            return
        eng.step()
    raise AssertionError([r.status for r in reqs])


def _paged_run(params, **kw):
    """Two plain prompts, one longer than the chunk, then one that shares
    its prefix: full, chunked and suffix prefill, and decode."""
    cfg, p = params
    eng = DecodeEngine(p, cfg, slots=2, capacity=256, page_tokens=16,
                       prefill_chunk_tokens=32, prefix_match_min_tokens=16,
                       step_timeline=4096, device="cpu", **kw)
    rng = np.random.default_rng(5)
    long_p = rng.integers(0, VOCAB, 70).tolist()
    reqs = [eng.submit(long_p, max_new_tokens=5),
            eng.submit(rng.integers(0, VOCAB, 9).tolist(), max_new_tokens=4)]
    _drive(eng, reqs)
    reqs = [eng.submit(long_p[:48] + [3, 4, 5], max_new_tokens=3)]
    _drive(eng, reqs)
    return eng


def _phases(eng):
    return [p for row in eng.timeline()["rows"] for p in row["phases"]]


def test_engine_rows_unchanged_with_the_switch_off(params, fake_cuda):
    tracing.set_device_spans(False)
    eng = _paged_run(params)
    phases = _phases(eng)
    assert {p["phase"] for p in phases} == {
        "prefill", "prefill-chunk", "suffix-prefill", "decode"}
    assert not any(SPAN_KEYS & set(p) for p in phases
                   if p["phase"] != "prefill-chunk")
    assert all(set(p) - {"tokens"} == set(p) - SPAN_KEYS for p in phases)
    assert not any("dev_ms" in r for r in eng.timeline()["rows"])
    assert (fake_cuda.made, fake_cuda.recorded) == (0, 0)
    # The switch adds phases and keys and changes nothing else.
    tracing.set_device_spans(True)
    on = _phases(_paged_run(params))
    strip = [{k: v for k, v in p.items() if k not in ("t0", "t1")}
             for p in phases]
    assert strip == [
        {k: v for k, v in p.items() if k not in ("t0", "t1", "dev_ms",
                                                  "attn_ms")
         and (k != "tokens" or p["phase"] == "prefill-chunk")}
        for p in on if p["phase"] not in ("admit", "emit")]


def test_engine_phases_carry_device_times(params, fake_cuda):
    tracing.set_device_spans(True)
    eng = _paged_run(params)
    rows = eng.timeline()["rows"]
    phases = _phases(eng)
    names = {p["phase"] for p in phases}
    assert {"admit", "emit", "prefill", "prefill-chunk", "suffix-prefill",
            "decode"} <= names <= HOST_PHASES | {"admit", "emit"}
    for p in phases:
        if p["phase"] in ("admit", "emit"):
            assert set(p) == {"phase", "t0", "t1"}
            continue
        assert p["dev_ms"] > 0
    decode = [p for p in phases if p["phase"] == "decode"]
    # Each decode step: one attn span a layer (one tick each on the fake
    # clock) inside its phase span.
    assert all(0 < p["attn_ms"] < p["dev_ms"] for p in decode)
    assert all(p["attn_ms"] == TINY["n_layers"] * p["k"] for p in decode)
    chunks = [p for p in phases if p["phase"] == "prefill-chunk"]
    assert sorted(p["tokens"] for p in chunks) == [6, 32, 32]
    assert [p["tokens"] for p in phases if p["phase"] == "prefill"] == [9]
    assert [p["tokens"] for p in phases
            if p["phase"] == "suffix-prefill"] == [51 - 48]
    # admit opens each row and ends no later than the first launch.
    for row in rows:
        first = row["phases"][0]
        assert first["phase"] == "admit" and first["t0"] == row["t0"]
        assert all(first["t1"] <= p["t0"] for p in row["phases"][1:])
    # Every span's events went back to the pool: none is left pending.
    assert not eng.steplog._spans
    assert len(tracing._EVENTS[0]) == fake_cuda.made


def test_spec_rows_carry_verify_attention_and_emit(params, fake_cuda):
    cfg, p = params
    tracing.set_device_spans(True)
    eng = DecodeEngine(p, cfg, slots=2, capacity=256, page_tokens=16,
                       prefix_pool_entries=0, spec_draft_params=p,
                       spec_draft_config=cfg, spec_k=3, step_timeline=256,
                       device="cpu")
    rng = np.random.default_rng(3)
    reqs = [eng.submit(rng.integers(0, VOCAB, n).tolist(),
                       max_new_tokens=10) for n in (20, 12)]
    _drive(eng, reqs)
    phases = _phases(eng)
    verify = [q for q in phases if q["phase"] == "verify"]
    draft = [q for q in phases if q["phase"] == "draft"]
    assert verify and all(0 < q["attn_ms"] < q["dev_ms"] for q in verify)
    assert draft and all(q["dev_ms"] > 0 for q in draft)
    assert all("tokens" in q for q in phases
               if q["phase"] == "draft-prefill")
    # The emit of a spec round lies inside its verify phase.
    for row in eng.timeline()["rows"]:
        for v in (q for q in row["phases"] if q["phase"] == "verify"):
            emits = [q for q in row["phases"] if q["phase"] == "emit"]
            assert len(emits) == 1
            assert v["t0"] <= emits[0]["t0"] <= emits[0]["t1"] <= v["t1"]


def test_engine_host_spans_on_the_cpu(params):
    """Without a card the phases carry their keys with no device time."""
    tracing.set_device_spans(True)
    try:
        eng = _paged_run(params)
    finally:
        tracing.set_device_spans(False)
    decode = [p for p in _phases(eng) if p["phase"] == "decode"]
    assert decode and all(p["dev_ms"] is None and p["attn_ms"] is None
                          for p in decode)


# --------------------------------------------------------- the train step


def _train(params, accum_steps=2, steps=1):
    cfg, p0 = params
    cfg = tl.LlamaConfig(dtype=torch.float32, loss_chunk=8,
                         **{**TINY, "max_seq_len": 32})
    p = {k: (v.clone() if torch.is_tensor(v) else
             {kk: vv.clone() for kk, vv in v.items()})
         for k, v in p0.items()}
    opt = adamw(1e-3)
    state = ts.init_optimizer_state(opt, p)
    step = ts.build_train_step(lambda pp, b: tl.loss_fn(pp, b, cfg), opt,
                               accum_steps=accum_steps)
    g = torch.Generator().manual_seed(1)
    for _ in range(steps):
        batch = {"tokens": torch.randint(0, VOCAB, (4, 33), generator=g)}
        p, state, m = step(p, state, batch)
    return step, p, m


def test_train_step_rows_with_lm_head_time(params, fake_cuda):
    tracing.set_device_spans(True)
    step, p_on, m_on = _train(params, steps=2)
    rows = step.timeline()["rows"]
    assert [r["step"] for r in rows] == [0, 1]
    row = rows[0]
    assert [(q["phase"], q.get("microbatch")) for q in row["phases"]] == [
        ("forward", 0), ("backward", 0), ("forward", 1), ("backward", 1),
        ("optimizer", None)]
    assert all(q["dev_ms"] > 0 for q in row["phases"])
    assert row["active"] == 4
    # Four chunks of 8 a microbatch, forward and backward: the row's sum
    # over both, each phase's over its own.
    assert 0 < row["lm_head_ce_ms"] < row["dev_ms"]
    by = {(q["phase"], q.get("microbatch")): q for q in row["phases"]}
    assert row["lm_head_ce_ms"] == sum(
        by[(ph, mb)]["lm_head_ce_ms"] for ph in ("forward", "backward")
        for mb in (0, 1))
    assert all(0 < by[(ph, mb)]["lm_head_ce_ms"] < by[(ph, mb)]["dev_ms"]
               for ph in ("forward", "backward") for mb in (0, 1))
    # The spans change nothing the step computes.
    tracing.set_device_spans(False)
    made = fake_cuda.made
    step_off, p_off, m_off = _train(params, steps=2)
    assert step_off.timeline()["rows"] == [] and fake_cuda.made == made
    assert torch.equal(m_on["loss"], m_off["loss"])
    for a, b in zip(ts.tree_leaves(p_on), ts.tree_leaves(p_off)):
        assert torch.equal(a, b)


def test_train_step_off_makes_no_event(params, fake_cuda):
    tracing.set_device_spans(False)
    step, _, _ = _train(params, accum_steps=1)
    assert step.timeline()["rows"] == []
    assert (fake_cuda.made, fake_cuda.recorded) == (0, 0)


# ---------------------------------------------------------------- on a card


@pytest.mark.cuda
def test_phase_device_time_between_busy_and_host_span():
    """On a card: over a few engine steps, the phases' summed ``dev_ms``
    is at least the profiler's busy time (the union of the kernels'
    intervals) and at most the host span of the steps."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA events time the card)")
    from torch.profiler import ProfilerActivity, profile

    cfg = tl.LlamaConfig(vocab_size=4096, dim=512, n_layers=4, n_heads=8,
                         n_kv_heads=2, mlp_dim=1024, max_seq_len=2048,
                         dtype=torch.bfloat16)
    p = tl.init_params(cfg, device="cuda", seed=0)
    eng = DecodeEngine(p, cfg, slots=8, capacity=1024, page_tokens=64,
                       prefill_chunk_tokens=256, step_timeline=4096,
                       device="cuda")
    rng = np.random.default_rng(0)
    warm = [eng.submit(rng.integers(0, 4096, 300).tolist(),
                       max_new_tokens=4) for _ in range(2)]
    _drive(eng, warm)
    torch.cuda.synchronize()
    tracing.set_device_spans(True)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            reqs = [eng.submit(rng.integers(0, 4096, n).tolist(),
                               max_new_tokens=24) for n in (100, 400, 700)]
            _drive(eng, reqs)
            torch.cuda.synchronize()
            t1 = time.time()
    finally:
        tracing.set_device_spans(False)
    rows = [r for r in eng.timeline()["rows"] if r["t0"] >= t0]
    dev = sum(q["dev_ms"] for r in rows for q in r["phases"]
              if "dev_ms" in q)
    ivs = sorted((e.time_range.start, e.time_range.end)
                 for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    busy_us, cur = 0.0, None
    for s, e in ivs:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy_us += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    busy_us += cur[1] - cur[0]
    assert rows and all("dev_ms" in q for r in rows for q in r["phases"]
                        if q["phase"] not in ("admit", "emit"))
    assert busy_us / 1e3 <= dev <= (t1 - t0) * 1e3, (busy_us, dev, t0, t1)
