"""The port's step timeline: ``ray_tpu_torch.serve.steplog`` against
``ray_tpu.serve.steplog`` on the same event and record sequence (clocks
pinned, so the dumps must be equal), and the rows the port's engine
records: phases, occupancy, page and preemption events, first dispatches,
and the draft / verify phases of a spec round."""

import itertools

import numpy as np
import pytest

from ray_tpu.serve import steplog as jsteplog
from ray_tpu_torch.serve import steplog as tsteplog
from ray_tpu_torch.serve.decode import DecodeEngine
from torch_parity import one_torch_thread, tiny_pair  # noqa: F401

VOCAB = 61
pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _script(mod, monkeypatch):
    """One fixed sequence of events and rows through ``mod``'s recorder
    at each ring size, on a clock that restarts at each call."""
    clock = itertools.count(1000.0, 0.5)
    monkeypatch.setattr(mod.time, "time", lambda: next(clock))
    out = {}
    for cap in (0, 3, 8):
        tl = mod.StepTimeline(cap)
        for step in range(6):
            tl.event("page-alloc", n=step, free=10 - step)
            if step % 2:
                tl.event("preempt", request=f"r{step}", tokens=step)
            tl.record(step, step + 0.1, step + 0.9,
                      [{"phase": "decode", "t0": step + 0.2,
                        "t1": step + 0.8, "batch": 2, "k": 1}],
                      active=2, prefilling=step % 3, queued=1,
                      pages_free=None if step == 4 else 10 - step)
        tl.event("jit-compile", key="decode")
        out[cap] = (tl.enabled, tl.pending_events, tl.dropped, tl.dump())
    return out


def test_timeline_matches_jax(monkeypatch):
    """Same dump, ring bound, dropped count and pending events at ring
    sizes 0 (disabled), 3 (overflowing) and 8."""
    j, t = _script(jsteplog, monkeypatch), _script(tsteplog, monkeypatch)
    assert t == j
    enabled, pending, dropped, dump = t[3]
    assert enabled and pending and dropped == 3 and len(dump["rows"]) == 3
    assert [r["step"] for r in dump["rows"]] == [3, 4, 5]
    assert "pages_free" not in dump["rows"][1]
    enabled, pending, dropped, dump = t[0]
    assert not enabled and not pending and dump["rows"] == []


def test_chrome_events_match_jax(monkeypatch):
    dump = _script(tsteplog, monkeypatch)[8][3]
    got = tsteplog.timeline_chrome_events(dump, pid="engine:0")
    assert got == jsteplog.timeline_chrome_events(dump, pid="engine:0")
    assert {e["ph"] for e in got} == {"X", "C", "i"}


# ------------------------------------------------------------ engine


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair("f32", max_seq_len=1024)


def _drive(eng, reqs, budget=3000):
    for _ in range(budget):
        if all(r.done.is_set() for r in reqs):
            return
        eng.step()
    raise AssertionError([r.status for r in reqs])


def _events(eng):
    return [e for row in eng.timeline()["rows"] for e in row.get("events",
                                                                  [])]


def _phases(eng):
    return [p for row in eng.timeline()["rows"] for p in row["phases"]]


def test_disabled_timeline_records_nothing(tiny):
    _, _, tcfg, tp = tiny
    eng = DecodeEngine(tp, tcfg, slots=2, capacity=128, page_tokens=16,
                       step_timeline=0, device="cpu")
    req = eng.submit([1, 2, 3], max_new_tokens=4)
    _drive(eng, [req])
    assert not eng.steplog.enabled and eng.timeline()["rows"] == []
    assert not eng.steplog.pending_events
    assert "step_timeline_rows" not in eng.stats()


def test_ring_bounded_with_phases_and_first_dispatches(tiny):
    _, _, tcfg, tp = tiny
    eng = DecodeEngine(tp, tcfg, slots=2, capacity=128,
                       prefix_pool_entries=0, step_timeline=8, device="cpu")
    reqs = [eng.submit([1, 2, 3], max_new_tokens=32) for _ in range(2)]
    _drive(eng, reqs)
    tl = eng.timeline()
    assert len(tl["rows"]) == 8 and tl["dropped"] > 0
    assert tl["paged"] is False and tl["spec_k"] == 0 and tl["slots"] == 2
    row = tl["rows"][-1]
    assert {"step", "t0", "t1", "active", "prefilling", "queued"} <= set(row)
    assert "pages_free" not in row
    assert {p["phase"] for p in row["phases"]} == {"decode"}
    assert all(p["t0"] <= p["t1"] for r in tl["rows"] for p in r["phases"])
    s = eng.stats()
    assert s["step_timeline_rows"] == 8 and s["step_timeline_dropped"] > 0
    assert {("prefill", 2, 128), ("decode",)} <= eng._compiled


def test_paged_rows_carry_page_preempt_and_prefill_phases(tiny):
    """A pool too small for four 30 + 90 token requests preempts; a
    prompt longer than the chunk prefills in chunks; a second prompt
    sharing a prefix prefills its suffix. Rows carry the page events, the
    preempt event and every prefill phase, with pages_free."""
    _, _, tcfg, tp = tiny
    rng = np.random.default_rng(7)
    eng = DecodeEngine(tp, tcfg, slots=4, capacity=256, page_tokens=16,
                       pool_pages=20, prefill_chunk_tokens=32,
                       prefix_match_min_tokens=16, step_timeline=4096,
                       device="cpu")
    prompts = [rng.integers(0, VOCAB, 30).tolist() for _ in range(4)]
    reqs = [eng.submit(p, max_new_tokens=90) for p in prompts]
    _drive(eng, reqs)
    assert eng.preempted > 0
    long_p = rng.integers(0, VOCAB, 100).tolist()
    reqs = [eng.submit(long_p, max_new_tokens=4)]
    _drive(eng, reqs)
    reqs = [eng.submit(long_p[:64] + [5, 6], max_new_tokens=4)]
    _drive(eng, reqs)
    kinds = {e["kind"] for e in _events(eng)}
    assert {"page-alloc", "page-free", "preempt", "jit-compile"} <= kinds
    assert sum(e["kind"] == "preempt" for e in _events(eng)) \
        == eng.preempted
    names = {p["phase"] for p in _phases(eng)}
    assert {"prefill", "prefill-chunk", "suffix-prefill", "decode"} <= names
    rows = eng.timeline()["rows"]
    assert all(r["pages_free"] is not None for r in rows)
    ev = tsteplog.timeline_chrome_events(eng.timeline(), pid="engine:t")
    assert any(e["ph"] == "i" and e["name"] == "preempt" for e in ev)


def test_spec_rows_carry_draft_and_verify_phases(tiny):
    """A spec engine whose draft pool seats one of two prompts: rows hold
    draft and verify phases (verify with its accepted count, which sums
    to the stats' accepted tokens) and the spec-draftless event."""
    _, _, tcfg, tp = tiny
    eng = DecodeEngine(tp, tcfg, slots=4, capacity=256, page_tokens=16,
                       prefix_pool_entries=0, spec_draft_params=tp,
                       spec_draft_config=tcfg, spec_k=3,
                       spec_draft_pool_pages=4, step_timeline=128,
                       device="cpu")
    rng = np.random.default_rng(3)
    reqs = [eng.submit(rng.integers(0, VOCAB, n).tolist(),
                       max_new_tokens=12) for n in (40, 30)]
    _drive(eng, reqs)
    tl = eng.timeline()
    assert tl["spec_k"] == 3 and tl["paged"] is True
    verify = [p for p in _phases(eng) if p["phase"] == "verify"]
    assert verify and all(p["k"] == 3 for p in verify)
    s = eng.stats()["spec"]
    assert sum(p["accepted"] for p in verify) == s["accepted_tokens"] > 0
    assert len(verify) == s["rounds"]
    names = {p["phase"] for p in _phases(eng)}
    assert {"draft", "verify", "draft-prefill"} <= names
    demoted = [e for e in _events(eng) if e["kind"] == "spec-draftless"]
    assert len(demoted) == s["draft_demotions"] >= 1
    assert {("spec_draft", 3), ("spec_verify", 3)} <= eng._compiled
