"""The port's paged DecodeEngine on the CPU (tiny float32 model): the JAX
package's paged-engine tests (``tests/test_paged_kv.py``) on the port,
the parked cursor of a chunked prefill beside active decode, the device
sampler on both engines, the deployment's paged knobs, and agreement with
the JAX package's paged engine on the same weights.

Streams compare under the margin rule (``torch_parity.
assert_greedy_agrees``) against solo contiguous runs in the port, with
tol 1e-4, well above float32 logit differences (~1e-6): a preempted,
chunked or prefix-hit request computes its logits through other paths
(suffix prefill, another batch) whose sums differ in order. The JAX paged
engine is an oracle only where neither preemption nor chunking runs: its
own exactness tests on those paths fail on the installed jax (ROADMAP.md
queue 3). Page accounting is exact: once every request has ended, every
pool page is free or pinned by the prefix index."""

import time

import numpy as np
import pytest
import torch

from ray_tpu_torch.serve.decode import DecodeEngine, LlamaDecodeDeployment
from torch_parity import assert_greedy_agrees, greedy_with_margins, tiny_pair

TOL = 1e-4
VOCAB = 61


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair("f32", max_seq_len=1024)


def _engine(tp, tcfg, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("capacity", 256)
    kw.setdefault("page_tokens", 16)
    kw.setdefault("prefix_pool_entries", 0)
    return DecodeEngine(tp, tcfg, device="cpu", **kw)


def _drive(eng, reqs, budget=2000):
    for _ in range(budget):
        if all(r.done.is_set() for r in reqs):
            return
        eng.step()
    raise AssertionError(f"requests not done in {budget} steps: "
                         f"{[r.status for r in reqs]}")


def _prompts(seed, *lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, VOCAB, n).tolist() for n in lengths]


def _check_solo(tcfg, tp, prompt, req, n=None):
    n = req.max_new_tokens if n is None else n
    assert req.status == "completed" and len(req.output) == n, req.status
    want, margins = greedy_with_margins(tcfg, tp, prompt, n)
    assert_greedy_agrees(req.output, want, margins, TOL)


def _assert_pages_accounted(eng):
    s = eng.stats()
    assert s["active"] == s["prefilling"] == s["queued"] == 0
    assert s["pages_free"] + s["pages_pinned"] == eng.pool_pages
    assert s["pages_in_use"] == s["pages_pinned"]
    assert s["prefill_backlog_tokens"] == 0


# ------------------------------------------------------ streams and hits


@pytest.mark.parametrize("page_tokens", [8, 16])
def test_paged_streams_agree_with_contiguous(tiny, page_tokens):
    """Prompt lengths straddle prefill-bucket and page boundaries; more
    requests than slots."""
    _, _, tcfg, tp = tiny
    prompts = _prompts(1, 5, 15, 16, 17, 31, 33)
    outs = {}
    for mode, kw in (("contiguous", dict(page_tokens=0)),
                     ("paged", dict(page_tokens=page_tokens))):
        eng = _engine(tp, tcfg, slots=3, capacity=64, **kw)
        reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
        _drive(eng, reqs)
        outs[mode] = reqs
    for p, c, r in zip(prompts, outs["contiguous"], outs["paged"]):
        _check_solo(tcfg, tp, p, r)
        want, margins = greedy_with_margins(tcfg, tp, p, 6)
        assert_greedy_agrees(r.output, c.output, margins, TOL)
    assert outs["paged"][0].prefix_pages == []


def test_prefix_hit_shares_pages_without_copy(tiny):
    """The insert pins the slot's own pages (pages_in_use does not grow),
    and a hit splices them into the sharer's block table: the pages
    before its suffix are the very same page ids."""
    _, _, tcfg, tp = tiny
    (shared,) = _prompts(2, 32)
    eng = _engine(tp, tcfg, slots=2, capacity=128, prefix_pool_entries=8,
                  prefix_match_min_tokens=8)
    r1 = eng.submit(shared + [7, 8], max_new_tokens=2)
    _drive(eng, [r1])
    s = eng.stats()
    assert s["pages_pinned"] == 2 and s["pages_in_use"] == 2
    pinned = sorted(eng.prefix.pinned_page_ids())
    p2 = shared + [3, 9, 4]
    r2 = eng.submit(p2, max_new_tokens=5)
    eng.step()
    slot = r2.slot
    assert sorted(eng._slot_pages[slot][:2]) == pinned
    assert eng.stats()["suffix_waves"] == 1
    _drive(eng, [r2])
    assert r2.prefix_len == 32
    _check_solo(tcfg, tp, p2, r2)
    st = eng.prefix.stats()
    assert st["hits"] == 1 and st["prefill_tokens_saved"] == 32
    _assert_pages_accounted(eng)


def test_overcommit_sustains_1p5x_concurrency(tiny):
    """12 requests active at once in a pool whose bytes hold 6 whole
    rows (2x overcommit); every stream agrees and nothing is preempted."""
    _, _, tcfg, tp = tiny
    slots, capacity, pool_pages, T = 12, 256, 24, 64
    assert pool_pages * T // capacity == 6
    eng = _engine(tp, tcfg, slots=slots, capacity=capacity, page_tokens=T,
                  pool_pages=pool_pages)
    prompts = _prompts(4, *([70] * slots))
    reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
    eng.step()
    assert eng.stats()["active"] == slots >= 1.5 * 6
    _drive(eng, reqs)
    assert eng.preempted == 0  # 12 x 2 pages fit exactly
    for p, r in zip(prompts, reqs):
        _check_solo(tcfg, tp, p, r)
    _assert_pages_accounted(eng)


# ------------------------------------------------- cancel and deadlines


def test_cancel_frees_nonshared_pages_within_one_step(tiny):
    _, _, tcfg, tp = tiny
    (shared,) = _prompts(5, 32)
    eng = _engine(tp, tcfg, slots=2, capacity=128, prefix_pool_entries=8,
                  prefix_match_min_tokens=8)
    r1 = eng.submit(shared + [1, 2], max_new_tokens=2)
    _drive(eng, [r1])
    pinned = eng.stats()["pages_pinned"]
    assert pinned == 2
    r2 = eng.submit(shared + [5, 6, 7], max_new_tokens=60)
    eng.step()
    assert eng.stats()["active"] == 1 and eng.stats()["pages_in_use"] == 3
    assert eng.cancel(r2.request_id)
    eng.step()  # ONE step boundary: the slot is reaped before decode
    s = eng.stats()
    assert r2.done.is_set() and r2.status == "cancelled"
    assert s["active"] == 0 and s["cancelled"] == 1
    assert s["pages_in_use"] == pinned == s["pages_pinned"]


def test_deadline_mid_chunked_prefill_frees_pages(tiny):
    _, _, tcfg, tp = tiny
    eng = _engine(tp, tcfg, slots=2, capacity=256, prefill_chunk_tokens=16)
    (prompt,) = _prompts(6, 200)
    req = eng.submit(prompt, max_new_tokens=4, deadline_s=30.0)
    eng.step()  # seated mid-prefill, first chunk
    eng.step()
    s = eng.stats()
    assert s["prefilling"] == 1 and s["pages_in_use"] == 2
    assert s["prefill_chunks"] == 2
    assert s["prefill_backlog_tokens"] == 200 - 32
    # Force the expiry: the reap path only reads the absolute deadline.
    req.deadline = time.monotonic() - 0.01
    eng.step()
    assert req.done.is_set() and req.status == "deadline_exceeded"
    _assert_pages_accounted(eng)
    assert eng.stats()["pages_free"] == eng.pool_pages


def test_cancel_while_requeued(tiny):
    """A request pushed back by a dry pool waits in the requeue; a cancel
    there retires it at the next purge, before it ever takes pages."""
    _, _, tcfg, tp = tiny
    eng = _engine(tp, tcfg, slots=2, capacity=128, pool_pages=8)
    big, small = _prompts(7, 100, 60)
    hog = eng.submit(big, max_new_tokens=20)   # 8 pages with its output
    eng.step()
    late = eng.submit(small, max_new_tokens=4)
    eng.step()
    assert eng.stats()["queued"] == 1 and late.slot == -1
    assert eng.cancel(late.request_id)
    eng.step()
    assert late.status == "cancelled" and not late.output
    _drive(eng, [hog])
    _check_solo(tcfg, tp, big, hog)
    _assert_pages_accounted(eng)


# --------------------------------------------------------- preemption


def test_preemption_recovers_streams(tiny):
    """4 slots x (30 + 90) tokens need 32 pages against a 20-page pool:
    the youngest requests are preempted and recomputed, and every stream
    still agrees with its solo run."""
    _, _, tcfg, tp = tiny
    eng = _engine(tp, tcfg, pool_pages=20)
    prompts = _prompts(7, 30, 30, 30, 30)
    reqs = [eng.submit(p, max_new_tokens=90) for p in prompts]
    _drive(eng, reqs)
    assert eng.preempted > 0
    assert sum(r.preemptions for r in reqs) == eng.preempted
    for p, r in zip(prompts, reqs):
        _check_solo(tcfg, tp, p, r)
        assert r.prompt_len == 30
    _assert_pages_accounted(eng)


def test_preemption_of_a_chunked_request_with_a_prefix(tiny):
    """Pressure while requests are mid-chunked-prefill and borrowing a
    cached prefix: preempted requests re-enter through the chunked path
    with their emitted tokens absorbed, and every stream agrees."""
    _, _, tcfg, tp = tiny
    (shared,) = _prompts(8, 64)
    eng = _engine(tp, tcfg, slots=4, capacity=256, pool_pages=24,
                  prefill_chunk_tokens=32, prefix_pool_entries=8,
                  prefix_match_min_tokens=16)
    src = eng.submit(shared + [1, 2, 3], max_new_tokens=4)
    _drive(eng, [src])
    tails = _prompts(9, 40, 70, 10)
    prompts = [shared + tails[0], tails[1] + tails[0], shared + tails[2],
               tails[2] * 3]
    reqs = [eng.submit(p, max_new_tokens=60) for p in prompts]
    _drive(eng, reqs)
    assert eng.preempted > 0 and eng.prefill_chunks > 0
    assert eng.prefix.stats()["hits"] >= 2
    for p, r in zip(prompts, reqs):
        _check_solo(tcfg, tp, p, r)
    _assert_pages_accounted(eng)


# ---------------------------------------------------- chunked prefill


def test_chunked_prefill_never_starves_active_slots(tiny):
    """While a long prompt prefills in chunks, every step that runs a
    chunk runs exactly one, and every active slot still emits its token
    on that step."""
    _, _, tcfg, tp = tiny
    eng = _engine(tp, tcfg, slots=3, capacity=512, page_tokens=32,
                  prefill_chunk_tokens=32)
    short = _prompts(10, 12, 12)
    actives = [eng.submit(p, max_new_tokens=40) for p in short]
    eng.step()
    assert eng.stats()["active"] == 2
    (long_prompt,) = _prompts(11, 200)  # 7 chunks
    long_req = eng.submit(long_prompt, max_new_tokens=3)
    chunk_steps = 0
    while not long_req.done.is_set():
        before = [r.generated for r in actives]
        chunks_before = eng.prefill_chunks
        eng.step()
        if eng.prefill_chunks > chunks_before:
            assert eng.prefill_chunks == chunks_before + 1
            chunk_steps += 1
            assert [r.generated for r in actives] == [b + 1 for b in before]
    assert chunk_steps == 7
    _drive(eng, actives)
    _check_solo(tcfg, tp, long_prompt, long_req)
    for p, r in zip(short, actives):
        _check_solo(tcfg, tp, p, r)
    assert long_req.first_token_at is not None
    _assert_pages_accounted(eng)


def test_chunked_prefill_keeps_decode_chunking_off(tiny):
    """decode_chunk fuses greedy steps only while no chunked prefill is in
    flight: the interleave needs a chunk between every two steps."""
    _, _, tcfg, tp = tiny
    eng = _engine(tp, tcfg, slots=2, capacity=256, decode_chunk=4,
                  prefill_chunk_tokens=16)
    short, long_prompt = _prompts(12, 8, 80)
    a = eng.submit(short, max_new_tokens=30)
    eng.step()
    assert eng._pick_chunk() == 4
    b = eng.submit(long_prompt, max_new_tokens=4)
    eng.step()
    assert eng.stats()["prefilling"] == 1 and eng._pick_chunk() == 1
    _drive(eng, [a, b])
    _check_solo(tcfg, tp, short, a)
    _check_solo(tcfg, tp, long_prompt, b)


def test_parked_cursor_keeps_shared_prefix_pages_intact(tiny):
    """A prefix hit longer than the chunk size seats a chunked prefill
    that waits several steps for its chunks (an older chunked request
    goes first) while another slot decodes. Each decode step writes the
    waiting slot's idle-row junk at its cursor, so the cursor must be
    parked at the spliced length: at 0 it would land inside the shared
    prefix pages. Those pages stay bit-identical, and every stream that
    borrows them agrees with its solo run."""
    _, _, tcfg, tp = tiny
    (shared,) = _prompts(13, 64)
    eng = _engine(tp, tcfg, slots=4, capacity=256, prefill_chunk_tokens=16,
                  prefix_pool_entries=8, prefix_match_min_tokens=16)
    src = eng.submit(shared + [5, 6, 7], max_new_tokens=3)
    _drive(eng, [src])
    pages = sorted(eng.prefix.pinned_page_ids())
    assert len(pages) == 4  # 64 tokens in 16-token pages
    snap_k = eng.cache["k"][:, pages].clone()
    snap_v = eng.cache["v"][:, pages].clone()
    (decoder,) = _prompts(14, 10)
    busy = eng.submit(decoder, max_new_tokens=40)
    eng.step()
    older, tail = _prompts(15, 90, 40)
    first = eng.submit(older, max_new_tokens=4)   # chunked, no prefix
    sharer_prompt = shared + tail                 # 64 cached + 40 new
    sharer = eng.submit(sharer_prompt, max_new_tokens=8)
    eng.step()
    assert sharer.prefix_len == 64 and sharer.slot in eng._prefilling
    assert int(eng.cache["length"][sharer.slot]) >= 64
    waited = 0
    while sharer.slot in eng._prefilling:
        if sharer.prefilled == 64:
            waited += 1
        eng.step()
    assert waited >= 3  # it really sat un-ticked beside active decode
    assert torch.equal(eng.cache["k"][:, pages], snap_k)
    assert torch.equal(eng.cache["v"][:, pages], snap_v)
    later_prompt = shared + [9, 9, 9]
    later = eng.submit(later_prompt, max_new_tokens=6)
    _drive(eng, [busy, first, sharer, later])
    assert later.prefix_len == 64
    for p, r in ((decoder, busy), (older, first), (sharer_prompt, sharer),
                 (later_prompt, later)):
        _check_solo(tcfg, tp, p, r)
    _assert_pages_accounted(eng)


# ---------------------------------------------------------------- soak


def test_soak_page_invariants(tiny):
    """Random mixed traffic (prefix sharers, chunked long prompts, short
    fillers, mid-flight cancels) on an overcommitted pool: every request
    ends, completed streams agree with solo runs, and the pool drains to
    exactly the prefix pins."""
    _, _, tcfg, tp = tiny
    rng = np.random.default_rng(42)
    eng = _engine(tp, tcfg, slots=4, capacity=512, page_tokens=32,
                  pool_pages=40, prefill_chunk_tokens=64,
                  prefix_pool_entries=8, prefix_match_min_tokens=16)
    (shared,) = _prompts(16, 128)
    live, done, submitted = [], [], 0
    for _ in range(250):
        if submitted < 16 and rng.random() < 0.25 and len(live) < 8:
            kind = rng.random()
            if kind < 0.4:
                prompt = (shared[:int(rng.integers(32, 128))]
                          + rng.integers(0, VOCAB,
                                         int(rng.integers(1, 20))).tolist())
            elif kind < 0.6:
                prompt = rng.integers(0, VOCAB,
                                      int(rng.integers(150, 400))).tolist()
            else:
                prompt = rng.integers(0, VOCAB,
                                      int(rng.integers(3, 40))).tolist()
            n = int(rng.integers(1, 24))
            live.append([eng.submit(prompt, max_new_tokens=n), prompt, n,
                         False])
            submitted += 1
        if live and rng.random() < 0.05:
            victim = live[int(rng.integers(len(live)))]
            if not victim[3]:
                eng.cancel(victim[0].request_id)
                victim[3] = True
        eng.step()
        for e in list(live):
            if e[0].done.is_set():
                live.remove(e)
                done.append(e)
    _drive(eng, [e[0] for e in live], budget=3000)
    done += live
    checked = 0
    for req, prompt, n, cancelled in done:
        if req.status != "completed":
            assert cancelled and req.status == "cancelled", req.status
            continue
        _check_solo(tcfg, tp, prompt, req, n)
        checked += 1
    assert checked >= 8
    assert eng.preempted + eng.prefill_chunks > 0
    _assert_pages_accounted(eng)


# ---------------------------------------------------- stats and checks


def test_stats_keys_and_load(tiny):
    _, _, tcfg, tp = tiny
    eng = _engine(tp, tcfg, slots=1, capacity=256, prefill_chunk_tokens=32)
    (short, long_prompt) = _prompts(17, 10, 200)
    active = eng.submit(short, max_new_tokens=40)
    eng.step()
    queued_long = eng.submit(long_prompt, max_new_tokens=2)
    s = eng.stats()
    for key in ("page_tokens", "pages_total", "pages_free", "pages_in_use",
                "pages_pinned", "kv_fragmentation", "preempted",
                "prefill_chunks", "prefilling", "prefill_waves",
                "suffix_waves", "prefill_backlog_tokens", "load"):
        assert key in s, key
    assert s["page_tokens"] == 16 and s["pages_total"] == eng.pool_pages
    assert s["active"] == 1 and s["queued"] == 1
    assert s["prefill_backlog_tokens"] == 200
    assert s["load"] == 1 + 1 + 200 // 32
    assert s["pages_free"] + s["pages_in_use"] == s["pages_total"]
    # One page backs the 10 prompt and 2 output tokens of 16.
    assert s["kv_fragmentation"] == round(1 - 12 / 16, 4)
    _drive(eng, [active, queued_long])
    assert eng.stats()["prefill_backlog_tokens"] == 0
    _assert_pages_accounted(eng)


def test_contiguous_stats_have_no_page_keys(tiny):
    _, _, tcfg, tp = tiny
    eng = _engine(tp, tcfg, slots=2, capacity=64, page_tokens=0)
    assert not eng.paged
    reqs = [eng.submit([i + 1, 2], max_new_tokens=8) for i in range(5)]
    eng.step()
    s = eng.stats()
    assert s["load"] == 5 and "pages_total" not in s
    assert s["preempted"] == s["prefill_chunks"] == s["prefilling"] == 0
    _drive(eng, reqs)


def test_rejects_bad_geometry(tiny):
    _, _, tcfg, tp = tiny
    with pytest.raises(ValueError, match="multiple"):
        _engine(tp, tcfg, slots=1, capacity=100)
    eng = _engine(tp, tcfg, slots=1, capacity=128, pool_pages=4)
    with pytest.raises(ValueError, match="pages"):
        eng.submit(list(range(1, 70)), max_new_tokens=8)  # > 4 pages


def test_chunk_size_rounds_down_to_a_power_of_two(tiny):
    _, _, tcfg, tp = tiny
    assert _engine(tp, tcfg, prefill_chunk_tokens=100) \
        .prefill_chunk_tokens == 64
    assert _engine(tp, tcfg, page_tokens=0, prefill_chunk_tokens=100) \
        .prefill_chunk_tokens == 0  # contiguous engines never chunk


def test_paged_engine_needs_a_card_unless_asked_for_cpu(tiny):
    _, _, tcfg, tp = tiny
    if torch.cuda.is_available():
        pytest.skip("checks the CPU-only refusal path")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DecodeEngine(tp, tcfg, slots=1, capacity=64, page_tokens=16)


# ------------------------------------------------------ device sampler


@pytest.mark.parametrize("page_tokens", [0, 16])
def test_device_sampler_greedy_equals_host_sampler(tiny, page_tokens):
    """Greedy streams are identical with the sampler on the device, across
    joins and finishes that rewrite the host token vector."""
    _, _, tcfg, tp = tiny
    prompts = _prompts(18, 5, 20, 9, 33, 2)
    outs = {}
    for on in (False, True):
        eng = _engine(tp, tcfg, slots=2, capacity=128,
                      page_tokens=page_tokens, device_sampler=on)
        reqs = [eng.submit(p, max_new_tokens=4 + 3 * i)
                for i, p in enumerate(prompts)]
        _drive(eng, reqs)
        outs[on] = [r.output for r in reqs]
    assert outs[True] == outs[False]


@pytest.mark.parametrize("page_tokens", [0, 16])
def test_device_sampler_sampled_rows_repeat(tiny, page_tokens):
    """Sampled rows draw from the step-seeded generator: two fresh engines
    give the same streams; greedy rows beside them still equal their solo
    runs."""
    _, _, tcfg, tp = tiny
    prompts = _prompts(19, 6, 11, 25)
    runs = []
    for _ in range(2):
        eng = _engine(tp, tcfg, slots=3, capacity=128,
                      page_tokens=page_tokens, device_sampler=True)
        reqs = [eng.submit(p, max_new_tokens=12,
                           temperature=0.8 if i == 1 else 0.0)
                for i, p in enumerate(prompts)]
        _drive(eng, reqs)
        runs.append(reqs)
    assert [r.output for r in runs[0]] == [r.output for r in runs[1]]
    assert all(0 <= t < VOCAB for t in runs[0][1].output)
    for i in (0, 2):
        _check_solo(tcfg, tp, prompts[i], runs[0][i])
    greedy, _ = greedy_with_margins(tcfg, tp, prompts[1], 12)
    assert runs[0][1].output != greedy  # really sampled


def test_device_sampler_feeds_tokens_back_on_the_device(tiny):
    """Between two sampled steps with no host-side token write, the next
    step takes the last step's device token vector; an admission drops
    it."""
    _, _, tcfg, tp = tiny
    eng = _engine(tp, tcfg, slots=2, capacity=128, device_sampler=True)
    a = eng.submit([3, 1, 4], max_new_tokens=10)
    eng.step()                     # admission + first sampled step
    kept = eng._tokens_dev
    assert kept is not None
    assert kept.tolist()[a.slot] == eng._tokens[a.slot]
    eng.step()
    assert eng._tokens_dev is not kept
    eng.submit([9, 9], max_new_tokens=2)
    eng._admit()
    assert eng._tokens_dev is None


# ---------------------------------------------------------- deployment


def test_deployment_takes_paged_knobs(tiny):
    _, _, tcfg, tp = tiny
    dep = LlamaDecodeDeployment(config=tcfg, slots=2, capacity=128,
                                kv_page_tokens=16, kv_pool_pages=12,
                                prefill_chunk_tokens=32,
                                device_sampler=True, device="cpu")
    try:
        eng = dep.engine
        assert eng.paged and eng.pool_pages == 12
        assert eng.prefill_chunk_tokens == 32 and eng._device_sampler
        out = dep({"tokens": list(range(1, 60)), "max_new_tokens": 5})
        streamed = list(dep({"tokens": [4, 5, 6], "max_new_tokens": 4,
                             "stream": True}))
        assert len(out["tokens"]) == 5 and len(streamed) == 4
        assert eng.stats()["prefill_chunks"] == 2
    finally:
        dep.shutdown()
    assert not dep._thread.is_alive()


# ------------------------------------------------- against the JAX engine


def test_paged_engine_matches_jax_paged_engine(tiny):
    """Same weights, same prompts, no preemption and no chunking: the JAX
    package's paged engine and the port's emit the same greedy streams
    (margin rule against the port's solo logits)."""
    from ray_tpu.serve.decode import DecodeEngine as JaxEngine

    jcfg, jp, tcfg, tp = tiny
    prompts = _prompts(20, 5, 17, 33)
    kw = dict(slots=4, capacity=64, page_tokens=16, prefix_pool_entries=0)
    jeng = JaxEngine(jp, jcfg, **kw)
    jreqs = [jeng.submit(p, max_new_tokens=5) for p in prompts]
    _drive(jeng, jreqs)
    teng = DecodeEngine(tp, tcfg, device="cpu", **kw)
    treqs = [teng.submit(p, max_new_tokens=5) for p in prompts]
    _drive(teng, treqs)
    assert jeng.preempted == teng.preempted == 0
    for p, jr, tr in zip(prompts, jreqs, treqs):
        _, margins = greedy_with_margins(tcfg, tp, p, 5)
        assert_greedy_agrees(tr.output, jr.output, margins, TOL)
    js, ts = jeng.stats(), teng.stats()
    for key in ("pages_total", "pages_free", "pages_in_use", "tokens_out"):
        assert ts[key] == js[key], key
