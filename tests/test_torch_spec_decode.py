"""The port's speculative decoding on the paged engine (tiny float32
models on the CPU): ``paged_verify`` and ``paged_spec_draft`` against
``ray_tpu.models.llama_decode``, and the engine's spec mode against the
port's plain paged engine and the JAX package's spec engine
(``tests/test_spec_decode.py`` on the port).

Two drafts over the target's vocab: a smaller model (1 layer, dim 16)
whose proposals are almost always rejected, and the target's own weights
plus 5% noise, which accepts about 40% of its proposals, so full, partial
and empty acceptance, catch-up rows of 1 and 2 and rollbacks all run.

Tolerances: logits and written K/V at rtol = atol = 1e-4 (float32, the
same math summed in another order; observed ~1e-6); proposals equal.
Streams compare under the margin rule (``torch_parity.
assert_greedy_agrees``, tol 1e-4) against solo contiguous runs in the
port: a verify forward scores k + 1 positions at once and a plain step
one, so their sums differ in order. Page accounting is exact: once every
request has ended, every target page is free or pinned by the prefix
index and every draft page is free."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama_decode as jd
from ray_tpu.serve.decode import DecodeEngine as JaxEngine
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models import llama_decode as td
from ray_tpu_torch.serve.decode import DecodeEngine, LlamaDecodeDeployment
from torch_parity import (assert_greedy_agrees, greedy_with_margins,
                          one_torch_thread, tiny_pair)  # noqa: F401

TOL = 1e-4
CLOSE = dict(rtol=1e-4, atol=1e-4)
VOCAB = 61
POOL_PAGES = 24


pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair("f32", max_seq_len=1024)


@pytest.fixture(scope="module")
def small_draft():
    return tiny_pair("f32", seed=1, dim=16, n_layers=1, n_heads=2,
                     n_kv_heads=1, mlp_dim=32, max_seq_len=1024)


@pytest.fixture(scope="module")
def noisy_draft(tiny):
    """The target's weights plus noise of 5% of each tensor's spread."""
    jcfg, jp, tcfg, _ = tiny
    rng = np.random.default_rng(5)
    weights = jax.tree.map(
        lambda a: np.asarray(a) + 0.05 * np.asarray(a).std()
        * rng.standard_normal(a.shape).astype(np.float32), jp)
    return (jcfg, jax.tree.map(jnp.asarray, weights), tcfg,
            tl.params_from_numpy(weights, tcfg, device="cpu"))


@pytest.fixture
def drafts(small_draft, noisy_draft):
    return {"small": small_draft, "noisy": noisy_draft}


def _engine(tp, tcfg, draft=None, k=4, **kw):
    kw.setdefault("slots", 4)
    kw.setdefault("capacity", 256)
    kw.setdefault("page_tokens", 16)
    kw.setdefault("prefix_pool_entries", 0)
    if draft is not None:
        kw.update(spec_draft_config=draft[2], spec_draft_params=draft[3],
                  spec_k=k)
    return DecodeEngine(tp, tcfg, device="cpu", **kw)


def _drive(eng, reqs, budget=2000):
    for _ in range(budget):
        if all(r.done.is_set() for r in reqs):
            return
        eng.step()
    raise AssertionError(f"requests not done in {budget} steps: "
                         f"{[r.status for r in reqs]}")


def _run(eng, prompts, n, **submit_kw):
    reqs = [eng.submit(p, max_new_tokens=n, **submit_kw) for p in prompts]
    _drive(eng, reqs)
    return reqs


def _prompts(seed, *lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, n).tolist() for n in lengths]


def _check_solo(tcfg, tp, prompt, req):
    assert req.status == "completed", req.status
    want, margins = greedy_with_margins(tcfg, tp, prompt, len(req.output))
    assert_greedy_agrees(req.output, want, margins, TOL)


def _assert_rolled_back(eng):
    """After a step, each active slot holds the pages its committed
    tokens cover in the target pool, and in the draft pool the pages its
    draft's committed tokens cover: a round's tail pages went back."""
    for slot, req in eng._active.items():
        L = req.prompt_len + req.generated - 1
        assert len(eng._slot_pages[slot]) == eng._seq_pages(L), slot
        D = eng._draft_committed[slot]
        want = eng._seq_pages(D) if D >= 0 else 0
        assert len(eng._draft_slot_pages[slot]) == want, slot


def _assert_pools_drained(eng):
    s = eng.stats()
    assert s["active"] == s["prefilling"] == s["queued"] == 0
    assert s["pages_in_use"] == s["pages_pinned"], "leaked target pages"
    assert s["spec"]["draft_pages_free"] == s["spec"]["draft_pages_total"], \
        "leaked draft pages"


# ----------------------------------------------------- model functions


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x.astype(jnp.float32))


def _logical(pool, bt, key):
    k = _np(pool[key])[:, bt]                       # (L, B, W, T, KV, D)
    L, B, W, T = k.shape[:4]
    return k.reshape(L, B, W * T, *k.shape[4:])


def _assert_rows_match(jpool, tpool, bt, upto):
    for key in ("k", "v"):
        j, t = _logical(jpool, bt, key), _logical(tpool, bt, key)
        for b, n in enumerate(upto):
            np.testing.assert_allclose(t[:, b, :n], j[:, b, :n], **CLOSE)


def _filled_pools(jcfg, jp, tcfg, tp, T, bt, lengths, seed):
    """Both pools with each row's first ``lengths[b]`` positions
    prefilled through ``bt``."""
    S = max(8, -(-max(lengths) // 8) * 8)
    toks = np.random.default_rng(seed).integers(
        1, VOCAB, (len(lengths), S)).astype(np.int32)
    lens = np.maximum(np.asarray(lengths, np.int32), 1)
    W = -(-S // T)
    wide = np.zeros((len(lengths), max(W, bt.shape[1])), np.int32)
    wide[:, :bt.shape[1]] = bt
    jpool = jd.init_page_pool(jcfg, POOL_PAGES, T)
    tpool = td.init_page_pool(tcfg, POOL_PAGES, T, device="cpu")
    _, jpool = jd.paged_prefill(jp, jnp.asarray(toks), jpool,
                                jnp.asarray(wide[:, :W]), jcfg,
                                jnp.asarray(lens))
    td.paged_prefill(tp, torch.from_numpy(toks), tpool,
                     torch.from_numpy(wide[:, :W]), tcfg,
                     torch.from_numpy(lens))
    return jpool, tpool


def _tables(T, width, pages_per_row, seed):
    """Shuffled page ids, ``pages_per_row[b]`` of them for row b; the
    rest of its columns are the scratch page 0."""
    ids = np.random.default_rng(seed).permutation(
        np.arange(1, POOL_PAGES + 1)).astype(np.int32)
    bt = np.zeros((len(pages_per_row), width), np.int32)
    used = 0
    for b, n in enumerate(pages_per_row):
        bt[b, :n] = ids[used:used + n]
        used += n
    return bt


@pytest.mark.parametrize("T", [4, 8])
def test_paged_verify_matches_jax(tiny, T):
    """Four rows verify k + 1 = 5 positions: row 0 crosses a page
    boundary inside the round, row 1 starts on one, row 2 is idle (cursor
    0, an all-scratch block table) and row 3's round runs past the block
    table's window, whose writes must go to the scratch page, never into
    its last live page. Logits at every position of the live rows and the
    K/V they wrote against JAX; the verify's logits against five plain
    decode steps of the port."""
    jcfg, jp, tcfg, tp = tiny
    W = 16 // T
    prefix = np.array([T - 2, T, 0, 16 - 2], np.int32)
    S = 5
    bt = _tables(T, W, [W, W, 0, W], seed=T)
    jpool, tpool = _filled_pools(jcfg, jp, tcfg, tp, T, bt, prefix, seed=1)
    rows = np.random.default_rng(2).integers(1, VOCAB, (4, S)).astype(
        np.int32)
    jl, jpool = jd.paged_verify(jp, jnp.asarray(rows), jpool,
                                jnp.asarray(bt), jcfg, jnp.asarray(prefix))
    tl_, tpool = td.paged_verify(tp, torch.from_numpy(rows), tpool,
                                 torch.from_numpy(bt), tcfg,
                                 torch.from_numpy(prefix))
    assert tuple(tl_.shape) == (4, S, VOCAB) and tl_.dtype == torch.float32
    live = [0, 1, 3]
    np.testing.assert_allclose(_np(tl_)[live], _np(jl)[live], **CLOSE)
    _assert_rows_match(jpool, tpool, bt[live],
                       np.minimum(prefix[live] + S, W * T))
    # The same five tokens through sequential paged decode steps.
    _, pool = _filled_pools(jcfg, jp, tcfg, tp, T, bt, prefix, seed=1)
    lens = torch.from_numpy(prefix)
    for j in range(S):
        step, pool, lens = td.paged_decode_step(
            tp, pool, torch.from_numpy(bt), lens,
            torch.from_numpy(rows[:, j]), tcfg)
        torch.testing.assert_close(step[live], tl_[live, j], rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("T", [4, 8])
def test_paged_spec_draft_matches_jax(tiny, T):
    """Rows with a 1-long and a 2-long catch-up row across page
    boundaries, beside an idle row: the proposals equal JAX's, and the
    K/V of the catch-up and proposal positions match."""
    jcfg, jp, tcfg, tp = tiny
    k = 4
    W = 24 // T
    lengths = np.array([T - 1, 2 * T - 2, 0], np.int32)
    clens = np.array([1, 2, 1], np.int32)
    bt = _tables(T, W, [W, W, 0], seed=10 + T)
    jpool, tpool = _filled_pools(jcfg, jp, tcfg, tp, T, bt, lengths,
                                 seed=3)
    catchup = np.random.default_rng(4).integers(1, VOCAB, (3, 2)).astype(
        np.int32)
    jt, jpool = jd.paged_spec_draft(
        jp, jpool, jnp.asarray(bt), jnp.asarray(lengths),
        jnp.asarray(catchup), jnp.asarray(clens), jcfg, k)
    tt, tpool = td.paged_spec_draft(
        tp, tpool, torch.from_numpy(bt), torch.from_numpy(lengths),
        torch.from_numpy(catchup), torch.from_numpy(clens), tcfg, k)
    assert tt.dtype == torch.int32 and tuple(tt.shape) == (3, k)
    np.testing.assert_array_equal(tt.numpy()[:2], np.asarray(jt)[:2])
    _assert_rows_match(jpool, tpool, bt[:2], (lengths + clens + k - 1)[:2])


# ------------------------------------------------------------- engine


@pytest.mark.parametrize("kind", ["small", "noisy"])
def test_spec_streams_agree_with_plain_and_jax(tiny, drafts, kind):
    """Prompts of 5, 15, 17 and 30 tokens on 16-token pages with k = 4:
    rounds write across page boundaries. The spec streams agree with the
    port's plain paged engine and with the JAX spec engine on the same
    weights, and the rounds, proposals and acceptances equal the JAX
    engine's."""
    jcfg, jp, tcfg, tp = tiny
    draft = drafts[kind]
    prompts = _prompts(7, 5, 15, 17, 30)
    plain = _run(_engine(tp, tcfg), prompts, 24)
    spec = _engine(tp, tcfg, draft)
    got = [spec.submit(p, max_new_tokens=24) for p in prompts]
    while not all(r.done.is_set() for r in got):
        spec.step()
        _assert_rolled_back(spec)
    jeng = JaxEngine(jp, jcfg, slots=4, capacity=256, page_tokens=16,
                     prefix_pool_entries=0, spec_draft_params=draft[1],
                     spec_draft_config=draft[0], spec_k=4)
    jreqs = _run(jeng, prompts, 24)
    for p, a, b, c in zip(prompts, plain, got, jreqs):
        want, margins = greedy_with_margins(tcfg, tp, p, 24)
        for other in (a, c):
            assert_greedy_agrees(b.output, other.output, margins, TOL)
        _check_solo(tcfg, tp, p, b)
    s, js = spec.stats()["spec"], jeng.stats()["spec"]
    for key in ("rounds", "proposed_tokens", "accepted_tokens"):
        assert s[key] == js[key], (key, s, js)
    assert spec.tokens_out == 4 * 24 and s["rounds"] > 0
    if kind == "noisy":
        assert 0 < s["accepted_tokens"] < s["proposed_tokens"]
    _assert_pools_drained(spec)


def test_perfect_draft_accepts_everything(tiny):
    """Draft == target: every proposal is accepted and the target runs
    about 1/(k+1) as many forwards as the plain engine's steps. The
    longest prompt's first round writes its last proposal's K/V at
    position 32, the first of a page, which the draft's block-table
    slice must reach."""
    _, _, tcfg, tp = tiny
    prompts = _prompts(3, 6, 13, 21, 29)
    plain_eng = _engine(tp, tcfg)
    plain = _run(plain_eng, prompts, 24)
    spec = _engine(tp, tcfg, (None, None, tcfg, tp))
    got = _run(spec, prompts, 24)
    for p, a, b in zip(prompts, plain, got):
        want, margins = greedy_with_margins(tcfg, tp, p, 24)
        assert_greedy_agrees(b.output, a.output, margins, TOL)
    assert spec.stats()["spec"]["accept_rate"] == 1.0
    assert spec.steps * 3 < plain_eng.steps
    _assert_pools_drained(spec)


def test_eos_and_max_tokens_truncate_mid_round(tiny):
    """An EOS inside an accepted run cuts the stream where sequential
    decode would; max_new_tokens = 6 ends a k = 4 round part way."""
    _, _, tcfg, tp = tiny
    prompts = _prompts(11, 8, 19)
    ref = _run(_engine(tp, tcfg), prompts, 20)
    eos = ref[0].output[4]  # the 5th token: inside the first full round
    want = _run(_engine(tp, tcfg), prompts, 20, eos_id=eos)
    spec = _engine(tp, tcfg, (None, None, tcfg, tp))
    got = _run(spec, prompts, 20, eos_id=eos)
    for w, g in zip(want, got):
        assert g.output == w.output
    assert got[0].output[-1] == eos and len(got[0].output) <= 5
    for p, r in zip(prompts, _run(spec, prompts, 6)):
        assert len(r.output) == 6
        _check_solo(tcfg, tp, p, r)
    _assert_pools_drained(spec)


def test_rollback_soak_leaks_no_pages(tiny, noisy_draft):
    """240 randomized steps on overcommitted pools with a half-right
    draft: admissions, cancels and deadlines land mid-round, rejected
    tails roll both pools back, the target pool may preempt and the draft
    pool evict. Completed streams agree with their solo runs, and both
    pools drain."""
    _, _, tcfg, tp = tiny
    rng = np.random.default_rng(42)
    eng = _engine(tp, tcfg, noisy_draft, pool_pages=48,
                  spec_draft_pool_pages=24, prefix_pool_entries=4,
                  prefix_match_min_tokens=16)
    live, done, submitted = [], [], 0
    for _ in range(240):
        if submitted < 20 and rng.random() < 0.3 and len(live) < 8:
            prompt = rng.integers(1, VOCAB, int(rng.integers(3, 60))).tolist()
            n = int(rng.integers(1, 28))
            dl = 0.02 if rng.random() < 0.08 else None
            live.append((eng.submit(prompt, max_new_tokens=n,
                                    deadline_s=dl), prompt))
            submitted += 1
        if live and rng.random() < 0.06:
            eng.cancel(live[int(rng.integers(len(live)))][0].request_id)
        eng.step()
        done += [e for e in live if e[0].done.is_set()]
        live = [e for e in live if not e[0].done.is_set()]
    _drive(eng, [r for r, _ in live])
    done += live
    completed = [(r, p) for r, p in done if r.status == "completed"]
    for req, prompt in completed:
        _check_solo(tcfg, tp, prompt, req)
    assert len(completed) >= 5
    s = eng.stats()["spec"]
    assert s["rounds"] > 20
    assert 0 < s["accepted_tokens"] < s["proposed_tokens"]
    assert eng.cancelled + eng.deadline_exceeded > 0
    _assert_pools_drained(eng)


def test_spec_composes_with_prefix_cache(tiny, noisy_draft):
    """A second prompt sharing a cached prefix splices the target's pages
    while the draft prefills the whole prompt (it has no prefix index)."""
    _, _, tcfg, tp = tiny
    (shared,) = _prompts(9, 48)
    prompts = [shared + [7], shared + [11, 5]]
    spec = _engine(tp, tcfg, noisy_draft, k=3, prefix_pool_entries=4,
                   prefix_match_min_tokens=16)
    got = [_run(spec, [p], 16)[0] for p in prompts]
    for p, r in zip(prompts, got):
        _check_solo(tcfg, tp, p, r)
    assert spec.stats()["prefix"]["hits"] >= 1 and got[1].prefix_len >= 16
    assert spec.stats()["spec"]["accepted_tokens"] > 0
    _assert_pools_drained(spec)


def test_spec_composes_with_chunked_prefill(tiny, noisy_draft):
    """A long prompt prefills in chunks while a short one decodes in spec
    rounds: the mid-prefill slot's verify and draft rows write only its
    own or the scratch page, and both streams agree."""
    _, _, tcfg, tp = tiny
    short_p, long_p = _prompts(13, 6, 150)
    spec = _engine(tp, tcfg, noisy_draft, prefill_chunk_tokens=32,
                   capacity=512)
    r_short = spec.submit(short_p, max_new_tokens=24)
    spec.step()
    r_long = spec.submit(long_p, max_new_tokens=12)
    rounds_during_chunks = 0
    while r_long.slot in spec._prefilling or r_long.slot < 0:
        before = spec.spec_rounds
        spec.step()
        rounds_during_chunks += spec.spec_rounds - before
    _drive(spec, [r_short, r_long])
    assert spec.prefill_chunks > 0 and rounds_during_chunks > 0
    _check_solo(tcfg, tp, short_p, r_short)
    _check_solo(tcfg, tp, long_p, r_long)
    _assert_pools_drained(spec)


@pytest.mark.parametrize("device_sampler", [False, True])
def test_mixed_temperature_falls_back_and_resyncs(tiny, noisy_draft,
                                                  device_sampler):
    """A sampled request parks spec on the plain path; when it ends, the
    greedy slot's draft is several tokens behind and is rebuilt by a
    resync prefill. The greedy stream agrees throughout, and with the
    device sampler no step feeds a token the host has overwritten."""
    _, _, tcfg, tp = tiny
    greedy_p, sampled_p = _prompts(17, 9, 5)
    spec = _engine(tp, tcfg, noisy_draft, k=3,
                   device_sampler=device_sampler)
    resyncs = []
    resync = spec._draft_resync

    def counted(slot, req):
        resyncs.append(slot)
        return resync(slot, req)

    spec._draft_resync = counted
    r_g = spec.submit(greedy_p, max_new_tokens=40)
    r_s = spec.submit(sampled_p, max_new_tokens=6, temperature=0.9)
    _drive(spec, [r_g, r_s])
    _check_solo(tcfg, tp, greedy_p, r_g)
    assert len(r_s.output) == 6 and all(0 <= t < VOCAB for t in r_s.output)
    assert resyncs and spec.stats()["spec"]["rounds"] > 0
    _assert_pools_drained(spec)


def test_draftless_slots_stay_exact(tiny, small_draft):
    """A draft pool too small to seat any prompt demotes every slot to
    draftless: rounds fall back to plain steps, nothing is counted as
    proposed, and no page leaks."""
    _, _, tcfg, tp = tiny
    prompts = _prompts(19, 40, 50)
    spec = _engine(tp, tcfg, small_draft, k=3, spec_draft_pool_pages=2)
    got = _run(spec, prompts, 12)
    for p, r in zip(prompts, got):
        _check_solo(tcfg, tp, p, r)
    s = spec.stats()["spec"]
    assert s["proposed_tokens"] == 0 and s["draft_demotions"] == 2
    _assert_pools_drained(spec)


def test_draft_eviction_and_a_draftless_neighbour(tiny, noisy_draft):
    """A draft pool that seats one prompt: the second admission evicts
    the first's draft seat, and rounds run with one drafted and one
    draftless slot. Both streams agree; only the drafted slot counts."""
    _, _, tcfg, tp = tiny
    prompts = _prompts(21, 40, 30)
    spec = _engine(tp, tcfg, noisy_draft, k=3, spec_draft_pool_pages=4)
    got = _run(spec, prompts, 16)
    for p, r in zip(prompts, got):
        _check_solo(tcfg, tp, p, r)
    s = spec.stats()["spec"]
    assert s["draft_demotions"] >= 1 and s["rounds"] > 0
    assert got[0].spec_proposed == 0 < got[1].spec_proposed
    _assert_pools_drained(spec)


def test_round_at_the_capacity_edge(tiny, noisy_draft):
    """prompt + max_new_tokens == capacity: the last rounds' positions
    past the slot's pages go to the scratch page, and the stream ends at
    its budget."""
    _, _, tcfg, tp = tiny
    (prompt,) = _prompts(23, 50)
    spec = _engine(tp, tcfg, noisy_draft, capacity=64)
    (req,) = _run(spec, [prompt], 14)
    _check_solo(tcfg, tp, prompt, req)
    _assert_pools_drained(spec)


def test_contiguous_engine_with_spec_raises(tiny, small_draft):
    _, _, tcfg, tp = tiny
    with pytest.raises(ValueError, match="paged"):
        _engine(tp, tcfg, small_draft, page_tokens=0)


def test_warmup_marks_keys_zeroes_lengths_then_streams_agree(
        tiny, noisy_draft):
    _, _, tcfg, tp = tiny
    spec = _engine(tp, tcfg, noisy_draft, k=3, decode_chunk=4,
                   device_sampler=True)
    spec.warmup()
    for key in [("decode",), ("decode_k", 2), ("decode_k", 4),
                ("decode_sampled",), ("spec_draft", 3), ("spec_verify", 3),
                ("paged_prefill", 1, 128)]:
        assert key in spec._compiled, key
    assert not spec.cache["length"].any()
    assert not spec._draft_cache["length"].any()
    assert spec.stats()["pages_free"] == spec.pool_pages
    prompts = _prompts(31, 10, 20)
    for p, r in zip(prompts, _run(spec, prompts, 10)):
        _check_solo(tcfg, tp, p, r)
    contiguous = _engine(tp, tcfg, page_tokens=0, decode_chunk=2,
                         device_sampler=True)
    contiguous.warmup()
    assert {("decode",), ("decode_k", 2), ("decode_sampled",)} \
        <= contiguous._compiled
    assert not contiguous.cache["length"].any()
    for p, r in zip(prompts, _run(contiguous, prompts, 10)):
        _check_solo(tcfg, tp, p, r)
    spec.submit(prompts[0], max_new_tokens=40)
    spec.step()
    with pytest.raises(RuntimeError, match="idle"):
        spec.warmup()


def test_deployment_takes_spec_knobs(tiny):
    """The deployment seeds the draft from seed + 1, runs warmup before
    its loop starts and answers through spec rounds; a draft preset over
    another vocab is refused."""
    from dataclasses import replace

    _, _, tcfg, _ = tiny
    cfg = replace(tl.PRESETS["debug"], max_seq_len=512)
    dep = LlamaDecodeDeployment(config=cfg, spec_draft_model="debug",
                                spec_k=3, kv_page_tokens=16,
                                kv_pool_pages=32, spec_draft_pool_pages=16,
                                warmup=True, seed=3, device="cpu")
    try:
        eng = dep.engine
        assert eng.spec and eng.spec_k == 3 and eng.draft_pool_pages == 16
        assert ("spec_verify", 3) in eng._compiled
        want = tl.init_params(tl.PRESETS["debug"], device="cpu", seed=4)
        for name in ("tok_embed", "lm_head"):
            assert torch.equal(eng._draft_params[name], want[name])
        prompt = list(range(1, 21))
        out = dep({"tokens": prompt, "max_new_tokens": 8})
        assert len(out["tokens"]) == 8
    finally:
        dep.shutdown()
    # Read after the loop stopped: it records a step after its stream ends.
    assert eng.stats()["spec"]["rounds"] > 0
    phases = {p["phase"] for r in dep.timeline()["rows"]
              for p in r["phases"]}
    assert {"draft", "verify"} <= phases
    with pytest.raises(ValueError, match="vocab"):
        LlamaDecodeDeployment(config=tcfg, spec_draft_model="debug",
                              spec_k=2, kv_page_tokens=16, device="cpu")
