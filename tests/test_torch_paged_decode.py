"""The port's paged KV functions and batched sampler vs
``ray_tpu.models.llama_decode`` on a tiny config, same weights and inputs.

Block tables use shuffled, non-contiguous page ids; prompts cross page
boundaries at page sizes 4 and 8; suffix buckets overhang the block
table's window, so their pad writes must land on the scratch page 0.
Pool contents are compared in logical order (each row's pages gathered
through its block table) below each row's real length: past it both sides
hold pad junk, which is masked.

Tolerances: float32 logits and K/V at rtol = atol = 1e-4 (same math, fp32
sums in another order; observed differences ~1e-6); bf16 logits at 5e-2
(activations rounded to bf16 between layers on both sides). The port's
paged path against its own contiguous path: 1e-5 (the same values, masked
tails of other widths add exact zeros)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama_decode as jd
from ray_tpu_torch.models import llama_decode as td
from torch_parity import tiny_pair

TOL = dict(rtol=1e-4, atol=1e-4)
SELF_TOL = dict(rtol=1e-5, atol=1e-5)
POOL_PAGES = 24


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x.astype(jnp.float32))


def _pools(jcfg, tcfg, T, pages=POOL_PAGES):
    return (jd.init_page_pool(jcfg, pages, T),
            td.init_page_pool(tcfg, pages, T, device="cpu"))


def _block_tables(lengths, width, T, seed):
    """Shuffled page ids: row b owns ceil(len_b / T) pages of a random
    permutation of 1..POOL_PAGES, the rest of its columns are the scratch
    page 0."""
    ids = np.random.default_rng(seed).permutation(
        np.arange(1, POOL_PAGES + 1)).astype(np.int32)
    bt = np.zeros((len(lengths), width), np.int32)
    used = 0
    for b, n in enumerate(lengths):
        need = -(-int(n) // T)
        bt[b, :need] = ids[used:used + need]
        used += need
    assert used <= POOL_PAGES
    return bt


def _logical(pool, bt):
    """Each row's pages in logical order: (L, B, W * T, KV, D) numpy."""
    k = _np(pool["k"])
    out = k[:, bt]                                  # (L, B, W, T, KV, D)
    L, B, W, T = out.shape[:4]
    return out.reshape(L, B, W * T, *out.shape[4:])


def _assert_rows_match(jpool, tpool, bt, lengths):
    for key in ("k", "v"):
        j = _logical({"k": jpool[key]}, bt)
        t = _logical({"k": tpool[key]}, bt)
        for b, n in enumerate(lengths):
            np.testing.assert_allclose(t[:, b, :n], j[:, b, :n], **TOL)


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(1, 61, (b, s)).astype(
        np.int32)


def _prefill_both(jcfg, jp, tcfg, tp, T, toks, lengths, bt):
    jpool, tpool = _pools(jcfg, tcfg, T)
    jl, jpool = jd.paged_prefill(jp, jnp.asarray(toks), jpool,
                                 jnp.asarray(bt), jcfg,
                                 jnp.asarray(lengths))
    tl, tpool = td.paged_prefill(tp, torch.from_numpy(toks), tpool,
                                 torch.from_numpy(bt), tcfg,
                                 torch.from_numpy(lengths))
    return jl, jpool, tl, tpool


@pytest.fixture(scope="module")
def tiny():
    return tiny_pair("f32")


@pytest.mark.parametrize("T", [4, 8])
def test_init_page_pool_shape(tiny, T):
    jcfg, _, tcfg, _ = tiny
    jpool, tpool = _pools(jcfg, tcfg, T)
    assert tuple(tpool["k"].shape) == tuple(jpool["k"].shape) == (
        tcfg.n_layers, POOL_PAGES + 1, T, tcfg.n_kv_heads, tcfg.head_dim)
    assert tpool["v"].dtype == tcfg.dtype and not tpool["k"].any()


@pytest.mark.parametrize("T", [4, 8])
def test_paged_prefill_matches_jax(tiny, T):
    """Prompts of 13 and 7 tokens in a 16-token bucket: each row owns only
    the pages its real length covers, so its pad positions scatter into
    its own tail page or the scratch page."""
    jcfg, jp, tcfg, tp = tiny
    toks = _tokens(2, 16, seed=0)
    lengths = np.array([13, 7], np.int32)
    bt = _block_tables(lengths, 16 // T, T, seed=1)
    jl, jpool, tl, tpool = _prefill_both(jcfg, jp, tcfg, tp, T, toks,
                                         lengths, bt)
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _assert_rows_match(jpool, tpool, bt, lengths)
    # Pages nobody owns stay untouched.
    owned = set(bt.ravel().tolist()) | {0}
    for p in range(POOL_PAGES + 1):
        if p not in owned:
            assert not tpool["k"][:, p].any() and not tpool["v"][:, p].any()


@pytest.mark.parametrize("T", [4, 8])
def test_paged_prefill_suffix_matches_jax_with_overhang(tiny, T):
    """Row 0's suffix bucket overhangs the block table's window (prefix 20
    + bucket 16 > 32 positions): those pad writes must go to the scratch
    page, never clamped into the row's last live page."""
    jcfg, jp, tcfg, tp = tiny
    full = _tokens(2, 32, seed=2)
    prefix_lens = np.array([20, 8], np.int32)
    lengths = np.array([28, 19], np.int32)
    width = 32 // T
    bt = _block_tables(lengths, width, T, seed=3)
    pre = np.zeros((2, 24), np.int32)
    for b in range(2):
        pre[b, :prefix_lens[b]] = full[b, :prefix_lens[b]]
    _, jpool, _, tpool = _prefill_both(jcfg, jp, tcfg, tp, T, pre,
                                       prefix_lens, bt)
    suffix = np.zeros((2, 16), np.int32)
    for b in range(2):
        n = lengths[b] - prefix_lens[b]
        suffix[b, :n] = full[b, prefix_lens[b]:lengths[b]]
    jl, jpool = jd.paged_prefill_suffix(
        jp, jnp.asarray(suffix), jpool, jnp.asarray(bt), jcfg,
        jnp.asarray(prefix_lens), jnp.asarray(lengths))
    tl, tpool = td.paged_prefill_suffix(
        tp, torch.from_numpy(suffix), tpool, torch.from_numpy(bt), tcfg,
        torch.from_numpy(prefix_lens), torch.from_numpy(lengths))
    np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    _assert_rows_match(jpool, tpool, bt, lengths)
    # The split prefill equals one full prefill of the same prompts.
    fl, _ = td.paged_prefill(
        tp, torch.from_numpy(full), td.init_page_pool(tcfg, POOL_PAGES, T,
                                                      device="cpu"),
        torch.from_numpy(bt), tcfg, torch.from_numpy(lengths))
    np.testing.assert_allclose(tl.numpy(), fl.numpy(), **TOL)


@pytest.mark.parametrize("T", [4, 8])
def test_paged_decode_steps_match_jax(tiny, T):
    """Three rows decode 6 steps across page boundaries (lengths 7, 3 and
    12 at T = 4 or 8), beside an idle row parked at 0 on an all-scratch
    block table; logits, lengths and pool contents against JAX."""
    jcfg, jp, tcfg, tp = tiny
    toks = _tokens(4, 16, seed=4)
    lengths = np.array([7, 3, 12, 0], np.int32)
    width = 24 // T
    bt = _block_tables([7 + 6, 3 + 6, 12 + 6, 0], width, T, seed=5)
    jl, jpool, tl, tpool = _prefill_both(
        jcfg, jp, tcfg, tp, T, toks, lengths.clip(min=1), bt)
    jlen = jnp.asarray(lengths)
    tlen = torch.from_numpy(lengths)
    nxt = np.array([4, 7, 9, 0], np.int32)
    for _ in range(6):
        jlog, jpool, jlen = jd.paged_decode_step(
            jp, jpool, jnp.asarray(bt), jlen, jnp.asarray(nxt), jcfg)
        tlog, tpool, tlen = td.paged_decode_step(
            tp, tpool, torch.from_numpy(bt), tlen, torch.from_numpy(nxt),
            tcfg)
        np.testing.assert_allclose(_np(tlog)[:3], _np(jlog)[:3], **TOL)
        nxt = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    assert tlen.dtype == torch.int32
    _assert_rows_match(jpool, tpool, bt, lengths[:3] + 6)


def test_paged_decode_chunk_matches_jax(tiny):
    jcfg, jp, tcfg, tp = tiny
    T = 4
    toks = _tokens(2, 8, seed=6)
    lengths = np.array([8, 5], np.int32)
    bt = _block_tables([8 + 5, 5 + 5], 4, T, seed=7)
    _, jpool, _, tpool = _prefill_both(jcfg, jp, tcfg, tp, T, toks,
                                       lengths, bt)
    nxt = np.array([3, 11], np.int32)
    jt, jpool, jlen = jd.paged_decode_chunk(
        jp, jpool, jnp.asarray(bt), jnp.asarray(lengths), jnp.asarray(nxt),
        jcfg, 5)
    tt, tpool, tlen = td.paged_decode_chunk(
        tp, tpool, torch.from_numpy(bt), torch.from_numpy(lengths),
        torch.from_numpy(nxt), tcfg, 5)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    _assert_rows_match(jpool, tpool, bt, lengths + 5)


@pytest.mark.parametrize("T", [4, 8])
def test_paged_matches_port_contiguous(tiny, T):
    """The port's paged prefill + decode against its own contiguous
    prefill + decode, while the sequence crosses page boundaries."""
    _, _, tcfg, tp = tiny
    prompt = torch.from_numpy(_tokens(1, 13, seed=8))
    cont = td.init_cache(tcfg, 1, 64, device="cpu")
    lc, cont = td.prefill(tp, prompt, cont, tcfg)
    pool = td.init_page_pool(tcfg, 64 // T, T, device="cpu")
    bt = torch.from_numpy(
        np.random.default_rng(9).permutation(np.arange(1, 64 // T + 1))
        .astype(np.int32)[None])
    lp, pool = td.paged_prefill(tp, prompt, pool, bt[:, :-(-13 // T)], tcfg)
    torch.testing.assert_close(lp, lc, **SELF_TOL)
    lens = torch.tensor([13], dtype=torch.int32)
    tok = torch.argmax(lc, -1).to(torch.int32)
    for _ in range(12):  # 13 -> 25 tokens
        la, cont = td.decode_step(tp, cont, tok, tcfg)
        # Slice the block table to the pages the live row needs, as the
        # engine does.
        w = -(-(int(lens[0]) + 1) // T)
        lb, pool, lens = td.paged_decode_step(tp, pool, bt[:, :w], lens, tok,
                                              tcfg)
        torch.testing.assert_close(lb, la, **SELF_TOL)
        tok = torch.argmax(la, -1).to(torch.int32)


def test_pad_and_idle_writes_touch_no_live_page(tiny):
    """A live row outside the call owns pages 1-4. A full prefill whose
    rows own pages 5-7 with pad positions past their pages, a suffix wave
    overhanging its window, and a decode step with idle rows (all-scratch
    block tables) and a cursor parked past the window must leave pages
    1-4 bit-identical; every stray write lands on page 0."""
    _, _, tcfg, tp = tiny
    T = 4
    pool = td.init_page_pool(tcfg, 7, T, device="cpu")
    live = _tokens(1, 16, seed=10)
    td.paged_prefill(tp, torch.from_numpy(live), pool,
                     torch.tensor([[1, 2, 3, 4]], dtype=torch.int32), tcfg)
    snap_k, snap_v = pool["k"][:, 1:5].clone(), pool["v"][:, 1:5].clone()

    def untouched():
        return (torch.equal(pool["k"][:, 1:5], snap_k)
                and torch.equal(pool["v"][:, 1:5], snap_v))

    # Two 16-token buckets whose rows own 2 and 1 pages.
    bt = torch.tensor([[5, 6, 0, 0], [7, 0, 0, 0]], dtype=torch.int32)
    toks = torch.from_numpy(_tokens(2, 16, seed=11))
    td.paged_prefill(tp, toks, pool, bt, tcfg,
                     lengths=torch.tensor([6, 3], dtype=torch.int32))
    assert untouched()
    # Suffix from 6 / 3 with an 8-token bucket on 2-page windows.
    td.paged_prefill_suffix(tp, toks[:, :8], pool, bt[:, :2], tcfg,
                            torch.tensor([6, 3]), torch.tensor([8, 4]))
    assert untouched()
    # Decode: rows 0-1 live, row 2 idle at 0, row 3 parked at 40 (past
    # the 2-page window).
    bt4 = torch.cat([bt[:, :2], torch.zeros(2, 2, dtype=torch.int32)])
    td.paged_decode_step(tp, pool, bt4, torch.tensor([8, 4, 0, 40]),
                         torch.tensor([1, 2, 3, 4]), tcfg)
    assert untouched()
    assert pool["k"][:, 0].any()  # the strays did land on the scratch page


def test_paged_bf16_close(tiny):
    """bf16 end to end: paged prefill and suffix logits within 5e-2."""
    jcfg, jp, tcfg, tp = tiny_pair("bf16")
    T = 8
    full = _tokens(2, 24, seed=12)
    lengths = np.array([24, 17], np.int32)
    prefix = np.array([16, 8], np.int32)
    bt = _block_tables(lengths, 4, T, seed=13)
    pre = np.zeros((2, 16), np.int32)
    for b in range(2):
        pre[b, :prefix[b]] = full[b, :prefix[b]]
    jl, jpool, tl, tpool = _prefill_both(jcfg, jp, tcfg, tp, T, pre, prefix,
                                         bt)
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=5e-2)
    suffix = np.zeros((2, 16), np.int32)
    for b in range(2):
        suffix[b, :lengths[b] - prefix[b]] = full[b, prefix[b]:lengths[b]]
    jl, _ = jd.paged_prefill_suffix(
        jp, jnp.asarray(suffix), jpool, jnp.asarray(bt), jcfg,
        jnp.asarray(prefix), jnp.asarray(lengths))
    tl, _ = td.paged_prefill_suffix(
        tp, torch.from_numpy(suffix), tpool, torch.from_numpy(bt), tcfg,
        torch.from_numpy(prefix), torch.from_numpy(lengths))
    np.testing.assert_allclose(_np(tl), _np(jl), rtol=0, atol=5e-2)


def test_paged_prefill_refuses_short_block_tables(tiny):
    _, _, tcfg, tp = tiny
    pool = td.init_page_pool(tcfg, 4, 4, device="cpu")
    with pytest.raises(ValueError, match="cover"):
        td.paged_prefill(tp, torch.ones(1, 16, dtype=torch.long), pool,
                         torch.tensor([[1, 2, 3]]), tcfg)


def test_sample_batch_greedy_lane_is_argmax():
    """Greedy rows (temperature <= 0) take the first maximum, like
    ``np.argmax`` and the JAX package's greedy lane, ties included."""
    logits = np.random.default_rng(14).normal(size=(5, 61)).astype(
        np.float32)
    logits[1, [3, 40]] = 9.0           # a tie: the first index wins
    logits[4, :] = 0.0                 # all tied
    temps = np.array([0.0, 0.0, -1.0, 0.0, 0.0], np.float32)
    got = td.sample_batch(torch.from_numpy(logits), torch.from_numpy(temps),
                          torch.Generator().manual_seed(0))
    want = jd.sample_batch(jnp.asarray(logits), jnp.asarray(temps),
                           jax.random.key(0))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.argmax(logits, -1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_batch_sampled_lane_repeats_under_one_seed():
    logits = torch.from_numpy(np.random.default_rng(15).normal(
        size=(64, 61)).astype(np.float32))
    temps = torch.full((64,), 1.0)
    temps[::4] = 0.0

    def draw(seed):
        return td.sample_batch(logits, temps,
                               torch.Generator().manual_seed(seed))

    a, b, c = draw(7), draw(7), draw(8)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert ((a >= 0) & (a < 61)).all()
    greedy = torch.argmax(logits, -1).to(torch.int32)
    assert torch.equal(a[::4], greedy[::4])
    # The sampled rows really sample at temperature 1 ...
    assert not torch.equal(a, greedy)
    # ... and collapse onto the argmax as the temperature falls.
    cold = td.sample_batch(logits, torch.full((64,), 1e-6),
                           torch.Generator().manual_seed(7))
    assert torch.equal(cold, greedy)


def test_sample_batch_follows_the_distribution():
    """1e5 draws over 4 classes at temperature 2: frequencies within
    0.01 of softmax(logits / 2) (a std of ~0.0015 each)."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]]).repeat(100_000, 1)
    got = td.sample_batch(logits, torch.full((100_000,), 2.0),
                          torch.Generator().manual_seed(16))
    freq = torch.bincount(got.long(), minlength=4).float() / 100_000
    want = torch.softmax(logits[0] / 2.0, dim=0)
    torch.testing.assert_close(freq, want, rtol=0, atol=1e-2)
