"""The port's ``serve/paging.py`` (PageAllocator, PagedPrefixIndex) against
``ray_tpu.serve.paging``: the JAX package's seven unit scenarios run on
both modules, and random operation sequences drive both side by side.

Host-side integer bookkeeping, so everything compares exactly: each
scenario records what it observes (page ids, refcounts, counts, match
results, stats) and the two modules' records must be equal."""

import numpy as np
import pytest

import ray_tpu.serve.paging as jpaging
import ray_tpu.serve.prefix_cache as jprefix
import ray_tpu_torch.serve.paging as tpaging
import ray_tpu_torch.serve.prefix_cache as tprefix

MODULES = {"jax_package": (jpaging, jprefix), "port": (tpaging, tprefix)}


def _allocator_alloc_free_incref(paging, prefix):
    pa = paging.PageAllocator(4)
    a = pa.alloc(3)
    assert len(a) == 3 and pa.free_count == 1 and pa.in_use == 3
    assert pa.alloc(2) is None          # all-or-nothing
    assert pa.free_count == 1           # a failed alloc grants nothing
    pa.incref(a[0])
    pa.free(a)                          # drops to refcount 1 on a[0]
    assert pa.free_count == 3 and pa.refcount(a[0]) == 1
    pa.free([a[0]])
    assert pa.free_count == 4 and pa.in_use == 0
    b = pa.alloc(4)
    assert sorted(b) == [1, 2, 3, 4]    # id 0 = scratch, reserved
    return [a, b, pa.stats()]


def _allocator_recycles_lifo(paging, prefix):
    pa = paging.PageAllocator(4)
    a = pa.alloc(2)
    pa.free([a[-1]])
    b = pa.alloc(1)
    assert b == [a[-1]]                 # most recently freed first
    return [a, b]


def _index_page_aligned_match_and_dedup(paging, prefix):
    pa = paging.PageAllocator(16)
    idx = paging.PagedPrefixIndex(pa, page_tokens=4, max_pages=8,
                                  min_tokens=4)
    toks = list(range(10, 29))          # 19 tokens
    pages = pa.alloc(5)
    # Insert grid = largest pow2 <= 19 = 16 tokens = 4 pages.
    assert idx.insert(toks, pages) == 4
    assert idx.insert(toks, pa.alloc(5)) == 0   # dedup on the token key
    got, mlen = idx.match(toks)
    assert mlen == 16 and got == pages[:4]      # page-aligned, in order
    refs = [pa.refcount(p) for p in got]
    assert min(refs) >= 3  # slot + index pin + match incref
    pa.free(got)                    # the borrower's release
    m2 = idx.match(toks[:9] + [99] * 6)
    assert m2 is not None and m2[1] == 8   # shorter shared prefix
    pa.free(m2[0])
    return [pages, got, mlen, refs, m2, idx.stats(), pa.stats()]


def _index_min_tokens_and_one_suffix_token(paging, prefix):
    pa = paging.PageAllocator(8)
    idx = paging.PagedPrefixIndex(pa, page_tokens=4, max_pages=8,
                                  min_tokens=8)
    toks = list(range(16))
    idx.insert(toks, pa.alloc(4))
    assert idx.match(toks[:8]) is None      # capped at len - 1 -> 4
    m = idx.match(toks)  # identical prompt: 16 -> capped at 15 -> 12
    assert m is not None and m[1] == 12
    pa.free(m[0])
    assert idx.match(toks[:5] + [99] * 8) is None  # 4 < min_tokens
    return [m, idx.stats()]


def _index_tail_eviction_shrinks_chain(paging, prefix):
    pa = paging.PageAllocator(16)
    idx = paging.PagedPrefixIndex(pa, page_tokens=4, max_pages=16,
                                  min_tokens=4)
    a_tokens = list(range(16))
    b_tokens = list(range(30, 46))
    a_pages = pa.alloc(4)
    b_pages = pa.alloc(4)
    idx.insert(a_tokens, a_pages)
    assert idx.match(b_tokens) is None
    idx.insert(b_tokens, b_pages)               # b is now most recent
    pa.free(a_pages)
    pa.free(b_pages)                            # only index pins remain
    assert idx.reclaim(1) == 1                  # evicts a's deepest leaf
    assert pa.free_count == 16 - 7
    ma = idx.match(a_tokens + [99])
    assert ma is not None and ma[1] == 12       # chain shrank 16 -> 12
    pa.free(ma[0])
    mb = idx.match(b_tokens + [99])
    assert mb is not None and mb[1] == 16       # b untouched
    pa.free(mb[0])
    return [ma, mb, idx.stats(), pa.stats()]


def _index_reclaim_skips_borrowed_pages(paging, prefix):
    pa = paging.PageAllocator(8)
    idx = paging.PagedPrefixIndex(pa, page_tokens=4, max_pages=8,
                                  min_tokens=4)
    pages = pa.alloc(2)
    idx.insert(list(range(8)), pages)   # refcount 2 on both (slot + pin)
    assert idx.reclaim(2) == 0          # the slot still borrows them
    pa.free(pages)                      # slot done
    assert idx.reclaim(2) == 2
    assert pa.free_count == 8
    return [pages, idx.stats(), pa.stats()]


def _index_hashes_on_pow2_grid(paging, prefix):
    pa = paging.PageAllocator(16)
    idx = paging.PagedPrefixIndex(pa, page_tokens=4, max_pages=16,
                                  min_tokens=4)
    toks = np.arange(100, 116, dtype=np.int32)
    idx.insert(toks, pa.alloc(4))
    # Chain entries at 4/8/12/16 tokens; advertised = pow2 lengths only.
    got = sorted(idx.hashes())
    assert got == sorted([prefix.prefix_hash(toks[:n]) for n in (4, 8, 16)])
    return got


SCENARIOS = [_allocator_alloc_free_incref, _allocator_recycles_lifo,
             _index_page_aligned_match_and_dedup,
             _index_min_tokens_and_one_suffix_token,
             _index_tail_eviction_shrinks_chain,
             _index_reclaim_skips_borrowed_pages,
             _index_hashes_on_pow2_grid]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__.lstrip("_") for f in SCENARIOS])
def test_scenario_matches_jax_package(scenario):
    want = scenario(*MODULES["jax_package"])
    got = scenario(*MODULES["port"])
    assert got == want


def test_prefix_hash_matches_jax_package():
    toks = np.random.default_rng(0).integers(0, 32000, 300)
    for n in (1, 16, 64, 300):
        assert tprefix.prefix_hash(toks[:n]) == jprefix.prefix_hash(toks[:n])


def test_scratch_page_and_bad_sizes():
    assert tpaging.SCRATCH_PAGE == jpaging.SCRATCH_PAGE == 0
    with pytest.raises(ValueError):
        tpaging.PageAllocator(0)
    with pytest.raises(ValueError):
        tpaging.PageAllocator(2).alloc(-1)


def _random_ops(paging, seed, steps=300):
    """A random mix of allocator and index operations with the engine's
    ownership discipline (every page a caller holds is freed once);
    returns every observable after each step."""
    rng = np.random.default_rng(seed)
    T = 4
    pa = paging.PageAllocator(24)
    idx = paging.PagedPrefixIndex(pa, page_tokens=T, max_pages=8,
                                  min_tokens=4)
    shared = rng.integers(0, 50, 40).tolist()
    held = []   # page lists a caller owns one reference to
    trace = []
    for _ in range(steps):
        op = rng.integers(0, 5)
        if op == 0:
            got = pa.alloc(int(rng.integers(0, 6)))
            if got is not None:
                held.append(got)
            trace.append(("alloc", got))
        elif op == 1 and held:
            pages = held.pop(int(rng.integers(len(held))))
            pa.free(pages)
            trace.append(("free", pages))
        elif op == 2:
            n = int(rng.integers(4, 40))
            toks = shared[:n] + rng.integers(0, 50, 3).tolist()
            need = -(-len(toks) // T)
            m = idx.match(toks)
            pages = list(m[0]) if m else []
            fresh = pa.alloc(need - len(pages))
            if fresh is None:
                pa.free(pages)
                trace.append(("match-dry", m))
                continue
            pages += fresh
            created = idx.insert(toks, pages,
                                 matched_len=m[1] if m else 0)
            held.append(pages)
            trace.append(("admit", m, fresh, created))
        elif op == 3:
            trace.append(("reclaim", idx.reclaim(int(rng.integers(1, 4)))))
        else:
            trace.append(("reclaim-any",
                          idx.reclaim(1, only_free=False)))
        trace.append((pa.stats(), idx.stats(), sorted(idx.pinned_page_ids()),
                      sorted(idx.hashes())))
    for pages in held:
        pa.free(pages)
    idx.reclaim(pa.pages, only_free=False)
    assert pa.free_count == pa.pages and len(idx) == 0
    trace.append(pa.stats())
    return trace


@pytest.mark.parametrize("seed", range(6))
def test_random_operation_sequences_match_jax_package(seed):
    assert _random_ops(tpaging, seed) == _random_ops(jpaging, seed)
