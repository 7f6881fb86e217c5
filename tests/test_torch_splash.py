"""The port's splash attention vs the JAX package's
(``ray_tpu.ops.splash_attention``), on the same numpy inputs.

The JAX op runs its Pallas kernels in interpret mode on the CPU, as
``tests/test_flash_attention.py`` runs them; the port runs its plain
versions (a CPU tensor never reaches the CUDA kernels). The masks, the
schedules and the head grouping are host code and must agree exactly,
array for array. Tolerances: float32 at rtol = atol = 1e-4 for outputs and
1e-4 of the JAX gradient's max |value| for gradients (the same math with
fp32 sums in another order: the TPU kernels accumulate tile by tile, the
plain version in one pass); bfloat16 at 2e-2 (P and dS are rounded to bf16
on both sides after sums taken in another order, so a rounded value may
land one bf16 ulp away).

The kernels' own schedules are checked here: the call schedule's lists
(the forward's at 128 x 128, dK/dV's at 64 x 64) against the JAX
``_Schedule`` array for array, its block order, and a replay of the rule
``splash.cu`` applies (visit the listed tiles, mask per element where the
tile is not full) against each head's dense mask, for the forward, dK/dV
and dQ (whose q-major walk runs at 128 x 64 in bf16 and 64 x 64 in
float32); and a plain walk of dQ's schedule that computes dQ as its kernel
does, against the plain backward and the JAX kernels. The Hopper kernels
themselves are held against the plain versions on a card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import splash_attention as jsplash
from ray_tpu_torch.ops import flash_attention as tflash
from ray_tpu_torch.ops import splash_attention as tsplash

torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32
torch.backends.cudnn.allow_tf32 = False

TOL = {"f32": 1e-4, "bf16": 2e-2}
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}

# (name, JAX mask, port mask): each built-in mask, with parameters that
# are and are not multiples of the tiles.
MASKS = {
    "full": (jsplash.FullMask(), tsplash.FullMask()),
    "causal": (jsplash.CausalMask(), tsplash.CausalMask()),
    "local128": (jsplash.LocalMask(128), tsplash.LocalMask(128)),
    "local50": (jsplash.LocalMask(50), tsplash.LocalMask(50)),
    "chunked256": (jsplash.ChunkedMask(256), tsplash.ChunkedMask(256)),
    "chunked96": (jsplash.ChunkedMask(96), tsplash.ChunkedMask(96)),
}


def _pair(spec):
    """(JAX masks, port masks) from a list of (kind, param)."""
    kinds = {"full": "FullMask", "causal": "CausalMask",
             "local": "LocalMask", "chunked": "ChunkedMask"}
    out = ([], [])
    for kind, *arg in spec:
        out[0].append(getattr(jsplash, kinds[kind])(*arg))
        out[1].append(getattr(tsplash, kinds[kind])(*arg))
    return out


def _inputs(b, sq, sk, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, d)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, d)).astype(np.float32),
            rng.normal(size=(b, sq, h, d)).astype(np.float32))


def _forward(q, k, v, jmask, tmask, dtype="f32", **kw):
    jdt, tdt = DT[dtype]
    out_j = jsplash.splash_attention(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), mask=jmask, **kw)
    out_t = tsplash.splash_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), mask=tmask, **kw)
    assert out_t.dtype == tdt and out_t.shape == q.shape
    return np.asarray(out_j.astype(jnp.float32)), out_t.float().numpy()


# ------------------------------------------------------------ host code


@pytest.mark.parametrize("name", sorted(MASKS))
def test_tile_predicates_match(name):
    jm, tm = MASKS[name]
    for bq, bk in ((64, 64), (128, 64), (64, 128), (100, 36)):
        for i, j in itertools.product(range(10), range(10)):
            assert tm.live_tile(i, j, bq, bk) == jm.live_tile(i, j, bq, bk)
            assert tm.full_tile(i, j, bq, bk) == jm.full_tile(i, j, bq, bk)


def test_masks_hash_and_compare_as_in_jax():
    assert tsplash.LocalMask(64) == tsplash.LocalMask(64)
    assert tsplash.LocalMask(64) != tsplash.LocalMask(65)
    assert tsplash.LocalMask(64) != tsplash.ChunkedMask(64)
    assert tsplash.CausalMask() == tsplash.CausalMask()
    assert len({tsplash.LocalMask(8), tsplash.LocalMask(8),
                tsplash.FullMask()}) == 2
    assert hash(tsplash.ChunkedMask(3)) == hash(jsplash.ChunkedMask(3))


@pytest.mark.parametrize("name", sorted(MASKS))
def test_mask_apply_matches(name):
    jm, tm = MASKS[name]
    s = np.random.default_rng(1).normal(size=(2, 40, 56)).astype(np.float32)
    rows, cols = np.arange(40)[:, None], np.arange(56)[None, :]
    want = jm.apply(jnp.asarray(s), jnp.asarray(rows), jnp.asarray(cols))
    got = tm.apply(torch.from_numpy(s), torch.from_numpy(rows),
                   torch.from_numpy(cols))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


SCHEDULES = [  # (nq, nk, bq, bk)
    (8, 8, 64, 64), (4, 8, 128, 64), (8, 3, 64, 128), (16, 16, 32, 32),
    (5, 7, 64, 64)]


@pytest.mark.parametrize("name", sorted(MASKS))
def test_schedule_arrays_match(name):
    jm, tm = MASKS[name]
    for nq, nk, bq, bk in SCHEDULES:
        js = jsplash._Schedule(jm, nq, nk, bq, bk)
        ts = tsplash._Schedule(tm, nq, nk, bq, bk)
        for attr in ("kv_ids", "kv_lens", "kv_full", "q_ids", "q_lens"):
            got, want = getattr(ts, attr), getattr(js, attr)
            assert got.dtype == want.dtype, attr
            np.testing.assert_array_equal(got, want, err_msg=attr)
        for attr in ("q_len", "k_len", "visited", "total"):
            assert getattr(ts, attr) == getattr(js, attr), attr


def test_schedule_degenerate_rows_match():
    """A q tile with no live kv tile visits tile 0, fully masked (sq > sk
    under a local window), on both sides."""
    jm, tm = jsplash.LocalMask(32), tsplash.LocalMask(32)
    js, ts = (mod._Schedule(m, 4, 1, 64, 64)
              for mod, m in ((jsplash, jm), (tsplash, tm)))
    assert ts.kv_lens.tolist() == [1, 1, 1, 1]
    assert ts.kv_full.tolist() == [[0]] * 4
    for attr in ("kv_ids", "kv_lens", "kv_full", "q_ids", "q_lens"):
        np.testing.assert_array_equal(getattr(ts, attr), getattr(js, attr))


@pytest.mark.parametrize("mask,seq,blocks", [
    (("local", 256), 4096, (256, 256)),
    (("full",), 4096, (256, 256)),
    (("causal",), 4096, (256, 256)),
    (("chunked", 1024), 2048, (128, 256)),
])
def test_schedule_stats_match(mask, seq, blocks):
    (jm,), (tm,) = _pair([mask])
    want = jsplash.schedule_stats(jm, seq, *blocks)
    got = tsplash.schedule_stats(tm, seq, *blocks)
    assert got == want
    if mask[0] == "local":
        assert got["density"] < 0.15


def test_group_heads_match():
    j, t = _pair([("local", 8)] * 3 + [("causal",)] * 2 + [("local", 8)]
                 + [("full",)] * 2)
    want = jsplash._group_heads(j)
    got = tsplash._group_heads(t)
    assert [(a, c) for a, c, _ in got] == [(a, c) for a, c, _ in want]
    assert [type(m).__name__ for _, _, m in got] == \
        [type(m).__name__ for _, _, m in want]
    assert [(a, c) for a, c, _ in got] == [(0, 3), (3, 2), (5, 1), (6, 2)]


# --------------------------------------------------------------- forward


@pytest.mark.parametrize("name", ["full", "causal", "local128", "chunked96"])
def test_forward_each_mask(name):
    jm, tm = MASKS[name]
    q, k, v, _ = _inputs(1, 512, 512, 2, 2, 64, seed=len(name))
    want, got = _forward(q, k, v, jm, tm, block_q=128, block_k=128)
    np.testing.assert_allclose(got, want, rtol=TOL["f32"], atol=TOL["f32"])


MIXED = [("local", 128), ("local", 128), ("chunked", 256), ("chunked", 256)]


@pytest.mark.parametrize("d", [64, 80])
def test_forward_mixed_gqa_stack(d):
    """Four q heads on two kv heads, a local pair then a chunked pair (one
    launch each on the card); D=80 is padded to the kernel's 128."""
    jm, tm = _pair(MIXED)
    q, k, v, _ = _inputs(1, 512, 512, 4, 2, d, seed=d)
    want, got = _forward(q, k, v, jm, tm, block_q=128, block_k=128)
    np.testing.assert_allclose(got, want, rtol=TOL["f32"], atol=TOL["f32"])


def test_forward_mixed_bf16():
    jm, tm = _pair([("causal",), ("causal",), ("full",), ("full",)])
    q, k, v, _ = _inputs(1, 256, 256, 4, 2, 64, seed=3)
    want, got = _forward(q, k, v, jm, tm, "bf16", block_q=128, block_k=128)
    np.testing.assert_allclose(got, want, rtol=TOL["bf16"],
                               atol=TOL["bf16"])


def test_forward_sq_ne_sk():
    """Fewer queries than keys under a full mask, and more queries than
    keys under a local window, where late rows see nothing (out 0)."""
    (jf,), (tf,) = _pair([("full",)])
    q, k, v, _ = _inputs(1, 128, 384, 2, 2, 32, seed=5)
    want, got = _forward(q, k, v, jf, tf, block_q=128, block_k=128)
    np.testing.assert_allclose(got, want, rtol=TOL["f32"], atol=TOL["f32"])
    (jl,), (tl,) = _pair([("local", 32)])
    q, k, v, _ = _inputs(1, 256, 64, 2, 2, 32, seed=6)
    want, got = _forward(q, k, v, jl, tl, block_q=128, block_k=64)
    np.testing.assert_allclose(got, want, rtol=TOL["f32"], atol=TOL["f32"])
    assert not got[:, 95:].any()


def test_plain_forward_dead_rows_convention():
    """A row nothing reaches: out 0 and lse -1e30, as the TPU kernel."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 256, 64, 2, 2, 16))
    out, lse = tsplash.splash_attention_reference(q, k, v,
                                                  tsplash.LocalMask(32))
    assert not out[:, 95:].any()
    assert torch.all(lse[:, :, 95:] == -1e30)
    assert torch.all(lse[:, :, :95] > -1e29)


def test_mask_none_delegates_to_flash():
    q, k, v, _ = _inputs(1, 128, 128, 4, 2, 64, seed=9)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = tsplash.splash_attention(tq, tk, tv, causal=True, window=40,
                                   block_q=64, block_k=64)
    want = tflash.flash_attention(tq, tk, tv, causal=True, window=40,
                                  block_q=64, block_k=64)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    want_j, got_t = _forward(q, k, v, None, None, causal=True, window=40,
                             block_q=64, block_k=64)
    np.testing.assert_allclose(got_t, want_j, rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------- gradients


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_grads_mixed_gqa_stack(dtype):
    """``jax.grad`` through the Pallas kernels' custom_vjp against the
    port's autograd (its plain backward), under the same cotangent."""
    jdt, tdt = DT[dtype]
    jm, tm = _pair(MIXED)
    q, k, v, do = _inputs(1, 512, 512, 4, 2, 64, seed=13)
    kw = dict(block_q=128, block_k=128)
    _, vjp = jax.vjp(lambda *a: jsplash.splash_attention(*a, mask=jm, **kw),
                     *(jnp.asarray(a, jdt) for a in (q, k, v)))
    want = [np.asarray(w.astype(jnp.float32))
            for w in vjp(jnp.asarray(do, jdt))]
    targs = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out = tsplash.splash_attention(*targs, mask=tm, **kw)
    got = torch.autograd.grad(out, targs, torch.from_numpy(do).to(tdt))
    for name, g, a, w in zip("qkv", got, targs, want):
        assert g.dtype == tdt and g.shape == a.shape
        err = float(np.abs(g.float().numpy() - w).max())
        assert err <= TOL[dtype] * float(np.abs(w).max()), ("d" + name, err)


def test_grads_of_sum_take_an_expanded_cotangent():
    """``out.sum().backward()`` hands the backward a stride-0 cotangent;
    the gradients match the plain backward on a dense one."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 64, 64, 2, 1, 16))
    m = [tsplash.ChunkedMask(24)] * 2
    args = [t.clone().requires_grad_() for t in (q, k, v)]
    tsplash.splash_attention(*args, mask=m, block_q=64,
                             block_k=64).sum().backward()
    out, lse = tsplash.splash_attention_reference(q, k, v, m)
    want = tsplash.splash_backward_reference(q, k, v, out, lse,
                                             torch.ones_like(out), m)
    for a, w in zip(args, want):
        torch.testing.assert_close(a.grad, w, rtol=1e-6, atol=1e-6)


def test_plain_backward_matches_autograd_of_plain_forward():
    """``splash_backward_reference`` is the gradient of
    ``splash_attention_reference`` (float32, GQA, mixed masks)."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 48, 48, 4, 2, 16,
                                                        seed=4))
    m = [tsplash.LocalMask(10)] * 2 + [tsplash.ChunkedMask(16)] * 2
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out, lse = tsplash.splash_attention_reference(q, k, v, m)
    want = torch.autograd.grad(out, (q, k, v), do)
    got = tsplash.splash_backward_reference(q.detach(), k.detach(),
                                            v.detach(), out.detach(),
                                            lse.detach(), do, m)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------- errors


def test_value_errors_match():
    x = np.zeros((1, 128, 4, 16), np.float32)
    kv = np.zeros((1, 128, 2, 16), np.float32)
    seg = np.zeros((1, 128), np.int32)
    cases = [
        (dict(mask=jsplash.CausalMask(), segment_ids=jnp.asarray(seg)),
         dict(mask=tsplash.CausalMask(), segment_ids=torch.from_numpy(seg)),
         "segment_ids are data-dependent"),
        (dict(mask=[jsplash.CausalMask()] * 3),
         dict(mask=[tsplash.CausalMask()] * 3), "3 masks for 4 heads"),
        (dict(mask=_pair([("causal",)] * 3 + [("full",)])[0]),
         dict(mask=_pair([("causal",)] * 3 + [("full",)])[1]),
         "align with GQA groups"),
        (dict(mask=jsplash.CausalMask(), block_q=96),
         dict(mask=tsplash.CausalMask(), block_q=96), "must divide blocks"),
        (dict(mask=jsplash.CausalMask(), block_k=48),
         dict(mask=tsplash.CausalMask(), block_k=48), "must divide blocks"),
    ]
    for jkw, tkw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            jsplash.splash_attention(jnp.asarray(x), jnp.asarray(kv),
                                     jnp.asarray(kv), **jkw)
        with pytest.raises(ValueError, match=msg):
            tsplash.splash_attention(torch.from_numpy(x),
                                     torch.from_numpy(kv),
                                     torch.from_numpy(kv), **tkw)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tsplash.splash_attention(*(torch.zeros(1, 8, 1, 16, device="meta")
                                   for _ in range(3)),
                                 mask=tsplash.CausalMask())


class _Diagonal(tsplash.Mask):
    """A mask the kernels do not know: each query sees only its own key."""

    def live_tile(self, i, j, bq, bk):
        return i * bq < (j + 1) * bk and j * bk < (i + 1) * bq

    def full_tile(self, i, j, bq, bk):
        return False

    def apply(self, s, rows, cols):
        return torch.where(rows == cols, s, -1e30)


class _Causal2(tsplash.CausalMask):
    """A subclass of a built-in mask is not that mask for the kernels."""


def test_custom_masks_run_on_cpu_and_are_refused_by_the_kernels():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 32, 32, 2, 2, 16))
    out = tsplash.splash_attention(q, k, v, mask=_Diagonal(), block_q=32,
                                   block_k=32)
    torch.testing.assert_close(out, v)
    for m in (_Diagonal(), _Causal2()):
        with pytest.raises(ValueError, match="FullMask, CausalMask, "
                                             "LocalMask and ChunkedMask"):
            tsplash._kernel_mask(m)
    assert tsplash._kernel_mask(tsplash.LocalMask(7)) == (2, 7)
    assert tsplash._kernel_mask(tsplash.ChunkedMask(9)) == (3, 9)
    assert tsplash._kernel_mask(tsplash.CausalMask()) == (1, 0)
    assert tsplash._kernel_mask(tsplash.FullMask()) == (0, 0)
    with pytest.raises(ValueError, match="chunk >= 1"):
        tsplash._kernel_mask(tsplash.ChunkedMask(0))


# ------------------------------------------------ the kernels' schedules


def _key_range(code, param, row, sk):
    """``splash.cu``'s key_range: keys [lo, hi] query ``row`` keeps."""
    lo, hi = 0, sk - 1
    if code:
        hi = min(hi, row)
    if code == 2:
        lo = row - param + 1
    if code == 3:
        lo = row // param * param
    return lo, hi


def _query_range(code, param, col, sq):
    """``splash.cu``'s query_range: query rows [lo, hi] that keep ``col``."""
    lo, hi = 0, sq - 1
    if code:
        lo = col
    if code == 2:
        hi = min(hi, col + param - 1)
    if code == 3:
        hi = min(hi, (col // param + 1) * param - 1)
    return lo, hi


def _side(buf, n_blocks, n_heads):
    """One direction of a call schedule (``_pack_side``'s layout), decoded:
    (order as (head, tile) pairs, head -> group, per group (code, param,
    ids, lens, full, first head, head count))."""
    buf = buf.numpy() if isinstance(buf, torch.Tensor) else buf
    order = buf[:n_blocks]
    head_group = buf[n_blocks:n_blocks + n_heads]
    n_groups = int(head_group.max()) + 1
    base = n_blocks + n_heads
    table = buf[base:base + n_groups * tsplash._GROUP_INTS].reshape(
        n_groups, tsplash._GROUP_INTS)
    groups = []
    for code, param, ids_off, lens_off, full_off, row, start, count in table:
        n_tiles = (lens_off - ids_off) // row
        groups.append((int(code), int(param),
                       buf[ids_off:lens_off].reshape(n_tiles, row),
                       buf[lens_off:lens_off + n_tiles],
                       buf[full_off:full_off + n_tiles * row].reshape(
                           n_tiles, row), int(start), int(count)))
    pairs = [(int(e) & 0xffff, int(e) >> 16) for e in order]
    return pairs, head_group, groups


def _q_major_walk(call, n_heads, sq, sk, bq, bk):
    """(n_heads, nq * bq, nk * bk) bool: the (query, key) pairs a walk of
    the call schedule's q-major side lets through (the forward's and dQ's
    rule: a block (q head, q tile) visits its group's listed kv tiles and
    masks the non-full ones by each row's key range), over the padded
    grid."""
    pairs, head_group, decoded = _side(call.fwd, call.fwd_blocks, n_heads)
    nq, nk = -(-sq // bq), -(-sk // bk)
    seen = np.zeros((n_heads, nq * bq, nk * bk), bool)
    for h, i in pairs:
        code, param, ids, lens, full, _, _ = decoded[head_group[h]]
        for j, f in zip(ids[i, :lens[i]], full[i, :lens[i]]):
            for r in range(i * bq, i * bq + bq):
                lo, hi = _key_range(code, param, r, sk)
                c = np.arange(j * bk, j * bk + bk)
                seen[h, r, c] = True if f else (c >= lo) & (c <= hi)
    return seen


def _kv_major_walk(call, n_heads, group, sq, sk, t):
    """The same for the transposed side at t x t (dK/dV's rule: a block
    (kv head, key tile) visits its listed q tiles for every q head of its
    kv head and masks the non-full ones by each key's query range)."""
    pairs, head_group, decoded = _side(call.dkv, call.dkv_blocks,
                                       n_heads // group)
    nq, nk = -(-sq // t), -(-sk // t)
    seen = np.zeros((n_heads, nq * t, nk * t), bool)
    for hk, j in pairs:
        code, param, ids, lens, full, _, _ = decoded[head_group[hk]]
        for h in range(hk * group, hk * group + group):
            for i, f in zip(ids[j, :lens[j]], full[j, :lens[j]]):
                for c in range(j * t, j * t + t):
                    lo, hi = _query_range(code, param, c, sq)
                    r = np.arange(i * t, i * t + t)
                    seen[h, r, c] = True if f else (r >= lo) & (r <= hi)
    return seen


def _heaviest_first(buf, n_blocks, n_heads):
    """The block order of one side is a permutation of every (head, tile)
    with non-increasing list lengths."""
    pairs, head_group, decoded = _side(buf, n_blocks, n_heads)
    n_tiles = n_blocks // n_heads
    assert sorted(pairs) == [(h, t) for h in range(n_heads)
                             for t in range(n_tiles)]
    counts = [decoded[head_group[h]][3][t] for h, t in pairs]
    assert all(x >= y for x, y in zip(counts, counts[1:]))


# dQ's tiles, (q rows, keys): the bf16 wgmma kernel's and the float32
# mma.sync kernel's.
DQ_TILES = [(128, 64), (64, 64)]


@pytest.mark.parametrize("spec,sq,sk", [
    (("causal",), 512, 512), (("full",), 200, 328), (("local", 100), 450,
                                                     450),
    (("local", 64), 512, 512), (("chunked", 96), 500, 500),
    (("chunked", 128), 512, 512), (("local", 32), 256, 64),
    (("causal",), 100, 100), (("full",), 100, 100)])
def test_kernel_schedule_replays_to_the_mask(spec, sq, sk):
    """Visiting the listed tiles and masking the non-full ones per element,
    as ``splash.cu`` does, keeps exactly the mask's pairs on the real grid
    and nothing in the padding, for dQ's q-major side at both of its
    tilings and dK/dV's transposed side at 64 x 64; each side's blocks put
    the longest lists first."""
    (m,) = _pair([spec])[1]
    cpu = torch.device("cpu")
    rows, cols = np.arange(sq)[:, None], np.arange(sk)[None, :]
    want = m.apply(torch.zeros(sq, sk), torch.from_numpy(rows),
                   torch.from_numpy(cols)).numpy() == 0
    for bq, bk in DQ_TILES:
        call = tsplash._call_schedule([m], 1, sq, sk, bq, bk, cpu)
        (dq,) = _q_major_walk(call, 1, sq, sk, bq, bk)
        np.testing.assert_array_equal(dq[:sq, :sk], want)
        assert not dq[:sq, sk:].any()
        assert call.fwd_blocks == -(-sq // bq)
        _heaviest_first(call.fwd, call.fwd_blocks, 1)
        assert call.fwd.dtype == torch.int32
        assert tsplash._call_schedule([m], 1, sq, sk, bq, bk, cpu) is call
    call = tsplash._call_schedule([m], 1, sq, sk, 64, 64, cpu)
    (dkv,) = _kv_major_walk(call, 1, 1, sq, sk, 64)
    np.testing.assert_array_equal(dkv[:sq, :sk], want)
    assert not dkv[sq:, :sk].any()
    _heaviest_first(call.dkv, call.dkv_blocks, 1)


# The smoke's 16 q heads on 8 kv heads: local / chunked / causal / full.
SMOKE_STACK = ([("local", 1024)] * 8 + [("chunked", 2048)] * 4
               + [("causal",)] * 2 + [("full",)] * 2)
STACKS = {
    **{name: ([spec] * 4, 2) for name, spec in (
        ("full", ("full",)), ("causal", ("causal",)),
        ("local100", ("local", 100)), ("chunked96", ("chunked", 96)))},
    "mixed_gqa2": ([("local", 50)] * 2 + [("chunked", 64)] * 2
                   + [("causal",)] * 2 + [("full",)] * 2, 2),
    "alternating_8_groups": ([("local", 40), ("full",)] * 4, 1),
    "smoke_16_8": (SMOKE_STACK, 2),
}


def _ragged(n, tile, length):
    return np.arange(n) * tile + tile > length


@pytest.mark.parametrize("stack,sq,sk", [
    (stack, sq, sk) for stack in sorted(STACKS)
    for sq, sk in ((4096, 4096), (1000, 1000), (200, 328))
    if stack != "smoke_16_8" or sq == 4096])  # its windows need the length
def test_call_schedule_lists_match_jax(stack, sq, sk):
    """Each head group's lists in the call schedule, the forward's at its
    128 x 128 tiles and dK/dV's at 64 x 64, are the JAX ``_Schedule``'s at
    the same tiles, array for array; full flags are JAX's with ragged
    tiles cleared; the group table names each group's mask and heads."""
    spec, group = STACKS[stack]
    jmasks, tmasks = _pair(spec)
    cpu = torch.device("cpu")
    groups = tsplash._group_heads(tmasks)
    for side, (bq, bk) in (("fwd", (128, 128)), ("dkv", (64, 64))):
        call = tsplash._call_schedule(tmasks, group, sq, sk, bq, bk, cpu)
        nq, nk = -(-sq // bq), -(-sk // bk)
        n_heads = len(tmasks) if side == "fwd" else len(tmasks) // group
        _, head_group, decoded = _side(getattr(call, side),
                                       getattr(call, f"{side}_blocks"),
                                       n_heads)
        assert len(decoded) == len(groups)
        for gi, ((a, c, m), (code, param, ids, lens, full, start,
                             count)) in enumerate(zip(groups, decoded)):
            jm = jmasks[a]
            js = jsplash._Schedule(jm, nq, nk, bq, bk)
            assert (code, param) == tsplash._kernel_mask(m)
            rq, rk = _ragged(nq, bq, sq), _ragged(nk, bk, sk)
            if side == "fwd":
                assert (start, count) == (a, c)
                np.testing.assert_array_equal(ids, js.kv_ids)
                np.testing.assert_array_equal(lens, js.kv_lens)
                np.testing.assert_array_equal(
                    full, js.kv_full * ~(rq[:, None] | rk[js.kv_ids]))
            else:
                assert (start, count) == (a // group, c // group)
                np.testing.assert_array_equal(ids, js.q_ids)
                np.testing.assert_array_equal(lens, js.q_lens)
                want = np.asarray([[jm.full_tile(int(i), j, bq, bk)
                                    for i in row]
                                   for j, row in enumerate(js.q_ids)])
                np.testing.assert_array_equal(
                    full, want & ~(rk[:, None] | rq[js.q_ids]))
            assert (head_group[start:start + count] == gi).all()


@pytest.mark.parametrize("stack", sorted(STACKS))
def test_call_schedule_block_order_is_heaviest_first(stack):
    """The block order of each direction is a permutation of every (head,
    tile), with the blocks' live-tile counts non-increasing across all
    heads and groups."""
    spec, group = STACKS[stack]
    tmasks = _pair(spec)[1]
    for side, tile in (("fwd", 128), ("dkv", 64)):
        call = tsplash._call_schedule(tmasks, group, 2048, 2048, tile, tile,
                                      torch.device("cpu"))
        n_heads = len(tmasks) if side == "fwd" else len(tmasks) // group
        assert getattr(call, f"{side}_blocks") == n_heads * 2048 // tile
        _heaviest_first(getattr(call, side), getattr(call, f"{side}_blocks"),
                        n_heads)


@pytest.mark.parametrize("stack", ["mixed_gqa2", "alternating_8_groups"])
@pytest.mark.parametrize("sq,sk", [(200, 200), (256, 64), (200, 328)])
def test_call_schedule_replays_to_each_heads_mask(stack, sq, sk):
    """Walking the call schedule as the kernels do (a block visits its
    group's listed tiles, masking the non-full ones by the per-row key
    range in the forward and dQ, by the per-key query range in dK/dV, for
    every q head of its kv head) keeps exactly each head's ``apply`` on
    the real grid and nothing in the padding: the forward's blocks over
    (q head, 128-row q tile) with 128-key tiles, dQ's over (q head,
    128-row q tile) with 64-key tiles, dK/dV's over (kv head, 64-key
    tile). A q tile that nothing reaches (S=256 queries on 64 keys) lists
    one tile, fully masked."""
    spec, group = STACKS[stack]
    tmasks = _pair(spec)[1]
    cpu = torch.device("cpu")
    rows, cols = np.arange(sq)[:, None], np.arange(sk)[None, :]
    want = np.stack([m.apply(torch.zeros(sq, sk), torch.from_numpy(rows),
                             torch.from_numpy(cols)).numpy() == 0
                     for m in tmasks])
    for bq, bk in ((128, 128), (128, 64)):  # the forward, dQ
        call = tsplash._call_schedule(tmasks, group, sq, sk, bq, bk, cpu)
        seen = _q_major_walk(call, len(tmasks), sq, sk, bq, bk)
        np.testing.assert_array_equal(seen[:, :sq, :sk], want)
        assert not seen[:, :sq, sk:].any()
        _, head_group, decoded = _side(call.fwd, call.fwd_blocks,
                                       len(tmasks))
        for h in range(len(tmasks)):
            _, _, ids, lens, full, _, _ = decoded[head_group[h]]
            for i in range(-(-sq // bq)):
                if not want[h, i * bq:(i + 1) * bq].any():
                    assert (lens[i], ids[i, 0], full[i, 0]) == (1, 0, 0)
    call = tsplash._call_schedule(tmasks, group, sq, sk, 64, 64, cpu)
    seen = _kv_major_walk(call, len(tmasks), group, sq, sk, 64)
    np.testing.assert_array_equal(seen[:, :sq, :sk], want)
    assert not seen[:, sq:, :sk].any()


def test_call_schedule_cache_keys_on_the_tile():
    masks = _pair(STACKS["mixed_gqa2"][0])[1]
    cpu = torch.device("cpu")
    a = tsplash._call_schedule(masks, 2, 512, 512, 128, 128, cpu)
    b = tsplash._call_schedule(masks, 2, 512, 512, 64, 64, cpu)
    assert a is not b and a.fwd_blocks == 8 * 4 and b.fwd_blocks == 8 * 8
    assert tsplash._call_schedule(list(masks), 2, 512, 512, 128, 128,
                                  cpu) is a
    assert tsplash._call_schedule(masks, 2, 512, 512, 64, 64, cpu) is b
    assert tsplash._call_schedule(masks, 1, 512, 512, 64, 64, cpu) is not b
    with pytest.raises(ValueError, match="FullMask, CausalMask"):
        tsplash._call_schedule([_Diagonal()] * 2, 1, 64, 64, 64, 64, cpu)


def _dq_walk(q, k, v, do, out, lse, masks, bq, bk):
    """dQ computed the way ``splash.cu``'s dQ kernels do, by a plain walk
    of the call schedule's q-major side at (bq, bk) tiles: each block (q
    head, q tile) visits only its listed kv tiles, masks scores by each
    row's key range only where the tile is not full, takes P = exp(s -
    max(lse, -5e29)) and dS = P (dP - delta) scale, rounds dS to k's
    dtype and accumulates dS K in fp32. Rows past Sq (zero Q and dO, lse
    and delta 0) are computed and dropped, as the kernel never stores
    them."""
    b, sq, h, d = q.shape
    sk, group = k.shape[1], h // k.shape[2]
    scale = d ** -0.5
    call = tsplash._call_schedule(masks, group, sq, sk, bq, bk,
                                  torch.device("cpu"))
    pairs, head_group, decoded = _side(call.fwd, call.fwd_blocks, h)
    nq, nk = -(-sq // bq), -(-sk // bk)

    def pad(t, n):
        return torch.nn.functional.pad(t.float(), (0, 0, 0, 0, 0,
                                                   n - t.shape[1]))

    qp, dop, kp, vp = pad(q, nq * bq), pad(do, nq * bq), pad(k, nk * bk), \
        pad(v, nk * bk)
    stats = torch.zeros(2, b, h, nq * bq)
    stats[0, :, :, :sq] = lse.clamp_min(-1e30 / 2)
    stats[1, :, :, :sq] = tflash.attention_delta_reference(out, do)
    dq = torch.zeros(b, nq * bq, h, d)
    for h_, i in pairs:
        code, param, ids, lens, full, _, _ = decoded[head_group[h_]]
        r = torch.arange(i * bq, (i + 1) * bq)
        bounds = torch.tensor([_key_range(code, param, int(x), sk)
                               for x in r])
        lse_r, dd = stats[:, :, h_, r][..., None]
        for j, f in zip(ids[i, :lens[i]], full[i, :lens[i]]):
            c = torch.arange(j * bk, (j + 1) * bk)
            kt = kp[:, c, h_ // group]
            s = torch.einsum("bqd,bkd->bqk", qp[:, r, h_], kt) * scale
            if not f:
                keep = (c >= bounds[:, :1]) & (c <= bounds[:, 1:])
                s = torch.where(keep, s, -1e30)
            p = torch.exp(s - lse_r)
            dp = torch.einsum("bqd,bkd->bqk", dop[:, r, h_],
                              vp[:, c, h_ // group])
            ds = (p * (dp - dd) * scale).to(k.dtype).float()
            dq[:, r, h_] += torch.einsum("bqk,bkd->bqd", ds, kt)
    return dq[:, :sq].to(q.dtype)


@pytest.mark.parametrize("stack,sq,sk,dtype,tiles,jax_blocks", [
    ("mixed_gqa2", 256, 256, "f32", (128, 64), (128, 64)),
    ("mixed_gqa2", 256, 256, "bf16", (128, 64), (128, 64)),
    ("mixed_gqa2", 256, 256, "f32", (64, 64), (64, 64)),
    ("degenerate", 256, 64, "f32", (128, 64), (128, 64)),
    ("alternating_8_groups", 200, 328, "f32", (128, 64), None),
])
def test_dq_walk_of_the_call_schedule_matches(stack, sq, sk, dtype, tiles,
                                              jax_blocks):
    """dQ from a plain walk of the call schedule, as the dQ kernels compute
    it (listed tiles only, the mask only on tiles not full, the lse floor,
    dS rounded to k's dtype), at the bf16 kernel's 128 x 64 tiles and the
    float32 kernel's 64 x 64, against ``splash_backward_reference`` on
    the same (out, lse) and against the JAX ``_sbwd`` dQ (its Pallas
    kernels in interpret mode, through ``jax.vjp``, where the lengths
    divide its blocks). Tolerances as the module's: float32 1e-4 and bf16
    2e-2 of the plain gradient's max |value|; rows nothing reaches (the
    degenerate stack: queries 95.. of 256 on 64 keys under a 32 window)
    get exactly zero."""
    spec, group = (([("local", 32)] * 2, 1) if stack == "degenerate"
                   else STACKS[stack])
    jmasks, tmasks = _pair(spec)
    jdt, tdt = DT[dtype]
    h = len(tmasks)
    q, k, v, do = _inputs(1, sq, sk, h, h // group, 32, seed=21)
    tq, tk, tv, tdo = (torch.from_numpy(a).to(tdt) for a in (q, k, v, do))
    out, lse = tsplash.splash_attention_reference(tq, tk, tv, tmasks)
    got = _dq_walk(tq, tk, tv, tdo, out, lse, tmasks, *tiles)
    assert got.dtype == tdt and got.shape == tq.shape
    want = tsplash.splash_backward_reference(tq, tk, tv, out, lse, tdo,
                                             tmasks)[0]
    tol = TOL[dtype] * float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol
    if stack == "degenerate":
        assert not got[:, 95:].any()
    if jax_blocks is not None:
        bq, bk = jax_blocks
        _, vjp = jax.vjp(lambda *a: jsplash.splash_attention(
            *a, mask=jmasks, block_q=bq, block_k=bk),
            *(jnp.asarray(a, jdt) for a in (q, k, v)))
        jdq = np.asarray(vjp(jnp.asarray(do, jdt))[0].astype(jnp.float32))
        tol = TOL[dtype] * float(np.abs(jdq).max())
        assert float(np.abs(got.float().numpy() - jdq).max()) <= tol
