"""Gradients of the port's flash attention vs ``jax.vjp`` through the JAX
package's Pallas kernels (interpret mode on the CPU, as
``tests/test_flash_attention.py`` runs them).

On the CPU the port's backward is ``flash_backward_reference`` (a CPU
tensor never reaches the CUDA kernels). Tolerances are on the max |error|
relative to the JAX gradient's max |value|: float32 at 2e-5 (the same math
with reordered fp32 sums: the TPU kernels accumulate tile by tile, the
plain version in one pass), bfloat16 at 2e-2 (P and dS are rounded to bf16
before their products on both sides, after sums taken in another order,
so a rounded value may land one bf16 ulp away).

The Hopper kernels themselves are held against the plain version on a card
by ``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jflash
from ray_tpu_torch.ops import flash_attention as tflash

torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32
torch.backends.cudnn.allow_tf32 = False

TOL = {"f32": 2e-5, "bf16": 2e-2}
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(b, sq, sk, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, d)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, d)).astype(np.float32),
            rng.normal(size=(b, sq, h, d)).astype(np.float32))


def _close(got, want, tol, name=""):
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got, np.float32) - want).max())
    assert err <= tol * float(np.abs(want).max()), (name, err)


def _grads(q, k, v, do, dtype, **kw):
    """(JAX grads, port grads) of flash attention under cotangent ``do``."""
    jdt, tdt = DT[dtype]
    jkw = {k_: (jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_)
           for k_, v_ in kw.items()}
    tkw = {k_: (torch.from_numpy(v_) if isinstance(v_, np.ndarray) else v_)
           for k_, v_ in kw.items()}
    jargs = [jnp.asarray(a, jdt) for a in (q, k, v)]
    _, vjp = jax.vjp(lambda *a: jflash.flash_attention(*a, **jkw), *jargs)
    want = vjp(jnp.asarray(do, jdt))
    targs = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v)]
    out = tflash.flash_attention(*targs, **tkw)
    got = torch.autograd.grad(out, targs, torch.from_numpy(do).to(tdt))
    for g, a in zip(got, targs):
        assert g.dtype == tdt and g.shape == a.shape
    return ([np.asarray(w.astype(jnp.float32)) for w in want],
            [g.float().numpy() for g in got])


CASES = {
    "causal": (dict(b=1, sq=128, sk=128, h=2, hkv=2, d=64),
               dict(causal=True)),
    "non_causal": (dict(b=1, sq=128, sk=128, h=2, hkv=2, d=64),
                   dict(causal=False)),
    "window": (dict(b=1, sq=128, sk=128, h=2, hkv=2, d=64),
               dict(causal=True, window=40)),
    "q_offset": (dict(b=2, sq=64, sk=128, h=2, hkv=2, d=64),
                 dict(causal=True, q_offset=64)),
    "gqa": (dict(b=2, sq=128, sk=128, h=4, hkv=2, d=16),
            dict(causal=True)),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_grads_match(case, dtype):
    shape, kw = CASES[case]
    q, k, v, do = _inputs(**shape, seed=len(case))
    want, got = _grads(q, k, v, do, dtype, block_q=64, block_k=64, **kw)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, TOL[dtype], "d" + name)


# Edges of the Hopper kernels' tiles (128-row dQ tiles, 64-key dK/dV tiles
# and their 64-row q tiles) at a small width: (shape, kwargs, (block_q,
# block_k)), the blocks dividing the lengths as the JAX package requires.
EDGE_CASES = {
    "s129_ragged": (dict(b=1, sq=129, sk=129, h=2, hkv=2, d=16),
                    dict(causal=True), (129, 129)),
    "s255_ragged": (dict(b=1, sq=255, sk=255, h=2, hkv=1, d=16),
                    dict(causal=True), (85, 51)),
    "sq200_sk328_q_offset128": (dict(b=1, sq=200, sk=328, h=2, hkv=2, d=16),
                                dict(causal=True, q_offset=128), (40, 41)),
    "window100": (dict(b=1, sq=256, sk=256, h=2, hkv=2, d=16),
                  dict(causal=True, window=100), (64, 64)),
    "gqa_group4": (dict(b=1, sq=192, sk=192, h=8, hkv=2, d=16),
                   dict(causal=True), (64, 64)),
    "d64_s200": (dict(b=1, sq=200, sk=200, h=2, hkv=2, d=64),
                 dict(causal=True), (40, 50)),
}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(EDGE_CASES))
def test_flash_grads_match_at_tile_edges(case, dtype):
    shape, kw, (bq, bk) = EDGE_CASES[case]
    q, k, v, do = _inputs(**shape, seed=len(case) + 20)
    want, got = _grads(q, k, v, do, dtype, block_q=bq, block_k=bk, **kw)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, TOL[dtype], "d" + name)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_grads_segments_off_the_tile_grid(dtype):
    """Segment boundaries that fall inside 64-key and 128-row tiles, with
    GQA; the second batch row has its own boundaries."""
    q, k, v, do = _inputs(2, 256, 256, 4, 2, 16, seed=31)
    seg = np.zeros((2, 256), np.int32)
    seg[:, 77:] = 1
    seg[:, 200:] = 2
    seg[1, 150:] = 3
    seg[1, 230:] = 4
    want, got = _grads(q, k, v, do, dtype, causal=True, segment_ids=seg,
                       block_q=64, block_k=64)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, TOL[dtype], "d" + name)


def test_flash_grads_segments_with_dead_rows():
    """Packed segments; query rows whose segment has no key anywhere get
    exactly zero gradient, on both sides."""
    q, k, v, do = _inputs(1, 64, 64, 2, 1, 16, seed=7)
    seg_q = np.zeros((1, 64), np.int32)
    seg_q[:, 20:40] = 1
    seg_q[:, 40:] = 9           # segment 9 has no keys: dead rows
    seg_k = np.zeros((1, 64), np.int32)
    seg_k[:, 30:] = 1
    want, got = _grads(q, k, v, do, "f32", causal=False, segment_ids=seg_q,
                       kv_segment_ids=seg_k, block_q=32, block_k=32)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, TOL["f32"], "d" + name)
    assert not got[0][0, 40:].any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_stats_grads_with_lse_cotangent(dtype):
    """``flash_attention_stats`` differentiates through both outputs: the
    lse cotangent enters dS as ``p * g_lse``."""
    jdt, tdt = DT[dtype]
    q, k, v, do = _inputs(1, 128, 128, 2, 2, 64, seed=11)
    qt, kt, vt, dot = (a.transpose(0, 2, 1, 3).copy() for a in (q, k, v, do))
    dlse = np.random.default_rng(12).normal(size=(1, 2, 128)).astype(
        np.float32)
    args = (64 ** -0.5, True, 48, 0, 64, 64)   # scale, causal, window, ...
    _, vjp = jax.vjp(lambda *a: jflash.flash_attention_stats(*a, *args),
                     *(jnp.asarray(a, jdt) for a in (qt, kt, vt)))
    want = vjp((jnp.asarray(dot, jdt), jnp.asarray(dlse)))
    targs = [torch.from_numpy(a).to(tdt).requires_grad_()
             for a in (qt, kt, vt)]
    out, lse = tflash.flash_attention_stats(*targs, *args)
    got = torch.autograd.grad((out, lse), targs,
                              (torch.from_numpy(dot).to(tdt),
                               torch.from_numpy(dlse)))
    for name, g, w in zip("qkv", got, want):
        _close(g.float().numpy(), w.astype(jnp.float32), TOL[dtype],
               "d" + name)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_flash_stats_grads_with_lse_cotangent_gqa(dtype):
    """The lse cotangent with a GQA group of 4 and ragged 64-row tiles:
    the group sum of dK / dV carries the cotangent's term of every head."""
    jdt, tdt = DT[dtype]
    q, _, _, do = _inputs(1, 96, 96, 8, 8, 64, seed=13)
    _, k, v, _ = _inputs(1, 96, 96, 8, 2, 64, seed=14)
    qt, kt, vt, dot = (a.transpose(0, 2, 1, 3).copy() for a in (q, k, v, do))
    dlse = np.random.default_rng(15).normal(size=(1, 8, 96)).astype(
        np.float32)
    args = (64 ** -0.5, True, None, 0, 32, 32)
    _, vjp = jax.vjp(lambda *a: jflash.flash_attention_stats(*a, *args),
                     *(jnp.asarray(a, jdt) for a in (qt, kt, vt)))
    want = vjp((jnp.asarray(dot, jdt), jnp.asarray(dlse)))
    targs = [torch.from_numpy(a).to(tdt).requires_grad_()
             for a in (qt, kt, vt)]
    out, lse = tflash.flash_attention_stats(*targs, *args)
    got = torch.autograd.grad((out, lse), targs,
                              (torch.from_numpy(dot).to(tdt),
                               torch.from_numpy(dlse)))
    for name, g, w in zip("qkv", got, want):
        _close(g.float().numpy(), w.astype(jnp.float32), TOL[dtype],
               "d" + name)


def test_flash_grads_need_no_lse_cotangent():
    """Through ``flash_attention_stats`` with only ``out`` used, the
    backward is the plain output backward (no lse term)."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(1, 32, 32, 2, 2, 16))
    qt, kt, vt = (a.transpose(1, 2).contiguous().requires_grad_()
                  for a in (q, k, v))
    out, _ = tflash.flash_attention_stats(qt, kt, vt, 0.25, True, None, 0,
                                          32, 32)
    got = torch.autograd.grad(out, (qt, kt, vt), do.transpose(1, 2))
    ref = tflash.flash_attention_reference(
        *(a.transpose(1, 2) for a in (qt, kt, vt)), causal=True,
        scale=0.25)[0]
    want = torch.autograd.grad(ref, (qt, kt, vt), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_plain_backward_matches_autograd_of_plain_forward():
    """``flash_backward_reference`` is the gradient of
    ``flash_attention_reference`` (float32, GQA, window and an lse
    cotangent): the explicit formulas agree with autograd through the
    plain forward."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 48, 48, 4, 2, 16,
                                                        seed=3))
    dlse = torch.randn(2, 4, 48, generator=torch.Generator().manual_seed(0))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    kw = dict(causal=True, window=20)
    out, lse = tflash.flash_attention_reference(q, k, v, **kw)
    want = torch.autograd.grad((out, lse), (q, k, v), (do, dlse))
    got = tflash.flash_backward_reference(q.detach(), k.detach(), v.detach(),
                                          out.detach(), lse.detach(), do,
                                          dlse, **kw)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


# The delta pre-pass, delta = rowsum(dO * O): the shapes the two backward
# paths hand it (before D is padded) and a (B, H, S, D) transposed view.
DELTA_CASES = {"d128": (2, 96, 4, 128), "d80": (1, 64, 3, 80),
               "d64": (2, 33, 2, 64), "d16_bhsd_view": (2, 40, 4, 16)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(DELTA_CASES))
def test_attention_delta_reference_matches_jax(case, dtype):
    """``attention_delta_reference`` against the JAX package's expression
    (``ray_tpu/ops/flash_attention.py:343-346``, ``jnp.sum(do.astype(f32)
    * out.astype(f32), -1)`` on its (B, H, S, D) layout) on the same numpy
    inputs, rounded to the working dtype first. Tolerance: 1e-5 of the
    largest |delta| (the same fp32 products, summed in another order)."""
    jdt, tdt = DT[dtype]
    b, s, h, d = DELTA_CASES[case]
    rng = np.random.default_rng(len(case))
    out, do = (rng.normal(size=(b, h, s, d)).astype(np.float32)
               for _ in range(2))
    want = np.asarray(jnp.sum(jnp.asarray(do, jdt).astype(jnp.float32)
                              * jnp.asarray(out, jdt).astype(jnp.float32),
                              axis=-1))
    t_out, t_do = (torch.from_numpy(a).to(tdt) for a in (out, do))
    if case.endswith("bhsd_view"):  # as flash_attention_stats hands it
        t_out, t_do = t_out.transpose(1, 2), t_do.transpose(1, 2)
    else:
        t_out, t_do = (x.transpose(1, 2).contiguous() for x in (t_out, t_do))
    got = tflash.attention_delta_reference(t_out, t_do)
    assert got.dtype == torch.float32 and got.shape == (b, h, s)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_attention_delta_takes_the_plain_version_on_cpu():
    """On CPU tensors ``attention_delta`` is its plain version (no kernel
    launch counted); other devices are refused."""
    out, do = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(2, 48, 48, 4, 4, 80)[:2])
    before = tflash.attention_delta.launches
    got = tflash.attention_delta(out, do)
    torch.testing.assert_close(got, tflash.attention_delta_reference(out, do),
                               rtol=0, atol=0)
    assert tflash.attention_delta.launches == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        tflash.attention_delta(*(torch.zeros(1, 8, 1, 16, device="meta")
                                 for _ in range(2)))
