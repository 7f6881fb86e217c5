"""The port's CUDA kernels against their plain PyTorch versions on a card.

Every test here is marked ``cuda`` and skips where no NVIDIA GPU is
present (the kernels have no CPU mode). The file imports no JAX, so it
also runs on a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

Tolerances: bf16 at 2e-2 (P is rounded to bf16 at other points of the
sum than in the plain version), float32 at 1e-4 (the kernel splits each
float32 operand into a bf16 hi + lo pair, ~2^-16 relative). Gradients
compare by max |error| relative to the plain version's max |gradient|
(their scale depends on S and on the cotangent's), at the same two
tolerances."""

import pytest
import torch

from ray_tpu_torch.ops import flash_attention as tflash


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the Hopper kernels have no CPU "
                    "mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,s,d,hkv,kw", [
    (torch.bfloat16, 192, 128, 4, dict(causal=True)),
    (torch.bfloat16, 192, 64, 2, dict(causal=True, window=50)),
    (torch.bfloat16, 200, 16, 4, dict(causal=False)),
    (torch.float32, 192, 128, 4, dict(causal=True, q_offset=64)),
])
def test_flash_kernel_matches_plain(cuda_device, dtype, s, d, hkv, kw):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q = torch.randn(2, s, 4, d, generator=g, device=cuda_device).to(dtype)
    k = torch.randn(2, s, hkv, d, generator=g, device=cuda_device).to(dtype)
    v = torch.randn(2, s, hkv, d, generator=g, device=cuda_device).to(dtype)
    before = tflash.flash_attention.launches
    out, lse = tflash.flash_forward(q, k, v, **kw)
    assert tflash.flash_attention.launches == before + 1
    ref, ref_lse = tflash.flash_attention_reference(q, k, v, **kw)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-3, atol=1e-3)


# Edges of the bf16 kernel's 128-row q tiles and 128-key kv tiles:
# (name, B, Sq, Sk, H, Hkv, D, kwargs); "segments" puts segment
# boundaries at 77, 200 and (last batch) 150.
BF16_TILE_EDGES = [
    ("s129_ragged", 2, 129, 129, 4, 4, 128, dict(causal=True)),
    ("s255_ragged", 2, 255, 255, 4, 2, 128, dict(causal=True)),
    ("sq200_sk328_q_offset128", 2, 200, 328, 4, 4, 128,
     dict(causal=True, q_offset=128)),
    ("window100", 1, 512, 512, 4, 4, 128, dict(causal=True, window=100)),
    ("segments_off_grid", 2, 384, 384, 4, 2, 128,
     dict(causal=True, segments=True)),
    ("gqa32_8", 1, 300, 300, 32, 8, 128, dict(causal=True)),
    ("d64_s200", 2, 200, 200, 4, 4, 64, dict(causal=True)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,b,sq,sk,h,hkv,d,kw", BF16_TILE_EDGES,
                         ids=[c[0] for c in BF16_TILE_EDGES])
def test_flash_bf16_kernel_tile_edges(cuda_device, name, b, sq, sk, h, hkv,
                                      d, kw):
    """The wgmma kernel (the bf16 route) against the plain version where
    ragged ends, frontiers, a q offset and segment boundaries fall inside
    its tiles."""
    g = torch.Generator(device=cuda_device).manual_seed(3)

    def rnd(s, heads):
        return torch.randn(b, s, heads, d, generator=g,
                           device=cuda_device).to(torch.bfloat16)

    q, k, v = rnd(sq, h), rnd(sk, hkv), rnd(sk, hkv)
    kw = dict(kw)
    if kw.pop("segments", False):
        seg = torch.zeros(b, sq, dtype=torch.int32, device=cuda_device)
        seg[:, 77:] = 1
        seg[:, 200:] = 2
        seg[-1, 150:] = 3
        kw.update(seg_q=seg, seg_k=seg)
    before = tflash.flash_attention.launches
    kernels_before = tflash.forward_kernel_launches()
    out, lse = tflash.flash_forward(q, k, v, **kw)
    torch.cuda.synchronize()
    assert tflash.flash_attention.launches == before + 1
    kernels = tflash.forward_kernel_launches()
    assert {k_: kernels[k_] - kernels_before[k_] for k_ in kernels} == {
        "wgmma": 1, "mma_sync_f32": 0}
    ref, ref_lse = tflash.flash_attention_reference(q, k, v, **kw)
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2,
                               atol=2e-2)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-3, atol=1e-3)


@pytest.mark.cuda
def test_flash_wrapper_refuses_what_the_kernel_does_not_take(cuda_device):
    q = torch.randn(1, 64, 2, 256, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        tflash.flash_forward(q, q, q)
    q16 = torch.randn(1, 64, 2, 64, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        tflash.flash_forward(q16, q16, q16)
    odd = torch.randn(1, 64, 2, 68, device=cuda_device,
                      dtype=torch.bfloat16)[..., :64]
    with pytest.raises(ValueError, match="aligned"):
        tflash.flash_forward(odd, odd, odd)


@pytest.mark.cuda
def test_engine_on_card_matches_solo(cuda_device):
    """A tiny bf16 model served on the card: continuous batching emits
    what each prompt's solo greedy run emits, and prefill went through the
    kernel (the default head dim 16 pads to 64)."""
    from dataclasses import replace

    from ray_tpu_torch.models import llama, llama_decode
    from ray_tpu_torch.serve.decode import DecodeEngine

    cfg = replace(llama.PRESETS["debug"], attention_impl="flash",
                  dtype=torch.float32)
    params = llama.init_params(cfg, device=cuda_device, seed=0)
    eng = DecodeEngine(params, cfg, slots=4, capacity=64)
    prompts = [[5, 9, 2], [7], [11, 3, 4, 8, 1]]
    before = tflash.flash_attention.launches
    reqs = [eng.submit(p, max_new_tokens=6) for p in prompts]
    for _ in range(50):
        if all(r.done.is_set() for r in reqs):
            break
        eng.step()
    assert tflash.flash_attention.launches - before == \
        cfg.n_layers * eng.stats()["prefill_waves"]
    for p, r in zip(prompts, reqs):
        solo = llama_decode.generate(params, [p], cfg, max_new_tokens=6)
        assert r.output == solo[0].tolist()


def _bwd_case(dev, dtype, b, s, h, hkv, d, kw, with_dlse=False, seed=1):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    q, do = rnd(b, s, h, d), rnd(b, s, h, d)
    k, v = rnd(b, s, hkv, d), rnd(b, s, hkv, d)
    out, lse = tflash.flash_attention_reference(q, k, v, **kw)
    dlse = (torch.randn(b, h, s, generator=g, device=dev)
            if with_dlse else None)
    return q, k, v, out, lse, do, dlse


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,s,d,h,hkv,kw,with_dlse", [
    (torch.bfloat16, 256, 128, 4, 2, dict(causal=True), False),
    (torch.bfloat16, 200, 64, 4, 4, dict(causal=True, window=50), False),
    (torch.bfloat16, 192, 16, 4, 1, dict(causal=False), True),
    (torch.float32, 192, 128, 2, 2, dict(causal=True), True),
])
def test_flash_backward_kernels_match_plain(cuda_device, dtype, s, d, h,
                                            hkv, kw, with_dlse):
    q, k, v, out, lse, do, dlse = _bwd_case(cuda_device, dtype, 2, s, h, hkv,
                                            d, kw, with_dlse)
    dkv0 = tflash.flash_backward.dkv_launches
    dq0 = tflash.flash_backward.dq_launches
    got = tflash.flash_backward(q, k, v, out, lse, do, dlse, **kw)
    torch.cuda.synchronize()
    assert tflash.flash_backward.dkv_launches == dkv0 + 1
    assert tflash.flash_backward.dq_launches == dq0 + 1
    want = tflash.flash_backward_reference(q, k, v, out, lse, do, dlse, **kw)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        err = float((a.float() - r.float()).abs().max())
        assert err <= tol * float(r.float().abs().max()), (name, err)


@pytest.mark.cuda
def test_flash_backward_dead_rows_give_zero(cuda_device):
    """Query rows whose segment has no key get exactly zero gradient."""
    q, k, v, _, _, do, _ = _bwd_case(cuda_device, torch.bfloat16, 1, 128, 2,
                                     2, 128, dict(causal=False))
    seg_q = torch.zeros(1, 128, dtype=torch.int32, device=cuda_device)
    seg_q[:, 64:] = 3
    seg_k = torch.zeros(1, 128, dtype=torch.int32, device=cuda_device)
    kw = dict(causal=False, seg_q=seg_q, seg_k=seg_k)
    out, lse = tflash.flash_forward(q, k, v, **kw)
    dq, dk, dv = tflash.flash_backward(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert not dq[:, 64:].any()
    want = tflash.flash_backward_reference(q, k, v, out, lse, do, **kw)
    for a, r in zip((dq, dk, dv), want):
        assert float((a.float() - r.float()).abs().max()) <= \
            2e-2 * float(r.float().abs().max())


def _backward_kernels_since(before):
    now = tflash.backward_kernel_launches()
    return {k_: now[k_] - before[k_] for k_ in now}


def _segments(dev, b, s):
    """Segment ids with boundaries at 77, 200 and (last batch) 150."""
    seg = torch.zeros(b, s, dtype=torch.int32, device=dev)
    seg[:, 77:] = 1
    seg[:, 200:] = 2
    seg[-1, 150:] = 3
    return seg


# Edges of the bf16 backward kernels' tiles (128-row dQ tiles, 64-key
# dK/dV tiles and their 64-row q tiles): (name, B, S, H, Hkv, D, kwargs,
# with_dlse); equal Sq and Sk except where kwargs set sk.
BF16_BWD_TILE_EDGES = [
    ("s129_ragged", 2, 129, 4, 4, 128, dict(causal=True), False),
    ("s255_ragged", 2, 255, 4, 2, 128, dict(causal=True), False),
    ("sq200_sk328_q_offset128", 2, 200, 4, 4, 128,
     dict(causal=True, q_offset=128, sk=328), False),
    ("window100", 1, 512, 4, 4, 128, dict(causal=True, window=100), False),
    ("segments_off_grid", 2, 384, 4, 2, 128,
     dict(causal=True, segments=True), False),
    ("gqa32_8", 1, 300, 32, 8, 128, dict(causal=True), False),
    ("d64_s200", 2, 200, 4, 4, 64, dict(causal=True), False),
    ("lse_cotangent_gqa", 2, 256, 8, 2, 128, dict(causal=True), True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,b,s,h,hkv,d,kw,with_dlse",
                         BF16_BWD_TILE_EDGES,
                         ids=[c[0] for c in BF16_BWD_TILE_EDGES])
def test_flash_backward_bf16_kernels_tile_edges(cuda_device, name, b, s, h,
                                                hkv, d, kw, with_dlse):
    """The wgmma backward kernels against the plain version where ragged
    ends, frontiers, a q offset, segment boundaries and the lse cotangent
    fall inside their tiles; both launches took the wgmma kernels."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    kw = dict(kw)
    sk = kw.pop("sk", s)

    def rnd(n, heads):
        return torch.randn(b, n, heads, d, generator=g,
                           device=cuda_device).to(torch.bfloat16)

    q, do, k, v = rnd(s, h), rnd(s, h), rnd(sk, hkv), rnd(sk, hkv)
    if kw.pop("segments", False):
        seg = _segments(cuda_device, b, s)
        kw.update(seg_q=seg, seg_k=seg)
    out, lse = tflash.flash_attention_reference(q, k, v, **kw)
    dlse = (torch.randn(b, h, s, generator=g, device=cuda_device)
            if with_dlse else None)
    before = tflash.backward_kernel_launches()
    got = tflash.flash_backward(q, k, v, out, lse, do, dlse, **kw)
    torch.cuda.synchronize()
    assert _backward_kernels_since(before) == {
        "dkv_wgmma": 1, "dq_wgmma": 1, "dkv_mma_sync_f32": 0,
        "dq_mma_sync_f32": 0}
    want = tflash.flash_backward_reference(q, k, v, out, lse, do, dlse, **kw)
    for gname, a, r in zip(("dq", "dk", "dv"), got, want):
        err = float((a.float() - r.float()).abs().max())
        assert err <= 2e-2 * float(r.float().abs().max()), (gname, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,want", [
    (torch.bfloat16, ("dkv_wgmma", "dq_wgmma")),
    (torch.float32, ("dkv_mma_sync_f32", "dq_mma_sync_f32")),
])
def test_flash_backward_kernel_chosen_by_dtype(cuda_device, dtype, want):
    """A bf16 call launches the wgmma kernels and a float32 call the
    mma.sync hi/lo kernels, as the C entries count them."""
    q, k, v, out, lse, do, _ = _bwd_case(cuda_device, dtype, 1, 128, 2, 2,
                                         128, dict(causal=True))
    before = tflash.backward_kernel_launches()
    tflash.flash_backward(q, k, v, out, lse, do)
    torch.cuda.synchronize()
    assert _backward_kernels_since(before) == {
        k_: int(k_ in want) for k_ in tflash.BACKWARD_KERNELS}


@pytest.mark.cuda
def test_flash_backward_dead_rows_at_tile_edge_give_zero(cuda_device):
    """Rows from 128 on (a 128-row dQ tile's edge) whose segment has no
    key get exactly zero gradient from the bf16 kernels, and add nothing
    to dK / dV."""
    q, k, v, _, _, do, _ = _bwd_case(cuda_device, torch.bfloat16, 1, 256, 4,
                                     2, 128, dict(causal=True))
    seg_q = torch.zeros(1, 256, dtype=torch.int32, device=cuda_device)
    seg_q[:, 128:] = 7
    seg_k = torch.zeros(1, 256, dtype=torch.int32, device=cuda_device)
    kw = dict(causal=True, seg_q=seg_q, seg_k=seg_k)
    out, lse = tflash.flash_forward(q, k, v, **kw)
    dq, dk, dv = tflash.flash_backward(q, k, v, out, lse, do, **kw)
    torch.cuda.synchronize()
    assert not dq[:, 128:].any()
    want = tflash.flash_backward_reference(q, k, v, out, lse, do, **kw)
    for a, r in zip((dq, dk, dv), want):
        assert float((a.float() - r.float()).abs().max()) <= \
            2e-2 * float(r.float().abs().max())


@pytest.mark.cuda
def test_flash_attention_autograd_runs_the_kernels(cuda_device):
    q, k, v, _, _, do, _ = _bwd_case(cuda_device, torch.bfloat16, 2, 128, 4,
                                     2, 64, dict(causal=True))
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    dkv0 = tflash.flash_backward.dkv_launches
    out = tflash.flash_attention(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), do)
    assert tflash.flash_backward.dkv_launches == dkv0 + 1
    ref = tflash.flash_attention_reference(q, k, v)[0]
    want = torch.autograd.grad(ref, (q, k, v), do)
    for a, r in zip(grads, want):
        assert float((a.float() - r.float()).abs().max()) <= \
            2e-2 * float(r.float().abs().max())


def _splash_inputs(dev, dtype, b, sq, sk, h, hkv, d, seed=2):
    """(q, k, v, dO) from a seeded generator on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(dtype)

    return rnd(b, sq, h, d), rnd(b, sk, hkv, d), rnd(b, sk, hkv, d), \
        rnd(b, sq, h, d)


def _splash_masks(spec):
    from ray_tpu_torch.ops import splash_attention as ss

    kinds = {"full": ss.FullMask, "causal": ss.CausalMask,
             "local": ss.LocalMask, "chunked": ss.ChunkedMask}
    return [kinds[kind](*arg) for kind, *arg in spec]


_ALTERNATING = [("local", 96), ("full",)] * 4  # eight head groups


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,sq,sk,h,hkv,d,spec", [
    (torch.bfloat16, 2, 192, 192, 4, 2, 128,
     [("local", 50)] * 2 + [("chunked", 64)] * 2),
    (torch.bfloat16, 1, 100, 100, 4, 2, 64,
     [("causal",)] * 2 + [("full",)] * 2),
    (torch.bfloat16, 1, 256, 64, 2, 1, 80, [("local", 32)] * 2),
    (torch.float32, 1, 200, 328, 2, 2, 128, [("full",)] * 2),
    # The wgmma kernels' tile edges (128-row q tiles in the forward,
    # 64-key and 64-row tiles in dK/dV, statistics rows off a multiple of
    # 4), GQA 1, 2 and 4, B=2, D 64 and 128, and eight head groups in one
    # launch.
    (torch.bfloat16, 2, 129, 129, 4, 4, 128,
     [("local", 70)] * 2 + [("causal",)] * 2),
    (torch.bfloat16, 2, 255, 255, 8, 2, 64,
     [("chunked", 100)] * 4 + [("full",)] * 4),
    (torch.bfloat16, 2, 100, 100, 8, 2, 128,
     [("causal",)] * 4 + [("local", 30)] * 4),
    (torch.bfloat16, 2, 200, 328, 4, 2, 128,
     [("causal",)] * 2 + [("local", 64)] * 2),
    (torch.bfloat16, 2, 200, 328, 8, 2, 64, [("full",)] * 8),
    (torch.bfloat16, 2, 256, 64, 4, 2, 64, [("local", 32)] * 4),
    (torch.bfloat16, 1, 512, 512, 8, 8, 128, _ALTERNATING),
    (torch.float32, 1, 129, 129, 4, 2, 64,
     [("causal",)] * 2 + [("local", 40)] * 2),
    (torch.float32, 2, 255, 255, 8, 8, 128, _ALTERNATING),
])
def test_splash_kernels_match_plain(cuda_device, dtype, b, sq, sk, h, hkv, d,
                                    spec):
    """The three splash kernels against the plain versions, each once over
    all head groups (on wgmma for bf16, on mma.sync for float32, by the C
    entries' own counts), after one delta launch. Mixed local / chunked
    stacks, ragged S=100, 129 and 255, rows that see nothing (S=256
    queries on 64 keys under a 32 window), D=80 padded, Sq != Sk, GQA 1, 2
    and 4, eight alternating head groups."""
    from ray_tpu_torch.ops import splash_attention as ss

    masks = _splash_masks(spec)
    q, k, v, do = _splash_inputs(cuda_device, dtype, b, sq, sk, h, hkv, d)
    before = (ss.splash_attention.launches, ss.splash_backward.dkv_launches,
              ss.splash_backward.dq_launches, tflash.attention_delta.launches)
    by_kernel = ss.kernel_launches()
    out, lse = ss.splash_forward(q, k, v, masks)
    got = ss.splash_backward(q, k, v, out, lse, do, masks)
    torch.cuda.synchronize()
    after = (ss.splash_attention.launches, ss.splash_backward.dkv_launches,
             ss.splash_backward.dq_launches, tflash.attention_delta.launches)
    assert [a - b_ for a, b_ in zip(after, before)] == [1, 1, 1, 1]
    route = "wgmma" if dtype == torch.bfloat16 else "mma_sync_f32"
    want = {k_: 0 for k_ in ss.SPLASH_KERNELS}
    want.update({f"fwd_{route}": 1, f"dkv_{route}": 1, f"dq_{route}": 1})
    assert {k_: n - by_kernel[k_]
            for k_, n in ss.kernel_launches().items()} == want
    ref, ref_lse = ss.splash_attention_reference(q, k, v, masks)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(lse, ref_lse, rtol=1e-3, atol=1e-3)
    want = ss.splash_backward_reference(q, k, v, out, lse, do, masks)
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        err = float((a.float() - r.float()).abs().max())
        assert err <= tol * float(r.float().abs().max()), (name, err)


@pytest.mark.cuda
def test_splash_dead_rows_give_exact_zeros(cuda_device):
    """Queries 95.. see no key inside their window (q tiles 2-3 have no
    live kv tile and visit tile 0 fully masked): out, lse and dq are
    exactly 0, -1e30 and 0 there."""
    from ray_tpu_torch.ops import splash_attention as ss

    q, k, v, do = _splash_inputs(cuda_device, torch.bfloat16, 1, 256, 64, 2,
                                 1, 128)
    masks = [ss.LocalMask(32)] * 2
    out, lse = ss.splash_forward(q, k, v, masks)
    dq, dk, dv = ss.splash_backward(q, k, v, out, lse, do, masks)
    torch.cuda.synchronize()
    assert not out[:, 95:].any() and not dq[:, 95:].any()
    assert bool((lse[:, :, 95:] == -1e30).all())
    assert bool((lse[:, :, :95] > -1e29).all())
    assert bool(torch.isfinite(dk.float()).all())
    assert bool(torch.isfinite(dv.float()).all())


@pytest.mark.cuda
def test_splash_attention_autograd_runs_the_kernels(cuda_device):
    from ray_tpu_torch.ops import splash_attention as ss

    masks = _splash_masks([("local", 96)] * 2 + [("causal",)] * 2
                          + [("chunked", 128)] * 2 + [("full",)] * 2)
    q, k, v, do = _splash_inputs(cuda_device, torch.bfloat16, 1, 512, 512, 8,
                                 4, 128)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    fwd0, dkv0 = ss.splash_attention.launches, ss.splash_backward.dkv_launches
    dq0 = ss.splash_backward.dq_launches
    out = ss.splash_attention(q, k, v, mask=masks)
    grads = torch.autograd.grad(out, (q, k, v), do)
    # One forward, one dK/dV and one dQ launch over the four head groups.
    assert ss.splash_attention.launches == fwd0 + 1
    assert ss.splash_backward.dkv_launches == dkv0 + 1
    assert ss.splash_backward.dq_launches == dq0 + 1
    ref = ss.splash_attention_reference(q, k, v, masks)[0]
    want = torch.autograd.grad(ref, (q, k, v), do)
    for a, r in zip(grads, want):
        assert float((a.float() - r.float()).abs().max()) <= \
            2e-2 * float(r.float().abs().max())


@pytest.mark.cuda
def test_splash_kernels_refuse_masks_they_do_not_know(cuda_device):
    from ray_tpu_torch.ops import splash_attention as ss

    class Diagonal(ss.Mask):
        def live_tile(self, i, j, bq, bk):
            return i * bq < (j + 1) * bk and j * bk < (i + 1) * bq

        def full_tile(self, i, j, bq, bk):
            return False

        def apply(self, s, rows, cols):
            return torch.where(rows == cols, s, -1e30)

    q = torch.randn(1, 64, 2, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="FullMask, CausalMask"):
        ss.splash_attention(q, q, q, mask=Diagonal())


# dQ's edges (128-row q tiles and 64-key tiles in bf16, 64 x 64 in
# float32): (dtype, B, Sq, Sk, H, Hkv, D, masks); "local32" on 256 queries
# and 64 keys leaves q tiles with nothing live (queries 95..).
SPLASH_DQ_EDGES = [
    (torch.bfloat16, 1, 256, 64, 2, 1, 128, [("local", 32)] * 2),
    (torch.bfloat16, 2, 256, 64, 4, 2, 64, [("local", 32)] * 4),
    (torch.bfloat16, 2, 129, 129, 4, 4, 128,
     [("local", 70)] * 2 + [("causal",)] * 2),
    (torch.bfloat16, 1, 200, 328, 8, 2, 128,
     [("chunked", 48)] * 4 + [("full",)] * 4),
    (torch.float32, 1, 256, 64, 2, 1, 128, [("local", 32)] * 2),
    (torch.float32, 2, 129, 129, 4, 2, 64,
     [("causal",)] * 2 + [("local", 40)] * 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,sq,sk,h,hkv,d,spec", SPLASH_DQ_EDGES)
def test_splash_dq_kernel_matches_plain(cuda_device, dtype, b, sq, sk, h, hkv,
                                        d, spec):
    """The dQ kernel alone (one launch over all head groups, on
    ``dq_wgmma`` for bf16 and ``dq_mma_sync_f32`` for float32) against the
    plain backward's dq on the same (out, lse, delta); rows that nothing
    reaches get exactly zero."""
    from ray_tpu_torch.ops import splash_attention as ss

    masks = _splash_masks(spec)
    q, k, v, do = _splash_inputs(cuda_device, dtype, b, sq, sk, h, hkv, d,
                                 seed=5)
    out, lse = ss.splash_attention_reference(q, k, v, masks)
    delta = tflash.attention_delta_reference(out, do)
    launch, (dq, _, _) = ss._splash_backward_launcher(
        q, k, v, do, lse, delta, masks, d ** -0.5)
    before = ss.kernel_launches()
    launch("dq")
    torch.cuda.synchronize()
    route = "wgmma" if dtype == torch.bfloat16 else "mma_sync_f32"
    assert {k_: n - before[k_] for k_, n in ss.kernel_launches().items()} \
        == {k_: int(k_ == f"dq_{route}") for k_ in ss.SPLASH_KERNELS}
    want = ss.splash_backward_reference(q, k, v, out, lse, do, masks)[0]
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    err = float((dq.float() - want.float()).abs().max())
    assert err <= tol * float(want.float().abs().max()), err
    dead = lse <= -1e29  # (B, H, Sq): rows nothing reaches
    assert not dq.transpose(1, 2)[dead].any()


# The delta pre-pass on the shapes and layouts the backward paths hand
# it: (name, dtype, B, S, H, D, layout); "bhsd" is the (B, S, H, D) view
# of a (B, H, S, D) tensor that flash_attention_stats passes.
DELTA_EDGES = [
    ("train_1b", torch.bfloat16, 4, 2048, 16, 128, "bshd"),
    ("s129", torch.bfloat16, 2, 129, 4, 128, "bshd"),
    ("d64", torch.bfloat16, 2, 200, 4, 64, "bshd"),
    ("d80", torch.bfloat16, 2, 200, 4, 80, "bshd"),
    ("d16", torch.bfloat16, 2, 64, 4, 16, "bshd"),
    ("f32", torch.float32, 2, 255, 4, 128, "bshd"),
    ("bhsd_view", torch.bfloat16, 2, 256, 4, 128, "bhsd"),
    ("head_dim_strided", torch.bfloat16, 1, 64, 2, 64, "strided"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype,b,s,h,d,layout", DELTA_EDGES,
                         ids=[c[0] for c in DELTA_EDGES])
def test_attention_delta_kernel_matches_plain(cuda_device, name, dtype, b, s,
                                              h, d, layout):
    """``delta.cu``'s kernel against ``attention_delta_reference``: one
    launch, (B, H, S) fp32 contiguous, within 1e-5 of the largest |delta|
    (fp32 sums of the same fp32 products, in another order)."""
    g = torch.Generator(device=cuda_device).manual_seed(6)

    def rnd():
        if layout == "bhsd":
            return torch.randn(b, h, s, d, generator=g, device=cuda_device
                               ).to(dtype).transpose(1, 2)
        if layout == "strided":  # every other element of the head dim
            return torch.randn(b, s, h, 2 * d, generator=g, device=cuda_device
                               ).to(dtype)[..., ::2]
        return torch.randn(b, s, h, d, generator=g, device=cuda_device
                           ).to(dtype)

    out, do = rnd(), rnd()
    before = tflash.attention_delta.launches
    got = tflash.attention_delta(out, do)
    torch.cuda.synchronize()
    assert tflash.attention_delta.launches == before + 1
    want = tflash.attention_delta_reference(out, do)
    assert got.dtype == torch.float32 and got.shape == (b, h, s)
    assert got.is_contiguous()
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err


def _solo_greedy(params, cfg, prompt, n, dev):
    """Solo contiguous greedy decode on the card: (tokens, top-2 logit
    margins behind each)."""
    from ray_tpu_torch.models import llama_decode as td

    toks = torch.as_tensor(prompt, device=dev)[None]
    cache = td.init_cache(cfg, 1, td.cache_bucket(len(prompt) + n),
                          device=dev)
    logits, cache = td.prefill(params, toks, cache, cfg)
    out, margins = [], []
    for _ in range(n):
        top2 = torch.topk(logits[0], 2).values
        margins.append(float(top2[0] - top2[1]))
        out.append(int(torch.argmax(logits[0])))
        logits, cache = td.decode_step(
            params, cache, torch.tensor([out[-1]], dtype=torch.int32,
                                        device=dev), cfg)
    return out, margins


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3),
                                       (torch.bfloat16, 5e-2)])
def test_paged_engine_matches_contiguous_engine(cuda_device, dtype, tol):
    """A tiny paged engine (16-token pages, an overcommitted pool, 32-token
    prefill chunks, the device sampler) against a tiny contiguous engine
    on the card, prefills on the flash kernel: greedy streams agree with
    solo contiguous runs under the margin rule (tokens compared while the
    solo top-2 margin exceeds ``tol``), and every page comes back."""
    from dataclasses import replace

    import numpy as np

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.decode import DecodeEngine

    cfg = replace(llama.PRESETS["debug"], dim=256, n_heads=4, n_kv_heads=2,
                  max_seq_len=512, attention_impl="flash", dtype=dtype)
    params = llama.init_params(cfg, device=cuda_device, seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (5, 20, 70, 130, 17, 40)]
    prompts.append(prompts[2][:64] + [3, 4, 5])  # a prefix hit on 70's
    launches0 = tflash.flash_attention.launches
    outs = {}
    for mode, kw in (("contiguous", {}),
                     ("paged", dict(page_tokens=16, pool_pages=24,
                                    prefill_chunk_tokens=32,
                                    device_sampler=True))):
        eng = DecodeEngine(params, cfg, slots=4, capacity=256,
                           prefix_match_min_tokens=16, device=cuda_device,
                           **kw)
        reqs = [eng.submit(p, max_new_tokens=24) for p in prompts]
        for _ in range(2000):
            if all(r.done.is_set() for r in reqs):
                break
            eng.step()
        assert all(r.status == "completed" for r in reqs)
        outs[mode] = [r.output for r in reqs]
        s = eng.stats()
        if mode == "paged":
            assert s["preempted"] + s["prefill_chunks"] > 0
            assert s["pages_free"] + s["pages_pinned"] == 24
    assert tflash.flash_attention.launches > launches0
    for p, c, g in zip(prompts, outs["contiguous"], outs["paged"]):
        want, margins = _solo_greedy(params, cfg, p, 24, cuda_device)
        for got in (c, g):
            for i, (a, b) in enumerate(zip(got, want)):
                if margins[i] <= tol:
                    break
                assert a == b, (i, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("draft", ["seeded", "perfect"])
def test_spec_engine_matches_plain_paged_engine(cuda_device, draft):
    """The spec engine on the card (the debug preset in bf16, prefills on
    the flash kernel, k = 4, 16-token pages, a draft pool that cannot
    seat every prompt) against the plain paged engine: greedy streams
    agree with solo contiguous runs under the margin rule (tol 5e-2, as
    for the bf16 paged engine above), a draft equal to the target accepts
    proposals, and every page of both pools comes back."""
    from dataclasses import replace

    import numpy as np

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.decode import DecodeEngine

    tol = 5e-2
    cfg = replace(llama.PRESETS["debug"], max_seq_len=512,
                  attention_impl="flash", dtype=torch.bfloat16)
    params = llama.init_params(cfg, device=cuda_device, seed=0)
    dparams = (params if draft == "perfect" else
               llama.init_params(cfg, device=cuda_device, seed=1))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, n).tolist()
               for n in (5, 20, 70, 130, 17, 40)]
    launches0 = tflash.flash_attention.launches
    outs = {}
    for mode, kw in (("plain", {}),
                     ("spec", dict(spec_draft_params=dparams,
                                   spec_draft_config=cfg, spec_k=4,
                                   spec_draft_pool_pages=16))):
        eng = DecodeEngine(params, cfg, slots=4, capacity=256,
                           page_tokens=16, pool_pages=64,
                           prefix_pool_entries=0, device=cuda_device, **kw)
        reqs = [eng.submit(p, max_new_tokens=24) for p in prompts]
        for _ in range(2000):
            if all(r.done.is_set() for r in reqs):
                break
            eng.step()
        assert all(r.status == "completed" for r in reqs)
        outs[mode] = [r.output for r in reqs]
        s = eng.stats()
        assert s["pages_free"] == 64
        if mode == "spec":
            spec = s["spec"]
            assert spec["rounds"] > 0
            assert spec["draft_pages_free"] == spec["draft_pages_total"]
            if draft == "perfect":
                assert spec["accepted_tokens"] > 0
    assert tflash.flash_attention.launches > launches0
    for p, a, b in zip(prompts, outs["plain"], outs["spec"]):
        want, margins = _solo_greedy(params, cfg, p, 24, cuda_device)
        for got in (a, b):
            for i, (x, y) in enumerate(zip(got, want)):
                if margins[i] <= tol:
                    break
                assert x == y, (i, got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2),
                                       (torch.float32, 1e-4)])
def test_loopback_ring_matches_full_flash(cuda_device, dtype, tol):
    """Ring attention's flash body (``ring_flash_attention_local``) for
    each of 4 virtual ranks of 128 tokens, K/V rotated by indexing through
    its ``ring`` argument: output and gradients against one full
    ``flash_attention`` call; the 6 dead hops launch nothing, the 4
    diagonal and 6 visible hops one forward and one backward each."""
    import torch_dist

    n, sl, h, hkv, d = 4, 128, 4, 2, 128
    g = torch.Generator(device=cuda_device).manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=g,  # noqa: E731
                                device=cuda_device).to(dtype)
    q, k, v, do = mk(1, n * sl, h, d), mk(1, n * sl, hkv, d), \
        mk(1, n * sl, hkv, d), mk(1, n * sl, h, d)

    def run(fn):
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        out.backward(do)
        return [out.detach()] + [t.grad for t in leaves]

    want = run(lambda *a: tflash.flash_attention(*a))
    f0, dkv0 = tflash.flash_attention.launches, \
        tflash.flash_backward.dkv_launches
    got = run(lambda *a: torch_dist.loopback_ring(*a, n))
    assert tflash.flash_attention.launches - f0 == 10
    assert tflash.flash_backward.dkv_launches - dkv0 == 10
    for a, b in zip(got, want):
        err = float((a.float() - b.float()).abs().max())
        assert err <= tol * float(b.float().abs().max()), err
