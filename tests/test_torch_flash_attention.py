"""The port's flash attention vs the JAX package's Pallas kernel.

On the CPU the port runs ``flash_attention_reference`` (a CPU tensor never
reaches the CUDA kernel); the JAX side runs its Pallas kernel in interpret
mode, as ``tests/test_flash_attention.py`` does. float32 compares at
rtol = atol = 2e-5 (the tolerance the JAX package's own flash tests use:
online softmax vs one-pass softmax reorder fp32 sums); bfloat16 at
rtol = atol = 2e-2 (P is rounded to bf16 before P·V on both sides, at
different tile boundaries).

The Hopper kernel itself is held against the plain version on a card by
``tests/test_torch_kernels_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jflash
from ray_tpu_torch.ops import flash_attention as tflash

torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32
torch.backends.cudnn.allow_tf32 = False

F32 = dict(rtol=2e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _inputs(b, sq, sk, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, h, d)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, d)).astype(np.float32),
            rng.normal(size=(b, sk, hkv, d)).astype(np.float32))


def _both(q, k, v, dtype="f32", **kw):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jkw = {k_: (jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_)
           for k_, v_ in kw.items()}
    tkw = {k_: (torch.from_numpy(v_) if isinstance(v_, np.ndarray) else v_)
           for k_, v_ in kw.items()}
    out_j = jflash.flash_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                   **jkw)
    out_t = tflash.flash_attention(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), **tkw)
    assert out_t.dtype == tdt
    return (np.asarray(out_j.astype(jnp.float32)), out_t.float().numpy())


@pytest.mark.parametrize("case", [
    dict(causal=True), dict(causal=False), dict(causal=True, window=32),
    dict(causal=False, window=48)])
def test_flash_forward_masks(case):
    q, k, v = _inputs(1, 128, 128, 2, 2, 64)
    want, got = _both(q, k, v, block_q=64, block_k=64, **case)
    np.testing.assert_allclose(got, want, **F32)


def test_flash_q_offset_chunk():
    """A later query chunk of a longer sequence (chunked prefill / ring
    shard): the causal frontier shifts by q_offset."""
    q, k, v = _inputs(2, 64, 128, 2, 2, 64, seed=1)
    want, got = _both(q, k, v, causal=True, q_offset=64, block_q=64,
                      block_k=64)
    np.testing.assert_allclose(got, want, **F32)


def test_flash_segments_and_gqa():
    q, k, v = _inputs(2, 128, 128, 4, 2, 16, seed=2)
    seg = np.zeros((2, 128), np.int32)
    seg[:, 50:] = 1
    seg[1, 100:] = 2
    want, got = _both(q, k, v, causal=True, segment_ids=seg, block_q=64,
                      block_k=64)
    np.testing.assert_allclose(got, want, **F32)


def test_flash_kv_segments_with_dead_rows():
    """Query rows whose segment has no key anywhere get out 0."""
    q, k, v = _inputs(1, 64, 64, 2, 1, 16, seed=3)
    seg_q = np.zeros((1, 64), np.int32)
    seg_q[:, 32:] = 7           # segment 7 has no keys: dead rows
    seg_k = np.zeros((1, 64), np.int32)
    want, got = _both(q, k, v, causal=False, segment_ids=seg_q,
                      kv_segment_ids=seg_k, block_q=32, block_k=32)
    np.testing.assert_allclose(got, want, **F32)
    assert not got[0, 32:].any()


def _off_grid_segments(b, s):
    seg = np.zeros((b, s), np.int32)
    seg[:, 77:] = 1
    seg[:, 200:] = 2
    seg[-1, 150:] = 3
    return seg


# The bf16 Hopper kernel works in 128-row q tiles and 128-key kv tiles;
# these shapes put ragged ends, the causal and window frontiers, a q
# offset with Sq != Sk and segment boundaries inside and across such
# tiles. The JAX side takes blocks that divide the lengths, as it
# requires: (name, (B, Sq, Sk, H, Hkv, D), (block_q, block_k), kwargs,
# dtype).
TILE_EDGES = [
    ("s129_ragged", (2, 129, 129, 2, 2, 64), (129, 129), dict(causal=True),
     "f32"),
    ("s255_ragged_gqa", (1, 255, 255, 4, 2, 64), (85, 85), dict(causal=True),
     "f32"),
    ("sq200_sk328_q_offset128", (1, 200, 328, 2, 2, 64), (100, 164),
     dict(causal=True, q_offset=128), "f32"),
    ("window100", (1, 256, 256, 2, 2, 64), (128, 128),
     dict(causal=True, window=100), "f32"),
    ("segments_off_grid", (2, 256, 256, 2, 1, 64), (128, 128),
     dict(causal=True, segment_ids=_off_grid_segments(2, 256)), "f32"),
    ("gqa32_8", (1, 64, 64, 32, 8, 16), (64, 64), dict(causal=True), "f32"),
    ("d64_s200_bf16", (1, 200, 200, 2, 2, 64), (200, 200),
     dict(causal=True), "bf16"),
]


@pytest.mark.parametrize("name,shape,blocks,kw,dtype", TILE_EDGES,
                         ids=[c[0] for c in TILE_EDGES])
def test_flash_forward_tile_edges(name, shape, blocks, kw, dtype):
    q, k, v = _inputs(*shape, seed=6)
    want, got = _both(q, k, v, dtype=dtype, block_q=blocks[0],
                      block_k=blocks[1], **kw)
    np.testing.assert_allclose(got, want, **(F32 if dtype == "f32" else BF16))


def test_flash_bf16_matches():
    q, k, v = _inputs(1, 128, 128, 4, 4, 64, seed=4)
    want, got = _both(q, k, v, dtype="bf16", causal=True, block_q=64,
                      block_k=64)
    np.testing.assert_allclose(got, want, **BF16)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 40)])
def test_flash_stats_match(causal, window):
    q, k, v = _inputs(1, 128, 128, 2, 2, 64, seed=5)
    # flash_attention_stats takes (B, H, S, D).
    qt, kt, vt = (a.transpose(0, 2, 1, 3).copy() for a in (q, k, v))
    out_j, lse_j = jflash.flash_attention_stats(
        jnp.asarray(qt), jnp.asarray(kt), jnp.asarray(vt), 64 ** -0.5,
        causal, window, 0, 64, 64)
    out_t, lse_t = tflash.flash_attention_stats(
        torch.from_numpy(qt), torch.from_numpy(kt), torch.from_numpy(vt),
        64 ** -0.5, causal, window, 0, 64, 64)
    assert lse_t.shape == (1, 2, 128)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **F32)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **F32)


def test_flash_dead_rows_lse_convention():
    """A row nothing reaches: out 0 and lse -1e30, as the TPU kernel."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 1, 1, 16))
    seg_q = torch.zeros(1, 8, dtype=torch.int32)
    seg_k = torch.ones(1, 8, dtype=torch.int32)
    out, lse = tflash.flash_attention_reference(q, k, v, causal=False,
                                                seg_q=seg_q, seg_k=seg_k)
    assert not out.any()
    assert torch.all(lse == -1e30)


def test_flash_value_errors_match():
    x = torch.zeros(1, 128, 4, 16)
    kv3 = torch.zeros(1, 128, 3, 16)
    with pytest.raises(ValueError, match="not a multiple of kv heads"):
        tflash.flash_attention(x, kv3, kv3)
    with pytest.raises(ValueError, match="must divide blocks"):
        tflash.flash_attention(x[:, :96], x[:, :96], x[:, :96], block_q=64,
                               block_k=64)
    with pytest.raises(ValueError, match="kv_segment_ids requires"):
        tflash.flash_attention(x, x, x,
                               kv_segment_ids=torch.zeros(1, 128))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tflash.flash_attention(*(torch.zeros(1, 8, 1, 16, device="meta")
                                 for _ in range(3)))

