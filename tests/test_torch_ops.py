"""Port ops vs the JAX package on the CPU: rms_norm, RoPE, attention.

float32 compares at rtol = atol = 1e-5: both sides run the same fp32 math
and differ only in reduction order (gradients too: ``jax.grad`` against
autograd, under the same numpy cotangent). bfloat16 compares at one bf16 ulp of
the result scale (rtol = atol = 1e-2): a reordered fp32 sum can round to
the neighbouring bf16 value."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as jattn
from ray_tpu.ops import norms as jnorms
from ray_tpu.ops import rotary as jrot
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.ops import norms as tnorms
from ray_tpu_torch.ops import rotary as trot

torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32
torch.backends.cudnn.allow_tf32 = False

TOL = {"f32": dict(rtol=1e-5, atol=1e-5), "bf16": dict(rtol=1e-2, atol=1e-2)}
DT = {"f32": (jnp.float32, torch.float32),
      "bf16": (jnp.bfloat16, torch.bfloat16)}


def _pair(x: np.ndarray, dtype: str):
    jdt, tdt = DT[dtype]
    return jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rms_norm_matches(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    w = rng.normal(size=(48,)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    out_j = jnorms.rms_norm(jx, jnp.asarray(w), 1e-5)
    out_t = tnorms.rms_norm(tx, torch.from_numpy(w), 1e-5)
    assert out_t.dtype == tx.dtype
    np.testing.assert_allclose(_np(out_t), _np(out_j), **TOL[dtype])


def test_rope_tables_match():
    cj, sj = jrot.rope_frequencies(16, 64, 10000.0)
    ct, st = trot.rope_frequencies(16, 64, 10000.0)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("with_positions", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_apply_rope_matches(with_positions, dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    jx, tx = _pair(x, dtype)
    cj, sj = jrot.rope_frequencies(16, 64)
    ct, st = trot.rope_frequencies(16, 64)
    if with_positions:
        pos = rng.integers(0, 64, size=(2, 7)).astype(np.int32)
        out_j = jrot.apply_rope(jx, cj, sj, positions=jnp.asarray(pos))
        out_t = trot.apply_rope(tx, ct, st,
                                positions=torch.from_numpy(pos).long())
    else:
        out_j = jrot.apply_rope(jx, cj, sj)
        out_t = trot.apply_rope(tx, ct, st)
    assert out_t.dtype == tx.dtype
    np.testing.assert_allclose(_np(out_t), _np(out_j), **TOL[dtype])


@pytest.mark.parametrize("impl", ["xla", "chunked"])
@pytest.mark.parametrize("causal,q_offset,hkv", [
    (True, 0, 4), (False, 0, 4), (True, 0, 2), (True, 16, 1)])
def test_attention_matches(impl, causal, q_offset, hkv):
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 32, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 32, hkv, 16)).astype(np.float32)
    v = rng.normal(size=(2, 32, hkv, 16)).astype(np.float32)
    out_j = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            causal=causal, q_offset=q_offset, impl=impl,
                            chunk_size=8)
    out_t = tattn.attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=causal,
                            q_offset=q_offset, impl=impl, chunk_size=8)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               **TOL["f32"])


def test_attention_bf16_and_kv_valid_match():
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(1, 24, 2, 16)).astype(np.float32)
               for _ in range(3))
    args_j = [jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)]
    args_t = [torch.from_numpy(a).bfloat16() for a in (q, k, v)]
    out_j = jattn.attention(*args_j, causal=True, kv_valid=17)
    out_t = tattn.attention(*args_t, causal=True, kv_valid=17)
    assert out_t.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out_t), _np(out_j), **TOL["bf16"])


def test_attention_errors_match():
    x = torch.zeros(1, 8, 2, 4)
    with pytest.raises(ValueError, match="unknown attention impl"):
        tattn.attention(x, x, x, impl="nope")
    with pytest.raises(ValueError, match="kv_valid"):
        tattn.attention(x, x, x, impl="chunked", kv_valid=4)
    with pytest.raises(ValueError, match="not divisible"):
        tattn.attention(x, x, x, impl="chunked", chunk_size=3)


def _vjp_pair(fn_j, fn_t, inputs, cotangent):
    """Gradients of both sides' functions of ``inputs`` (numpy, float32)
    under the same cotangent: (JAX grads, port grads) as numpy."""
    import jax

    _, vjp = jax.vjp(fn_j, *(jnp.asarray(a) for a in inputs))
    want = vjp(jnp.asarray(cotangent))
    targs = [torch.from_numpy(a).requires_grad_() for a in inputs]
    got = torch.autograd.grad(fn_t(*targs), targs,
                              torch.from_numpy(cotangent))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


@pytest.mark.parametrize("impl", ["xla", "chunked"])
@pytest.mark.parametrize("causal,hkv", [(True, 4), (False, 2)])
def test_attention_grads_match(impl, causal, hkv):
    """The plain and the chunked paths differentiate (the chunked one
    through its per-chunk checkpoints) to ``jax.grad`` of the JAX ones."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=(2, 32, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, 32, hkv, 16)).astype(np.float32)
    v = rng.normal(size=(2, 32, hkv, 16)).astype(np.float32)
    do = rng.normal(size=(2, 32, 4, 16)).astype(np.float32)
    kw = dict(causal=causal, impl=impl, chunk_size=8)
    want, got = _vjp_pair(lambda *a: jattn.attention(*a, **kw),
                          lambda *a: tattn.attention(*a, **kw), (q, k, v),
                          do)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL["f32"])


def test_rms_norm_and_rope_grads_match():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    want, got = _vjp_pair(lambda a, b: jnorms.rms_norm(a, b, 1e-5),
                          lambda a, b: tnorms.rms_norm(a, b, 1e-5), (x, w),
                          dy)
    for g, w_ in zip(got, want):
        np.testing.assert_allclose(g, w_, **TOL["f32"])
    cj, sj = jrot.rope_frequencies(16, 64)
    ct, st = trot.rope_frequencies(16, 64)
    want, got = _vjp_pair(lambda a: jrot.apply_rope(a, cj, sj),
                          lambda a: trot.apply_rope(a, ct, st), (x,), dy)
    np.testing.assert_allclose(got[0], want[0], **TOL["f32"])
