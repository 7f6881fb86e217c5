"""Attention ops (port of ``ray_tpu/ops/attention.py``): the plain path
and the chunked online-softmax path, one signature.

* ``impl="xla"``: plain softmax over the full (B, H, Sq, Sk) scores.
* ``impl="chunked"``: online softmax over KV chunks; never materializes
  the full score matrix. Each chunk's step runs under
  ``torch.utils.checkpoint`` (the JAX package's ``jax.checkpoint``), so the
  backward recomputes that chunk's probabilities and keeps O(S * chunk)
  live.

Both keep the JAX package's numerics: scores and the softmax statistics in
fp32, probabilities rounded to the value dtype before P·V on the plain
path. GQA repeats K/V heads to match the query heads. Shapes are
(batch, seq, heads, head_dim) throughout. This is the non-flash branch of
``models.llama._decoder_layer`` and the oracle the small tests use.

``attention_block_stats``, ``merge_attention_stats`` and
``finalize_attention`` are the pieces of the ring's ``xla`` impl
(``parallel.ring_attention.ring_attention_local``): one block's
unnormalized accumulator and softmax statistics, their log-sum-exp merge,
and the division at the end.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

_NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    return k if n_rep == 1 else k.repeat_interleave(n_rep, dim=2)


def _mask(sq: int, sk: int, q_offset: int, kv_offset: int,
          device) -> torch.Tensor:
    q_pos = q_offset + torch.arange(sq, device=device)[:, None]
    k_pos = kv_offset + torch.arange(sk, device=device)[None, :]
    return q_pos >= k_pos


def attention(
    q: torch.Tensor,                 # (B, Sq, Hq, D)
    k: torch.Tensor,                 # (B, Sk, Hkv, D)
    v: torch.Tensor,                 # (B, Sk, Hkv, D)
    causal: bool = True,
    q_offset: int = 0,
    kv_offset: int = 0,
    impl: str = "xla",
    chunk_size: int = 512,
    kv_valid: Optional[int] = None,
) -> torch.Tensor:
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    if impl == "xla":
        return _attention_xla(q, k, v, causal, q_offset, kv_offset,
                              kv_valid)
    if impl == "chunked":
        if kv_valid is not None:
            raise ValueError("kv_valid is only supported by impl='xla'")
        return _attention_chunked(q, k, v, causal, q_offset, kv_offset,
                                  chunk_size)
    raise ValueError(f"unknown attention impl {impl!r}")


def attention_block_stats(q, k, v, causal, q_offset, kv_offset):
    """One attention block's *unnormalized* accumulator and softmax
    statistics: (acc (B, H, Sq, D) fp32, m (B, H, Sq), l (B, H, Sq)), all
    in fp32 (scores, probabilities and P·V)."""
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = _mask(q.shape[1], k.shape[1], q_offset, kv_offset, q.device)
        scores = scores.masked_fill(~mask, _NEG_INF)
    m = scores.amax(dim=-1)
    p = torch.exp(scores - m.clamp_min(_NEG_INF / 2)[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhqk,bkhd->bhqd", p, v.float())
    return acc, m, l


def merge_attention_stats(acc1, m1, l1, acc2, m2, l2):
    """Log-sum-exp merge of two partial attention results."""
    m = torch.maximum(m1, m2)
    m_safe = m.clamp_min(_NEG_INF / 2)
    c1 = torch.exp(m1.clamp_min(_NEG_INF / 2) - m_safe)
    c2 = torch.exp(m2.clamp_min(_NEG_INF / 2) - m_safe)
    acc = acc1 * c1[..., None] + acc2 * c2[..., None]
    return acc, m, l1 * c1 + l2 * c2


def finalize_attention(acc, l, dtype):
    """(B, H, S, D) accumulator over its row sums -> (B, S, H, D) output in
    ``dtype``; rows with nothing live stay zero."""
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).permute(0, 2, 1, 3).to(dtype)


def _attention_xla(q, k, v, causal, q_offset, kv_offset, kv_valid=None):
    scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = _mask(q.shape[1], k.shape[1], q_offset, kv_offset, q.device)
        scores = scores.masked_fill(~mask, _NEG_INF)
    if kv_valid is not None and kv_valid < k.shape[1]:
        alive = torch.arange(k.shape[1], device=q.device) < kv_valid
        scores = scores.masked_fill(~alive, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    p32 = torch.exp(scores - m.clamp_min(_NEG_INF / 2))
    l = p32.sum(dim=-1, keepdim=True)
    p = p32.to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", p.float(), v.float())
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = out / l_safe.permute(0, 2, 1, 3)
    return out.to(q.dtype)


def _chunk_step(acc, m, l, q32, k_c, v_c, mask, scale):
    """One online-softmax update over a KV chunk (checkpointed by the
    caller)."""
    scores = torch.einsum("bqhd,bkhd->bhqk", q32, k_c.float()) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, _NEG_INF)
    m_new = torch.maximum(m, scores.amax(dim=-1))
    m_safe = m_new.clamp_min(_NEG_INF / 2)
    p = torch.exp(scores - m_safe[..., None])
    corr = torch.exp(m.clamp_min(_NEG_INF / 2) - m_safe)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                               v_c.float())
    return acc, m_new, l


def _attention_chunked(q, k, v, causal, q_offset, kv_offset, chunk_size):
    b, sq, h, d = q.shape
    sk = k.shape[1]
    chunk_size = min(chunk_size, sk)
    if sk % chunk_size != 0:
        raise ValueError(f"kv length {sk} not divisible by chunk {chunk_size}")
    scale = d ** -0.5
    q32 = q.float()
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), _NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    for idx in range(sk // chunk_size):
        sl = slice(idx * chunk_size, (idx + 1) * chunk_size)
        mask = (_mask(sq, chunk_size, q_offset, kv_offset + idx * chunk_size,
                      q.device) if causal else None)
        args = (acc, m, l, q32, k[:, sl], v[:, sl], mask, scale)
        if grad:
            acc, m, l = checkpoint(_chunk_step, *args, use_reentrant=False)
        else:
            acc, m, l = _chunk_step(*args)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return (acc / l_safe[..., None]).permute(0, 2, 1, 3).to(q.dtype)
