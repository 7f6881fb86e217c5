"""Ring attention: sequence parallelism over the ``seq`` mesh axis (port
of ``ray_tpu/parallel/ring_attention.py``).

Each rank holds a contiguous sequence shard of Q, K and V; the K/V shards
rotate around the ring and the partial results merge by the log-sum-exp
rule, so the full sequence is never gathered. The JAX ``lax.ppermute``
is ``_Rotate``, an autograd function around ``dist.batch_isend_irecv``
whose backward rotates the gradient the other way (what JAX gets by
differentiating ``ppermute``): the gradient of a K/V shard arrives one
rotation late, on the rank that held it.

Two impls, as in the JAX package:

* ``"xla"`` (``ring_attention_local``): plain fp32 block statistics from
  ``ops.attention``, every hop computed (masked hops contribute zero).
* ``"flash"`` (``ring_flash_attention_local``): each hop is one
  ``flash_attention_stats`` call, the Hopper flash kernels on a card,
  with the lse cotangent in the backward. Under a causal mask a hop is
  all or nothing at shard granularity, so a hop whose K/V shard lies
  ahead of the local queries launches nothing (``_ring_hop``).

``ring_attention`` is the ``shard_map`` wrapper over global tensors.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ray_tpu_torch.ops.attention import (
    attention_block_stats,
    finalize_attention,
    merge_attention_stats,
)
from ray_tpu_torch.parallel.mesh import axis_sizes
from ray_tpu_torch.parallel.sharding import shard_map

_NEG_INF = -1e30


def ring_position(mesh, axis_name: str = "seq"):
    """(group, rank, n) of this rank on ``mesh``'s ``axis_name`` ring;
    ``(None, 0, 1)`` when the mesh lacks the axis or it has size 1."""
    n = axis_sizes(mesh).get(axis_name, 1)
    if n == 1:
        return None, 0, 1
    return (mesh.get_group(axis_name), mesh.get_local_rank(axis_name), n)


def _send_recv(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """Send ``x`` to the rank ``shift`` places on and receive from the
    rank ``shift`` places back. Every rank posts the same two ops in the
    same order (at n = 2 both peers are one rank)."""
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (rank + shift) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (rank - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Rotate(torch.autograd.Function):
    """One ring rotation (``lax.ppermute`` with ``perm = [(j, j+1)]``);
    the backward sends the gradient back the way the value came."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _send_recv(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _send_recv(g, ctx.group, -1), None


def rotate(x: torch.Tensor, group) -> torch.Tensor:
    return _Rotate.apply(x, group)


class _Anchor(torch.autograd.Function):
    """``out`` unchanged, with a zero gradient for ``kv``: the last rotated
    K/V shard then always reaches the backward, so every rank runs every
    rotation's backward (its send/recv pair), even a rank whose last hops
    were dead and used no K/V."""

    @staticmethod
    def forward(ctx, out, kv):
        ctx.kv_meta = (kv.shape, kv.dtype, kv.device)
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.kv_meta
        return g, torch.zeros(shape, dtype=dtype, device=device)


def ring_attention_local(q, k, v, mesh, axis_name: str = "seq",
                         causal: bool = True) -> torch.Tensor:
    """Per-shard ring attention body (the ``xla`` impl) on local
    (B, S_local, H, D) shards, the global sequence laid out contiguously
    around ``mesh``'s ``axis_name`` ring."""
    group, rank, n = ring_position(mesh, axis_name)
    s_local = q.shape[1]
    q32 = q.float()

    def block(carry, kv, step):
        src = (rank - step) % n
        stats = attention_block_stats(q32, kv[0], kv[1], causal,
                                      rank * s_local, src * s_local)
        return stats if carry is None else merge_attention_stats(
            *carry, *stats)

    kv = (k, v)
    carry = block(None, kv, 0)
    if n > 1:
        kv = torch.stack(kv)
    for step in range(1, n):
        kv = rotate(kv, group)
        carry = block(carry, kv, step)
    acc, _, l = carry
    return finalize_attention(acc, l, q.dtype)


def _merge_partial(o1, lse1, o2, lse2):
    """Merge two normalized partial attention results by their
    log-sum-exps. Rows dead in both partials stay zero."""
    m = torch.maximum(lse1, lse2).clamp_min(_NEG_INF / 2)
    w1 = torch.exp(lse1 - m)[..., None]
    w2 = torch.exp(lse2 - m)[..., None]
    tot = w1 + w2
    dead = tot == 0.0
    o = torch.where(dead, 0.0, (o1 * w1 + o2 * w2)
                    / torch.where(dead, 1.0, tot))
    lse = torch.where(dead[..., 0], _NEG_INF,
                      m + torch.log(torch.where(dead[..., 0], 1.0,
                                                tot[..., 0])))
    return o, lse


def _ring_hop(qt, kt, vt, step: int, rank: int, n: int, causal: bool,
              bq: int, bk: int, scale: Optional[float] = None):
    """One ring hop on (B, H, S, D) shards: ``(out, lse)`` of the local
    queries against the K/V shard that started ``step`` ranks back. With
    a causal mask the local hop (step 0) is causal, a shard behind the
    queries (``rank >= step``) is fully visible, and a shard ahead of them
    is dead: zeros and an lse of -1e30, with no kernel launched.
    ``scale`` defaults to the head dim's (pass the unpadded one when D
    was padded)."""
    from ray_tpu_torch.ops.flash_attention import flash_attention_stats

    if scale is None:
        scale = qt.shape[-1] ** -0.5
    if causal and step > 0 and rank < step:
        b, h, s, d = qt.shape
        return (torch.zeros((b, h, s, d), dtype=qt.dtype, device=qt.device),
                torch.full((b, h, s), _NEG_INF, dtype=torch.float32,
                           device=qt.device))
    return flash_attention_stats(qt, kt, vt, scale, causal and step == 0,
                                 None, 0, bq, bk)


def ring_flash_attention_local(q, k, v, mesh, axis_name: str = "seq",
                               causal: bool = True, block_q: int = 256,
                               block_k: int = 256,
                               ring: Optional[tuple] = None) -> torch.Tensor:
    """Ring attention whose hops run ``flash_attention_stats`` (the ``flash``
    impl) on local (B, S_local, H, D) shards: head_dim zero-padded to 128
    (exact), one (B, H, S, D) transpose for the whole ring, the hops'
    normalized partials merged in fp32 by ``_merge_partial``.

    ``ring`` = ``(rank, n, rotate_fn)`` runs the same body at another ring
    position with ``rotate_fn(kv)`` in place of the collective rotation
    (``kv`` stacks the padded (B, H, S_local, D) K and V; ``rotate_fn``
    returns the stack one rank back): one process can then run every rank
    of a ring. Default: this rank's position on ``mesh``'s ``axis_name``
    and ``rotate``."""
    if ring is None:
        group, rank, n = ring_position(mesh, axis_name)
        rotate_fn = partial(rotate, group=group)
    else:
        rank, n, rotate_fn = ring
    b, s_local, h, d = q.shape
    scale = d ** -0.5
    bq = min(block_q, s_local)
    bk = min(block_k, s_local)
    if s_local % bq or s_local % bk:
        raise ValueError(
            f"per-device sequence shard {s_local} must divide flash blocks "
            f"({bq}, {bk}); pick block sizes that divide S/seq_parallelism")
    d_pad = (-d) % 128
    if d_pad:
        q, k, v = (F.pad(t, (0, d_pad)) for t in (q, k, v))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    hop = partial(_ring_hop, rank=rank, n=n, causal=causal, bq=bq, bk=bk,
                  scale=scale)
    o, lse = hop(qt, kt, vt, 0)
    o = o.float()
    if n > 1:
        kv = torch.stack([kt, vt])
        for step in range(1, n):
            kv = rotate_fn(kv)
            o_h, lse_h = hop(qt, kv[0], kv[1], step)
            o, lse = _merge_partial(o, lse, o_h.float(), lse_h)
        if causal:
            o = _Anchor.apply(o, kv)
    if d_pad:
        o = o[..., :d]
    return o.to(q.dtype).transpose(1, 2)


def ring_attention(q, k, v, mesh, causal: bool = True,
                   axis_name: str = "seq", batch_axes=("data", "fsdp"),
                   head_axis: Optional[str] = "tensor",
                   impl: str = "xla") -> torch.Tensor:
    """Ring attention over global (B, S, H, D) tensors sharded batch x seq x
    heads (DTensors on ``mesh``, or plain tensors holding the full value on
    every rank); returns the output sharded the same way (plain in, plain
    out). ``impl="flash"`` runs each hop on the flash kernels, ``"xla"``
    is the plain path."""
    if impl not in ("xla", "flash"):
        raise ValueError(f"unknown ring attention impl {impl!r}")
    spec = (batch_axes, axis_name, head_axis)
    local = (ring_flash_attention_local if impl == "flash"
             else ring_attention_local)
    fn = partial(local, mesh=mesh, axis_name=axis_name, causal=causal)
    return shard_map(fn, mesh, (spec, spec, spec), spec)(q, k, v)
