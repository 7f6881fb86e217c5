"""Autoregressive decoding for the Llama family (port of
``ray_tpu/models/llama_decode.py``: the contiguous KV cache, the paged KV
pool, the speculative verify and draft functions and the batched
sampler).

The cache is the JAX package's ``(L, B, C, KV, D)`` layout plus a per-row
``length``; the paged pool is its ``(L, pages + 1, T, KV, D)`` layout
addressed through per-row block tables. Where the JAX functions return new
caches (the engine donates the old buffers), these update the
preallocated cache and pool tensors IN PLACE and return the same dict: the
KV state is never copied per step.

Prefill attention is the config's ``attention_impl`` (``"flash"`` launches
the Hopper kernel), for the contiguous and the paged full prefill alike;
the suffix-prefill, chunk, verify and decode attention, paged or not, are
plain masked products in fp32, as the JAX package leaves them to XLA.

Writes the JAX package lets XLA drop (a scatter index past the cache row)
raise or fault in PyTorch, so they are masked out explicitly here: never
clamped into a live position. Reads past the rope tables clamp, as XLA's
gathers do; they only feed rows whose output nothing reads.

On a decode mesh (``parallel.sharding.local_shards``, set up by
``decode_shardings``) every function runs on this rank's local shards:
its heads, kv heads, MLP columns and vocab block over "model", and its
rows over "batch". The contiguous cache holds only the rank's slots, so a
contiguous call computes the rows whose slots the rank holds; the paged
pool holds every page (its kv heads), so a paged call splits its rows
evenly when the batch axis divides them, and gathers each layer's new K/V
over "batch" before writing it, so every copy of the pool stays whole.
Logits come back whole on every rank. Without ``local_shards`` nothing
here communicates.

With device spans on (``util.tracing``), each layer's cache read or page
gather plus its masked attention in ``decode_step`` and the paged decode,
verify, draft and chunk functions is one ``attn`` span.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ray_tpu_torch.core.device import resolve_device
from ray_tpu_torch.models.llama import (LlamaConfig,
                                        decoder_layer_kv, embed,
                                        layer_params, logits_f32, mlp,
                                        out_proj, qkv, rope_tables)
from ray_tpu_torch.ops.norms import rms_norm
from ray_tpu_torch.ops.rotary import apply_rope
from ray_tpu_torch.parallel.sharding import (KV_ROW_AXES, POOL_AXES,
                                             LocalShards, current_shards,
                                             decode_rules,
                                             decode_state_shardings,
                                             shard_local, tree_shardings)
from ray_tpu_torch.util.tracing import device_span

Cache = Dict[str, torch.Tensor]
_NEG_INF = -1e30

# Re-exported under the JAX package's names.
_qkv = qkv
_mlp = mlp


def cache_bucket(n: int, minimum: int = 128) -> int:
    """Smallest power of two >= n (>= minimum): the prompt-length buckets
    admission pads to."""
    c = minimum
    while c < n:
        c *= 2
    return c


def _local(shape: Tuple[int, ...], axes) -> Tuple[int, ...]:
    """``shape`` laid out by ``axes``: this rank's shard of it under
    ``local_shards``, the whole of it outside."""
    shards = current_shards()
    return shape if shards is None else shards.local_shape(shape, axes)


def init_cache(config: LlamaConfig, batch: int, capacity: int,
               dtype: Optional[torch.dtype] = None, device=None) -> Cache:
    """Zeroed KV cache for ``batch`` slots of ``capacity`` tokens (under
    ``local_shards``: this rank's slots and kv heads; ``length`` whole)."""
    c = config
    dev = resolve_device(device)
    shape = _local((c.n_layers, batch, capacity, c.n_kv_heads, c.head_dim),
                   KV_ROW_AXES)
    dt = dtype or c.dtype
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "length": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def _rows(rows, n: int, device) -> torch.Tensor:
    if rows is None:
        return torch.arange(n, device=device)
    return torch.as_tensor(rows, device=device).long()


class _Owned:
    """The rows of a contiguous call whose slots this rank's cache holds:
    ``idx`` their positions in the call, ``slots`` their cache rows here,
    and how to put the ranks' outputs back in the call's order."""

    def __init__(self, shards: LocalShards, rows: torch.Tensor, n: int):
        p = shards.parts("batch", n)
        per = n // p
        owner = (rows // per).cpu()
        me = shards.index[shards.axis("batch")]
        self.shards = shards
        self.counts = [int((owner == j).sum()) for j in range(p)]
        self.idx = (owner == me).nonzero(as_tuple=True)[0].to(rows.device)
        self.slots = rows[self.idx] - me * per
        self.order = torch.cat([(owner == j).nonzero(as_tuple=True)[0]
                                for j in range(p)]).to(rows.device)

    def merge(self, x: torch.Tensor) -> torch.Tensor:
        """The call's rows of ``x`` from each rank's own rows."""
        got = self.shards.gather_rows(x, "batch", self.counts)
        out = torch.empty_like(got)
        out[self.order] = got
        return out


def _owned(rows: torch.Tensor, n: int) -> Optional[_Owned]:
    """None when this rank holds every slot of an ``n``-slot cache."""
    shards = current_shards()
    if shards is None or shards.parts("batch", n) == 1:
        return None
    return _Owned(shards, rows, n)


def _row_block(n: int) -> Tuple[int, int]:
    """This rank's rows of a paged call of ``n`` rows: an even block of
    the batch axis, or all of them when it does not divide ``n``."""
    shards = current_shards()
    return (0, n) if shards is None else shards.block(n, "batch")


def _gather_batch(x: torch.Tensor, n: int) -> torch.Tensor:
    """Dim 0 (``n`` rows) whole from each rank's ``_row_block``."""
    shards = current_shards()
    if shards is None or shards.parts("batch", n) == 1:
        return x
    return shards.gather(x, 0, "batch")


def _last_real(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, S, E), idx (B,) -> x[b, idx[b]] (B, E)."""
    return x[torch.arange(x.shape[0], device=x.device), idx.long()]


def _masked_attention(q, k_c, v_c, valid, config: LlamaConfig):
    """GQA attention of q (B, S, H, D) against cached rows k_c/v_c
    (B, C, KV, D): q grouped over KV heads, so repeated K/V never exist.
    ``valid`` (B, S, C) marks visible keys. Scores and softmax in fp32;
    probabilities rounded to the cache dtype and the output to the compute
    dtype, as in the JAX package."""
    c = config
    B, S, H = q.shape[:3]
    KV = k_c.shape[2]  # the local heads on a mesh
    qg = q.reshape(B, S, KV, H // KV, c.head_dim)
    scores = torch.einsum("bskgd,bckd->bkgsc", qg.float(),
                          k_c.float()) * c.head_dim ** -0.5
    scores = scores.masked_fill(~valid[:, None, None], _NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_c.dtype)
    att = torch.einsum("bkgsc,bckd->bskgd", probs.float(), v_c.float())
    return att.to(v_c.dtype).reshape(B, S, H, c.head_dim).to(q.dtype)


def _empty_logits(config: LlamaConfig, device) -> torch.Tensor:
    return torch.empty((0, config.vocab_size), dtype=torch.float32,
                       device=device)


def _prefill_hidden(params, tokens: torch.Tensor, config: LlamaConfig,
                    write) -> torch.Tensor:
    """The full causal forward of (B, S) prompts, handing each layer's
    roped k and v (the ones it attended with) to ``write(i, k, v)``.
    Returns the final-norm hidden states (B, S, E)."""
    c = config
    x = embed(params, tokens, c)
    cos, sin = rope_tables(c, tokens.device)
    for i in range(c.n_layers):
        x, k, v = decoder_layer_kv(c, x, layer_params(params, i), cos, sin)
        write(i, k, v)
    return rms_norm(x, params["final_norm"], c.norm_eps)


def prefill(params, tokens: torch.Tensor, cache: Cache, config: LlamaConfig,
            lengths: Optional[torch.Tensor] = None,
            rows=None) -> Tuple[torch.Tensor, Cache]:
    """Process right-padded prompts (B, S), filling cache rows ``rows``
    (default ``0..B-1``) at positions ``[0, S)`` in place.

    Returns ``(last_logits (B, V) fp32, cache)``, the logits at each row's
    final REAL token. Causality keeps real positions clean of the padding;
    the junk K/V the padded tail writes is masked by ``length`` at decode
    time. The roped k and the v each layer attends with are the ones
    cached, computed once."""
    c = config
    B, S = tokens.shape
    capacity = cache["k"].shape[2]
    if S > capacity:
        raise ValueError(f"prompt length {S} exceeds cache capacity "
                         f"{capacity}")
    dev = tokens.device
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    rows = _rows(rows, B, dev)
    cache["length"][rows] = lengths.to(torch.int32)
    own = _owned(rows, cache["length"].shape[0])
    if own is not None:
        tokens, lengths, rows = tokens[own.idx], lengths[own.idx], own.slots
        if not len(rows):  # this rank holds none of the call's slots
            return own.merge(_empty_logits(c, dev)), cache

    def write(i, k, v):
        cache["k"][i, rows, :S] = k.to(cache["k"].dtype)
        cache["v"][i, rows, :S] = v.to(cache["v"].dtype)

    x = _prefill_hidden(params, tokens, c, write)
    x_last = _last_real(x, (lengths - 1).clamp(0, S - 1))
    logits = logits_f32(params, x_last)
    return (logits if own is None else own.merge(logits)), cache


def prefill_suffix(params, tokens: torch.Tensor, cache: Cache,
                   config: LlamaConfig, prefix_lens: torch.Tensor,
                   lengths: torch.Tensor, rows=None
                   ) -> Tuple[torch.Tensor, Cache]:
    """Suffix-only prefill: right-padded suffix ``tokens`` (B, S) from
    ``pos = prefix_lens`` against cache rows ``rows`` whose first
    ``prefix_lens`` positions are already filled (spliced from a prefix
    pool). ``lengths`` is each row's TOTAL length (prefix + real suffix).

    A suffix query at absolute position p attends key positions <= p.
    Suffix K/V is written in place at its absolute positions; pad
    positions past the cache row are dropped (never clamped into a live
    position). Returns ``(last_logits (B, V) fp32, cache)`` at each row's
    final real token, like ``prefill``."""
    c = config
    B, S = tokens.shape
    capacity = cache["k"].shape[2]
    dev = tokens.device
    rows = _rows(rows, B, dev)
    lengths = lengths.to(dev)
    cache["length"][rows] = lengths.to(torch.int32)
    prefix_lens = prefix_lens.to(dev).long()
    abs_pos = prefix_lens[:, None] + torch.arange(S, device=dev)[None, :]
    # Attention reads only up to the furthest position written or needed
    # by any row of the call.
    lim = min(capacity, int(abs_pos.max()) + 1)
    own = _owned(rows, cache["length"].shape[0])
    if own is not None:
        tokens, lengths, rows = tokens[own.idx], lengths[own.idx], own.slots
        prefix_lens, abs_pos = prefix_lens[own.idx], abs_pos[own.idx]
        if not len(rows):
            return own.merge(_empty_logits(c, dev)), cache
    valid = (torch.arange(lim, device=dev)[None, None, :]
             <= abs_pos[:, :, None])                           # (B, S, lim)
    wb, ws = (abs_pos < capacity).nonzero(as_tuple=True)      # kept writes
    w_rows, w_pos = rows[wb], abs_pos[wb, ws]
    rope_pos = abs_pos.clamp(max=c.max_seq_len - 1)
    x = embed(params, tokens, c)
    cos, sin = rope_tables(c, dev)
    for i in range(c.n_layers):
        layer = layer_params(params, i)
        h = rms_norm(x, layer["attn_norm"], c.norm_eps)
        q, k_new, v_new = qkv(layer, h, c)
        q = apply_rope(q, cos, sin, positions=rope_pos)
        k_new = apply_rope(k_new, cos, sin, positions=rope_pos)
        kc, vc = cache["k"][i], cache["v"][i]
        kc[w_rows, w_pos] = k_new[wb, ws].to(kc.dtype)
        vc[w_rows, w_pos] = v_new[wb, ws].to(vc.dtype)
        att = _masked_attention(q, kc[rows, :lim], vc[rows, :lim], valid, c)
        x = mlp(layer, x + out_proj(layer, att.to(x.dtype)), c)
    x = rms_norm(x, params["final_norm"], c.norm_eps)
    idx = (lengths.long() - prefix_lens - 1).clamp(0, S - 1)
    logits = logits_f32(params, _last_real(x, idx))
    return (logits if own is None else own.merge(logits)), cache


def decode_step(params, cache: Cache, tokens: torch.Tensor,
                config: LlamaConfig) -> Tuple[torch.Tensor, Cache]:
    """Append one token per slot and return next-token logits (B, V) fp32.

    ``tokens`` (B,): each row's token is written in place at position
    ``cache["length"][row]``; attention sees positions ``<= length``, and
    every length advances by one. A row whose cursor has walked past the
    cache (an idle slot never re-parked) has its write dropped, as XLA
    drops it. Attention runs over the live prefix ``[0, max(length)]``
    of all slots only: the positions past it are masked to exact zeros
    anyway."""
    c = config
    dev = tokens.device
    capacity = cache["k"].shape[2]
    n = cache["length"].shape[0]
    pos = cache["length"].long()
    lim = min(capacity, int(pos.max()) + 1)
    lo, hi = _row_block(n)  # the slots this rank's cache holds
    pos, tokens = pos[lo:hi], tokens[lo:hi]
    w_rows = (pos < capacity).nonzero(as_tuple=True)[0]
    w_pos = pos[w_rows]
    valid = (torch.arange(lim, device=dev)[None, :]
             <= pos[:, None])[:, None, :]                       # (B, 1, lim)
    rope_pos = pos.clamp(max=c.max_seq_len - 1)[:, None]
    x = embed(params, tokens, c)[:, None]                       # (B, 1, E)
    cos, sin = rope_tables(c, dev)
    for i in range(c.n_layers):
        layer = layer_params(params, i)
        h = rms_norm(x, layer["attn_norm"], c.norm_eps)
        q, k_new, v_new = qkv(layer, h, c)                      # (B, 1, ., D)
        q = apply_rope(q, cos, sin, positions=rope_pos)
        k_new = apply_rope(k_new, cos, sin, positions=rope_pos)
        kc, vc = cache["k"][i], cache["v"][i]
        kc[w_rows, w_pos] = k_new[w_rows, 0].to(kc.dtype)
        vc[w_rows, w_pos] = v_new[w_rows, 0].to(vc.dtype)
        with device_span("attn", dev):
            att = _masked_attention(q, kc[:, :lim], vc[:, :lim], valid, c)
        x = mlp(layer, x + out_proj(layer, att.to(x.dtype)), c)
    cache["length"] += 1
    x = rms_norm(x, params["final_norm"], c.norm_eps)
    return _gather_batch(logits_f32(params, x[:, 0]), n), cache


def decode_chunk(params, cache: Cache, tokens: torch.Tensor,
                 config: LlamaConfig, k: int) -> Tuple[torch.Tensor, Cache]:
    """``k`` greedy decode steps, each step's argmax feeding the next.
    Returns ``(tokens (k, B) int32, cache)``."""
    out = []
    tok = tokens
    for _ in range(k):
        logits, cache = decode_step(params, cache, tok, config)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out), cache


# --------------------------------------------------------------- paged KV
#
# K/V for ALL slots live in one device pool of ``(pages + 1, T)`` blocks;
# a per-row block table (page ids, (B, W)) maps logical token positions to
# pool pages. Attention gathers a row's pages back into logical order, so
# the gathered layout is value-for-value the contiguous cache's and the
# masked product is the contiguous one.
#
# Page 0 is the reserved scratch page: block-table entries a row never
# allocated point at it, and positions past the block table's window are
# routed to it explicitly, as the JAX package routes them. An index is
# never clamped into a live page. Several rows may write page 0 at one
# offset in one ``index_put_``: whichever write lands, nothing reads it.
# A full prefill writes no page another row owns; suffix, chunk and decode
# writes start at each row's ``prefix_lens`` / ``length``, past the pages a
# prefix hit shares (those end on a page boundary at or before it).


def init_page_pool(config: LlamaConfig, pages: int, page_tokens: int,
                   dtype: Optional[torch.dtype] = None, device=None) -> Cache:
    """Zeroed paged KV pool: ``pages`` usable pages of ``page_tokens``
    tokens each, plus the scratch page 0 (so ``pages + 1`` page rows);
    under ``local_shards``, of this rank's kv heads."""
    c = config
    dev = resolve_device(device)
    shape = _local((c.n_layers, pages + 1, page_tokens, c.n_kv_heads,
                    c.head_dim), POOL_AXES)
    dt = dtype or c.dtype
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def _page_slots(block_tables: torch.Tensor, pos: torch.Tensor, T: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pool (page, offset) of absolute positions ``pos`` (B, ...) through
    ``block_tables`` (B, W); positions past the ``W * T`` window go to the
    scratch page 0."""
    W = block_tables.shape[1]
    col = torch.div(pos, T, rounding_mode="floor").clamp(max=W - 1)
    rows = torch.arange(pos.shape[0], device=pos.device).view(
        -1, *([1] * (pos.dim() - 1)))
    page = torch.where(pos < W * T, block_tables[rows, col],
                       torch.zeros_like(col))
    return page, pos % T


def _gather_pages(pool_layer: torch.Tensor, block_tables: torch.Tensor
                  ) -> torch.Tensor:
    """One layer's pool (P + 1, T, KV, D) -> each row's pages in logical
    order, (B, W * T, KV, D)."""
    B, W = block_tables.shape
    T = pool_layer.shape[1]
    return pool_layer[block_tables].reshape(B, W * T, *pool_layer.shape[2:])


def _write_pages(pool: Cache, i: int, pages, offs, k, v, n: int) -> None:
    """Layer ``i``'s K/V of this rank's rows into the pool at
    (``pages``, ``offs``) of all ``n`` rows: on a batch-split mesh the rows
    are gathered first, so every rank's pool gets every write."""
    kp, vp = pool["k"][i], pool["v"][i]
    kp[pages, offs] = _gather_batch(k, n).to(kp.dtype)
    vp[pages, offs] = _gather_batch(v, n).to(vp.dtype)


def paged_prefill(params, tokens: torch.Tensor, pool: Cache,
                  block_tables: torch.Tensor, config: LlamaConfig,
                  lengths: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Cache]:
    """Full prefill of right-padded prompts (B, S) scattered into pool
    pages. The attention is the plain causal forward (a fresh prompt
    attends only to itself, no pool reads); each layer's position ``p``
    of row ``b`` lands in page ``block_tables[b, p // T]`` at offset
    ``p % T``, in place.

    ``block_tables``: (B, W) with ``W * T >= S``. Pad positions past a
    row's real length scatter into whatever page backs them, the row's own
    tail page or the scratch page 0, and are never read (causally
    invisible at prefill, masked by ``length`` at decode). Returns
    ``(last_logits (B, V) fp32, pool)``."""
    c = config
    B, S = tokens.shape
    dev = tokens.device
    T = pool["k"].shape[2]
    bt = block_tables.to(dev).long()
    if bt.shape[1] * T < S:
        raise ValueError(f"block tables of {bt.shape[1]} pages x {T} "
                         f"tokens do not cover the prompt bucket {S}")
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    pos = torch.arange(S, device=dev)
    pages = bt[:, pos // T]                                     # (B, S)
    offs = (pos % T).expand(B, S)
    lo, hi = _row_block(B)
    x = _prefill_hidden(
        params, tokens[lo:hi], c,
        lambda i, k, v: _write_pages(pool, i, pages, offs, k, v, B))
    x_last = _last_real(x, (lengths.to(dev)[lo:hi] - 1).clamp(0, S - 1))
    return _gather_batch(logits_f32(params, x_last), B), pool


def _paged_forward(params, tokens: torch.Tensor, pool: Cache,
                   block_tables: torch.Tensor, config: LlamaConfig,
                   prefix_lens: torch.Tensor) -> torch.Tensor:
    """Right-padded rows ``tokens`` (B, S) from ``pos = prefix_lens``
    against the pages ``block_tables`` (B, W) maps: each layer writes its
    K/V in place at the rows' absolute positions (past the ``W * T``
    window: the scratch page) BEFORE it gathers, so each query sees its
    own causal K/V. Returns the final-norm hidden states of this rank's
    rows (``_row_block(B)``; all B without a mesh), (B, S, E)."""
    c = config
    B, S = tokens.shape
    dev = tokens.device
    T = pool["k"].shape[2]
    bt = block_tables.to(dev).long()
    C = bt.shape[1] * T
    abs_pos = prefix_lens.to(dev).long()[:, None] \
        + torch.arange(S, device=dev)[None, :]
    pages, offs = _page_slots(bt, abs_pos, T)                   # (B, S)
    lo, hi = _row_block(B)
    bt, abs_pos = bt[lo:hi], abs_pos[lo:hi]
    valid = (torch.arange(C, device=dev)[None, None, :]
             <= abs_pos[:, :, None])                            # (B, S, C)
    rope_pos = abs_pos.clamp(max=c.max_seq_len - 1)
    x = embed(params, tokens[lo:hi], c)
    cos, sin = rope_tables(c, dev)
    for i in range(c.n_layers):
        layer = layer_params(params, i)
        h = rms_norm(x, layer["attn_norm"], c.norm_eps)
        q, k_new, v_new = qkv(layer, h, c)
        q = apply_rope(q, cos, sin, positions=rope_pos)
        k_new = apply_rope(k_new, cos, sin, positions=rope_pos)
        _write_pages(pool, i, pages, offs, k_new, v_new, B)
        with device_span("attn", dev):
            att = _masked_attention(q, _gather_pages(pool["k"][i], bt),
                                    _gather_pages(pool["v"][i], bt), valid,
                                    c)
        x = mlp(layer, x + out_proj(layer, att.to(x.dtype)), c)
    return rms_norm(x, params["final_norm"], c.norm_eps)


def paged_prefill_suffix(params, tokens: torch.Tensor, pool: Cache,
                         block_tables: torch.Tensor, config: LlamaConfig,
                         prefix_lens: torch.Tensor, lengths: torch.Tensor
                         ) -> Tuple[torch.Tensor, Cache]:
    """Suffix prefill against paged context: right-padded suffix
    ``tokens`` (B, S) from ``pos = prefix_lens``, attending to the pages
    ``block_tables`` (B, W) maps (the shared or earlier-filled prefix
    pages plus the causal part of the suffix). It serves the prefix-hit
    splice (the block table IS the splice, no copy) and each chunk of a
    chunked prefill (prefix = what earlier chunks wrote).

    Pass block tables sliced to the columns covering prefix + suffix, so
    the gather and the attention scale with what the wave touches. Suffix
    K/V is written in place at its absolute positions before the gather;
    pad positions past the window go to the scratch page. ``lengths`` is
    each row's TOTAL length. Returns ``(last_logits (B, V) fp32, pool)``
    at each row's final real token."""
    B, S = tokens.shape
    x = _paged_forward(params, tokens, pool, block_tables, config,
                       prefix_lens)
    dev = tokens.device
    lo, hi = _row_block(B)
    idx = (lengths.to(dev).long() - prefix_lens.to(dev).long() - 1).clamp(
        0, S - 1)[lo:hi]
    return _gather_batch(logits_f32(params, _last_real(x, idx)), B), pool


def paged_decode_step(params, pool: Cache, block_tables: torch.Tensor,
                      lengths: torch.Tensor, tokens: torch.Tensor,
                      config: LlamaConfig
                      ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
    """One decode token per row against paged context. ``tokens`` (B,) is
    written in place at position ``lengths[b]`` of each row's block-mapped
    sequence; attention sees positions ``<= length`` across the row's
    gathered pages, value for value the contiguous ``decode_step``.

    Idle and mid-prefill rows flow through too: their parked cursor may
    sit past the window (block tables sliced to the live rows' needs), and
    those writes go to the scratch page. Returns ``(logits (B, V) fp32,
    pool, lengths + 1)``; nothing here reads a device value back to the
    host."""
    c = config
    dev = tokens.device
    B = tokens.shape[0]
    T = pool["k"].shape[2]
    bt = block_tables.to(dev).long()
    C = bt.shape[1] * T
    pos = lengths.to(dev).long()
    page, off = _page_slots(bt, pos, T)                         # (B,)
    lo, hi = _row_block(B)
    bt, rpos = bt[lo:hi], pos[lo:hi]
    valid = (torch.arange(C, device=dev)[None, :]
             <= rpos[:, None])[:, None, :]                      # (B, 1, C)
    rope_pos = rpos.clamp(max=c.max_seq_len - 1)[:, None]
    x = embed(params, tokens[lo:hi], c)[:, None]                # (B, 1, E)
    cos, sin = rope_tables(c, dev)
    for i in range(c.n_layers):
        layer = layer_params(params, i)
        h = rms_norm(x, layer["attn_norm"], c.norm_eps)
        q, k_new, v_new = qkv(layer, h, c)                      # (B, 1, ., D)
        q = apply_rope(q, cos, sin, positions=rope_pos)
        k_new = apply_rope(k_new, cos, sin, positions=rope_pos)
        _write_pages(pool, i, page, off, k_new[:, 0], v_new[:, 0], B)
        with device_span("attn", dev):
            att = _masked_attention(q, _gather_pages(pool["k"][i], bt),
                                    _gather_pages(pool["v"][i], bt), valid,
                                    c)
        x = mlp(layer, x + out_proj(layer, att.to(x.dtype)), c)
    x = rms_norm(x, params["final_norm"], c.norm_eps)
    logits = _gather_batch(logits_f32(params, x[:, 0]), B)
    return logits, pool, (pos + 1).to(torch.int32)


def paged_decode_chunk(params, pool: Cache, block_tables: torch.Tensor,
                       lengths: torch.Tensor, tokens: torch.Tensor,
                       config: LlamaConfig, k: int
                       ) -> Tuple[torch.Tensor, Cache, torch.Tensor]:
    """``k`` greedy paged decode steps, each step's argmax feeding the
    next. The block tables are fixed across the chunk: the caller must
    have pages allocated to cover ``length + k`` for every stepping row.
    Returns ``(tokens (k, B) int32, pool, lengths)``."""
    out = []
    tok = tokens
    for _ in range(k):
        logits, pool, lengths = paged_decode_step(
            params, pool, block_tables, lengths, tok, config)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out), pool, lengths


# ------------------------------------------------- speculative decoding
#
# ``paged_verify`` scores a (k+1)-token row per slot in ONE target forward
# (the ragged-position write-then-gather of ``paged_prefill_suffix``, with
# logits at EVERY position: the engine compares the draft's proposals with
# the per-position argmaxes), and ``paged_spec_draft`` runs the draft
# model: it takes up to two catch-up tokens (the true tokens the draft has
# not committed yet; the acceptance rule bounds them at 2), then proposes
# ``k`` tokens greedily. Accepting the longest prefix of proposals that
# equals the target's argmaxes emits, at each position, the token
# sequential greedy decode picks: position ``j``'s verify logits condition
# on exactly the tokens sequential decode would have conditioned on
# whenever proposals ``1..j`` were accepted.


def paged_verify(params, tokens: torch.Tensor, pool: Cache,
                 block_tables: torch.Tensor, config: LlamaConfig,
                 prefix_lens: torch.Tensor) -> Tuple[torch.Tensor, Cache]:
    """Target verify forward: right-padded rows ``tokens`` (B, S = k + 1)
    from ``pos = prefix_lens`` against the paged context; returns fp32
    logits at ALL ``S`` positions, (B, S, V), and the pool. The engine's
    row layout is ``[last_emitted, draft_1, .., draft_k]``. K/V for every
    position is written in place into the row's pages (past the window:
    the scratch page), so the accepted prefix is committed by the forward
    that scores it; a rejected tail is junk past the rolled-back
    ``length``, masked like pad writes and rewritten by the next round
    before anything gathers it. Pass block tables covering
    ``prefix_lens + S`` positions of every live row."""
    x = _paged_forward(params, tokens, pool, block_tables, config,
                       prefix_lens)
    return _gather_batch(logits_f32(params, x), tokens.shape[0]), pool


def paged_spec_draft(params, pool: Cache, block_tables: torch.Tensor,
                     lengths: torch.Tensor, catchup: torch.Tensor,
                     catchup_lens: torch.Tensor, config: LlamaConfig,
                     k: int) -> Tuple[torch.Tensor, Cache]:
    """Draft propose step: take the ragged ``catchup`` rows (B, 2), 1 true
    token normally or 2 after a fully accepted round, writing their K/V at
    ``lengths .. lengths + catchup_lens - 1``, then greedily roll ``k``
    proposals. Returns ``(proposals (B, k) int32, pool)``. The caller owns
    the ``lengths`` cursors (rolled back on the host after acceptance);
    pages must cover ``lengths + catchup_lens + k - 1`` positions. A
    1-long row's pad writes junk one past its real token, which the first
    proposal's decode step rewrites before anything gathers it."""
    logits, pool = paged_verify(params, catchup, pool, block_tables,
                                config, lengths)
    rows = torch.arange(logits.shape[0], device=logits.device)
    last = logits[rows, catchup_lens.to(logits.device).long() - 1]
    tok = torch.argmax(last, dim=-1).to(torch.int32)
    lens = (lengths.to(logits.device) + catchup_lens.to(logits.device)).to(
        torch.int32)
    out = [tok]
    for _ in range(k - 1):
        logits, pool, lens = paged_decode_step(params, pool, block_tables,
                                               lens, tok, config)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
    return torch.stack(out, dim=1), pool


# ------------------------------------------------- serving on a mesh
#
# One replica over a ``parallel.mesh.decode_mesh`` ("batch", "model"):
# ``shard_decode_state`` cuts the weights to this rank's shards under the
# decode rules, and the functions above, run under ``local_shards`` of the
# bundle's ``"local"``, keep the KV state in the bundle's layouts.


def decode_shardings(config: LlamaConfig, mesh) -> Dict[str, Any]:
    """The decode replica's layouts on ``mesh``: the rule table resolved
    for ``config`` (``decode_rules``), ``NamedSharding``s of the params,
    the contiguous cache, the paged pool, the contiguous prefix pool and
    the replicated outputs, and ``"local"``: this rank's ``LocalShards``
    under those rules."""
    from ray_tpu_torch.models.llama import decode_param_axes

    rules = decode_rules(config, mesh)
    return {"rules": rules,
            "params": tree_shardings(mesh, decode_param_axes(config), rules),
            **decode_state_shardings(mesh, rules),
            "local": LocalShards(mesh, rules)}


def _take_fused(config: LlamaConfig, shards: LocalShards):
    """``shard_local``'s hook for the fused projections: a rank's block of
    ``wqkv`` is its q heads, then its k and v heads, and of ``w_gate_up``
    its gate columns, then its up columns, so ``qkv`` and ``mlp_hidden``
    split their local products as they split the whole ones."""
    c = config

    def take(path, t, axes):
        if path.endswith("layers/wqkv"):
            q, k, v = t.split([c.n_heads, c.n_kv_heads, c.n_kv_heads], 2)
            return torch.cat([shards.take(q, 2, "heads"),
                              shards.take(k, 2, "kv_heads"),
                              shards.take(v, 2, "kv_heads")], 2)
        if path.endswith("layers/w_gate_up"):
            return torch.cat([shards.take(w, 2, "mlp")
                              for w in t.chunk(2, 2)], 2)
        return None

    return take


def shard_decode_state(params: Dict[str, Any], config: LlamaConfig, mesh
                       ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """``(this rank's shards of params, decode_shardings(config, mesh))``.
    ``params`` is the full tree (the same on every rank); a weight that
    stays whole on this mesh is returned as is, a sharded one as a copy of
    this rank's block."""
    from ray_tpu_torch.models.llama import decode_param_axes

    bundle = decode_shardings(config, mesh)
    local = bundle["local"]
    return shard_local(params, decode_param_axes(config), local,
                       take=_take_fused(config, local)), bundle


def init_prefix_pool(config: LlamaConfig, entries: int, capacity: int,
                     dtype: Optional[torch.dtype] = None,
                     device=None) -> Cache:
    """Zeroed contiguous prefix pool: ``entries`` rows of ``capacity``
    tokens (under ``local_shards``: every row, this rank's kv heads)."""
    c = config
    shape = _local((c.n_layers, entries, capacity, c.n_kv_heads,
                    c.head_dim), POOL_AXES)
    dt = dtype or c.dtype
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def prefix_splice(cache: Cache, pool: Cache, slots: torch.Tensor,
                  entries: torch.Tensor) -> None:
    """Copy contiguous prefix-pool rows ``entries`` into cache rows
    ``slots`` (the whole pool row, positions ``[0, Cp)``) in place; on a
    mesh each rank copies into the slots its cache holds (the pool is
    whole over "batch")."""
    own = _owned(slots, cache["length"].shape[0])
    if own is not None:
        slots, entries = own.slots, entries[own.idx]
    cp = pool["k"].shape[2]
    cache["k"][:, slots, :cp] = pool["k"][:, entries]
    cache["v"][:, slots, :cp] = pool["v"][:, entries]


def prefix_insert(cache: Cache, pool: Cache, slot: int, row: int) -> None:
    """Copy cache row ``slot``'s leading ``Cp`` positions into prefix-pool
    row ``row`` in place; on a batch-split mesh the rank holding the slot
    copies it and broadcasts the row over "batch"."""
    cp = pool["k"].shape[2]
    shards = current_shards()
    n = cache["length"].shape[0]
    p = 1 if shards is None else shards.parts("batch", n)
    if p == 1:
        pool["k"][:, row] = cache["k"][:, slot, :cp]
        pool["v"][:, row] = cache["v"][:, slot, :cp]
        return
    per = n // p
    owner, me = slot // per, shards.index[shards.axis("batch")]
    for name in ("k", "v"):
        buf = (cache[name][:, slot - me * per, :cp].contiguous()
               if me == owner else torch.empty_like(pool[name][:, row]))
        pool[name][:, row] = shards.broadcast(buf, "batch", owner)


def _sample(logits: torch.Tensor, temperature: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def sample_batch(logits: torch.Tensor, temperatures: torch.Tensor,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """Per-row sampling on the device: argmax where ``temperatures[b] <=
    0``, else a categorical draw at that row's temperature (Gumbel-max:
    ``argmax(logits / t + g)`` with ``g = -log(-log(u))``, the draw the
    JAX package's ``jax.random.categorical`` makes). The greedy lane
    equals host ``np.argmax`` (both take the first maximum); the sampled
    lane draws from ``generator``, a different stream than the host
    sampler's and the JAX package's, and repeats under one seed.
    Returns (B,) int32."""
    greedy = torch.argmax(logits, dim=-1)
    temps = temperatures.to(logits.device, torch.float32)
    u = torch.rand(logits.shape, generator=generator, device=logits.device,
                   dtype=torch.float32)
    gumbel = -torch.log(-torch.log(u))
    sampled = torch.argmax(logits.float() / temps.clamp(min=1e-6)[:, None]
                           + gumbel, dim=-1)
    return torch.where(temps <= 0.0, greedy, sampled).to(torch.int32)


@torch.no_grad()
def generate(params, tokens, config: LlamaConfig, max_new_tokens: int = 32,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             eos_id: Optional[int] = None, lengths=None,
             device=None) -> torch.Tensor:
    """Generate ``max_new_tokens`` per prompt row (prefill, then decode
    steps): the offline path. Greedy at ``temperature <= 0``, else
    categorical at that temperature from ``generator``. Rows that emitted
    ``eos_id`` repeat it. Runs on ``device`` (``cuda`` unless the caller
    passes another), where ``params`` must live. Returns (B, max_new)."""
    dev = resolve_device(device)
    if params["tok_embed"].device.type != dev.type:
        raise ValueError(f"params are on {params['tok_embed'].device}, "
                         f"generate was asked to run on {dev}")
    tokens = torch.as_tensor(tokens, dtype=torch.int64, device=dev)
    if tokens.ndim == 1:
        tokens = tokens[None]
    B, S = tokens.shape
    if lengths is not None:
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    cache = init_cache(config, B, cache_bucket(S + max_new_tokens),
                       device=dev)
    logits, cache = prefill(params, tokens, cache, config, lengths)
    tok = _sample(logits, temperature, generator)
    out = [tok]
    done = (tok == eos_id) if eos_id is not None else None
    for _ in range(max_new_tokens - 1):
        logits, cache = decode_step(params, cache, tok, config)
        tok = _sample(logits, temperature, generator)
        if eos_id is not None:
            tok = torch.where(done, torch.full_like(tok, eos_id), tok)
            done = done | (tok == eos_id)
        out.append(tok)
    return torch.stack(out, dim=1)
