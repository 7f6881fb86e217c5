"""Splash attention (port of ``ray_tpu/ops/splash_attention.py``).

Block-sparse flash attention with per-head static mask schedules. A
:class:`Mask` describes one head's sparsity (full, causal, local window,
chunked); consecutive heads with equal masks form a group, and for each
group a host-built :class:`_Schedule` lists, per q tile, exactly the live
kv tiles (and, transposed, per kv tile its live q tiles), so dead tiles are
never loaded.

``splash_attention`` keeps the JAX package's signature, its (B, S, H, D)
layout and its ValueErrors. On a CUDA tensor the forward launches
``ops/csrc/splash.cu``'s ``rtt_splash_fwd`` (which replaces the Pallas
``_sfwd_kernel``) and the backward the delta pre-pass kernel, then its
``rtt_splash_bwd_dkv`` (``_sbwd_dkv_kernel``) and ``rtt_splash_bwd_dq``
(``_sbwd_dq_kernel``), each once over all head groups, or raises: bf16
runs the wgmma kernels, float32 the mma.sync kernels
(``kernel_launches`` counts which ran). On a CPU tensor both directions
run the plain versions ``splash_attention_reference`` and
``splash_backward_reference``. ``mask=None`` delegates to the port's
``flash_attention``, as in JAX.

The kernels walk call schedules (``_call_schedule``: every group's
``_Schedule`` lists with one block order, heaviest first across all
heads) at their own tiles; the caller's ``block_q``/``block_k`` are
validated and reported, as in JAX, but do not change the function
computed. Each schedule is uploaded once and cached.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch.ops import flash_attention as _flash
from ray_tpu_torch.ops.flash_attention import _NEG_INF

# ------------------------------------------------------------------- masks


class Mask:
    """One head's static sparsity pattern. ``live_tile``/``full_tile`` are
    host-side (plain ints); ``apply`` masks scores (torch tensors)."""

    def live_tile(self, i: int, j: int, bq: int, bk: int) -> bool:
        raise NotImplementedError

    def full_tile(self, i: int, j: int, bq: int, bk: int) -> bool:
        raise NotImplementedError

    def apply(self, s, rows, cols):
        raise NotImplementedError

    def __eq__(self, other):
        return type(self) is type(other) and vars(self) == vars(other)

    def __hash__(self):
        return hash((type(self).__name__, tuple(sorted(vars(self).items()))))


class FullMask(Mask):
    """Dense attention (a "global" head in a mixed-head stack)."""

    def live_tile(self, i, j, bq, bk):
        return True

    def full_tile(self, i, j, bq, bk):
        return True

    def apply(self, s, rows, cols):
        return s


class CausalMask(Mask):
    def live_tile(self, i, j, bq, bk):
        return (i + 1) * bq - 1 >= j * bk

    def full_tile(self, i, j, bq, bk):
        # Entire tile below the diagonal: even the first row sees the last col.
        return i * bq >= (j + 1) * bk - 1

    def apply(self, s, rows, cols):
        return torch.where(rows >= cols, s, _NEG_INF)


class LocalMask(Mask):
    """Sliding-window attention: causal, keeping the last ``window``
    positions per query (Mistral-style local heads)."""

    def __init__(self, window: int):
        self.window = int(window)

    def live_tile(self, i, j, bq, bk):
        causal_live = (i + 1) * bq - 1 >= j * bk
        win_live = (j + 1) * bk - 1 > i * bq - self.window
        return causal_live and win_live

    def full_tile(self, i, j, bq, bk):
        causal_full = i * bq >= (j + 1) * bk - 1
        # Last row's window still covers the tile's first column.
        win_full = ((i + 1) * bq - 1) - j * bk < self.window
        return causal_full and win_full

    def apply(self, s, rows, cols):
        s = torch.where(rows >= cols, s, _NEG_INF)
        return torch.where(rows - cols < self.window, s, _NEG_INF)


class ChunkedMask(Mask):
    """Block-diagonal chunks of ``chunk`` positions (chunked prefill /
    local-global stacks): queries attend causally within their chunk."""

    def __init__(self, chunk: int):
        self.chunk = int(chunk)

    def live_tile(self, i, j, bq, bk):
        if not ((i + 1) * bq - 1 >= j * bk):
            return False
        # Any query row sharing a chunk with any kv col in the tile?
        q_chunks = range(i * bq // self.chunk,
                         ((i + 1) * bq - 1) // self.chunk + 1)
        k_chunks = range(j * bk // self.chunk,
                         ((j + 1) * bk - 1) // self.chunk + 1)
        return bool(set(q_chunks) & set(k_chunks))

    def full_tile(self, i, j, bq, bk):
        same_chunk = (i * bq // self.chunk
                      == ((i + 1) * bq - 1) // self.chunk
                      == j * bk // self.chunk
                      == ((j + 1) * bk - 1) // self.chunk)
        return same_chunk and i * bq >= (j + 1) * bk - 1

    def apply(self, s, rows, cols):
        s = torch.where(rows >= cols, s, _NEG_INF)
        return torch.where(rows // self.chunk == cols // self.chunk, s,
                           _NEG_INF)


_MASK_CODES = {FullMask: 0, CausalMask: 1, LocalMask: 2, ChunkedMask: 3}


def _kernel_mask(mask: Mask) -> Tuple[int, int]:
    """``(code, param)`` of a built-in mask for ``splash.cu``: full 0,
    causal 1, local 2 with its window, chunked 3 with its chunk."""
    code = _MASK_CODES.get(type(mask))
    if code is None:
        raise ValueError(
            f"the splash kernels take FullMask, CausalMask, LocalMask and "
            f"ChunkedMask, not {type(mask).__name__} (a CPU tensor runs any "
            f"Mask through its apply)")
    param = getattr(mask, "window", getattr(mask, "chunk", 0))
    if (code == 3 and param < 1) or not -2 ** 31 <= param < 2 ** 31:
        raise ValueError(f"{type(mask).__name__}({param}): the kernel takes "
                         f"a chunk >= 1 and a window that fits in int32")
    return code, param


# --------------------------------------------------------------- schedules


class _Schedule:
    """Compacted per-q-tile kv visit lists for one head group (and the
    transpose for the dK/dV pass)."""

    def __init__(self, mask: Mask, nq: int, nk: int, bq: int, bk: int):
        self.mask = mask
        rows: List[List[int]] = []
        fulls: List[List[int]] = []
        live = np.zeros((nq, nk), bool)
        for i in range(nq):
            js = [j for j in range(nk) if mask.live_tile(i, j, bq, bk)]
            if not js:
                js = [0]  # degenerate row: visit one tile, fully masked
            live[i, [j for j in js]] = True
            rows.append(js)
            fulls.append([int(mask.full_tile(i, j, bq, bk)) for j in js])
        self.q_len = max(len(r) for r in rows)
        self.kv_ids = np.zeros((nq, self.q_len), np.int32)
        self.kv_lens = np.asarray([len(r) for r in rows], np.int32)
        self.kv_full = np.zeros((nq, self.q_len), np.int32)
        for i, (js, fl) in enumerate(zip(rows, fulls)):
            self.kv_ids[i, :len(js)] = js
            self.kv_ids[i, len(js):] = js[-1]  # padding refetches last tile
            self.kv_full[i, :len(fl)] = fl
        # Transpose: per kv-tile, its live q-tiles (dK/dV accumulation).
        cols = [[i for i in range(nq) if live[i, j]] or [0]
                for j in range(nk)]
        self.k_len = max(len(c) for c in cols)
        self.q_ids = np.zeros((nk, self.k_len), np.int32)
        self.q_lens = np.asarray([len(c) for c in cols], np.int32)
        for j, is_ in enumerate(cols):
            self.q_ids[j, :len(is_)] = is_
            self.q_ids[j, len(is_):] = is_[-1]
        self.visited = int(self.kv_lens.sum())
        self.total = nq * nk


def _group_heads(masks: Sequence[Mask]) -> List[Tuple[int, int, Mask]]:
    """Consecutive heads sharing a mask -> (start, count, mask) groups."""
    groups = []
    start = 0
    for h in range(1, len(masks) + 1):
        if h == len(masks) or masks[h] != masks[start]:
            groups.append((start, h - start, masks[start]))
            start = h
    return groups


def _aligned_groups(masks: Sequence[Mask], group: int
                    ) -> List[Tuple[int, int, Mask]]:
    """``_group_heads``, each group a whole number of GQA groups."""
    groups = _group_heads(masks)
    for start, count, _ in groups:
        if start % group or count % group:
            raise ValueError(
                "per-head masks must align with GQA groups "
                f"(group size {group}); got a boundary at head {start}")
    return groups


def schedule_stats(mask: Mask, seq: int, block_q: int = 256,
                   block_k: int = 256) -> dict:
    """Visited vs total tiles for a mask at a given length — the sparsity
    the schedule actually realizes (observability/tests)."""
    s = _Schedule(mask, seq // block_q, seq // block_k, block_q, block_k)
    return {"visited": s.visited, "total": s.total,
            "density": s.visited / s.total, "q_len": s.q_len}


# ------------------------------------------------------------ plain version


def _head_masks(mask: Union[Mask, Sequence[Mask]], hq: int) -> List[Mask]:
    masks = [mask] * hq if isinstance(mask, Mask) else list(mask)
    if len(masks) != hq:
        raise ValueError(f"{len(masks)} masks for {hq} heads")
    return masks


def _mask_scores(masks: Sequence[Mask]):
    """Sets the masked entries of (B, H, Sq, Sk) scores to -1e30, each
    head group through its mask's ``apply``."""
    def run(s):
        rows = torch.arange(s.shape[2], device=s.device)[:, None]
        cols = torch.arange(s.shape[3], device=s.device)[None, :]
        return torch.cat([m.apply(s[:, a:a + c], rows, cols)
                          for a, c, m in _group_heads(masks)], dim=1)
    return run


def splash_attention_reference(q, k, v, mask, scale=None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch splash forward on (B, S, H, D) with one mask or a
    per-head list: ``(out, lse)``, lse (B, H, Sq) fp32. The flash plain
    version's arithmetic (fp32 scores and softmax, P rounded to the value
    dtype before P·V); a row with nothing live gets out 0 and lse -1e30.
    Materializes (B, H, Sq, Sk): the CPU path and the kernel's
    yardstick."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    masks = _head_masks(mask, q.shape[2])
    return _flash._reference_forward(q, k, v, scale, _mask_scores(masks))


def splash_backward_reference(q, k, v, out, lse, do, mask, scale=None
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Plain PyTorch splash backward on (B, S, H, D): ``(dq, dk, dv)``
    with the TPU kernels' rounding points, those of
    ``flash_backward_reference``: P in fp32, rounded to dO's dtype before
    Pᵀ·dO; dS rounded to q's dtype before dSᵀ·Q and to k's before dS·K;
    dK and dV summed over the GQA group in fp32 and cast once. A row with
    nothing live gets zero gradients."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    masks = _head_masks(mask, q.shape[2])
    return _flash._reference_backward(q, k, v, out, lse, do, None, scale,
                                      _mask_scores(masks))


# ----------------------------------------------------------------- kernels

# The (q rows, keys) tiles each kernel walks its call schedule at, by
# dtype: the bf16 wgmma forward's 128 x 128 and dQ's 128 x 64, and 64 x 64
# for both dK/dV kernels and every float32 mma.sync kernel.
_FWD_TILE = {torch.bfloat16: (128, 128), torch.float32: (64, 64)}
_DQ_TILE = {torch.bfloat16: (128, 64), torch.float32: (64, 64)}
_DKV_TILE = (64, 64)
_GROUP_INTS = 8  # a group's row of a call schedule (kGroupInts)

# The kernels behind splash.cu's entries, in the order of the counts
# ``rtt_splash_launches`` reports (see ``kernel_launches``).
SPLASH_KERNELS = ("fwd_wgmma", "fwd_mma_sync_f32", "dkv_wgmma",
                  "dkv_mma_sync_f32", "dq_wgmma", "dq_mma_sync_f32")


def _full_flags(mask: Mask, s: _Schedule, sq: int, sk: int, bq: int,
                bk: int) -> Tuple[np.ndarray, np.ndarray]:
    """``(kv_full, q_full)`` of a schedule at (bq, bk) tiles, int32: the
    q schedule's full flags and the transposed one's. A ragged last tile is
    never full (its padding rows and columns must be masked), and the
    dK/dV kernels skip the mask where ``full_tile`` holds, as the forward
    does."""
    nq, nk = len(s.kv_lens), len(s.q_lens)
    ragged_q = np.arange(nq) * bq + bq > sq
    ragged_k = np.arange(nk) * bk + bk > sk
    kv_full = s.kv_full * ~(ragged_q[:, None] | ragged_k[s.kv_ids])
    q_full = np.asarray([[mask.full_tile(int(i), j, bq, bk) for i in row]
                         for j, row in enumerate(s.q_ids)], bool)
    q_full &= ~(ragged_k[:, None] | ragged_q[s.q_ids])
    return kv_full.astype(np.int32), q_full.astype(np.int32)


class _CallSchedule(NamedTuple):
    """The schedules of one call's head groups as ``splash.cu``'s kernels
    walk them in one launch each: an int32 device buffer per direction
    (``fwd``, the q-major side over (q head, q tile) that the forward and
    dQ walk, and ``dkv`` over (kv head, kv tile); see ``_pack_side``) and
    its number of blocks."""
    fwd: torch.Tensor
    fwd_blocks: int
    dkv: torch.Tensor
    dkv_blocks: int


_call_schedules: Dict[tuple, _CallSchedule] = {}


def _pack_side(groups, n_heads: int, n_tiles: int, lists) -> np.ndarray:
    """One direction of a call schedule as ``splash.cu`` reads it, int32:
    the block order (``n_heads * n_tiles`` entries ``tile << 16 | head``,
    by live-tile count, most first, stable over head-major order), each
    head's group, a row of ``_GROUP_INTS`` per group (mask code, mask
    param, the buffer offsets of its ids, lens and full arrays, their row
    length, its first head and head count), then each group's arrays.
    ``groups`` holds (first head, head count, code, param), ``lists``
    (ids, lens, full) per group."""
    if n_heads >= 1 << 16 or n_tiles >= 1 << 15:
        raise ValueError(f"the splash kernels take < 65536 heads and < "
                         f"32768 tiles, not {n_heads} and {n_tiles}")
    counts = np.zeros((n_heads, n_tiles), np.int64)
    head_group = np.zeros(n_heads, np.int64)
    table = np.zeros((len(groups), _GROUP_INTS), np.int64)
    off = n_heads * n_tiles + n_heads + table.size
    arrays = []
    for gi, ((start, count, code, param), (ids, lens, full)) in enumerate(
            zip(groups, lists)):
        head_group[start:start + count] = gi
        counts[start:start + count] = lens
        table[gi] = (code, param, off, off + ids.size,
                     off + ids.size + lens.size, ids.shape[1], start, count)
        arrays += [ids.ravel(), lens, full.ravel()]
        off += 2 * ids.size + lens.size
    order = np.argsort(-counts.ravel(), kind="stable")
    entries = (order % n_tiles) << 16 | order // n_tiles
    buf = np.concatenate([entries, head_group, table.ravel(), *arrays])
    if len(buf) >= 1 << 31:
        raise ValueError("splash call schedule too large for int32 offsets")
    return buf.astype(np.int32)


def _call_schedule(masks: Sequence[Mask], group: int, sq: int, sk: int,
                   bq: int, bk: int, device: torch.device) -> _CallSchedule:
    """The call schedule of a per-head mask list (GQA group size
    ``group``) at (bq, bk) tiles: every head group's ``_Schedule`` at
    those tiles, with ``_full_flags``, packed by ``_pack_side`` in both
    directions and uploaded once per (masks, group, lengths, tiles,
    device). Masks the kernels do not know raise here."""
    masks = tuple(masks)
    key = (masks, group, sq, sk, bq, bk, str(device))
    hit = _call_schedules.get(key)
    if hit is not None:
        return hit
    nq, nk = -(-sq // bq), -(-sk // bk)
    fwd_groups, fwd_lists, dkv_groups, dkv_lists = [], [], [], []
    for a, c, m in _aligned_groups(masks, group):
        code, param = _kernel_mask(m)
        s = _Schedule(m, nq, nk, bq, bk)
        kv_full, q_full = _full_flags(m, s, sq, sk, bq, bk)
        fwd_groups.append((a, c, code, param))
        fwd_lists.append((s.kv_ids, s.kv_lens, kv_full))
        dkv_groups.append((a // group, c // group, code, param))
        dkv_lists.append((s.q_ids, s.q_lens, q_full))
    fwd = _pack_side(fwd_groups, len(masks), nq, fwd_lists)
    dkv = _pack_side(dkv_groups, len(masks) // group, nk, dkv_lists)
    flat = torch.from_numpy(np.concatenate([fwd, dkv])).to(device)
    hit = _call_schedules[key] = _CallSchedule(
        flat[:len(fwd)], len(masks) * nq, flat[len(fwd):],
        len(masks) // group * nk)
    return hit


def _strides(t: Optional[torch.Tensor]) -> Tuple[int, int, int]:
    return (0, 0, 0) if t is None else t.stride()[:3]


def _kernel_args(dtype, q, k, v, call, n_blocks, *, out=None, lse=None,
                 do=None, delta=None, dq=None, dk=None, dv=None):
    """ctypes (ptrs, ints) for ``splash.cu`` (its ``parse`` lists the
    layout): one side ``call`` of a call schedule, of ``n_blocks`` blocks;
    absent operands are null."""
    def ptr(t):
        return None if t is None else t.data_ptr()

    stats = lse if lse is not None else delta
    ptrs = (ctypes.c_void_p * 11)(
        ptr(q), ptr(k), ptr(v), ptr(out), ptr(lse), ptr(do), ptr(delta),
        ptr(dq), ptr(dk), ptr(dv), ptr(call))
    b, sq, h, d = q.shape
    ints = (ctypes.c_longlong * 31)(
        _flash._DTYPE_CODES[dtype], b, h, k.shape[2], sq, k.shape[1], d,
        *_strides(q), *_strides(k), *_strides(v), *_strides(out),
        *_strides(do), *_strides(dq), *_strides(dk),
        stats.stride(0), stats.stride(1), n_blocks)
    return ptrs, ints


def _splash_forward_launcher(q, k, v, masks, scale, csrc=None):
    """Validate and allocate for ``rtt_splash_fwd`` on (B, S, H, D) CUDA
    tensors, D in {64, 128}, with a per-head list of masks. Returns
    ``(launch, (out, lse))``: ``launch()`` launches the kernel once, over
    every head group, into those outputs (a timing calls it alone)."""
    b, sq, sk, hq, hkv, d = _flash._check_inputs(q, k, v, None, None,
                                                 "splash")
    dtype, device = q.dtype, q.device
    call = _call_schedule(masks, hq // hkv, sq, sk, *_FWD_TILE[dtype],
                          device)
    fn = _flash._library("splash", "rtt_splash_fwd", csrc)
    out = torch.empty((b, sq, hq, d), dtype=dtype, device=device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=device)
    ptrs, ints = _kernel_args(dtype, q, k, v, call.fwd, call.fwd_blocks,
                              out=out, lse=lse)
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch() -> None:
        err = fn(ptrs, ints, float(scale), stream)
        if err:
            raise RuntimeError(f"splash_fwd launch failed: cudaError {err}")
        splash_attention.launches += 1

    return launch, (out, lse)


def _splash_backward_launcher(q, k, v, do, lse, delta, masks, scale,
                              csrc=None):
    """Validate and allocate for ``rtt_splash_bwd_dkv`` and
    ``rtt_splash_bwd_dq`` on (B, S, H, D) CUDA tensors, D in {64, 128};
    ``lse`` and ``delta`` are (B, H, Sq) fp32. Returns ``(launch, (dq, dk,
    dv))``: ``launch("dkv")`` and ``launch("dq")`` launch the dK/dV and the
    dQ kernel once each, over every head group, into those outputs."""
    b, sq, sk, hq, hkv, d = _flash._check_inputs(q, k, v, None, None,
                                                 "splash")
    dtype, device = q.dtype, q.device
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} does not match q "
                         f"{tuple(q.shape)}")
    _flash._check_operand("do", do, dtype, device)
    # The dK/dV kernels read the statistics contiguous (TMA: 16-byte
    # aligned).
    lse, delta = (_flash._aligned(t.to(device=device, dtype=torch.float32)
                                  .contiguous()) for t in (lse, delta))
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, hq, sq):
            raise ValueError(f"{name} {tuple(t.shape)} is not ({b}, {hq}, "
                             f"{sq})")
    group = hq // hkv
    dkv_call = _call_schedule(masks, group, sq, sk, *_DKV_TILE, device)
    dq_call = _call_schedule(masks, group, sq, sk, *_DQ_TILE[dtype], device)
    fns = {name: _flash._library("splash", f"rtt_splash_bwd_{name}", csrc)
           for name in ("dkv", "dq")}
    dq = torch.empty((b, sq, hq, d), dtype=dtype, device=device)
    dk = torch.empty((b, sk, hkv, d), dtype=dtype, device=device)
    dv = torch.empty_like(dk)
    stats = dict(lse=lse, do=do, delta=delta)
    args = {"dkv": _kernel_args(dtype, q, k, v, dkv_call.dkv,
                                dkv_call.dkv_blocks, dk=dk, dv=dv, **stats),
            "dq": _kernel_args(dtype, q, k, v, dq_call.fwd,
                               dq_call.fwd_blocks, dq=dq, **stats)}
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch(name: str) -> None:
        ptrs, ints = args[name]
        err = fns[name](ptrs, ints, float(scale), stream)
        if err:
            raise RuntimeError(
                f"splash_bwd_{name} launch failed: cudaError {err}")
        counter = f"{name}_launches"
        setattr(splash_backward, counter,
                getattr(splash_backward, counter) + 1)

    launch.keep = (lse, delta)  # alive while launches may run
    return launch, (dq, dk, dv)


def kernel_launches(csrc=None) -> dict:
    """``SPLASH_KERNELS`` -> launches by ``splash.cu``'s three entries, as
    the C entries count them."""
    return _flash._kernel_launches("splash", SPLASH_KERNELS, csrc)


def splash_forward(q, k, v, mask, scale=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` on (B, S, H, D), the arguments of
    ``splash_attention_reference``, dispatched on the tensors' device: the
    Hopper kernel for CUDA tensors, the plain version for CPU tensors.
    Pads D to the kernel's 64 / 128 (exact: zero columns change no score,
    and the padded output columns are dropped)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _flash._device_kind(q, "splash_attention") == "cpu":
        return splash_attention_reference(q, k, v, mask, scale)
    masks = _head_masks(mask, q.shape[2])
    d = q.shape[-1]
    d_pad = _flash._pad_d(d, "splash")
    if d_pad:
        q, k, v = (F.pad(t, (0, d_pad)) for t in (q, k, v))
    launch, (out, lse) = _splash_forward_launcher(q, k, v, masks, scale)
    launch()
    return (out[..., :d] if d_pad else out), lse


def splash_backward(q, k, v, out, lse, do, mask, scale=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` on (B, S, H, D), the arguments of
    ``splash_backward_reference``, dispatched on the tensors' device: the
    delta pre-pass kernel (delta = rowsum(dO∘O), on the unpadded
    tensors) and the two Hopper kernels (dK/dV, then dQ) for CUDA
    tensors, the plain version for CPU tensors. Pads D like the forward
    and drops the padded gradient columns."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _flash._device_kind(q, "splash_attention") == "cpu":
        return splash_backward_reference(q, k, v, out, lse, do, mask, scale)
    masks = _head_masks(mask, q.shape[2])
    delta = _flash.attention_delta(out, do)
    d = q.shape[-1]
    d_pad = _flash._pad_d(d, "splash")
    if d_pad:
        q, k, v, do = (F.pad(t, (0, d_pad)) for t in (q, k, v, do))
    launch, grads = _splash_backward_launcher(q, k, v, do, lse, delta,
                                              masks, scale)
    launch("dkv")
    launch("dq")
    return tuple(g[..., :d] for g in grads) if d_pad else grads


splash_backward.dkv_launches = 0  # dK/dV kernel launches (CUDA only)
splash_backward.dq_launches = 0   # dQ kernel launches (CUDA only)


class _Splash(torch.autograd.Function):
    """out = splash_forward(q, k, v); the backward runs ``splash_backward``
    on the saved (q, k, v, out, lse): the port of ``_splash_group``'s
    ``custom_vjp``, over all head groups at once."""

    @staticmethod
    def forward(ctx, q, k, v, masks, scale):
        out, lse = splash_forward(q, k, v, masks, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks, ctx.scale = masks, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = splash_backward(q, k, v, out, lse, do.contiguous(),
                                     ctx.masks, ctx.scale)
        return dq, dk, dv, None, None


# ------------------------------------------------------------- public API


def splash_attention(
    q: torch.Tensor,                # (B, S, Hq, D)
    k: torch.Tensor,                # (B, S, Hkv, D)
    v: torch.Tensor,                # (B, S, Hkv, D)
    mask: Union[Mask, Sequence[Mask], None] = None,
    causal: bool = True,
    window: Optional[int] = None,
    segment_ids: Optional[torch.Tensor] = None,
    kv_segment_ids: Optional[torch.Tensor] = None,
    block_q: int = 256,
    block_k: int = 256,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Block-sparse attention with per-head static mask schedules,
    differentiable through the backward kernels.

    ``mask`` is one :class:`Mask` for all heads or a per-head sequence
    (consecutive heads with equal masks form a head group — e.g.
    ``[LocalMask(1024)] * 6 + [FullMask()] * 2`` for a local/global
    stack; each kernel takes every group in one launch). With
    ``mask=None`` the causal/window algebra (and data-dependent
    ``segment_ids``) delegates to the port's flash attention; with a mask,
    ``causal`` and ``window`` are ignored, as in JAX."""
    if mask is None:
        return _flash.flash_attention(
            q, k, v, causal=causal, window=window, segment_ids=segment_ids,
            kv_segment_ids=kv_segment_ids, block_q=block_q, block_k=block_k,
            scale=scale)
    if segment_ids is not None:
        raise ValueError("segment_ids are data-dependent; use mask=None "
                         "(the flash path) for packed sequences")
    b, sq, hq, d = q.shape
    hkv, sk = k.shape[2], k.shape[1]
    masks = _head_masks(mask, hq)
    if scale is None:
        scale = d ** -0.5
    bq, bk = min(block_q, sq), min(block_k, sk)
    if sq % bq or sk % bk:
        raise ValueError(f"seq lengths ({sq}, {sk}) must divide blocks "
                         f"({bq}, {bk})")
    _aligned_groups(masks, hq // hkv)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Splash.apply(q, k, v, masks, scale)
    return splash_forward(q, k, v, masks, scale)[0]


splash_attention.launches = 0  # forward kernel launches (CUDA tensors only)
