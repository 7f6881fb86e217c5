"""Flash attention (port of ``ray_tpu/ops/flash_attention.py``).

``flash_attention`` and ``flash_attention_stats`` keep the JAX package's
public signatures, its (B, S, H, D) layout (``flash_attention_stats``:
(B, H, S, D)) and its ValueErrors. On a CUDA tensor the forward launches
the hand-written Hopper kernel ``ops/csrc/flash_fwd.cu`` (which replaces
the Pallas ``_fwd_kernel``; the C entry sends bf16 to its wgmma kernel
and float32 to its mma.sync kernel, and ``forward_kernel_launches``
reads which it launched) and the backward launches the
two kernels of ``ops/csrc/flash_bwd.cu`` (``_bwd_dkv_kernel`` then
``_bwd_dq_kernel``; the C entries send bf16 to their wgmma kernels and
float32 to their mma.sync kernels, and ``backward_kernel_launches`` reads
which they launched), or raises; on a CPU tensor both directions run the
plain PyTorch versions,
``flash_attention_reference`` and ``flash_backward_reference``. The
backward's pre-pass ``attention_delta`` (delta = rowsum(dO∘O), shared
with splash) launches ``ops/csrc/delta.cu`` on a CUDA tensor and runs
``attention_delta_reference`` on a CPU tensor. Nothing else is on either
path.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_NEG_INF = -1e30
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}
# The kernels behind ``flash_fwd.cu``'s entry, in the order of the counts
# ``rtt_flash_fwd_launches`` reports (see ``forward_kernel_launches``).
FORWARD_KERNELS = ("wgmma", "mma_sync_f32")
# The kernels behind ``flash_bwd.cu``'s two entries, in the order of the
# counts ``rtt_flash_bwd_launches`` reports (see
# ``backward_kernel_launches``).
BACKWARD_KERNELS = ("dkv_wgmma", "dq_wgmma", "dkv_mma_sync_f32",
                    "dq_mma_sync_f32")


# ------------------------------------------------------------ plain version


def flash_attention_reference(q, k, v, causal=True, q_offset=0, scale=None,
                              window=None, seg_q=None, seg_k=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch flash forward on (B, S, H, D): ``(out, lse)`` with lse
    (B, H, Sq) in fp32. Scores, max and sum in fp32; P rounded to the value
    dtype before P·V as the kernels do; masked scores are -1e30 and a row
    with nothing live gets out 0 and lse -1e30. Materializes the
    (B, H, Sq, Sk) scores: the CPU path and the kernel's yardstick."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    keep = _keep_mask(q.shape[1], k.shape[1], causal, q_offset, window,
                      seg_q, seg_k, q.device)
    return _reference_forward(q, k, v, scale, _where_kept(keep))


def _where_kept(keep):
    return lambda s: torch.where(keep, s, torch.full_like(s, _NEG_INF))


def _reference_forward(q, k, v, scale, mask_scores
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward on (B, S, H, D) once ``mask_scores`` has set the
    masked entries of the fp32 (B, H, Sq, Sk) scores to -1e30: shared by
    the flash and splash plain versions."""
    group = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(group, dim=2) if group > 1 else k
    v = v.repeat_interleave(group, dim=2) if group > 1 else v
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = mask_scores(s)
    m_safe = s.amax(dim=-1, keepdim=True).clamp_min(_NEG_INF / 2)
    p = torch.exp(s - m_safe)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = out / l_safe.permute(0, 2, 1, 3)
    lse = torch.where(l == 0.0, torch.full_like(l, _NEG_INF),
                      m_safe + torch.log(l_safe))
    return out.to(q.dtype), lse[..., 0]


def _keep_mask(sq, sk, causal, q_offset, window, seg_q, seg_k, device):
    """(1 | B, 1, Sq, Sk) bool: which (query, key) pairs the masks leave."""
    rows = q_offset + torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        keep = keep & (rows >= cols)
    if window is not None:
        keep = keep & (rows - cols < window)
    keep = keep[None, None]
    if seg_q is not None:
        keep = keep & (seg_q[:, None, :, None] == seg_k[:, None, None, :])
    return keep


def attention_delta_reference(out: torch.Tensor,
                              do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, (B, S, H, D) -> (B, H, S)
    contiguous: the plain version of the backward kernels' pre-pass (the
    JAX package's expression, which it leaves to XLA)."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def flash_backward_reference(q, k, v, out, lse, do, dlse=None, causal=True,
                             q_offset=0, scale=None, window=None, seg_q=None,
                             seg_k=None) -> Tuple[torch.Tensor, torch.Tensor,
                                                  torch.Tensor]:
    """Plain PyTorch flash backward on (B, S, H, D): ``(dq, dk, dv)`` from
    the forward's ``out`` and ``lse`` (B, H, Sq), the output cotangent
    ``do`` and, for ``flash_attention_stats``, the lse cotangent ``dlse``
    (B, H, Sq). Keeps the TPU kernels' rounding points: P = exp(s -
    max(lse, -5e29)) in fp32, rounded to dO's dtype before Pᵀ·dO; dP in
    fp32 plus the lse cotangent; dS = P∘(dP − delta)·scale rounded to
    q's dtype before dSᵀ·Q and to k's before dS·K; dK and dV accumulated
    per query head in fp32, summed over the GQA group in fp32 and cast
    once; dq written in q's dtype. Materializes (B, H, Sq, Sk): the CPU
    path and the kernels' yardstick."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    keep = _keep_mask(q.shape[1], k.shape[1], causal, q_offset, window,
                      seg_q, seg_k, q.device)
    return _reference_backward(q, k, v, out, lse, do, dlse, scale,
                               _where_kept(keep))


def _reference_backward(q, k, v, out, lse, do, dlse, scale, mask_scores
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain backward on (B, S, H, D) with the scores masked by
    ``mask_scores`` as in ``_reference_forward``: shared by the flash and
    splash plain versions."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    group = hq // hkv
    kr = k.repeat_interleave(group, dim=2) if group > 1 else k
    vr = v.repeat_interleave(group, dim=2) if group > 1 else v
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * scale
    s = mask_scores(s)
    p = torch.exp(s - lse.float().clamp_min(_NEG_INF / 2)[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vr.float())
    if dlse is not None:
        dp = dp + dlse.float()[..., None]
    ds = p * (dp - attention_delta_reference(out, do)[..., None]) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), kr.float())
    dk = dk.view(b, sk, hkv, group, d).sum(3)
    dv = dv.view(b, sk, hkv, group, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ----------------------------------------------------------------- kernels


def _check_operand(name: str, t: torch.Tensor, dtype: torch.dtype,
                   device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, q on {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, q is {dtype}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}'s head dim must be contiguous "
                         f"(strides {t.stride()})")
    vec = 16 // t.element_size()
    if t.data_ptr() % 16 or any(st % vec for st, n in
                                zip(t.stride()[:-1], t.shape[:-1]) if n > 1):
        raise ValueError(f"{name} must be 16-byte aligned with strides that "
                         f"are multiples of {vec} elements "
                         f"(strides {t.stride()})")


def _check_inputs(q, k, v, seg_q, seg_k, kernel="flash"):
    """Validate the kernels' (B, S, H, D) operands; returns
    (b, sq, sk, hq, hkv, d)."""
    dtype, device = q.dtype, q.device
    if dtype not in _DTYPE_CODES:
        raise ValueError(
            f"{kernel} kernel takes bfloat16 or float32, not {dtype}")
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if d not in (64, 128):
        raise ValueError(
            f"{kernel} kernel head dim must be 64 or 128, got {d}")
    if k.shape != (b, sk, hkv, d) or v.shape != k.shape or hq % hkv:
        raise ValueError(f"k {tuple(k.shape)} / v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if seg_q is not None and (seg_q.shape != (b, sq)
                              or seg_k.shape != (b, sk)):
        raise ValueError(f"segment ids {tuple(seg_q.shape)} / "
                         f"{tuple(seg_k.shape)} do not match ({b}, {sq}) / "
                         f"({b}, {sk})")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, dtype, device)
    return b, sq, sk, hq, hkv, d


def _segments(seg_q, seg_k, device):
    if seg_q is None:
        return None, None
    return (seg_q.to(device=device, dtype=torch.int32).contiguous(),
            seg_k.to(device=device, dtype=torch.int32).contiguous())


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _mask_ints(seg_q, seg_k, causal, window, q_offset):
    return (seg_q.stride(0) if seg_q is not None else 0,
            seg_k.stride(0) if seg_k is not None else 0,
            int(bool(causal)), int(window is not None),
            int(window) if window is not None else 0, int(q_offset))


def _forward_launcher(q, k, v, seg_q, seg_k, scale, causal, window,
                      q_offset, csrc=None):
    """Validate and allocate for ``flash_fwd.cu`` on (B, S, H, D) CUDA
    tensors, D in {64, 128}. Returns ``(launch, (out, lse))``: ``launch()``
    launches the kernel into those outputs (a timing calls it alone)."""
    b, sq, sk, hq, hkv, d = _check_inputs(q, k, v, seg_q, seg_k)
    dtype, device = q.dtype, q.device
    fn = _library("flash_fwd", "rtt_flash_fwd", csrc)
    out = torch.empty((b, sq, hq, d), dtype=dtype, device=device)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=device)
    seg_q, seg_k = _segments(seg_q, seg_k, device)
    ptrs = (ctypes.c_void_p * 7)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg_q), _ptr(seg_k),
        out.data_ptr(), lse.data_ptr())
    ints = (ctypes.c_longlong * 25)(
        _DTYPE_CODES[dtype], b, hq, hkv, sq, sk, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        out.stride(0), out.stride(1), out.stride(2),
        *_mask_ints(seg_q, seg_k, causal, window, q_offset))
    stream = torch.cuda.current_stream(device).cuda_stream

    def launch() -> None:
        err = fn(ptrs, ints, float(scale), stream)
        if err:
            raise RuntimeError(f"flash_fwd launch failed: cudaError {err}")
        flash_attention.launches += 1

    launch.keep = (seg_q, seg_k)  # alive while launches may run
    return launch, (out, lse)


def _kernel_forward(q, k, v, seg_q, seg_k, scale, causal, window,
                    q_offset, csrc=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch ``flash_fwd.cu`` (the arguments of ``_forward_launcher``)."""
    launch, result = _forward_launcher(q, k, v, seg_q, seg_k, scale, causal,
                                       window, q_offset, csrc)
    launch()
    return result


def _backward_launcher(q, k, v, do, lse, delta, dlse, seg_q, seg_k, scale,
                       causal, window, q_offset, csrc=None):
    """Validate and allocate for ``flash_bwd.cu`` on (B, S, H, D) CUDA
    tensors, D in {64, 128}; ``lse``, ``delta`` and ``dlse`` (or None) are
    (B, H, Sq) fp32. Returns ``(launch, (dq, dk, dv))``: ``launch("dkv")``
    and ``launch("dq")`` launch one kernel each into those outputs (a
    timing of one kernel calls ``launch`` alone)."""
    b, sq, sk, hq, hkv, d = _check_inputs(q, k, v, seg_q, seg_k)
    dtype, device = q.dtype, q.device
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} does not match q "
                         f"{tuple(q.shape)}")
    _check_operand("do", do, dtype, device)
    stats = [lse, delta] + ([] if dlse is None else [dlse])
    lse, delta, *rest = (_aligned(t.to(device=device, dtype=torch.float32)
                                  .contiguous()) for t in stats)
    dlse = rest[0] if rest else None
    for name, t in (("lse", lse), ("delta", delta), ("dlse", dlse)):
        if t is not None and t.shape != (b, hq, sq):
            raise ValueError(f"{name} {tuple(t.shape)} is not ({b}, {hq}, "
                             f"{sq})")
    fns = {name: _library("flash_bwd", f"rtt_flash_bwd_{name}", csrc)
           for name in ("dkv", "dq")}
    dq = torch.empty((b, sq, hq, d), dtype=dtype, device=device)
    dk = torch.empty((b, sk, hkv, d), dtype=dtype, device=device)
    dv = torch.empty_like(dk)
    seg_q, seg_k = _segments(seg_q, seg_k, device)
    ptrs = (ctypes.c_void_p * 12)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), _ptr(dlse), _ptr(seg_q),
        _ptr(seg_k), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    ints = (ctypes.c_longlong * 31)(
        _DTYPE_CODES[dtype], b, hq, hkv, sq, sk, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        do.stride(0), do.stride(1), do.stride(2),
        dq.stride(0), dq.stride(1), dq.stride(2),
        dk.stride(0), dk.stride(1), dk.stride(2),
        *_mask_ints(seg_q, seg_k, causal, window, q_offset))
    stream = torch.cuda.current_stream(device).cuda_stream
    keep = (lse, delta, dlse, seg_q, seg_k)  # alive while launches may run

    def launch(name: str) -> None:
        err = fns[name](ptrs, ints, float(scale), stream)
        if err:
            raise RuntimeError(
                f"flash_bwd_{name} launch failed: cudaError {err}")
        counter = f"{name}_launches"
        setattr(flash_backward, counter, getattr(flash_backward, counter) + 1)

    launch.keep = keep
    return launch, (dq, dk, dv)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, copied if its data does not start on 16 bytes (the backward
    kernels load the (B, H, Sq) statistics by TMA, which needs that)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _kernel_backward(q, k, v, do, lse, delta, dlse, seg_q, seg_k, scale,
                     causal, window, q_offset, csrc=None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch ``flash_bwd.cu``'s dK/dV kernel, then its dQ kernel (the
    arguments of ``_backward_launcher``)."""
    launch, grads = _backward_launcher(q, k, v, do, lse, delta, dlse, seg_q,
                                       seg_k, scale, causal, window,
                                       q_offset, csrc)
    launch("dkv")
    launch("dq")
    return grads


# The attention entries' C signature: (ptrs, ints, scale, stream).
_ENTRY_ARGTYPES = [ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_float,
                   ctypes.c_void_p]


def _library(kernel: str, entry: str, csrc=None, argtypes=None):
    """``entry`` of the built library of ``kernel`` (from ``ops/csrc``
    unless ``csrc`` names another source directory, as an A/B timing of
    two versions does), with its ctypes signature set (``argtypes``, by
    default the attention entries')."""
    from ray_tpu_torch.ops import cuda_build

    fn = getattr(cuda_build.load(kernel, csrc or cuda_build.CSRC), entry)
    if fn.argtypes is None:
        fn.argtypes = argtypes or _ENTRY_ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _delta_launcher(out, do, csrc=None):
    """Validate and allocate for ``delta.cu``'s ``rtt_attention_delta`` on
    (B, S, H, D) CUDA tensors of one dtype (bf16 or float32), any D and
    any strides. Returns ``(launch, delta)``: ``launch()`` launches the
    kernel into the (B, H, S) fp32 ``delta`` (a timing calls it alone)."""
    if out.dim() != 4 or do.shape != out.shape:
        raise ValueError(f"do {tuple(do.shape)} does not match out "
                         f"{tuple(out.shape)} (B, S, H, D)")
    if out.dtype not in _DTYPE_CODES or do.dtype != out.dtype:
        raise ValueError(f"attention_delta takes bfloat16 or float32 out "
                         f"and do of one dtype, not {out.dtype} and "
                         f"{do.dtype}")
    if do.device != out.device:
        raise ValueError(f"do is on {do.device}, out on {out.device}")
    b, s, h, d = out.shape
    fn = _library("delta", "rtt_attention_delta", csrc,
                  [ctypes.POINTER(ctypes.c_void_p),
                   ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
    delta = torch.empty((b, h, s), dtype=torch.float32, device=out.device)
    ptrs = (ctypes.c_void_p * 3)(out.data_ptr(), do.data_ptr(),
                                 delta.data_ptr())
    ints = (ctypes.c_longlong * 13)(_DTYPE_CODES[out.dtype], b, s, h, d,
                                    *out.stride(), *do.stride())
    stream = torch.cuda.current_stream(out.device).cuda_stream

    def launch() -> None:
        err = fn(ptrs, ints, stream)
        if err:
            raise RuntimeError(f"attention_delta launch failed: cudaError "
                               f"{err}")
        attention_delta.launches += 1

    launch.keep = delta  # alive while launches may run
    return launch, delta


def attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in fp32, (B, S, H, D) -> (B, H, S)
    contiguous: the pre-pass of both backward kernels, dispatched on the
    tensors' device: ``delta.cu``'s kernel for CUDA tensors (or it
    raises), ``attention_delta_reference`` for CPU tensors."""
    if _device_kind(out, "attention_delta") == "cpu":
        return attention_delta_reference(out, do)
    launch, delta = _delta_launcher(out, do)
    if delta.numel():
        launch()
    return delta


attention_delta.launches = 0  # delta kernel launches (CUDA tensors only)


def _kernel_launches(kernel: str, names, csrc=None) -> dict:
    """Kernel name -> launches of it by the entries of ``<kernel>.cu``
    since its library was loaded, counted in C where the launch succeeds
    (``rtt_<kernel>_launches`` fills them in the order of ``names``):
    which kernel the calls took. Loads (and if needed builds) the library,
    so it needs the CUDA toolkit."""
    from ray_tpu_torch.ops import cuda_build

    fn = getattr(cuda_build.load(kernel, csrc or cuda_build.CSRC),
                 f"rtt_{kernel}_launches")
    fn.restype = None
    counts = (ctypes.c_longlong * len(names))()
    fn(counts)
    return dict(zip(names, counts))


def forward_kernel_launches(csrc=None) -> dict:
    """``FORWARD_KERNELS`` -> launches by ``flash_fwd.cu``'s entry."""
    return _kernel_launches("flash_fwd", FORWARD_KERNELS, csrc)


def backward_kernel_launches(csrc=None) -> dict:
    """``BACKWARD_KERNELS`` -> launches by ``flash_bwd.cu``'s two
    entries."""
    return _kernel_launches("flash_bwd", BACKWARD_KERNELS, csrc)


def _device_kind(q: torch.Tensor, op: str = "flash_attention") -> str:
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{op} runs on cuda or cpu, not {q.device}")
    return q.device.type


def _pad_d(d: int, kernel: str = "flash") -> int:
    if d > 128:
        raise ValueError(f"{kernel} kernel head dim must be <= 128, got {d}")
    return (64 if d <= 64 else 128) - d


def flash_forward(q, k, v, causal=True, q_offset=0, scale=None,
                  window=None, seg_q=None, seg_k=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` on (B, S, H, D), the arguments of
    ``flash_attention_reference``, dispatched on the tensors' device: the
    Hopper kernel for CUDA tensors, the plain version for CPU tensors.
    Pads D to the kernel's 64 / 128 (exact: zero columns change no score,
    and the padded output columns are dropped). No block-size checks: the
    kernel masks ragged edges itself."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _device_kind(q) == "cpu":
        return flash_attention_reference(q, k, v, causal, q_offset, scale,
                                         window, seg_q, seg_k)
    d = q.shape[-1]
    d_pad = _pad_d(d)
    if d_pad:
        q, k, v = (F.pad(t, (0, d_pad)) for t in (q, k, v))
    out, lse = _kernel_forward(q, k, v, seg_q, seg_k, scale, causal, window,
                               q_offset)
    return (out[..., :d] if d_pad else out), lse


def flash_backward(q, k, v, out, lse, do, dlse=None, causal=True,
                   q_offset=0, scale=None, window=None, seg_q=None,
                   seg_k=None) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """``(dq, dk, dv)`` on (B, S, H, D), the arguments of
    ``flash_backward_reference``, dispatched on the tensors' device: the
    two Hopper kernels for CUDA tensors, the plain version for CPU
    tensors. delta = rowsum(dO∘O) comes first, from ``attention_delta``
    on the unpadded tensors. Pads D to 64 / 128 like the forward (zero
    columns add nothing to any product) and drops the padded gradient
    columns."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _device_kind(q) == "cpu":
        return flash_backward_reference(q, k, v, out, lse, do, dlse, causal,
                                        q_offset, scale, window, seg_q,
                                        seg_k)
    delta = attention_delta(out, do)
    d = q.shape[-1]
    d_pad = _pad_d(d)
    if d_pad:
        q, k, v, do = (F.pad(t, (0, d_pad)) for t in (q, k, v, do))
    grads = _kernel_backward(q, k, v, do, lse, delta, dlse, seg_q, seg_k,
                             scale, causal, window, q_offset)
    return tuple(g[..., :d] for g in grads) if d_pad else grads


flash_backward.dkv_launches = 0  # dK/dV kernel launches (CUDA only)
flash_backward.dq_launches = 0   # dQ kernel launches (CUDA only)


class _Flash(torch.autograd.Function):
    """(out, lse) = flash_forward(q, k, v); the backward runs
    ``flash_backward`` on the saved (q, k, v, out, lse), passing the lse
    cotangent only where the caller asked for lse as an output
    (``flash_attention_stats``). Segment ids get no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, opts, lse_is_output):
        out, lse = flash_forward(q, k, v, **opts)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = opts
        ctx.lse_is_output = lse_is_output
        ctx.set_materialize_grads(False)
        if not lse_is_output:
            ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(out)
        dq, dk, dv = flash_backward(
            q, k, v, out, lse, do, dlse if ctx.lse_is_output else None,
            **ctx.opts)
        return dq, dk, dv, None, None


def _run(q, k, v, opts, lse_is_output):
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, opts, lse_is_output)
    return flash_forward(q, k, v, **opts)


# ------------------------------------------------------------- public API


def flash_attention(
    q: torch.Tensor,                # (B, S, Hq, D)
    k: torch.Tensor,                # (B, S, Hkv, D)
    v: torch.Tensor,                # (B, S, Hkv, D)
    causal: bool = True,
    q_offset: int = 0,
    block_q: int = 256,
    block_k: int = 256,
    scale: Optional[float] = None,
    window: Optional[int] = None,
    segment_ids: Optional[torch.Tensor] = None,     # (B, S) int
    kv_segment_ids: Optional[torch.Tensor] = None,  # (B, S_kv) int
) -> torch.Tensor:
    """Flash attention over (batch, seq, heads, head_dim) tensors,
    differentiable through the backward kernels.

    ``window`` keeps only the last ``window`` positions per query;
    ``segment_ids`` masks cross-segment attention (packed sequences).
    ``block_q``/``block_k`` are validated as in the JAX package (the
    sequence lengths must divide them); the Hopper kernels pick their own
    tiles and mask ragged edges themselves."""
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if scale is None:
        scale = d ** -0.5
    block_q = min(block_q, sq)
    block_k = min(block_k, sk)
    if sq % block_q or sk % block_k:
        raise ValueError(
            f"seq lengths ({sq}, {sk}) must divide blocks ({block_q}, "
            f"{block_k})")
    seg_q = seg_k = None
    if kv_segment_ids is not None and segment_ids is None:
        raise ValueError(
            "kv_segment_ids requires segment_ids (the query-side ids); "
            "pass both to mask packed cross-attention")
    if segment_ids is not None:
        seg_q = segment_ids
        seg_k = segment_ids if kv_segment_ids is None else kv_segment_ids
    opts = dict(causal=causal, q_offset=q_offset, scale=scale, window=window,
                seg_q=seg_q, seg_k=seg_k)
    return _run(q, k, v, opts, False)[0]


flash_attention.launches = 0  # forward kernel launches (CUDA tensors only)


def flash_attention_stats(q, k, v, scale, causal, window, q_offset,
                          block_q, block_k
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) on (B, H, S, D) tensors, lse shaped (B, H, S): the JAX
    package's signature and layout (the hook ring attention's cross-shard
    merge uses). Differentiable in both outputs: the backward takes the
    lse cotangent (``ds += p * g_lse``)."""
    if q.shape[2] % block_q or k.shape[2] % block_k:
        raise ValueError(
            f"seq lengths ({q.shape[2]}, {k.shape[2]}) must divide blocks "
            f"({block_q}, {block_k})")
    opts = dict(causal=causal, q_offset=q_offset, scale=scale, window=window)
    # The kernels read through strides: the transposes are views.
    out, lse = _run(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    opts, True)
    return out.transpose(1, 2), lse
