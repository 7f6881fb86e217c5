"""Time two versions of the flash or splash kernels on one card, in turns.

    python -m ray_tpu_torch.tools.flash_ab PARENT_CSRC_DIR [fwd|bwd|splash]
    python -m ray_tpu_torch.tools.flash_ab LABEL=DIR [LABEL=DIR ...] [MODE]

Builds the kernel source (``flash_fwd.cu`` for ``fwd``, the default;
``flash_bwd.cu`` for ``bwd``; ``splash.cu`` for ``splash``) from
``PARENT_CSRC_DIR`` (e.g. the
``ops/csrc`` of the parent commit unpacked into a git-ignored directory)
and from this checkout's ``ray_tpu_torch/ops/csrc``, holds both against the
plain version, then times their launches alone (the wrapper's host work
kept out) parent, change, change, parent with CUDA events, the PyTorch
library call (SDPA, or its backward) alongside. With several labelled
directories (versions of one design step by step) each is timed in turn,
there and back: a, b, ..., change, change, ..., b, a.

- ``fwd``: the forward's two main-path shapes, causal, bf16: the serving
  path's largest prefill (B=4, S=2048, H=32, D=128) and the training
  path's (B=4, S=2048, 16 q heads on 8 kv heads, D=128), with SDPA on
  the same call (``enable_gqa`` for the second).
- ``bwd``: the training path's shape (B=4, S=2048, H=16, Hkv=8, D=128,
  causal, bf16): the dK/dV and dQ kernels each, the two back to back
  ("pair"), their sum, the delta pre-pass and the unit (delta + pair),
  beside SDPA's backward pinned to each backend that takes the call
  (``SDPA_BACKENDS``), the fastest named as the yardstick.
- ``splash``: ``chip_smoke.py``'s splash shape (B=1, S=8192, 16 q heads
  on 8 kv heads, D=128, bf16, heads 0-7 ``LocalMask(1024)``, 8-11
  ``ChunkedMask(2048)``, 12-13 ``CausalMask``, 14-15 ``FullMask``): the
  forward, dK/dV and dQ kernels each, dK/dV + dQ back to back ("pair")
  and the call's kernels with the delta pre-pass ("call": forward,
  delta, dK/dV, dQ), beside SDPA with the dense boolean mask and
  ``flex_attention`` with a ``create_block_mask`` of the same stack
  (compiled once, outside the timed window; its error instead where it
  does not compile), forward and backward. A directory whose
  ``splash.cu`` has no ``splash_bwd_dq_wgmma_kernel`` speaks the older
  interface of the mma.sync dQ (the forward and dK/dV from the call
  schedule, dQ one launch per head group on that group's own schedule)
  and is launched that way; the delta pre-pass is this checkout's in
  every version, and its plain version is timed beside it.

Prints one JSON line with the card's name and power limit. Needs one CUDA
card.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ray_tpu_torch.ops import cuda_build
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import splash_attention as ss


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _turns(out, dirs, timers) -> None:
    """Time each named timer over the versions in turns, there and back
    (parent, change, change, parent for two)."""
    order = list(dirs) + list(dirs)[::-1]
    for label, make in timers.items():
        turns = [(which, _time_ms(make(which))) for which in order]
        out[f"{label}_turns_ms"] = turns
        for which in dirs:
            ts = [t for w, t in turns if w == which]
            out[f"{label}_{which}_ms"] = sum(ts) / len(ts)


# The forward's two main-path shapes: (B, S, H, Hkv, D), causal, bf16.
FWD_SHAPES = {"prefill_7b": (4, 2048, 32, 32, 128),
              "train_1b": (4, 2048, 16, 8, 128)}


def _ab_fwd(dirs, g) -> dict:
    out = {"kernel": "fwd", "dtype": "bfloat16", "causal": True}
    for name, (b, s, h, hkv, d) in FWD_SHAPES.items():
        q = torch.randn(b, s, h, d, generator=g, device="cuda").to(
            torch.bfloat16)
        k, v = (torch.randn(b, s, hkv, d, generator=g, device="cuda")
                .to(torch.bfloat16) for _ in range(2))
        ref, ref_lse = fa.flash_attention_reference(q, k, v, causal=True)
        launchers = {which: fa._forward_launcher(
            q, k, v, None, None, d ** -0.5, True, None, 0, csrc=dirs[which])
            for which in dirs}
        res = {"shape": [b, s, h, hkv, d]}
        for which, (launch, (o, lse)) in launchers.items():
            launch()
            torch.cuda.synchronize()
            res[f"{which}_max_abs_err"] = _err(o, ref)
            res[f"{which}_lse_max_abs_err"] = _err(lse, ref_lse)
        del ref, ref_lse
        _turns(res, dirs, {"fwd": lambda which: launchers[which][0]})
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        res["sdpa_ms"] = _time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=hkv != h))
        out[name] = res
        del q, k, v, qt, kt, vt, launchers
        torch.cuda.empty_cache()
    return out


# The SDPA backends the backward yardstick is timed on, each pinned with
# ``sdpa_kernel``.
SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION")


def sdpa_backward_ms(q, k, v, do) -> dict:
    """The backward of causal SDPA (``enable_gqa`` where the heads differ)
    on (B, S, H, D) bf16 tensors, dq, dk and dv together (what the delta
    pre-pass and both backward kernels compute), pinned with
    ``sdpa_kernel`` to each backend of ``SDPA_BACKENDS`` that takes the
    call and timed in turns, there and back (``sdpa_bwd_turns_ms``): each
    backend's mean (``sdpa_bwd_ms_by_backend``) and the fastest
    (``sdpa_backend``, ``sdpa_bwd_ms``), the yardstick."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)
    gqa = q.shape[2] != k.shape[2]
    timers = {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name)
        try:
            with sdpa_kernel([backend]):
                out = torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=gqa)
                torch.autograd.grad(out, (qt, kt, vt), dot,
                                    retain_graph=True)
            torch.cuda.synchronize()
        except RuntimeError:
            continue

        def run(backend=backend, out=out):
            with sdpa_kernel([backend]):
                torch.autograd.grad(out, (qt, kt, vt), dot,
                                    retain_graph=True)
        timers[name] = run
    if not timers:
        raise RuntimeError("no SDPA backend takes the causal backward here")
    order = list(timers) + list(timers)[::-1]
    turns = [(name, _time_ms(timers[name], warmup=5)) for name in order]
    by = {name: sum(t for n, t in turns if n == name) / 2 for name in timers}
    best = min(by, key=by.get)
    return {"sdpa_bwd_turns_ms": turns, "sdpa_bwd_ms_by_backend": by,
            "sdpa_backend": best, "sdpa_bwd_ms": by[best]}


def _ab_bwd(dirs, g) -> dict:
    b, s, h, hkv, d = 4, 2048, 16, 8, 128

    def rnd(heads):
        return torch.randn(b, s, heads, d, generator=g,
                           device="cuda").to(torch.bfloat16)

    q, k, v, do = rnd(h), rnd(hkv), rnd(hkv), rnd(h)
    scale = d ** -0.5
    o, lse = fa.flash_forward(q, k, v, causal=True)
    delta = fa.attention_delta(o, do)
    ref = fa.flash_backward_reference(q, k, v, o, lse, do, causal=True)

    launchers = {which: fa._backward_launcher(
        q, k, v, do, lse, delta, None, None, None, scale, True, None, 0,
        csrc=dirs[which]) for which in dirs}
    out = {"kernel": "bwd", "shape": [b, s, h, hkv, d], "dtype": "bfloat16",
           "causal": True}
    for which, (launch, got) in launchers.items():
        launch("dkv")
        launch("dq")
        torch.cuda.synchronize()
        out[f"{which}_rel_max_abs_err"] = {
            n: _err(a, r) / float(r.float().abs().max())
            for n, a, r in zip(("dq", "dk", "dv"), got, ref)}
    del ref

    def pair(which):
        def run():
            launchers[which][0]("dkv")
            launchers[which][0]("dq")
        return run

    timers = {name: (lambda which, name=name: lambda: launchers[which][0](name))
              for name in ("dkv", "dq")}
    timers["pair"] = pair
    _turns(out, dirs, timers)
    # The delta pre-pass is this checkout's kernel in every version,
    # launched alone (its plain version beside it); the unit (delta +
    # dK/dV + dQ) is what SDPA's backward call computes.
    out["delta_ms"] = _time_ms(fa._delta_launcher(o, do)[0])
    out["delta_plain_ms"] = _time_ms(
        lambda: fa.attention_delta_reference(o, do))
    for which in dirs:
        out[f"sum_{which}_ms"] = out[f"dkv_{which}_ms"] + out[f"dq_{which}_ms"]
        out[f"unit_{which}_ms"] = out["delta_ms"] + out[f"pair_{which}_ms"]
    out.update(sdpa_backward_ms(q, k, v, do))
    return out


# ----------------------------------------------------------------- splash

SPLASH_SHAPE = (1, 8192, 16, 8, 128)  # B, S, H, Hkv, D


def splash_masks():
    return ([ss.LocalMask(1024)] * 8 + [ss.ChunkedMask(2048)] * 4
            + [ss.CausalMask()] * 2 + [ss.FullMask()] * 2)


# The per-group dQ interface (an earlier ``splash.cu``, whose mma.sync dQ
# launched once per head group): 64 x 64 tiles, and its entries' argument
# layout.
_PARENT_TILE = 64


class _GroupSchedule(NamedTuple):
    """One head group's q schedule at 64 x 64 as the per-group dQ reads it:
    ids, lengths, full flags and the order of its q tiles."""
    kv_ids: torch.Tensor
    kv_lens: torch.Tensor
    kv_full: torch.Tensor
    q_order: torch.Tensor
    q_len: int


def _group_schedule(mask, sq, sk, device) -> _GroupSchedule:
    t = _PARENT_TILE
    s = ss._Schedule(mask, -(-sq // t), -(-sk // t), t, t)
    kv_full, _ = ss._full_flags(mask, s, sq, sk, t, t)
    arrays = [torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)
              for a in (s.kv_ids, s.kv_lens, kv_full,
                        np.argsort(-s.kv_lens, kind="stable"))]
    return _GroupSchedule(*arrays, s.q_len)


def _parent_args(q, k, v, *, sched=None, code=0, param=0, call=None,
                 n_blocks=0, out=None, lse=None, do=None, delta=None,
                 dq=None, dk=None, dv=None):
    """ctypes (ptrs, ints) in the per-group dQ interface's layout (15
    pointers: the call's ten tensors, a group's four schedule arrays, the
    call schedule; 34 ints: this checkout's 30, then mask code, mask
    param, q_len, n_blocks)."""
    def ptr(t):
        return None if t is None else t.data_ptr()

    lists = (None,) * 4 if sched is None else sched[:4]
    stats = lse if lse is not None else delta
    ptrs = (ctypes.c_void_p * 15)(
        ptr(q), ptr(k), ptr(v), ptr(out), ptr(lse), ptr(do), ptr(delta),
        ptr(dq), ptr(dk), ptr(dv), *(ptr(x) for x in lists), ptr(call))
    _, cur = ss._kernel_args(q.dtype, q, k, v, None, 0, out=out, lse=stats,
                             do=do, dq=dq, dk=dk)
    ints = (ctypes.c_longlong * 34)(
        *cur[:30], code, param, 0 if sched is None else sched.q_len,
        n_blocks)
    return ptrs, ints


def _parent_launchers(csrc, q, k, v, do, masks, scale):
    """``{"fwd", "dkv", "dq"}`` -> a launch of that kernel through the
    per-group dQ interface of ``csrc``'s ``splash.cu`` (the forward and
    dK/dV once over all head groups, dQ once per head group), into
    outputs allocated here; and ``(out, lse, delta)``, ``(dq, dk, dv)``."""
    b, s_, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    fns = {name: fa._library("splash", f"rtt_splash_{name}", csrc)
           for name in ("fwd", "bwd_dkv", "bwd_dq")}
    out = torch.empty_like(q)
    lse = torch.empty((b, h, s_), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    fwd_call = ss._call_schedule(masks, group, s_, s_, 128, 128, q.device)
    dkv_call = ss._call_schedule(masks, group, s_, s_, 64, 64, q.device)
    args = {"fwd": [_parent_args(q, k, v, call=fwd_call.fwd,
                                 n_blocks=fwd_call.fwd_blocks, out=out,
                                 lse=lse)]}
    stream = torch.cuda.current_stream().cuda_stream

    def run(name):
        def go():
            for ptrs, ints in args[name]:
                err = fns[name](ptrs, ints, float(scale), stream)
                if err:
                    raise RuntimeError(f"splash {name}: cudaError {err}")
        return go

    run("fwd")()
    delta = fa.attention_delta(out, do)
    args["bwd_dkv"] = [_parent_args(q, k, v, call=dkv_call.dkv,
                                    n_blocks=dkv_call.dkv_blocks, lse=lse,
                                    do=do, delta=delta, dk=dk, dv=dv)]
    scheds = []  # alive while launches may run
    args["bwd_dq"] = []
    for a, c, m in ss._aligned_groups(masks, group):
        code, param = ss._kernel_mask(m)
        scheds.append(_group_schedule(m, s_, s_, q.device))
        qs, ks = slice(a, a + c), slice(a // group, (a + c) // group)
        args["bwd_dq"].append(_parent_args(
            q[:, :, qs], k[:, :, ks], v[:, :, ks], sched=scheds[-1],
            code=code, param=param, lse=lse[:, qs], do=do[:, :, qs],
            delta=delta[:, qs], dq=dq[:, :, qs]))
    launches = {"fwd": run("fwd"), "dkv": run("bwd_dkv"), "dq": run("bwd_dq")}
    launches["dq"].keep = (scheds, fwd_call, dkv_call)
    return launches, (out, lse, delta), (dq, dk, dv)


def _splash_launchers(csrc, q, k, v, do, masks, scale):
    """The launchers of ``csrc``'s splash kernels, in the interface its
    source speaks: ``({"fwd", "dkv", "dq"} -> launch, (out, lse, delta),
    (dq, dk, dv))``."""
    if "splash_bwd_dq_wgmma_kernel" not in (Path(csrc) / "splash.cu"
                                             ).read_text():
        return _parent_launchers(csrc, q, k, v, do, masks, scale)
    fwd, (out, lse) = ss._splash_forward_launcher(q, k, v, masks, scale,
                                                  csrc)
    fwd()
    delta = fa.attention_delta(out, do)
    bwd, grads = ss._splash_backward_launcher(q, k, v, do, lse, delta, masks,
                                              scale, csrc)
    return ({"fwd": fwd, "dkv": lambda: bwd("dkv"), "dq": lambda: bwd("dq")},
            (out, lse, delta), grads)


def _splash_plain(q, k, v, do, masks):
    """The plain forward and backward, one kv head (and its q heads) at a
    time: ((out, lse), (dq, dk, dv))."""
    group = q.shape[2] // k.shape[2]
    outs, lses, grads = [], [], []
    for i in range(k.shape[2]):
        qs, ks = slice(i * group, (i + 1) * group), slice(i, i + 1)
        args = (q[:, :, qs], k[:, :, ks], v[:, :, ks])
        out, lse = ss.splash_attention_reference(*args, masks[qs])
        grads.append(ss.splash_backward_reference(*args, out, lse,
                                                  do[:, :, qs], masks[qs]))
        outs.append(out)
        lses.append(lse)
    return ((torch.cat(outs, 2), torch.cat(lses, 1)),
            tuple(torch.cat(g, 2) for g in zip(*grads)))


def _flex_ms(q, k, v, do, masks) -> dict:
    """``flex_attention`` on the same call with a ``create_block_mask`` of
    the mask stack (each head's ``apply`` as its mask_mod), compiled once
    outside the timed window: forward and backward ms, or the error."""
    try:
        from torch.nn.attention.flex_attention import (create_block_mask,
                                                       flex_attention)

        groups = ss._group_heads(masks)

        def mask_mod(b, h, q_idx, kv_idx):
            keep = q_idx < 0
            for a, c, m in groups:
                live = m.apply(torch.zeros_like(q_idx, dtype=torch.float32),
                               q_idx, kv_idx) == 0
                keep = keep | ((h >= a) & (h < a + c) & live)
            return keep

        s_ = q.shape[1]
        block_mask = create_block_mask(mask_mod, None, q.shape[2], s_, s_,
                                       device="cuda")
        flex = torch.compile(flex_attention)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        dot = do.transpose(1, 2)

        def fwd():
            return flex(qt, kt, vt, block_mask=block_mask, enable_gqa=True)

        out = fwd()
        torch.autograd.grad(out, (qt, kt, vt), dot, retain_graph=True)
        torch.cuda.synchronize()
        return {"flex_fwd_ms": _time_ms(fwd),
                "flex_bwd_ms": _time_ms(lambda: torch.autograd.grad(
                    out, (qt, kt, vt), dot, retain_graph=True)),
                "flex_out": out.detach().transpose(1, 2)}
    except Exception as e:  # the yardstick only; its error is the result
        return {"flex_error": f"{type(e).__name__}: {e}"[:2000]}


def _ab_splash(dirs, g) -> dict:
    b, s_, h, hkv, d = SPLASH_SHAPE
    masks = splash_masks()

    def rnd(heads):
        return torch.randn(b, s_, heads, d, generator=g,
                           device="cuda").to(torch.bfloat16)

    q, k, v, do = rnd(h), rnd(hkv), rnd(hkv), rnd(h)
    scale = d ** -0.5
    (ref, ref_lse), ref_grads = _splash_plain(q, k, v, do, masks)
    versions = {w: _splash_launchers(dirs[w], q, k, v, do, masks, scale)
                for w in dirs}
    out = {"kernel": "splash", "shape": list(SPLASH_SHAPE),
           "dtype": "bfloat16",
           "masks": "heads 0-7 LocalMask(1024), 8-11 ChunkedMask(2048), "
                    "12-13 CausalMask, 14-15 FullMask"}
    for which, (launch, (o, lse, _), grads) in versions.items():
        launch["dkv"]()
        launch["dq"]()
        torch.cuda.synchronize()
        out[f"{which}_max_abs_err"] = _err(o, ref)
        out[f"{which}_rel_max_abs_err"] = {
            n: _err(a, r) / float(r.float().abs().max())
            for n, a, r in zip(("dq", "dk", "dv"), grads, ref_grads)}
    del ref, ref_lse, ref_grads

    def seq(*names, delta=False):
        def make(which):
            launch, (o, _, _), _ = versions[which]
            delta_launch = fa._delta_launcher(o, do)[0]

            def run():
                for n in names:
                    launch[n]()
                    if delta and n == "fwd":
                        delta_launch()
            return run
        return make

    _turns(out, dirs, {"fwd": seq("fwd"), "dkv": seq("dkv"), "dq": seq("dq"),
                       "pair": seq("dkv", "dq"),
                       "call": seq("fwd", "dkv", "dq", delta=True)})
    # Library yardsticks: SDPA with the dense (H, S, S) boolean mask (k and
    # v expanded to the q heads), and flex_attention with a block mask.
    rows = torch.arange(s_, device="cuda")[:, None]
    cols = torch.arange(s_, device="cuda")[None, :]
    dense = torch.stack([m.apply(torch.zeros(s_, s_, device="cuda"), rows,
                                 cols) == 0 for m in masks])[None]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (x.repeat_interleave(h // hkv, dim=2).transpose(1, 2).detach()
              .requires_grad_() for x in (k, v))
    dot = do.transpose(1, 2)

    def sdpa():
        return torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=dense)

    out["sdpa_dense_fwd_ms"] = _time_ms(sdpa, iters=10)
    lib_out = sdpa()
    out["sdpa_dense_bwd_ms"] = _time_ms(lambda: torch.autograd.grad(
        lib_out, (qt, kt, vt), dot, retain_graph=True), iters=10)
    del dense, qt, kt, vt, lib_out
    torch.cuda.empty_cache()
    flex = _flex_ms(q, k, v, do, masks)
    flex_out = flex.pop("flex_out", None)
    if flex_out is not None:
        out["flex_max_abs_err_vs_change"] = _err(
            flex_out, versions["change"][1][0])
    out.update(flex)
    return out


MODES = ("fwd", "bwd", "splash")


def main(*args: str) -> int:
    """``args``: one or more source directories, each ``DIR`` (labelled
    "parent") or ``LABEL=DIR``, then optionally ``fwd``, ``bwd`` or
    ``splash``."""
    kernel = args[-1] if args and args[-1] in MODES else "fwd"
    sources = [a for a in args if a not in MODES]
    if not sources:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dirs = {}
    for a in sources:
        label, _, path = a.rpartition("=")
        dirs[label or "parent"] = Path(path)
    dirs["change"] = cuda_build.CSRC
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"fwd": _ab_fwd, "bwd": _ab_bwd, "splash": _ab_splash}[kernel](
        dirs, g)
    out["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
