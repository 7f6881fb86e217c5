"""Time two versions of the flash kernels on one card, in turns.

    python -m ray_tpu_torch.tools.flash_ab PARENT_CSRC_DIR [fwd|bwd]
    python -m ray_tpu_torch.tools.flash_ab LABEL=DIR [LABEL=DIR ...] [fwd]

Builds the kernel source (``flash_fwd.cu`` for ``fwd``, the default;
``flash_bwd.cu`` for ``bwd``) from ``PARENT_CSRC_DIR`` (e.g. the
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
  causal, bf16); the dK/dV and dQ kernels are timed separately.

Prints one JSON line with the card's name and power limit. Needs one CUDA
card.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

from ray_tpu_torch.ops import cuda_build
from ray_tpu_torch.ops import flash_attention as fa


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
    _turns(out, dirs, {
        name: (lambda which, name=name: lambda: launchers[which][0](name))
        for name in ("dkv", "dq")})
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    lib = torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True)
    out["sdpa_bwd_ms"] = _time_ms(lambda: torch.autograd.grad(
        lib, (qt, kt, vt), do.transpose(1, 2), retain_graph=True))
    return out


def main(*args: str) -> int:
    """``args``: one or more source directories, each ``DIR`` (labelled
    "parent") or ``LABEL=DIR``, then optionally ``fwd`` or ``bwd``."""
    kernel = args[-1] if args and args[-1] in ("fwd", "bwd") else "fwd"
    sources = [a for a in args if a not in ("fwd", "bwd")]
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
    out = (_ab_fwd if kernel == "fwd" else _ab_bwd)(dirs, g)
    out["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
