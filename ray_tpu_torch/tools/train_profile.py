"""Where a train step's time goes on one card.

    python -m ray_tpu_torch.tools.train_profile [llama|vit] [STEPS [TRACE_JSON]]

Default (llama): the training configuration ``chip_smoke.py`` drives
(``PRESETS["1b"]`` at full width and depth, fp32 masters from seed 0,
``attention_impl="flash"``, full remat, ``loss_chunk=512``, AdamW, two
microbatches of 4 x 2048 tokens). ``vit``: the smoke's vit phase
(``vit.PRESETS["vit_b16"]``, fp32 masters from seed 0, bf16 compute, full
remat, AdamW(3e-4, weight decay 0.1), batch 256) fed by
``device_prefetch(prefetch=2)`` from seeded numpy batches. Takes one
warm-up step, then traces ``STEPS`` steps (default 2) with
``torch.profiler``. Prints one JSON line: the step time, the device's busy
and idle share of the traced window, the device time by kernel group and
by kernel (top 20), and the device time under the PyTorch ops that launch
the products and copies (``aten::mm`` / ``addmm``: the 2-D products,
bf16 in both models but for their fp32 heads; ``aten::bmm``: ViT's
attention products, fp32; host-to-device copies), beside the card's name
and power limit. Writes the Chrome trace to ``TRACE_JSON`` when given.
Needs one CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import replace
from pathlib import Path

import torch

# Kernel-name fragments -> group, first match wins.
GROUPS = (
    ("flash_bwd_dkv", "flash_bwd_dkv"), ("flash_bwd_dq", "flash_bwd_dq"),
    ("flash_fwd", "flash_fwd"),
    ("gemm", "matmul"), ("xmma", "matmul"), ("cutlass", "matmul"),
    ("sm90", "matmul"), ("nvjet", "matmul"),
    ("reduce", "reduction"), ("softmax", "reduction"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"),
    ("copy", "copy/cast"), ("Memcpy", "copy/cast"), ("Memset", "copy/cast"),
)


def _group(name: str) -> str:
    for frag, group in GROUPS:
        if frag in name:
            return group
    return "other"


def _device_us(evt, total: bool = False) -> float:
    """An event's device time (its own kernels, or with ``total`` those of
    the ops under it too), in microseconds."""
    kind = "" if total else "self_"
    for attr in (f"{kind}device_time_total", f"{kind}cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


# PyTorch ops whose device time (their kernels) the line reports.
OPS = ("aten::mm", "aten::addmm", "aten::bmm")


def _llama_step():
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.optim import adamw
    from ray_tpu_torch.parallel import train_step

    cfg = replace(llama.PRESETS["1b"], attention_impl="flash", remat=True,
                  remat_policy="full", loss_chunk=512)
    params = llama.init_params(cfg, device="cuda", dtype=torch.float32,
                               seed=0)
    opt = adamw(3e-4, weight_decay=0.1)
    state = train_step.init_optimizer_state(opt, params)
    step = train_step.build_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg), opt, accum_steps=2)
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 2049),
                                     generator=g, device="cuda")}

    def run():
        nonlocal params, state
        params, state, m = step(params, state, batch)
        return m

    return run


def _vit_step(steps: int):
    import numpy as np

    from ray_tpu_torch.data import device_prefetch
    from ray_tpu_torch.models import vit
    from ray_tpu_torch.ops.optim import adamw
    from ray_tpu_torch.parallel import train_step

    cfg = vit.PRESETS["vit_b16"]
    g = torch.Generator(device="cuda").manual_seed(0)
    params = vit.init_params(cfg, g, device="cuda")
    opt = adamw(3e-4, weight_decay=0.1)
    state = train_step.init_optimizer_state(opt, params)
    step = train_step.build_train_step(
        lambda p, b: vit.loss_fn(p, b, cfg)[0], opt)
    rng = np.random.default_rng(1)
    shape = (256, cfg.image_size, cfg.image_size, cfg.channels)
    host = [{"images": rng.standard_normal(shape, dtype=np.float32),
             "labels": rng.integers(0, cfg.num_classes, shape[0])}
            for _ in range(2)]
    # The warm-up, the traced steps, and the 3 batches the producer may
    # hold ahead, so the traced window copies as many batches as it takes.
    batches = device_prefetch((host[i % 2] for i in range(steps + 4)),
                              prefetch=2)

    def run():
        nonlocal params, state
        params, state, m = step(params, state, next(batches))
        return m

    return run


def main(steps: int = 2, trace: str = "", model: str = "llama") -> int:
    if not torch.cuda.is_available():
        print("train_profile: no CUDA device is available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    run = _vit_step(steps) if model == "vit" else _llama_step()
    run()                                             # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            m = run()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel = sorted(((e.key, _device_us(e) / 1e3, e.count)
                        for e in kernels), key=lambda t: -t[1])
    busy_ms = sum(ms for _, ms, _ in by_kernel)
    groups: dict = {}
    for name, ms, _ in by_kernel:
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    ops = {e.key: _device_us(e, total=True) / 1e3 for e in events
           if e.key in OPS and e.device_type != torch.autograd.DeviceType.CUDA}
    ops["h2d copies"] = sum(ms for name, ms, _ in by_kernel
                            if "Memcpy HtoD" in name)
    if trace:
        Path(trace).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(trace)
    wall_ms = wall_s * 1e3
    print(json.dumps({
        "model": model, "steps": steps, "step_ms": wall_ms / steps,
        "loss": float(m["loss"]),
        "device_busy_ms_per_step": busy_ms / steps,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "groups_ms_per_step": {k: v / steps for k, v in
                               sorted(groups.items(), key=lambda t: -t[1])},
        "ops_ms_per_step": {k: v / steps for k, v in ops.items()},
        "top_kernels": [{"name": n[:120], "ms_per_step": ms / steps,
                         "calls_per_step": c / steps}
                        for n, ms, c in by_kernel[:20]],
        "device": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip(),
    }), flush=True)
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    model = args.pop(0) if args and args[0] in ("llama", "vit") else "llama"
    sys.exit(main(int(args[0]) if args else 2, *args[1:2], model=model))
