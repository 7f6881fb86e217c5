"""Where a 7B decode step's time goes on one card: contiguous, paged, and
a speculative round.

    python -m ray_tpu_torch.tools.serve_profile [STEPS [CONTEXT [LAYOUTS]]]

Builds Llama-2-7B (``PRESETS["7b"]`` at full width and depth, random bf16
weights from seed 0, ``attention_impl="flash"``), then for each engine
layout in turn (``LAYOUTS``, comma-separated, default
``contiguous,paged,spec``: the contiguous cache, a paged pool of 64-token
pages, and that pool with the 1B preset as a speculative draft, random
weights from seed 1, ``spec_k=4``), seats 8 greedy requests of
``CONTEXT`` prompt tokens (default 1024) in 8 slots of 2048 tokens with
room for every page (no preemption, no chunked prefill, no draft
demotion), takes two warm-up steps, and traces ``STEPS`` engine steps
(default 8; a spec step is one round) with ``torch.profiler``. Prints one
JSON line per layout: the step time (host clock, each step ends in the
host's copy of the step's tokens), the device's busy and idle share of
the traced window, the device time by kernel group and by kernel (top
12), for a spec round also its draft and verify phases' host times from
the step timeline, beside the card's name and power limit. Needs one
CUDA card.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from dataclasses import replace

import numpy as np
import torch

from ray_tpu_torch.tools.train_profile import _device_us

SLOTS, CAPACITY, PAGE_TOKENS = 8, 2048, 64
# Kernel-name fragments -> group, first match wins.
GROUPS = (
    ("flash_fwd", "flash_fwd"),
    ("gemm", "matmul"), ("xmma", "matmul"), ("cutlass", "matmul"),
    ("sm90", "matmul"), ("nvjet", "matmul"),
    ("index", "gather/scatter"), ("gather", "gather/scatter"),
    ("scatter", "gather/scatter"),
    ("softmax", "softmax"), ("reduce", "reduction"),
    ("elementwise", "elementwise"), ("vectorized", "elementwise"),
    ("copy", "copy/cast"), ("Memcpy", "copy/cast"), ("Memset", "copy/cast"),
)


def _group(name: str) -> str:
    for frag, group in GROUPS:
        if frag in name:
            return group
    return "other"


def _profile(engine, steps: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_kernel = sorted(((e.key, _device_us(e) / 1e3, e.count)
                        for e in kernels), key=lambda t: -t[1])
    busy_ms = sum(ms for _, ms, _ in by_kernel)
    groups: dict = {}
    for name, ms, _ in by_kernel:
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    return {
        "step_ms": wall_ms / steps,
        "device_busy_ms_per_step": busy_ms / steps,
        "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
        "groups_ms_per_step": {k: v / steps for k, v in
                               sorted(groups.items(), key=lambda t: -t[1])},
        "top_kernels": [{"name": n[:100], "ms_per_step": ms / steps,
                         "calls_per_step": c / steps}
                        for n, ms, c in by_kernel[:12]],
    }


def main(steps: int = 8, context: int = 1024,
         layouts: str = "contiguous,paged,spec") -> int:
    if not torch.cuda.is_available():
        print("serve_profile: no CUDA device is available", file=sys.stderr)
        return 1
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.serve.decode import DecodeEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = replace(llama.PRESETS["7b"], attention_impl="flash")
    params = llama.init_params(cfg, device="cuda", seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size, context).tolist()
               for _ in range(SLOTS)]
    device = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip()
    draft_cfg = llama.PRESETS["1b"]
    kws = {"contiguous": {}, "paged": dict(page_tokens=PAGE_TOKENS),
           "spec": dict(page_tokens=PAGE_TOKENS, spec_draft_config=draft_cfg,
                        spec_k=4)}
    for layout in layouts.split(","):
        kw = dict(kws[layout])
        if layout == "spec":
            kw["spec_draft_params"] = llama.init_params(
                draft_cfg, device="cuda", seed=1)
        engine = DecodeEngine(params, cfg, slots=SLOTS, capacity=CAPACITY,
                              prefix_pool_entries=0, device="cuda", **kw)
        for p in prompts:
            engine.submit(p, max_new_tokens=steps * 5 + 8)
        for _ in range(2):  # the admission wave, then a plain step
            engine.step()
        torch.cuda.synchronize()
        rows = len(engine.timeline()["rows"])
        out = {"layout": layout, "slots": SLOTS, "context": context,
               "steps": steps, **_profile(engine, steps), "device": device}
        if engine.spec:
            phases = [p for row in engine.timeline()["rows"][rows:]
                      for p in row["phases"]]
            for name in ("draft", "verify"):
                ms = [1e3 * (p["t1"] - p["t0"]) for p in phases
                      if p["phase"] == name]
                out[f"{name}_host_ms"] = sum(ms) / len(ms)
            out["spec"] = engine.stats()["spec"]
        print(json.dumps(out), flush=True)
        engine.shutdown()
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:3]] + sys.argv[3:4]
    sys.exit(main(*args))
