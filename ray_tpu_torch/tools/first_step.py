"""Where a fresh process's first train step goes on one card.

    python -m ray_tpu_torch.tools.first_step

Runs, each in a fresh interpreter, one after the other: ``import torch``,
``import ray_tpu_torch``, the CUDA context, then the train runtime's
model (``PRESETS["1b"]`` cut to 4 layers at full width, fp32 masters,
flash, full remat, ``loss_chunk=512``, AdamW, two microbatches of 4 x
2048 tokens) for three steps, each timed after a sync. The processes
differ in what runs before step 1: nothing (``plain``), a 4096^2 bf16
product (``gemm``), one flash forward (``flash``), or the CPU profiler
started around step 1 (``prof``, which also prints the step's top ops by
host time). Prints one JSON line per process (seconds of each stage and
the process's wall time), then the card's name and power limit. Needs
one CUDA card; the kernels are built first, in this process.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from dataclasses import replace

MODES = ("plain", "gemm", "flash", "prof", "plain")


def child(mode: str) -> dict:
    """One fresh process's stages (run with ``--child MODE``)."""
    out = {"mode": mode}
    t = time.perf_counter()
    import torch
    out["import_torch_s"] = time.perf_counter() - t
    t = time.perf_counter()
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.ops.optim import adamw
    from ray_tpu_torch.parallel import train_step
    out["import_port_s"] = time.perf_counter() - t
    sync = torch.cuda.synchronize
    t = time.perf_counter()
    torch.zeros(1, device="cuda")
    sync()
    out["cuda_context_s"] = time.perf_counter() - t
    if mode == "gemm":
        a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
        t = time.perf_counter()
        (a @ a).sum().item()
        out["first_bf16_gemm_s"] = time.perf_counter() - t
    if mode == "flash":
        q = torch.randn(1, 2048, 16, 128, device="cuda",
                        dtype=torch.bfloat16)
        k = torch.randn(1, 2048, 8, 128, device="cuda",
                        dtype=torch.bfloat16)
        t = time.perf_counter()
        flash_attention(q, k, k, causal=True).float().sum().item()
        out["first_flash_s"] = time.perf_counter() - t
    cfg = replace(llama.PRESETS["1b"], attention_impl="flash", remat=True,
                  remat_policy="full", loss_chunk=512, n_layers=4)
    params = train_step.init_sharded_params(
        lambda seed: llama.init_params(cfg, device="cuda",
                                       dtype=torch.float32, seed=seed),
        llama.param_axes(cfg), key=0)
    opt = adamw(3e-4, weight_decay=0.1)
    state = train_step.init_optimizer_state(opt, params)
    step = train_step.build_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg), opt, accum_steps=2)
    g = torch.Generator(device="cuda").manual_seed(0)
    data = {"tokens": torch.randint(0, cfg.vocab_size, (8, 2049),
                                    generator=g, device="cuda")}
    sync()
    prof = None
    if mode == "prof":
        from torch.profiler import ProfilerActivity, profile
        prof = profile(activities=[ProfilerActivity.CPU])
        prof.__enter__()
    for i in range(3):
        t = time.perf_counter()
        params, state, m = step(params, state, data)
        float(m["loss"])
        sync()
        out[f"step{i + 1}_s"] = time.perf_counter() - t
        if prof is not None:
            prof.__exit__(None, None, None)
            rows = sorted(prof.key_averages(),
                          key=lambda e: -e.cpu_time_total)[:10]
            out["step1_top_host_ms"] = [
                (e.key, e.cpu_time_total / 1e3, e.count) for e in rows]
            prof = None
    return out


def main() -> int:
    if sys.argv[1:2] == ["--child"]:
        print("FIRST_STEP " + json.dumps(child(sys.argv[2])), flush=True)
        return 0
    from ray_tpu_torch.ops import cuda_build

    cuda_build.build(["flash_fwd", "flash_bwd", "delta", "splash"])
    for mode in MODES:
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.tools.first_step",
             "--child", mode], capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t
        lines = [x for x in proc.stdout.splitlines()
                 if x.startswith("FIRST_STEP ")]
        rec = (json.loads(lines[0][len("FIRST_STEP "):]) if lines else
               {"mode": mode, "rc": proc.returncode,
                "error": proc.stderr[-2000:]})
        rec["wall_s"] = wall
        print(json.dumps(rec), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
