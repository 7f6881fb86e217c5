"""Where a ``TorchTrainer`` worker's time goes on one card, beside the same
step in the calling process.

    python -m ray_tpu_torch.tools.train_runtime_profile [STEPS]

The 1B training configuration ``chip_smoke.py`` drives (``PRESETS["1b"]``
at full width and depth, fp32 masters from seed 0, flash attention, full
remat, ``loss_chunk=512``, AdamW, two microbatches of 4 x 2048 tokens) in
three places: this process, a ``TorchTrainer`` worker without a process
group, and one with a one-rank NCCL group (``TorchConfig(distributed=
True)``). Each place times its first step (a fresh process's, with no
profiler running: the profiler's start would pay part of its one-time
cost), ``STEPS`` more (default 5), and traces two with ``torch.profiler``
for the card's busy and idle share.
Then the checkpoint save's parts at the train runtime's size (params and
AdamW's two moments in fp32): the copy of every leaf to the host, one
``torch.save`` of them with its CRC32 on and off, and a raw write of the
same bytes. Prints one JSON line per place and one for the save, beside
the card's name and power limit. Needs one CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from dataclasses import replace

import torch


def _config():
    from ray_tpu_torch.models import llama

    return replace(llama.PRESETS["1b"], attention_impl="flash", remat=True,
                   remat_policy="full", loss_chunk=512)


def profile_steps(config: dict) -> dict:
    """The first step, ``config["steps"]`` timed steps and two traced
    ones, in this process."""
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.optim import adamw
    from ray_tpu_torch.parallel import train_step
    from ray_tpu_torch.tools.train_profile import _device_us

    cfg = _config()
    t0 = time.perf_counter()
    params = llama.init_params(cfg, device="cuda", dtype=torch.float32,
                               seed=0)
    opt = adamw(3e-4, weight_decay=0.1)
    state = train_step.init_optimizer_state(opt, params)
    step = train_step.build_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg), opt, accum_steps=2)
    g = torch.Generator(device="cuda").manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (8, 2049),
                                     generator=g, device="cuda")}
    torch.cuda.synchronize()
    out = {"pid": os.getpid(), "process_group": (
        dist.get_backend() if dist.is_initialized() else None),
        "init_s": time.perf_counter() - t0}
    times = []
    for _ in range(config["steps"] + 1):
        t = time.perf_counter()
        params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    out["first_step_s"], out["step_s"] = times[0], times[1:]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(2):
            params, state, m = step(params, state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    busy_ms = sum(_device_us(e) / 1e3 for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    out.update({"traced_step_ms": wall_ms / 2,
                "device_busy_ms_per_step": busy_ms / 2,
                "device_idle_share": max(0.0, 1.0 - busy_ms / wall_ms),
                "loss": float(m["loss"])})
    return out


def _worker_loop(config):
    from ray_tpu_torch import train

    train.report(profile_steps(config))


def in_workers(steps: int) -> list:
    """``profile_steps`` in a GPU-leased ``TorchTrainer`` worker, without
    and with a one-rank NCCL group."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.train import ScalingConfig, TorchTrainer
    from ray_tpu_torch.train.torch_backend import TorchConfig

    rt.init()
    try:
        out = []
        for distributed in (False, True):
            result = TorchTrainer(
                _worker_loop, train_loop_config={"steps": steps},
                scaling_config=ScalingConfig(
                    num_workers=1, use_gpu=True, torch_config=TorchConfig(
                        distributed=distributed))).fit()
            if result.error is not None:
                raise RuntimeError(result.error)
            out.append(result.metrics)
        return out
    finally:
        rt.shutdown()


def save_parts() -> dict:
    """The checkpoint save's parts at 3 x the 1B params in fp32."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.optim import tree_leaves

    params = llama.init_params(_config(), device="cuda",
                               dtype=torch.float32, seed=0)
    leaves = tree_leaves(params) * 3
    nbytes = sum(t.numel() * t.element_size() for t in leaves)
    torch.cuda.synchronize()
    t = time.perf_counter()
    host = [x.cpu() for x in leaves]
    out = {"bytes": nbytes, "host_copy_s": time.perf_counter() - t}
    del params, leaves
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "tree.pt")
        for name, crc in (("torch_save_s", True),
                          ("torch_save_no_crc32_s", False)):
            torch.serialization.set_crc32_options(crc)
            t = time.perf_counter()
            torch.save(host, path)
            out[name] = time.perf_counter() - t
            os.remove(path)
        torch.serialization.set_crc32_options(True)
        t = time.perf_counter()
        with open(path, "wb") as f:
            for x in host:
                f.write(memoryview(x.numpy()).cast("B"))
        out["raw_write_s"] = time.perf_counter() - t
    out.update({f"{k[:-2]}_gb_s": nbytes / v / 1e9
                for k, v in list(out.items()) if k.endswith("_s")})
    return out


def main(steps: int = 5) -> int:
    if not torch.cuda.is_available():
        print("train_runtime_profile: no CUDA device is available",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30).stdout.strip()
    rows = [{"where": "this process", **profile_steps({"steps": steps})}]
    torch.cuda.empty_cache()
    rows += [{"where": "worker", **r} for r in in_workers(steps)]
    rows.append({"where": "checkpoint save", **save_parts()})
    for row in rows:
        print(json.dumps({**row, "device": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(*(int(a) for a in sys.argv[1:2])))
