"""Drive the PyTorch/CUDA port's splash, serving (a decode mesh among
them), training (Llama and ViT) and mesh paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (``{"phase": ..., "ok": ...}``):

1. env: torch, CUDA and nvcc versions, and the card (nvidia-smi).
2. build: every kernel of the path from ``ray_tpu_torch/ops/csrc``, one
   nvcc per source, all started together.
3. kernels: each flash kernel against its plain PyTorch version on the
   card at the main paths' shapes and at edge cases (the forward at the
   7B prefill and 1B training shapes and at the edges of its 128 x 128
   tiles, each case naming the kernel the C entry counted itself
   launching, which must be ``wgmma`` for bf16 and ``mma_sync_f32`` for
   float32; the two backward kernels at the 1B training shape and at
   the edges of their tiles, each case naming the kernels the C entries
   counted, ``dkv_wgmma+dq_wgmma`` for bf16 and the ``mma_sync_f32`` pair
   for float32), then timed with CUDA events beside the plain version,
   the PyTorch library call that computes the same function, and the
   card's bound for the work (the forward at both shapes, launch-only and
   through its wrapper, with the wrapper's host time a call; the backward
   at the 1B shape with the delta pre-pass, the unit delta + dK/dV + dQ,
   SDPA's backward on each backend that takes it, and the host time a
   call); then the delta pre-pass kernel (``delta.cu``) against its plain
   version on the shapes and layouts both backward paths hand it (the 1B
   training and splash shapes, S=129, D=64, D=80, float32, a (B, H, S, D)
   view), timed at the 1B and splash shapes beside its bound.
4. splash: ``splash_attention`` forward and backward at the 1B preset's
   attention width (16 q heads on 8 kv heads, head_dim 128), B=1,
   S=8192, bf16, default 256 blocks, on a GQA-aligned head stack (heads
   0-7 ``LocalMask(1024)``, 8-11 ``ChunkedMask(2048)``, 12-13
   ``CausalMask``, 14-15 ``FullMask``): four head groups, so exactly one
   forward, one dK/dV and one dQ launch over all groups (each on its
   wgmma kernel, by the C entries' own counts) and one delta launch,
   counted between a reset right before and a read right after. Out and
   gradients against the plain version (one kv head at a time) and, on
   the local, causal and full heads, against the flash kernels; twelve
   edge cases
   (float32, D=64, D=80 padded, ragged S=100, 129 and 255, rows that see
   nothing, Sq != Sk, GQA 1, 2 and 4, B=2, eight alternating head groups),
   each with the kernels it launched; then each kernel timed launch-only
   beside the plain version, SDPA with the dense boolean mask and the
   bound over the call's 297,824,256 live pairs (dQ also with its rate),
   the host time a call (C entries and wrappers, beside the per-group dQ
   design's),
   and on each head group alone beside the flash kernel on the same
   heads.
5. serve: Llama-2-7B (``PRESETS["7b"]``, full width and depth, random
   weights from seed 0, ``attention_impl="flash"``) behind
   ``LlamaDecodeDeployment`` answers six requests from several threads,
   one of them a prefix-cache hit. Launch counters are zeroed right before
   and read right after; every kernel of the path must have run. Greedy
   outputs are held against solo runs under the margin rule.
6. serve_paged: a fresh deployment of the same model and weights with a
   paged KV pool (``kv_page_tokens=64``, ``kv_pool_pages=64``: 4096
   tokens of KV for 8 slots of 2048), ``prefill_chunk_tokens=512`` and
   the device sampler answers eight requests sent before the first can
   finish (1100 tokens, a sharer of its first 1061 plus 200 sent after
   its first token, 1500, 900, 800, 700 sampled at temperature 0.8, 300
   and 20; every prompt over 512 tokens prefills in chunks, the 1500 one
   in three). It must preempt at least once, run at
   least three prefill chunks, hit the prefix cache, return every page
   (free or pinned by the prefix index) and launch the flash forward 32
   times per full prefill wave, all on wgmma. Greedy streams are held
   against solo contiguous runs under the margin rule, and the paged
   paths' logit drift against the contiguous ones must stay under it.
7. serve_spec: a fresh speculative deployment of the same model and
   weights with the 1B preset as its draft (random weights from seed 1),
   ``spec_k=4``, 8 slots of 2048 tokens on 128 pages of 64, a draft pool
   of 48 pages (3072 tokens, too few to seat every prompt), the device
   sampler and warmup. Before any request the warmup's step keys must be
   marked and both pools idle. Seven requests sent at once: greedy
   prompts of 20, 300, 700, 900, 1100 and 1500 tokens with 32 new tokens
   each, and 400 tokens at temperature 0.8 with 16 (rounds fall back to
   plain steps while it is active). It must run spec rounds, demote or
   evict a draft seat, resync a lagging draft, return every page of both
   pools and launch the flash forward 32 times per target full prefill
   wave, all on wgmma; the timeline must hold draft and verify phases.
   Greedy streams are held against solo runs under the margin rule. Then
   one slot's verify logits against k + 1 decode steps (drift under the
   margin tolerance), and a draft equal to the target (4 slots, four of
   the greedy prompts) against a plain paged engine: accept rate at
   least 0.5, at most half the plain engine's steps in rounds, streams
   under the margin rule.
8. serve_disagg: two deployments of the same model, prefill and decode,
   seven requests through the handoff (prefill, capture, lease, adopt).
9. serve_mesh: the serve_paged geometry and requests served by one
   ``DecodeEngine`` replica over a (1, 1) decode mesh at world size 1
   (one NCCL process group of one rank, in process) beside the mesh-less
   engine on the same weights from seed 0, both driven through
   ``step()`` on one schedule (seven requests before the first step, the
   prefix sharer after the source's first token) so both see the same
   waves. Every stream must equal the mesh-less engine's token for
   token, the waves, chunks and steps must be the same, and each run
   must launch the flash forward 32 times per full prefill wave, all on
   wgmma. Prints each run's mean and decode step time, tokens/s, TTFT
   and ``slo_summary``, and the lockstep's control messages.
10. train: the 1B Llama (``PRESETS["1b"]``, full width and depth, fp32
   masters from seed 0, ``attention_impl="flash"``, full remat,
   ``loss_chunk=512``) takes four AdamW steps through ``build_train_step``
   with two microbatches of 4 x 2048 tokens. Launch counters are zeroed
   before each step and read after it; each step must launch each
   backward kernel and the delta pre-pass once per layer and microbatch
   and the forward twice (the remat recompute). Losses must be finite
   and falling. A 2-layer model of the same width then holds the flash
   gradients against the plain-attention ones.
11. vit: ViT-B/16 (``vit.PRESETS["vit_b16"]``, full width and depth, fp32
   masters from seed 0, bf16 compute, full remat) takes six AdamW(3e-4,
   weight decay 0.1) steps through ``build_train_step`` at batch 256, fed
   by ``device_prefetch(prefetch=2)`` from seeded numpy batches of float32
   NHWC images and int64 labels (made before the loop); the first step is
   the warm-up. Then six steps on the same batches placed on the card
   beforehand (the yardstick for whether the copy is hidden). It prints
   step time (host clock after a sync), images/s, MFU from
   ``flops_per_image``, peak memory, the consumer's wait per step on the
   prefetch queue and the copies' rate. Checks: finite losses and params,
   the params moved, each device batch's checksum equals its host
   batch's, the host buffers were pinned and the copies ran on a side
   stream, the port on the card equals the port on the CPU at the debug
   size in float32 (random head), ``pad_tokens_to=256`` logits equal the
   unpadded ones at B=4, and none of the seven hand-written kernels
   launched (ViT attention is the plain path, as in the JAX package).
12. mesh: the mesh plane at world size 1: one NCCL process group of one
   rank, rendezvoused in process (``parallel.mesh.init_distributed``).
   The train phase's 1B setup (2 steps of 2 microbatches of 4 x 2048)
   mesh-less, then through ``build_train_step`` on
   ``MeshSpec(fsdp=-1).build()`` (DTensor params, state and batch) and
   through ``build_zero1_train_step``, from the same weights and tokens:
   losses and gradient norms within ``MESH_REL_TOL`` of the mesh-less
   step's, exact launches a step, each variant's step time, tokens/s,
   peak memory and state bytes. ``ring_attention(impl="flash")`` forward
   and backward and ``ulysses_attention(impl="flash")`` on the 1-rank
   mesh at the 1B attention width (B=1, S=8192, 16 q on 8 kv heads,
   D=128, bf16, causal), and the 1B width with 8 experts (top-2,
   capacity 1.25) cut to ``MOE_LAYERS`` layers trained 3 steps on
   1 x 2048 tokens on an ``expert`` mesh of one (finite loss and aux,
   the loss falls). Counters are zeroed before the mesh, ZeRO-1, ring,
   Ulysses and MoE runs and read after them: the exact launches, all on
   wgmma. Then the comparisons, against the plain flash forward and
   backward on the ring's inputs: the path's ring output and gradients,
   Ulysses' output, the 1-rank ring run again, and a loopback ring of 4
   virtual shards of 2048 (the package's ``ring_flash_attention_local``
   for each virtual rank, K/V rotated by indexing through its ``ring``
   argument), which is also held against one full ``flash_attention``
   call; out and gradients within ``RING_BF16_TOL``. The loopback
   launches 10 forwards and 10 of each backward kernel (4 diagonal and 6
   visible hops; the 6 dead hops launch nothing), and each is timed
   beside the full call. Its hops' shapes (B=1, 2048, 16 on 8 heads,
   full and causal, with an lse cotangent) are kernel cases too.

Serve, serve_paged, serve_spec and train also read the forward's C
entry's own launch count of each of its kernels over the same window:
every forward launch there must have taken the wgmma kernel; train reads
the backward's entries the same way, and every backward launch must have
taken a wgmma kernel.

Each main path (splash, serve, serve_paged, serve_spec, serve_disagg,
serve_mesh, train, mesh) must have launched each of its kernels at least
once. Then a ``{"kernels": [...]}`` line
with all seven kernels (the six attention kernels with their main-path
launches by kernel, and each with its ptxas lines: registers, shared
memory and spills of each instantiation), the nvidia-smi
name/power-limit line, and, last, ``{"ok": true, "device": {...}}``.
Any failed phase exits 1 without that last line; so does a machine
without a card.
"""

from __future__ import annotations

import gc
import json
import math
import re
import subprocess
import sys
import threading
import time
import traceback
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
PEAK_F32_FLOPS = 67e12     # H100 SXM float32 outside the tensor cores
# Greedy-agreement margin for bf16 7B logits: tokens are compared while
# the solo run's top-2 logit margin exceeds it. The serve phase measures
# how far batch shape and the prefix-hit path move logits and fails if
# any drift reaches it.
MARGIN_TOL = 0.1
REQUEST_TIMEOUT_S = 300.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ env


def phase_env() -> dict:
    from ray_tpu_torch.ops import cuda_build

    nvcc = subprocess.run([cuda_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60)
    return {"python": sys.version.split()[0], "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "nvcc": nvcc.stdout.strip().splitlines()[-1],
            "device": torch.cuda.get_device_name(0),
            "device_count": torch.cuda.device_count(),
            "nvidia_smi": smi_line()}


# ---------------------------------------------------------------- build


KERNELS = {
    # name -> what the kernels line needs besides measurements
    "flash_fwd": {
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:109",
    },
    "flash_bwd_dkv": {
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:223",
    },
    "flash_bwd_dq": {
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/flash_bwd.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:281",
    },
    "splash_fwd": {
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/splash.cu",
        "replaces": "ray_tpu/ops/splash_attention.py:204",
    },
    "splash_bwd_dq": {
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/splash.cu",
        "replaces": "ray_tpu/ops/splash_attention.py:311",
    },
    "splash_bwd_dkv": {
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/splash.cu",
        "replaces": "ray_tpu/ops/splash_attention.py:350",
    },
    # Not a TPU kernel: the JAX package leaves this expression to XLA.
    "attention_delta": {
        "route": "cuda",
        "source": "ray_tpu_torch/ops/csrc/delta.cu",
        "replaces": "ray_tpu/ops/flash_attention.py:343",
    },
}
# The kernels each main path must launch at least once.
PATH_KERNELS = {
    "serve": ["flash_fwd"],
    "serve_paged": ["flash_fwd"],
    "serve_spec": ["flash_fwd"],
    "serve_disagg": ["flash_fwd"],
    "serve_mesh": ["flash_fwd"],
    "train": ["flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
              "attention_delta"],
    "splash": ["splash_fwd", "splash_bwd_dq", "splash_bwd_dkv",
               "attention_delta"],
    "mesh": ["flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
             "attention_delta"],
}
# The sources to build: one library (and one nvcc) per .cu file.
SOURCES = sorted({Path(k["source"]).stem for k in KERNELS.values()})


def _counters() -> dict:
    """Kernel name -> (wrapper, attribute) of its launch counter."""
    from ray_tpu_torch.ops.flash_attention import (attention_delta,
                                                   flash_attention,
                                                   flash_backward)
    from ray_tpu_torch.ops.splash_attention import (splash_attention,
                                                    splash_backward)

    return {"flash_fwd": (flash_attention, "launches"),
            "flash_bwd_dkv": (flash_backward, "dkv_launches"),
            "flash_bwd_dq": (flash_backward, "dq_launches"),
            "splash_fwd": (splash_attention, "launches"),
            "splash_bwd_dq": (splash_backward, "dq_launches"),
            "splash_bwd_dkv": (splash_backward, "dkv_launches"),
            "attention_delta": (attention_delta, "launches")}


def launch_counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in _counters().items()}


def reset_counts() -> None:
    for fn, attr in _counters().values():
        setattr(fn, attr, 0)


def fwd_kernel_counts(device="cuda") -> dict:
    """Launches of each kernel behind ``flash_fwd.cu``'s entry, as the C
    entry counts them (none off the card)."""
    if torch.device(device).type != "cuda":
        return {}
    from ray_tpu_torch.ops.flash_attention import forward_kernel_launches

    return forward_kernel_launches()


def fwd_kernels_since(before: dict, device="cuda") -> dict:
    return {k: n - before.get(k, 0)
            for k, n in fwd_kernel_counts(device).items()}


def all_on_wgmma(by_kernel: dict, flash_launches: int, device) -> bool:
    """Every forward launch of a bf16 path took the wgmma kernel (off the
    card nothing launches)."""
    if torch.device(device).type != "cuda":
        return True
    return by_kernel == {"wgmma": flash_launches, "mma_sync_f32": 0}


def bwd_kernel_counts(device="cuda") -> dict:
    """Launches of each kernel behind ``flash_bwd.cu``'s two entries, as
    the C entries count them (none off the card)."""
    if torch.device(device).type != "cuda":
        return {}
    from ray_tpu_torch.ops.flash_attention import backward_kernel_launches

    return backward_kernel_launches()


def bwd_kernels_since(before: dict, device="cuda") -> dict:
    return {k: n - before.get(k, 0)
            for k, n in bwd_kernel_counts(device).items()}


def all_bwd_on_wgmma(by_kernel: dict, dkv_launches: int, dq_launches: int,
                     device) -> bool:
    """Every backward launch of a bf16 path took a wgmma kernel (off the
    card nothing launches)."""
    if torch.device(device).type != "cuda":
        return True
    return by_kernel == {"dkv_wgmma": dkv_launches, "dq_wgmma": dq_launches,
                         "dkv_mma_sync_f32": 0, "dq_mma_sync_f32": 0}


def _route(by_kernel: dict) -> str:
    """The kernels a window launched, joined by "+"."""
    return "+".join(k for k, n in by_kernel.items() if n)


def cuda_build_rows(cuda_build, name: str) -> list:
    """One line per kernel instantiation in the build log of ``name``: its
    name, registers and shared memory, and spills."""
    log = cuda_build.build_log(name).splitlines()
    rows = []
    for i, line in enumerate(log):
        if "Function properties for" in line:
            fn = line.split("for")[-1].strip()
            # The kernel's name and template arguments, past the mangled
            # anonymous namespace (which names the file).
            m = re.search(r"(?:(?:splash|flash)_(?:fwd|bwd_dq|bwd_dkv)"
                          r"(?:_wgmma|_f32)?|attention_delta)_kernel\w*", fn)
            fn = m.group(0) if m else fn
            spill = log[i + 1].strip() if i + 1 < len(log) else ""
            used = next((x.strip() for x in log[i + 2:i + 4]
                         if "registers" in x), "")
            rows.append(f"{fn}: {used}; {spill}")
    return rows


def phase_build() -> dict:
    from ray_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    libs = cuda_build.build(SOURCES)
    out = {"seconds": round(time.perf_counter() - t0, 3),
           "libraries": [p.name for p in libs]}
    for name in SOURCES:
        out[f"{name}_ptxas"] = cuda_build_rows(cuda_build, name)
    return out


# -------------------------------------------------------------- kernels


def _inputs(g, b, sq, sk, h, hkv, d, dtype, dev="cuda"):
    q = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
    k = torch.randn(b, sk, hkv, d, generator=g, device=dev).to(dtype)
    v = torch.randn(b, sk, hkv, d, generator=g, device=dev).to(dtype)
    return q, k, v


def _off_grid_segments():
    """(2, 512) segment ids whose boundaries fall off every tile grid."""
    seg = torch.zeros(2, 512, dtype=torch.int32, device="cuda")
    seg[:, 77:] = 1
    seg[:, 200:] = 2
    seg[0, 450:] = 3
    seg[1, 333:] = 4
    return seg


def _bhsd(x):
    """(B, S, H, D) views of a (B, H, S, D) tensor, as
    ``flash_attention_stats`` passes them."""
    return x.transpose(1, 2).contiguous().transpose(1, 2)


def _flash_cases(g):
    """(name, tensors, kwargs) at the slice's prefill and training shapes
    and the edges (of the bf16 kernel's 128-row q tiles and 128-key kv
    tiles among them)."""
    bf = torch.bfloat16
    seg = torch.zeros(2, 1024, dtype=torch.int32, device="cuda")
    seg[:, 300:] = 1
    seg[1, 700:] = 2
    dead_q = torch.zeros(1, 256, dtype=torch.int32, device="cuda")
    dead_q[:, 128:] = 5          # segment 5 has no keys: dead rows
    dead_k = torch.zeros(1, 256, dtype=torch.int32, device="cuda")
    off_grid = _off_grid_segments()
    return [
        ("prefill_7b_b4_s2048", _inputs(g, 4, 2048, 2048, 32, 32, 128, bf),
         dict(causal=True)),
        ("train_1b_b4_s2048_gqa16_8",
         _inputs(g, 4, 2048, 2048, 16, 8, 128, bf), dict(causal=True)),
        ("gqa_h32_kv8", _inputs(g, 1, 2048, 2048, 32, 8, 128, bf),
         dict(causal=True)),
        ("d64", _inputs(g, 2, 512, 512, 16, 16, 64, bf), dict(causal=True)),
        ("window256", _inputs(g, 1, 2048, 2048, 8, 8, 128, bf),
         dict(causal=True, window=256)),
        ("q_offset512", _inputs(g, 2, 512, 1024, 8, 8, 128, bf),
         dict(causal=True, q_offset=512)),
        ("segment_ids", _inputs(g, 2, 1024, 1024, 8, 8, 128, bf),
         dict(causal=True, seg_q=seg, seg_k=seg)),
        ("non_causal", _inputs(g, 2, 1024, 1024, 8, 8, 128, bf),
         dict(causal=False)),
        ("fully_masked_rows", _inputs(g, 1, 256, 256, 4, 4, 128, bf),
         dict(causal=False, seg_q=dead_q, seg_k=dead_k)),
        ("s384", _inputs(g, 2, 384, 384, 8, 8, 128, bf), dict(causal=True)),
        ("s400_ragged_d80", _inputs(g, 2, 400, 400, 8, 4, 80, bf),
         dict(causal=True)),
        ("s129_ragged", _inputs(g, 2, 129, 129, 4, 4, 128, bf),
         dict(causal=True)),
        ("s255_ragged", _inputs(g, 2, 255, 255, 4, 2, 128, bf),
         dict(causal=True)),
        ("sq200_sk328_q_offset128", _inputs(g, 2, 200, 328, 4, 4, 128, bf),
         dict(causal=True, q_offset=128)),
        ("window100", _inputs(g, 1, 1024, 1024, 4, 4, 128, bf),
         dict(causal=True, window=100)),
        ("window100_non_causal", _inputs(g, 1, 512, 512, 4, 4, 128, bf),
         dict(causal=False, window=100)),
        ("segments_off_grid", _inputs(g, 2, 512, 512, 4, 2, 128, bf),
         dict(causal=True, seg_q=off_grid, seg_k=off_grid)),
        ("gqa32_8_s300", _inputs(g, 1, 300, 300, 32, 8, 128, bf),
         dict(causal=True)),
        ("d64_s200", _inputs(g, 2, 200, 200, 4, 4, 64, bf),
         dict(causal=True)),
        ("bhsd_views", tuple(_bhsd(x) for x in _inputs(
            g, 2, 256, 256, 4, 2, 128, bf)), dict(causal=True)),
        ("f32_s320", _inputs(g, 1, 320, 320, 4, 4, 128, torch.float32),
         dict(causal=True)),
        # A visible off-diagonal hop of the mesh phase's loopback ring.
        ("ring_hop_full_b1_s2048_gqa16_8",
         _inputs(g, 1, 2048, 2048, 16, 8, 128, bf), dict(causal=False)),
    ]


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
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


def _live_pairs(sq, sk, q_offset=0, causal=True) -> int:
    """(q, k) pairs per (batch, head) that the causal mask leaves live."""
    if not causal:
        return sq * sk
    return int(np.clip(q_offset + np.arange(sq) + 1, 0, sk).sum())


def _flash_bound(b, sq, sk, h, hkv, d, q_offset=0, causal=True,
                 itemsize=2, head_pairs=None):
    """Least time for the forward on this card: each input read once and
    each output written once over HBM bandwidth, against the QK^T and PV
    flops of the (q, k) pairs this call's masks leave live (``head_pairs``,
    summed over the heads; by default the causal mask's on every head)
    over the bf16 tensor-core peak. Returns (ms, "bytes" | "operations")."""
    if head_pairs is None:
        head_pairs = h * _live_pairs(sq, sk, q_offset, causal)
    flops = 4.0 * b * d * head_pairs
    nbytes = (itemsize * (2 * b * sq * h * d + 2 * b * sk * hkv * d)
              + 4 * b * h * sq)
    t_ops = flops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _flash_bwd_bounds(b, sq, sk, h, hkv, d, causal=True, itemsize=2,
                      head_pairs=None, prefix="flash"):
    """Least time for each backward kernel on this card: the larger of its
    bytes (each input read once, each output written once) over HBM
    bandwidth and its matrix products over the live (q, k) pairs (as in
    ``_flash_bound``) over the bf16 tensor-core peak. dK/dV does 4 products
    (S, dP, dV, dK), dQ 3 (S, dP, dQ). Returns {kernel: (ms, "bytes" |
    "operations")}, the kernels named ``<prefix>_bwd_dkv`` and
    ``<prefix>_bwd_dq``."""
    if head_pairs is None:
        head_pairs = h * _live_pairs(sq, sk, causal=causal)
    q_bytes = itemsize * b * sq * h * d          # q, dO or dq
    kv_bytes = itemsize * b * sk * hkv * d       # k, v, dk or dv
    stats = 4 * b * h * sq                       # lse or delta (fp32)
    work = {
        f"{prefix}_bwd_dkv": (8.0 * b * d * head_pairs,
                              2 * q_bytes + 4 * kv_bytes + 2 * stats),
        f"{prefix}_bwd_dq": (6.0 * b * d * head_pairs,
                             3 * q_bytes + 2 * kv_bytes + 2 * stats),
    }
    out = {}
    for name, (flops, nbytes) in work.items():
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e3,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def _bwd_inputs(g, b, sq, sk, h, hkv, d, dtype, dev="cuda"):
    q, k, v = _inputs(g, b, sq, sk, h, hkv, d, dtype, dev)
    do = torch.randn(b, sq, h, d, generator=g, device=dev).to(dtype)
    return q, k, v, do


def _flash_bwd_cases(g):
    """(name, (q, k, v, dO), kwargs, with_dlse) at the training path's
    shape and the edges."""
    bf = torch.bfloat16
    seg = torch.zeros(2, 1024, dtype=torch.int32, device="cuda")
    seg[:, 300:] = 1
    seg[1, 700:] = 2
    dead_q = torch.zeros(1, 256, dtype=torch.int32, device="cuda")
    dead_q[:, 128:] = 5          # segment 5 has no keys: dead rows
    dead_k = torch.zeros(1, 256, dtype=torch.int32, device="cuda")
    off_grid = _off_grid_segments()
    return [
        ("train_1b_b4_s2048", _bwd_inputs(g, 4, 2048, 2048, 16, 8, 128, bf),
         dict(causal=True), False),
        ("gqa_h32_kv8", _bwd_inputs(g, 1, 1024, 1024, 32, 8, 128, bf),
         dict(causal=True), False),
        ("mha_h8", _bwd_inputs(g, 2, 1024, 1024, 8, 8, 128, bf),
         dict(causal=True), False),
        ("d64", _bwd_inputs(g, 2, 512, 512, 16, 8, 64, bf),
         dict(causal=True), False),
        ("d80_padded", _bwd_inputs(g, 2, 512, 512, 8, 4, 80, bf),
         dict(causal=True), False),
        ("window256", _bwd_inputs(g, 1, 2048, 2048, 8, 4, 128, bf),
         dict(causal=True, window=256), False),
        ("q_offset512", _bwd_inputs(g, 2, 512, 1024, 8, 8, 128, bf),
         dict(causal=True, q_offset=512), False),
        ("segment_ids", _bwd_inputs(g, 2, 1024, 1024, 8, 8, 128, bf),
         dict(causal=True, seg_q=seg, seg_k=seg), False),
        ("non_causal", _bwd_inputs(g, 2, 1024, 1024, 8, 4, 128, bf),
         dict(causal=False), False),
        ("fully_masked_rows", _bwd_inputs(g, 1, 256, 256, 4, 4, 128, bf),
         dict(causal=False, seg_q=dead_q, seg_k=dead_k), False),
        ("s400_ragged", _bwd_inputs(g, 2, 400, 400, 8, 4, 128, bf),
         dict(causal=True), False),
        ("lse_cotangent_stats", _bwd_inputs(g, 2, 512, 512, 8, 8, 128, bf),
         dict(causal=True), True),
        ("f32_s320", _bwd_inputs(g, 1, 320, 320, 4, 2, 128, torch.float32),
         dict(causal=True), False),
        # Edges of the bf16 kernels' tiles: 128-row dQ tiles, 64-key
        # dK/dV tiles and their 64-row q tiles.
        ("s129_ragged", _bwd_inputs(g, 2, 129, 129, 4, 4, 128, bf),
         dict(causal=True), False),
        ("s255_ragged", _bwd_inputs(g, 2, 255, 255, 4, 2, 128, bf),
         dict(causal=True), False),
        ("sq200_sk328_q_offset128",
         _bwd_inputs(g, 2, 200, 328, 4, 4, 128, bf),
         dict(causal=True, q_offset=128), False),
        ("window100", _bwd_inputs(g, 1, 1024, 1024, 4, 4, 128, bf),
         dict(causal=True, window=100), False),
        ("segments_off_grid", _bwd_inputs(g, 2, 512, 512, 4, 2, 128, bf),
         dict(causal=True, seg_q=off_grid, seg_k=off_grid), False),
        ("gqa32_8_s300", _bwd_inputs(g, 1, 300, 300, 32, 8, 128, bf),
         dict(causal=True), False),
        ("d64_s200", _bwd_inputs(g, 2, 200, 200, 4, 4, 64, bf),
         dict(causal=True), False),
        ("lse_cotangent_gqa8_2", _bwd_inputs(g, 2, 512, 512, 8, 2, 128, bf),
         dict(causal=True), True),
        ("bhsd_views", tuple(_bhsd(x) for x in _bwd_inputs(
            g, 2, 256, 256, 4, 2, 128, bf)), dict(causal=True), False),
        # The mesh phase's loopback ring hops: off-diagonal (full) and
        # diagonal (causal), each with the lse cotangent of the merge.
        ("ring_hop_full_dlse_b1_s2048_gqa16_8",
         _bwd_inputs(g, 1, 2048, 2048, 16, 8, 128, bf),
         dict(causal=False), True),
        ("ring_hop_diag_dlse_b1_s2048_gqa16_8",
         _bwd_inputs(g, 1, 2048, 2048, 16, 8, 128, bf),
         dict(causal=True), True),
    ]


def _stats_grads(q, k, v, do, dlse, causal):
    """Gradients through ``flash_attention_stats`` ((B, H, S, D) layout)
    under cotangents for both outputs: the path ring attention uses."""
    from ray_tpu_torch.ops import flash_attention as fa

    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    out, lse = fa.flash_attention_stats(qt, kt, vt, q.shape[-1] ** -0.5,
                                        causal, None, 0, 64, 64)
    dq, dk, dv = torch.autograd.grad((out, lse), (qt, kt, vt),
                                     (do.transpose(1, 2), dlse))
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def _check_flash_bwd(g) -> list:
    """Each backward case: the kernels' dq, dk, dv against the plain
    version on the same (q, k, v, out, lse, dO). Errors are max |error|
    relative to the plain gradient's max |value|: at most 2e-2 in bf16
    (P and dS round to bf16 after sums in another order), 1e-4 in float32
    (bf16 hi + lo split operands, ~2^-16)."""
    from ray_tpu_torch.ops import flash_attention as fa

    results = []
    for name, (q, k, v, do), kw, with_dlse in _flash_bwd_cases(g):
        out, lse = fa.flash_forward(q, k, v, **kw)
        dlse = None
        before = bwd_kernel_counts()
        if with_dlse:
            dlse = torch.randn(lse.shape, generator=g, device="cuda")
            got = _stats_grads(q, k, v, do, dlse, kw["causal"])
        else:
            got = fa.flash_backward(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        # The kernels the C entries launched, read from their own counts.
        route = _route(bwd_kernels_since(before))
        want = fa.flash_backward_reference(q, k, v, out, lse, do, dlse, **kw)
        tol = 2e-2 if q.dtype == torch.bfloat16 else 1e-4
        errs, ok = {}, True
        for gname, a, r in zip(("dq", "dk", "dv"), got, want):
            scale = float(r.float().abs().max())
            err = float((a.float() - r.float()).abs().max())
            errs[gname] = err / max(scale, 1e-30)
            ok = ok and a.dtype == r.dtype and a.shape == r.shape and (
                bool(torch.isfinite(a.float()).all())
                and err <= tol * scale)
        ok = ok and route == ("dkv_wgmma+dq_wgmma" if q.dtype == torch.bfloat16
                              else "dkv_mma_sync_f32+dq_mma_sync_f32")
        if name == "fully_masked_rows":
            ok = ok and not got[0][:, 128:].any()
        results.append({"case": f"bwd_{name}", "route": route, "ok": ok,
                        "rel_max_abs_err": errs, "tol": tol})
        del q, k, v, do, out, lse, got, want
    torch.cuda.empty_cache()
    return results


def _time_flash_bwd(g, record: dict) -> dict:
    """Time each backward kernel at the 1B training shape beside the plain
    version and the library yardstick (the backward of PyTorch's SDPA,
    timed only, on each backend that takes the call, the fastest used),
    with the delta pre-pass and the unit (delta + dK/dV + dQ, what SDPA's
    backward computes), the host time a call, and each kernel's bound."""
    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.tools.flash_ab import sdpa_backward_ms

    b, s, h, hkv, d = 4, 2048, 16, 8, 128
    q, k, v, do = _bwd_inputs(g, b, s, s, h, hkv, d, torch.bfloat16)
    scale = d ** -0.5
    out, lse = fa.flash_forward(q, k, v, causal=True)
    delta = fa.attention_delta(out, do)
    want = fa.flash_backward_reference(q, k, v, out, lse, do, causal=True)
    got = fa.flash_backward(q, k, v, out, lse, do, causal=True)
    errs = [float((a.float() - r.float()).abs().max())
            for a, r in zip(got, want)]
    del got, want

    # Timed through the launcher alone: validation and allocation happen
    # once, so the wrapper's host work does not enter the kernel time.
    launch, _ = fa._backward_launcher(q, k, v, do, lse, delta, None, None,
                                      None, scale, True, None, 0)

    def pair():
        launch("dkv")
        launch("dq")

    ms = {"flash_bwd_dkv": _time_ms(lambda: launch("dkv"), iters=20),
          "flash_bwd_dq": _time_ms(lambda: launch("dq"), iters=20)}
    pair_ms = _time_ms(pair, iters=20)
    delta_ms = _time_ms(fa._delta_launcher(out, do)[0], iters=20)
    delta_plain_ms = _time_ms(lambda: fa.attention_delta_reference(out, do),
                              iters=20)
    plain_ms = _time_ms(lambda: fa.flash_backward_reference(
        q, k, v, out, lse, do, causal=True), iters=3, warmup=1)
    lib = sdpa_backward_ms(q, k, v, do)
    # Host time a backward call: the two C entries alone (seven and four
    # tensor maps encoded, two launches) and the whole wrapper (delta,
    # validation, allocation).
    launch_host_ms = _host_ms(pair)
    wrapper_host_ms = _host_ms(lambda: fa.flash_backward(
        q, k, v, out, lse, do, causal=True))
    bounds = _flash_bwd_bounds(b, s, s, h, hkv, d)
    max_err = {"flash_bwd_dkv": max(errs[1], errs[2]),
               "flash_bwd_dq": errs[0]}
    ptxas = cuda_build_rows(cuda_build, "flash_bwd")
    for name, kernel in (("flash_bwd_dkv", "flash_bwd_dkv_wgmma_kernel"),
                         ("flash_bwd_dq", "flash_bwd_dq_wgmma_kernel")):
        record[name] = {"max_abs_err": max_err[name], "ms": ms[name],
                        "plain_ms": plain_ms, "bound_ms": bounds[name][0],
                        "bound_by": bounds[name][1],
                        "library_ms": lib["sdpa_bwd_ms"],
                        "ptxas": [r for r in ptxas if r.startswith(kernel)]}
    del q, k, v, do, out, lse, delta, launch
    torch.cuda.empty_cache()
    return {"bwd_timing_shape": {"B": b, "S": s, "H": h, "Hkv": hkv,
                                 "D": d, "causal": True,
                                 "dtype": "bfloat16"},
            "bwd_pair_ms": pair_ms, "bwd_delta_ms": delta_ms,
            "bwd_delta_plain_ms": delta_plain_ms,
            "bwd_unit_ms": delta_ms + pair_ms,
            "bwd_launch_host_ms": launch_host_ms,
            "bwd_wrapper_host_ms": wrapper_host_ms,
            "bwd_library_is": f"SDPA backward ({lib['sdpa_backend']}, the "
                              "fastest backend that takes the call; dq, dk, "
                              "dv together)",
            "bwd_sdpa_ms_by_backend": lib["sdpa_bwd_ms_by_backend"],
            "bwd_plain_is": "flash_backward_reference (dq, dk, dv together)"}


def _delta_cases(g):
    """(name, (out, dO)) at the shapes and layouts the two backward paths
    hand the delta pre-pass, before D is padded: the 1B training and the
    splash shapes, a ragged S, D 64 and 80, float32, and the (B, S, H, D)
    view of a (B, H, S, D) tensor that ``flash_attention_stats`` passes."""
    def pair(b, s, h, d, dtype=torch.bfloat16):
        return tuple(torch.randn(b, s, h, d, generator=g, device="cuda")
                     .to(dtype) for _ in range(2))

    return [("train_1b_b4_s2048", pair(4, 2048, 16, 128)),
            ("splash_b1_s8192", pair(1, 8192, 16, 128)),
            ("s129", pair(2, 129, 4, 128)),
            ("d64", pair(2, 512, 16, 64)),
            ("d80_unpadded", pair(2, 512, 8, 80)),
            ("f32_s320", pair(1, 320, 4, 128, torch.float32)),
            ("bhsd_view", tuple(_bhsd(x) for x in pair(2, 256, 4, 128)))]


def _delta_bound(out):
    """Least time for the delta pre-pass on this card: O and dO read once
    and delta written once over HBM bandwidth, against its 2 fp32 flops an
    element over the fp32 peak outside the tensor cores."""
    b, s, h, _ = out.shape
    t_bytes = (2 * out.numel() * out.element_size() + 4 * b * h * s) \
        / PEAK_BYTES
    t_ops = 2.0 * out.numel() / PEAK_F32_FLOPS
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _check_delta(g, record) -> list:
    """Each delta case: ``delta.cu``'s kernel (one launch) against
    ``attention_delta_reference``, within 1e-5 of the largest |delta| (the
    same fp32 products summed in another order); at the 1B training and
    splash shapes also timed (launch only) beside the plain version and
    the bound. No single PyTorch call computes it (an fp32 sum of bf16
    products into (B, H, S)), so it has no library time."""
    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.ops import flash_attention as fa

    results = []
    for name, (out, do) in _delta_cases(g):
        before = fa.attention_delta.launches
        got = fa.attention_delta(out, do)
        torch.cuda.synchronize()
        launched = fa.attention_delta.launches - before
        want = fa.attention_delta_reference(out, do)
        err = float((got - want).abs().max())
        tol = 1e-5 * float(want.abs().max())
        res = {"case": f"delta_{name}",
               "ok": launched == 1 and got.shape == want.shape
               and got.is_contiguous() and err <= tol,
               "max_abs_err": err, "tol": tol}
        if name in ("train_1b_b4_s2048", "splash_b1_s8192"):
            launch, _ = fa._delta_launcher(out, do)
            res["ms"] = _time_ms(launch, iters=50)
            res["plain_ms"] = _time_ms(
                lambda: fa.attention_delta_reference(out, do), iters=20)
            res["bound_ms"], res["bound_by"] = _delta_bound(out)
        results.append(res)
        del out, do, got, want
    torch.cuda.empty_cache()
    train, splash = results[0], results[1]
    record["attention_delta"] = {
        **{k: train[k] for k in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by")},
        "library_ms": None,
        "at_splash": {k: splash[k] for k in ("ms", "plain_ms", "bound_ms",
                                             "max_abs_err")},
        "ptxas": cuda_build_rows(cuda_build, "delta")}
    return results


def _host_ms(fn, iters: int = 20) -> float:
    """Host time a call of ``fn``: ``iters`` calls enqueued, no sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize()
    return ms


def _time_flash_fwd(g, b, s, h, hkv, d, plain=True) -> dict:
    """The forward at one causal bf16 shape: the kernel timed through the
    launcher alone (the wrapper's host work per call can exceed the
    kernel's time), the full wrapper per call, the plain version, SDPA on
    the same call (``enable_gqa`` where hkv < h) and the card's bound."""
    from ray_tpu_torch.ops import flash_attention as fa

    q, k, v = _inputs(g, b, s, s, h, hkv, d, torch.bfloat16)
    launch, _ = fa._forward_launcher(q, k, v, None, None, d ** -0.5, True,
                                     None, 0)
    res = {"shape": {"B": b, "S": s, "H": h, "Hkv": hkv, "D": d,
                     "causal": True, "dtype": "bfloat16"},
           "ms": _time_ms(launch, iters=20),
           "wrapper_ms": _time_ms(
               lambda: fa.flash_forward(q, k, v, causal=True), iters=20)}
    # Host time a call: the C entry alone (three tensor maps encoded and
    # the launch) and the whole wrapper.
    res["launch_host_ms"] = _host_ms(launch)
    res["wrapper_host_ms"] = _host_ms(
        lambda: fa.flash_forward(q, k, v, causal=True))
    if plain:
        res["plain_ms"] = _time_ms(
            lambda: fa.flash_attention_reference(q, k, v, causal=True),
            iters=3, warmup=1)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    res["library_ms"] = _time_ms(
        lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=hkv != h), iters=20)
    res["bound_ms"], res["bound_by"] = _flash_bound(b, s, s, h, hkv, d)
    del q, k, v, qt, kt, vt, launch
    torch.cuda.empty_cache()
    return res


def phase_kernels(record: dict) -> dict:
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops import cuda_build
    from ray_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda").manual_seed(0)
    results = []
    errs = {}
    for name, (q, k, v), kw in _flash_cases(g):
        before = fwd_kernel_counts()
        out, lse = fa.flash_forward(q, k, v, **kw)
        torch.cuda.synchronize()
        # The kernel the C entry launched, read from its own counts.
        route = _route(fwd_kernels_since(before))
        ref, ref_lse = fa.flash_attention_reference(q, k, v, **kw)
        tol = 2e-2 if q.dtype == torch.bfloat16 else 1e-4
        err = float((out.float() - ref.float()).abs().max())
        lse_err = float((lse - ref_lse).abs().max())
        ok = (torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
              and torch.allclose(lse, ref_lse, rtol=1e-3, atol=1e-3)
              and bool(torch.isfinite(out.float()).all())
              and route == ("wgmma" if q.dtype == torch.bfloat16
                            else "mma_sync_f32"))
        if name == "fully_masked_rows":
            ok = ok and not out[:, 128:].any() and bool(
                (lse[:, :, 128:] == -1e30).all())
        results.append({"case": name, "route": route,
                        "ok": ok, "max_abs_err": err,
                        "lse_max_abs_err": lse_err, "tol": tol})
        errs[name] = err
        del out, lse, ref, ref_lse
    torch.cuda.empty_cache()

    # Through the model at a small size: flash vs plain attention logits
    # (fp32 debug preset; its head dim 16 pads to the kernel's 64).
    cfg = replace(llama.PRESETS["debug"], dtype=torch.float32)
    params = llama.init_params(cfg, device="cuda", seed=1)
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=g,
                         device="cuda")
    plain = llama.forward(params, toks, replace(cfg, attention_impl="xla"))
    before = fwd_kernel_counts()
    flash = llama.forward(params, toks, replace(cfg, attention_impl="flash"))
    by_kernel = fwd_kernels_since(before)
    model_err = float((plain - flash).abs().max())
    results.append({"case": "debug_model_logits_f32",
                    "route": _route(by_kernel),
                    "ok": model_err < 1e-3 and by_kernel["wgmma"] == 0
                    and by_kernel["mma_sync_f32"] > 0,
                    "max_abs_err": model_err, "tol": 1e-3})

    # Timing at the serving path's largest prefill shape (the kernels
    # line's numbers) and at the 1B training shape.
    prefill = _time_flash_fwd(g, 4, 2048, 32, 32, 128)
    train = _time_flash_fwd(g, 4, 2048, 16, 8, 128, plain=False)
    train["max_abs_err"] = errs["train_1b_b4_s2048_gqa16_8"]
    record["flash_fwd"] = {
        "max_abs_err": errs["prefill_7b_b4_s2048"],
        **{key: prefill[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
        "wrapper_ms": prefill["wrapper_ms"],
        "wrapper_host_ms": prefill["wrapper_host_ms"],
        "launch_host_ms": prefill["launch_host_ms"],
        "at_train_1b": {key: train[key] for key in (
            "shape", "ms", "wrapper_ms", "wrapper_host_ms", "launch_host_ms",
            "bound_ms", "bound_by", "library_ms", "max_abs_err")},
        "ptxas": cuda_build_rows(cuda_build, "flash_fwd")}

    results += _check_flash_bwd(g)
    bwd = _time_flash_bwd(g, record)
    results += _check_delta(g, record)
    ok = all(r["ok"] for r in results)
    return {"ok": ok, "cases": results,
            "timing_shape": prefill["shape"],
            **bwd,
            **{f"{name}_{key}": val for name in PATH_KERNELS["train"]
               for key, val in record[name].items()}}


# --------------------------------------------------------------- splash

# The splash path: splash attention forward and backward at the 1B
# preset's attention width (16 q heads on 8 kv heads, head_dim 128) on a
# GQA-aligned local / chunked / causal / global head stack. Live (q, k)
# pairs per head at S = 8192: local 7,864,832, chunked 8,392,704, causal
# 33,558,528, full 67,108,864; 297,824,256 for the call.
SPLASH_SHAPE = dict(b=1, s=8192, h=16, hkv=8, d=128)
SPLASH_PAIRS = 297_824_256
# Launches of each kernel a splash forward + backward call over the four
# head groups: each splash kernel once over all groups, after one delta.
SPLASH_LAUNCHES = {"splash_fwd": 1, "splash_bwd_dkv": 1, "splash_bwd_dq": 1,
                   "attention_delta": 1}
# The splash wrappers' host time a forward + backward call when dQ launched
# once per head group (six kernel-argument sets a call): 0.461 ms, read by
# this script on an NVIDIA H100 80GB HBM3 at 700 W. The phase prints this
# run's beside it.
SPLASH_WRAPPER_HOST_MS_PER_GROUP_DQ = 0.461


def _splash_masks():
    from ray_tpu_torch.ops import splash_attention as ss

    return ([ss.LocalMask(1024)] * 8 + [ss.ChunkedMask(2048)] * 4
            + [ss.CausalMask()] * 2 + [ss.FullMask()] * 2)


def _rel_err(got, want) -> float:
    """max |got - want| relative to max |want|."""
    scale = float(want.float().abs().max())
    return float((got.float() - want.float()).abs().max()) / max(scale, 1e-30)


def _kv_head_slices(q, k):
    """(query-head slice, kv-head slice) of each kv head."""
    group = q.shape[2] // k.shape[2]
    return [(slice(i * group, (i + 1) * group), slice(i, i + 1))
            for i in range(k.shape[2])]


def _splash_plain(q, k, v, do, masks):
    """The plain forward and backward of the splash call, one kv head (and
    its query heads) at a time to keep the (S, S) scores small: ((out,
    lse), (dq, dk, dv)) in the kernels' layouts."""
    from ray_tpu_torch.ops import splash_attention as ss

    outs, lses, grads = [], [], []
    for qs, ks in _kv_head_slices(q, k):
        args = (q[:, :, qs], k[:, :, ks], v[:, :, ks])
        out, lse = ss.splash_attention_reference(*args, masks[qs])
        grads.append(ss.splash_backward_reference(*args, out, lse,
                                                  do[:, :, qs], masks[qs]))
        outs.append(out)
        lses.append(lse)
    return ((torch.cat(outs, 2), torch.cat(lses, 1)),
            tuple(torch.cat(g, 2) for g in zip(*grads)))


def _splash_cases(g, dev):
    """(name, (q, k, v, dO), masks) at the edges of the splash kernels."""
    from ray_tpu_torch.ops import splash_attention as ss

    def inputs(*shape, dtype=torch.bfloat16):
        return _bwd_inputs(g, *shape, dtype, dev)

    return [
        ("f32_mixed", inputs(1, 512, 512, 4, 2, 128, dtype=torch.float32),
         [ss.LocalMask(100)] * 2 + [ss.ChunkedMask(192)] * 2),
        ("d64", inputs(2, 1024, 1024, 8, 4, 64),
         [ss.CausalMask()] * 4 + [ss.LocalMask(256)] * 2
         + [ss.FullMask()] * 2),
        ("d80_padded", inputs(1, 512, 512, 4, 2, 80),
         [ss.ChunkedMask(128)] * 2 + [ss.FullMask()] * 2),
        ("s100_ragged", inputs(2, 100, 100, 8, 4, 128),
         [ss.LocalMask(30)] * 2 + [ss.ChunkedMask(40)] * 2
         + [ss.CausalMask()] * 2 + [ss.FullMask()] * 2),
        # Queries 95.. see no key within the window: out 0, lse -1e30,
        # zero gradients; q tiles 2-3 have no live kv tile at all.
        ("degenerate_rows", inputs(1, 256, 64, 2, 1, 128),
         [ss.LocalMask(32)] * 2),
        ("sq200_sk328_full", inputs(1, 200, 328, 4, 2, 128),
         [ss.FullMask()] * 4),
        # Edges of the wgmma kernels' tiles (128-row q tiles in the
        # forward, 64-key tiles and 64-row q tiles in dK/dV, statistics
        # rows that start off a multiple of 4) and their one launch over
        # every head group: GQA 1, 2 and 4, B=2, D 64 and 128.
        ("s129_gqa1", inputs(2, 129, 129, 4, 4, 128),
         [ss.LocalMask(70)] * 2 + [ss.CausalMask()] * 2),
        ("s255_gqa4_d64", inputs(2, 255, 255, 8, 2, 64),
         [ss.ChunkedMask(100)] * 4 + [ss.FullMask()] * 4),
        ("sq200_sk328_gqa2_b2", inputs(2, 200, 328, 4, 2, 128),
         [ss.CausalMask()] * 2 + [ss.LocalMask(64)] * 2),
        ("degenerate_rows_d64_gqa2", inputs(2, 256, 64, 4, 2, 64),
         [ss.LocalMask(32)] * 4),
        ("alternating_8_groups", inputs(1, 512, 512, 8, 8, 128),
         [ss.LocalMask(96), ss.FullMask()] * 4),
        ("f32_s129_gqa2", inputs(1, 129, 129, 4, 2, 64, dtype=torch.float32),
         [ss.CausalMask()] * 2 + [ss.LocalMask(40)] * 2),
    ]


def splash_kernel_counts(device="cuda") -> dict:
    """Launches of each kernel behind ``splash.cu``'s entries, as the C
    entries count them (none off the card)."""
    if torch.device(device).type != "cuda":
        return {}
    from ray_tpu_torch.ops.splash_attention import kernel_launches

    return kernel_launches()


def splash_kernels_since(before: dict, device="cuda") -> dict:
    return {k: n - before.get(k, 0)
            for k, n in splash_kernel_counts(device).items()}


def splash_calls_on(by_kernel: dict, calls: int, dtype, device) -> bool:
    """``calls`` forward + backward splash calls launched one forward, one
    dK/dV and one dQ kernel a call, over all their head groups, on wgmma
    for bf16 and mma.sync for float32 (off the card nothing launches)."""
    if torch.device(device).type != "cuda":
        return True
    route = "wgmma" if dtype == torch.bfloat16 else "mma_sync_f32"
    want = {k: 0 for k in by_kernel}
    want.update({f"{kind}_{route}": calls for kind in ("fwd", "dkv", "dq")})
    return by_kernel == want


def _check_splash_cases(g, dev) -> list:
    """Each edge case: the forward kernel's out and lse against the plain
    forward, and the backward kernels' dq, dk, dv against the plain
    backward on the same (out, lse), with the kernels the C entries
    counted (one forward, one dK/dV and one dQ launch, on wgmma for bf16
    and mma.sync for float32; ``dq_kernel`` names dQ's). Tolerances as the
    flash checks: out at rtol = atol = 2e-2 in bf16 and 1e-4 in float32,
    gradients by max |error| relative to the plain gradient's max at the
    same two."""
    from ray_tpu_torch.ops import splash_attention as ss

    results = []
    for name, (q, k, v, do), masks in _splash_cases(g, dev):
        before = splash_kernel_counts(dev)
        out, lse = ss.splash_forward(q, k, v, masks)
        got = ss.splash_backward(q, k, v, out, lse, do, masks)
        _sync(dev)
        by_kernel = splash_kernels_since(before, dev)
        ref, ref_lse = ss.splash_attention_reference(q, k, v, masks)
        want = ss.splash_backward_reference(q, k, v, out, lse, do, masks)
        tol = 2e-2 if q.dtype == torch.bfloat16 else 1e-4
        live = ref_lse > -1e29
        ok = (torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol)
              and torch.allclose(lse[live], ref_lse[live], rtol=1e-3,
                                 atol=1e-3)
              and bool((lse[~live] == -1e30).all()))
        errs = {"out": float((out.float() - ref.float()).abs().max())}
        for gname, a, r in zip(("dq", "dk", "dv"), got, want):
            errs[gname] = _rel_err(a, r)
            ok = ok and a.dtype == r.dtype and a.shape == r.shape and (
                bool(torch.isfinite(a.float()).all()) and errs[gname] <= tol)
        if name.startswith("degenerate_rows"):
            ok = ok and not out[:, 95:].any() and not got[0][:, 95:].any() \
                and bool((lse[:, :, 95:] == -1e30).all())
        ok = ok and splash_calls_on(by_kernel, 1, q.dtype, dev)
        results.append({"case": f"splash_{name}", "ok": ok,
                        "route": _route(by_kernel),
                        "dq_kernel": _route({k_: n for k_, n in
                                             by_kernel.items()
                                             if k_.startswith("dq_")}),
                        "max_abs_err_out": errs.pop("out"),
                        "rel_max_abs_err": errs, "tol": tol})
    torch.cuda.empty_cache()
    return results


def _sdpa_backend(qt, kt, vt, mask):
    """The first SDPA backend that takes this boolean mask, forward and
    backward."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with sdpa_kernel([backend]):
                out = torch.nn.functional.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask)
                torch.autograd.grad(out, (qt, kt, vt), torch.ones_like(out),
                                    retain_graph=True)
            torch.cuda.synchronize()
            return backend
        except RuntimeError:
            continue
    raise RuntimeError("no SDPA backend takes a boolean mask here")


def _splash_keep(masks, s, dev):
    """Each distinct mask's (S, S) boolean keep matrix, from its own
    ``apply``."""
    rows = torch.arange(s, device=dev)[:, None]
    cols = torch.arange(s, device=dev)[None, :]
    return {m: m.apply(torch.zeros(s, s, device=dev), rows, cols) == 0
            for m in set(masks)}


def _time_splash(q, k, v, do, masks, keep, errs, record) -> dict:
    """Time each splash kernel at the path's shape (launches alone, all
    head groups per call) beside the plain version, SDPA with the dense
    boolean mask ``keep`` gives, and the card's bound over this call's
    live pairs."""
    from torch.nn.attention import sdpa_kernel

    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import splash_attention as ss

    b, s, h, d = q.shape[0], q.shape[1], q.shape[2], q.shape[3]
    hkv = k.shape[2]
    scale = d ** -0.5
    head_pairs = sum(int(keep[m].sum()) for m in masks)
    launch, (out, lse) = ss._splash_forward_launcher(q, k, v, masks, scale)
    ms = {"splash_fwd": _time_ms(launch, iters=20)}
    delta = fa.attention_delta(out, do)
    launch_b, _ = ss._splash_backward_launcher(q, k, v, do, lse, delta,
                                               masks, scale)
    ms["splash_bwd_dkv"] = _time_ms(lambda: launch_b("dkv"), iters=20)
    ms["splash_bwd_dq"] = _time_ms(lambda: launch_b("dq"), iters=20)

    def launches():
        launch()
        launch_b("dkv")
        launch_b("dq")

    def wrapper():
        o, l_ = ss.splash_forward(q, k, v, masks)
        ss.splash_backward(q, k, v, o, l_, do, masks)

    # Host time a forward + backward call: the C entries alone (one
    # launch each) and the whole wrappers (delta, validation, allocation,
    # the cached schedules' lookup), beside the per-group dQ design's.
    host = {"launch_host_ms": _host_ms(launches),
            "wrapper_host_ms": _host_ms(wrapper),
            "wrapper_host_ms_per_group_dq":
                SPLASH_WRAPPER_HOST_MS_PER_GROUP_DQ,
            "fwd_bwd_ms": _time_ms(wrapper, iters=10)}
    heads = _kv_head_slices(q, k)
    plain_fwd_ms = _time_ms(lambda: [ss.splash_attention_reference(
        q[:, :, qs], k[:, :, ks], v[:, :, ks], masks[qs])
        for qs, ks in heads], iters=2, warmup=1)
    plain_bwd_ms = _time_ms(lambda: [ss.splash_backward_reference(
        q[:, :, qs], k[:, :, ks], v[:, :, ks], out[:, :, qs], lse[:, qs],
        do[:, :, qs], masks[qs]) for qs, ks in heads], iters=2, warmup=1)
    del launch, launch_b, delta

    # Library yardstick: SDPA with the dense (H, S, S) boolean mask, k and
    # v expanded to the 16 query heads.
    dense = torch.stack([keep[m] for m in masks])[None]
    qt = q.transpose(1, 2).detach().requires_grad_()
    kt, vt = (x.repeat_interleave(h // hkv, dim=2).transpose(1, 2).detach()
              .requires_grad_() for x in (k, v))
    backend = _sdpa_backend(qt, kt, vt, dense)
    dot = do.transpose(1, 2)
    with sdpa_kernel([backend]):
        lib_fwd_ms = _time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=dense), iters=10)
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=dense)
        lib_bwd_ms = _time_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), dot, retain_graph=True), iters=10)
    del dense, qt, kt, vt, lib_out
    torch.cuda.empty_cache()

    bound_fwd = _flash_bound(b, s, s, h, hkv, d, head_pairs=head_pairs)
    bounds = {"splash_fwd": bound_fwd,
              **_flash_bwd_bounds(b, s, s, h, hkv, d, head_pairs=head_pairs,
                                  prefix="splash")}
    plain = {"splash_fwd": plain_fwd_ms, "splash_bwd_dkv": plain_bwd_ms,
             "splash_bwd_dq": plain_bwd_ms}
    lib = {"splash_fwd": lib_fwd_ms, "splash_bwd_dkv": lib_bwd_ms,
           "splash_bwd_dq": lib_bwd_ms}
    from ray_tpu_torch.ops import cuda_build

    ptxas = cuda_build_rows(cuda_build, "splash")
    for name in ms:
        record[name] = {"max_abs_err": errs[name], "ms": ms[name],
                        "plain_ms": plain[name], "bound_ms": bounds[name][0],
                        "bound_by": bounds[name][1], "library_ms": lib[name],
                        "ptxas": [r for r in ptxas if r.startswith(name)]}
    dq_flops = 6.0 * b * d * head_pairs
    return {"bwd_pair_ms": ms["splash_bwd_dkv"] + ms["splash_bwd_dq"],
            "dq_ms": ms["splash_bwd_dq"],
            "dq_bound_ms": bounds["splash_bwd_dq"][0],
            "dq_tflops": dq_flops / ms["splash_bwd_dq"] / 1e9,
            "dq_share_of_bound_rate": bounds["splash_bwd_dq"][0]
            / ms["splash_bwd_dq"],
            **host,
            "library_is": f"SDPA ({backend.name}) with a dense ({h}, S, S) "
                          f"boolean mask, k/v expanded to {h} heads; "
                          "backward gives dq, dk, dv together",
            "plain_is": "splash_attention_reference / "
                        "splash_backward_reference, one kv head at a time"}


# The head groups of the splash stack that a flash mask also describes:
# (name, q heads, flash_forward's keywords).
FLASH_TWINS = (("local", (0, 8), dict(causal=True, window=1024)),
               ("causal", (12, 14), dict(causal=True)),
               ("full", (14, 16), dict(causal=False)))


def _time_groups(q, k, v, do, masks) -> dict:
    """Launch-only times (CUDA events, 20 launches after warm-up) of each
    splash kernel on each head group alone, beside the flash kernel on the
    same heads where a flash mask describes the group: where the call's
    time goes, and the cost of walking a tile list instead of a range."""
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import splash_attention as ss

    scale = q.shape[-1] ** -0.5
    group = q.shape[2] // k.shape[2]
    twins = {heads: kw for _, heads, kw in FLASH_TWINS}
    res = {}
    for a, c, m in ss._group_heads(masks):
        qs, ks = slice(a, a + c), slice(a // group, (a + c) // group)
        args = (q[:, :, qs], k[:, :, ks], v[:, :, ks])
        s_fwd, (out, lse) = ss._splash_forward_launcher(*args, masks[qs],
                                                        scale)
        s_fwd()
        delta = fa.attention_delta(out, do[:, :, qs])
        s_bwd, _ = ss._splash_backward_launcher(*args, do[:, :, qs], lse,
                                                delta, masks[qs], scale)
        times = {"fwd_ms": {"splash": _time_ms(s_fwd, 20)},
                 "bwd_dkv_ms": {"splash": _time_ms(lambda: s_bwd("dkv"), 20)},
                 "bwd_dq_ms": {"splash": _time_ms(lambda: s_bwd("dq"), 20)}}
        kw = twins.get((a, a + c))
        if kw is not None:
            mask_args = (kw["causal"], kw.get("window"), 0)
            f_fwd, _ = fa._forward_launcher(*args, None, None, scale,
                                            *mask_args)
            f_bwd, _ = fa._backward_launcher(*args, do[:, :, qs], lse, delta,
                                             None, None, None, scale,
                                             *mask_args)
            times["fwd_ms"]["flash"] = _time_ms(f_fwd, 20)
            times["bwd_dkv_ms"]["flash"] = _time_ms(lambda: f_bwd("dkv"), 20)
            times["bwd_dq_ms"]["flash"] = _time_ms(lambda: f_bwd("dq"), 20)
        res[f"{type(m).__name__} heads {a}-{a + c - 1}"] = times
    return res


def _against_flash(q, k, v, do, out, grads) -> dict:
    """The splash kernels' out and gradients on the local, causal and full
    heads against the flash kernels on the same heads (window=1024,
    causal, non-causal): two hand-written kernels agree or one is wrong.
    Max |error| relative to the flash value's max; at most 2e-2 (bf16)."""
    from ray_tpu_torch.ops import flash_attention as fa

    res = {}
    for name, heads, kw in FLASH_TWINS:
        qs, ks = slice(*heads), slice(heads[0] // 2, heads[1] // 2)
        args = (q[:, :, qs], k[:, :, ks], v[:, :, ks])
        f_out, f_lse = fa.flash_forward(*args, **kw)
        f_grads = fa.flash_backward(*args, f_out, f_lse, do[:, :, qs], **kw)
        errs = {"out": _rel_err(out[:, :, qs], f_out)}
        for gname, a, r, sl in zip(("dq", "dk", "dv"), grads, f_grads,
                                   (qs, ks, ks)):
            errs[gname] = _rel_err(a[:, :, sl], r)
        res[name] = {"rel_max_abs_err": errs,
                     "ok": max(errs.values()) <= 2e-2}
    return res


def phase_splash(record: dict, device="cuda", shape=None) -> dict:
    """The splash path: ``splash_attention`` forward and backward through
    the autograd Function at the 1B attention width, S = 8192, bf16, the
    default 256 blocks, with exact launch counts; the result against the
    plain version and against the flash kernels; the edge cases; on the
    card, the timings. ``shape`` (a ``SPLASH_SHAPE`` dict) shrinks it for
    a rehearsal on the CPU, where the kernels' plain versions run."""
    from ray_tpu_torch.ops import splash_attention as ss

    shape = shape or SPLASH_SHAPE
    b, s, h, hkv, d = (shape[x] for x in ("b", "s", "h", "hkv", "d"))
    cuda = torch.device(device).type == "cuda"
    g = torch.Generator(device=device).manual_seed(3)
    q, k, v, do = _bwd_inputs(g, b, s, s, h, hkv, d, torch.bfloat16, device)
    masks = _splash_masks()
    keep = _splash_keep(masks, s, device)
    head_pairs = sum(int(keep[m].sum()) for m in masks)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    reset_counts()
    before = splash_kernel_counts(device)
    t0 = time.perf_counter()
    out = ss.splash_attention(*leaves, mask=masks)
    out.backward(do)
    _sync(device)
    wall_s = [time.perf_counter() - t0]
    counts = launch_counts()
    by_kernel = splash_kernels_since(before, device)
    grads = tuple(x.grad for x in leaves)
    out = out.detach()
    # A second call: the schedules come from the cache and the kernels are
    # loaded, so its wall time is the op's steady cost on the host clock.
    t0 = time.perf_counter()
    torch.autograd.grad(ss.splash_attention(*leaves, mask=masks), leaves,
                        do)
    _sync(device)
    wall_s.append(time.perf_counter() - t0)
    del leaves

    (ref, _), ref_grads = _splash_plain(q, k, v, do, masks)
    tol = 2e-2
    errs = {"out": float((out.float() - ref.float()).abs().max())}
    errs.update({n: _rel_err(a, r) for n, a, r in
                 zip(("dq", "dk", "dv"), grads, ref_grads)})
    checks = {
        # One forward, one dK/dV and one dQ launch over all four head
        # groups, after one delta; bf16, so all three on wgmma.
        "launches_1_1_1": counts == {
            k_: SPLASH_LAUNCHES.get(k_, 0) for k_ in KERNELS},
        "splash_on_wgmma": splash_calls_on(by_kernel, 1, torch.bfloat16,
                                           device),
        "out_matches_plain": torch.allclose(out.float(), ref.float(),
                                            rtol=tol, atol=tol),
        "grads_match_plain": max(errs["dq"], errs["dk"], errs["dv"]) <= tol,
        "finite": all(bool(torch.isfinite(t.float()).all())
                      for t in (out, *grads)),
    }
    if shape == SPLASH_SHAPE:
        checks["live_pairs_297824256"] = head_pairs == SPLASH_PAIRS
    del ref, ref_grads
    flash = _against_flash(q, k, v, do, out, grads)
    checks["matches_flash_kernels"] = all(r["ok"] for r in flash.values())
    cases = _check_splash_cases(g, device)
    checks["edge_cases"] = all(r["ok"] for r in cases)
    res = {"shape": {**shape, "dtype": "bfloat16", "block_q": 256,
                     "block_k": 256,
                     "masks": "heads 0-7 LocalMask(1024), 8-11 "
                              "ChunkedMask(2048), 12-13 CausalMask, "
                              "14-15 FullMask"},
           "launches": counts, "splash_by_kernel": by_kernel,
           "fwd_bwd_wall_s_first_second": wall_s,
           "live_pairs_per_head": {type(m).__name__: int(keep[m].sum())
                                   for m in keep},
           "live_pairs": head_pairs, "max_err_vs_plain": errs, "tol": tol,
           "vs_flash": flash, "cases": cases}
    if cuda:
        torch.cuda.empty_cache()
        res.update(_time_splash(
            q, k, v, do, masks, keep,
            {"splash_fwd": errs["out"], "splash_bwd_dq": errs["dq"],
             "splash_bwd_dkv": max(errs["dk"], errs["dv"])}, record))
        res["group_ms"] = _time_groups(q, k, v, do, masks)
        for name, prefix in (("splash_fwd", "fwd_"),
                             ("splash_bwd_dkv", "dkv_"),
                             ("splash_bwd_dq", "dq_")):
            record[name]["launches_by_kernel"] = {
                k_: n for k_, n in by_kernel.items() if k_.startswith(prefix)}
        res.update({f"{name}_{key}": val for name in PATH_KERNELS["splash"]
                    if name.startswith("splash")
                    for key, val in record[name].items()})
        res["device"] = smi_line()
    del q, k, v, do, out, grads, keep
    res["checks"] = checks
    res["ok"] = all(checks.values())
    return res


# ---------------------------------------------------------------- serve


def _solo_greedy(engine, prompt, n):
    """Solo greedy decode of one prompt on the deployment's weights, its
    prompt padded to the engine's bucket: (tokens, top-2 margins)."""
    from ray_tpu_torch.models import llama_decode as ld

    cfg, params, dev = engine.config, engine.params, engine.device
    s = len(prompt)
    cache = ld.init_cache(cfg, 1, ld.cache_bucket(s + n), device=dev)
    padded = torch.zeros(1, ld.cache_bucket(s, engine.prefill_bucket),
                         dtype=torch.long, device=dev)
    padded[0, :s] = torch.as_tensor(prompt, device=dev)
    logits, cache = ld.prefill(params, padded, cache, cfg,
                               lengths=torch.tensor([s], device=dev))
    out, margins = [], []
    for _ in range(n):
        top2 = torch.topk(logits[0], 2).values
        margins.append(float(top2[0] - top2[1]))
        tok = int(torch.argmax(logits[0]))
        out.append(tok)
        logits, cache = ld.decode_step(
            params, cache, torch.tensor([tok], dtype=torch.int32,
                                        device=dev), cfg)
    del cache
    return out, margins


def _path_drift(engine, batch_prompts, src, sharer, prefix_len) -> dict:
    """Max |logit| differences between the ways the engine may compute the
    same next-token logits: a prompt prefilled alone vs in a batch of four
    (cut to the first prompt's length), one decode step after each, and a
    prefix-hit suffix prefill over ``src``'s cached K/V vs a full prefill
    of ``sharer``. The margin rule's tolerance must cover all of them."""
    from ray_tpu_torch.models import llama_decode as ld

    cfg, dev, params = engine.config, engine.device, engine.params
    s = len(batch_prompts[0])
    bucket = ld.cache_bucket(s, engine.prefill_bucket)
    n = len(batch_prompts)
    rows = torch.zeros(n, bucket, dtype=torch.long, device=dev)
    for i, p in enumerate(batch_prompts):
        rows[i, :s] = torch.as_tensor(p[:s], device=dev)
    lengths = torch.full((n,), s, device=dev)
    c1 = ld.init_cache(cfg, 1, bucket * 2, device=dev)
    cn = ld.init_cache(cfg, n, bucket * 2, device=dev)
    solo, c1 = ld.prefill(params, rows[:1], c1, cfg, lengths=lengths[:1])
    batch, cn = ld.prefill(params, rows, cn, cfg, lengths=lengths)
    out = {"prefill_batch": float((solo[0] - batch[0]).abs().max())}
    tok = torch.argmax(solo, dim=-1).to(torch.int32)
    solo, c1 = ld.decode_step(params, c1, tok, cfg)
    batch, cn = ld.decode_step(params, cn, tok.repeat(n), cfg)
    out["decode_batch"] = float((solo[0] - batch[0]).abs().max())
    del c1, cn

    def padded(p, b):
        t = torch.zeros(1, b, dtype=torch.long, device=dev)
        t[0, :len(p)] = torch.as_tensor(p, device=dev)
        return t

    cap = engine.capacity
    full, _ = ld.prefill(
        params, padded(sharer, ld.cache_bucket(len(sharer))),
        ld.init_cache(cfg, 1, cap, device=dev), cfg,
        lengths=torch.tensor([len(sharer)], device=dev))
    cache = ld.init_cache(cfg, 1, cap, device=dev)
    ld.prefill(params, padded(src, ld.cache_bucket(len(src))), cache, cfg,
               lengths=torch.tensor([len(src)], device=dev))
    suffix = sharer[prefix_len:]
    hit, _ = ld.prefill_suffix(
        params, padded(suffix, ld.cache_bucket(len(suffix), 16)), cache,
        cfg, torch.tensor([prefix_len], device=dev),
        torch.tensor([len(sharer)], device=dev))
    out["suffix_vs_full"] = float((hit[0] - full[0]).abs().max())
    return out


def _agrees(got, want, margins, tol):
    """Margin rule: equal tokens while the solo top-2 margin exceeds tol;
    stop at the first position within tol. Returns positions compared,
    or -1 on a disagreement outside the rule."""
    for i, (a, b) in enumerate(zip(got, want)):
        if margins[i] <= tol:
            return i
        if a != b:
            return -1
    return len(got)


def slo(deployment: str) -> dict:
    """``slo_summary`` of one deployment's serve metrics, read from this
    process's registry."""
    from ray_tpu_torch.serve.metrics import slo_summary
    from ray_tpu_torch.util.metrics import _Registry

    return slo_summary({"local": _Registry.get().snapshot()}).get(
        deployment, {})


def slo_line(summary: dict) -> dict:
    """TTFT p50/p99, inter-token p50, queue-wait p50 (seconds, bucket-
    interpolated by ``histogram_quantile``) and the outcomes."""
    def q(field, key):
        return summary.get(field, {}).get(key)

    return {"ttft_p50_s": q("ttft_s", "p50"), "ttft_p99_s": q("ttft_s", "p99"),
            "ttft_count": q("ttft_s", "count"),
            "inter_token_p50_s": q("inter_token_s", "p50"),
            "queue_wait_p50_s": q("queue_wait_s", "p50"),
            "outcomes": summary.get("outcomes", {})}


def phase_serve(cfg, device="cuda") -> dict:
    from ray_tpu_torch.serve.decode import LlamaDecodeDeployment

    t0 = time.perf_counter()
    dep = LlamaDecodeDeployment(config=cfg, slots=4, capacity=2048, seed=0,
                                metrics_deployment="serve", device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    eng = dep.engine
    rng = np.random.default_rng(0)

    def prompt(n):
        return rng.integers(1, cfg.vocab_size, n).tolist()

    shared = prompt(1100)
    plan = {  # name -> (prompt, max_new_tokens, streamed)
        "r1_shared_src": (shared, 32, True),
        "r2_short": (prompt(20), 16, False),
        "r3": (prompt(300), 24, False),
        "r4": (prompt(700), 32, True),
        "r5_prefix_hit": (shared[:1061] + prompt(200), 24, False),
        "r6_long": (prompt(1500), 16, False),
    }
    results, errors, token_times = {}, {}, {}
    first_token = threading.Event()

    def run(name):
        toks, n, streamed = plan[name]
        try:
            t_sub = time.perf_counter()
            if streamed:
                got, times = [], []
                for tok in dep({"tokens": toks, "max_new_tokens": n,
                                "stream": True}):
                    times.append(time.perf_counter())
                    got.append(tok)
                    if name == "r1_shared_src":
                        first_token.set()
                token_times[name] = times
                results[name] = {"tokens": got,
                                 "ttft_s": times[0] - t_sub}
            else:
                results[name] = dep({"tokens": toks, "max_new_tokens": n})
        except Exception as e:  # reported as a failed phase below
            errors[name] = f"{type(e).__name__}: {e}"
            first_token.set()

    reset_counts()
    fwd0 = fwd_kernel_counts(device)
    t_start = time.perf_counter()
    threads = [threading.Thread(target=run, args=(n,))
               for n in ("r1_shared_src", "r2_short", "r3", "r4")]
    for t in threads:
        t.start()
    # Prefix entries are inserted at admission: submit the sharer only
    # after the source request has produced its first token.
    first_token.wait(REQUEST_TIMEOUT_S)
    later = [threading.Thread(target=run, args=(n,))
             for n in ("r5_prefix_hit", "r6_long")]
    for t in later:
        t.start()
    for t in threads + later:
        t.join(REQUEST_TIMEOUT_S)
    _sync(device)
    t_end = time.perf_counter()
    counts = launch_counts()
    by_kernel = fwd_kernels_since(fwd0, device)
    stats = eng.stats()
    hung = [t.name for t in threads + later if t.is_alive()]
    out = {"init_s": init_s, "wall_s": t_end - t_start,
           "launches": counts, "flash_fwd_by_kernel": by_kernel,
           "engine": stats, "errors": errors, "hung_threads": hung}
    checks = {}
    checks["all_answered"] = (not errors and not hung
                              and set(results) == set(plan))
    checks["token_counts"] = checks["all_answered"] and all(
        len(results[n]["tokens"]) == plan[n][1] for n in plan)
    checks["tokens_in_vocab"] = checks["all_answered"] and all(
        0 <= t < cfg.vocab_size for n in plan for t in results[n]["tokens"])
    checks["prefix_hit"] = stats.get("prefix", {}).get("hits", 0) >= 1
    checks["flash_launches_32_per_miss_wave"] = (
        stats["prefill_waves"] > 0
        and counts["flash_fwd"] == cfg.n_layers * stats["prefill_waves"])
    checks["flash_fwd_on_wgmma"] = all_on_wgmma(by_kernel, counts["flash_fwd"],
                                                device)
    if checks["all_answered"]:
        out["ttft_s"] = {n: results[n]["ttft_s"] for n in plan}
        out["stream_decode_tok_s"] = {
            n: (len(ts) - 1) / (ts[-1] - ts[0])
            for n, ts in token_times.items() if len(ts) > 1}
        out["engine_tok_s"] = stats["tokens_out"] / (t_end - t_start)
        agree = {}
        for n, (toks, k, _) in plan.items():
            want, margins = _solo_greedy(eng, toks, k)
            agree[n] = _agrees(results[n]["tokens"], want, margins,
                               MARGIN_TOL)
        out["greedy_positions_compared"] = agree
        drift = _path_drift(
            eng, [plan[n][0] for n in ("r3", "r4", "r6_long",
                                       "r1_shared_src")],
            shared, plan["r5_prefix_hit"][0],
            stats["prefix"]["prefill_tokens_saved"])
        out["logit_drift"] = drift
        checks["greedy_agrees_with_solo"] = (
            all(v >= 0 for v in agree.values())
            and max(drift.values()) < MARGIN_TOL)
    out["slo"] = slo_line(slo("serve"))
    checks["slo_completed"] = (
        out["slo"]["outcomes"].get("completed") == len(plan))
    out["margin_tol"] = MARGIN_TOL
    out["checks"] = checks
    if torch.device(device).type == "cuda":
        out["device"] = smi_line()
    out["ok"] = all(checks.values()) and len(checks) == 8
    dep.shutdown()
    return out


# The serve_paged phase's pool and requests (see the module docstring).
PAGED_SERVE = dict(slots=8, capacity=2048, page_tokens=64, pool_pages=64,
                   chunk=512)


def _paged_drift(engine, plan, src, sharer, prefix_len) -> dict:
    """Max |logit| differences between the paged and the contiguous paths
    on the deployment's weights, each through a fresh pool with shuffled
    page ids: a full paged prefill and one paged decode step after it
    against the contiguous ones; the longest prompt prefilled in
    engine-sized chunks (paged suffix prefills) against its full
    contiguous prefill; and a prefix hit's paged suffix prefill over the
    source's pages against the sharer's full contiguous prefill. The
    margin rule's tolerance must cover all of them."""
    from ray_tpu_torch.models import llama_decode as ld

    cfg, dev, params = engine.config, engine.device, engine.params
    T, chunk = engine.page_tokens, engine.prefill_chunk_tokens
    pages = engine.slot_pages_max
    ids = torch.as_tensor(np.random.default_rng(1).permutation(
        np.arange(1, pages + 1)), dtype=torch.int32, device=dev)[None]

    def padded(p, b):
        t = torch.zeros(1, b, dtype=torch.long, device=dev)
        t[0, :len(p)] = torch.as_tensor(p, device=dev)
        return t

    def contiguous(p):
        cache = ld.init_cache(cfg, 1, engine.capacity, device=dev)
        logits, cache = ld.prefill(
            params, padded(p, ld.cache_bucket(len(p), engine.prefill_bucket)),
            cache, cfg, lengths=torch.tensor([len(p)], device=dev))
        return logits, cache

    out = {}
    p = plan["p3"][0]
    bucket = ld.cache_bucket(len(p), engine.prefill_bucket)
    pool = ld.init_page_pool(cfg, pages, T, device=dev)
    lengths = torch.tensor([len(p)], dtype=torch.int32, device=dev)
    paged, pool = ld.paged_prefill(params, padded(p, bucket), pool,
                                   ids[:, :-(-bucket // T)], cfg,
                                   lengths=lengths)
    full, cache = contiguous(p)
    out["prefill"] = float((paged - full).abs().max())
    tok = torch.argmax(full, dim=-1).to(torch.int32)
    paged, pool, _ = ld.paged_decode_step(
        params, pool, ids[:, :-(-(len(p) + 1) // T)], lengths, tok, cfg)
    full, cache = ld.decode_step(params, cache, tok, cfg)
    out["decode"] = float((paged - full).abs().max())
    del cache
    p = plan["p2_chunked"][0]
    pool = ld.init_page_pool(cfg, pages, T, device=dev)
    for start in range(0, len(p), chunk):
        end = min(len(p), start + chunk)
        b = min(ld.cache_bucket(end - start, engine._suffix_bucket_min),
                chunk)
        paged, pool = ld.paged_prefill_suffix(
            params, padded(p[start:end], b), pool,
            ids[:, :min(pages, -(-(start + b) // T))], cfg,
            torch.tensor([start], device=dev),
            torch.tensor([end], device=dev))
    full, _ = contiguous(p)
    out["chunked_vs_full"] = float((paged - full).abs().max())
    pool = ld.init_page_pool(cfg, pages, T, device=dev)
    bucket = ld.cache_bucket(len(src), engine.prefill_bucket)
    ld.paged_prefill(params, padded(src, bucket), pool,
                     ids[:, :-(-bucket // T)], cfg,
                     lengths=torch.tensor([len(src)], device=dev))
    suffix = sharer[prefix_len:]
    b = ld.cache_bucket(len(suffix), engine._suffix_bucket_min)
    paged, pool = ld.paged_prefill_suffix(
        params, padded(suffix, b), pool,
        ids[:, :min(pages, -(-(prefix_len + b) // T))], cfg,
        torch.tensor([prefix_len], device=dev),
        torch.tensor([len(sharer)], device=dev))
    full, _ = contiguous(sharer)
    out["suffix_vs_full"] = float((paged - full).abs().max())
    del pool
    return out


def _paged_plan(cfg) -> dict:
    """serve_paged's eight requests, name -> (prompt, max_new_tokens,
    temperature): a 1100-token prefix source, a 1500-token prompt (3
    chunks), prompts of 900, 800, 700 (sampled at 0.8), 300 and 20 tokens,
    and a sharer of the source's first 1061 tokens plus 200."""
    rng = np.random.default_rng(1)

    def prompt(n):
        return rng.integers(1, cfg.vocab_size, n).tolist()

    shared = prompt(1100)
    return {
        "p1_shared_src": (shared, 32, 0.0),
        "p2_chunked": (prompt(1500), 16, 0.0),
        "p3": (prompt(900), 24, 0.0),
        "p4": (prompt(800), 24, 0.0),
        "p5_sampled": (prompt(700), 24, 0.8),
        "p6": (prompt(300), 32, 0.0),
        "p7_short": (prompt(20), 32, 0.0),
        "p8_prefix_hit": (shared[:1061] + prompt(200), 24, 0.0),
    }


def phase_serve_paged(cfg, device="cuda") -> dict:
    """Llama-2-7B behind a paged ``LlamaDecodeDeployment``: 8 slots of
    2048 tokens on a pool of 64 pages of 64 tokens (4096 tokens for
    requests that want far more), 512-token prefill chunks, the device
    sampler. Eight requests, all sent before the first can finish: a
    1100-token prefix source; a sharer of its first 1061 tokens plus 200,
    sent after the source's first token; a 1500-token prompt (3 chunks);
    prompts of 900, 800, 700, 300 and 20 tokens, the 700 one sampled at
    temperature 0.8."""
    from ray_tpu_torch.serve.decode import LlamaDecodeDeployment

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    geo = PAGED_SERVE
    t0 = time.perf_counter()
    dep = LlamaDecodeDeployment(
        config=cfg, slots=geo["slots"], capacity=geo["capacity"], seed=0,
        kv_page_tokens=geo["page_tokens"], kv_pool_pages=geo["pool_pages"],
        prefill_chunk_tokens=geo["chunk"], device_sampler=True,
        metrics_deployment="serve_paged", device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    eng = dep.engine
    plan = _paged_plan(cfg)
    shared = plan["p1_shared_src"][0]
    results, errors, token_times, submitted = {}, {}, {}, {}
    first_token = threading.Event()

    def run(name):
        toks, n, temp = plan[name]
        try:
            got, times = [], []
            submitted[name] = time.perf_counter()
            for tok in dep({"tokens": toks, "max_new_tokens": n,
                            "temperature": temp, "stream": True}):
                times.append(time.perf_counter())
                got.append(tok)
                if name == "p1_shared_src":
                    first_token.set()
            token_times[name] = times
            results[name] = got
        except Exception as e:  # reported as a failed phase below
            errors[name] = f"{type(e).__name__}: {e}"
            first_token.set()

    # Page stats at every step boundary, read on the decode loop's own
    # thread: a read from another thread could land inside an admission,
    # whose pages are taken before its prefill has filled them.
    samples = []
    step = eng.step

    def step_and_sample():
        n = step()
        s = eng.stats()
        if s["active"] or s["prefilling"]:
            samples.append((s["kv_fragmentation"], s["pages_free"]))
        return n

    eng.step = step_and_sample
    reset_counts()
    fwd0 = fwd_kernel_counts(device)
    t_start = time.perf_counter()
    threads = [threading.Thread(target=run, args=(n,))
               for n in plan if n != "p8_prefix_hit"]
    for t in threads:
        t.start()
    # The prefix index takes the source's pages at its admission: send the
    # sharer after the source's first token.
    first_token.wait(REQUEST_TIMEOUT_S)
    later = threading.Thread(target=run, args=("p8_prefix_hit",))
    later.start()
    for t in threads + [later]:
        t.join(REQUEST_TIMEOUT_S)
    _sync(device)
    t_end = time.perf_counter()
    counts = launch_counts()
    by_kernel = fwd_kernels_since(fwd0, device)
    stats = eng.stats()
    hung = [t.name for t in threads + [later] if t.is_alive()]
    out = {"init_s": init_s, "wall_s": t_end - t_start,
           "geometry": geo, "launches": counts,
           "flash_fwd_by_kernel": by_kernel, "engine": stats,
           "errors": errors, "hung_threads": hung}
    checks = {}
    checks["all_answered"] = (not errors and not hung
                              and set(results) == set(plan))
    checks["token_counts"] = checks["all_answered"] and all(
        len(results[n]) == plan[n][1] for n in plan)
    checks["tokens_in_vocab"] = checks["all_answered"] and all(
        0 <= t < cfg.vocab_size for n in plan for t in results[n])
    checks["preempted"] = stats["preempted"] >= 1
    checks["prefill_chunks_3"] = stats["prefill_chunks"] >= 3
    checks["prefix_hit"] = stats.get("prefix", {}).get("hits", 0) >= 1
    checks["pages_returned"] = (
        stats["active"] == stats["prefilling"] == stats["queued"] == 0
        and stats["pages_free"] + stats["pages_pinned"]
        == geo["pool_pages"])
    checks["flash_launches_per_full_wave"] = (
        stats["prefill_waves"] > 0
        and counts["flash_fwd"] == cfg.n_layers * stats["prefill_waves"])
    checks["flash_fwd_on_wgmma"] = all_on_wgmma(by_kernel,
                                                counts["flash_fwd"], device)
    if samples:
        frag = [f for f, _ in samples]
        out["kv_fragmentation"] = {"mean": sum(frag) / len(frag),
                                   "max": max(frag), "steps": len(frag)}
        out["pages_free_min"] = min(p for _, p in samples)
    if checks["all_answered"]:
        out["ttft_s"] = {n: token_times[n][0] - submitted[n] for n in plan}
        out["stream_decode_tok_s"] = {
            n: (len(ts) - 1) / (ts[-1] - ts[0])
            for n, ts in token_times.items() if len(ts) > 1}
        out["engine_tok_s"] = stats["tokens_out"] / (t_end - t_start)
        agree = {}
        for n, (toks, k, temp) in plan.items():
            if temp > 0:
                continue
            want, margins = _solo_greedy(eng, toks, k)
            agree[n] = _agrees(results[n], want, margins, MARGIN_TOL)
        out["greedy_positions_compared"] = agree
        # The source's prefix entry: the largest power of two <= 1100
        # tokens, whole 64-token pages.
        drift = _paged_drift(eng, plan, shared, plan["p8_prefix_hit"][0],
                             1024)
        out["logit_drift"] = drift
        checks["greedy_agrees_with_solo"] = (
            all(v >= 0 for v in agree.values())
            and max(drift.values()) < MARGIN_TOL)
    out["slo"] = slo_line(slo("serve_paged"))
    checks["slo_completed"] = (
        out["slo"]["outcomes"].get("completed") == len(plan))
    out["margin_tol"] = MARGIN_TOL
    out["checks"] = checks
    if torch.device(device).type == "cuda":
        out["device"] = smi_line()
    out["ok"] = all(checks.values()) and len(checks) == 11
    dep.shutdown()
    return out


# The serve_spec phase's pools, draft and requests (see the module
# docstring). The draft pool holds 3072 tokens for prompts of 4920.
SPEC_SERVE = dict(slots=8, capacity=2048, page_tokens=64, pool_pages=128,
                  draft="1b", k=4, draft_pool_pages=48)


def _verify_drift(engine, prompt, k) -> float:
    """Max |logit| difference between one slot's ``paged_verify`` logits
    at its k + 1 positions and k + 1 sequential ``paged_decode_step``s of
    the same tokens, on the deployment's weights, through one pool with
    shuffled page ids (the decode steps rewrite each position before they
    read it)."""
    from ray_tpu_torch.models import llama_decode as ld

    cfg, dev, params = engine.config, engine.device, engine.params
    T, pages = engine.page_tokens, engine.slot_pages_max
    bt = torch.as_tensor(np.random.default_rng(2).permutation(
        np.arange(1, pages + 1)), dtype=torch.int32, device=dev)[None]
    s = len(prompt)
    bucket = ld.cache_bucket(s, engine.prefill_bucket)
    toks = torch.zeros(1, bucket, dtype=torch.long, device=dev)
    toks[0, :s] = torch.as_tensor(prompt, device=dev)
    pool = ld.init_page_pool(cfg, pages, T, device=dev)
    lengths = torch.tensor([s], dtype=torch.int32, device=dev)
    logits, pool = ld.paged_prefill(params, toks, pool,
                                    bt[:, :-(-bucket // T)], cfg,
                                    lengths=lengths)
    row = [int(torch.argmax(logits[0]))]
    row += np.random.default_rng(3).integers(1, cfg.vocab_size, k).tolist()
    row = torch.tensor([row], dtype=torch.int32, device=dev)
    width = bt[:, :-(-(s + k + 1) // T)]
    verify, pool = ld.paged_verify(params, row, pool, width, cfg, lengths)
    drift = 0.0
    for j in range(k + 1):
        step, pool, lengths = ld.paged_decode_step(params, pool, width,
                                                   lengths, row[:, j], cfg)
        drift = max(drift, float((step[0] - verify[0, j]).abs().max()))
    del pool
    return drift


def _drive_engine(engine, plan) -> dict:
    """Submit every request of ``plan`` to an engine and step it by hand
    until all end: name -> request."""
    reqs = {n: engine.submit(toks, max_new_tokens=m)
            for n, (toks, m, _) in plan.items()}
    for _ in range(100_000):
        if all(r.done.is_set() for r in reqs.values()):
            break
        engine.step()
    return reqs


def _perfect_draft(cfg, params, plan, solo, device) -> dict:
    """A DecodeEngine whose draft is the target itself (k = 4, 4 slots)
    against a plain paged engine on the same requests and weights."""
    from ray_tpu_torch.serve.decode import DecodeEngine

    geo = SPEC_SERVE
    kw = dict(slots=4, capacity=geo["capacity"],
              page_tokens=geo["page_tokens"], pool_pages=64, device=device)
    out, streams = {}, {}
    for mode, extra in (("plain", {}),
                        ("spec", dict(spec_draft_params=params,
                                      spec_draft_config=cfg,
                                      spec_k=geo["k"]))):
        engine = DecodeEngine(params, cfg, **kw, **extra)
        _sync(device)
        t0 = time.perf_counter()
        reqs = _drive_engine(engine, plan)
        _sync(device)
        wall = time.perf_counter() - t0
        s = engine.stats()
        out[mode] = {"wall_s": wall, "steps": engine.steps,
                     "tokens_out": s["tokens_out"],
                     "engine_tok_s": s["tokens_out"] / wall,
                     "completed": all(r.status == "completed"
                                      for r in reqs.values())}
        if mode == "spec":
            out[mode]["spec"] = s["spec"]
        streams[mode] = {n: r.output for n, r in reqs.items()}
        del engine
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    out["greedy_positions_compared"] = {
        mode: {n: _agrees(streams[mode][n], *solo[n], MARGIN_TOL)
               for n in plan} for mode in streams}
    return out


def phase_serve_spec(cfg, device="cuda", draft=None) -> dict:
    """Llama-2-7B behind a speculative ``LlamaDecodeDeployment`` with the
    1B preset as its draft (seed 1, random weights like the target's),
    k = 4, 8 slots of 2048 tokens on 128 pages of 64, a draft pool of 48
    pages, the device sampler and warmup. Seven requests sent before the
    first can finish: greedy prompts of 20, 300, 700, 900, 1100 and 1500
    tokens with 32 new tokens each and a 400-token prompt at temperature
    0.8 with 16. Then the verify's drift against decode steps, and a
    draft equal to the target against a plain paged engine."""
    from ray_tpu_torch.serve.decode import LlamaDecodeDeployment

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    geo = SPEC_SERVE
    k = geo["k"]
    t0 = time.perf_counter()
    dep = LlamaDecodeDeployment(
        config=cfg, slots=geo["slots"], capacity=geo["capacity"], seed=0,
        kv_page_tokens=geo["page_tokens"], kv_pool_pages=geo["pool_pages"],
        spec_draft_model=draft or geo["draft"], spec_k=k,
        spec_draft_pool_pages=geo["draft_pool_pages"], device_sampler=True,
        warmup=True, metrics_deployment="serve_spec", device=device)
    _sync(device)
    init_s = time.perf_counter() - t0
    eng = dep.engine
    checks = {}
    checks["warmup_keys"] = {
        ("decode",), ("decode_sampled",), ("spec_draft", k),
        ("spec_verify", k), ("paged_prefill", 1, 128)} <= eng._compiled
    checks["warmup_idle_pools"] = (
        not eng.cache["length"].any() and not eng._draft_cache["length"].any()
        and eng.stats()["pages_free"] == geo["pool_pages"]
        and eng.stats()["spec"]["draft_pages_free"]
        == geo["draft_pool_pages"])
    rng = np.random.default_rng(2)

    def prompt(n):
        return rng.integers(1, cfg.vocab_size, n).tolist()

    plan = {  # name -> (prompt, max_new_tokens, temperature)
        "s1_short": (prompt(20), 32, 0.0),
        "s2": (prompt(300), 32, 0.0),
        "s3": (prompt(700), 32, 0.0),
        "s4": (prompt(900), 32, 0.0),
        "s5": (prompt(1100), 32, 0.0),
        "s6_long": (prompt(1500), 32, 0.0),
        "s7_sampled": (prompt(400), 16, 0.8),
    }
    results, errors, token_times, submitted = {}, {}, {}, {}

    def run(name):
        toks, n, temp = plan[name]
        try:
            got, times = [], []
            submitted[name] = time.perf_counter()
            for tok in dep({"tokens": toks, "max_new_tokens": n,
                            "temperature": temp, "stream": True}):
                times.append(time.perf_counter())
                got.append(tok)
            token_times[name] = times
            results[name] = got
        except Exception as e:  # reported as a failed phase below
            errors[name] = f"{type(e).__name__}: {e}"

    resyncs = []
    resync = eng._draft_resync

    def counted_resync(slot, req):
        resyncs.append(slot)
        return resync(slot, req)

    eng._draft_resync = counted_resync
    reset_counts()
    fwd0 = fwd_kernel_counts(device)
    t_start = time.perf_counter()
    threads = [threading.Thread(target=run, args=(n,)) for n in plan]
    for t in threads:
        t.start()
    for t in threads:
        t.join(REQUEST_TIMEOUT_S)
    _sync(device)
    t_end = time.perf_counter()
    # Stop the loop before reading its state: a request's stream ends
    # before the loop records the step that finished it.
    dep.shutdown()
    counts = launch_counts()
    by_kernel = fwd_kernels_since(fwd0, device)
    stats = eng.stats()
    spec = stats["spec"]
    timeline = eng.timeline()
    hung = [t.name for t in threads if t.is_alive()]
    phases = [p for row in timeline["rows"] for p in row["phases"]]
    host_ms = {name: sorted(1e3 * (p["t1"] - p["t0"]) for p in phases
                            if p["phase"] == name)
               for name in ("draft", "verify", "decode", "draft-prefill")}
    out = {"init_s": init_s, "wall_s": t_end - t_start, "geometry": geo,
           "launches": counts, "flash_fwd_by_kernel": by_kernel,
           "engine": stats, "resyncs": len(resyncs), "errors": errors,
           "hung_threads": hung,
           "timeline_rows": len(timeline["rows"]),
           "timeline_dropped": timeline["dropped"],
           "phase_host_ms_median": {n: v[len(v) // 2] if v else None
                                    for n, v in host_ms.items()},
           "phase_count": {n: len(v) for n, v in host_ms.items()}}
    checks["all_answered"] = (not errors and not hung
                              and set(results) == set(plan))
    checks["token_counts"] = checks["all_answered"] and all(
        len(results[n]) == plan[n][1] for n in plan)
    checks["tokens_in_vocab"] = checks["all_answered"] and all(
        0 <= t < cfg.vocab_size for n in plan for t in results[n])
    checks["spec_rounds"] = spec["rounds"] > 0
    checks["draft_demoted_or_evicted"] = spec["draft_demotions"] >= 1
    checks["resynced"] = len(resyncs) >= 1
    checks["pages_returned"] = (
        stats["active"] == stats["prefilling"] == stats["queued"] == 0
        and stats["pages_free"] + stats["pages_pinned"]
        == geo["pool_pages"]
        and spec["draft_pages_free"] == geo["draft_pool_pages"])
    checks["flash_launches_per_full_wave"] = (
        stats["prefill_waves"] > 0
        and counts["flash_fwd"] == cfg.n_layers * stats["prefill_waves"])
    checks["flash_fwd_on_wgmma"] = all_on_wgmma(by_kernel,
                                                counts["flash_fwd"], device)
    verify = [p for p in phases if p["phase"] == "verify"]
    checks["timeline_draft_verify"] = (
        bool(host_ms["draft"]) and bool(verify)
        and all("accepted" in p for p in verify))
    solo = {}
    if checks["all_answered"]:
        out["ttft_s"] = {n: token_times[n][0] - submitted[n] for n in plan}
        out["engine_tok_s"] = stats["tokens_out"] / (t_end - t_start)
        agree = {}
        for n, (toks, m, temp) in plan.items():
            if temp > 0:
                continue
            solo[n] = _solo_greedy(eng, toks, m)
            agree[n] = _agrees(results[n], *solo[n], MARGIN_TOL)
        out["greedy_positions_compared"] = agree
        checks["greedy_agrees_with_solo"] = all(
            v >= 0 for v in agree.values())
    out["slo"] = slo_line(slo("serve_spec"))
    checks["slo_completed"] = (
        out["slo"]["outcomes"].get("completed") == len(plan))
    drift = _verify_drift(eng, plan["s5"][0], k)
    out["verify_drift"] = drift
    checks["verify_drift_under_tol"] = drift < MARGIN_TOL
    # (c) A draft equal to the target, on four of the greedy requests.
    params = eng.params
    del dep, eng, resync
    sub = {n: plan[n] for n in ("s1_short", "s2", "s3", "s5")}
    if all(n in solo for n in sub):
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        perfect = _perfect_draft(cfg, params, sub, solo, device)
        out["perfect_draft"] = perfect
        pspec = perfect["spec"]["spec"]
        checks["perfect_accept_rate"] = (pspec["accept_rate"] or 0) >= 0.5
        checks["perfect_rounds_half_of_plain_steps"] = (
            2 * pspec["rounds"] <= perfect["plain"]["steps"])
        checks["perfect_streams_agree"] = (
            perfect["plain"]["completed"] and perfect["spec"]["completed"]
            and all(v >= 0 for m in perfect["greedy_positions_compared"]
                    .values() for v in m.values()))
    out["margin_tol"] = MARGIN_TOL
    out["checks"] = checks
    if torch.device(device).type == "cuda":
        out["device"] = smi_line()
    out["ok"] = all(checks.values()) and len(checks) == 18
    return out


# The serve_disagg phase's two deployments (see the module docstring): the
# prefill side's pool is serve_paged's, the decode side's serve_spec's.
DISAGG_SERVE = dict(slots=8, capacity=2048, page_tokens=64,
                    prefill_pool_pages=64, decode_pool_pages=128, chunk=512,
                    ttl_s=1.0)
# PCIe Gen5 x16, nominal rate a direction: what a host-staged handoff
# between two cards would cross (this phase's two deployments share one).
PCIE5_X16_NOMINAL_GBS = 64.0


def phase_serve_disagg(cfg, device="cuda") -> dict:
    """Disaggregated prefill/decode at Llama-2-7B: a prefill deployment
    (64 pages of 64 tokens, 512-token chunks) and a decode deployment (8
    slots of 2048 tokens on 128 pages), both from seed 0 with the device
    sampler. Seven requests from threads, each through ``prefill_handoff``
    then ``decode_adopted`` (one sampled stream through
    ``stream_adopted``), the lease discharged after the adopt as the
    JAX router does: greedy prompts of 20, 300, 700, 1100 and 1500 tokens
    with 32 new tokens, a sharer of the 1100 prompt's first 1061 tokens
    plus 200 sent after that prompt's descriptor returns (a prefix hit on
    the prefill side), and 400 tokens at temperature 0.8 with 16. Then a
    descriptor whose adopt is refused (page_tokens altered) and aborted,
    and one lease left to expire through the TTL sweep."""
    from ray_tpu_torch.core import api
    from ray_tpu_torch.core.config import config as rt_config
    from ray_tpu_torch.core.errors import HandoffAdoptError
    from ray_tpu_torch.serve.decode import LlamaDecodeDeployment

    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    geo = DISAGG_SERVE
    common = dict(config=cfg, slots=geo["slots"], capacity=geo["capacity"],
                  seed=0, kv_page_tokens=geo["page_tokens"],
                  device_sampler=True, device=device)
    objects0 = len(api._store)
    t0 = time.perf_counter()
    # The prefill side's ledger takes a 1 s TTL (read at construction) so
    # the phase can let one lease expire; the sweep runs only when
    # replica_metrics is read, after every other lease is discharged.
    ttl = rt_config.serve_handoff_ttl_s
    rt_config.serve_handoff_ttl_s = geo["ttl_s"]
    try:
        pre = LlamaDecodeDeployment(
            **common, kv_pool_pages=geo["prefill_pool_pages"],
            prefill_chunk_tokens=geo["chunk"], metrics_deployment="prefill")
    finally:
        rt_config.serve_handoff_ttl_s = ttl
    dec = LlamaDecodeDeployment(**common,
                                kv_pool_pages=geo["decode_pool_pages"],
                                metrics_deployment="decode")
    _sync(device)
    init_s = time.perf_counter() - t0
    peng, deng = pre.engine, dec.engine
    rng = np.random.default_rng(3)

    def prompt(n):
        return rng.integers(1, cfg.vocab_size, n).tolist()

    shared = prompt(1100)
    plan = {  # name -> (prompt, max_new_tokens, temperature)
        "d1_short": (prompt(20), 32, 0.0),
        "d2": (prompt(300), 32, 0.0),
        "d3": (prompt(700), 32, 0.0),
        "d4_shared_src": (shared, 32, 0.0),
        "d5_long": (prompt(1500), 32, 0.0),
        "d6_sampled_stream": (prompt(400), 16, 0.8),
        "d7_prefix_hit": (shared[:1061] + prompt(200), 32, 0.0),
    }
    check_pages_of = "d3"
    capture, adopt, pages_equal = {}, {}, {}
    capture_fn, seat_fn = peng._capture_handoff, deng._seat_adopted

    def timed_capture(req, slot, first_token):
        # On the prefill loop's thread: the copy to the host, by the card.
        _sync(device)
        t = time.perf_counter()
        capture_fn(req, slot, first_token)
        _sync(device)
        capture[req.request_id] = (req.handoff["nbytes"],
                                   time.perf_counter() - t)

    def timed_seat(req):
        # On the decode loop's thread: the copy to the card and the
        # scatter into the pool; then one slot's pages against its payload.
        payload = req.adopt
        _sync(device)
        t = time.perf_counter()
        seated = seat_fn(req)
        _sync(device)
        if seated:
            adopt[req.request_id] = (payload["k"].nbytes
                                     + payload["v"].nbytes,
                                     time.perf_counter() - t)
            if req.request_id == f"dc-{check_pages_of}":
                ids = torch.as_tensor(deng._slot_pages[req.slot],
                                      device=deng.device)
                pages_equal[req.request_id] = all(
                    torch.equal(deng.cache[n][:, ids],
                                payload[n].to(deng.device))
                    for n in ("k", "v"))
        return seated

    peng._capture_handoff = timed_capture
    deng._seat_adopted = timed_seat
    results, descs, errors, times = {}, {}, {}, {}
    src_published = threading.Event()

    def run(name):
        toks, n, temp = plan[name]
        req = {"tokens": toks, "max_new_tokens": n, "temperature": temp}
        desc = None
        try:
            t = time.perf_counter()
            desc = pre.prefill_handoff({**req, "request_id": f"pf-{name}"})
            descs[name] = desc
            t_desc = time.perf_counter() - t
            if name == "d4_shared_src":
                src_published.set()
            dreq = {**req, "request_id": f"dc-{name}"}
            if temp > 0:
                got, t_first = [], None
                for tok in dec.stream_adopted(dreq, desc):
                    if t_first is None:
                        t_first = time.perf_counter() - t
                        pre.discharge_handoff(desc["handoff_id"])
                    got.append(tok)
            else:
                got = dec.decode_adopted(dreq, desc)["tokens"]
                t_first = None
                pre.discharge_handoff(desc["handoff_id"])
            times[name] = {"descriptor_s": t_desc,
                           "first_stream_token_s": t_first,
                           "done_s": time.perf_counter() - t}
            results[name] = got
        except Exception as e:  # reported as a failed phase below
            errors[name] = f"{type(e).__name__}: {e}"
            if desc is not None:
                pre.abort_handoff(desc["handoff_id"])
            src_published.set()

    reset_counts()
    fwd0 = fwd_kernel_counts(device)
    t_start = time.perf_counter()
    threads = [threading.Thread(target=run, args=(n,))
               for n in plan if n != "d7_prefix_hit"]
    for t in threads:
        t.start()
    # The prefill side's prefix index takes the source's pages when it
    # prefills: send the sharer once the source's descriptor is back.
    src_published.wait(REQUEST_TIMEOUT_S)
    later = threading.Thread(target=run, args=("d7_prefix_hit",))
    later.start()
    for t in threads + [later]:
        t.join(REQUEST_TIMEOUT_S)
    _sync(device)
    t_end = time.perf_counter()
    hung = [t.name for t in threads + [later] if t.is_alive()]
    # (a) An adopt the decode side must refuse, then the abort.
    refused = None
    req = {"tokens": prompt(100), "max_new_tokens": 4}
    desc = pre.prefill_handoff(req)
    try:
        dec.decode_adopted(req, {**desc,
                                 "page_tokens": geo["page_tokens"] // 2})
    except HandoffAdoptError as e:
        refused = str(e)
    pre.abort_handoff(desc["handoff_id"])
    # (b) A lease nobody discharges: expired by the sweep replica_metrics
    # runs once the TTL has passed.
    pre.prefill_handoff({"tokens": prompt(60), "max_new_tokens": 4})
    time.sleep(geo["ttl_s"] + 0.2)
    rm = pre.replica_metrics()
    # Stop both loops before reading their state.
    pre.shutdown()
    dec.shutdown()
    counts = launch_counts()
    by_kernel = fwd_kernels_since(fwd0, device)
    pstats, dstats = peng.stats(), deng.stats()
    summary = {"prefill": slo("prefill"), "decode": slo("decode")}
    books = summary["prefill"].get("handoffs", {})
    handoff = {}
    for name in plan:
        key = (f"pf-{name}", f"dc-{name}")
        if key[0] in capture and key[1] in adopt:
            (nb, tc), (_, ta) = capture[key[0]], adopt[key[1]]
            handoff[name] = {"payload_bytes": nb,
                             "capture_ms": 1e3 * tc,
                             "capture_gb_s": nb / tc / 1e9,
                             "adopt_ms": 1e3 * ta,
                             "adopt_gb_s": nb / ta / 1e9}
    out = {"init_s": init_s, "wall_s": t_end - t_start, "geometry": geo,
           "launches": counts, "flash_fwd_by_kernel": by_kernel,
           "prefill_engine": pstats, "decode_engine": dstats,
           "replica_metrics_prefill": rm, "errors": errors,
           "hung_threads": hung, "handoff": handoff,
           "pcie5_x16_nominal_gb_s_per_direction": PCIE5_X16_NOMINAL_GBS,
           "host_clock_s": times, "refused_adopt": refused,
           "handoff_latency_s": summary["prefill"].get("handoff_latency_s"),
           "handoff_descriptor_bytes": summary["prefill"].get(
               "handoff_bytes"),
           "handoff_events": books,
           "slo": {dep: slo_line(v) for dep, v in summary.items()}}
    checks = {}
    checks["all_answered"] = (not errors and not hung
                              and set(results) == set(plan))
    checks["token_counts"] = checks["all_answered"] and all(
        len(results[n]) == plan[n][1] for n in plan)
    checks["first_token_from_prefill"] = checks["all_answered"] and all(
        results[n][0] == descs[n]["first_token"] for n in plan)
    checks["adopted_pages_equal_payload"] = (
        pages_equal.get(f"dc-{check_pages_of}") is True)
    checks["decode_ran_no_prefill"] = (
        dstats["prefill_waves"] == dstats["suffix_waves"]
        == dstats["prefill_chunks"] == 0)
    checks["prefill_prefix_hit"] = (
        pstats.get("prefix", {}).get("hits", 0) >= 1)
    checks["flash_launches_per_full_wave"] = (
        pstats["prefill_waves"] > 0
        and counts["flash_fwd"] == cfg.n_layers * pstats["prefill_waves"])
    checks["flash_fwd_on_wgmma"] = all_on_wgmma(by_kernel,
                                                counts["flash_fwd"], device)
    checks["adopt_refused"] = refused is not None and "page_tokens" in refused
    checks["handoff_books_close"] = (
        books.get("published", 0) == len(plan) + 2
        and books.get("published") == books.get("adopted", 0)
        + books.get("aborted", 0) + books.get("expired", 0)
        and books.get("aborted") == 1 and books.get("expired") == 1)
    checks["ledger_drained"] = (
        rm["handoffs_live"] == 0 and rm["handoff_live_bytes"] == 0
        and pre._handoffs.live() == 0 and pre._handoffs.live_bytes() == 0)
    checks["refs_freed"] = len(api._store) == objects0
    checks["pages_returned"] = all(
        s["active"] == s["prefilling"] == s["queued"] == 0
        and s["pages_free"] + s["pages_pinned"] == s["pages_total"]
        for s in (pstats, dstats))
    dsum = summary["decode"]
    checks["slo_decode"] = (
        dsum.get("ttft_s", {}).get("count") == len(plan)
        and dsum.get("inter_token_s", {}).get("count") == len(plan)
        and dsum.get("outcomes", {}).get("completed") == len(plan))
    if checks["all_answered"]:
        out["engine_tok_s"] = dstats["tokens_out"] / (t_end - t_start)
        agree = {}
        for n, (toks, m, temp) in plan.items():
            if temp > 0:
                continue
            agree[n] = _agrees(results[n], *_solo_greedy(deng, toks, m),
                               MARGIN_TOL)
        out["greedy_positions_compared"] = agree
        checks["greedy_agrees_with_solo"] = all(
            v >= 0 for v in agree.values())
    out["margin_tol"] = MARGIN_TOL
    out["checks"] = checks
    if torch.device(device).type == "cuda":
        out["device"] = smi_line()
    out["ok"] = all(checks.values()) and len(checks) == 15
    return out


# Flash vs plain-attention gradients of the 2-layer check: the relative L2
# norm of their difference, per parameter. Both round P (and the flash path
# dS) to bf16, at other points of the sums, through two layers of bf16
# activations.
GRAD_REL_TOL = 5e-2


# ------------------------------------------------------------ serve_mesh


def _drive_steps(engine, plan, device) -> dict:
    """serve_paged's requests through ``engine.step()`` on one schedule:
    seven submitted before the first step, the prefix sharer before the
    first step after the source's first token, then steps until all end.
    Each step is timed on the host clock (a step ends on a device-to-host
    copy of its tokens, so the clock covers its device work); a decode
    step is one that ran no prefill wave or chunk."""
    reqs = {n: engine.submit(plan[n][0], max_new_tokens=plan[n][1],
                             temperature=plan[n][2], request_id=n)
            for n in plan if n != "p8_prefix_hit"}
    steps, decode_steps = [], []
    t_start = time.perf_counter()
    for _ in range(2000):
        if "p8_prefix_hit" not in reqs and reqs["p1_shared_src"].output:
            n = "p8_prefix_hit"
            reqs[n] = engine.submit(plan[n][0], max_new_tokens=plan[n][1],
                                    temperature=plan[n][2], request_id=n)
        if len(reqs) == len(plan) and all(r.done.is_set()
                                          for r in reqs.values()):
            break
        s0 = engine.stats()
        t0 = time.perf_counter()
        engine.step()
        dt = time.perf_counter() - t0
        s1 = engine.stats()
        steps.append(dt)
        if all(s1[k] == s0[k] for k in ("prefill_waves", "suffix_waves",
                                        "prefill_chunks")):
            decode_steps.append(dt)
    _sync(device)
    wall = time.perf_counter() - t_start
    stats = engine.stats()
    return {"streams": {n: list(r.output) for n, r in reqs.items()},
            "status": {n: r.status for n, r in reqs.items()},
            "ttft_s": {n: r.first_token_at - r.submitted_at
                       for n, r in reqs.items()
                       if r.first_token_at is not None},
            "wall_s": wall, "steps": len(steps),
            "step_ms_mean": 1e3 * sum(steps) / max(1, len(steps)),
            "decode_step_ms_median": (
                1e3 * sorted(decode_steps)[len(decode_steps) // 2]
                if decode_steps else None),
            "decode_steps": len(decode_steps),
            "tokens_out": stats["tokens_out"],
            "tok_s": stats["tokens_out"] / wall, "engine": stats}


def _first_difference(got: dict, want: dict) -> dict:
    """Each request's first position where two runs' streams differ."""
    out = {}
    for n in want:
        a, b = got.get(n, []), want[n]
        diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
        if diff or len(a) != len(b):
            out[n] = diff[0] if diff else min(len(a), len(b))
    return out


# The serve_mesh phase's runs, in turns so that neither engine always
# runs first on a warmer card.
MESH_RUN_ORDER = ("meshless", "mesh", "mesh", "meshless")


def phase_serve_mesh(cfg, device="cuda") -> dict:
    """Llama-2-7B served by one ``DecodeEngine`` replica over a (1, 1)
    decode mesh at world size 1 (NCCL on the card, in process), beside the
    mesh-less engine on the same weights, serve_paged's geometry (8 slots
    of 2048 on 64 pages of 64 tokens, 512-token chunks, the device
    sampler) and serve_paged's eight requests on one step schedule
    (``_drive_steps``), so every run sees the same waves. Four runs in
    turns (``MESH_RUN_ORDER``). Every stream must equal the first
    mesh-less run's token for token (the mesh's functions run on local
    shards, which at (1, 1) are the whole weights: the same launches);
    every run launches the flash forward 32 times per full prefill wave,
    all on wgmma. Prints each run's mean and decode step time, tokens/s
    and ``slo_summary``, and the mesh's lockstep messages; the path's
    launches are the first mesh run's."""
    import torch.distributed as dist

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.parallel.mesh import init_distributed
    from ray_tpu_torch.serve.decode import DecodeEngine

    gc.collect()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
    geo = PAGED_SERVE
    t0 = time.perf_counter()
    params = llama.init_params(cfg, device=device, seed=0)
    _sync(device)
    init_s = time.perf_counter() - t0
    plan = _paged_plan(cfg)
    init_distributed(0, 1, device_type=device)
    runs = []
    try:
        for i, name in enumerate(MESH_RUN_ORDER):
            tag = f"serve_mesh_{name}_{i}"
            eng = DecodeEngine(
                params, cfg, slots=geo["slots"], capacity=geo["capacity"],
                page_tokens=geo["page_tokens"], pool_pages=geo["pool_pages"],
                prefill_chunk_tokens=geo["chunk"], device_sampler=True,
                metrics_deployment=tag, device=device,
                **({"mesh_shape": (1, 1)} if name == "mesh" else {}))
            reset_counts()
            fwd0 = fwd_kernel_counts(device)
            run = _drive_steps(eng, plan, device)
            run.update(name=name, launches=launch_counts(),
                       flash_fwd_by_kernel=fwd_kernels_since(fwd0, device),
                       slo=slo_line(slo(tag)))
            if name == "mesh":
                run["lockstep_messages"] = eng._ctl.sent
                run["backend"] = dist.get_backend()
            runs.append(run)
            eng.shutdown()
            del eng
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    del params
    base = runs[0]
    mesh = [r for r in runs if r["name"] == "mesh"]
    diffs = [_first_difference(r["streams"], base["streams"])
             for r in runs[1:]]

    def median(name, key):
        xs = sorted(r[key] for r in runs if r["name"] == name)
        return (xs[0] + xs[-1]) / 2

    out = {"init_s": init_s, "geometry": geo, "mesh_shape": [1, 1],
           "world_size": 1, "order": list(MESH_RUN_ORDER),
           "runs": [{k: v for k, v in r.items() if k != "streams"}
                    for r in runs],
           "first_difference": diffs,
           "launches": mesh[0]["launches"],
           "flash_fwd_by_kernel": mesh[0]["flash_fwd_by_kernel"]}
    out["mesh_vs_meshless"] = {
        key: median("mesh", key) / median("meshless", key)
        for key in ("decode_step_ms_median", "step_ms_mean", "tok_s")}
    checks = {}
    checks["all_completed"] = all(
        set(r["status"]) == set(plan)
        and all(v == "completed" for v in r["status"].values())
        and all(len(r["streams"][k]) == plan[k][1] for k in plan)
        and r["slo"]["outcomes"].get("completed") == len(plan)
        for r in runs)
    checks["flash_launches_per_full_wave"] = all(
        r["engine"]["prefill_waves"] > 0
        and r["launches"]["flash_fwd"]
        == cfg.n_layers * r["engine"]["prefill_waves"] for r in runs)
    checks["flash_fwd_on_wgmma"] = all(
        all_on_wgmma(r["flash_fwd_by_kernel"], r["launches"]["flash_fwd"],
                     device) for r in runs)
    checks["streams_equal"] = not any(diffs)
    checks["same_waves"] = all(
        r["engine"][k] == base["engine"][k] for r in runs
        for k in ("prefill_waves", "suffix_waves", "prefill_chunks",
                  "preempted", "steps"))
    checks["mesh_stats"] = all(r["engine"]["chips"] == 1
                               and r["engine"]["mesh_shape"] == [1, 1]
                               for r in mesh)
    checks["lockstep_a_message_a_step"] = all(
        r["lockstep_messages"] == r["steps"] for r in mesh)
    checks["backend"] = all(r["backend"] == ("nccl" if cuda else "gloo")
                            for r in mesh)
    if cuda:
        out["device"] = smi_line()
    out["checks"] = checks
    out["ok"] = all(checks.values())
    return out


def _grad_check(cfg, device, b, s) -> dict:
    """The same width at 2 layers: gradients of ``loss_fn`` with
    ``attention_impl="flash"`` against ``"xla"`` (plain PyTorch)."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.optim import tree_leaves
    from ray_tpu_torch.parallel.train_step import value_and_grad

    cfg2 = replace(cfg, n_layers=2)
    params = llama.init_params(cfg2, device=device, dtype=torch.float32,
                               seed=1)
    g = torch.Generator(device=device).manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s + 1),
                                     generator=g, device=device)}
    def run(impl):
        c = replace(cfg2, attention_impl=impl)
        return value_and_grad(lambda p, b_: llama.loss_fn(p, b_, c), params,
                              batch)

    loss_f, grads_f = run("flash")
    loss_x, grads_x = run("xla")
    rel = [float((a - b_).norm() / b_.norm().clamp_min(1e-30))
           for a, b_ in zip(tree_leaves(grads_f), tree_leaves(grads_x))]
    return {"shape": {"B": b, "S": s, "n_layers": 2},
            "loss_flash": float(loss_f), "loss_xla": float(loss_x),
            "max_grad_rel_norm_diff": max(rel), "tol": GRAD_REL_TOL,
            "ok": max(rel) <= GRAD_REL_TOL and math.isfinite(sum(rel))}


def phase_train(cfg, device="cuda", batch=8, seq=2048, steps=4,
                accum_steps=2, check_batch=1, check_seq=1024) -> dict:
    """``steps`` AdamW steps of ``cfg`` through ``build_train_step`` on one
    fixed batch of ``batch`` x (``seq`` + 1) random tokens, in
    ``accum_steps`` microbatches, with per-step launch counts; then the
    flash-vs-plain gradient check."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.optim import adamw
    from ray_tpu_torch.parallel import train_step

    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    params = train_step.init_sharded_params(
        lambda seed: llama.init_params(cfg, device=device,
                                       dtype=torch.float32, seed=seed),
        llama.param_axes(cfg), key=0)
    opt = adamw(3e-4, weight_decay=0.1)
    opt_state = train_step.init_optimizer_state(opt, params)
    step = train_step.build_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg), opt, accum_steps=accum_steps)
    g = torch.Generator(device=device).manual_seed(0)
    data = {"tokens": torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                                    generator=g, device=device)}
    _sync(device)
    init_s = time.perf_counter() - t0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    want = {**{k: 0 for k in KERNELS},
            "flash_fwd": 2 * cfg.n_layers * accum_steps,
            "flash_bwd_dkv": cfg.n_layers * accum_steps,
            "flash_bwd_dq": cfg.n_layers * accum_steps,
            "attention_delta": cfg.n_layers * accum_steps}
    losses, norms, times, per_step = [], [], [], []
    total = {k: 0 for k in want}
    by_kernel: dict = {}
    bwd_by_kernel: dict = {}
    on_wgmma = bwd_on_wgmma = True
    for _ in range(steps):
        reset_counts()
        fwd0 = fwd_kernel_counts(device)
        bwd0 = bwd_kernel_counts(device)
        t = time.perf_counter()
        params, opt_state, m = step(params, opt_state, data)
        _sync(device)
        times.append(time.perf_counter() - t)
        counts = launch_counts()
        step_by_kernel = fwd_kernels_since(fwd0, device)
        step_bwd = bwd_kernels_since(bwd0, device)
        on_wgmma = on_wgmma and all_on_wgmma(step_by_kernel,
                                             counts["flash_fwd"], device)
        bwd_on_wgmma = bwd_on_wgmma and all_bwd_on_wgmma(
            step_bwd, counts["flash_bwd_dkv"], counts["flash_bwd_dq"],
            device)
        per_step.append(counts)
        for k in total:
            total[k] += counts[k]
        for k, n in step_by_kernel.items():
            by_kernel[k] = by_kernel.get(k, 0) + n
        for k, n in step_bwd.items():
            bwd_by_kernel[k] = bwd_by_kernel.get(k, 0) + n
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    peak = torch.cuda.max_memory_allocated() if cuda else None
    del params, opt_state, step, data
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    steady = times[1:] or times
    step_s = sum(steady) / len(steady)
    tokens = batch * seq
    out = {"config": {"preset_width": {"dim": cfg.dim,
                                       "n_layers": cfg.n_layers,
                                       "n_heads": cfg.n_heads,
                                       "n_kv_heads": cfg.n_kv_heads,
                                       "mlp_dim": cfg.mlp_dim},
                      "num_params": cfg.num_params(),
                      "attention_impl": cfg.attention_impl,
                      "remat_policy": cfg.remat_policy if cfg.remat
                      else None, "loss_chunk": cfg.loss_chunk,
                      "batch": batch, "seq": seq,
                      "accum_steps": accum_steps},
           "init_s": init_s, "losses": losses, "grad_norms": norms,
           "step_s": times, "launches": total,
           "flash_fwd_by_kernel": by_kernel,
           "flash_bwd_by_kernel": bwd_by_kernel,
           "launches_per_step": per_step, "launches_want": want}
    checks = {
        "finite": all(math.isfinite(x) for x in losses + norms),
        "loss_falls": losses[-1] < losses[0],
        "launches_per_step_exact": all(c == want for c in per_step),
        "flash_fwd_on_wgmma": on_wgmma,
        "flash_bwd_on_wgmma": bwd_on_wgmma,
    }
    if cuda:
        out["device"] = smi_line()
        out["steady_step_s"] = step_s
        out["tokens_per_s"] = tokens / step_s
        out["mfu_bf16_peak"] = (llama.flops_per_token(cfg, seq) * tokens
                                / (step_s * PEAK_BF16_FLOPS))
        out["peak_memory_bytes"] = peak
    check = _grad_check(cfg, device, check_batch, check_seq)
    checks["flash_grads_match_plain"] = check.pop("ok")
    out["grad_check"] = check
    out["checks"] = checks
    out["ok"] = all(checks.values())
    return out


# The ViT-B/16 train loop (``bench.py``'s ViT workload): batch, steps (the
# first a warm-up), the prefetch depth.
VIT_TRAIN = dict(batch=256, steps=6, prefetch=2)
# Port on the card against port on the CPU at the debug size in float32,
# TF32 off: logits and gradients within this share of their max |value|
# (the same math, fp32 sums in another order).
VIT_F32_TOL = 1e-4
# pad_tokens_to against no padding on the card, ViT-B/16 width, B = 4:
# float32 at the tolerance above, bf16 at the JAX package's test's 2e-2
# (cuBLAS picks its kernels by shape, so the bf16 roundings differ).
VIT_PAD_BF16_TOL = 2e-2


def _steady(xs: list) -> float:
    """The mean past the first (warm-up) entry."""
    xs = xs[1:] or xs
    return sum(xs) / len(xs)


def _vit_host_batches(cfg, batch: int, n: int, seed: int) -> list:
    """``n`` host batches of float32 NHWC images and int64 labels, made
    with numpy from ``seed`` before the loop (set-up, not ingest)."""
    rng = np.random.default_rng(seed)
    shape = (batch, cfg.image_size, cfg.image_size, cfg.channels)
    return [{"images": rng.standard_normal(shape, dtype=np.float32),
             "labels": rng.integers(0, cfg.num_classes, batch)}
            for _ in range(n)]


def _checksum(images, labels):
    """Integer sums of the images' bits and of the labels, exact on the
    host (numpy) and on the card (torch) alike."""
    if isinstance(images, np.ndarray):
        return (int(images.view(np.int32).sum(dtype=np.int64)),
                int(labels.sum()))
    return torch.stack([images.view(torch.int32).sum(dtype=torch.int64),
                        labels.sum()])


def _max_rel(got, want) -> float:
    return float((got.float().cpu() - want.float().cpu()).abs().max()
                 / want.float().abs().max().clamp_min(1e-30))


def _vit_cpu_check(device) -> dict:
    """The debug preset in float32 with a random head: logits and every
    gradient on ``device`` against the CPU."""
    from ray_tpu_torch.models import vit
    from ray_tpu_torch.ops.optim import tree_leaves, tree_map
    from ray_tpu_torch.parallel.train_step import value_and_grad

    cfg = replace(vit.PRESETS["debug"], dtype=torch.float32)
    params = vit.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    params["head"].normal_(std=cfg.dim ** -0.5,
                           generator=torch.Generator().manual_seed(1))
    host = _vit_host_batches(cfg, 8, 1, seed=2)[0]
    batch = {k: torch.from_numpy(v) for k, v in host.items()}

    def run(p, b):
        with torch.no_grad():
            logits = vit.forward(p, b["images"], cfg)
        loss, grads = value_and_grad(lambda p_, b_: vit.loss_fn(
            p_, b_, cfg)[0], p, b)
        return logits, loss, tree_leaves(grads)

    want = run(params, batch)
    got = run(tree_map(lambda t: t.to(device), params),
              tree_map(lambda t: t.to(device), batch))
    logits = _max_rel(got[0], want[0])
    grads = max(_max_rel(a, b) for a, b in zip(got[2], want[2]))
    return {"logits_max_rel": logits, "grads_max_rel": grads,
            "loss": float(got[1]), "loss_cpu": float(want[1]),
            "tol": VIT_F32_TOL,
            "ok": max(logits, grads) <= VIT_F32_TOL
            and abs(float(got[1]) - float(want[1]))
            <= VIT_F32_TOL * abs(float(want[1]))}


def _vit_pad_check(cfg, params, device, b=4) -> dict:
    """``pad_tokens_to=256`` logits against the unpadded ones at the
    config's width and depth, B = ``b``, with a random head, in float32 and
    in the config's dtype."""
    from ray_tpu_torch.models import vit

    g = torch.Generator(device=device).manual_seed(3)
    head = torch.randn(params["head"].shape, generator=g, device=device)
    p = dict(params, head=head * cfg.dim ** -0.5)
    images = torch.randn(b, cfg.image_size, cfg.image_size, cfg.channels,
                         generator=g, device=device)
    out = {"pad_tokens_to": 256, "tokens": cfg.num_patches, "batch": b}
    ok = True
    for name, dt, tol in (("f32", torch.float32, VIT_F32_TOL),
                          ("bf16", cfg.dtype, VIT_PAD_BF16_TOL)):
        c = replace(cfg, dtype=dt)
        with torch.no_grad():
            base = vit.forward(p, images, c)
            pad = vit.forward(p, images, replace(c, pad_tokens_to=256))
        err = _max_rel(pad, base)
        out[f"{name}_max_rel"] = err
        out[f"{name}_tol"] = tol
        ok = ok and err <= tol and bool(torch.isfinite(pad).all())
    out["ok"] = ok
    return out


def phase_vit(cfg, device="cuda", batch=None, steps=None,
              prefetch=None) -> dict:
    """ViT-B/16 (``cfg``) trained from fp32 masters (seed 0) with AdamW
    through ``build_train_step``, fed by ``device_prefetch`` from host
    batches; then the same number of steps on the same batches placed on
    the card beforehand, the port on the card against the CPU at the debug
    size, and ``pad_tokens_to`` against no padding."""
    from ray_tpu_torch.data import device_prefetch
    from ray_tpu_torch.models import vit
    from ray_tpu_torch.ops.optim import adamw, tree_leaves
    from ray_tpu_torch.parallel import train_step

    batch = batch or VIT_TRAIN["batch"]
    steps = steps or VIT_TRAIN["steps"]
    prefetch = prefetch or VIT_TRAIN["prefetch"]
    cuda = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    params = vit.init_params(
        cfg, torch.Generator(device=device).manual_seed(0), device=device)
    before = {k: params[k].clone() for k in ("patch_embed", "head")}
    before["wqkv"] = params["layers"]["wqkv"].clone()
    opt = adamw(3e-4, weight_decay=0.1)
    state = train_step.init_optimizer_state(opt, params)
    step = train_step.build_train_step(
        lambda p, b: vit.loss_fn(p, b, cfg)[0], opt)
    host = _vit_host_batches(cfg, batch, steps, seed=1)
    want_sums = [_checksum(h["images"], h["labels"]) for h in host]
    _sync(device)
    init_s = time.perf_counter() - t0

    def run(batches):
        nonlocal params, state
        losses, times, sums = [], [], []
        t = time.perf_counter()
        for b in batches:
            params, state, m = step(params, state, b)
            sums.append(_checksum(b["images"], b["labels"]))
            _sync(device)
            now = time.perf_counter()
            times.append(now - t)
            t = now
            losses.append(float(m["loss"]))
        return losses, times, [tuple(int(x) for x in s) for s in sums]

    reset_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    it = device_prefetch(iter(host), prefetch=prefetch, device=device)
    losses, times, got_sums = run(it)
    stats = it.stats()
    peak = torch.cuda.max_memory_allocated() if cuda else None
    # The yardstick: the same batches, already on the card.
    placed = [{k: torch.from_numpy(v).to(device) for k, v in h.items()}
              for h in host]
    _sync(device)
    placed_losses, placed_times, _ = run(placed)
    launches = launch_counts()
    moved = {k: not torch.equal(v, params["layers"]["wqkv"] if k == "wqkv"
                                else params[k]) for k, v in before.items()}
    finite = all(math.isfinite(x) for x in losses + placed_losses) and all(
        bool(torch.isfinite(t).all()) for t in tree_leaves(params))
    del before, placed, it
    cpu_check = _vit_cpu_check(device)
    pad_check = _vit_pad_check(cfg, params, device)
    del params, state, step
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    step_s, placed_s = _steady(times), _steady(placed_times)
    waits = stats["wait_s"]
    out = {"config": {"image_size": cfg.image_size,
                      "patch_size": cfg.patch_size, "dim": cfg.dim,
                      "n_layers": cfg.n_layers, "n_heads": cfg.n_heads,
                      "mlp_dim": cfg.mlp_dim,
                      "num_classes": cfg.num_classes,
                      "num_params": vit.num_params(cfg),
                      "dtype": str(cfg.dtype), "remat": cfg.remat,
                      "remat_policy": cfg.remat_policy, "batch": batch,
                      "steps": steps, "prefetch": prefetch,
                      "optimizer": "adamw(3e-4, weight_decay=0.1)"},
           "init_s": init_s, "losses": losses, "step_s": times,
           "placed_losses": placed_losses, "placed_step_s": placed_times,
           "prefetch_wait_s": waits,
           "prefetch": {k: v for k, v in stats.items() if k != "wait_s"},
           "cpu_check": cpu_check, "pad_check": pad_check,
           "launches": launches}
    checks = {
        "finite": finite,
        "params_moved": all(moved.values()),
        "device_batches_equal_host": got_sums == want_sums,
        "host_buffers_pinned": bool(stats.get("pinned")) or not cuda,
        "copies_on_side_stream": bool(stats.get("side_stream")) or not cuda,
        "card_matches_cpu_debug_f32": cpu_check.pop("ok"),
        "pad_tokens_to_matches": pad_check.pop("ok"),
        "no_hand_written_kernel_launched": not any(launches.values()),
    }
    if cuda:
        out["device"] = smi_line()
        out["steady_step_s"] = step_s
        out["images_per_s"] = batch / step_s
        out["mfu_bf16_peak"] = (vit.flops_per_image(cfg) * batch
                                / (step_s * PEAK_BF16_FLOPS))
        out["placed_steady_step_s"] = placed_s
        out["placed_images_per_s"] = batch / placed_s
        out["steady_prefetch_wait_s_mean"] = _steady(waits)
        out["h2d_gb_per_s"] = stats["h2d_gb_per_s"]
        out["peak_memory_bytes"] = peak
    out["checks"] = checks
    out["ok"] = all(checks.values())
    return out


# ----------------------------------------------------------------- mesh

# Mesh step against the mesh-less step on one card, bf16 compute: losses
# and gradient norms of the same two steps from the same weights and
# batches, relative. At world size 1 the DTensor step runs the same local
# products in the same order, so the numbers agree to the last bit; 1e-6
# leaves room for one rounding and still catches a step that drops one of
# its two microbatches (its loss is then the mean over other tokens) or
# scales the accumulated gradient by a factor off 1 by more than 1e-6.
MESH_REL_TOL = 1e-6
# The ring (1-rank, in the path and again timed), the loopback ring (4
# virtual shards, each hop's bf16 partial output merged in fp32) and
# Ulysses against the plain flash forward and backward, and the loopback
# against one full flash call, bf16: max |error| relative to max |value|
# for out, dq, dk and dv.
RING_BF16_TOL = 2e-2
# The 1B MoE model's depth cut for the mesh phase (see MOE_* below).
MOE_LAYERS = 4


def _mesh_train_run(cfg, variant, device, tokens, steps, accum_steps, mesh):
    """``steps`` AdamW(3e-4, wd 0.1) steps of ``cfg`` from seed-0 fp32
    masters on ``tokens``: mesh-less (``"plain"``), through
    ``build_train_step(mesh=...)`` (``"mesh"``) or through
    ``build_zero1_train_step`` (``"zero1"``); per-step losses, grad norms,
    times after a sync, launches, peak memory."""
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.optim import adamw
    from ray_tpu_torch.parallel import train_step as ts

    cuda = torch.device(device).type == "cuda"
    opt = adamw(3e-4, weight_decay=0.1)
    lf = lambda p, b: llama.loss_fn(p, b, cfg)  # noqa: E731
    init = lambda seed: llama.init_params(  # noqa: E731
        cfg, device=device, dtype=torch.float32, seed=seed)
    if variant == "plain":
        params = init(0)
        state = ts.init_optimizer_state(opt, params)
        step = ts.build_train_step(lf, opt, accum_steps=accum_steps)
        batch = {"tokens": tokens}
    elif variant == "mesh":
        params = ts.init_sharded_params(init, llama.param_axes(cfg), mesh, 0)
        state = ts.init_optimizer_state(opt, params)
        step = ts.build_train_step(lf, opt, mesh, accum_steps=accum_steps)
        batch = ts.shard_batch({"tokens": tokens}, mesh)
    else:
        params = init(0)
        state = ts.init_zero1_opt_state(opt, params, mesh)
        step = ts.build_zero1_train_step(lf, opt, mesh, params,
                                         accum_steps=accum_steps)
        batch = ts.shard_batch({"tokens": tokens}, mesh)
    _sync(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out = {"losses": [], "grad_norms": [], "step_s": [],
           "launches_per_step": []}
    for _ in range(steps):
        before = launch_counts()
        t = time.perf_counter()
        params, state, m = step(params, state, batch)
        _sync(device)
        out["step_s"].append(time.perf_counter() - t)
        now = launch_counts()
        out["launches_per_step"].append(
            {k: now[k] - before[k] for k in now})
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
    if variant != "plain":
        out["state_bytes_per_rank"] = ts.per_replica_state_bytes(state)
    if cuda:
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        tok = tokens.shape[0] * (tokens.shape[1] - 1)
        last = out["step_s"][-1]
        out["tokens_per_s"] = tok / last
    del params, state, step, batch
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def _ring_inputs(shape, device, seed=3):
    g = torch.Generator(device=device).manual_seed(seed)
    b, s, h, hkv, d = (shape[k] for k in ("b", "s", "h", "hkv", "d"))
    dt = torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32
    mk = lambda *sh: torch.randn(sh, generator=g, device=device,  # noqa
                                 dtype=torch.float32).to(dt)
    return mk(b, s, h, d), mk(b, s, hkv, d), mk(b, s, hkv, d), mk(b, s, h, d)


def _with_grads(fn, q, k, v, do):
    """``fn(q, k, v)``'s output and the q/k/v gradients of sum(out * do)."""
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    out = fn(q, k, v)
    out.backward(do)
    return [out.detach(), q.grad, k.grad, v.grad]


def _loopback_ring(q, k, v, n):
    """The package's ``ring_flash_attention_local`` run for each of ``n``
    virtual ranks in one process, K/V rotated by indexing (its ``ring``
    argument) instead of collectives. Returns the full (B, S, H, D)
    output."""
    import torch.nn.functional as F

    from ray_tpu_torch.parallel.ring_attention import (
        ring_flash_attention_local)

    sl = q.shape[1] // n
    pad = (-q.shape[-1]) % 128
    shard = lambda t, r: t[:, r * sl:(r + 1) * sl]  # noqa: E731

    def ring_of(rank):
        src = [rank]

        def rotate_fn(kv):
            src[0] = (src[0] - 1) % n
            kv = torch.stack([shard(k, src[0]), shard(v, src[0])])
            return F.pad(kv, (0, pad)).transpose(2, 3)

        return rank, n, rotate_fn

    return torch.cat([ring_flash_attention_local(
        shard(q, r), shard(k, r), shard(v, r), None, ring=ring_of(r))
        for r in range(n)], dim=1)


def _plain_attention(q, k, v, do):
    """[out, dq, dk, dv] of causal attention by the plain flash forward and
    backward (``flash_attention_reference``, ``flash_backward_reference``)."""
    from ray_tpu_torch.ops import flash_attention as fa

    out, lse = fa.flash_attention_reference(q, k, v, causal=True)
    return [out, *fa.flash_backward_reference(q, k, v, out, lse, do,
                                              causal=True)]


def _errs(got, want) -> dict:
    return {n: _rel_err(g, w) for n, g, w in
            zip(("out", "dq", "dk", "dv"), got, want)}


def _ring_checks(q, k, v, do, mesh, n_virtual, plain) -> dict:
    """(a) ``ring_attention(impl="flash")`` on the 1-rank mesh and (b) the
    loopback ring of ``n_virtual`` shards, forward and backward, each
    against ``plain`` (``_plain_attention`` on the same inputs); the
    loopback also against one full ``flash_attention`` call; with the
    launches of each and their times."""
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.parallel.ring_attention import ring_attention

    cuda = q.is_cuda
    full = lambda q_, k_, v_: flash_attention(q_, k_, v_)  # noqa: E731
    ring = lambda q_, k_, v_: ring_attention(  # noqa: E731
        q_, k_, v_, mesh, impl="flash")
    loop = lambda q_, k_, v_: _loopback_ring(q_, k_, v_, n_virtual)  # noqa
    flash = _with_grads(full, q, k, v, do)
    res = {"full_flash_rel_err_vs_plain": _errs(flash, plain)}
    for name, fn in (("ring_1rank", ring), ("loopback", loop)):
        before = launch_counts()
        fwd0, bwd0 = fwd_kernel_counts(q.device), bwd_kernel_counts(q.device)
        got = _with_grads(fn, q, k, v, do)
        _sync(q.device)
        now = launch_counts()
        res[name] = {"rel_err_vs_plain": _errs(got, plain),
                     "launches": {k_: now[k_] - before[k_] for k_ in now},
                     "fwd_by_kernel": fwd_kernels_since(fwd0, q.device),
                     "bwd_by_kernel": bwd_kernels_since(bwd0, q.device)}
        if name == "loopback":
            res[name]["rel_err_vs_flash"] = _errs(got, flash)
        if cuda:
            res[name]["fwd_bwd_ms"] = _time_ms(
                lambda: _with_grads(fn, q, k, v, do), 3, 1)
    if cuda:
        res["full_flash_fwd_bwd_ms"] = _time_ms(
            lambda: _with_grads(full, q, k, v, do), 3, 1)
    return res


def phase_mesh(cfg, device="cuda", batch=8, seq=2048, steps=2,
               accum_steps=2, ring_shape=None, moe_seq=2048,
               moe_steps=3) -> dict:
    """The mesh plane on one card: a process group of one rank (NCCL, or
    gloo on the CPU), ``cfg`` trained through the mesh step on
    ``MeshSpec(fsdp=-1)`` and through ZeRO-1 against the mesh-less step,
    ``ring_attention(impl="flash")`` and ``ulysses_attention`` on the
    1-rank mesh, and the MoE model at ``cfg``'s width cut to
    ``MOE_LAYERS`` layers on an ``expert`` mesh of one; then the
    comparisons: the ring, Ulysses and a loopback ring of 4 virtual
    shards against the plain flash forward and backward, and the loopback
    against one full flash call."""
    import torch.distributed as dist

    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.optim import adamw
    from ray_tpu_torch.parallel import train_step as ts
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.parallel.ring_attention import ring_attention
    from ray_tpu_torch.parallel.ulysses import ulysses_attention

    cuda = torch.device(device).type == "cuda"
    dtype_name = "cuda" if cuda else "cpu"
    ring_shape = ring_shape or dict(b=1, s=8192, h=cfg.n_heads,
                                    hkv=cfg.n_kv_heads, d=cfg.head_dim)
    mesh = MeshSpec(fsdp=-1).build(device_type=dtype_name)
    g = torch.Generator(device=device).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq + 1), generator=g,
                           device=device)
    per_step = {"flash_fwd": 2 * cfg.n_layers * accum_steps,
                "flash_bwd_dkv": cfg.n_layers * accum_steps,
                "flash_bwd_dq": cfg.n_layers * accum_steps,
                "attention_delta": cfg.n_layers * accum_steps}
    want_step = {**{k: 0 for k in KERNELS}, **per_step}
    runs = {"plain": _mesh_train_run(cfg, "plain", device, tokens, steps,
                                     accum_steps, mesh)}
    q, k, v, do = _ring_inputs(ring_shape, device)

    # The main path: counts zeroed right before, read right after.
    reset_counts()
    fwd0, bwd0 = fwd_kernel_counts(device), bwd_kernel_counts(device)
    for variant in ("mesh", "zero1"):
        runs[variant] = _mesh_train_run(cfg, variant, device, tokens, steps,
                                        accum_steps, mesh)
    ring_out = _with_grads(lambda *a: ring_attention(*a, mesh, impl="flash"),
                           q, k, v, do)
    uly_out = ulysses_attention(q, k, v, mesh, impl="flash")
    moe_cfg = replace(cfg, n_layers=MOE_LAYERS, moe_experts=8, moe_top_k=2,
                      moe_capacity_factor=1.25)
    moe_mesh = MeshSpec(expert=-1, fsdp=1).build(device_type=dtype_name)
    moe_params = ts.init_sharded_params(
        lambda seed: llama.init_params(moe_cfg, device=device,
                                       dtype=torch.float32, seed=seed),
        llama.param_axes(moe_cfg), moe_mesh, 1)
    opt = adamw(3e-4, weight_decay=0.1)
    moe_state = ts.init_optimizer_state(opt, moe_params)

    def aux_metric(p, b):
        _, aux = llama.hidden_states_aux(p, b["tokens"][:, :-1], moe_cfg)
        return {"aux": ts._full(aux)}

    moe_step = ts.build_train_step(lambda p, b: llama.loss_fn(p, b, moe_cfg),
                                   opt, moe_mesh, extra_metrics=aux_metric)
    moe_batch = ts.shard_batch({"tokens": tokens[:1, :moe_seq + 1]},
                               moe_mesh)
    moe = {"losses": [], "aux": [], "step_s": []}
    for _ in range(moe_steps):
        t = time.perf_counter()
        moe_params, moe_state, m = moe_step(moe_params, moe_state, moe_batch)
        _sync(device)
        moe["step_s"].append(time.perf_counter() - t)
        moe["losses"].append(float(m["loss"]))
        moe["aux"].append(float(m["aux"]))
    del moe_params, moe_state, moe_step
    _sync(device)
    launches = launch_counts()
    by_kernel = fwd_kernels_since(fwd0, device)
    bwd_by_kernel = bwd_kernels_since(bwd0, device)

    # The comparisons (their launches are not the path's), against the
    # plain forward and backward at the ring's shape.
    plain_attn = _plain_attention(q, k, v, do)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ring = _ring_checks(q, k, v, do, mesh, 4, plain_attn)
    uly_err = _rel_err(uly_out, plain_attn[0])
    ring_err = _errs(ring_out, plain_attn)
    del q, k, v, do, ring_out, uly_out, plain_attn
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    plain, mesh_r, z1 = runs["plain"], runs["mesh"], runs["zero1"]
    rel = lambda a, b: max(abs(x - y) / max(abs(y), 1e-30)  # noqa: E731
                           for x, y in zip(a, b))
    n_virtual = 4
    live = n_virtual * (n_virtual + 1) // 2    # diagonal + visible hops
    loop_want = {**{k_: 0 for k_ in KERNELS}, "flash_fwd": live,
                 "flash_bwd_dkv": live, "flash_bwd_dq": live,
                 "attention_delta": live}
    ring1_want = {**{k_: 0 for k_ in KERNELS}, "flash_fwd": 1,
                  "flash_bwd_dkv": 1, "flash_bwd_dq": 1,
                  "attention_delta": 1}
    # The path: the mesh and ZeRO-1 steps, the ring's forward and
    # backward, Ulysses' forward, and per MoE step each layer's forward,
    # remat recompute and aux-metric forward, backward and delta.
    moe_want = {k_: moe_steps * MOE_LAYERS * (3 if k_ == "flash_fwd"
                                              else 1 if k_ in per_step
                                              else 0) for k_ in KERNELS}
    path_want = {k_: 2 * steps * want_step[k_] + ring1_want[k_]
                 + (k_ == "flash_fwd") + moe_want[k_] for k_ in KERNELS}
    out = {"world_size": dist.get_world_size(),
           "backend": dist.get_backend(),
           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "config": {"preset_width": {"dim": cfg.dim,
                                       "n_layers": cfg.n_layers,
                                       "n_heads": cfg.n_heads,
                                       "n_kv_heads": cfg.n_kv_heads,
                                       "mlp_dim": cfg.mlp_dim},
                      "batch": batch, "seq": seq,
                      "accum_steps": accum_steps, "steps": steps,
                      "ring_shape": ring_shape,
                      "moe": {"n_layers": MOE_LAYERS, "experts": 8,
                              "top_k": 2, "capacity_factor": 1.25,
                              "batch": 1, "seq": moe_seq,
                              "cut": "depth 22 -> 4 layers"}},
           "train": runs, "moe": moe, "ring": ring,
           "ring_1rank_in_path_rel_err_vs_plain": ring_err,
           "ulysses_rel_err_vs_plain": uly_err,
           "launches": launches, "launches_want": path_want,
           "flash_fwd_by_kernel": by_kernel,
           "flash_bwd_by_kernel": bwd_by_kernel,
           "tol": {"mesh_rel": MESH_REL_TOL, "ring_bf16": RING_BF16_TOL}}
    ring_tol = RING_BF16_TOL if cuda else 1e-5
    checks = {
        "world_size_1": out["world_size"] == 1,
        "backend": out["backend"] == ("nccl" if cuda else "gloo"),
        "mesh_losses_match_plain": rel(mesh_r["losses"], plain["losses"])
        <= MESH_REL_TOL,
        "mesh_grad_norms_match_plain": rel(mesh_r["grad_norms"],
                                           plain["grad_norms"])
        <= MESH_REL_TOL,
        "zero1_losses_match_plain": rel(z1["losses"], plain["losses"])
        <= MESH_REL_TOL,
        "zero1_grad_norms_match_plain": rel(z1["grad_norms"],
                                            plain["grad_norms"])
        <= MESH_REL_TOL,
        "mesh_launches_per_step_exact": all(
            c == want_step for r in (mesh_r, z1)
            for c in r["launches_per_step"]),
        "ring_1rank_in_path_matches_plain": max(ring_err.values())
        <= ring_tol,
        "ring_1rank_matches_plain": max(
            ring["ring_1rank"]["rel_err_vs_plain"].values()) <= ring_tol,
        "ring_1rank_launches": ring["ring_1rank"]["launches"] == ring1_want,
        "loopback_matches_plain": max(
            ring["loopback"]["rel_err_vs_plain"].values()) <= ring_tol,
        "loopback_matches_flash": max(
            ring["loopback"]["rel_err_vs_flash"].values()) <= ring_tol,
        "loopback_launches_skip_dead_hops":
            ring["loopback"]["launches"] == loop_want,
        "ulysses_matches_plain": uly_err <= ring_tol,
        "moe_finite": all(math.isfinite(x)
                          for x in moe["losses"] + moe["aux"]),
        "moe_loss_falls": moe["losses"][-1] < moe["losses"][0],
        "path_launches_exact": launches == path_want,
        "flash_fwd_on_wgmma": all_on_wgmma(by_kernel, launches["flash_fwd"],
                                           device),
        "flash_bwd_on_wgmma": all_bwd_on_wgmma(
            bwd_by_kernel, launches["flash_bwd_dkv"],
            launches["flash_bwd_dq"], device),
        "loopback_on_wgmma": all_on_wgmma(
            ring["loopback"]["fwd_by_kernel"], live, device)
        and all_bwd_on_wgmma(ring["loopback"]["bwd_by_kernel"], live, live,
                             device),
    }
    if cuda:
        out["device"] = smi_line()
        for r in runs.values():
            r["steady_step_s"] = r["step_s"][-1]
    out["checks"] = checks
    out["ok"] = all(checks.values())
    dist.destroy_process_group()
    return out


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ----------------------------------------------------------------- main


def main() -> int:
    from ray_tpu_torch.models import llama, vit

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record: dict = {}
    paths: dict = {}
    by_kernel: dict = {}
    bwd_by_kernel: dict = {}
    serve_cfg = replace(llama.PRESETS["7b"], attention_impl="flash")
    train_cfg = replace(llama.PRESETS["1b"], attention_impl="flash",
                        remat=True, remat_policy="full", loss_chunk=512)
    for name, fn in (("env", phase_env), ("build", phase_build),
                     ("kernels", lambda: phase_kernels(record)),
                     ("splash", lambda: phase_splash(record)),
                     ("serve", lambda: phase_serve(serve_cfg)),
                     ("serve_paged", lambda: phase_serve_paged(serve_cfg)),
                     ("serve_spec", lambda: phase_serve_spec(serve_cfg)),
                     ("serve_disagg",
                      lambda: phase_serve_disagg(serve_cfg)),
                     ("serve_mesh", lambda: phase_serve_mesh(serve_cfg)),
                     ("train", lambda: phase_train(train_cfg)),
                     ("vit", lambda: phase_vit(vit.PRESETS["vit_b16"])),
                     ("mesh", lambda: phase_mesh(train_cfg))):
        t0 = time.perf_counter()
        try:
            res = fn()
        except Exception:
            emit({"phase": name, "ok": False,
                  "error": traceback.format_exc()})
            return 1
        res = {"phase": name, "ok": res.pop("ok", True),
               "seconds": time.perf_counter() - t0, **res}
        emit(res)
        if not res["ok"]:
            return 1
        if name in PATH_KERNELS:
            paths[name] = res["launches"]
            for k, n in res.get("flash_fwd_by_kernel", {}).items():
                by_kernel[k] = by_kernel.get(k, 0) + n
            for k, n in res.get("flash_bwd_by_kernel", {}).items():
                bwd_by_kernel[k] = bwd_by_kernel.get(k, 0) + n
            gc.collect()
            torch.cuda.empty_cache()
    # Each main path's counts were zeroed right before it and read right
    # after it; a kernel counts the launches of every path.
    launches = {k: sum(p.get(k, 0) for p in paths.values()) for k in KERNELS}
    missing = [k for k in KERNELS if launches[k] < 1]
    missing += [f"{k} on the {p} path" for p, want in PATH_KERNELS.items()
                for k in want if paths[p].get(k, 0) < 1]
    if missing:
        emit({"phase": "launches", "ok": False, "not_launched": missing})
        return 1
    # The forward's launches on the serve and train paths by the kernel
    # its C entry launched (every one bf16, so all on wgmma).
    record["flash_fwd"]["launches_by_kernel"] = by_kernel
    # The backward's launches on the train path by the kernel its C entries
    # launched (every one bf16, so all on wgmma).
    for name, prefix in (("flash_bwd_dkv", "dkv_"), ("flash_bwd_dq", "dq_")):
        record[name]["launches_by_kernel"] = {
            k: n for k, n in bwd_by_kernel.items() if k.startswith(prefix)}
    emit({"kernels": [
        {"name": k, **KERNELS[k], "launches": launches[k], **record[k]}
        for k in KERNELS]})
    print(smi_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
