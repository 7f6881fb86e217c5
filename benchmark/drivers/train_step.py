"""Training cells: the step ``build_train_step`` returns, driven back to
back.

Set-up makes the float32 master weights on the card from the seed, builds
the optimizer state and the step, and drives that same step through its
first three steps (on rows of their own, through the window's own feed):
they are the warm-up, and what the check compares. After step 1 it reads
each leaf's first gradient from AdamW's first moment (``mu / (1 - b1)``),
after step 3 each leaf's change from the seeded start. The window then
runs further steps, each synced at its end; the rate is the tokens of the
steps it completed over the time to the synced end of its last one.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

import torch

from benchmark.harness import weights
from benchmark.harness.spec import Cell
from benchmark.harness.trace import LEAD_S, Tracer, attention_shapes, wrap
from benchmark.harness.traffic import train_batch
from benchmark.drivers.common import (free_device, llama_config, memory_peak,
                                      setup_parts)

CHECK_STEPS = 3


def _sync(device: str) -> None:
    if device != "cpu":
        torch.cuda.synchronize()


def compare(mine: Dict[str, Any], ref_run: Dict[str, Any]
            ) -> Dict[str, Any]:
    """The three compared numbers of ``mine`` (losses, first gradient
    norms, change norms by leaf) against a reference run's."""
    from benchmark.reference import llama as ref

    skip = ref.rounding_leaves(ref_run["grad_norms"])
    grad = ref.worst_leaf_gap(mine["grad_norms"], ref_run["grad_norms"],
                              skip)
    moved = ref.worst_leaf_gap(mine["change_norms"],
                               ref_run["change_norms"], skip)
    return {"loss_gap": max(abs(a - b) for a, b in
                            zip(mine["losses"], ref_run["losses"])),
            "grad_norm_gap": grad["gap"], "grad_worst_leaf": grad["leaf"],
            "change_norm_gap": moved["gap"],
            "change_worst_leaf": moved["leaf"], "rounding_leaves": skip}


def run(cell: Cell, seed: int, seconds: float, trace: bool, device: str,
        t_proc: float, control: bool = False
        ) -> Tuple[Dict[str, Any], List[Tuple[str, float, float]],
                   Dict[str, Any]]:
    """One run of a training cell: ``(result, compared numbers, obs)``.
    With ``control`` the check also reads, into ``info``, the control
    (the reference in float8 in the program's place) and the half-batch
    fault (the reference on half of each batch's rows)."""
    import ray_tpu_torch.ops.flash_attention as fa
    from ray_tpu_torch.models import llama
    from ray_tpu_torch.ops.optim import adamw
    from ray_tpu_torch.parallel import train_step

    marks = {"imports": time.monotonic()}
    cfg, mix = cell.config, cell.traffic
    seq = int(mix["batch"]["seq_len"])
    tokens_per_step = int(mix["batch"]["rows"]) * seq
    lcfg = llama_config(cfg, mix["model"], seq)
    vocab = lcfg.vocab_size
    o = mix["optimizer"]
    opt = adamw(o["learning_rate"], b1=o.get("b1", 0.9), b2=o.get("b2", 0.999),
                eps=o.get("eps", 1e-8), weight_decay=o["weight_decay"])
    params = weights.make(cfg, seed, torch.float32, device)
    state = train_step.init_optimizer_state(opt, params)
    step = train_step.build_train_step(
        lambda p, b: llama.loss_fn(p, b, lcfg), opt,
        accum_steps=int(mix["accum_steps"]))
    _sync(device)
    marks["weights"] = time.monotonic()

    def run_step(k: int):
        nonlocal params, state
        batch = {"tokens": train_batch(mix, seed, k, vocab, device)}
        params, state, m = step(params, state, batch)
        return m

    losses, grad_norms = [], {}
    for k in range(CHECK_STEPS):
        losses.append(float(run_step(k)["loss"]))
        if k == 0:
            grad_norms = {path: float(m.norm()) / (1.0 - opt.b1)
                          for path, m in weights.flat(state.mu).items()}
    change = {path: float((p - weights.draw(cfg, seed, path, torch.float32,
                                            device)).norm())
              for path, p in weights.flat(params).items()}
    marks["checked_steps"] = time.monotonic()
    tracer = Tracer(trace)
    undo = wrap(tracer, fa, "flash_backward", "flash_bwd", attention_shapes)
    _sync(device)

    # ------------------------------------------------------------ window
    # With a trace, the profiler starts at the first step boundary in the
    # window's last trace_s + LEAD_S and counts from the first boundary
    # LEAD_S after that; the host-clock rate of a traced run is the part
    # before the profiler.
    t0 = time.monotonic()
    setup_s = t0 - t_proc
    trace_from = t0 + seconds - float(mix.get("trace_seconds", seconds)) \
        - LEAD_S
    k, done, t_last = CHECK_STEPS, 0, t0
    plain = None
    while t_last < t0 + seconds:
        run_step(k)
        _sync(device)
        t_last = time.monotonic()
        k += 1
        done += 1
        if tracer.enabled and plain is None and t_last >= trace_from:
            plain = (done, t_last - t0)
            tracer.start()
            started = t_last
        elif tracer.active and tracer.t0 == tracer.origin \
                and t_last >= started + LEAD_S:
            tracer.count()
    tracer.stop()
    undo()
    rate = done * tokens_per_step / (t_last - t0)
    peak_bytes = memory_peak(device)
    del params, state, step
    free_device()

    # --------------------------------------------------------- correct
    from benchmark.reference import llama as ref

    ref.exact_matmuls()
    batches = [train_batch(mix, seed, i, vocab, device)
               for i in range(CHECK_STEPS)]
    r = ref.train(cfg, seed, batches, o, device)
    got = compare({"losses": losses, "grad_norms": grad_norms,
                   "change_norms": change}, r)
    lim = cell.limits
    checks = [(k, got[k], float(lim[k]))
              for k in ("loss_gap", "grad_norm_gap", "change_norm_gap")]
    correct = all(v <= limit for _, v, limit in checks)
    info = {"steps": done, "step_s": (t_last - t0) / done,
            "losses": losses, "ref_losses": r["losses"],
            **{k: got[k] for k in ("grad_worst_leaf", "change_worst_leaf",
                                   "rounding_leaves")},
            "setup_parts_s": setup_parts(t_proc, marks, t0)}
    if control:
        info["control"] = compare(
            ref.train(cfg, seed, batches, o, device, prec="fp8"), r)
        info["half_batch"] = compare(
            ref.train(cfg, seed, [b[::2] for b in batches], o, device), r)
    result = {"correct": correct, "attempted": done + CHECK_STEPS,
              "failed": 0,
              "e2e": {"setup_s": setup_s, "train_tokens_per_s": rate},
              "info": info, "memory_peak_bytes": peak_bytes}
    plain = plain or (done, t_last - t0)
    obs = {"cell": cell, "window_s": plain[1],
           "tokens_per_s": plain[0] * tokens_per_step / plain[1],
           "seq_len": seq,
           "trace": tracer.reduce(["flash_bwd"]) if trace else None}
    return result, checks, obs
