"""Model step: the window's model FLOPs over the wall time of the engine
steps that did them x the card's bf16 peak, in %.

A prompt counts when its first token comes inside the window, each later
token when it comes inside it (``counts.prompt_flops``,
``counts.serve_token_flops``: 2 x the layers' matmul parameters a token,
attention over its context, the LM head where logits are needed).
Recomputed prompts of preempted requests count nothing. The steps' wall
time is the engine's step timeline, each step ending in the host's copy
of its tokens. Moves ``itl_p95_ms``."""

from benchmark.harness import counts


def read(obs):
    rows, reqs = obs.get("step_rows"), obs.get("requests")
    if not rows or reqs is None:
        return None
    w, cfg = obs["window_s"], obs["cell"].config
    flops = 0.0
    for r in reqs:
        t = r["times"]
        if t and 0.0 <= t[0] <= w:
            flops += counts.prompt_flops(cfg, r["prompt"])
        flops += sum(counts.serve_token_flops(cfg, r["prompt"] + i - 1, True)
                     for i in range(1, len(t)) if 0.0 <= t[i] <= w)
    busy = sum(min(t1, w) - max(t0, 0.0) for t0, t1 in rows
               if t1 > 0.0 and t0 < w)
    if busy <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (busy * obs["peak"]["bf16_flops"])
