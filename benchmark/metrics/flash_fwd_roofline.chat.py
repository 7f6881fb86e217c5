"""Kernels: the causal prefill attention's share of its roofline, in %.

The work is counted from the shapes fed to the flash forward entry
(``ray_tpu_torch.ops.flash_attention.flash_attention``) inside the traced
part of the window; the time is the device time of every kernel launched
while the benchmark's ``bench::flash_fwd`` range around that entry was
open, whatever kernel implements it. Moves ``itl_p95_ms``: the steps
that carry a prefill chunk make the tail of the gaps between tokens."""

from benchmark.harness import counts


def read(obs):
    tr = obs.get("trace")
    rng = tr and tr["ranges"].get("flash_fwd")
    if not rng or not rng["calls"] or rng["device_s"] <= 0:
        return None
    return counts.roofline_share(rng["calls"], rng["device_s"],
                                 counts.attention_fwd,
                                 obs["peak"])["share_pct"]
