"""Kernels: the causal attention backward's share of its roofline, in %.

The work is counted from the shapes fed to the flash backward entry
(``ray_tpu_torch.ops.flash_attention.flash_backward``, which autograd
calls for each layer) inside the traced part of the window; the time is
the device time of every kernel launched while the benchmark's
``bench::flash_bwd`` range around that entry was open (the delta
pre-pass, dK/dV and dQ today). Moves ``train_tokens_per_s``."""

from benchmark.harness import counts


def read(obs):
    tr = obs.get("trace")
    rng = tr and tr["ranges"].get("flash_bwd")
    if not rng or not rng["calls"] or rng["device_s"] <= 0:
        return None
    return counts.roofline_share(rng["calls"], rng["device_s"],
                                 counts.attention_bwd,
                                 obs["peak"])["share_pct"]
