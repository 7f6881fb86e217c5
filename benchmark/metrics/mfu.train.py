"""Model step: the window's trained tokens a second x the model FLOPs of a
token (``counts.train_flops_per_token``: 6 x the non-embedding parameters
with the LM head, plus causal attention, 6 L H D S; recomputation counts
nothing) over the card's bf16 peak, in %. The result line's device entry
gives the card's power limit. Moves ``train_tokens_per_s``."""

from benchmark.harness import counts


def read(obs):
    rate = obs.get("tokens_per_s")
    if not rate:
        return None
    flops = counts.train_flops_per_token(obs["cell"].config, obs["seq_len"])
    return 100.0 * rate * flops / obs["peak"]["bf16_flops"]
