"""Device: the share of the traced part of the window in which no
operation ran on the card (``torch.profiler``), in %. Moves
``train_tokens_per_s``."""


def read(obs):
    tr = obs.get("trace")
    if not tr or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
