"""Engine: the window's wall time over the decode steps the engine ran in
it (``DecodeEngine.stats()["steps"]``), in ms. Moves ``itl_p95_ms``."""


def read(obs):
    steps = obs.get("steps")
    if not steps:
        return None
    return 1e3 * obs["window_s"] / steps
