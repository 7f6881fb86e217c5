"""The learner host of the distributed RL plane (port of
``ray_tpu/rl/distributed/learner.py``): only ``new_plane_key`` is carried,
because single-process IMPALA and APPO key their weight fan-out with it.
The learner state, the rollout plane and its stats are ROADMAP.md queue 1's
next RL slice; their names raise."""

from __future__ import annotations

import itertools
import os

_plane_counter = itertools.count()

_NOT_PORTED = ("LearnerState", "RolloutPlane", "plane_stats")


def new_plane_key(prefix: str) -> str:
    """Unique fan-out key per algorithm instance (pid-scoped so two
    drivers on one box never cross-subscribe)."""
    return f"{prefix}-{os.getpid()}-{next(_plane_counter)}"


def __getattr__(name):
    if name in _NOT_PORTED:
        from ray_tpu_torch.core.errors import not_ported

        raise not_ported(f"rl.distributed.{name}",
                         "item 5, the distributed plane")
    raise AttributeError(name)
