"""The cluster discovery file (the part of ``ray_tpu/scripts.py`` that the
runtime writes; the state CLI is not ported yet, ROADMAP.md queue 1,
item 4).

The newest controller on the host writes its address here, under the
port's own name in the temp directory, so a JAX runtime's discovery file
is never overwritten.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Tuple

DISCOVERY_PATH = os.path.join(tempfile.gettempdir(), "ray_tpu_torch",
                              "cluster_latest.json")


def write_discovery(addr: Tuple[str, int]) -> None:
    try:
        os.makedirs(os.path.dirname(DISCOVERY_PATH), exist_ok=True)
        with open(DISCOVERY_PATH, "w") as f:
            json.dump({"address": list(addr), "pid": os.getpid()}, f)
    except OSError:
        pass
