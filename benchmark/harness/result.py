"""The run's checks and its result line."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path
from typing import Any, Dict, List, Set, Tuple

# Top-level module names no run may load: JAX and the JAX package the
# port was made from. Compared whole: ``ray_tpu_torch`` is not
# ``ray_tpu``.
FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")


_ROOT = Path(__file__).resolve().parents[2]
# Where the program's kernel builds and the run's caches go: a run that
# adds a file here built or compiled something in its set-up.
CACHE_DIRS = (_ROOT / "ray_tpu_torch" / "_build",
              _ROOT / "benchmark" / ".cache")


def cache_files() -> Set[str]:
    return {str(p) for d in CACHE_DIRS if d.is_dir()
            for p in d.rglob("*") if p.is_file()}


def forbidden_modules() -> List[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def card(count: int) -> Dict[str, Any]:
    """Name, count and power limit of the ``count`` cards a run uses."""
    import torch

    out = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": count}
    try:
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out["power_limit"] = "unknown"
    return out


def compared_lines(checks: List[Tuple[str, float, float]]) -> List[str]:
    return [f"check {name} {value!r} limit {limit!r}"
            for name, value, limit in checks]


def emit(result: Dict[str, Any], checks: List[Tuple[str, float, float]],
         out=sys.stdout, err=sys.stderr) -> None:
    """Print every compared number beside its limit as the last lines of
    standard error, and the result as the last line of standard output,
    with the same numbers under ``compared``, its last key."""
    for line in compared_lines(checks):
        print(line, file=err)
    err.flush()
    line = dict(result)
    line["compared"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    print(json.dumps(line), file=out)
    out.flush()
