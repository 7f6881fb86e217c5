"""Run one cell of the benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the checkout's root, on a machine with the cards the cell asks for.
With ``--trace 0`` the line's metrics are the cell's end-to-end metrics;
with ``--trace 1`` the profiler traces part of the window and the line's
metrics are its per-layer metrics, with the device's busy time and a
breakdown. The last lines of standard error, and the line's ``compared``
key, give each number the output check compared beside its limit.

Exits non-zero and prints no result line when no card (or too few) is
present, when the cell is unknown, when ``BENCHMARK.json`` is missing, or
when JAX or the JAX package was loaded.
"""

import time

T_PROC = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "benchmark" / ".cache"


def environment() -> None:
    """Caches at fixed paths inside the checkout; no JAX through any
    library that would load it by itself; the checkout's root first on
    the path. Every entry point (``run.py``, ``sweep.py``,
    ``control.py``) sets up its process with this."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "benchmark":
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))


def _args(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = _args(argv)
    environment()
    from benchmark.harness import spec

    if not (ROOT / "BENCHMARK.json").exists():
        print("run.py: no BENCHMARK.json at the checkout's root",
              file=sys.stderr)
        return 2
    try:
        cell = spec.load_cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        print(f"run.py: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("run.py: no CUDA device is available", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"run.py: the cell needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} are present", file=sys.stderr)
        return 3
    from benchmark.harness.runner import run_cell

    return run_cell(cell, args.seed, args.seconds, bool(args.trace),
                    "cuda", T_PROC)


if __name__ == "__main__":
    sys.exit(main())
