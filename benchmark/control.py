"""Read the output check's numbers on several seeds, with the control's.

    python3 benchmark/control.py --workload <cell> --seeds a,b,c \
        --seconds <s>

Runs the cell once a seed in one process, as ``run.py`` does, and puts
beside the program's compared numbers those of the control: the plain
reference computed in float8 (e4m3 operands, e5m2 gradients) in the
program's place, on the same prompts and served tokens (serving) or the
same batches (training), and for training also the reference on half of
each batch's rows (the half-batch fault). The limits in
``benchmark/limits/`` are set from these readings (``PERF.md``). Prints one
result line a seed. Needs the cards the cell asks for; the benchmark's
own runs never run the control.
"""

import sys
import time


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from run import environment

    environment()
    import torch

    from benchmark.harness import spec
    from benchmark.harness.runner import run_cell

    if not torch.cuda.is_available():
        print("control.py: no CUDA device is available", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        rc = run_cell(cell, seed, args.seconds, False, "cuda",
                      time.monotonic(), control=True)
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
