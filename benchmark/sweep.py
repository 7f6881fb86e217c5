"""Find the knee of a serving cell: the highest rate it holds without a
growing backlog.

    python3 benchmark/sweep.py --workload <cell> --seed <n> \
        --seconds <s> --rates 1.5,2,2.5,3

One process, one engine (set up as ``run.py`` sets it up); for each rate
in turn, the requests in progress at that rate seated (the mix's
``residents``), an open loop of the cell's mix at that rate for
``seconds``, then every request still open is cancelled and the engine
drained before the next. Prints one JSON line a rate: tails, tokens a
second, how many requests still had no first token when the window
closed, and the median time to first token of the window's first and
last thirds (a backlog that grows shows as a last third far above the
first). Run once, when a cell is defined; ``PERF.md`` keeps the sweep
and the rate chosen.
"""

import json
import sys
import time


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--rates", required=True)
    args = p.parse_args(argv)
    from run import environment

    environment()
    import torch

    from benchmark.drivers import engine as drv
    from benchmark.harness import serving, spec, stats
    from benchmark.harness.trace import Tracer
    from benchmark.harness.traffic import residents, serve_schedule

    if not torch.cuda.is_available():
        print("sweep.py: no CUDA device is available", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    eng, loop, _, vocab = drv.start(cell, args.seed, "cuda")
    for i, rate in enumerate(float(r) for r in args.rates.split(",")):
        mix = dict(cell.traffic, arrivals={"process": "poisson",
                                           "rate_per_s": rate})
        held = residents(mix, args.seed + i, vocab)
        drv.seat_residents(eng, held)
        reqs = serve_schedule(mix, args.seconds, args.seed + i, vocab)
        w = drv.window(eng, loop, reqs, args.seconds, Tracer(False), 0.0,
                       0.0, "cuda", held)
        t0, t_end = w["t0"], w["t0"] + args.seconds
        waiting = sum(1 for r in reqs if not r.times or r.times[0] > t_end)
        sm = serving.summarize(reqs, t0, args.seconds, t_end, held)
        third = len(reqs) // 3
        firsts = [(r.times[0] if r.times else t_end) - r.due for r in reqs]
        for r in reqs + held:
            if r.handle is not None and not r.handle.done.is_set():
                eng.cancel(r.handle.request_id)
        while eng.stats()["active"] or eng.stats()["queued"] or \
                eng.stats()["prefilling"]:
            time.sleep(0.05)
        print(json.dumps({
            "rate_per_s": rate, "requests": len(reqs),
            "residents": len(held),
            "waiting_at_close": waiting, "steps": w["steps"],
            "ttft_p50_ms": sm["ttft_p50_ms"],
            "ttft_p95_ms": sm["ttft_p95_ms"],
            "itl_p95_ms": sm["itl_p95_ms"],
            "serve_tokens_per_s": sm["serve_tokens_per_s"],
            "step_ms": 1e3 * args.seconds / max(1, w["steps"]),
            "active_peak": w["pool"]["active"],
            "ttft_first_third_p50_ms": 1e3 * stats.percentile(
                firsts[:third], 50),
            "ttft_last_third_p50_ms": 1e3 * stats.percentile(
                firsts[-third:], 50),
            "device": torch.cuda.get_device_name(0)}), flush=True)
    eng.shutdown()
    loop.join(timeout=120)
    return 0


if __name__ == "__main__":
    sys.exit(main())
