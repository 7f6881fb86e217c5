"""One run of a cell, from its driver to the result line."""

from __future__ import annotations

import importlib
import math
import sys
from typing import Any, Dict

from benchmark.harness import counts, result, spec


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: str, t_proc: float, out=sys.stdout,
             err=sys.stderr, control: bool = False) -> int:
    """Run ``cell`` with its mix's driver and print the result line.
    Returns the exit code: 0, or 4 when JAX or the JAX package was loaded
    (then no line is printed). ``control`` adds the control's readings
    to the line's ``info`` (``control.py``; never in a benchmark run).
    ``info["built_files"]`` counts the files the run added to the kernel
    builds and caches: a run that reads more than 0 built its kernels in
    its set-up, and its ``setup_s`` stands apart from the warm runs'."""
    cached = result.cache_files()
    driver = importlib.import_module(
        f"benchmark.drivers.{cell.traffic['driver']}")
    res, checks, obs = driver.run(cell, seed, seconds, trace, device, t_proc,
                                  control=control)
    found = result.forbidden_modules()
    if found:
        print(f"run.py: forbidden modules loaded: {', '.join(found)}",
              file=err)
        return 4
    dev = (result.card(cell.chips) if device != "cpu"
           else {"platform": "cpu", "kind": "cpu", "count": 1})
    dev["memory_peak_bytes"] = res["memory_peak_bytes"]
    obs["peak"] = counts.PEAKS.get(dev["kind"],
                                   counts.PEAKS[counts.DEFAULT_PEAK])
    line: Dict[str, Any] = {"correct": res["correct"],
                            "attempted": res["attempted"],
                            "failed": res["failed"]}
    if trace:
        line["metrics"] = per_layer(cell, obs)
        tr = obs["trace"]
        for name, r in tr["ranges"].items():
            print(f"trace range {name} calls={len(r['calls'])} "
                  f"device_s={r['device_s']!r}", file=err)
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = tr["window_s"]
        line["breakdown"] = tr["breakdown"]
    else:
        e2e = res["e2e"]
        line["metrics"] = {
            m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if e2e.get(m["name"]) is not None}
    line["device"] = dev
    built = len(result.cache_files() - cached)
    line["info"] = {**res["info"], "built_files": built,
                    "first_build": built > 0}
    print("info " + " ".join(f"{k}={v}" for k, v in line["info"].items()),
          file=err)
    result.emit(line, checks, out, err)
    return 0


def per_layer(cell: spec.Cell, obs: Dict[str, Any]) -> Dict[str, Any]:
    """Each per-layer metric of the cell its reader finds something to
    read for; a reader that returns ``None`` leaves its metric out."""
    out = {}
    for m in cell.per_layer:
        value = spec.reader(m["name"])(obs)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
