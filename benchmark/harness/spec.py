"""Finding a cell and everything it names, by name.

``BENCHMARK.json`` at the checkout's root lists configurations, cells
(``workloads``) and metrics. Each configuration is the file its entry
names; each traffic mix is ``benchmark/traffic/<mix>.json``; each
per-layer metric is the reader ``benchmark/metrics/<metric>.py``; each
cell's output limits are ``benchmark/limits/<cell>.json``. A later cell,
mix or metric is added as files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with what it names, loaded."""

    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]
    traffic_name: str
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    end_to_end: List[Dict[str, Any]] = field(default_factory=list)
    per_layer: List[Dict[str, Any]] = field(default_factory=list)


def _applies(metric: Dict[str, Any], cell: str, e2e_names: List[str]) -> bool:
    """A metric with ``workloads`` applies to the cells it lists; an
    end-to-end metric without it to every cell; a per-layer metric
    without it to every cell that reports the metric it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_names
    return True


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``; raises KeyError for a
    cell, configuration or mix that is not there."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, [])]
    names = [m["name"] for m in e2e]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name, names)]
    return Cell(
        name=name, chips=int(w["chips"]), config_name=entry["name"],
        config=load_json(root / entry["file"]),
        traffic_name=w["traffic"],
        traffic=load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(BENCH_DIR / "limits" / f"{name}.json"),
        end_to_end=e2e, per_layer=per_layer)


def reader(metric: str, directory: Path = BENCH_DIR / "metrics"
           ) -> Callable[[Dict[str, Any]], Optional[float]]:
    """The ``read(obs)`` function of ``metrics/<metric>.py``. A metric's
    name may hold dots, so the file is loaded by path, not imported by
    module name."""
    path = directory / f"{metric}.py"
    if not path.exists():
        raise KeyError(f"no reader {path.name} for per-layer metric "
                       f"{metric!r}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
