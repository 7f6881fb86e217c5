"""The harness finds every configuration, mix, limit file and per-layer
reader by the names in BENCHMARK.json, and the file keeps to the
benchmark's contract."""

import json
import re

import pytest

from benchmark.harness import spec

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_with_what_it_names(cell):
    c = spec.load_cell(cell)
    assert c.config and c.traffic and c.limits
    assert c.traffic["driver"] in ("engine", "train_step")
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names
        assert callable(spec.reader(m["name"]))


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        spec.load_cell("no-such-cell")
    with pytest.raises(KeyError):
        spec.reader("no_such_metric")


def test_names_units_and_lines():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for entry in BENCH["configs"] + BENCH["workloads"] + metrics:
        assert NAME.match(entry["name"]), entry["name"]
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200
        assert set(m["workloads"]) <= set(CELLS)
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51


def test_configs_live_under_paths():
    for c in BENCH["configs"]:
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] == []
    assert {w["config"] for w in BENCH["workloads"]} == {
        c["name"] for c in BENCH["configs"]}
    assert all(w["chips"] == 1 for w in BENCH["workloads"])


def test_file_names_use_name_characters():
    allowed = re.compile(r"^[A-Za-z0-9_.\-/]+$")
    for p in spec.BENCH_DIR.rglob("*"):
        rel = p.relative_to(spec.ROOT).as_posix()
        if "__pycache__" in rel or "/.cache" in rel:
            continue
        assert allowed.match(rel), rel
