"""No run loads JAX or the JAX package; the reference and the yardstick
import nothing of the program."""

import ast
import subprocess
import sys
import types

import pytest

from benchmark.harness import result, spec

RUN = """
import sys, time
sys.path.insert(0, {root!r})
from benchmark.harness.runner import run_cell
from benchmark.tests import tiny
cell = tiny.{cell}()
rc = run_cell(cell, 2**40 + 9, 1.5, False, "cpu", time.monotonic())
from benchmark.harness.result import forbidden_modules
print("FORBIDDEN", forbidden_modules(), "RC", rc)
"""


@pytest.mark.parametrize("cell", ["chat_cell", "train_cell"])
def test_a_run_loads_no_jax(cell):
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(root=str(spec.ROOT), cell=cell)],
        capture_output=True, text=True, timeout=600, cwd=spec.ROOT)
    assert "FORBIDDEN [] RC 0" in out.stdout, out.stderr[-3000:]


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ray_tpu_torch_like",
                        types.ModuleType("ray_tpu_torch_like"))
    assert "ray_tpu" not in result.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ray_tpu.core",
                        types.ModuleType("ray_tpu.core"))
    assert "ray_tpu" in result.forbidden_modules()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("folder", ["reference", "harness", "metrics"])
def test_yardstick_imports_nothing_of_the_program(folder):
    for path in (spec.BENCH_DIR / folder).glob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"ray_tpu_torch", "ray_tpu", "jax", "jaxlib",
                           "flax"}, path
