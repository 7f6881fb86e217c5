"""graftlint's metrics families (``ray_tpu/analysis/metrics_lint.py``) over
the port's sources: the lint resolves the JAX package's module names
(``ray_tpu.util.metrics``, ``ray_tpu.util.flightrec``), so each source is
read with ``ray_tpu_torch`` mapped to ``ray_tpu`` before the lint sees it.
Line numbers and pragmas are unchanged by the mapping."""

from __future__ import annotations

import os
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _as_reference(src: str) -> str:
    return src.replace("ray_tpu_torch", "ray_tpu")


def lint_project(**modules):
    """A fixture project of port modules (sources written against
    ``ray_tpu_torch``), as the lint reads them."""
    from ray_tpu.analysis.core import Project, SourceFile

    files = []
    for name, src in modules.items():
        rel = f"ray_tpu/{name}.py"
        files.append(SourceFile(f"/fixture/{rel}", rel,
                                _as_reference(textwrap.dedent(src))))
    return Project("/fixture", files)


def run_metrics_lint(project):
    from ray_tpu.analysis import metrics_lint

    by_rel = {f.relpath: f for f in project.files}
    return [f for f in metrics_lint.check_project(project)
            if not by_rel[f.path].suppressed(f.rule, f.line)]


def port_findings(rule: str):
    """Findings of one metrics rule over the whole ``ray_tpu_torch``
    package."""
    from ray_tpu.analysis.core import Project, SourceFile

    files = []
    pkg = os.path.join(REPO, "ray_tpu_torch")
    for dirpath, dirnames, filenames in os.walk(pkg):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for name in sorted(filenames):
            if name.endswith(".py"):
                path = os.path.join(dirpath, name)
                rel = os.path.relpath(path, pkg)
                with open(path, encoding="utf-8") as f:
                    files.append(SourceFile(
                        path, os.path.join("ray_tpu", rel),
                        _as_reference(f.read())))
    return [f for f in run_metrics_lint(Project(REPO, files))
            if f.rule == rule]
