"""graftlint's metrics families (``ray_tpu_torch/analysis/metrics_lint.py``)
over the port's sources: fixture projects of port modules, and the whole
``ray_tpu_torch`` package as the port's analyzer loads it."""

from __future__ import annotations

import os
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def lint_project(**modules):
    """A fixture project of port modules (``ray_tpu_torch/<name>.py``)."""
    from ray_tpu_torch.analysis.core import Project, SourceFile

    files = []
    for name, src in modules.items():
        rel = f"ray_tpu_torch/{name}.py"
        files.append(SourceFile(f"/fixture/{rel}", rel,
                                textwrap.dedent(src)))
    return Project("/fixture", files)


def run_metrics_lint(project):
    from ray_tpu_torch.analysis import metrics_lint

    by_rel = {f.relpath: f for f in project.files}
    return [f for f in metrics_lint.check_project(project)
            if not by_rel[f.path].suppressed(f.rule, f.line)]


def port_findings(rule: str):
    """Findings of one metrics rule over the whole ``ray_tpu_torch``
    package."""
    from ray_tpu_torch.analysis.core import Project

    return [f for f in run_metrics_lint(Project.load(REPO))
            if f.rule == rule]
