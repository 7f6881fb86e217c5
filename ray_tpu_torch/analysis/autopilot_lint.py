"""Autopilot family: action handlers must fence AND audit.

**autopilot-unpaired-action** — in the closed-loop remediator
(``rules.AUTOPILOT_MODULES``), every action handler — a method whose
name starts with ``rules.AUTOPILOT_ACTION_PREFIX`` (``_act_``) — must
call BOTH ``self._fence_ok(...)`` and ``self._audit(...)`` somewhere
in its own body. This is the RPC_LEASE_PAIRS shape applied to control
actions instead of leases: the fence is what keeps a remediation from
fighting a cluster that already self-healed (stale epoch == the world
moved on), and the audit record is what makes an autonomous mutation
accountable after the fact. A handler missing either is exactly the
kind of "helpful" code path that double-kills a recovered gang or
leaves no trail for the post-mortem — flagged at ``make lint``, not
found in an incident review.

The pairing must be visible in the handler body itself, not satisfied
through a transitive callee: the point of the idiom is that a reader
of the handler sees the fence and the audit without chasing calls.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from ray_tpu_torch.analysis import rules
from ray_tpu_torch.analysis.core import Finding, Project, qualname_of


def _self_calls(fn: ast.AST) -> set:
    """Names of every ``self.<name>(...)`` call in the function body."""
    out: set = set()
    for node in ast.walk(fn):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "self"):
            out.add(node.func.attr)
    return out


def check_project(project: Project,
                  emit_files: Optional[set] = None) -> List[Finding]:
    findings: List[Finding] = []
    for f in sorted(project.files, key=lambda s: s.relpath):
        if f.relpath not in rules.AUTOPILOT_MODULES:
            continue
        if emit_files is not None and f.relpath not in emit_files:
            continue
        stack: List[ast.AST] = []

        def visit(node: ast.AST) -> None:
            is_scope = isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef,
                                         ast.ClassDef))
            if is_scope:
                stack.append(node)
            for child in ast.iter_child_nodes(node):
                visit(child)
            if is_scope:
                stack.pop()
            if not (isinstance(node, (ast.FunctionDef,
                                      ast.AsyncFunctionDef))
                    and node.name.startswith(
                        rules.AUTOPILOT_ACTION_PREFIX)
                    and stack and isinstance(stack[-1], ast.ClassDef)):
                return
            calls = _self_calls(node)
            missing = [c for c in (rules.AUTOPILOT_FENCE_CALL,
                                   rules.AUTOPILOT_AUDIT_CALL)
                       if c not in calls]
            if not missing:
                return
            findings.append(Finding(
                rule=rules.AUTOPILOT_UNPAIRED,
                path=f.relpath, line=node.lineno,
                symbol=qualname_of(stack + [node]),
                message=(f"action handler {node.name!r} never calls "
                         f"self.{' / self.'.join(missing)}: every "
                         f"autopilot action must pair an epoch-fence "
                         f"check ({rules.AUTOPILOT_FENCE_CALL}) with "
                         f"a durable audit record "
                         f"({rules.AUTOPILOT_AUDIT_CALL}) in its own "
                         f"body — an unfenced action can double-kill "
                         f"a gang the cluster already healed; an "
                         f"unaudited one is an unaccountable "
                         f"mutation")))

        visit(f.tree)
    return findings


def sites(project: Project) -> int:
    """Action handlers in the autopilot modules."""
    n = 0
    for f in project.files:
        if f.relpath not in rules.AUTOPILOT_MODULES:
            continue
        for cls in ast.walk(f.tree):
            if isinstance(cls, ast.ClassDef):
                n += sum(1 for node in cls.body
                         if isinstance(node, (ast.FunctionDef,
                                              ast.AsyncFunctionDef))
                         and node.name.startswith(
                             rules.AUTOPILOT_ACTION_PREFIX))
    return n
