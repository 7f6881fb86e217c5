"""lifecycle-hygiene: swallowed exceptions and leak-on-error resources.

Slot and prefix-pin leaks have cost days; their root cause was whose root cause was error
paths that silently ate the exception or skipped the release. Two rules:

* swallowed-exception      — ``except Exception:``/``except
                             BaseException:``/bare ``except:`` whose
                             entire body is ``pass`` (or ``...``). Typed
                             narrow excepts (``except OSError: pass``)
                             are deliberate and exempt. Deliberate broad
                             silences get a pragma with a reason.
* missing-finally-release  — an acquire (``.acquire()``, ``selector
                             .register``, ``socket.socket()``/``open()``
                             not in ``with``) whose matching release
                             appears later in the SAME function but not
                             inside a ``finally`` block: any exception in
                             between leaks the resource. Functions that
                             never release (ownership handed elsewhere)
                             are not flagged.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.analysis import rules
from ray_tpu_torch.analysis.callgraph import dotted, _walk_no_nested
from ray_tpu_torch.analysis.core import Finding, Project, qualname_of

_BROAD = {"Exception", "BaseException"}


def _is_broad_handler(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    if isinstance(t, (ast.Name, ast.Attribute)):
        d = dotted(t)
        return d is not None and d.split(".")[-1] in _BROAD
    if isinstance(t, ast.Tuple):
        return any(
            (d := dotted(el)) is not None and d.split(".")[-1] in _BROAD
            for el in t.elts)
    return False


def _body_is_silent(body: List[ast.stmt]) -> bool:
    if len(body) != 1:
        return False
    stmt = body[0]
    if isinstance(stmt, ast.Pass):
        return True
    return (isinstance(stmt, ast.Expr)
            and isinstance(stmt.value, ast.Constant)
            and stmt.value.value is Ellipsis)


def _check_swallowed(tree: ast.AST, relpath: str,
                     findings: List[Finding]) -> None:
    stack: List[ast.AST] = []

    def visit(node: ast.AST) -> None:
        is_scope = isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef, ast.ClassDef))
        if is_scope:
            stack.append(node)
        for child in ast.iter_child_nodes(node):
            visit(child)
        if isinstance(node, ast.ExceptHandler) \
                and _is_broad_handler(node) \
                and _body_is_silent(node.body):
            findings.append(Finding(
                rule=rules.SWALLOWED_EXCEPTION,
                path=relpath, line=node.lineno,
                symbol=qualname_of(stack),
                message="broad except with silent pass — log "
                        "(rate-limited) or narrow the exception type"))
        if is_scope:
            stack.pop()

    visit(tree)


def _in_finally_lines(fn_node: ast.AST) -> Set[int]:
    """Lines inside ``finally`` blocks OR ``except`` handlers: a release
    in either is exception-path remediation, not a leakable gap."""
    lines: Set[int] = set()

    def mark(stmts: List[ast.stmt]) -> None:
        for stmt in stmts:
            for sub in ast.walk(stmt):
                ln = getattr(sub, "lineno", None)
                if ln is not None:
                    lines.add(ln)

    for node in _walk_no_nested(fn_node):
        if isinstance(node, ast.Try):
            if node.finalbody:
                mark(node.finalbody)
            for h in node.handlers:
                mark(h.body)
    return lines


def _with_context_lines(fn_node: ast.AST) -> Set[int]:
    """Line numbers of expressions used as ``with`` context managers —
    those handle their own release."""
    lines: Set[int] = set()
    for node in _walk_no_nested(fn_node):
        if isinstance(node, ast.With):
            for item in node.items:
                for sub in ast.walk(item.context_expr):
                    ln = getattr(sub, "lineno", None)
                    if ln is not None:
                        lines.add(ln)
    return lines


def _recv_name(call: ast.Call) -> Optional[str]:
    """Receiver of a method call as a dotted key (``x.acquire()`` -> x,
    ``self._selector.register(...)`` -> ``self._selector``)."""
    if isinstance(call.func, ast.Attribute):
        return dotted(call.func.value)
    return None


def _check_releases(fn_node: ast.AST, relpath: str, symbol: str,
                    findings: List[Finding]) -> None:
    method_pairs = dict(rules.ACQUIRE_RELEASE_METHODS)
    release_names = set(method_pairs.values()) | {
        rel for _, rel in rules.ACQUIRE_RELEASE_DOTTED}

    # (receiver, release verb) -> acquire lines and -> release lines.
    # "Receiver" keys the pairing: x.acquire / x.release, sock =
    # socket.socket() / sock.close(). The finally and with line sets are
    # computed only for functions that hold both halves of a pair.
    acquires: Dict[Tuple[str, str], List[int]] = {}
    releases: Dict[Tuple[str, str], List[int]] = {}

    for node in _walk_no_nested(fn_node):
        # assignment-style acquires: x = socket.socket(...) / open(...)
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Call):
            d = dotted(node.value.func)
            for acq_dotted, release in rules.ACQUIRE_RELEASE_DOTTED:
                if d == acq_dotted:
                    acquires.setdefault(
                        (node.targets[0].id, release), []).append(
                        node.lineno)
        if not isinstance(node, ast.Call):
            continue
        recv = _recv_name(node)
        meth = node.func.attr if isinstance(node.func, ast.Attribute) \
            else None
        if recv is None or meth is None:
            continue
        if meth in method_pairs:
            acquires.setdefault((recv, method_pairs[meth]), []).append(
                node.lineno)
        if meth in release_names:
            releases.setdefault((recv, meth), []).append(node.lineno)

    paired = [key for key in acquires if key in releases]
    if not paired:
        return  # no release here: ownership transferred
    finally_lines = _in_finally_lines(fn_node)
    with_lines = _with_context_lines(fn_node)
    for recv, release in paired:
        acq_lines = [ln for ln in acquires[(recv, release)]
                     if ln not in with_lines]
        if not acq_lines:
            continue
        rel_sites = [(ln, ln in finally_lines)
                     for ln in releases[(recv, release)]]
        acq_line = min(acq_lines)
        later = [(ln, fin) for ln, fin in rel_sites if ln > acq_line]
        if not later:
            continue
        if any(fin for _, fin in later):
            continue  # protected by a finally
        rel_line = min(ln for ln, _ in later)
        if rel_line - acq_line <= 1:
            continue  # nothing in between can raise
        findings.append(Finding(
            rule=rules.MISSING_FINALLY,
            path=relpath, line=acq_line, symbol=symbol,
            message=f"`{recv}` acquired here but released at line "
                    f"{rel_line} outside any finally — an exception in "
                    f"between leaks it"))


def check_project(project: Project, emit_files=None) -> List[Finding]:
    findings: List[Finding] = []
    for f in project.files:
        if emit_files is not None and f.relpath not in emit_files:
            continue  # purely per-file rules: skip entirely
        _check_swallowed(f.tree, f.relpath, findings)
        stack: List[ast.AST] = []

        def visit(node: ast.AST) -> None:
            is_scope = isinstance(
                node, (ast.FunctionDef, ast.AsyncFunctionDef,
                       ast.ClassDef))
            if is_scope:
                stack.append(node)
                if not isinstance(node, ast.ClassDef):
                    _check_releases(node, f.relpath, qualname_of(stack),
                                    findings)
            for child in ast.iter_child_nodes(node):
                visit(child)
            if is_scope:
                stack.pop()

        visit(f.tree)
    return findings


def sites(project: Project) -> int:
    """Broad ``except`` handlers plus ``.acquire()`` calls."""
    n = 0
    for f in project.files:
        for node in ast.walk(f.tree):
            if isinstance(node, ast.ExceptHandler) \
                    and _is_broad_handler(node):
                n += 1
            elif isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr in {
                        a for a, _r in rules.ACQUIRE_RELEASE_METHODS}:
                n += 1
    return n
