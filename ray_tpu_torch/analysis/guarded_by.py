"""guarded-by inference: data races on inconsistently-locked fields.

Whole-program, in three steps:

1. **Thread entry points** — ``threading.Thread(target=...)`` /
   ``Timer`` targets, ``executor.submit(fn)`` submissions, the reactor
   callbacks (rules.REACTOR_ROOT_FUNCS), and every RPC handler
   registered in a ``handlers={...}`` map (those run on the server's
   pool — concurrently with THEMSELVES). A synthetic ``caller`` entry
   stands for user threads: every public method and module function.
2. **Thread reachability** — BFS over the resolved call graph from each
   entry; a function is multi-thread-reachable when ≥2 distinct entries
   reach it, or when it is reachable from a self-concurrent entry
   (pool-executed code races against itself).
3. **Guarded-by inference** — per class field (``self._x`` accesses in
   the class's own methods), the lock held at a strict majority of
   eligible access sites (and at ≥ rules.GUARDED_BY_MIN_LOCKED_SITES of
   them) is the field's inferred guard; an exact tie infers nothing.
   Unguarded reads/writes of a guarded field from multi-thread-reachable
   code are flagged.

Noise control, all deliberate: ``__init__``/``__del__``/``__repr__``
sites are construction-time (excluded); ``*_locked``-suffix methods are
called with the lock held by convention (excluded); fields never
written outside excluded methods are effectively immutable (skipped);
lock/condition attributes themselves are skipped.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from ray_tpu_torch.analysis import rules
from ray_tpu_torch.analysis.callgraph import CallGraph, FunctionInfo, _short
from ray_tpu_torch.analysis.core import Finding
from ray_tpu_torch.analysis.lock_discipline import (LockId, LockIndex,
                                              lock_index)

_CTOR_TAILS = {d.split(".")[-1] for d in rules.THREAD_CTORS}


@dataclass
class AccessSite:
    fqn: str
    qualname: str
    path: str
    line: int
    is_write: bool
    held: FrozenSet[LockId]
    excluded: bool       # __init__-class method or *_locked convention


def thread_entries(graph: CallGraph
                   ) -> Tuple[Dict[str, Set[str]], Set[str]]:
    """-> (entry key -> root fqns, self-concurrent entry keys)."""
    from ray_tpu_torch.analysis import rpc_contract

    entries: Dict[str, Set[str]] = {}
    self_concurrent: Set[str] = set()

    def add(key: str, fqn: str, concurrent: bool = False) -> None:
        entries.setdefault(key, set()).add(fqn)
        if concurrent:
            self_concurrent.add(key)

    graph.edges()  # ensure the calls_by_tail side index is built
    for fqn, info in graph.functions.items():
        tail = info.qualname.rsplit(".", 1)[-1]
        # reactor callbacks all share THE reactor thread
        if (any(info.module.endswith(m) and info.qualname == q
                for m, q in rules.REACTOR_ROOT_FUNCS)
                or tail in rules.REACTOR_ROOT_NAME_PATTERNS):
            add("reactor", fqn)
    for tail_name in _CTOR_TAILS:
        for node, info in graph.calls_by_tail.get(tail_name, ()):
            rd = graph.resolved_dotted(node, info)
            if rd not in rules.THREAD_CTORS:
                continue
            kw_name, pos_idx = rules.THREAD_CTORS[rd]
            target = None
            for kw in node.keywords:
                if kw.arg == kw_name:
                    target = kw.value
            if target is None and len(node.args) > pos_idx:
                target = node.args[pos_idx]
            tfqn = graph.resolve_callable_expr(target, info) \
                if target is not None else None
            if tfqn is not None and tfqn in graph.functions:
                add(f"thread:{_short(tfqn)}", tfqn)
    for verb in rules.EXECUTOR_SUBMIT_METHODS:
        for node, info in graph.calls_by_tail.get(verb, ()):
            if isinstance(node.func, ast.Attribute) and node.args:
                tfqn = graph.resolve_callable_expr(node.args[0], info)
                if tfqn is not None and tfqn in graph.functions:
                    add(f"pool:{_short(tfqn)}", tfqn, concurrent=True)

    # RPC handlers run on the server's worker pool
    _regs, _inline, handler_fqns = \
        rpc_contract.collect_registrations(graph)
    for name, hfqn in handler_fqns.items():
        add(f"rpc:{name}", hfqn, concurrent=True)

    # synthetic caller entry: public surface invoked from user threads
    for fqn, info in graph.functions.items():
        tail = info.qualname.rsplit(".", 1)[-1]
        if not tail.startswith("_"):
            add("caller", fqn)
    return entries, self_concurrent


def reachability(graph: CallGraph, entries: Dict[str, Set[str]]
                 ) -> Dict[str, Set[str]]:
    """fqn -> set of entry keys whose threads can execute it."""
    edges = graph.edges()
    keys_of: Dict[str, Set[str]] = {}
    for key, roots in entries.items():
        queue = [fqn for fqn in roots]
        seen: Set[str] = set(queue)
        while queue:
            fqn = queue.pop()
            keys_of.setdefault(fqn, set()).add(key)
            for callee, _line, _vs in edges.get(fqn, ()):
                if callee not in seen:
                    seen.add(callee)
                    queue.append(callee)
    return keys_of


def _class_fields(graph: CallGraph, index: LockIndex, module: str,
                  cls: str) -> Dict[str, List[AccessSite]]:
    """field name -> access sites across the class's own methods."""
    ci = graph.classes[(module, cls)]
    lock_attrs = {attr for (m, owner, attr) in index.decls
                  if m == module and owner == cls}
    out: Dict[str, List[AccessSite]] = {}
    for meth_name, fqn in ci.methods.items():
        info = graph.functions.get(fqn)
        if info is None:
            continue
        excluded = meth_name in rules.GUARDED_BY_EXCLUDED_METHODS \
            or meth_name.endswith(rules.LOCKED_BY_CONVENTION_SUFFIX)
        seen = set()
        for site in _method_accesses(index, info, lock_attrs):
            field, line, is_write, held = site
            # one site per (line, kind): `self._q + self._q` is one
            # read site, not two votes in the majority inference
            key = (field, line, is_write, held)
            if key in seen:
                continue
            seen.add(key)
            out.setdefault(field, []).append(AccessSite(
                fqn=fqn, qualname=info.qualname,
                path=info.file.relpath, line=line, is_write=is_write,
                held=held, excluded=excluded))
    return out


def _method_accesses(index: LockIndex, info: FunctionInfo,
                     lock_attrs: Set[str]
                     ) -> List[Tuple[str, int, bool, FrozenSet[LockId]]]:
    """(field, line, is_write, held locks) for every ``self.X`` access,
    tracking the lexical ``with <lock>:`` stack. Nested defs are skipped
    (they execute on their own schedule)."""
    sites: List[Tuple[str, int, bool, FrozenSet[LockId]]] = []

    def record(node: ast.AST, held: Tuple[LockId, ...],
               is_write: bool) -> None:
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self" \
                and node.attr not in lock_attrs:
            sites.append((node.attr, node.lineno, is_write,
                          frozenset(held)))

    def scan_expr(node: ast.AST, held: Tuple[LockId, ...]) -> None:
        for sub in ast.walk(node):
            record(sub, held, isinstance(getattr(sub, "ctx", None),
                                         (ast.Store, ast.Del)))

    def visit(stmts: List[ast.stmt], held: Tuple[LockId, ...]) -> None:
        for node in stmts:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                continue
            if isinstance(node, ast.With):
                inner = held
                for item in node.items:
                    lock, _via = index.bind(item.context_expr, info)
                    if lock is not None:
                        inner = inner + (lock,)
                    else:
                        scan_expr(item.context_expr, held)
                    if item.optional_vars is not None:
                        scan_expr(item.optional_vars, held)
                visit(node.body, inner)
                continue
            if isinstance(node, ast.AugAssign):
                # target is both read and written
                record(node.target, held, True)
                scan_expr(node.value, held)
                continue
            # statement-level expressions: walk, excluding nested defs
            for field_name in ("body", "orelse", "finalbody"):
                sub = getattr(node, field_name, None)
                if isinstance(sub, list) and sub \
                        and isinstance(sub[0], ast.stmt):
                    visit(sub, held)
            for h in getattr(node, "handlers", ()):
                visit(h.body, held)
            for sub in ast.iter_child_nodes(node):
                if isinstance(sub, (ast.stmt, ast.FunctionDef,
                                    ast.AsyncFunctionDef, ast.ClassDef,
                                    ast.ExceptHandler)):
                    continue
                scan_expr(sub, held)

    visit(list(info.node.body), ())
    return sites


def _infer_guard(sites: List[AccessSite]
                 ) -> Tuple[Optional[LockId], int, int]:
    """-> (majority lock or None, locked-site count, eligible count)."""
    eligible = [s for s in sites if not s.excluded]
    if not eligible:
        return None, 0, 0
    counts: Dict[LockId, int] = {}
    for s in eligible:
        for lock in s.held:
            counts[lock] = counts.get(lock, 0) + 1
    if not counts:
        return None, 0, len(eligible)
    best = max(counts, key=lambda lk: counts[lk])
    n = counts[best]
    if n < rules.GUARDED_BY_MIN_LOCKED_SITES or n * 2 <= len(eligible):
        return None, n, len(eligible)  # minority or exact tie
    return best, n, len(eligible)


def check(graph: CallGraph, emit_files=None) -> List[Finding]:
    index = lock_index(graph)
    entries, self_concurrent = thread_entries(graph)
    keys_of = reachability(graph, entries)
    findings: List[Finding] = []

    for (module, cls) in sorted(graph.classes):
        if emit_files is not None:
            src = graph.project.by_module.get(module)
            if src is None or src.relpath not in emit_files:
                # a class's fields live in its own file: inference for
                # out-of-slice classes can't produce in-slice findings
                continue
        fields = _class_fields(graph, index, module, cls)
        for field_name, sites in sorted(fields.items()):
            if not any(s.is_write and not s.excluded for s in sites):
                continue  # effectively immutable after construction
            guard, n_locked, n_total = _infer_guard(sites)
            if guard is None:
                continue
            # Contention is a property of the FIELD, not of any single
            # method: a daemon loop mutating it and a public method
            # reading it are two different thread keys even though
            # neither method alone is reachable from two threads.
            field_keys: Set[str] = set()
            concurrent = False
            for s in sites:
                if s.excluded:
                    continue
                ks = keys_of.get(s.fqn, set())
                field_keys |= ks
                concurrent = concurrent or any(
                    k in self_concurrent for k in ks)
            if not (concurrent or len(field_keys) >= 2):
                continue
            for s in sites:
                if s.excluded or guard in s.held:
                    continue
                if not keys_of.get(s.fqn):
                    continue  # unreachable from any entry: dead code
                kind = "written" if s.is_write else "read"
                findings.append(Finding(
                    rule=rules.UNGUARDED_FIELD, path=s.path,
                    line=s.line, symbol=s.qualname,
                    message=f"{cls}.{field_name} is guarded by "
                            f"{guard.label()} at {n_locked}/{n_total} "
                            f"access sites but {kind} without it here; "
                            f"the field is reached from "
                            f"{', '.join(sorted(field_keys)[:4])}"))
    return findings


def sites(graph: CallGraph) -> int:
    """Written class fields whose accesses the inference reads."""
    index = lock_index(graph)
    n = 0
    for (module, cls) in graph.classes:
        fields = _class_fields(graph, index, module, cls)
        n += sum(1 for accesses in fields.values()
                 if any(s.is_write and not s.excluded for s in accesses))
    return n
