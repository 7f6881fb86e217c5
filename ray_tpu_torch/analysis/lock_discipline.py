"""lock-discipline: acquisition-order cycles and blocking under locks.

Builds the package-wide lock graph from ``with <lock>:`` statements
(locks are attributes assigned ``threading.Lock()``/``RLock()``/
``Condition()`` in a class or at module level; ``Condition(self._x)``
aliases to ``_x``). Two rule families:

* lock-order-cycle   — a cycle in the held->acquired edge relation
                       (direct nesting or via resolved package calls) is
                       a deadlock candidate. Self-edges are reported only
                       with same-instance evidence: a ``self.X``
                       (non-reentrant Lock) held while a ``self.``-method
                       chain re-acquires ``self.X``.
* lock-held-blocking — a blocking primitive or RPC verb
                       (``.call``/``.notify``/``ray_tpu_torch.get``/
                       blocking connect/``time.sleep``/unbounded waits)
                       executed, directly or via resolved calls, while a
                       lock is held. Every thread that touches that lock
                       then queues behind the peer's latency.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.analysis import rules
from ray_tpu_torch.analysis.callgraph import (CallGraph, FunctionInfo, dotted,
                                        _short, _walk_no_nested)
from ray_tpu_torch.analysis.core import Finding

_LOCK_CTORS = {"Lock": "lock", "RLock": "rlock", "Condition": "condition"}


@dataclass(frozen=True)
class LockId:
    module: str
    owner: Optional[str]   # class name, or None for module-level
    attr: str
    kind: str              # lock | rlock | condition

    def label(self) -> str:
        owner = f"{self.owner}." if self.owner else ""
        return f"{self.module.split('.')[-1]}:{owner}{self.attr}"


@dataclass
class Acquisition:
    lock: LockId
    line: int
    via_self: bool
    body: List[ast.stmt]


class LockIndex:
    """All lock declarations in the project, with Condition aliasing.
    Use :func:`lock_index` — the per-graph memo — instead of
    constructing directly (two checker families need it)."""

    def __init__(self, graph: CallGraph):
        self.graph = graph
        # (module, owner-or-None, attr) -> LockId
        self.decls: Dict[Tuple[str, Optional[str], str], LockId] = {}
        # attr name -> [LockId] per module, for obj.attr fallback binding
        self.by_attr: Dict[Tuple[str, str], List[LockId]] = {}
        self._aliases: Dict[Tuple[str, Optional[str], str],
                            Tuple[str, Optional[str], str]] = {}
        for f in graph.project.files:
            self._index_module(f)
        # resolve one level of Condition(self._lock) aliasing
        for key, target in self._aliases.items():
            if target in self.decls and key in self.decls:
                self.decls[key] = self.decls[target]

    def _lock_kind(self, value: ast.AST) -> Optional[str]:
        if isinstance(value, ast.Call):
            d = dotted(value.func)
            if d is not None and d.split(".")[-1] in _LOCK_CTORS \
                    and (d.startswith("threading.")
                         or "." not in d):
                return _LOCK_CTORS[d.split(".")[-1]]
        return None

    def _index_module(self, f) -> None:
        def record(owner: Optional[str], attr: str, value: ast.AST
                   ) -> None:
            kind = self._lock_kind(value)
            if kind is None:
                return
            lock = LockId(f.module, owner, attr, kind)
            key = (f.module, owner, attr)
            self.decls[key] = lock
            self.by_attr.setdefault((f.module, attr), []).append(lock)
            if kind == "condition" and isinstance(value, ast.Call) \
                    and value.args:
                arg = value.args[0]
                if isinstance(arg, ast.Attribute) \
                        and isinstance(arg.value, ast.Name) \
                        and arg.value.id == "self":
                    self._aliases[key] = (f.module, owner, arg.attr)

        # single pass, tracking the innermost enclosing class (the old
        # walk-per-class rescanned nested bodies quadratically);
        # module-level locks are recorded from the top level only, as
        # before
        def visit(node: ast.AST, cls: Optional[str]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    visit(child, child.name)
                    continue
                if cls is not None and isinstance(child, ast.Assign):
                    for tgt in child.targets:
                        if isinstance(tgt, ast.Attribute) \
                                and isinstance(tgt.value, ast.Name) \
                                and tgt.value.id == "self":
                            record(cls, tgt.attr, child.value)
                        elif isinstance(tgt, ast.Name):
                            record(cls, tgt.id, child.value)
                visit(child, cls)

        visit(f.tree, None)
        for node in f.tree.body:
            if isinstance(node, ast.Assign):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        record(None, tgt.id, node.value)

    def bind(self, expr: ast.AST, ctx: FunctionInfo
             ) -> Tuple[Optional[LockId], bool]:
        """Bind a with-item expression to a declared lock."""
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name):
            base, attr = expr.value.id, expr.attr
            if base in ("self", "cls") and ctx.cls is not None:
                hit = self.decls.get((ctx.module, ctx.cls, attr))
                if hit is not None:
                    return hit, True
                # lock declared on a base/sibling class in this module
                cands = self.by_attr.get((ctx.module, attr), [])
                if len(cands) == 1:
                    return cands[0], True
                return None, False
            # Cls.attr (class-level lock accessed via the class)
            hit = self.decls.get((ctx.module, base, attr))
            if hit is not None:
                return hit, False
            cands = self.by_attr.get((ctx.module, attr), [])
            if len(cands) == 1:
                return cands[0], False
        elif isinstance(expr, ast.Name):
            hit = self.decls.get((ctx.module, None, expr.id))
            if hit is not None:
                return hit, False
        return None, False


def lock_index(graph: CallGraph) -> LockIndex:
    """Per-graph LockIndex memo (lock-discipline and guarded-by both
    need it; indexing the whole package twice showed up in profiles)."""
    cached = getattr(graph, "_lock_index", None)
    if cached is None:
        cached = LockIndex(graph)
        graph._lock_index = cached
    return cached


def _acquisitions(index: LockIndex, info: FunctionInfo
                  ) -> List[Acquisition]:
    """Every bound lock acquisition in the function (nested ``with``
    blocks included, nested defs excluded). Reads the graph's
    withs-by-fqn side index — most functions have no ``with`` at all
    and are skipped without touching their bodies."""
    out: List[Acquisition] = []
    for node in index.graph.withs_by_fqn.get(info.fqn, ()):
        for item in node.items:
            lock, via_self = index.bind(item.context_expr, info)
            if lock is not None:
                out.append(Acquisition(lock, node.lineno, via_self,
                                       node.body))
    return out


def _locks_acquired_closure(graph: CallGraph, index: LockIndex,
                            direct: Dict[str, List[Acquisition]]
                            ) -> Dict[str, Set[Tuple[LockId, bool]]]:
    """fqn -> set of (lock, self_chain) acquired in it or its resolved
    callees. self_chain is True only while every hop is a self.-call and
    the final acquisition is via self (same-instance evidence)."""
    edges: Dict[str, List[Tuple[str, bool]]] = {
        fqn: [(callee, via_self) for callee, _line, via_self in rows]
        for fqn, rows in graph.edges().items()}

    closure: Dict[str, Set[Tuple[LockId, bool]]] = {
        fqn: {(a.lock, a.via_self) for a in acqs}
        for fqn, acqs in direct.items()}
    changed = True
    iters = 0
    while changed and iters < 20:
        changed = False
        iters += 1
        for fqn, outs in edges.items():
            cur = closure[fqn]
            before = len(cur)
            for callee, via_self in outs:
                for lock, self_chain in list(closure.get(callee, ())):
                    cur.add((lock, self_chain and via_self))
            if len(cur) != before:
                changed = True
    return closure


def _blocking_chains(graph: CallGraph) -> Dict[str, List[str]]:
    table = dict(rules.BLOCKING_DOTTED)
    table.update(rules.RPC_DOTTED)
    return graph.blocking_closure(
        table, dict(rules.BLOCKING_METHODS_ALWAYS),
        dict(rules.BLOCKING_METHODS_UNBOUNDED))


def _direct_rpc_sites(graph: CallGraph, info: FunctionInfo
                      ) -> List[Tuple[int, str]]:
    """.call/.notify RPC verbs + resolved RPC dotted names, direct only."""
    sites: List[Tuple[int, str]] = []
    for node in _walk_no_nested(info.node):
        if not isinstance(node, ast.Call):
            continue
        rd = graph.resolved_dotted(node, info)
        if rd is not None and rd in rules.RPC_DOTTED:
            sites.append((node.lineno, f"{rd} ({rules.RPC_DOTTED[rd]})"))
        elif isinstance(node.func, ast.Attribute) \
                and node.func.attr in rules.RPC_METHODS:
            sites.append((node.lineno,
                          f".{node.func.attr}() "
                          f"({rules.RPC_METHODS[node.func.attr]})"))
    return sites


def check(graph: CallGraph, emit_files=None) -> List[Finding]:
    index = lock_index(graph)
    findings: List[Finding] = []
    chains = _blocking_chains(graph)
    direct_acqs: Dict[str, List[Acquisition]] = {
        fqn: _acquisitions(index, info)
        for fqn, info in graph.functions.items()}
    closure = _locks_acquired_closure(graph, index, direct_acqs)

    # fqn -> [(line, label)] for direct blocking sites (lock table: no
    # file I/O — serializing a file write is often the lock's purpose).
    lock_dotted = dict(rules.BLOCKING_DOTTED)
    lock_dotted.update(rules.RPC_DOTTED)

    edge_sites: Dict[Tuple[LockId, LockId], Tuple[str, int]] = {}
    edges: Dict[LockId, Set[LockId]] = {}
    self_edges: List[Tuple[LockId, str, int]] = []

    for fqn, info in graph.functions.items():
        # ordering edges are whole-program (a cycle can span files); only
        # the per-site blocking findings are sliceable
        emit_here = emit_files is None \
            or info.file.relpath in emit_files
        for acq in direct_acqs[fqn]:
            held = acq.lock
            # -------- blocking under the lock (direct statements)
            for node in _iter_body(acq.body):
                if not isinstance(node, ast.Call):
                    continue
                label = _blocking_label(graph, info, node, lock_dotted)
                if label is not None and not emit_here:
                    continue
                if label is not None:
                    findings.append(Finding(
                        rule=rules.LOCK_HELD_BLOCKING,
                        path=info.file.relpath, line=node.lineno,
                        symbol=info.qualname,
                        message=f"{label} while holding "
                                f"{held.label()}"))
                    continue
                callee, via_self = graph.resolve_call_cached(node, info)
                if callee is not None and callee in chains \
                        and emit_here:
                    chain = " -> ".join(chains[callee])
                    findings.append(Finding(
                        rule=rules.LOCK_HELD_BLOCKING,
                        path=info.file.relpath, line=node.lineno,
                        symbol=info.qualname,
                        message=f"call into blocking {_short(callee)} "
                                f"({chain}) while holding "
                                f"{held.label()}"))
                # -------- ordering edges via calls
                if callee is not None:
                    for lock, self_chain in closure.get(callee, ()):
                        if lock == held:
                            if self_chain and via_self and acq.via_self \
                                    and held.kind == "lock":
                                self_edges.append(
                                    (held, info.qualname, node.lineno))
                            continue
                        edges.setdefault(held, set()).add(lock)
                        edge_sites.setdefault(
                            (held, lock),
                            (f"{info.file.relpath}:{node.lineno} "
                             f"({info.qualname} -> {_short(callee)})",
                             node.lineno))
            # -------- ordering edges via direct nesting
            for inner in _nested_acquisitions(index, info, acq.body):
                if inner.lock == held:
                    if inner.via_self and acq.via_self \
                            and held.kind == "lock":
                        self_edges.append(
                            (held, info.qualname, inner.line))
                    continue
                edges.setdefault(held, set()).add(inner.lock)
                edge_sites.setdefault(
                    (held, inner.lock),
                    (f"{info.file.relpath}:{inner.line} "
                     f"({info.qualname})", inner.line))

    # -------- cycles (length >= 2) via DFS
    for cycle in _find_cycles(edges):
        a, b = cycle[0], cycle[1 % len(cycle)]
        site, line = edge_sites.get((a, b), ("?", 0))
        info_file, qn = _site_owner(graph, site)
        findings.append(Finding(
            rule=rules.LOCK_ORDER_CYCLE,
            path=info_file or "ray_tpu_torch", line=line, symbol=qn,
            message="lock-order cycle (deadlock candidate): "
                    + " -> ".join(lk.label() for lk in cycle)
                    + f" -> {cycle[0].label()}; first edge at {site}"))
    for held, qn, line in self_edges:
        owner_file = graph.project.by_module[held.module].relpath
        findings.append(Finding(
            rule=rules.LOCK_ORDER_CYCLE,
            path=owner_file, line=line, symbol=qn,
            message=f"re-acquisition of non-reentrant {held.label()} on "
                    f"the same instance via a self.-call chain "
                    f"(self-deadlock)"))
    if emit_files is not None:
        findings = [f for f in findings if f.path in emit_files]
    return findings


def _blocking_label(graph: CallGraph, info: FunctionInfo, node: ast.Call,
                    lock_dotted: Dict[str, str]) -> Optional[str]:
    rd = graph.resolved_dotted(node, info)
    if rd is not None and rd in lock_dotted:
        return f"{rd} ({lock_dotted[rd]})"
    if isinstance(node.func, ast.Attribute):
        meth = node.func.attr
        if meth in rules.RPC_METHODS:
            return f".{meth}() ({rules.RPC_METHODS[meth]})"
        if meth in rules.BLOCKING_METHODS_ALWAYS:
            return f".{meth}() ({rules.BLOCKING_METHODS_ALWAYS[meth]})"
        if meth in rules.BLOCKING_METHODS_UNBOUNDED and not node.args \
                and not node.keywords:
            return f".{meth}() ({rules.BLOCKING_METHODS_UNBOUNDED[meth]})"
    return None


def _iter_body(stmts: List[ast.stmt]):
    stack: List[ast.AST] = list(stmts)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _nested_acquisitions(index: LockIndex, info: FunctionInfo,
                         body: List[ast.stmt]) -> List[Acquisition]:
    out: List[Acquisition] = []
    for node in _iter_body(body):
        if isinstance(node, ast.With):
            for item in node.items:
                lock, via_self = index.bind(item.context_expr, info)
                if lock is not None:
                    out.append(Acquisition(lock, node.lineno, via_self,
                                           node.body))
    return out


def _find_cycles(edges: Dict[LockId, Set[LockId]]) -> List[List[LockId]]:
    """Simple cycle enumeration, deduped by cycle node-set."""
    cycles: List[List[LockId]] = []
    seen_sets: Set[frozenset] = set()

    def dfs(start: LockId, node: LockId, path: List[LockId],
            on_path: Set[LockId]) -> None:
        for nxt in edges.get(node, ()):
            if nxt == start and len(path) >= 2:
                key = frozenset(path)
                if key not in seen_sets:
                    seen_sets.add(key)
                    cycles.append(list(path))
            elif nxt not in on_path and len(path) < 6:
                on_path.add(nxt)
                dfs(start, nxt, path + [nxt], on_path)
                on_path.discard(nxt)

    for start in list(edges):
        dfs(start, start, [start], {start})
    return cycles


def _site_owner(graph: CallGraph, site: str) -> Tuple[Optional[str], str]:
    path = site.split(":", 1)[0] if ":" in site else None
    qn = site.split("(")[-1].rstrip(")") if "(" in site else "<module>"
    return path, qn.split(" ->")[0].strip()


def sites(graph: CallGraph) -> int:
    """Bound lock acquisitions (``with <lock>:``) in the package."""
    index = lock_index(graph)
    return sum(len(_acquisitions(index, info))
               for info in graph.functions.values())
