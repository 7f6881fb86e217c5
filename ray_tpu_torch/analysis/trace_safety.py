"""trace-safety: host syncs, tensor branches, recompile hazards in the
port's compiled and captured regions.

A compiled or captured region runs on the card's own schedule: a hidden
host sync inside it is a graph break under ``torch.compile`` (or a
failed capture under ``torch.cuda.graph``), and a branch on a tensor's
value recompiles per value. Nothing crashes; it is only visible as step
time. This checker finds the regions:

* functions compiled or scripted — ``@torch.compile`` /
  ``@torch.compile(...)`` / ``@torch.jit.script`` decorators, or the
  wrapping call (``f2 = torch.compile(f)``, ``torch.jit.trace(f, x)``,
  ``torch.cuda.make_graphed_callables(f, x)``);
* the body of a ``with torch.cuda.graph(g):`` capture,

and flags, with a light forward taint pass over the function body:

* trace-host-sync      — ``.item()``/``.tolist()``/``.cpu()``/
                         ``.numpy()``/``torch.cuda.synchronize``/
                         ``np.asarray`` on tensors, ``float()/int()/
                         bool()`` of a traced name.
* trace-python-branch  — ``if``/``while`` whose test uses a traced name
                         directly (``.shape``/``.dtype``/``.ndim``/
                         ``len()``/``is None``/``isinstance`` uses are
                         static and exempt).
* trace-retrace-hazard — a traced name in a shape position
                         (``torch.zeros(n)``), or iterating a ``set``
                         while building the region's inputs (unordered
                         => guard churn).

Taint = function parameters that are not annotated with a non-tensor
type (``int``, a config class: guarded constants under the compiler)
plus names assigned from expressions that use tainted names or call
into ``torch``. ``x.shape``-style attribute reads are static and
un-taint. Package functions called from a region (transitively) get
only the unambiguous checks (``.item()`` etc.).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.analysis import rules
from ray_tpu_torch.analysis.callgraph import (CallGraph, FunctionInfo, dotted,
                                              _walk_no_nested)
from ray_tpu_torch.analysis.core import Finding

_STATIC_ATTRS = {"shape", "dtype", "ndim", "device", "layout",
                 "requires_grad", "is_cuda"}


def _resolve(graph: CallGraph, info: FunctionInfo,
             expr: ast.AST) -> Optional[str]:
    """Dotted name of ``expr`` with its leading import alias resolved
    (``compile`` -> ``torch.compile`` for ``from torch import compile``)."""
    d = dotted(expr)
    if d is None:
        return None
    head, _, rest = d.partition(".")
    imp = graph._import_target(info, head)
    if imp is None or imp[1] is None:
        return d
    return f"{imp[1]}.{rest}" if rest else imp[1]


def _is_scope_callable(graph: CallGraph, info: FunctionInfo,
                       expr: ast.AST) -> bool:
    return _resolve(graph, info, expr) in rules.TRACE_SCOPE_DOTTED


def _is_scope_decorator(graph: CallGraph, info: FunctionInfo,
                        dec: ast.expr) -> bool:
    if isinstance(dec, ast.Call):
        dec = dec.func
    return _is_scope_callable(graph, info, dec)


def _find_regions(graph: CallGraph) -> Set[str]:
    """fqns of directly compiled / scripted / graphed functions."""
    marked: Set[str] = set()
    for fqn, info in graph.functions.items():
        if any(_is_scope_decorator(graph, info, dec)
               for dec in getattr(info.node, "decorator_list", [])):
            marked.add(fqn)
    # wrapping form: torch.compile(f) / torch.jit.trace(self._step, x)
    graph.edges()  # calls_by_tail is built as an edge-walk side index
    tails = {d.rsplit(".", 1)[-1] for d in rules.TRACE_SCOPE_DOTTED}
    # aliased imports (``from torch import compile as fast``)
    tables = list(graph.imports.values()) + [
        info.local_imports for info in graph.functions.values()]
    for table in tables:
        tails.update(name for name, (_kind, target) in table.items()
                     if target in rules.TRACE_SCOPE_DOTTED)
    for tail in sorted(tails):
        for node, info in graph.calls_by_tail.get(tail, ()):
            if not (node.args
                    and _is_scope_callable(graph, info, node.func)):
                continue
            arg = node.args[0]
            if isinstance(arg, (ast.Name, ast.Attribute)):
                fake = ast.Call(func=arg, args=[], keywords=[])
                ast.copy_location(fake, arg)
                callee, _ = graph.resolve_call(fake, info)
                if callee is not None and callee in graph.functions:
                    marked.add(callee)
    return marked


def _captures(graph: CallGraph, info: FunctionInfo) -> List[ast.With]:
    """``with torch.cuda.graph(g):`` blocks in this function."""
    out = []
    for node in _walk_no_nested(info.node):
        if isinstance(node, ast.With) and any(
                isinstance(item.context_expr, ast.Call)
                and _resolve(graph, info, item.context_expr.func)
                in rules.TRACE_CAPTURE_CTXS
                for item in node.items):
            out.append(node)
    return out


def _numpy_aliases(graph: CallGraph, info: FunctionInfo) -> Set[str]:
    out = set()
    for table in (graph.imports.get(info.module, {}), info.local_imports):
        for name, (kind, target) in table.items():
            if kind == "module" and target == "numpy":
                out.add(name)
    return out


def _torch_heads(graph: CallGraph, info: FunctionInfo) -> Set[str]:
    """Local names bound to ``torch`` or a submodule of it."""
    out = {"torch"}
    for table in (graph.imports.get(info.module, {}), info.local_imports):
        for name, (kind, target) in table.items():
            if kind == "module" and target is not None and (
                    target == "torch" or target.startswith("torch.")):
                out.add(name)
    return out


def _static_annotation(ann: Optional[ast.AST]) -> bool:
    """A parameter annotated with a type that is not a tensor: the
    compiler guards on its value, it is not traced."""
    if ann is None:
        return False
    return not any(isinstance(n, (ast.Name, ast.Attribute))
                   and (dotted(n) or "").split(".")[-1] == "Tensor"
                   for n in ast.walk(ann))


def _taint(info: FunctionInfo, heads: Set[str]) -> Set[str]:
    """Forward pass: which local names carry traced tensors."""
    args = info.node.args
    traced: Set[str] = set()
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        if a.arg in ("self", "cls") or _static_annotation(a.annotation):
            continue
        traced.add(a.arg)

    def uses_traced(expr: ast.AST) -> bool:
        # Manual walk so `x.shape[0]`-style static reads are PRUNED —
        # the `x` underneath must not taint the assignment target.
        stack = [expr]
        while stack:
            n = stack.pop()
            if isinstance(n, ast.Attribute) and n.attr in _STATIC_ATTRS:
                continue  # static metadata read: don't descend
            if isinstance(n, ast.Call):
                d = dotted(n.func)
                if d is not None and d.split(".")[0] in heads:
                    return True
                if d in ("len", "isinstance", "type"):
                    continue  # static: don't descend into the argument
            if isinstance(n, ast.Name) and n.id in traced:
                return True
            stack.extend(ast.iter_child_nodes(n))
        return False

    # two passes to reach a simple fixpoint on straight-line code
    for _ in range(2):
        for node in _walk_no_nested(info.node):
            if isinstance(node, ast.Assign):
                tainted = uses_traced(node.value)
                for tgt in node.targets:
                    for n in ast.walk(tgt):
                        if isinstance(n, ast.Name):
                            if tainted:
                                traced.add(n.id)
                            else:
                                traced.discard(n.id)
            elif isinstance(node, ast.AugAssign) and \
                    isinstance(node.target, ast.Name):
                if uses_traced(node.value):
                    traced.add(node.target.id)
    return traced


def _test_traced_names(test: ast.AST, traced: Set[str]) -> List[str]:
    """Traced names used *directly* in a test (static contexts exempt)."""
    static_name_ids: Set[int] = set()
    for n in ast.walk(test):
        if isinstance(n, ast.Attribute) and n.attr in _STATIC_ATTRS:
            for sub in ast.walk(n.value):
                if isinstance(sub, ast.Name):
                    static_name_ids.add(id(sub))
        elif isinstance(n, ast.Call):
            d = dotted(n.func)
            if d in ("len", "isinstance", "getattr", "hasattr", "type"):
                for sub in ast.walk(n):
                    if isinstance(sub, ast.Name):
                        static_name_ids.add(id(sub))
        elif isinstance(n, ast.Compare) and any(
                isinstance(op, (ast.Is, ast.IsNot)) for op in n.ops):
            for sub in ast.walk(n):
                if isinstance(sub, ast.Name):
                    static_name_ids.add(id(sub))
    hits = []
    for n in ast.walk(test):
        if isinstance(n, ast.Name) and n.id in traced \
                and id(n) not in static_name_ids:
            hits.append(n.id)
    return hits


def _check_nodes(graph: CallGraph, info: FunctionInfo, nodes,
                 traced: Set[str], findings: List[Finding]) -> None:
    """Every check on the statements of a compiled function or of a
    capture block."""
    np_aliases = _numpy_aliases(graph, info)
    for node in nodes:
        if isinstance(node, ast.Call):
            _check_sync_call(graph, info, node, traced, np_aliases,
                             findings, in_marked=True)
            _check_shape_position(info, node, traced, findings)
        elif isinstance(node, (ast.If, ast.While)):
            hits = _test_traced_names(node.test, traced)
            if hits:
                kind = "while" if isinstance(node, ast.While) else "if"
                findings.append(Finding(
                    rule=rules.TRACE_PY_BRANCH,
                    path=info.file.relpath, line=node.lineno,
                    symbol=info.qualname,
                    message=f"`{kind}` on traced value(s) "
                            f"{sorted(set(hits))} inside a compiled "
                            f"region — use torch.where/torch.cond or "
                            f"hoist to a guarded Python argument"))
        elif isinstance(node, ast.For):
            it = node.iter
            is_set = isinstance(it, ast.Set) or (
                isinstance(it, ast.Call) and dotted(it.func) == "set")
            if is_set:
                findings.append(Finding(
                    rule=rules.TRACE_RETRACE,
                    path=info.file.relpath, line=node.lineno,
                    symbol=info.qualname,
                    message="iterating a set inside a compiled region — "
                            "unordered iteration churns the guards and "
                            "recompiles"))


def _capture_nodes(capture: ast.With):
    """The statements of a capture block, nested defs excluded."""
    stack = list(capture.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _check_sync_call(graph: CallGraph, info: FunctionInfo, node: ast.Call,
                     traced: Set[str], np_aliases: Set[str],
                     findings: List[Finding], in_marked: bool) -> None:
    path, qn = info.file.relpath, info.qualname

    def add(rule: str, msg: str) -> None:
        findings.append(Finding(rule=rule, path=path, line=node.lineno,
                                symbol=qn, message=msg))

    rd = graph.resolved_dotted(node, info)
    if rd in rules.TRACE_SYNC_DOTTED:
        add(rules.TRACE_HOST_SYNC,
            f"{rules.TRACE_SYNC_DOTTED[rd]} inside a compiled region")
        return
    if isinstance(node.func, ast.Attribute):
        meth = node.func.attr
        if meth in rules.TRACE_SYNC_METHODS:
            add(rules.TRACE_HOST_SYNC,
                f"{rules.TRACE_SYNC_METHODS[meth]} inside a compiled "
                f"region")
            return
    d = dotted(node.func)
    if d is not None and "." in d:
        head, _, tail = d.partition(".")
        if head in np_aliases and tail in rules.NUMPY_SYNC_FUNCS \
                and node.args and not isinstance(node.args[0],
                                                 ast.Constant):
            add(rules.TRACE_HOST_SYNC,
                f"numpy {tail}() inside a compiled region copies the "
                f"tensor to the host")
            return
    if in_marked and d in ("float", "int", "bool") and len(node.args) == 1:
        arg = node.args[0]
        names = {n.id for n in ast.walk(arg) if isinstance(n, ast.Name)}
        if names & traced:
            add(rules.TRACE_HOST_SYNC,
                f"{d}() of a traced tensor inside a compiled region is "
                f"a host sync (a graph break; an error under capture)")


def _check_shape_position(info: FunctionInfo, node: ast.Call,
                          traced: Set[str],
                          findings: List[Finding]) -> None:
    d = dotted(node.func)
    if d is None:
        return
    tail = d.split(".")[-1]
    if tail not in rules.SHAPE_POSITION_FUNCS or "." not in d:
        return  # bare zeros()/full() etc. unlikely to be torch's
    shape_args: List[ast.AST] = []
    if node.args:
        shape_args.append(node.args[0])
    shape_args.extend(kw.value for kw in node.keywords
                      if kw.arg == "size")
    for arg in shape_args:
        hits = [n.id for n in ast.walk(arg)
                if isinstance(n, ast.Name) and n.id in traced]
        # x.shape-derived ints are fine; the taint pass already excludes
        # them, so a hit here is a traced VALUE in a shape slot.
        if hits:
            findings.append(Finding(
                rule=rules.TRACE_RETRACE,
                path=info.file.relpath, line=node.lineno,
                symbol=info.qualname,
                message=f"traced value(s) {sorted(set(hits))} in shape "
                        f"position of {tail}() — a host sync and a "
                        f"recompile per value"))
            return


def _regions(graph: CallGraph
             ) -> Tuple[Set[str], Dict[str, List[ast.With]]]:
    """(compiled fqns, fqn -> capture blocks), memoized on the graph
    (``check`` and ``sites`` both read it)."""
    cached = getattr(graph, "_trace_regions", None)
    if cached is None:
        graph.edges()
        captures = {}
        for fqn in graph.withs_by_fqn:
            found = _captures(graph, graph.functions[fqn])
            if found:
                captures[fqn] = found
        cached = (_find_regions(graph), captures)
        graph._trace_regions = cached
    return cached


def sites(graph: CallGraph) -> int:
    """Compiled functions plus capture blocks: the regions this family
    reads."""
    marked, captures = _regions(graph)
    return len(marked) + sum(len(v) for v in captures.values())


def check(graph: CallGraph, emit_files=None) -> List[Finding]:
    findings: List[Finding] = []
    graph.edges()  # ensure side indexes exist

    def in_slice(info: FunctionInfo) -> bool:
        return emit_files is None or info.file.relpath in emit_files

    marked, captures = _regions(graph)
    for fqn in marked:
        info = graph.functions[fqn]
        if in_slice(info):
            traced = _taint(info, _torch_heads(graph, info))
            _check_nodes(graph, info, _walk_no_nested(info.node), traced,
                         findings)
    roots: List[str] = list(marked)
    for fqn, blocks in captures.items():
        info = graph.functions[fqn]
        traced = _taint(info, _torch_heads(graph, info))
        for block in blocks:
            if in_slice(info):
                _check_nodes(graph, info, _capture_nodes(block), traced,
                             findings)
            lines = {n.lineno for n in _capture_nodes(block)
                     if hasattr(n, "lineno")}
            for callee, line, _vs in graph.edges().get(fqn, ()):
                if line in lines:
                    roots.append(callee)
    # package functions a region calls: unambiguous host syncs only
    reachable: Set[str] = set()
    queue = list(roots)
    seen: Set[str] = set(queue)
    for fqn in roots:
        if fqn not in marked:
            reachable.add(fqn)
    while queue:
        fqn = queue.pop(0)
        for callee, _line, _vs in graph.edges().get(fqn, ()):
            if callee not in seen:
                seen.add(callee)
                reachable.add(callee)
                queue.append(callee)
    for fqn in reachable:
        if fqn in marked or fqn not in graph.functions:
            continue
        info = graph.functions[fqn]
        if not in_slice(info):
            continue
        np_aliases = _numpy_aliases(graph, info)
        for node in _walk_no_nested(info.node):
            if isinstance(node, ast.Call):
                _check_sync_call(graph, info, node, set(), np_aliases,
                                 findings, in_marked=False)
    return findings
