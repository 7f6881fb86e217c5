"""Donation-aliasing family: donated jit programs, statically.

Two real wrong-numbers bugs of the JAX engine drive these rules. One: a donated
executable reloaded from the persistent XLA disk cache segfaults or
returns wrong numbers (jaxlib 0.4.37), so the decode engine routes
every donated program's FIRST dispatch through ``_dispatch_fresh``,
which detaches the disk cache for that compile. Two: ``np.asarray``
over a jax dispatch result (or donated device state) returns a host
VIEW of the device buffer — the next donated dispatch clobbers it in
place, silently corrupting tokens already handed to clients; the
convention is ``np.array`` (an owning copy). Both were convention-only
across 60+ sites; these rules pin them:

**donation-unguarded-dispatch** — a program constructed with
``jit(..., donate_argnums=...)`` (recognized through wrapper calls
like ``_mesh_scoped``, via ``rules.DONATION_JIT_KWARGS``) and bound to
a ``self.`` attribute or local, dispatched WITHOUT flowing through a
guard named in ``rules.DONATED_DISPATCH_GUARDS`` (i.e. not inside an
argument of ``self._dispatch_fresh(key, lambda: ...)`` and not in the
guard's own body).

**donation-asarray-alias** — ``np.asarray(x)`` (import-resolved to
numpy — ``jnp.asarray`` is device-side and fine) inside a class that
owns donated programs, where ``x`` derives from donated device state:
a ``self.`` attribute that appears in a donated argument position or
is assigned from a dispatch result, or a local bound from a dispatch
result. Suggests ``np.array`` (copy).

**donation-read-after-donate** — a LOCAL passed in a donated argument
position and read again afterwards without an intervening rebind: the
dispatch invalidated the buffer, so the read observes freed/clobbered
device memory.

In ray_tpu_torch these rules read no site: the port builds no program
with donated buffers. They stay in ``rules.ALL_RULES`` and keep the JAX
spellings, so one written that way would be read.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.analysis import rules
from ray_tpu_torch.analysis.callgraph import CallGraph, FunctionInfo
from ray_tpu_torch.analysis.core import Finding


def _walk_with_lambdas(fn_node: ast.AST):
    """Function-body walk that DOES descend into lambdas (a guarded
    dispatch lives inside ``lambda: self._prog(...)``) but not into
    nested defs/classes (separately indexed functions)."""
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _donation_indices(call: ast.Call) -> Optional[Tuple[int, ...]]:
    for kw in call.keywords:
        if kw.arg in rules.DONATION_JIT_KWARGS:
            v = kw.value
            if isinstance(v, ast.Constant) and isinstance(v.value, int):
                return (v.value,)
            if isinstance(v, (ast.Tuple, ast.List)):
                idxs = tuple(e.value for e in v.elts
                             if isinstance(e, ast.Constant)
                             and isinstance(e.value, int))
                return idxs or None
            return ()  # donating, indices unknown: guard still applies
    return None


def _find_donating_call(value: ast.AST) -> Optional[Tuple[int, ...]]:
    """Donated indices of the innermost donating jit construction in an
    assignment RHS (wrapper calls like _mesh_scoped included)."""
    for node in ast.walk(value):
        if isinstance(node, ast.Call):
            idxs = _donation_indices(node)
            if idxs is not None:
                return idxs
    return None


class _Index:
    """Per-project donation index: which self-attrs / locals bind
    donated programs, and which calls dispatch them."""

    def __init__(self, graph: CallGraph):
        self.graph = graph
        # (module, cls, attr) -> donated arg indices
        self.donated_attrs: Dict[Tuple[str, Optional[str], str],
                                 Tuple[int, ...]] = {}
        # fqn -> {local name -> donated arg indices}
        self.donated_locals: Dict[str, Dict[str, Tuple[int, ...]]] = {}
        graph.edges()
        for fqn, info in graph.functions.items():
            for node in _walk_with_lambdas(info.node):
                if not (isinstance(node, ast.Assign)
                        and len(node.targets) == 1):
                    continue
                idxs = _find_donating_call(node.value)
                if idxs is None:
                    continue
                tgt = node.targets[0]
                if isinstance(tgt, ast.Attribute) \
                        and isinstance(tgt.value, ast.Name) \
                        and tgt.value.id == "self" \
                        and info.cls is not None:
                    self.donated_attrs[
                        (info.module, info.cls, tgt.attr)] = idxs
                elif isinstance(tgt, ast.Name):
                    self.donated_locals.setdefault(fqn, {})[
                        tgt.id] = idxs
        self.owner_classes: Set[Tuple[str, str]] = {
            (mod, cls) for (mod, cls, _a) in self.donated_attrs}

    def dispatch_indices(self, call: ast.Call, info: FunctionInfo
                         ) -> Optional[Tuple[int, ...]]:
        """Donated arg indices when ``call`` dispatches a donated
        program (self-attr or local), else None."""
        func = call.func
        if isinstance(func, ast.Attribute) \
                and isinstance(func.value, ast.Name) \
                and func.value.id == "self" and info.cls is not None:
            return self.donated_attrs.get(
                (info.module, info.cls, func.attr))
        if isinstance(func, ast.Name):
            return self.donated_locals.get(info.fqn, {}).get(func.id)
        return None


def _guarded_call_ids(info: FunctionInfo) -> Set[int]:
    """ids of every Call node inside an argument of a guard-wrapper
    call (the ``self._dispatch_fresh(key, lambda: ...)`` shape)."""
    out: Set[int] = set()
    for node in _walk_with_lambdas(info.node):
        if not isinstance(node, ast.Call):
            continue
        func = node.func
        tail = func.attr if isinstance(func, ast.Attribute) else (
            func.id if isinstance(func, ast.Name) else None)
        if tail not in rules.DONATED_DISPATCH_GUARDS:
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            for sub in ast.walk(arg):
                if isinstance(sub, ast.Call):
                    out.add(id(sub))
    return out


def _check_unguarded(index: _Index, findings: List[Finding]) -> None:
    for fqn, info in index.graph.functions.items():
        if (info.module, info.cls) not in index.owner_classes \
                and fqn not in index.donated_locals:
            continue
        if info.node.name in rules.DONATED_DISPATCH_GUARDS:
            continue    # the guard's own body IS the guarded path
        guarded = _guarded_call_ids(info)
        for node in _walk_with_lambdas(info.node):
            if not isinstance(node, ast.Call) or id(node) in guarded:
                continue
            if index.dispatch_indices(node, info) is None:
                continue
            prog = ast.unparse(node.func) if hasattr(ast, "unparse") \
                else "<donated program>"
            findings.append(Finding(
                rule=rules.DONATION_UNGUARDED,
                path=info.file.relpath, line=node.lineno,
                symbol=info.qualname,
                message=(f"donated program {prog} dispatched outside "
                         f"the fresh-compile guard "
                         f"({'/'.join(rules.DONATED_DISPATCH_GUARDS)}):"
                         f" its first dispatch may reload the donated "
                         f"executable from the persistent XLA cache "
                         f"(jaxlib 0.4.37: segfault or wrong numbers)"
                         f" — wrap it as self._dispatch_fresh(key, "
                         f"lambda: ...)")))


def _base_of(node: ast.AST) -> ast.AST:
    """Strip subscripts/slices: the object an expression views into."""
    while isinstance(node, ast.Subscript):
        node = node.value
    return node


def _donated_state(index: _Index, info: FunctionInfo
                   ) -> Tuple[Set[str], Set[str]]:
    """(self-attrs holding donated device state, locals bound from
    dispatch results) for one function: attrs fed into donated arg
    positions or assigned from dispatch results, and result locals of
    donated/guarded dispatch calls."""
    attrs: Set[str] = set()
    result_locals: Set[str] = set()

    def is_dispatch(call: ast.Call) -> bool:
        if index.dispatch_indices(call, info) is not None:
            return True
        func = call.func
        tail = func.attr if isinstance(func, ast.Attribute) else None
        return tail in rules.DONATED_DISPATCH_GUARDS

    for node in _walk_with_lambdas(info.node):
        if isinstance(node, ast.Call):
            idxs = index.dispatch_indices(node, info)
            if idxs:
                for i in idxs:
                    if i < len(node.args):
                        base = _base_of(node.args[i])
                        if isinstance(base, ast.Attribute) \
                                and isinstance(base.value, ast.Name) \
                                and base.value.id == "self":
                            attrs.add(base.attr)
        elif isinstance(node, ast.Assign) and isinstance(node.value,
                                                         ast.Call) \
                and is_dispatch(node.value):
            targets: List[ast.AST] = []
            for t in node.targets:
                targets += list(t.elts) if isinstance(
                    t, (ast.Tuple, ast.List)) else [t]
            for t in targets:
                if isinstance(t, ast.Name):
                    result_locals.add(t.id)
                elif isinstance(t, ast.Attribute) \
                        and isinstance(t.value, ast.Name) \
                        and t.value.id == "self":
                    attrs.add(t.attr)
    return attrs, result_locals


def _check_asarray_alias(index: _Index,
                         findings: List[Finding]) -> None:
    graph = index.graph
    # donated state attrs are a CLASS property: any method's dispatch
    # teaches every other method's asarray check.
    cls_attrs: Dict[Tuple[str, str], Set[str]] = {}
    fn_locals: Dict[str, Set[str]] = {}
    for fqn, info in graph.functions.items():
        if (info.module, info.cls) not in index.owner_classes:
            continue
        attrs, result_locals = _donated_state(index, info)
        cls_attrs.setdefault((info.module, info.cls), set()).update(attrs)
        fn_locals[fqn] = result_locals
    for call, info in graph.calls_by_tail.get("asarray", ()):
        if (info.module, info.cls) not in index.owner_classes:
            continue
        rd = graph.resolved_dotted(call, info)
        if rd != "numpy.asarray" or not call.args:
            continue
        base = _base_of(call.args[0])
        hit: Optional[str] = None
        if isinstance(base, ast.Attribute) \
                and isinstance(base.value, ast.Name) \
                and base.value.id == "self" \
                and base.attr in cls_attrs.get(
                    (info.module, info.cls), ()):
            hit = f"self.{base.attr} (donated device state)"
        elif isinstance(base, ast.Name) \
                and base.id in fn_locals.get(info.fqn, ()):
            hit = f"{base.id} (a jax dispatch result)"
        if hit is None:
            continue
        findings.append(Finding(
            rule=rules.DONATION_ASARRAY_ALIAS,
            path=info.file.relpath, line=call.lineno,
            symbol=info.qualname,
            message=(f"np.asarray over {hit} returns a host VIEW of "
                     f"the device buffer — the next donated dispatch "
                     f"clobbers it in place (the wrong-tokens bug); "
                     f"use np.array (an owning copy)")))


def _check_read_after_donate(index: _Index,
                             findings: List[Finding]) -> None:
    for fqn, info in index.graph.functions.items():
        if (info.module, info.cls) not in index.owner_classes \
                and fqn not in index.donated_locals:
            continue
        dispatches: List[Tuple[ast.Call, Tuple[int, ...]]] = []
        for node in _walk_with_lambdas(info.node):
            if isinstance(node, ast.Call):
                idxs = index.dispatch_indices(node, info)
                if idxs:
                    dispatches.append((node, idxs))
        if not dispatches:
            continue
        stores: Dict[str, List[int]] = {}
        loads: Dict[str, List[ast.Name]] = {}
        for node in _walk_with_lambdas(info.node):
            if isinstance(node, ast.Name):
                if isinstance(node.ctx, ast.Load):
                    loads.setdefault(node.id, []).append(node)
                else:
                    stores.setdefault(node.id, []).append(node.lineno)
        for call, idxs in dispatches:
            for i in idxs:
                if i >= len(call.args) \
                        or not isinstance(call.args[i], ast.Name):
                    continue
                name = call.args[i].id
                for load in loads.get(name, ()):
                    if load.lineno <= call.lineno:
                        continue
                    # >= call line, not >: the rebind target of
                    # ``x, c = f(c)`` shares the dispatch's line and IS
                    # the safe idiom (the result replaces the donated
                    # buffer before any later read).
                    if any(call.lineno <= s <= load.lineno
                           for s in stores.get(name, ())):
                        continue
                    findings.append(Finding(
                        rule=rules.DONATION_READ_AFTER_DONATE,
                        path=info.file.relpath, line=load.lineno,
                        symbol=info.qualname,
                        message=(f"{name!r} is read after being passed "
                                 f"in donated argument position {i} of "
                                 f"a dispatch at line {call.lineno}: "
                                 f"donation invalidated the buffer, so "
                                 f"this read observes freed/clobbered "
                                 f"device memory")))
                    break   # one finding per (dispatch, name)


def _index(graph: CallGraph) -> _Index:
    """The donation index, memoized on the graph."""
    cached = getattr(graph, "_donation_index", None)
    if cached is None:
        cached = _Index(graph)
        graph._donation_index = cached
    return cached


def check(graph: CallGraph,
          emit_files: Optional[set] = None) -> List[Finding]:
    index = _index(graph)
    findings: List[Finding] = []
    _check_unguarded(index, findings)
    _check_asarray_alias(index, findings)
    _check_read_after_donate(index, findings)
    if emit_files is not None:
        findings = [f for f in findings if f.path in emit_files]
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def sites(graph: CallGraph) -> int:
    """Programs constructed with a donation argument. The port
    constructs none (it compiles no program with donated buffers), so
    this family reads no site there."""
    index = _index(graph)
    return len(index.donated_attrs) + sum(
        len(v) for v in index.donated_locals.values())
