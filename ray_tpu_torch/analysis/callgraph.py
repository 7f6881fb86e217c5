"""Best-effort intra-package call graph over the project ASTs.

Resolution is deliberately conservative: a call we cannot bind to a
package function is simply not an edge (checkers treat unresolved calls
as opaque). What IS resolved:

* ``foo(...)``            — module function / class in the same module,
                            or a ``from x import foo`` target.
* ``mod.foo(...)``        — where ``mod``/alias binds an imported module
                            (``import ray_tpu_torch.core.rpc as rpc``).
* ``self.meth(...)``      — method of the enclosing class (single-module
                            base-class walk included).
* ``Cls(...)``            — constructor => ``Cls.__init__``.
* ``obj.meth(...)``       — when exactly one class in the same module
                            defines ``meth`` (covers the ``st: _Conn``
                            pattern in core/rpc.py).
* ``f = self.foo; f()``   — bound-method aliasing through simple local
                            assignments (last assignment wins).
* ``functools.partial(self.foo, x)(...)`` — unwrapped to its target,
                            including aliased partials.
* ``self.pubsub.poll(...)`` — one level of self-attribute typing:
                            ``self.pubsub = Pubsub()`` in any method of
                            the class binds the attribute's class, so
                            calls through it resolve cross-module.

Decorated functions need no special casing — the AST name still binds
the undecorated ``FunctionDef``, so call edges into them resolve exactly
like plain functions (fixture-tested in tests/test_analysis_v2.py).

Imports are collected at module level AND inside each function (this
codebase imports locally for cycle-avoidance all over).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.analysis.core import Project, SourceFile

# Names that collide with builtin container/str methods: the
# single-owner-in-module fallback must never bind `msg.get(...)` or
# `buf.append(...)` to a package method that happens to share the name.
_BUILTIN_METHODS: Set[str] = set()
for _t in (dict, list, set, str, bytes, bytearray, tuple, frozenset):
    _BUILTIN_METHODS.update(n for n in dir(_t) if not n.startswith("__"))


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclass
class FunctionInfo:
    fqn: str                     # "ray_tpu_torch.core.rpc:RpcServer._flush"
    module: str
    qualname: str
    cls: Optional[str]
    node: ast.AST                # FunctionDef / AsyncFunctionDef
    file: SourceFile
    local_imports: Dict[str, Tuple[str, Optional[str]]] = \
        field(default_factory=dict)
    # local name -> aliased callable expr (``f = self.foo`` /
    # ``f = functools.partial(self.foo, x)``); last assignment wins.
    aliases: Dict[str, ast.AST] = field(default_factory=dict)


@dataclass
class ClassInfo:
    module: str
    name: str
    node: ast.ClassDef
    methods: Dict[str, str] = field(default_factory=dict)  # name -> fqn
    bases: List[str] = field(default_factory=list)


class CallGraph:
    def __init__(self, project: Project, package: str = "ray_tpu_torch"):
        self.project = project
        self.package = package
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Dict[Tuple[str, str], ClassInfo] = {}
        # module -> {local name -> (kind, target)}; kind "module" binds a
        # module path, kind "object" binds (module path, attr name).
        self.imports: Dict[str, Dict[str, Tuple[str, Optional[str]]]] = {}
        # module -> method name -> [class names defining it]
        self._method_owners: Dict[str, Dict[str, List[str]]] = {}
        # (module, cls, attr) -> (target module, target class): the type
        # of ``self.attr`` when some method assigns
        # ``self.attr = Cls(...)`` with Cls a package class.
        self.self_attr_types: Dict[Tuple[str, str, str],
                                   Tuple[str, str]] = {}
        self._self_attr_candidates: List[Tuple[FunctionInfo, ast.AST]] = []
        for f in project.files:
            self._index_file(f)
        self._index_self_attr_types()
        self._self_attr_candidates = []
        self._edges: Optional[Dict[str, List[Tuple[str, int, bool]]]] = \
            None
        self._call_targets: Dict[int, Tuple[str, bool]] = {}
        # side indexes built during the edges() walk (one body pass
        # serves every checker): call tail name -> [(node, info)],
        # keyword-arg name -> [(node, info)], attribute-target
        # AugAssigns, and fqn -> [With] (nested ones included)
        self.calls_by_tail: Dict[str,
                                 List[Tuple[ast.Call, FunctionInfo]]] = {}
        self.calls_by_kwarg: Dict[str,
                                  List[Tuple[ast.Call, FunctionInfo]]] = {}
        self.attr_augassigns: List[Tuple[ast.AugAssign, FunctionInfo]] = []
        self.withs_by_fqn: Dict[str, List[ast.With]] = {}

    def edges(self) -> Dict[str, List[Tuple[str, int, bool]]]:
        """fqn -> [(callee fqn, line, via_self)] for every resolved
        intra-package call, computed once and shared by all checkers
        (resolve_call is the analyzer's hottest path)."""
        if self._edges is None:
            out: Dict[str, List[Tuple[str, int, bool]]] = {}
            for fqn, info in self.functions.items():
                rows: List[Tuple[str, int, bool]] = []
                for node in _walk_no_nested(info.node):
                    if isinstance(node, ast.Call):
                        res = self.resolve_call(node, info)
                        self._call_targets[id(node)] = res
                        callee, via_self = res
                        if callee is not None \
                                and callee in self.functions:
                            rows.append((callee, node.lineno, via_self))
                        func = node.func
                        tail = func.attr \
                            if isinstance(func, ast.Attribute) else (
                                func.id if isinstance(func, ast.Name)
                                else None)
                        if tail is not None:
                            self.calls_by_tail.setdefault(
                                tail, []).append((node, info))
                        for kw in node.keywords:
                            if kw.arg is not None:
                                self.calls_by_kwarg.setdefault(
                                    kw.arg, []).append((node, info))
                    elif isinstance(node, ast.AugAssign) \
                            and isinstance(node.target, ast.Attribute):
                        self.attr_augassigns.append((node, info))
                    elif isinstance(node, (ast.With, ast.AsyncWith)):
                        self.withs_by_fqn.setdefault(fqn, []).append(
                            node)
                out[fqn] = rows
            self._edges = out
        return self._edges

    def resolve_call_cached(self, call: ast.Call, ctx: FunctionInfo
                            ) -> Tuple[Optional[str], bool]:
        """resolve_call through the edges() cache (same AST objects, so
        node identity keys it); falls back to a live resolve for nodes
        outside any indexed function body."""
        if self._edges is None:
            self.edges()
        hit = self._call_targets.get(id(call))
        if hit is not None:
            return hit
        return self.resolve_call(call, ctx)

    # ------------------------------------------------------------ indexing

    def _index_file(self, f: SourceFile) -> None:
        """Single pass over the module tree: imports, classes, methods,
        aliases and self-attr assigns are collected as each node is
        first visited (re-walking every function body for each concern
        made indexing the analyzer's hottest path)."""
        imports: Dict[str, Tuple[str, Optional[str]]] = {}
        self.imports[f.module] = imports
        owners: Dict[str, List[str]] = {}
        self._method_owners[f.module] = owners

        def add_import(child: ast.AST,
                       into: Dict[str, Tuple[str, Optional[str]]]
                       ) -> None:
            if isinstance(child, ast.Import):
                for alias in child.names:
                    name = alias.asname or alias.name.split(".")[0]
                    target = alias.name if alias.asname else \
                        alias.name.split(".")[0]
                    into[name] = ("module", target)
            elif isinstance(child, ast.ImportFrom) and child.module:
                for alias in child.names:
                    into[alias.asname or alias.name] = (
                        "object", f"{child.module}.{alias.name}")

        def visit(node: ast.AST, stack: List[ast.AST],
                  cls: Optional[str],
                  fn_info: Optional[FunctionInfo]) -> None:
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.Import, ast.ImportFrom)):
                    # function-local imports bind locally; everything
                    # else (module/class level, and also inside nested
                    # scopes' enclosing function) binds to the nearest
                    # function, falling back to the module table
                    add_import(child, fn_info.local_imports
                               if fn_info is not None else imports)
                    continue
                if isinstance(child, ast.ClassDef):
                    ci = ClassInfo(f.module, child.name, child,
                                   bases=[d for d in
                                          (dotted(b) for b in child.bases)
                                          if d])
                    self.classes[(f.module, child.name)] = ci
                    visit(child, stack + [child], child.name, fn_info)
                    continue
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    qn_parts = [n.name for n in stack
                                if isinstance(n, (ast.ClassDef,
                                                  ast.FunctionDef,
                                                  ast.AsyncFunctionDef))]
                    qn = ".".join(qn_parts + [child.name])
                    fqn = f"{f.module}:{qn}"
                    info = FunctionInfo(fqn, f.module, qn, cls, child, f)
                    self.functions[fqn] = info
                    if cls is not None and len(qn_parts) == 1:
                        self.classes[(f.module, cls)].methods[
                            child.name] = fqn
                        owners.setdefault(child.name, []).append(cls)
                    # nested defs: indexed but rarely resolved into
                    visit(child, stack + [child], cls, info)
                    continue
                if fn_info is not None and isinstance(child, ast.Assign) \
                        and len(child.targets) == 1 \
                        and isinstance(child.targets[0], ast.Name) \
                        and isinstance(child.value, (ast.Attribute,
                                                     ast.Name, ast.Call)):
                    # Callable-shaped alias values only: bound methods /
                    # functions (Attribute, Name) and partial
                    # constructions (Call — harmless for other calls:
                    # resolution of ``x = foo(); x()`` just fails at the
                    # non-partial Call).
                    fn_info.aliases[child.targets[0].id] = child.value
                if fn_info is not None and fn_info.cls is not None \
                        and isinstance(child, (ast.Assign,
                                               ast.AnnAssign)):
                    self._self_attr_candidates.append((fn_info, child))
                visit(child, stack, cls, fn_info)

        visit(f.tree, [], None, None)
        # A name imported inside any function remains a resolution
        # fallback module-wide (this file's historical behavior — local
        # import tables win, the module table catches the rest).
        for key, info in self.functions.items():
            if info.file is f:
                for name, target in info.local_imports.items():
                    imports.setdefault(name, target)

    # ---------------------------------------------------------- resolution

    def _import_target(self, ctx: FunctionInfo, name: str
                       ) -> Optional[Tuple[str, Optional[str]]]:
        hit = ctx.local_imports.get(name)
        if hit is None:
            hit = self.imports.get(ctx.module, {}).get(name)
        return hit

    def _module_symbol(self, module: str, name: str) -> Optional[str]:
        """fqn of function `name` or class-constructor in `module`."""
        fqn = f"{module}:{name}"
        if fqn in self.functions:
            return fqn
        ci = self.classes.get((module, name))
        if ci is not None:
            init = ci.methods.get("__init__")
            return init if init is not None else fqn  # class w/o __init__
        return None

    def _class_method(self, module: str, cls: str, meth: str,
                      depth: int = 0) -> Optional[str]:
        ci = self.classes.get((module, cls))
        if ci is None or depth > 4:
            return None
        fqn = ci.methods.get(meth)
        if fqn is not None:
            return fqn
        for base in ci.bases:
            base = base.split(".")[-1]
            hit = self._class_method(module, base, meth, depth + 1)
            if hit is not None:
                return hit
        return None

    def _index_self_attr_types(self) -> None:
        """``self.attr = Cls(...)`` (and ``self.attr: Cls`` /
        ``Optional[Cls]`` annotations) in any method of a class bind the
        attribute's type; conflicting assignments poison the entry.
        Candidates were collected during the single indexing pass."""
        poisoned: Set[Tuple[str, str, str]] = set()
        for info, node in self._self_attr_candidates:
            tgt = val_cls = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                if isinstance(node.value, ast.Call):
                    val_cls = self._class_of_ctor(node.value, info)
            elif isinstance(node, ast.AnnAssign):
                tgt = node.target
                val_cls = self._class_of_annotation(
                    node.annotation, info)
                if isinstance(node.value, ast.Call) and val_cls is None:
                    val_cls = self._class_of_ctor(node.value, info)
            if val_cls is None or not isinstance(tgt, ast.Attribute) \
                    or not isinstance(tgt.value, ast.Name) \
                    or tgt.value.id != "self":
                continue
            key = (info.module, info.cls, tgt.attr)
            old = self.self_attr_types.get(key)
            if old is not None and old != val_cls:
                poisoned.add(key)
            else:
                self.self_attr_types[key] = val_cls
        for key in poisoned:
            self.self_attr_types.pop(key, None)

    def _class_of_ctor(self, call: ast.Call, ctx: FunctionInfo
                       ) -> Optional[Tuple[str, str]]:
        func = call.func
        if isinstance(func, ast.Name):
            if (ctx.module, func.id) in self.classes:
                return (ctx.module, func.id)
            imp = self._import_target(ctx, func.id)
            if imp is not None and imp[0] == "object" and imp[1] \
                    and imp[1].startswith(self.package):
                mod, _, attr = imp[1].rpartition(".")
                if (mod, attr) in self.classes:
                    return (mod, attr)
        elif isinstance(func, ast.Attribute):
            d = self.resolved_dotted(call, ctx)
            if d:
                mod, _, attr = d.rpartition(".")
                if (mod, attr) in self.classes:
                    return (mod, attr)
        return None

    def _class_of_annotation(self, ann: ast.AST, ctx: FunctionInfo
                             ) -> Optional[Tuple[str, str]]:
        # Optional[X] / "X" string forms unwrap to X where recognizable.
        if isinstance(ann, ast.Subscript):
            d = dotted(ann.value)
            if d is not None and d.split(".")[-1] == "Optional":
                return self._class_of_annotation(ann.slice, ctx)
            return None
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str) \
                and ann.value.isidentifier():
            ann = ast.Name(id=ann.value)
        if isinstance(ann, ast.Name):
            if (ctx.module, ann.id) in self.classes:
                return (ctx.module, ann.id)
            imp = self._import_target(ctx, ann.id)
            if imp is not None and imp[0] == "object" and imp[1] \
                    and imp[1].startswith(self.package):
                mod, _, attr = imp[1].rpartition(".")
                if (mod, attr) in self.classes:
                    return (mod, attr)
        return None

    def _is_partial_ctor(self, call: ast.Call, ctx: FunctionInfo) -> bool:
        d = self.resolved_dotted(call, ctx)
        return d is not None and d.split(".")[-1] == "partial" \
            and bool(call.args)

    def expr_is_self_bound(self, expr: ast.AST, ctx: FunctionInfo,
                           depth: int = 0) -> bool:
        """True when calling ``expr`` runs a method on THIS instance
        (``self.foo``, an alias of it, or a partial over it)."""
        if depth > 3:
            return False
        if isinstance(expr, ast.Attribute):
            return isinstance(expr.value, ast.Name) \
                and expr.value.id in ("self", "cls")
        if isinstance(expr, ast.Name):
            alias = ctx.aliases.get(expr.id)
            if alias is not None and alias is not expr:
                return self.expr_is_self_bound(alias, ctx, depth + 1)
        if isinstance(expr, ast.Call) and self._is_partial_ctor(expr, ctx):
            return self.expr_is_self_bound(expr.args[0], ctx, depth + 1)
        return False

    def resolve_callable_expr(self, expr: ast.AST, ctx: FunctionInfo,
                              depth: int = 0) -> Optional[str]:
        """Resolve an expression used as a callable (a call's func, a
        thread/executor target, a handler value, an aliased local) to a
        package function fqn, or None."""
        if expr is None or depth > 3:
            return None
        if isinstance(expr, ast.Call):
            # functools.partial(target, ...) resolves to its target;
            # any other call-result callable is opaque.
            if self._is_partial_ctor(expr, ctx):
                return self.resolve_callable_expr(expr.args[0], ctx,
                                                  depth + 1)
            return None
        if isinstance(expr, ast.Name):
            name = expr.id
            hit = self._module_symbol(ctx.module, name)
            if hit is not None:
                return hit
            imp = self._import_target(ctx, name)
            if imp is not None:
                kind, target = imp
                if kind == "object" and target and \
                        target.startswith(self.package):
                    mod, _, attr = target.rpartition(".")
                    if mod in self.project.by_module:
                        return self._module_symbol(mod, attr)
                return None
            alias = ctx.aliases.get(name)
            if alias is not None and alias is not expr:
                return self.resolve_callable_expr(alias, ctx, depth + 1)
            return None
        if isinstance(expr, ast.Attribute):
            recv, meth = expr.value, expr.attr
            if isinstance(recv, ast.Name):
                if recv.id in ("self", "cls") and ctx.cls is not None:
                    return self._class_method(ctx.module, ctx.cls, meth)
                imp = self._import_target(ctx, recv.id)
                if imp is not None and imp[0] == "module" and \
                        imp[1].startswith(self.package) and \
                        imp[1] in self.project.by_module:
                    return self._module_symbol(imp[1], meth)
                # Cls.method(...) in the same module
                if (ctx.module, recv.id) in self.classes:
                    return self._class_method(ctx.module, recv.id, meth)
                # obj.meth for a bare-name receiver, when exactly one
                # class in this module defines meth — covers the
                # ``st: _Conn`` pattern. Never for names shared with
                # builtin container/str methods (msg.get, buf.append...).
                if meth not in _BUILTIN_METHODS and meth != "__init__":
                    owners = self._method_owners.get(ctx.module, {}).get(
                        meth, [])
                    if len(owners) == 1:
                        return self._class_method(ctx.module, owners[0],
                                                  meth)
                return None
            if isinstance(recv, ast.Attribute) \
                    and isinstance(recv.value, ast.Name) \
                    and recv.value.id in ("self", "cls") \
                    and ctx.cls is not None:
                # self.attr.meth via self-attribute typing
                typ = self.self_attr_types.get(
                    (ctx.module, ctx.cls, recv.attr))
                if typ is not None:
                    return self._class_method(typ[0], typ[1], meth)
            d = dotted(expr)
            if d is not None and d.startswith(self.package + "."):
                mod, _, attr = d.rpartition(".")
                if mod in self.project.by_module:
                    return self._module_symbol(mod, attr)
        return None

    def resolve_call(self, call: ast.Call, ctx: FunctionInfo
                     ) -> Tuple[Optional[str], bool]:
        """-> (callee fqn or None, via_self). via_self is True only for
        direct/aliased calls on THIS instance (self-deadlock evidence) —
        not for calls through a typed self-attribute, whose locks belong
        to a different object."""
        return (self.resolve_callable_expr(call.func, ctx),
                self.expr_is_self_bound(call.func, ctx))

    def resolved_dotted(self, call: ast.Call, ctx: FunctionInfo
                        ) -> Optional[str]:
        """Dotted name with the leading import alias normalized to its
        real module path (``sleep`` -> ``time.sleep`` for
        ``from time import sleep``)."""
        d = dotted(call.func)
        if d is None:
            return None
        head, _, rest = d.partition(".")
        imp = self._import_target(ctx, head)
        if imp is None:
            return d
        kind, target = imp
        if kind == "module":
            return f"{target}.{rest}" if rest else target
        return f"{target}.{rest}" if rest else target

    # ------------------------------------------------- blocking analysis

    def direct_blocking_map(self, dotted_table: Dict[str, str],
                            methods_always: Dict[str, str],
                            methods_unbounded: Dict[str, str],
                            ) -> Dict[str, List[Tuple[int, str]]]:
        """fqn -> (line, label) for every blocking primitive called
        directly in it (nested defs excluded — they run later). Built
        from the calls-by-tail side index: only calls whose trailing
        name can possibly match a table entry are resolved."""
        self.edges()
        sites: Dict[str, List[Tuple[int, str]]] = {}

        tails = {d.split(".")[-1] for d in dotted_table}
        for tail in tails:
            for node, info in self.calls_by_tail.get(tail, ()):
                rd = self.resolved_dotted(node, info)
                if rd is not None and rd in dotted_table:
                    sites.setdefault(info.fqn, []).append(
                        (node.lineno, f"{rd} ({dotted_table[rd]})"))
        for meth, label in methods_always.items():
            for node, info in self.calls_by_tail.get(meth, ()):
                if isinstance(node.func, ast.Attribute):
                    rd = self.resolved_dotted(node, info)
                    if rd is not None and rd in dotted_table:
                        continue  # already counted via the dotted table
                    sites.setdefault(info.fqn, []).append(
                        (node.lineno, f".{meth}() ({label})"))
        for meth, label in methods_unbounded.items():
            for node, info in self.calls_by_tail.get(meth, ()):
                if isinstance(node.func, ast.Attribute) \
                        and not node.args and not node.keywords:
                    sites.setdefault(info.fqn, []).append(
                        (node.lineno, f".{meth}() ({label})"))
        for rows in sites.values():
            rows.sort()
        return sites

    def blocking_closure(self, dotted_table: Dict[str, str],
                         methods_always: Dict[str, str],
                         methods_unbounded: Dict[str, str],
                         ) -> Dict[str, List[str]]:
        """fqn -> shortest call chain (list of labels) ending at a
        blocking primitive, for every transitively-blocking function."""
        all_edges = self.edges()
        direct: Dict[str, List[Tuple[int, str]]] = self.direct_blocking_map(
            dotted_table, methods_always, methods_unbounded)
        direct = {fqn: direct.get(fqn, []) for fqn in self.functions}
        edges: Dict[str, List[Tuple[str, int]]] = {
            fqn: [(callee, line) for callee, line, _ in rows]
            for fqn, rows in all_edges.items()}

        chains: Dict[str, List[str]] = {}
        for fqn, sites in direct.items():
            if sites:
                line, label = sites[0]
                chains[fqn] = [f"{_short(fqn)}:{line} -> {label}"]
        # BFS fixpoint: propagate the shortest chain to callers.
        changed = True
        while changed:
            changed = False
            for fqn, outs in edges.items():
                if fqn in chains:
                    continue
                for callee, line in outs:
                    if callee in chains:
                        chains[fqn] = (
                            [f"{_short(fqn)}:{line}"] + chains[callee])
                        changed = True
                        break
        return chains


def _walk_no_nested(fn_node: ast.AST) -> List[ast.AST]:
    """The nodes of a function body without descending into nested
    defs/classes (those execute on their own schedule, not in this
    frame). Every family walks the same bodies, so the list is kept on
    the node after the first walk."""
    cached = getattr(fn_node, "_body_nodes", None)
    if cached is not None:
        return cached
    out: List[ast.AST] = []
    stack = list(ast.iter_child_nodes(fn_node))
    while stack:
        node = stack.pop()
        out.append(node)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))
    fn_node._body_nodes = out
    return out


def _short(fqn: str) -> str:
    return fqn.split(":", 1)[-1]
