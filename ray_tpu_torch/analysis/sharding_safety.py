"""sharding-safety: static GSPMD sharding / mesh-scope checking.

The serving plane's correctness rests on hand-maintained
sharding invariants: the decode rule table never partitions a
contraction dim, every row-parallel reduction is preceded by a
``constrain`` anchor (gather-then-contract, so sharded logits stay
BIT-EXACT vs the single-chip program), and every sharded program is
traced under an ``axis_rules`` scope with pinned shardings. Runtime
tests police those invariants only on the mesh shapes they happen to
trace; this checker evaluates them *statically*, against the rule
tables themselves — an edit that partitions a contraction dim in
``DECODE_RULES`` is caught without importing jax. Four rules:

* sharding-partitioned-contraction — an einsum/dot/matmul site whose
  contracted dim carries a logical axis that a bit-exactness table
  (``DECODE_RULES``) maps to a mesh axis. Operand axes resolve two
  ways: activation locals flow from their nearest preceding
  ``constrain(x, (...axes...))`` assignment; weight operands
  (``layer["wo"]``-style literal subscripts) resolve through the
  ``param_axes``/``decode_param_axes`` tables (decode overrides win —
  that is where ``wo``/``w_down`` are re-bound to replicated).
  Unresolvable operands are skipped (conservative silence).
* sharding-missing-anchor — a reduction against a ROW-PARALLEL weight
  (derived from the tables: decode axes fully replicated while the
  train axes shard a dim) whose activation operand does not flow from a
  ``constrain`` anchor. Without the anchor, propagation shards the
  contracted dim upstream (heads/mlp over "model") and XLA emits a
  partial-sum psum — numerically fine, bit-exactness broken.
* sharding-unpinned-mesh-call — a jit-family call inside a mesh scope
  (a ``with axis_rules(...)`` block, or the argument of a
  ``*_mesh_scoped`` wrapper) carrying no ``in_shardings``/
  ``out_shardings`` (a ``**kwargs`` splat counts as unknown and is not
  flagged), or a ``device_put`` inside a scope with no placement
  argument — unpinned programs let XLA re-place committed state.
* sharding-unscoped-trace — a jit call WITH explicit sharding kwargs
  whose wrapped callable (transitively) hits a ``constrain`` site, yet
  the jit is neither inside an ``axis_rules`` block, nor passed through
  a mesh-scope wrapper, nor does the wrapped callable open the scope
  itself (the train-step idiom: ``with axis_rules(...)`` inside the
  traced body). Out of scope, ``constrain`` is a silent no-op — the
  program compiles, unsharded, and the invariant evaporates.

All tables are parsed from the AST (``ast.literal_eval`` on the dict /
tuple literals); nothing here imports torch, jax or the model code.

In ray_tpu_torch the contractions are ``@`` products: weights come
through the ``_w(layer, "<name>", x)`` accessor, reshaped to 2-D (one
layer's slice, so the ``layers`` axis is dropped), and on a decode mesh
of local shards ``gather_local`` before ``wo`` / ``w_down`` is the
pre-contraction anchor (``rules.SHARDING_WEIGHT_ACCESSORS``,
``SHARDING_GATHER_FUNCS``). Rules 3-4 read the port's ``shard_map``
calls; it compiles nothing with sharding kwargs.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from ray_tpu_torch.analysis import rules
from ray_tpu_torch.analysis.callgraph import (CallGraph, FunctionInfo, dotted,
                                        _walk_no_nested)
from ray_tpu_torch.analysis.core import Finding, Project

Axes = Tuple[Optional[str], ...]


# ------------------------------------------------------- table parsing

def _literal_axes(node: ast.AST) -> Optional[Axes]:
    """A literal tuple of axis names (str | None | nested tuple is
    flattened to its first element for matching purposes), else None."""
    if not isinstance(node, (ast.Tuple, ast.List)):
        return None
    try:
        val = ast.literal_eval(node)
    except (ValueError, SyntaxError):
        return None
    out = []
    for el in val:
        if el is None or isinstance(el, str):
            out.append(el)
        else:
            return None
    return tuple(out)


def load_rule_tables(project: Project
                     ) -> Dict[str, Tuple[Dict[str, object], str,
                                          Dict[str, int]]]:
    """table name -> (axis -> mesh-axis-or-None, relpath, axis lines)
    for every module-level ``NAME: Rules = {...literal...}`` in the
    sharding-rules module."""
    f = project.by_module.get(rules.SHARDING_RULES_MODULE)
    out: Dict[str, Tuple[Dict[str, object], str, Dict[str, int]]] = {}
    if f is None:
        return out
    wanted = set(rules.SHARDING_BITEXACT_TABLES) | {
        rules.SHARDING_TRAIN_TABLE}
    for node in f.tree.body:
        tgt = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            tgt, val = node.targets[0].id, node.value
        elif isinstance(node, ast.AnnAssign) \
                and isinstance(node.target, ast.Name) \
                and node.value is not None:
            tgt, val = node.target.id, node.value
        if tgt is None or tgt not in wanted \
                or not isinstance(val, ast.Dict):
            continue
        table: Dict[str, object] = {}
        lines: Dict[str, int] = {}
        for k, v in zip(val.keys, val.values):
            if not (isinstance(k, ast.Constant)
                    and isinstance(k.value, str)):
                continue
            try:
                table[k.value] = ast.literal_eval(v)
            except (ValueError, SyntaxError):
                continue
            lines[k.value] = k.lineno
        out[tgt] = (table, f.relpath, lines)
    return out


def load_param_axes(project: Project) -> Tuple[Dict[str, Axes],
                                               Dict[str, Axes]]:
    """(train weight axes, decode weight axes) keyed by weight name,
    extracted from the literal tuple bindings inside the param-axes
    functions (``layers["wo"] = (...)`` / ``{"wo": (...)}`` forms).
    The decode map is the train map with the decode function's
    re-bindings applied on top."""
    f = project.by_module.get(rules.SHARDING_PARAM_AXES_MODULE)
    train: Dict[str, Axes] = {}
    decode_over: Dict[str, Axes] = {}
    if f is None:
        return train, dict(train)

    def harvest(fn: ast.AST, into: Dict[str, Axes]) -> None:
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Subscript) \
                    and isinstance(node.targets[0].slice, ast.Constant) \
                    and isinstance(node.targets[0].slice.value, str):
                axes = _literal_axes(node.value)
                if axes is not None:
                    into[node.targets[0].slice.value] = axes
            elif isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if isinstance(k, ast.Constant) \
                            and isinstance(k.value, str):
                        axes = _literal_axes(v)
                        if axes is not None:
                            into.setdefault(k.value, axes)

    for node in ast.walk(f.tree):
        if isinstance(node, ast.FunctionDef):
            if node.name in rules.SHARDING_PARAM_AXES_FUNCS:
                harvest(node, train)
            elif node.name in rules.SHARDING_DECODE_AXES_FUNCS:
                harvest(node, decode_over)
    decode = dict(train)
    decode.update(decode_over)
    return train, decode


def row_parallel_weights(train: Dict[str, Axes], decode: Dict[str, Axes],
                         train_table: Dict[str, object]) -> Set[str]:
    """Weight names whose decode axes are fully replicated while their
    train axes shard some dim — the Megatron row-parallel pair
    (``wo``/``w_down``): their inputs are CONTRACTED, so the sharded
    serving path keeps them replicated and relies on a pre-contraction
    ``constrain`` anchor instead."""
    out: Set[str] = set()
    for name, d_axes in decode.items():
        t_axes = train.get(name)
        if t_axes is None or t_axes == d_axes:
            continue
        body = [a for a in d_axes if a != "layers"]
        if any(a is not None for a in body):
            continue  # decode still shards it: not the replicated pair
        if any(a is not None and train_table.get(a) is not None
               for a in t_axes):
            out.add(name)
    return out


# ------------------------------------------------- operand resolution

def _peel(expr: ast.AST) -> ast.AST:
    """Strip ``.astype(...)`` / ``.to(...)`` / ``.float()`` wrappers:
    they change dtype or layout, not axes."""
    while isinstance(expr, ast.Call) \
            and isinstance(expr.func, ast.Attribute) \
            and expr.func.attr in rules.SHARDING_AXIS_KEEPING_METHODS:
        expr = expr.func.value
    return expr


def _reshape_of(expr: ast.AST) -> Optional[ast.Call]:
    """The ``x.reshape(...)`` / ``x.view(...)`` call ``expr`` is, else
    None."""
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute) \
            and expr.func.attr in rules.SHARDING_RESHAPE_METHODS:
        return expr
    return None


def _weight_accessor(call: ast.AST) -> Optional[str]:
    """``_w(layer, "wo", x)``: the port's weight read, by name."""
    if not isinstance(call, ast.Call):
        return None
    d = dotted(call.func)
    idx = rules.SHARDING_WEIGHT_ACCESSORS.get(
        d.split(".")[-1] if d else None)
    if idx is None or len(call.args) <= idx:
        return None
    arg = call.args[idx]
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return arg.value
    return None


def _is_gather(call: ast.AST) -> bool:
    d = dotted(call.func) if isinstance(call, ast.Call) else None
    return d is not None \
        and d.split(".")[-1] in rules.SHARDING_GATHER_FUNCS


def _is_constrain(call: ast.Call) -> bool:
    d = dotted(call.func)
    return d is not None \
        and d.split(".")[-1] in rules.SHARDING_CONSTRAIN_FUNCS


def _constrain_axes(call: ast.Call) -> Optional[Axes]:
    if len(call.args) >= 2:
        return _literal_axes(call.args[1])
    return None


class _AxisEnv:
    """Per-function map of local names to logical-axes tuples, flowing
    from ``x = constrain(x, (...axes...))`` assignments. A later
    reassignment from anything else kills the binding (lexical order by
    line — the model code is straight-line enough for that)."""

    def __init__(self, info: FunctionInfo):
        # name -> [(lineno, axes-or-None)]; ``()`` is a gathered
        # (anchored) value whose axes are not spelled at the site
        self.defs: Dict[str, List[Tuple[int, Optional[Axes]]]] = {}
        # name -> [(lineno, weight name or None)]: locals bound to a
        # weight accessor (``wo = _w(layer, "wo", x)``)
        self.weights: Dict[str, List[Tuple[int, Optional[str]]]] = {}
        for node in _walk_no_nested(info.node):
            if isinstance(node, ast.Assign):
                axes = None
                val = _peel(node.value)
                if isinstance(val, ast.Call) and _is_constrain(val):
                    axes = _constrain_axes(val)
                elif _is_gather(val):
                    axes = ()
                wname = _weight_accessor(val)
                for tgt in node.targets:
                    for sub in ast.walk(tgt):
                        if isinstance(sub, ast.Name):
                            one = isinstance(tgt, ast.Name)
                            self.defs.setdefault(sub.id, []).append(
                                (node.lineno, axes if one else None))
                            self.weights.setdefault(sub.id, []).append(
                                (node.lineno, wname if one else None))
            elif isinstance(node, ast.AugAssign) \
                    and isinstance(node.target, ast.Name):
                self.defs.setdefault(node.target.id, []).append(
                    (node.lineno, None))
        for rows in self.defs.values():
            rows.sort()
        for rows in self.weights.values():
            rows.sort(key=lambda r: r[0])

    @staticmethod
    def _last(rows, line: int):
        best = None
        for ln, val in rows:
            if ln >= line:
                break
            best = val
        return best

    def axes_at(self, name: str, line: int) -> Optional[Axes]:
        return self._last(self.defs.get(name, ()), line)

    def weight_at(self, name: str, line: int) -> Optional[str]:
        return self._last(self.weights.get(name, ()), line)


def _flatten_2d(axes: Axes, reshape: ast.Call) -> Optional[Axes]:
    """A weight reshaped to 2-D for a ``@`` (the port's projections):
    ``w.reshape(e, -1)`` keeps the first dim and merges the rest,
    ``w.reshape(-1, e)`` merges all but the last. A merged dim carries
    the first of its axes that is not None (None when all are)."""
    if len(reshape.args) != 2:
        return None

    def merged(group):
        named = [a for a in group if a is not None]
        return named[0] if named else None

    first, second = reshape.args
    if isinstance(second, ast.UnaryOp) or (
            isinstance(second, ast.Constant) and second.value == -1):
        return (axes[0], merged(axes[1:]))
    if isinstance(first, ast.UnaryOp) or (
            isinstance(first, ast.Constant) and first.value == -1):
        return (merged(axes[:-1]), axes[-1])
    return None


def _weight_axes_of(name: str, weight_axes: Dict[str, Axes],
                    per_layer: bool) -> Optional[Axes]:
    axes = weight_axes.get(name)
    if axes is not None and per_layer and axes and axes[0] == "layers":
        axes = axes[1:]  # an accessor reads one layer's slice
    return axes


def _operand_axes(expr: ast.AST, line: int, env: _AxisEnv,
                  weight_axes: Dict[str, Axes]
                  ) -> Tuple[Optional[Axes], Optional[str]]:
    """-> (axes or None, weight name if the operand is a weight). Axes
    ``()`` mark an anchored (gathered or reshaped) activation whose axes
    the site does not spell."""
    expr = _peel(expr)
    reshape = _reshape_of(expr)
    inner = _peel(reshape.func.value) if reshape is not None else None
    if isinstance(expr, ast.Call) and _is_constrain(expr):
        return _constrain_axes(expr), None
    if _is_gather(expr):
        return (), None
    if isinstance(expr, ast.Subscript) \
            and isinstance(expr.slice, ast.Constant) \
            and isinstance(expr.slice.value, str):
        name = expr.slice.value
        return weight_axes.get(name), name
    wname = _weight_accessor(expr)
    if wname is None and isinstance(expr, ast.Name):
        wname = env.weight_at(expr.id, line)
    if wname is not None:
        return _weight_axes_of(wname, weight_axes, True), wname
    if isinstance(expr, ast.Name):
        return env.axes_at(expr.id, line), None
    if reshape is not None and inner is not None:
        wname = _weight_accessor(inner)
        if wname is None and isinstance(inner, ast.Name):
            wname = env.weight_at(inner.id, line)
        if wname is not None:
            axes = _weight_axes_of(wname, weight_axes, True)
            return (None if axes is None
                    else _flatten_2d(axes, reshape)), wname
        if isinstance(inner, ast.Name) \
                and env.axes_at(inner.id, line) is not None:
            return (), None
    return None, None


def _align(letters: str, axes: Axes) -> Optional[Dict[str, Optional[str]]]:
    """Map einsum subscript letters to logical axes. Inside a scanned
    layer body the leading ``layers`` axis is consumed, so a weight
    whose axes tuple is one longer than its subscript drops it."""
    if "." in letters:
        return None
    if len(letters) == len(axes):
        pairs = zip(letters, axes)
    elif len(letters) == len(axes) - 1 and axes and axes[0] == "layers":
        pairs = zip(letters, axes[1:])
    else:
        return None
    return {letter: ax for letter, ax in pairs}


# ------------------------------------------------------ rule 1 & 2

def _check_contractions(graph: CallGraph, findings: List[Finding],
                        bitexact: Dict[str, Tuple[Dict[str, object], str,
                                                  Dict[str, int]]],
                        weight_axes: Dict[str, Axes],
                        row_parallel: Set[str],
                        emit_files) -> None:
    scoped = [info for info in graph.functions.values()
              if info.file.relpath.startswith(
                  rules.SHARDING_SCOPE_PREFIXES)]
    for info in scoped:
        if emit_files is not None \
                and info.file.relpath not in emit_files:
            continue
        env: Optional[_AxisEnv] = None
        for node in _walk_no_nested(info.node):
            ops: List[Tuple[ast.AST, Optional[str]]] = []
            contracted: Sequence[str] = ()
            if isinstance(node, ast.Call):
                d = dotted(node.func)
                tail = d.split(".")[-1] if d else None
                if tail in rules.SHARDING_CONTRACT_FUNCS \
                        and len(node.args) >= 3 \
                        and isinstance(node.args[0], ast.Constant) \
                        and isinstance(node.args[0].value, str) \
                        and "->" in node.args[0].value:
                    spec = node.args[0].value.replace(" ", "")
                    ins, _, out_sub = spec.partition("->")
                    subs = ins.split(",")
                    if len(subs) != len(node.args) - 1:
                        continue
                    contracted = sorted(
                        {c for s in subs for c in s if c.isalpha()}
                        - set(out_sub))
                    ops = list(zip(node.args[1:], subs))
                elif tail in rules.SHARDING_MATMUL_FUNCS \
                        and "." in (d or "") and len(node.args) == 2:
                    ops = [(node.args[0], "@L"), (node.args[1], "@R")]
                    contracted = ("@k",)
            elif isinstance(node, ast.BinOp) \
                    and isinstance(node.op, ast.MatMult):
                ops = [(node.left, "@L"), (node.right, "@R")]
                contracted = ("@k",)
            if not ops or not contracted:
                continue
            if env is None:
                env = _AxisEnv(info)

            resolved: List[Tuple[Dict[str, Optional[str]],
                                 Optional[str]]] = []
            unresolved_act = False
            weight_hits: List[str] = []
            for expr, sub in ops:
                axes, wname = _operand_axes(expr, node.lineno, env,
                                            weight_axes)
                if wname is not None and wname in row_parallel:
                    weight_hits.append(wname)
                if axes is None:
                    if wname is None:
                        unresolved_act = True
                    continue
                if not axes:
                    continue  # anchored, axes unspelled
                if sub in ("@L", "@R"):
                    # matmul: contraction is left[-1] / right[0] (2-D)
                    # or right[-2] (batched) — map the single "@k" slot.
                    k_ax = axes[-1] if sub == "@L" else (
                        axes[0] if len(axes) == 2 else axes[-2])
                    resolved.append(({"@k": k_ax}, wname))
                    continue
                mapping = _align(sub, axes)
                if mapping is not None:
                    resolved.append((mapping, wname))

            # rule 1: a contracted dim carrying a partitioned axis
            flagged_axes: Set[str] = set()
            for mapping, _w in resolved:
                for letter in contracted:
                    ax = mapping.get(letter)
                    if ax is None or ax in flagged_axes:
                        continue
                    for tname in rules.SHARDING_BITEXACT_TABLES:
                        table, tpath, tlines = bitexact.get(
                            tname, ({}, "", {}))
                        mesh_ax = table.get(ax)
                        if mesh_ax is None:
                            continue
                        flagged_axes.add(ax)
                        findings.append(Finding(
                            rule=rules.SHARDING_CONTRACTION,
                            path=info.file.relpath, line=node.lineno,
                            symbol=info.qualname,
                            message=f"contraction dim '{letter}' carries "
                                    f"logical axis '{ax}', which "
                                    f"{tname} partitions over mesh axis "
                                    f"{mesh_ax!r} ({tpath}:"
                                    f"{tlines.get(ax, '?')}) — a split "
                                    f"reduction breaks the sharded-"
                                    f"decode bit-exactness contract"))
            # rule 2: row-parallel reduction with unanchored activation
            if weight_hits and unresolved_act:
                findings.append(Finding(
                    rule=rules.SHARDING_ANCHOR,
                    path=info.file.relpath, line=node.lineno,
                    symbol=info.qualname,
                    message=f"reduction against replicated row-parallel "
                            f"weight {weight_hits[0]!r} has an operand "
                            f"that does not flow from a constrain() "
                            f"anchor — without the pre-contraction "
                            f"anchor, propagation shards the contracted "
                            f"dim and XLA emits a partial-sum psum "
                            f"(bit-exactness contract)"))


# ------------------------------------------------------ rule 3 & 4

def _is_jit_call(graph: CallGraph, info: FunctionInfo,
                 call: ast.Call) -> bool:
    d = graph.resolved_dotted(call, info)
    return d is not None \
        and d.split(".")[-1] in rules.JIT_DOTTED_SUFFIXES


def _has_sharding_kw(call: ast.Call) -> bool:
    return any(kw.arg in rules.JIT_SHARDING_KWARGS
               for kw in call.keywords)


def _has_kw_splat(call: ast.Call) -> bool:
    return any(kw.arg is None for kw in call.keywords)


def _scope_withs(info: FunctionInfo) -> List[ast.AST]:
    """``with axis_rules(...)`` statements in this function."""
    out = []
    for node in _walk_no_nested(info.node):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ce = item.context_expr
                if isinstance(ce, ast.Call):
                    d = dotted(ce.func)
                    if d is not None and d.split(".")[-1] in \
                            rules.SHARDING_SCOPE_CTXS:
                        out.append(node)
                        break
    return out


def _constrain_reachable(graph: CallGraph) -> Set[str]:
    """fqns that (transitively) call a constrain anchor."""
    direct: Set[str] = set()
    for tail in rules.SHARDING_CONSTRAIN_FUNCS:
        for _node, info in graph.calls_by_tail.get(tail, ()):
            direct.add(info.fqn)
    # reverse-BFS over the call graph
    callers: Dict[str, List[str]] = {}
    for fqn, rows in graph.edges().items():
        for callee, _line, _vs in rows:
            callers.setdefault(callee, []).append(fqn)
    seen = set(direct)
    queue = list(direct)
    while queue:
        fqn = queue.pop()
        for caller in callers.get(fqn, ()):
            if caller not in seen:
                seen.add(caller)
                queue.append(caller)
    return seen


def _opens_scope(graph: CallGraph, fqn: Optional[str],
                 depth: int = 0) -> bool:
    """The wrapped callable (or a callee, shallow) opens axis_rules
    itself — the train-step idiom (scope inside the traced body)."""
    if fqn is None or fqn not in graph.functions or depth > 2:
        return False
    info = graph.functions[fqn]
    if _scope_withs(info):
        return True
    return any(_opens_scope(graph, callee, depth + 1)
               for callee, _l, _vs in graph.edges().get(fqn, ()))


def _mesh_candidates(graph: CallGraph) -> Dict[str, FunctionInfo]:
    """Functions that can possibly hold a mesh-scope finding, from the
    shared side indexes — everything else is skipped whole."""
    cands: Dict[str, FunctionInfo] = {}
    tails = tuple(rules.JIT_DOTTED_SUFFIXES) + ("device_put",) \
        + tuple(rules.MESH_SCOPE_WRAPPERS)
    for tail in tails:
        for _node, info in graph.calls_by_tail.get(tail, ()):
            cands[info.fqn] = info
    for kw in rules.JIT_SHARDING_KWARGS:
        for _node, info in graph.calls_by_kwarg.get(kw, ()):
            cands[info.fqn] = info
    return cands


def _check_mesh_scopes(graph: CallGraph, findings: List[Finding],
                       emit_files) -> None:
    cands = _mesh_candidates(graph)
    constrainers = _constrain_reachable(graph) if cands else set()
    for fqn, info in sorted(cands.items()):
        if emit_files is not None \
                and info.file.relpath not in emit_files:
            continue
        scope_node_ids: Set[int] = set()
        for w in _scope_withs(info):
            for sub in ast.walk(w):
                scope_node_ids.add(id(sub))
        wrapper_args: Set[int] = set()
        for node in _walk_no_nested(info.node):
            if isinstance(node, ast.Call):
                d = dotted(node.func)
                if d is not None and d.split(".")[-1] in \
                        rules.MESH_SCOPE_WRAPPERS:
                    for a in node.args:
                        wrapper_args.add(id(a))

        for node in _walk_no_nested(info.node):
            if not isinstance(node, ast.Call):
                continue
            in_scope = id(node) in scope_node_ids \
                or id(node) in wrapper_args
            if _is_jit_call(graph, info, node) \
                    or _has_sharding_kw(node):
                pinned = _has_sharding_kw(node) or _has_kw_splat(node)
                if in_scope and not pinned:
                    findings.append(Finding(
                        rule=rules.SHARDING_UNPINNED,
                        path=info.file.relpath, line=node.lineno,
                        symbol=info.qualname,
                        message="jit inside a mesh scope without "
                                "in_shardings/out_shardings — unpinned "
                                "outputs let XLA re-place committed "
                                "sharded state"))
                if not in_scope and _has_sharding_kw(node) \
                        and node.args:
                    wrapped = None
                    arg = node.args[0]
                    if isinstance(arg, (ast.Name, ast.Attribute)):
                        fake = ast.Call(func=arg, args=[], keywords=[])
                        ast.copy_location(fake, arg)
                        wrapped, _vs = graph.resolve_call_cached(
                            fake, info)
                        if wrapped is None:
                            wrapped, _vs = graph.resolve_call(fake, info)
                    if wrapped is not None \
                            and wrapped in constrainers \
                            and not _opens_scope(graph, wrapped):
                        findings.append(Finding(
                            rule=rules.SHARDING_UNSCOPED,
                            path=info.file.relpath, line=node.lineno,
                            symbol=info.qualname,
                            message=f"sharded program "
                                    f"{wrapped.split(':')[-1]!r} (it "
                                    f"reaches constrain()) is jitted "
                                    f"with sharding kwargs outside any "
                                    f"axis_rules scope — constrain is a "
                                    f"silent no-op there, so the traced "
                                    f"program drops every anchor"))
                continue
            d = graph.resolved_dotted(node, info)
            if d is not None and d.split(".")[-1] == "device_put" \
                    and id(node) in scope_node_ids \
                    and len(node.args) < 2 and not node.keywords:
                findings.append(Finding(
                    rule=rules.SHARDING_UNPINNED,
                    path=info.file.relpath, line=node.lineno,
                    symbol=info.qualname,
                    message="device_put inside a mesh scope without a "
                            "sharding/placement argument — the value "
                            "lands on the default device, off-mesh"))


def check(graph: CallGraph, emit_files=None) -> List[Finding]:
    findings: List[Finding] = []
    graph.edges()  # ensure side indexes exist
    bitexact = load_rule_tables(graph.project)
    train_table = bitexact.get(rules.SHARDING_TRAIN_TABLE,
                               ({}, "", {}))[0]
    train_axes, decode_axes = load_param_axes(graph.project)
    row_par = row_parallel_weights(train_axes, decode_axes, train_table)
    _check_contractions(graph, findings, bitexact, decode_axes, row_par,
                        emit_files)
    _check_mesh_scopes(graph, findings, emit_files)
    return findings


def _contraction_sites(graph: CallGraph) -> int:
    n = 0
    for info in graph.functions.values():
        if not info.file.relpath.startswith(rules.SHARDING_SCOPE_PREFIXES):
            continue
        for node in _walk_no_nested(info.node):
            if isinstance(node, ast.BinOp) \
                    and isinstance(node.op, ast.MatMult):
                n += 1
            elif isinstance(node, ast.Call):
                d = dotted(node.func)
                tail = d.split(".")[-1] if d else None
                if tail in rules.SHARDING_CONTRACT_FUNCS or (
                        tail in rules.SHARDING_MATMUL_FUNCS
                        and "." in (d or "")):
                    n += 1
    return n


def sites(graph: CallGraph) -> int:
    """Contraction sites in the sharded model and parallelism code,
    plus jit / placement calls that could sit in a mesh scope."""
    graph.edges()
    return _contraction_sites(graph) + len(_mesh_candidates(graph))
