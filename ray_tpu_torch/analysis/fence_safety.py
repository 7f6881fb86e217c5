"""Fence-safety family: the epoch-fence protocol, statically.

Every fault-tolerance layer rides one idiom: writes to
shared control state carry a monotonic epoch, the owner of the state
rejects strictly-older (or, for version clocks, not-strictly-newer)
writes, and a REJECTED writer must treat the verdict as "you were
deposed" — self-fence, stop reconciling, or raise. The idiom is spread
across eleven files and is pure convention; these rules pin it:

**fence-result-ignored** — a fenced write (``rules.FENCED_WRITE_APIS``
by call tail, ``rules.FENCED_WRITE_EPOCH_ARG`` for publish-shaped APIs
that are fenced only when an epoch rides the call, plus the
``client.call("kv_put_fenced", ...)`` string form) whose result is
discarded: a bare expression statement, an assignment to a name that
is never read, or a result propagated through a bare ``return`` whose
own callers discard it (the lifetime.py via-self idiom — a function
that just forwards the verdict is a *fence carrier*, and the
discarding is charged to ITS call sites, transitively). A zombie that
ignores the stale-epoch verdict keeps acting as the owner: the exact
split-brain the fencing exists to prevent.

**unfenced-mutation-in-fenced-class** — inside a class listed in
``rules.FENCED_STATE_CLASSES``, a raw (unfenced) controller-KV write
spelling, or a publish-shaped call WITHOUT its epoch argument. The
class's state is fenced or it isn't: one bypassing write re-opens the
hole for every fenced one.

**epoch-compare-direction** — at the comparison sites named in
``rules.EPOCH_COMPARE_TABLE``, the guard's direction must match the
clock's semantics: "equal-ok" clocks (epoch fences) reject only
STRICTLY older writes — ``incoming <= stored`` drops a legitimate
same-epoch republish; "strict" clocks (weight versions) must reject
equal — ``incoming < stored`` lets a replayed version re-apply.

**epoch-not-threaded** — a fenced publish in a fenced class whose
dict-literal payload lacks the clock key (``rules.
FENCED_PAYLOAD_RULES``): subscribers run their OWN staleness check
against the payload's epoch/version (the router-snapshot idiom), so a
payload without it makes every downstream fence blind.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.analysis import rules
from ray_tpu_torch.analysis.callgraph import (CallGraph, FunctionInfo, dotted,
                                        _walk_no_nested)
from ray_tpu_torch.analysis.core import Finding

_MIRROR = {ast.Lt: ast.Gt, ast.LtE: ast.GtE,
           ast.Gt: ast.Lt, ast.GtE: ast.LtE}
# ops flagged with the STORED clock normalized to the right-hand side
_BAD_OPS = {"equal-ok": (ast.LtE, ast.Gt), "strict": (ast.Lt, ast.GtE)}


def _call_tail(call: ast.Call) -> Optional[str]:
    func = call.func
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _is_none(node: ast.AST) -> bool:
    return isinstance(node, ast.Constant) and node.value is None


def _has_epoch_arg(call: ast.Call, kwarg: str, pos: int,
                   offset: int = 0) -> bool:
    """True when an epoch rides the call: the named kwarg (non-None
    literal), or a positional at ``pos`` (+offset for the string-RPC
    form, whose args shift right past the method name)."""
    for kw in call.keywords:
        if kw.arg == kwarg and not _is_none(kw.value):
            return True
    i = pos + offset
    return len(call.args) > i and not _is_none(call.args[i])


def _fenced_call_sites(graph: CallGraph
                       ) -> List[Tuple[ast.Call, FunctionInfo, str]]:
    """Every (call node, enclosing function, api name) writing through
    a fenced API — stub/handler tails, epoch-carrying publishes, and
    the client.call("<name>", ...) string form."""
    graph.edges()
    sites: List[Tuple[ast.Call, FunctionInfo, str]] = []
    for name in rules.FENCED_WRITE_APIS:
        for call, info in graph.calls_by_tail.get(name, ()):
            sites.append((call, info, name))
    for name, (kwarg, pos) in rules.FENCED_WRITE_EPOCH_ARG.items():
        for call, info in graph.calls_by_tail.get(name, ()):
            if _has_epoch_arg(call, kwarg, pos):
                sites.append((call, info, name))
    for verb in rules.FENCED_RPC_VERBS:
        for call, info in graph.calls_by_tail.get(verb, ()):
            if not (call.args and isinstance(call.args[0], ast.Constant)
                    and isinstance(call.args[0].value, str)):
                continue
            name = call.args[0].value
            if name in rules.FENCED_WRITE_APIS:
                sites.append((call, info, name))
            elif name in rules.FENCED_WRITE_EPOCH_ARG:
                kwarg, pos = rules.FENCED_WRITE_EPOCH_ARG[name]
                if _has_epoch_arg(call, kwarg, pos, offset=1):
                    sites.append((call, info, name))
    return sites


def _parents(fn_node: ast.AST) -> Dict[int, ast.AST]:
    out: Dict[int, ast.AST] = {}
    for node in ast.walk(fn_node):
        for child in ast.iter_child_nodes(node):
            out[id(child)] = node
    return out


def _name_loads(fn_node: ast.AST, name: str) -> List[ast.Name]:
    return [n for n in _walk_no_nested(fn_node)
            if isinstance(n, ast.Name) and n.id == name
            and isinstance(n.ctx, ast.Load)]


def _classify(call: ast.Call, info: FunctionInfo) -> str:
    """How the fenced result is used: 'discarded' (never looked at),
    'carrier' (forwarded verbatim via return — charge the callers), or
    'consumed' (anything else: tests, call args, attribute stores)."""
    parents = _parents(info.node)
    node: ast.AST = call
    parent = parents.get(id(node))
    while isinstance(parent, ast.Await):
        node, parent = parent, parents.get(id(parent))
    if isinstance(parent, ast.Expr):
        return "discarded"
    if isinstance(parent, ast.Return):
        return "carrier"
    if isinstance(parent, ast.Assign) and parent.value is node \
            and len(parent.targets) == 1 \
            and isinstance(parent.targets[0], ast.Name):
        loads = _name_loads(info.node, parent.targets[0].id)
        if not loads:
            return "discarded"
        returned = set()
        for n in _walk_no_nested(info.node):
            if isinstance(n, ast.Return) and isinstance(n.value, ast.Name):
                returned.add(id(n.value))
        if all(id(n) in returned for n in loads):
            return "carrier"
        return "consumed"
    return "consumed"


def _check_result_ignored(graph: CallGraph,
                          findings: List[Finding]) -> None:
    sites = _fenced_call_sites(graph)
    # (api name, chain of carrier hops) per pending site; carriers fan
    # the classification out to their own call sites, transitively.
    work = [(call, info, api, []) for call, info, api in sites]
    seen_carriers: Set[Tuple[str, str]] = set()
    while work:
        call, info, api, chain = work.pop()
        verdict = _classify(call, info)
        if verdict == "consumed":
            continue
        if verdict == "carrier":
            if (info.fqn, api) in seen_carriers:
                continue
            seen_carriers.add((info.fqn, api))
            tail = info.node.name
            for caller_call, caller_info in \
                    graph.calls_by_tail.get(tail, ()):
                callee, _ = graph.resolve_call_cached(caller_call,
                                                      caller_info)
                if callee == info.fqn:
                    work.append((caller_call, caller_info, api,
                                 chain + [info.qualname]))
            continue
        via = f" (via the {' -> '.join(chain)} fence carrier)" \
            if chain else ""
        findings.append(Finding(
            rule=rules.FENCE_RESULT_IGNORED,
            path=info.file.relpath, line=call.lineno,
            symbol=info.qualname,
            message=(f"result of fenced write {api!r} is discarded"
                     f"{via}: {rules.FENCED_WRITE_APIS.get(api) or 'a stale epoch returns a rejection'}"
                     f" — a writer that ignores the verdict keeps "
                     f"acting as the owner after being deposed "
                     f"(self-fence or raise on a stale write)")))


def _check_unfenced_mutation(graph: CallGraph,
                             findings: List[Finding]) -> None:
    banned_tails = {t for spellings in rules.FENCED_STATE_CLASSES.values()
                    for t in spellings}
    for tail in sorted(banned_tails):
        for call, info in graph.calls_by_tail.get(tail, ()):
            banned = rules.FENCED_STATE_CLASSES.get(info.cls or "", ())
            if tail in banned:
                findings.append(Finding(
                    rule=rules.FENCE_UNFENCED_MUTATION,
                    path=info.file.relpath, line=call.lineno,
                    symbol=info.qualname,
                    message=(f"raw {tail!r} write inside fenced class "
                             f"{info.cls}: this class's control state "
                             f"is epoch-fenced — an unfenced write "
                             f"lets a deposed instance clobber the "
                             f"new owner's state (use the fenced API "
                             f"with the instance epoch)")))
    for verb in rules.FENCED_RPC_VERBS:
        for call, info in graph.calls_by_tail.get(verb, ()):
            if not (call.args and isinstance(call.args[0], ast.Constant)
                    and isinstance(call.args[0].value, str)):
                continue
            name = call.args[0].value
            banned = rules.FENCED_STATE_CLASSES.get(info.cls or "", ())
            if name in banned:
                findings.append(Finding(
                    rule=rules.FENCE_UNFENCED_MUTATION,
                    path=info.file.relpath, line=call.lineno,
                    symbol=info.qualname,
                    message=(f"raw call({name!r}, ...) inside fenced "
                             f"class {info.cls}: use the fenced API "
                             f"with the instance epoch")))
    for name, (kwarg, pos) in rules.FENCED_WRITE_EPOCH_ARG.items():
        for call, info in graph.calls_by_tail.get(name, ()):
            if info.cls in rules.FENCED_STATE_CLASSES \
                    and not _has_epoch_arg(call, kwarg, pos):
                findings.append(Finding(
                    rule=rules.FENCE_UNFENCED_MUTATION,
                    path=info.file.relpath, line=call.lineno,
                    symbol=info.qualname,
                    message=(f"{name!r} without its {kwarg!r} argument "
                             f"inside fenced class {info.cls}: the hub "
                             f"treats an epoch-less publish as "
                             f"unfenced, so a deposed publisher "
                             f"overwrites the new owner's snapshot")))


def _dotted_of(node: ast.AST) -> Optional[str]:
    while isinstance(node, ast.Subscript):
        node = node.value
    return dotted(node)


def _matches(node: ast.AST, suffix: str) -> bool:
    d = _dotted_of(node)
    return d is not None and (d == suffix or d.endswith("." + suffix))


def _check_compare_direction(graph: CallGraph,
                             findings: List[Finding]) -> None:
    by_path: Dict[str, List[Tuple[str, str]]] = {}
    for path, suffix, mode in rules.EPOCH_COMPARE_TABLE:
        by_path.setdefault(path, []).append((suffix, mode))
    by_rel = {f.relpath: f for f in graph.project.files}
    for path, entries in by_path.items():
        src = by_rel.get(path)
        if src is None:
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
            if not (isinstance(node, ast.Compare)
                    and len(node.ops) == 1):
                return
            left, op, right = node.left, node.ops[0], node.comparators[0]
            if type(op) not in _MIRROR:
                return
            for suffix, mode in entries:
                lm, rm = _matches(left, suffix), _matches(right, suffix)
                if lm == rm:        # neither side, or ambiguous
                    continue
                incoming = left if rm else right
                norm_op = type(op) if rm else _MIRROR[type(op)]
                if isinstance(incoming, ast.Constant):
                    continue        # sentinel checks, not protocol
                if norm_op in _BAD_OPS[mode]:
                    want = ("strictly-older-loses (equal must be "
                            "ACCEPTED: a same-epoch republish is "
                            "legitimate)") if mode == "equal-ok" else \
                        ("strictly-newer-wins (equal must be "
                         "REJECTED: an equal version is a replay)")
                    from ray_tpu_torch.analysis.core import qualname_of
                    findings.append(Finding(
                        rule=rules.FENCE_COMPARE_DIRECTION,
                        path=path, line=node.lineno,
                        symbol=qualname_of(stack),
                        message=(f"comparison against stored clock "
                                 f"{suffix!r} has the wrong direction "
                                 f"for a {mode!r} fence: the protocol "
                                 f"is {want}")))

        visit(src.tree)


def _dict_payload(call: ast.Call, argidx: int,
                  info: FunctionInfo) -> Optional[ast.Dict]:
    """The payload argument as a dict literal — direct, or resolved
    through the last same-function assignment to a local name before
    the call. Opaque payload expressions return None (not evidence)."""
    if len(call.args) <= argidx:
        return None
    payload = call.args[argidx]
    if isinstance(payload, ast.Dict):
        return payload
    if not isinstance(payload, ast.Name):
        return None
    best: Optional[ast.Dict] = None
    best_line = -1
    for node in _walk_no_nested(info.node):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id == payload.id \
                and isinstance(node.value, ast.Dict) \
                and best_line < node.lineno <= call.lineno:
            best, best_line = node.value, node.lineno
    return best


def _check_epoch_threaded(graph: CallGraph,
                          findings: List[Finding]) -> None:
    for (cls, tail), (argidx, key) in \
            sorted(rules.FENCED_PAYLOAD_RULES.items()):
        for call, info in graph.calls_by_tail.get(tail, ()):
            if info.cls != cls:
                continue
            payload = _dict_payload(call, argidx, info)
            if payload is None:
                continue
            keys = {k.value for k in payload.keys
                    if isinstance(k, ast.Constant)}
            if key not in keys:
                findings.append(Finding(
                    rule=rules.FENCE_EPOCH_NOT_THREADED,
                    path=info.file.relpath, line=call.lineno,
                    symbol=info.qualname,
                    message=(f"payload of fenced {tail!r} in {cls} "
                             f"lacks the {key!r} key: subscribers run "
                             f"their own staleness check against the "
                             f"payload clock — without it every "
                             f"downstream fence is blind")))


def check(graph: CallGraph,
          emit_files: Optional[set] = None) -> List[Finding]:
    findings: List[Finding] = []
    _check_result_ignored(graph, findings)
    _check_unfenced_mutation(graph, findings)
    _check_compare_direction(graph, findings)
    _check_epoch_threaded(graph, findings)
    if emit_files is not None:
        findings = [f for f in findings if f.path in emit_files]
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    return findings


def sites(graph: CallGraph) -> int:
    """Fenced writes, plus the epoch-compare table's rows whose file is
    in the package."""
    paths = {f.relpath for f in graph.project.files}
    return len(_fenced_call_sites(graph)) + sum(
        1 for path, _s, _m in rules.EPOCH_COMPARE_TABLE if path in paths)
