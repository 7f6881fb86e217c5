"""deadline-safety: nothing in the control plane may block forever.

The runtime's signature failure mode is the silent distributed hang —
one member parks on an unbounded wait and the whole gang idles. Five
rules on the shared call graph police *time* the way the lock/lease
families police state:

* ``unbounded-blocking-call`` — reactor-blocking-call generalized past
  the reactor: every thread entry point graftlint already enumerates
  (RPC handlers, ``threading.Thread``/``Timer`` targets, executor
  submissions — the reactor itself stays family #1's job) is BFS-walked
  and any reachable ``Event.wait()`` / ``Queue.get()`` / ``join()`` /
  ``future.result()`` / socket ``recv`` without a finite bound is
  flagged. Bounded = the timeout-position argument is present and not
  the literal ``None``; queue receivers are ctor-typed so dict/
  contextvar ``.get`` never matches.
* ``rpc-call-no-timeout`` — in the control-plane modules
  (rules.DEADLINE_RPC_SCOPE_PREFIXES), every literal ``.call("x",...)``
  and typed-stub call must carry ``timeout=``: the client transport
  treats ``timeout=None`` as park-forever, and a faultinject ``drop``
  rule on the endpoint (or a dead peer mid-call) wedges the caller.
* ``deadline-not-propagated`` — a function accepting a ``timeout_s`` /
  ``deadline`` budget that hands the FULL budget to 2+ blocking/RPC
  sites (N× the caller's budget) or makes an unbounded one, without a
  remaining-time idiom (``util.deadline.Deadline`` or raw
  ``time.monotonic`` arithmetic). One budget-consuming call is a
  pass-through, not a violation.
* ``retry-unbounded`` — ``while True`` / ``itertools.count`` loops
  re-issuing dial/RPC verbs with no backoff sleep, attempt counter, or
  deadline check in the body (the reconnect-storm shape).
* ``timeout-knob-dead`` — every ``*_timeout_s`` knob in core/config.py
  must be READ somewhere in the package (``config.<knob>``); a knob
  never threaded to a wait site is dead documentation, mirroring
  rpc-dead-endpoint.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from ray_tpu_torch.analysis import rules
from ray_tpu_torch.analysis.callgraph import (CallGraph, FunctionInfo, _short,
                                        _walk_no_nested, dotted)
from ray_tpu_torch.analysis.core import Finding

# ----------------------------------------------------- receiver typing


def _ctor_typed(graph: CallGraph, ctors: Set[str],
                ) -> Tuple[Set[Tuple[str, Optional[str], str]],
                           Set[Tuple[str, str]]]:
    """Receivers typed by construction: ``self.x = Ctor()`` anywhere in
    a class -> (module, cls, attr); ``q = Ctor()`` -> (fqn, local)."""
    self_attrs: Set[Tuple[str, Optional[str], str]] = set()
    fn_locals: Set[Tuple[str, str]] = set()
    for fqn, info in graph.functions.items():
        for node in _walk_no_nested(info.node):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.value, ast.Call)):
                continue
            rd = graph.resolved_dotted(node.value, info)
            if rd is None or rd not in ctors:
                continue
            tgt = node.targets[0]
            if (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"):
                self_attrs.add((info.module, info.cls, tgt.attr))
            elif isinstance(tgt, ast.Name):
                fn_locals.add((fqn, tgt.id))
    return self_attrs, fn_locals


def _stub_typed(graph: CallGraph
                ) -> Tuple[Set[Tuple[str, Optional[str], str]],
                           Set[Tuple[str, str]]]:
    """Receivers typed as generated RPC stubs (``ControllerStub(...)``
    and friends, rules.RPC_STUBS_MODULE)."""
    self_attrs: Set[Tuple[str, Optional[str], str]] = set()
    fn_locals: Set[Tuple[str, str]] = set()
    prefix = rules.RPC_STUBS_MODULE + "."
    for fqn, info in graph.functions.items():
        for node in _walk_no_nested(info.node):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.value, ast.Call)):
                continue
            if not _is_stub_ctor(graph, node.value, info, prefix):
                continue
            tgt = node.targets[0]
            if (isinstance(tgt, ast.Attribute)
                    and isinstance(tgt.value, ast.Name)
                    and tgt.value.id == "self"):
                self_attrs.add((info.module, info.cls, tgt.attr))
            elif isinstance(tgt, ast.Name):
                fn_locals.add((fqn, tgt.id))
    return self_attrs, fn_locals


def _is_stub_ctor(graph: CallGraph, call: ast.Call, info: FunctionInfo,
                  prefix: str) -> bool:
    rd = graph.resolved_dotted(call, info)
    if rd is not None and rd.startswith(prefix):
        return True
    # unresolved import paths: fall back on the ``*Stub(...)`` spelling
    d = dotted(call.func)
    return d is not None and d.split(".")[-1].endswith("Stub")


# ------------------------------------------------- wait-site inventory


def _timeout_arg(node: ast.Call, kwname: str,
                 pos: int) -> Optional[ast.AST]:
    for kw in node.keywords:
        if kw.arg == kwname:
            return kw.value
    if len(node.args) > pos:
        return node.args[pos]
    return None


def _is_none(expr: Optional[ast.AST]) -> bool:
    return isinstance(expr, ast.Constant) and expr.value is None


def _is_false(expr: Optional[ast.AST]) -> bool:
    return isinstance(expr, ast.Constant) and expr.value is False


def wait_sites(graph: CallGraph
               ) -> Dict[str, List[Tuple[int, str, bool]]]:
    """fqn -> [(line, label, bounded)] for every wait-verb call.
    ``get`` only on queue-typed receivers; socket recv verbs bounded
    when the enclosing module manages socket modes."""
    graph.edges()  # calls_by_tail is built as an edge-walk side index
    q_attrs, q_locals = _ctor_typed(
        graph, set(rules.DEADLINE_QUEUE_CTORS))
    out: Dict[str, List[Tuple[int, str, bool]]] = {}

    def add(info: FunctionInfo, line: int, label: str,
            bounded: bool) -> None:
        out.setdefault(info.fqn, []).append((line, label, bounded))

    for verb, (kwname, pos, label) in rules.DEADLINE_WAIT_VERBS.items():
        for node, info in graph.calls_by_tail.get(verb, ()):
            if not isinstance(node.func, ast.Attribute):
                continue
            recv = node.func.value
            if isinstance(recv, ast.Constant):
                continue  # "\n".join(...) and friends
            if verb == "get":
                typed = False
                if (isinstance(recv, ast.Attribute)
                        and isinstance(recv.value, ast.Name)
                        and recv.value.id == "self"):
                    typed = (info.module, info.cls,
                             recv.attr) in q_attrs
                elif isinstance(recv, ast.Name):
                    typed = (info.fqn, recv.id) in q_locals
                if not typed:
                    continue
                block = _timeout_arg(node, rules.DEADLINE_NONBLOCK_KWARG,
                                     0)
                if _is_false(block):
                    continue  # non-blocking get
            t = _timeout_arg(node, kwname, pos)
            add(info, node.lineno, label,
                t is not None and not _is_none(t))

    # socket reads: bounded only via settimeout/setblocking, checked at
    # module granularity (the reactor's nonblocking fds, _connect's
    # bounded dial)
    managed: Set[str] = set()
    for mode_call in rules.DEADLINE_SOCKET_MODE_CALLS:
        for node, info in graph.calls_by_tail.get(mode_call, ()):
            managed.add(info.module)
    for verb in rules.DEADLINE_SOCKET_VERBS:
        for node, info in graph.calls_by_tail.get(verb, ()):
            if not isinstance(node.func, ast.Attribute):
                continue
            add(info, node.lineno, f"socket {verb} with unmanaged "
                "timeout", info.module in managed)
    return out


# -------------------------------------------------- rpc-site inventory


def _stub_param(info: FunctionInfo, name: str) -> bool:
    a = info.node.args
    params = {p.arg for p in (a.posonlyargs + a.args + a.kwonlyargs)}
    return name in params and (
        name in rules.DEADLINE_STUB_PARAM_NAMES
        or name.endswith(rules.DEADLINE_STUB_PARAM_SUFFIX))


def rpc_sites(graph: CallGraph
              ) -> Dict[str, List[Tuple[int, str, bool]]]:
    """fqn -> [(line, "method", bounded)] for literal ``.call`` and
    typed-stub RPC sites (``notify`` is fire-and-forget: exempt)."""
    s_attrs, s_locals = _stub_typed(graph)
    prefix = rules.RPC_STUBS_MODULE + "."
    out: Dict[str, List[Tuple[int, str, bool]]] = {}

    for fqn, info in graph.functions.items():
        if info.file.relpath == rules.RPC_STUBS_PATH:
            continue  # generated pass-throughs thread their own kwarg
        for node in _walk_no_nested(info.node):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            meth = None
            if (node.func.attr == "call" and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                meth = node.args[0].value
            else:
                recv = node.func.value
                stubbed = False
                if (isinstance(recv, ast.Attribute)
                        and isinstance(recv.value, ast.Name)
                        and recv.value.id == "self"):
                    stubbed = (info.module, info.cls,
                               recv.attr) in s_attrs
                elif isinstance(recv, ast.Name):
                    stubbed = (info.fqn, recv.id) in s_locals \
                        or _stub_param(info, recv.id)
                elif isinstance(recv, ast.Call):
                    stubbed = _is_stub_ctor(graph, recv, info, prefix)
                if stubbed:
                    meth = node.func.attr
            if meth is None:
                continue
            t = _timeout_arg(node, "timeout", 10**9)  # kwarg-only
            out.setdefault(fqn, []).append(
                (node.lineno, meth,
                 t is not None and not _is_none(t)))
    return out


# ------------------------------------------------------------- checks


def _thread_roots(graph: CallGraph) -> Dict[str, str]:
    """root fqn -> entry key, for every NON-reactor, NON-synthetic
    thread entry (the reactor stays reactor-blocking-call's beat;
    ``caller`` would make the whole package 'thread code')."""
    from ray_tpu_torch.analysis.guarded_by import thread_entries

    entries, _self_conc = thread_entries(graph)
    roots: Dict[str, str] = {}
    for key, fqns in entries.items():
        if key in ("caller", "reactor"):
            continue
        for fqn in fqns:
            roots.setdefault(fqn, key)
    return roots


def _check_unbounded(graph: CallGraph, waits, emit_files
                     ) -> List[Finding]:
    roots = _thread_roots(graph)
    findings: List[Finding] = []
    paths: Dict[str, Tuple[str, List[str]]] = {
        fqn: (key, [_short(fqn)]) for fqn, key in roots.items()}
    queue = list(paths)
    while queue:
        fqn = queue.pop(0)
        key, chain = paths[fqn]
        info = graph.functions[fqn]
        emit = emit_files is None or info.file.relpath in emit_files
        if emit:
            for line, label, bounded in waits.get(fqn, ()):
                if bounded:
                    continue
                via = " -> ".join(chain)
                findings.append(Finding(
                    rule=rules.DEADLINE_UNBOUNDED,
                    path=info.file.relpath, line=line,
                    symbol=info.qualname,
                    message=f"{label} on thread entry '{key}' "
                            f"(reachable via {via}); pass a finite "
                            f"timeout or thread a Deadline"))
        for callee, _line, _vs in graph.edges().get(fqn, ()):
            if callee not in paths:
                paths[callee] = (key, chain + [_short(callee)])
                queue.append(callee)
    return findings


def _check_rpc_timeout(graph: CallGraph, all_rpc, emit_files
                       ) -> List[Finding]:
    findings: List[Finding] = []
    for fqn, sites in all_rpc.items():
        info = graph.functions[fqn]
        if not info.file.relpath.startswith(
                rules.DEADLINE_RPC_SCOPE_PREFIXES):
            continue
        if emit_files is not None \
                and info.file.relpath not in emit_files:
            continue
        for line, meth, bounded in sites:
            if bounded:
                continue
            findings.append(Finding(
                rule=rules.DEADLINE_RPC_NO_TIMEOUT,
                path=info.file.relpath, line=line,
                symbol=info.qualname,
                message=f"control-plane RPC '{meth}' without timeout= "
                        f"(timeout=None parks forever if the reply "
                        f"never lands)"))
    return findings


def _mentions(node: ast.AST, name: str) -> bool:
    return any(isinstance(n, ast.Name) and n.id == name
               for n in ast.walk(node))


def _budget_passes(fn_node: ast.AST, budget: str) -> int:
    """How many distinct downstream flows consume the budget: the
    OUTERMOST calls mentioning it (nested calls are one flow, so
    ``outs.append(w.run(cmd, timeout))`` counts once), with all
    ``return``-position flows collapsed to one (alternative exits
    cannot compound) and ``raise`` constructors skipped (an error
    message quoting the budget consumes nothing)."""
    count = 0
    return_hit = False

    def rec(node, in_call: bool, in_return: bool) -> None:
        nonlocal count, return_hit
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda, ast.ClassDef)):
                continue
            if isinstance(child, ast.Raise):
                continue
            child_in_call = in_call
            if isinstance(child, ast.Call) and not in_call \
                    and _mentions(child, budget):
                if in_return:
                    return_hit = True
                else:
                    count += 1
                child_in_call = True
            rec(child, child_in_call,
                in_return or isinstance(child, ast.Return))

    rec(fn_node, False, False)
    return count + (1 if return_hit else 0)


def _check_propagation(graph: CallGraph, waits, all_rpc, emit_files
                       ) -> List[Finding]:
    findings: List[Finding] = []
    for fqn, info in graph.functions.items():
        if emit_files is not None \
                and info.file.relpath not in emit_files:
            continue
        a = info.node.args
        params = [p.arg for p in
                  (a.posonlyargs + a.args + a.kwonlyargs)]
        budget = next((p for p in params
                       if p in rules.DEADLINE_PARAM_NAMES), None)
        if budget is None:
            continue
        sites = list(waits.get(fqn, ())) + list(all_rpc.get(fqn, ()))
        if not sites:
            continue
        # remaining-time idiom anywhere in the body: Deadline attrs
        # (.remaining/.expired/.sub) or raw monotonic arithmetic
        idiom = False
        for node in _walk_no_nested(info.node):
            if isinstance(node, ast.Attribute) \
                    and node.attr in rules.DEADLINE_IDIOM_ATTRS:
                idiom = True
                break
            if isinstance(node, ast.Call):
                rd = graph.resolved_dotted(node, info)
                if rd in rules.DEADLINE_IDIOM_DOTTED or (
                        rd is not None and rd.startswith(
                            rules.DEADLINE_HELPER_MODULE)):
                    idiom = True
                    break
        if idiom:
            continue
        unbounded = [s for s in sites if not s[2]]
        # distinct downstream flows the budget is handed to
        passes = _budget_passes(info.node, budget)
        if unbounded:
            line, label, _ = unbounded[0]
            msg = (f"accepts '{budget}' but makes an unbounded "
                   f"call ({label}) — the budget is dropped")
        elif passes >= 2:
            line = sites[0][0]
            msg = (f"hands the full '{budget}' budget to {passes} "
                   f"downstream calls (N x the caller's budget); "
                   f"thread Deadline.remaining()")
        else:
            continue
        findings.append(Finding(
            rule=rules.DEADLINE_NOT_PROPAGATED,
            path=info.file.relpath, line=line, symbol=info.qualname,
            message=msg))
    return findings


def _loop_is_infinite(graph: CallGraph, node: ast.AST,
                      info: FunctionInfo) -> bool:
    if isinstance(node, ast.While):
        return isinstance(node.test, ast.Constant) \
            and bool(node.test.value)
    if isinstance(node, ast.For) and isinstance(node.iter, ast.Call):
        rd = graph.resolved_dotted(node.iter, info)
        return rd == "itertools.count"
    return False


def _check_retry(graph: CallGraph, emit_files) -> List[Finding]:
    findings: List[Finding] = []
    retry_verbs = set(rules.DEADLINE_RETRY_VERBS)
    backoff = set(rules.DEADLINE_BACKOFF_CALLS)
    for fqn, info in graph.functions.items():
        if emit_files is not None \
                and info.file.relpath not in emit_files:
            continue
        for node in _walk_no_nested(info.node):
            if not _loop_is_infinite(graph, node, info):
                continue
            has_rpc = False
            bounded = False
            for sub in ast.walk(node):
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef, ast.Lambda)):
                    continue
                if isinstance(sub, ast.Call):
                    tail = sub.func.attr \
                        if isinstance(sub.func, ast.Attribute) else (
                            sub.func.id
                            if isinstance(sub.func, ast.Name) else None)
                    if tail in retry_verbs:
                        has_rpc = True
                    if tail in backoff:
                        bounded = True
                    rd = graph.resolved_dotted(sub, info)
                    if rd in rules.DEADLINE_IDIOM_DOTTED:
                        bounded = True
                elif isinstance(sub, ast.Attribute) \
                        and sub.attr in rules.DEADLINE_IDIOM_ATTRS:
                    bounded = True
                elif isinstance(sub, ast.AugAssign):
                    bounded = True  # attempt counter
            if has_rpc and not bounded:
                findings.append(Finding(
                    rule=rules.DEADLINE_RETRY_UNBOUNDED,
                    path=info.file.relpath, line=node.lineno,
                    symbol=info.qualname,
                    message="infinite loop re-issuing dial/RPC calls "
                            "with no backoff, attempt bound, or "
                            "deadline check (reconnect-storm shape)"))
    return findings


def _check_dead_knobs(graph: CallGraph, emit_files) -> List[Finding]:
    cfg = next((f for f in graph.project.files
                if f.relpath == rules.DEADLINE_CONFIG_MODULE_PATH),
               None)
    if cfg is None:
        return []
    if emit_files is not None and cfg.relpath not in emit_files:
        return []
    knobs: List[Tuple[str, int]] = []
    for node in ast.walk(cfg.tree):
        # the registry is declared annotated (_FLAG_DEFS: Dict[...] =
        # {...}), so match both assignment spellings
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
        elif isinstance(node, ast.AnnAssign):
            tgt = node.target
        else:
            continue
        if not (isinstance(tgt, ast.Name)
                and tgt.id == rules.DEADLINE_CONFIG_FLAGS_NAME
                and isinstance(node.value, ast.Dict)):
            continue
        for key in node.value.keys:
            if isinstance(key, ast.Constant) \
                    and isinstance(key.value, str) \
                    and key.value.endswith(rules.DEADLINE_KNOB_SUFFIX):
                knobs.append((key.value, key.lineno))
    findings: List[Finding] = []
    for name, line in knobs:
        probe = f".{name}"
        if any(probe in f.text for f in graph.project.files
               if f.relpath != cfg.relpath):
            continue
        findings.append(Finding(
            rule=rules.DEADLINE_KNOB_DEAD,
            path=cfg.relpath, line=line, symbol=name,
            message=f"timeout knob '{name}' is registered but never "
                    f"read (config.{name} appears nowhere): it bounds "
                    f"no wait site"))
    return findings


def check(graph: CallGraph, emit_files=None) -> List[Finding]:
    waits, all_rpc = _site_tables(graph)
    findings = _check_unbounded(graph, waits, emit_files)
    findings += _check_rpc_timeout(graph, all_rpc, emit_files)
    findings += _check_propagation(graph, waits, all_rpc, emit_files)
    findings += _check_retry(graph, emit_files)
    findings += _check_dead_knobs(graph, emit_files)
    return findings


def _site_tables(graph: CallGraph):
    """(wait sites, RPC sites), memoized on the graph (``check`` and
    ``sites`` both read them)."""
    cached = getattr(graph, "_deadline_sites", None)
    if cached is None:
        cached = (wait_sites(graph), rpc_sites(graph))
        graph._deadline_sites = cached
    return cached


def sites(graph: CallGraph) -> int:
    """Wait-verb calls plus literal and typed-stub RPC calls."""
    waits, all_rpc = _site_tables(graph)
    return sum(len(v) for v in waits.values()) + sum(
        len(v) for v in all_rpc.values())
