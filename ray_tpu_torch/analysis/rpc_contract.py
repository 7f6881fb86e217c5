"""rpc-contract: string-keyed RPC calls checked against registrations.

The RPC plane is stringly-typed: ``RpcServer(handlers={"name": fn})``
on one side, ``client.call("name", args...)`` on the other, with
nothing but grep keeping them aligned. A renamed handler, a drifted
argument list, or a dead endpoint is invisible until a peer throws at
runtime. Three rules:

* rpc-unknown-method   — a literal ``.call("x")``/``.notify("x")`` whose
                         name is registered by NO server in the package
                         (also: an ``inline_methods`` entry naming no
                         handler).
* rpc-arity-mismatch   — the call's positional/keyword shape cannot be
                         accepted by any registration of that name
                         (client-consumed kwargs like ``timeout`` are
                         excluded; ``*``-splats make a site unchecked).
* rpc-dead-endpoint    — a registered name never called anywhere in the
                         package (attributed to the registration line).
                         Dynamic dispatch (dashboard ``?method=`` proxy)
                         is whitelisted via rules.RPC_DYNAMIC_ENDPOINTS
                         or a pragma on the registration.

Namespace model: the union of all registrations package-wide (the
specified contract). A name registered by several servers is
callable if ANY registration accepts the call's shape.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.analysis import rules
from ray_tpu_torch.analysis.callgraph import CallGraph, FunctionInfo
from ray_tpu_torch.analysis.core import Finding


@dataclass
class Registration:
    name: str                    # RPC method name (the string key)
    path: str                    # file of the registration
    line: int                    # line of the dict key / register call
    symbol: str                  # enclosing function qualname
    # accepted shape, from the handler's signature (None = unresolvable
    # handler: name checking still applies, arity checking is skipped)
    min_pos: Optional[int] = None
    max_pos: Optional[int] = None     # None with has_varargs
    has_varargs: bool = False
    has_kwargs: bool = False
    kw_names: Tuple[str, ...] = ()    # every keyword it can accept
    required_kwonly: Tuple[str, ...] = ()
    handler_fqn: Optional[str] = None  # resolved handler (stub gen)


@dataclass
class CallSite:
    name: str
    path: str
    line: int
    symbol: str
    n_pos: Optional[int]         # None when *args splat present
    kw_names: Tuple[str, ...]
    has_kw_splat: bool
    verb: str                    # call | notify | wrapper name


def _shape_of_arguments(args: ast.arguments, drop_first: bool
                        ) -> Dict[str, object]:
    """Accepted-call shape of a FunctionDef/Lambda ``arguments`` node.
    ``drop_first`` drops the bound ``self``/``cls`` parameter."""
    pos = list(args.posonlyargs) + list(args.args)
    if drop_first and pos:
        pos = pos[1:]
    n_defaults = len(args.defaults)
    min_pos = max(0, len(pos) - n_defaults)
    kwonly = [a.arg for a in args.kwonlyargs]
    required_kwonly = tuple(
        a.arg for a, d in zip(args.kwonlyargs, args.kw_defaults)
        if d is None)
    return {
        "min_pos": min_pos,
        "max_pos": None if args.vararg else len(pos),
        "has_varargs": args.vararg is not None,
        "has_kwargs": args.kwarg is not None,
        # positional params are also addressable by keyword (posonly
        # excluded)
        "kw_names": tuple(a.arg for a in args.args[
            (1 if drop_first and not args.posonlyargs else 0):]
        ) + tuple(kwonly),
        "required_kwonly": required_kwonly,
    }


def _handler_shape(graph: CallGraph, value: ast.AST, ctx: FunctionInfo
                   ) -> Optional[Dict[str, object]]:
    """Shape accepted by a handler-map value expression, or None."""
    if isinstance(value, ast.Lambda):
        return _shape_of_arguments(value.args, drop_first=False)
    fqn = graph.resolve_callable_expr(value, ctx)
    if fqn is None or fqn not in graph.functions:
        return None
    target = graph.functions[fqn]
    is_method = target.cls is not None \
        and "." in target.qualname \
        and not any(_dec_name(d) == "staticmethod"
                    for d in getattr(target.node, "decorator_list", ()))
    return _shape_of_arguments(target.node.args, drop_first=is_method)


def _dec_name(dec: ast.AST) -> Optional[str]:
    if isinstance(dec, ast.Name):
        return dec.id
    if isinstance(dec, ast.Attribute):
        return dec.attr
    return None


def collect_registrations(graph: CallGraph
                          ) -> Tuple[List[Registration],
                                     List[Tuple[str, str, int, str, str]],
                                     Dict[str, str]]:
    """-> (registrations, inline_decls, handler_fqns).

    inline_decls: (name, path, line, symbol, via) for every
    ``inline_methods`` entry. handler_fqns: rpc name -> resolved handler
    fqn where known (guarded-by uses these as pool-thread entry points).
    """
    cached = getattr(graph, "_rpc_registrations", None)
    if cached is not None:
        return cached
    graph.edges()  # ensure the side indexes are built

    regs: List[Registration] = []
    inline: List[Tuple[str, str, int, str, str]] = []
    handler_fqns: Dict[str, str] = {}

    # RpcServer(handlers={...}, inline_methods={...})
    for node, info in graph.calls_by_kwarg.get(
            rules.RPC_HANDLERS_KWARG, ()):
        for kw in node.keywords:
            if kw.arg == rules.RPC_HANDLERS_KWARG \
                    and isinstance(kw.value, ast.Dict):
                for key, value in zip(kw.value.keys, kw.value.values):
                    if not (isinstance(key, ast.Constant)
                            and isinstance(key.value, str)):
                        continue
                    reg = Registration(
                        name=key.value, path=info.file.relpath,
                        line=key.lineno, symbol=info.qualname)
                    shape = _handler_shape(graph, value, info)
                    if shape is not None:
                        for k, v in shape.items():
                            setattr(reg, k, v)
                    hfqn = graph.resolve_callable_expr(value, info)
                    if hfqn is not None and hfqn in graph.functions:
                        handler_fqns.setdefault(key.value, hfqn)
                        reg.handler_fqn = hfqn
                    regs.append(reg)
    for node, info in graph.calls_by_kwarg.get(
            rules.RPC_INLINE_KWARG, ()):
        for kw in node.keywords:
            if kw.arg == rules.RPC_INLINE_KWARG \
                    and isinstance(kw.value, (ast.Set, ast.List,
                                              ast.Tuple)):
                for el in kw.value.elts:
                    if isinstance(el, ast.Constant) \
                            and isinstance(el.value, str):
                        inline.append((el.value, info.file.relpath,
                                       el.lineno, info.qualname,
                                       "inline_methods"))
    # server.register("name", fn) — exactly two positionals with a
    # literal name (gym.register/atexit.register don't match).
    for node, info in graph.calls_by_tail.get(
            rules.RPC_REGISTER_METHOD, ()):
        if isinstance(node.func, ast.Attribute) \
                and not node.keywords and len(node.args) == 2 \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str):
            reg = Registration(
                name=node.args[0].value, path=info.file.relpath,
                line=node.lineno, symbol=info.qualname)
            shape = _handler_shape(graph, node.args[1], info)
            if shape is not None:
                for k, v in shape.items():
                    setattr(reg, k, v)
            hfqn = graph.resolve_callable_expr(node.args[1], info)
            if hfqn is not None and hfqn in graph.functions:
                handler_fqns.setdefault(node.args[0].value, hfqn)
                reg.handler_fqn = hfqn
            regs.append(reg)
    result = (regs, inline, handler_fqns)
    graph._rpc_registrations = result  # memoized: guarded-by reuses it
    return result


def _stub_classes(graph: CallGraph) -> Dict[str, frozenset]:
    """class name -> method names for the generated stub module
    (``<Owner>Stub`` classes in rules.RPC_STUBS_MODULE)."""
    out: Dict[str, frozenset] = {}
    for (mod, cls), ci in graph.classes.items():
        if mod == rules.RPC_STUBS_MODULE and cls.endswith("Stub") \
                and not cls.startswith("_"):
            out[cls] = frozenset(m for m in ci.methods
                                 if not m.startswith("_"))
    return out


def _stub_receiver_class(graph: CallGraph, recv: ast.AST,
                         info: FunctionInfo) -> Optional[str]:
    """The stub class a receiver expression is an instance of, in the
    three migrated spellings: chained ``ControllerStub(c).m(...)``, a
    local alias ``st = ControllerStub(c); st.m(...)``, and a typed
    self-attribute ``self._stub = ControllerStub(c)``."""
    if isinstance(recv, ast.Call):
        hit = graph._class_of_ctor(recv, info)
    elif isinstance(recv, ast.Name):
        alias = info.aliases.get(recv.id)
        if not isinstance(alias, ast.Call):
            return None
        hit = graph._class_of_ctor(alias, info)
    elif isinstance(recv, ast.Attribute) \
            and isinstance(recv.value, ast.Name) \
            and recv.value.id in ("self", "cls") and info.cls is not None:
        hit = graph.self_attr_types.get((info.module, info.cls,
                                         recv.attr))
    else:
        return None
    if hit is not None and hit[0] == rules.RPC_STUBS_MODULE:
        return hit[1]
    return None


def collect_call_sites(graph: CallGraph) -> List[CallSite]:
    graph.edges()  # ensure the side indexes are built
    sites: List[CallSite] = []
    wrappers = rules.RPC_CALL_WRAPPERS
    for verb in tuple(rules.RPC_METHODS) + tuple(wrappers):
        for node, info in graph.calls_by_tail.get(verb, ()):
            if not isinstance(node.func, ast.Attribute):
                continue
            extra = 0
            if verb in wrappers:
                extra, wrapper_module = wrappers[verb]
                if wrapper_module is not None \
                        and info.module != wrapper_module:
                    continue
            if not node.args or not (
                    isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                continue  # dynamic method name: unchecked
            payload = node.args[1:]
            has_splat = any(isinstance(a, ast.Starred) for a in payload)
            kw_names = tuple(kw.arg for kw in node.keywords
                             if kw.arg is not None
                             and kw.arg not in rules.RPC_CLIENT_KWARGS)
            has_kw_splat = any(kw.arg is None for kw in node.keywords)
            sites.append(CallSite(
                name=node.args[0].value, path=info.file.relpath,
                line=node.lineno, symbol=info.qualname,
                n_pos=None if has_splat else len(payload) + extra,
                kw_names=kw_names, has_kw_splat=has_kw_splat,
                verb=verb))
    # Generated-stub call sites: ``<StubCls>(client).method(...)``-shaped
    # calls are literal uses of the endpoint the method mirrors — they
    # count toward dead-endpoint coverage and get the same shape check
    # (the stub signature mirrors the handler, but a drifted call site
    # should fail HERE, not at the peer). The stub module's own
    # ``self._call(method, ...)`` forwarding is deliberately NOT a use:
    # counting it would mark every endpoint alive.
    stub_cls = _stub_classes(graph)
    if stub_cls:
        for cls, methods in stub_cls.items():
            for meth in methods:
                for node, info in graph.calls_by_tail.get(meth, ()):
                    if not isinstance(node.func, ast.Attribute) \
                            or info.module == rules.RPC_STUBS_MODULE:
                        continue
                    recv_cls = _stub_receiver_class(
                        graph, node.func.value, info)
                    if recv_cls != cls:
                        continue
                    has_splat = any(isinstance(a, ast.Starred)
                                    for a in node.args)
                    kw_names = tuple(
                        kw.arg for kw in node.keywords
                        if kw.arg is not None
                        and kw.arg not in rules.RPC_CLIENT_KWARGS)
                    sites.append(CallSite(
                        name=meth, path=info.file.relpath,
                        line=node.lineno, symbol=info.qualname,
                        n_pos=None if has_splat else len(node.args),
                        kw_names=kw_names,
                        has_kw_splat=any(kw.arg is None
                                         for kw in node.keywords),
                        verb="stub"))
    return sites


def _site_accepted(site: CallSite, reg: Registration) -> Optional[str]:
    """None when the registration accepts the site's shape, else a short
    reason string."""
    if reg.min_pos is None:
        return None  # unresolvable handler: name-only checking
    if site.n_pos is not None:
        if site.n_pos < reg.min_pos:
            # keywords may cover the remaining positional params
            if not site.kw_names and not site.has_kw_splat:
                return (f"{site.n_pos} positional arg(s) for a handler "
                        f"requiring {reg.min_pos}")
        if reg.max_pos is not None and site.n_pos > reg.max_pos:
            return (f"{site.n_pos} positional arg(s) for a handler "
                    f"taking at most {reg.max_pos}")
    if not reg.has_kwargs:
        unknown = [k for k in site.kw_names if k not in reg.kw_names]
        if unknown:
            return f"unknown keyword(s) {', '.join(sorted(unknown))}"
    if reg.required_kwonly and not site.has_kw_splat:
        missing = [k for k in reg.required_kwonly
                   if k not in site.kw_names]
        if missing:
            return (f"missing required keyword-only "
                    f"arg(s) {', '.join(missing)}")
    return None


def check(graph: CallGraph, emit_files=None) -> List[Finding]:
    regs, inline, _handler_fqns = collect_registrations(graph)
    sites = collect_call_sites(graph)
    findings: List[Finding] = []

    by_name: Dict[str, List[Registration]] = {}
    for reg in regs:
        by_name.setdefault(reg.name, []).append(reg)

    # inline_methods entries must name a registered handler
    for name, path, line, symbol, _via in inline:
        if name not in by_name:
            findings.append(Finding(
                rule=rules.RPC_UNKNOWN, path=path, line=line,
                symbol=symbol,
                message=f"inline_methods entry \"{name}\" matches no "
                        f"registered handler"))

    called = set()
    for site in sites:
        called.add(site.name)
        cands = by_name.get(site.name)
        if not cands:
            findings.append(Finding(
                rule=rules.RPC_UNKNOWN, path=site.path, line=site.line,
                symbol=site.symbol,
                message=f".{site.verb}(\"{site.name}\") matches no "
                        f"handler registered anywhere in the package"))
            continue
        reasons = []
        for reg in cands:
            reason = _site_accepted(site, reg)
            if reason is None:
                reasons = []
                break
            reasons.append(reason)
        if reasons:
            findings.append(Finding(
                rule=rules.RPC_ARITY, path=site.path, line=site.line,
                symbol=site.symbol,
                message=f".{site.verb}(\"{site.name}\") rejected by "
                        f"every registration: {reasons[0]} "
                        f"(handler registered at "
                        f"{cands[0].path}:{cands[0].line})"))

    for reg in regs:
        if reg.name in called \
                or reg.name in rules.RPC_DYNAMIC_ENDPOINTS:
            continue
        findings.append(Finding(
            rule=rules.RPC_DEAD, path=reg.path, line=reg.line,
            symbol=reg.symbol,
            message=f"handler \"{reg.name}\" is registered but never "
                    f"called with a literal name anywhere in the "
                    f"package (dynamic-dispatch endpoints: "
                    f"rules.RPC_DYNAMIC_ENDPOINTS or pragma)"))
    if emit_files is not None:
        findings = [f for f in findings if f.path in emit_files]
    return findings


def sites(graph: CallGraph) -> int:
    """Handler registrations plus literal RPC call sites."""
    regs, _inline, _fqns = collect_registrations(graph)
    return len(regs) + len(collect_call_sites(graph))
