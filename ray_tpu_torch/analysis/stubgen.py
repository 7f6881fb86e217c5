"""--gen-stubs: typed RPC client stubs generated from the handler index.

The RPC plane is stringly-typed (``client.call("reserve_subslice",
owner, chips, shape)``); rpc_contract polices the strings, but every
call site still re-spells the method name and argument order by hand.
This generator turns rpc_contract's handler index into a checked-in
module (``ray_tpu_torch/core/rpc_stubs.py``) of REAL Python signatures:

    ControllerStub(client).reserve_subslice(owner, chips, shape)
    NodeStub(client).kill_worker(worker_id, force, timeout=5.0)

One ``<Owner>Stub`` class per RpcServer-owning class (Controller, Node,
CoreWorker, ClientServer), one method per registered handler, parameter
names/arity lifted from the handler's signature (``self`` dropped,
defaults preserved as optionality via the ``_UNSET`` sentinel — the
server-side default value stays the single source of truth), plus the
transport's ``timeout`` kwarg on every method. Unresolvable handlers
(lambdas) degrade to ``*args, **kwargs`` passthroughs.

Generation is DETERMINISTIC (classes and methods sorted) so the drift
gate is a straight string compare: the ``rpc-stub-drift`` rule (and
``make lint-stubs-check``) regenerates and fails when a handler
signature changed without rerunning ``--gen-stubs``.

Why generated-and-checked-in instead of built at import time: the stubs
must be greppable, reviewable in diffs when a handler changes, and
importable with zero analysis machinery at runtime.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.analysis import rules
from ray_tpu_torch.analysis.callgraph import CallGraph
from ray_tpu_torch.analysis.core import Finding

_HEADER = '''"""Typed RPC client stubs — GENERATED, do not edit by hand.

Regenerate with ``python -m ray_tpu_torch.analysis --gen-stubs`` whenever a
handler signature changes; ``make lint`` (rpc-stub-drift) and
``make lint-stubs-check`` fail on drift. Each ``<Owner>Stub`` wraps an
RPC client (RpcClient / ReconnectingClient / anything with ``.call``)
and exposes every handler its server registers as a real method —
method names, arities, and the transport ``timeout`` kwarg are checked
by Python itself instead of failing stringly at the peer.

Parameters the handler defaults are declared ``=_UNSET`` and simply
omitted from the wire when not passed, so the SERVER-side default stays
the single source of truth.
"""

from __future__ import annotations

_UNSET = object()


class _StubBase:
    __slots__ = ("_client",)

    def __init__(self, client):
        self._client = client

    def _call(self, method, *args, timeout=_UNSET, **kwargs):
        kwargs = {k: v for k, v in kwargs.items() if v is not _UNSET}
        if timeout is not _UNSET:
            kwargs["timeout"] = timeout
        return self._client.call(method, *args, **kwargs)
'''


def _owner_class(symbol: str, module: str) -> str:
    """Stub-group name for a registration's enclosing symbol:
    ``Controller.__init__`` -> ``Controller``; module-level
    registrations fall back to the module tail, title-cased."""
    head = symbol.split(".")[0]
    if head and head != "<module>" and head[0].isupper():
        return head
    tail = module.rsplit(".", 1)[-1]
    return "".join(p.title() for p in tail.split("_"))


def _fold(prefix: str, parts: List[str], suffix: str) -> str:
    """Greedy line wrap: ``prefix(p1, p2, ...)suffix`` with
    continuations aligned under the open paren, every line <= 78."""
    open_col = len(prefix) + 1
    lines = [prefix + "("]
    for i, part in enumerate(parts):
        tail = part + ("," if i < len(parts) - 1 else suffix)
        if lines[-1].endswith("("):
            cand = lines[-1] + tail
        else:
            cand = lines[-1] + " " + tail
        if len(cand) <= 78:
            lines[-1] = cand
        else:
            lines.append(" " * open_col + tail)
    return "\n".join(lines) + "\n"


def _method_source(graph: CallGraph, name: str,
                   handler_fqn: Optional[str]) -> str:
    """One stub method. Falls back to a passthrough when the handler
    (or an exotic signature) cannot be mirrored faithfully."""
    if not name.isidentifier():
        return ""
    info = graph.functions.get(handler_fqn) if handler_fqn else None
    passthrough = (
        f"    def {name}(self, *args, timeout=_UNSET, **kwargs):\n"
        + _fold("        return self._call",
                [repr(name), "*args", "timeout=timeout", "**kwargs"],
                ")"))
    if info is None:
        return passthrough
    args = info.node.args
    is_method = info.cls is not None and "." in info.qualname and not any(
        isinstance(d, ast.Name) and d.id == "staticmethod"
        for d in getattr(info.node, "decorator_list", ()))
    pos = list(args.posonlyargs) + list(args.args)
    if is_method and pos:
        pos = pos[1:]
    names = [a.arg for a in pos]
    kwonly = [a.arg for a in args.kwonlyargs]
    all_names = names + kwonly
    if args.vararg or args.kwarg or "timeout" in all_names \
            or "self" in all_names or args.posonlyargs \
            or any(not n.isidentifier() for n in all_names):
        return passthrough
    n_req = len(names) - len(args.defaults)
    params, sends = [], [repr(name)]
    for i, n in enumerate(names):
        if i < n_req:
            params.append(n)
            sends.append(n)
        else:
            # defaulted params travel as keywords so an omitted middle
            # arg never shifts later positionals on the wire
            params.append(f"{n}=_UNSET")
            sends.append(f"{n}={n}")
    params.append("*")
    for a, d in zip(args.kwonlyargs, args.kw_defaults):
        params.append(a.arg if d is None else f"{a.arg}=_UNSET")
        sends.append(f"{a.arg}={a.arg}")
    params.append("timeout=_UNSET")
    sends.append("timeout=timeout")
    return _fold(f"    def {name}", ["self"] + params, "):") \
        + _fold("        return self._call", sends, ")")


def stub_groups(graph: CallGraph
                ) -> Dict[str, List[Tuple[str, Optional[str]]]]:
    """owner class -> sorted [(rpc name, handler fqn)] from the handler
    index (one entry per name per owner; first registration wins)."""
    from ray_tpu_torch.analysis import rpc_contract

    regs, _inline, _fqns = rpc_contract.collect_registrations(graph)
    groups: Dict[str, Dict[str, Optional[str]]] = {}
    for reg in regs:
        if reg.path == rules.RPC_STUBS_PATH:
            continue  # never self-referential
        owner = _owner_class(reg.symbol, reg.path.replace("/", ".")
                             .removesuffix(".py"))
        groups.setdefault(owner, {}).setdefault(
            reg.name, getattr(reg, "handler_fqn", None))
    return {owner: sorted(methods.items())
            for owner, methods in sorted(groups.items())}


def generate(graph: CallGraph) -> str:
    """The full deterministic source of ray_tpu_torch/core/rpc_stubs.py."""
    out = [_HEADER]
    for owner, methods in stub_groups(graph).items():
        out.append(f"\n\nclass {owner}Stub(_StubBase):\n")
        out.append(f'    """Typed stubs for the {owner} RPC surface '
                   f'(generated)."""\n')
        wrote = False
        for name, fqn in methods:
            src = _method_source(graph, name, fqn)
            if src:
                out.append("\n" + src)
                wrote = True
        if not wrote:
            out.append("\n    pass\n")
    return "".join(out)


def check(graph: CallGraph, emit_files=None) -> List[Finding]:
    """rpc-stub-drift: the checked-in stub module must byte-match what
    the current handler index generates."""
    f = graph.project.by_module.get(rules.RPC_STUBS_MODULE)
    path = rules.RPC_STUBS_PATH
    if f is None:
        finding = Finding(
            rule=rules.RPC_STUB_DRIFT, path=path, line=1,
            symbol="<module>",
            message="generated stub module is missing — run "
                    "`python -m ray_tpu_torch.analysis --gen-stubs`")
    elif f.text != generate(graph):
        finding = Finding(
            rule=rules.RPC_STUB_DRIFT, path=path, line=1,
            symbol="<module>",
            message="stubs are stale vs the current handler index — a "
                    "handler signature changed without regeneration; "
                    "run `python -m ray_tpu_torch.analysis --gen-stubs`")
    else:
        return []
    if emit_files is not None and path not in emit_files:
        return []
    return [finding]


def sites(graph: CallGraph) -> int:
    """Handlers the generated stubs mirror."""
    return sum(len(m) for m in stub_groups(graph).values())
