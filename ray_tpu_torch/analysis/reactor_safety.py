"""reactor-safety: no blocking call reachable from a selector callback.

A blocking ``send`` on the reactor thread once wedged every
connection at once. This checker walks the call graph from the
reactor-thread functions (``rules.REACTOR_ROOT_FUNCS`` plus anything
named ``_on_readable``/``_on_writable``) and flags every blocking
primitive — ``time.sleep``, blocking connect/sendall, unbounded
``acquire``/``wait``/``join``/``result``, subprocess and file I/O —
that the reactor could hit. Calls that cannot be resolved into the
package (dynamic handler dispatch, pool submission) are treated as
opaque: handlers run on the pool, which is exactly the design.
"""

from __future__ import annotations

from typing import Dict, List

from ray_tpu_torch.analysis import rules
from ray_tpu_torch.analysis.callgraph import CallGraph, _short
from ray_tpu_torch.analysis.core import Finding


def _dotted_table() -> Dict[str, str]:
    table = dict(rules.BLOCKING_DOTTED)
    table.update(rules.REACTOR_EXTRA_DOTTED)
    return table


def _roots(graph: CallGraph) -> List[str]:
    roots = []
    for fqn, info in graph.functions.items():
        tail = info.qualname.rsplit(".", 1)[-1]
        if (any(info.module.endswith(m) and info.qualname == q
                for m, q in rules.REACTOR_ROOT_FUNCS)
                or tail in rules.REACTOR_ROOT_NAME_PATTERNS):
            roots.append(fqn)
    return roots


def sites(graph: CallGraph) -> int:
    """Reactor-thread roots found in the package."""
    return len(_roots(graph))


def check(graph: CallGraph, emit_files=None) -> List[Finding]:
    roots = _roots(graph)

    dotted_table = _dotted_table()
    findings: List[Finding] = []
    blocking_map = graph.direct_blocking_map(
        dotted_table, rules.BLOCKING_METHODS_ALWAYS,
        rules.BLOCKING_METHODS_UNBOUNDED)
    # BFS the reactor-reachable set, remembering one path per function.
    paths: Dict[str, List[str]] = {fqn: [_short(fqn)] for fqn in roots}
    queue = list(roots)
    while queue:
        fqn = queue.pop(0)
        info = graph.functions[fqn]
        if emit_files is not None \
                and info.file.relpath not in emit_files:
            # still walk the closure (reachability is whole-program),
            # just skip emission in out-of-slice files
            for callee, _line, _vs in graph.edges().get(fqn, ()):
                if callee not in paths:
                    paths[callee] = paths[fqn] + [_short(callee)]
                    queue.append(callee)
            continue
        for site_line, label in blocking_map.get(fqn, ()):
            via = " -> ".join(paths[fqn])
            findings.append(Finding(
                rule=rules.REACTOR_BLOCKING,
                path=info.file.relpath, line=site_line,
                symbol=info.qualname,
                message=f"blocking call {label} on the reactor thread "
                        f"(reachable via {via})"))
        for callee, _line, _vs in graph.edges().get(fqn, ()):
            if callee not in paths:
                paths[callee] = paths[fqn] + [_short(callee)]
                queue.append(callee)
    return findings
