"""Metrics family: name collisions and label cardinality.

**metrics-name-collision** — one metric name, one definition. The
metrics registry keys entries by (name, tags); two call sites
registering the SAME name as different KINDS (Counter vs Histogram) or
with different histogram BUCKET grids silently produce entries that can
never be merged — the controller aggregation, ``slo_summary`` and the
Prometheus text all key by name, so the collision corrupts every
downstream percentile instead of failing anywhere visible. This check
makes it fail at ``make lint``.

Collected package-wide: constructor calls of ``Counter`` / ``Gauge`` /
``Histogram`` that resolve (via the module's imports) to
``ray_tpu_torch.util.metrics`` — ``collections.Counter`` and friends are not
confused — whose first argument is a literal string. The definition
signature is (kind, boundaries-literal); the first site wins and every
later disagreeing site is flagged.

**metrics-label-cardinality** — label VALUES must be bounded. A tag
like ``{"request": request_id}`` creates one registry series per
request: the series never merge (each key is unique), the per-process
snapshot grows until the ``metrics_max_series`` cap starts dropping
BOUNDED series, and every snapshot push carries the garbage. Flagged
at record call sites (``.inc/.set/.observe/.observe_many(...,
tags={...})`` and ``set_default_tags({...})``): any label-value
expression containing an id-shaped terminal name (``*_id``, ``oid``,
``uuid``, …) or an id-producing call (``.hex()``, ``uuid4()``). Label
values that are genuinely bounded ids (node ids: series die with the
node) carry a pragma with the justification.

**Flight-recorder events** go through the same two checks at
``flightrec.record("<name>", **attrs)`` sites (import-resolved to
``ray_tpu_torch.util.flightrec`` — any other ``record`` is never confused):
one event name, one ATTR-KEY SCHEMA (``doctor.post_mortem`` merges
events by name; a site recording the same name with different keys
silently breaks every grouping — flagged as metrics-name-collision),
and id-shaped attr values flagged as metrics-label-cardinality —
bounded schedule ints (``rules.FLIGHTREC_BOUNDED_ATTRS``: step, mb,
stage, epoch, …) are exempt, and genuinely-bounded subject ids (gang
ids die with the gang) carry the same justification pragma as metric
labels.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.analysis import rules
from ray_tpu_torch.analysis.core import Finding, Project, qualname_of

_METRIC_CLASSES = {"Counter", "Gauge", "Histogram"}
_METRICS_MODULE = "ray_tpu_torch.util.metrics"


def _metric_aliases(tree: ast.AST) -> Tuple[Dict[str, str], set]:
    """(direct aliases: local name -> metric class) and (module
    aliases: local names bound to ray_tpu_torch.util.metrics itself)."""
    direct: Dict[str, str] = {}
    mod_aliases: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.module == _METRICS_MODULE:
                for a in node.names:
                    if a.name in _METRIC_CLASSES:
                        direct[a.asname or a.name] = a.name
            elif node.module == "ray_tpu_torch.util":
                for a in node.names:
                    if a.name == "metrics":
                        mod_aliases.add(a.asname or "metrics")
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == _METRICS_MODULE:
                    mod_aliases.add(a.asname or "ray_tpu_torch")
    return direct, mod_aliases


def _resolve_metric_class(call: ast.Call, direct: Dict[str, str],
                          mod_aliases: set) -> Optional[str]:
    fn = call.func
    if isinstance(fn, ast.Name):
        return direct.get(fn.id)
    if (isinstance(fn, ast.Attribute) and fn.attr in _METRIC_CLASSES
            and isinstance(fn.value, ast.Name)
            and fn.value.id in mod_aliases):
        return fn.attr
    return None


def _boundaries_literal(call: ast.Call) -> Optional[str]:
    """Canonical text of the ``boundaries`` argument (kwarg or the
    Histogram signature's 3rd positional). None = registry default.
    Compared as AST dumps: a NON-literal expression only matches
    itself spelled identically, which is exactly the conservative
    behavior wanted (same constant name = same grid)."""
    for kw in call.keywords:
        if kw.arg == "boundaries":
            return ast.dump(kw.value)
    if len(call.args) >= 3:
        return ast.dump(call.args[2])
    return None


def _is_id_shaped(expr: ast.AST) -> Optional[str]:
    """The sub-expression that makes a label value unbounded, rendered
    for the message — or None when the value looks bounded."""
    for node in ast.walk(expr):
        if isinstance(node, ast.Call):
            fn = node.func
            name = (fn.attr if isinstance(fn, ast.Attribute)
                    else fn.id if isinstance(fn, ast.Name) else None)
            if name in rules.METRICS_ID_CALLS:
                return f"{name}() call"
        elif isinstance(node, (ast.Name, ast.Attribute)):
            term = node.id if isinstance(node, ast.Name) else node.attr
            if (term in rules.METRICS_ID_NAMES
                    or term.endswith(rules.METRICS_ID_SUFFIX)):
                return f"identifier {term!r}"
    return None


def _tags_dict(call: ast.Call, method: str) -> Optional[ast.Dict]:
    """The tags dict literal of a metric-record call, if present."""
    for kw in call.keywords:
        if kw.arg == "tags" and isinstance(kw.value, ast.Dict):
            return kw.value
    idx = 0 if method == "set_default_tags" else 1
    if len(call.args) > idx and isinstance(call.args[idx], ast.Dict):
        return call.args[idx]
    return None


def _check_cardinality(project: Project, emit_files=None) -> List[Finding]:
    findings: List[Finding] = []
    for f in sorted(project.files, key=lambda s: s.relpath):
        if emit_files is not None and f.relpath not in emit_files:
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
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr in rules.METRICS_RECORD_METHODS):
                return
            tags = _tags_dict(node, node.func.attr)
            if tags is None:
                return
            for key, value in zip(tags.keys, tags.values):
                if not (isinstance(key, ast.Constant)
                        and isinstance(key.value, str)):
                    continue  # **splat merges checked at their own site
                if isinstance(value, ast.Constant):
                    continue
                why = _is_id_shaped(value)
                if why is None:
                    continue
                findings.append(Finding(
                    rule=rules.METRICS_CARDINALITY, path=f.relpath,
                    line=node.lineno, symbol=qualname_of(stack),
                    message=(f"label {key.value!r} takes an id-shaped "
                             f"value ({why}): one registry series per "
                             f"id never merges and floods every "
                             f"snapshot push — use a bounded label "
                             f"(role/outcome/deployment) or pragma "
                             f"with the bound's justification")))

        visit(f.tree)
    return findings


def _flightrec_aliases(tree: ast.AST) -> Tuple[set, set]:
    """(direct names bound to flightrec.record) and (local names bound
    to the ray_tpu_torch.util.flightrec module itself)."""
    direct: set = set()
    mod_aliases: set = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            if node.module == rules.FLIGHTREC_MODULE:
                for a in node.names:
                    if a.name in rules.FLIGHTREC_RECORD_FUNCS:
                        direct.add(a.asname or a.name)
            elif node.module == "ray_tpu_torch.util":
                for a in node.names:
                    if a.name == "flightrec":
                        mod_aliases.add(a.asname or "flightrec")
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == rules.FLIGHTREC_MODULE:
                    mod_aliases.add(a.asname or "ray_tpu_torch")
    return direct, mod_aliases


def _is_flightrec_record(call: ast.Call, direct: set,
                         mod_aliases: set) -> bool:
    fn = call.func
    if isinstance(fn, ast.Name):
        return fn.id in direct
    return (isinstance(fn, ast.Attribute)
            and fn.attr in rules.FLIGHTREC_RECORD_FUNCS
            and isinstance(fn.value, ast.Name)
            and fn.value.id in mod_aliases)


def _check_flightrec(project: Project, emit_files=None) -> List[Finding]:
    """Flight-recorder event discipline: collect every literal-name
    ``record()`` site package-wide (schema = sorted attr keys; the
    first site wins), then flag schema collisions and id-shaped attr
    values — the family-#10 checks applied to the event catalog."""
    sites: Dict[str, List[dict]] = {}
    card: List[Finding] = []
    for f in sorted(project.files, key=lambda s: s.relpath):
        direct, mod_aliases = _flightrec_aliases(f.tree)
        if not direct and not mod_aliases:
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
            if not (isinstance(node, ast.Call)
                    and _is_flightrec_record(node, direct, mod_aliases)
                    and node.args):
                return
            name_arg = node.args[0]
            if not (isinstance(name_arg, ast.Constant)
                    and isinstance(name_arg.value, str)):
                return
            keys = tuple(sorted(kw.arg for kw in node.keywords
                                if kw.arg is not None))
            sites.setdefault(name_arg.value, []).append({
                "relpath": f.relpath, "line": node.lineno,
                "symbol": qualname_of(stack), "keys": keys})
            if emit_files is not None and f.relpath not in emit_files:
                return
            for kw in node.keywords:
                if (kw.arg is None
                        or kw.arg in rules.FLIGHTREC_BOUNDED_ATTRS
                        or isinstance(kw.value, ast.Constant)):
                    continue
                why = _is_id_shaped(kw.value)
                if why is None:
                    continue
                card.append(Finding(
                    rule=rules.METRICS_CARDINALITY, path=f.relpath,
                    line=node.lineno, symbol=qualname_of(stack),
                    message=(f"flight-recorder event "
                             f"{name_arg.value!r} attr {kw.arg!r} "
                             f"takes an id-shaped value ({why}): "
                             f"per-id events are a metric trying to "
                             f"be born — use a bounded attr, or "
                             f"pragma with the bound's justification "
                             f"(gang/pipeline ids die with their "
                             f"subject)")))

        visit(f.tree)

    findings: List[Finding] = []
    for name, regs in sites.items():
        first = regs[0]
        for site in regs[1:]:
            if site["keys"] == first["keys"]:
                continue
            if (emit_files is not None
                    and site["relpath"] not in emit_files):
                continue
            findings.append(Finding(
                rule=rules.METRICS_COLLISION, path=site["relpath"],
                line=site["line"], symbol=site["symbol"],
                message=(f"flight-recorder event {name!r} recorded "
                         f"with attr keys {list(site['keys'])} here "
                         f"but {list(first['keys'])} at "
                         f"{first['relpath']}:{first['line']} — one "
                         f"event name, one schema (the post-mortem "
                         f"merges events by name)")))
    findings.extend(card)
    return findings


def check_project(project: Project, emit_files=None) -> List[Finding]:
    # First pass: every literal-name registration in the package, in
    # deterministic file order, so "first site wins" is stable.
    sites: Dict[str, List[dict]] = {}
    for f in sorted(project.files, key=lambda s: s.relpath):
        direct, mod_aliases = _metric_aliases(f.tree)
        if not direct and not mod_aliases:
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
            if not isinstance(node, ast.Call):
                return
            cls = _resolve_metric_class(node, direct, mod_aliases)
            if cls is None or not node.args:
                return
            name_arg = node.args[0]
            if not (isinstance(name_arg, ast.Constant)
                    and isinstance(name_arg.value, str)):
                return
            sites.setdefault(name_arg.value, []).append({
                "relpath": f.relpath, "line": node.lineno,
                "symbol": qualname_of(stack), "cls": cls,
                "boundaries": (_boundaries_literal(node)
                               if cls == "Histogram" else None),
            })

        visit(f.tree)

    findings: List[Finding] = []
    for name, regs in sites.items():
        first = regs[0]
        for site in regs[1:]:
            if site["cls"] != first["cls"]:
                msg = (f"metric {name!r} registered as {site['cls']} "
                       f"here but as {first['cls']} at "
                       f"{first['relpath']}:{first['line']} — one name, "
                       f"one kind")
            elif (site["cls"] == "Histogram"
                  and site["boundaries"] != first["boundaries"]):
                msg = (f"histogram {name!r} registered with different "
                       f"bucket boundaries than "
                       f"{first['relpath']}:{first['line']} — entries "
                       f"with mismatched grids can never be merged")
            else:
                continue
            if (emit_files is not None
                    and site["relpath"] not in emit_files):
                continue
            findings.append(Finding(
                rule=rules.METRICS_COLLISION, path=site["relpath"],
                line=site["line"], symbol=site["symbol"], message=msg))
    findings.extend(_check_cardinality(project, emit_files))
    findings.extend(_check_flightrec(project, emit_files))
    return findings


def sites(project: Project) -> int:
    """Metric constructors and flight-recorder records, in the files
    that import either module."""
    n = 0
    for f in project.files:
        direct, mod_aliases = _metric_aliases(f.tree)
        fdirect, fmod = _flightrec_aliases(f.tree)
        if not (direct or mod_aliases or fdirect or fmod):
            continue
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            if _resolve_metric_class(node, direct, mod_aliases) \
                    is not None or _is_flightrec_record(node, fdirect, fmod):
                n += 1
    return n
