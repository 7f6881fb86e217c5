"""The port's analyzer against the JAX package's, fixture by fixture.

Every fixture project the reference analysis tests build
(``tests/test_analysis*.py``: ``project_of`` / ``project_at`` /
``shard_project`` / ``_sf`` calls whose sources are string literals,
harvested from their ASTs) runs through every family of both analyzers:
the JAX one on ``ray_tpu/<m>.py``, the port's on ``ray_tpu_torch/<m>.py``
with the package name mapped in the source. The two must report the
same ``(rule, line)`` set with the same messages, modulo the package
name. The trace family is the exception: its scopes are the port's
compiled and captured regions, so its cases run on line-aligned pairs,
a ``jax.jit`` spelling against a ``torch.compile`` / ``torch.jit`` /
CUDA-graph one, compared on ``(rule, line)``.
"""

import ast
import re
import textwrap
from pathlib import Path

import pytest

import ray_tpu.analysis as ref_analysis
import ray_tpu_torch.analysis as port_analysis
from ray_tpu.analysis import callgraph as ref_callgraph
from ray_tpu.analysis import core as ref_core
from ray_tpu_torch.analysis import callgraph as port_callgraph
from ray_tpu_torch.analysis import core as port_core
from ray_tpu_torch.analysis import rules

TESTS = Path(__file__).resolve().parent
REFERENCE_FILES = ["test_analysis.py", "test_analysis_v2.py",
                   "test_analysis_v3.py", "test_analysis_v4.py",
                   "test_analysis_v5.py"]
TRACE_RULES = {rules.TRACE_HOST_SYNC, rules.TRACE_PY_BRANCH,
               rules.TRACE_RETRACE}


# ------------------------------------------------------------- harvest

def _constants(tree: ast.Module) -> dict:
    """Module-level ``NAME = <expr>`` bindings (evaluated lazily)."""
    return {node.targets[0].id: node.value for node in tree.body
            if isinstance(node, ast.Assign) and len(node.targets) == 1
            and isinstance(node.targets[0], ast.Name)}


def _text(expr, consts: dict, local: dict, depth: int = 0):
    """The string a fixture expression builds from literals: constants,
    names bound to them, ``+`` and ``.replace`` with literal
    arguments. None when it cannot be read statically."""
    if depth > 8 or expr is None:
        return None
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value
    if isinstance(expr, ast.Name):
        bound = local.get(expr.id, consts.get(expr.id))
        return _text(bound, consts, local, depth + 1)
    if isinstance(expr, ast.BinOp) and isinstance(expr.op, ast.Add):
        left = _text(expr.left, consts, local, depth + 1)
        right = _text(expr.right, consts, local, depth + 1)
        return None if left is None or right is None else left + right
    if isinstance(expr, ast.Call) and isinstance(expr.func, ast.Attribute) \
            and expr.func.attr == "replace" and len(expr.args) == 2 \
            and not expr.keywords:
        base = _text(expr.func.value, consts, local, depth + 1)
        old, new = (_text(a, consts, local, depth + 1) for a in expr.args)
        if None in (base, old, new):
            return None
        return base.replace(old, new)
    return None


def _locals_before(fn: ast.AST, line: int) -> dict:
    """Local name -> the expression last bound to it before ``line``."""
    rows = sorted(
        [(node.lineno, node.targets[0].id, node.value)
         for node in ast.walk(fn)
         if isinstance(node, ast.Assign) and len(node.targets) == 1
         and isinstance(node.targets[0], ast.Name) and node.lineno < line],
        key=lambda row: row[0])
    return {name: value for _ln, name, value in rows}


def _dict_of(expr, consts: dict, local: dict):
    if isinstance(expr, ast.Name):
        expr = local.get(expr.id, consts.get(expr.id))
    return expr if isinstance(expr, ast.Dict) else None


def _project_of_call(call: ast.Call, consts: dict, local: dict):
    """{subpath: source} for one fixture-building call, or None."""
    name = getattr(call.func, "id", None)
    mods = {}
    if name == "project_of" and call.keywords:
        for kw in call.keywords:
            src = _text(kw.value, consts, local)
            if kw.arg is None or src is None:
                return None
            mods[kw.arg] = src
    elif name == "project_at" and call.args \
            and _dict_of(call.args[0], consts, local) is not None:
        table = _dict_of(call.args[0], consts, local)
        for k, v in zip(table.keys, table.values):
            src = _text(v, consts, local)
            if not isinstance(k, ast.Constant) or src is None:
                return None
            mods[k.value] = src
    elif name == "shard_project":
        rules_src = _text(consts.get("SHARD_RULES"), consts, local)
        extra = None
        args = list(call.args)
        for kw in call.keywords:
            if kw.arg == "rules_src":
                args[:1] = [kw.value]
            elif kw.arg == "extra":
                extra = kw.value
        if args:
            rules_src = _text(args[0], consts, local)
        model = _text(consts.get("SHARD_MODEL"), consts, local)
        if rules_src is None or model is None:
            return None
        mods = {"parallel/sharding": rules_src, "models/llama": model}
        if extra is not None:
            if not isinstance(extra, ast.Dict):
                return None
            for k, v in zip(extra.keys, extra.values):
                src = _text(v, consts, local)
                if not isinstance(k, ast.Constant) or src is None:
                    return None
                mods[k.value] = src
    elif name == "_sf" and len(call.args) == 2:
        rel = _text(call.args[0], consts, local)
        src = _text(call.args[1], consts, local)
        if rel is None or src is None or not rel.startswith("ray_tpu/"):
            return None
        mods[rel[len("ray_tpu/"):-len(".py")]] = src
    else:
        return None
    return mods


def _harvest():
    """(label, {subpath: source}) for every fixture project a test
    function of the reference files builds from literal sources."""
    cases = {}
    for fname in REFERENCE_FILES:
        tree = ast.parse((TESTS / fname).read_text())
        consts = _constants(tree)
        for fn in tree.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            for call in ast.walk(fn):
                if not isinstance(call, ast.Call):
                    continue
                mods = _project_of_call(
                    call, consts, _locals_before(fn, call.lineno))
                if mods:
                    cases.setdefault(tuple(sorted(mods.items())),
                                     f"{fname[:-3]}:{fn.name}:{call.lineno}")
    return sorted(((label, dict(key)) for key, label in cases.items()),
                  key=lambda c: c[0])


CASES = _harvest()


def test_harvest_reads_the_reference_fixtures():
    """The harvest finds the reference files' fixture projects (a
    shrinking harvest would hollow out the comparison below)."""
    assert len(CASES) >= 80, len(CASES)
    files = {label.split(":")[0] for label, _ in CASES}
    assert files == {f[:-3] for f in REFERENCE_FILES}


# ---------------------------------------------------------- both runs

def _run(analysis, core, callgraph, pkg: str, mods: dict):
    files = []
    for sub, src in mods.items():
        rel = f"{pkg}/{sub}.py"
        text = textwrap.dedent(src)
        if pkg == "ray_tpu_torch":
            text = re.sub(r"\bray_tpu\b", "ray_tpu_torch", text)
        files.append(core.SourceFile(f"/fixture/{rel}", rel, text))
    project = core.Project("/fixture", files)
    graph = callgraph.CallGraph(project)
    found = []
    for entry in analysis._family_checks().values():
        needs_graph, check = entry[0], entry[1]
        found += check(graph if needs_graph else project)
    by_rel = {f.relpath: f for f in project.files}
    return {(f.rule, f.path.split("/", 1)[1], f.line,
             _normalized(f.message))
            for f in found
            if not (f.path in by_rel
                    and by_rel[f.path].suppressed(f.rule, f.line))}


def _normalized(message: str) -> str:
    message = re.sub(r"\bray_tpu_torch\b", "ray_tpu", message)
    return re.sub(r"\bPR \d+ ", "", message)


def _both(mods: dict):
    try:
        want = _run(ref_analysis, ref_core, ref_callgraph, "ray_tpu", mods)
    except SyntaxError:
        pytest.skip("fixture text is not a module on its own")
    got = _run(port_analysis, port_core, port_callgraph, "ray_tpu_torch",
               mods)
    return want, got


@pytest.mark.parametrize("label,mods", CASES, ids=[c[0] for c in CASES])
def test_port_analyzer_matches_reference_on_fixture(label, mods):
    want, got = _both(mods)
    want = {f for f in want if f[0] not in TRACE_RULES}
    got = {f for f in got if f[0] not in TRACE_RULES}
    assert got == want


# ------------------------------------------------ the trace family pairs

# (jax spelling, torch spelling): line-aligned, so the findings of one
# are the findings of the other, line for line.
TRACE_PAIRS = {
    "decorated": ("""
        import jax
        import jax.numpy as jnp

        @jax.jit
        def host_sync(x):
            return x.item()

        @jax.jit
        def tracer_branch(x):
            if x > 0:
                return x
            return -x

        @jax.jit
        def shape_retrace(n):
            return jnp.zeros(n)

        @jax.jit
        def set_iter(x):
            acc = x
            for k in {"a", "b"}:
                acc = acc + 1
            return acc
    """, """
        import torch
        import torch.nn.functional as F

        @torch.compile
        def host_sync(x):
            return x.item()

        @torch.compile(fullgraph=True)
        def tracer_branch(x):
            if x > 0:
                return x
            return -x

        @torch.jit.script
        def shape_retrace(n):
            return torch.zeros(n)

        @torch.compile
        def set_iter(x):
            acc = x
            for k in {"a", "b"}:
                acc = acc + 1
            return acc
    """),
    "static_and_unmarked": ("""
        import functools
        import jax
        import jax.numpy as jnp

        @jax.jit
        def static_shape_ok(x):
            n = x.shape[0]
            if x.shape[0] > 2:
                pass
            return jnp.zeros(n)

        @functools.partial(jax.jit, static_argnums=(1,))
        def static_argnum_ok(x, n):
            if n > 4:
                return jnp.zeros(n)
            return jnp.zeros((2, n))

        def not_jitted(x):
            return x.item()
    """, """
        import functools
        import torch
        import torch.nn.functional as F

        @torch.compile
        def static_shape_ok(x):
            n = x.shape[0]
            if x.shape[0] > 2:
                pass
            return torch.zeros(n)

        @torch.compile
        def static_argnum_ok(x, n: int):
            if n > 4:
                return torch.zeros(n)
            return torch.zeros((2, n))

        def not_jitted(x):
            return x.item()
    """),
    "wrapped_and_called": ("""
        import jax
        import numpy as np

        def helper(x):
            return x.item()

        def step(x):
            y = helper(x)
            if x:
                return np.asarray(x)
            return float(x)

        def build():
            return jax.jit(step)
    """, """
        import torch
        import numpy as np

        def helper(x):
            return x.item()

        def step(x):
            y = helper(x)
            if x:
                return np.asarray(x)
            return float(x)

        def build():
            return torch.compile(step)
    """),
    "captured": ("""
        import jax

        def helper(x):
            return x.tolist()

        def body(x):
            return helper(x)

        def wire(x):
            return jax.jit(body)(x)
    """, """
        import torch

        def helper(x):
            return x.tolist()

        def body(x):
            return helper(x)

        def wire(g, x):
            with torch.cuda.graph(g): return body(x)
    """),
}


@pytest.mark.parametrize("name", sorted(TRACE_PAIRS))
def test_trace_family_matches_reference_on_torch_spelling(name):
    jax_src, torch_src = TRACE_PAIRS[name]
    assert len(textwrap.dedent(jax_src).splitlines()) == \
        len(textwrap.dedent(torch_src).splitlines())
    want = _run(ref_analysis, ref_core, ref_callgraph, "ray_tpu",
                {"mod": jax_src})
    got = _run(port_analysis, port_core, port_callgraph, "ray_tpu_torch",
               {"mod": torch_src})
    want = {(r, ln) for r, _p, ln, _m in want if r in TRACE_RULES}
    got = {(r, ln) for r, _p, ln, _m in got if r in TRACE_RULES}
    assert bool(want) == (name != "static_and_unmarked"), want
    assert got == want


def test_port_rules_are_the_reference_rules():
    """Every rule of the JAX package's ``ALL_RULES`` has its counterpart
    (the same id, in the same family) in the port's tables."""
    from ray_tpu.analysis import rules as ref_rules

    assert rules.ALL_RULES == ref_rules.ALL_RULES
    assert rules.FAMILIES == ref_rules.FAMILIES
    assert set(port_analysis._family_checks()) == set(rules.FAMILIES)


def test_port_baseline_holds_only_triaged_entries():
    """The port's own baseline (never the JAX package's) carries a real
    reason on every entry."""
    baseline = port_core.Baseline.load(port_analysis.DEFAULT_BASELINE)
    assert Path(port_analysis.DEFAULT_BASELINE).parent == \
        Path(port_analysis.__file__).parent
    for entry in baseline.entries.values():
        reason = entry.get("reason", "")
        assert reason and "TODO" not in reason, entry
