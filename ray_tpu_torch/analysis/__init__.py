"""graftlint: AST-based concurrency & trace-safety analysis for
ray_tpu_torch.

Fourteen checker families fitted to this codebase's real failure modes
(the README's analyzer section gives, for each family, what it reads in
the package and how many sites a full run visited):

=====================  ==================================================
rule                   catches
=====================  ==================================================
reactor-blocking-call  blocking calls reachable from core/rpc.py selector
                       callbacks (a wedged reactor stalls every peer)
trace-host-sync        .item()/.cpu()/np.asarray/torch.cuda.synchronize
                       inside torch.compile / torch.jit / a CUDA-graph
                       capture
trace-python-branch    Python if/while on traced tensors in those regions
trace-retrace-hazard   traced values in shape positions, set iteration
lock-order-cycle       lock-acquisition ordering cycles / self-deadlocks
lock-held-blocking     RPC sends, connects, sleeps under a held lock
swallowed-exception    ``except Exception: pass``
missing-finally-release  lock acquire/release in one function w/o finally
unguarded-field-access guarded-by inference: a field locked at a majority
                       of sites, accessed lock-free from 2+-thread code
resource-leak-path     a path (incl. exception edges) exiting a scope
                       with a socket/registration/slot/pin/topology
                       lease still live
rpc-unknown-method     .call("x")/.notify("x") with no registered handler
rpc-arity-mismatch     call arg shape no registration of the name accepts
rpc-dead-endpoint      handler registered but never called in-package
sharding-partitioned-contraction  a DECODE_RULES entry partitioning a
                       contraction dim at an einsum/matmul/``@`` site
                       (split reduction = bit-exactness broken)
sharding-missing-anchor  a row-parallel reduction (wo / w_down) whose
                       activation operand has no ``constrain`` or
                       ``gather_local`` anchor
sharding-unpinned-mesh-call  jit/device_put inside a mesh scope without
                       in_shardings/out_shardings (no such call in the
                       port: it reads the port's shard_map calls)
sharding-unscoped-trace  a sharded program (reaches ``constrain``)
                       jitted with sharding kwargs outside axis_rules
rpc-stub-drift         core/rpc_stubs.py stale vs the handler index
                       (regenerate with ``--gen-stubs``)
metrics-name-collision one metric name registered with two kinds or two
                       histogram grids (or one flight-recorder event
                       name with two attr schemas)
metrics-label-cardinality  id-shaped label / event attr values
checkpoint-missing-save  a checkpointed controller handler that returns
                       without reaching its save method
autopilot-unpaired-action  an autopilot action without its fence check
                       and audit record
fence-result-ignored   a fenced write (kv_put_fenced / epoch publish /
                       mh_group_put / pipe_step_complete) whose stale-
                       epoch verdict is discarded, incl. through
                       fence-carrier return chains
unfenced-mutation-in-fenced-class  raw kv_put / epoch-less publish
                       inside a class whose state is epoch-fenced
epoch-compare-direction  a stored-clock comparison whose direction
                       contradicts the table (equal-ok vs strict)
epoch-not-threaded     fenced publish whose dict payload lacks the
                       epoch/version key subscribers fence against
donation-unguarded-dispatch  a donate_argnums program dispatched
                       outside _dispatch_fresh (no donating program in
                       the port: reads no site)
donation-asarray-alias np.asarray over donated device state / dispatch
                       results (reads no site in the port)
donation-read-after-donate  a local read again after being passed in a
                       donated argument position (reads no site)
unbounded-blocking-call  Event.wait()/Queue.get()/join()/result()/socket
                       recv with no finite bound, reachable from any
                       thread entry point (RPC handlers, Thread/Timer
                       targets, executor submits — the silent hang)
rpc-call-no-timeout    control-plane .call("x")/stub sites without
                       timeout= (timeout=None parks forever)
deadline-not-propagated  a timeout_s/deadline parameter handed raw to
                       2+ blocking calls (or dropped) instead of a
                       util.deadline.Deadline remaining-time budget
retry-unbounded        while-True dial/RPC loops with no backoff,
                       attempt bound, or deadline (reconnect storm)
timeout-knob-dead      a *_timeout_s config knob no code ever reads
stale-pragma           a ``# graftlint:`` pragma suppressing nothing
                       (computed centrally on full runs)
=====================  ==================================================

Run it: ``python -m ray_tpu_torch.analysis [--strict] [--format json]
[--jobs N] [--diff REF] [--gen-stubs [PATH]] [--stats]
[--stats-json PATH]``.
Suppress a deliberate site with ``# graftlint: disable=<rule>`` (same
line or the line above) and a reason beside it; defer a triaged
finding via ``analysis/baseline.json`` (``--write-baseline``, then fill
in the ``reason``). The tier-1 gate (tests/test_torch_analysis.py)
fails on any unbaselined finding.

Pure stdlib ``ast`` — it imports neither torch nor jax nor the
``ray_tpu`` package, and reads only this package's own baseline.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

from ray_tpu_torch.analysis import rules
from ray_tpu_torch.analysis.core import (Baseline, Finding, Project,
                                   assign_fingerprints)

__all__ = ["run_analysis", "Finding", "Baseline", "Project",
           "DEFAULT_BASELINE", "repo_root"]

DEFAULT_BASELINE = os.path.join(os.path.dirname(__file__),
                                "baseline.json")

# Set in the parent before forking --jobs workers; children inherit the
# parsed project/graph via copy-on-write and ship only findings back.
_FORK_CTX: Dict[str, object] = {}


def repo_root() -> str:
    """The directory containing the ``ray_tpu_torch`` package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def _family_checks():
    """family name -> (needs_graph, check callable, sites callable).
    Every check takes (project_or_graph, emit_files=None): whole-program
    indexes are always built, but per-file emission work is skipped for
    files outside ``emit_files`` (the --diff fast path). ``sites`` counts
    what the family reads in the package (``--stats``)."""
    from ray_tpu_torch.analysis import (autopilot_lint, deadline_safety,
                                        donation_safety, fence_safety,
                                        guarded_by, lifecycle_hygiene,
                                        lifetime, lock_discipline,
                                        metrics_lint, reactor_safety,
                                        rpc_contract, sharding_safety,
                                        stubgen, trace_safety)

    return {
        "reactor-safety": (True, reactor_safety.check,
                           reactor_safety.sites),
        "trace-safety": (True, trace_safety.check, trace_safety.sites),
        "lock-discipline": (True, lock_discipline.check,
                            lock_discipline.sites),
        "lifecycle-hygiene": (False, lifecycle_hygiene.check_project,
                              lifecycle_hygiene.sites),
        "guarded-by": (True, guarded_by.check, guarded_by.sites),
        "lifetime": (True, lifetime.check, lifetime.sites),
        "rpc-contract": (True, rpc_contract.check, rpc_contract.sites),
        "sharding-safety": (True, sharding_safety.check,
                            sharding_safety.sites),
        "rpc-stubs": (True, stubgen.check, stubgen.sites),
        "metrics": (False, metrics_lint.check_project,
                    metrics_lint.sites),
        "autopilot": (False, autopilot_lint.check_project,
                      autopilot_lint.sites),
        "fence-safety": (True, fence_safety.check, fence_safety.sites),
        "donation-aliasing": (True, donation_safety.check,
                              donation_safety.sites),
        "deadline-safety": (True, deadline_safety.check,
                            deadline_safety.sites),
    }


def _stale_pragma_findings(project: Project,
                           raw: List[Finding]) -> List[Finding]:
    """One finding per ``# graftlint: disable=...`` comment that no
    longer suppresses anything: none of the rules it names has a raw
    finding on a line the pragma covers (its own line, plus the next
    code line for standalone comments). A pragma naming an unknown
    rule is stale by definition — it can never fire."""
    by_path: Dict[str, Dict[int, set]] = {}
    for f in raw:
        by_path.setdefault(f.path, {}).setdefault(
            f.line, set()).add(f.rule)
    known = set(rules.ALL_RULES)
    out: List[Finding] = []
    for sf in project.files:
        lines = by_path.get(sf.relpath, {})
        for row, names, covered in sf.pragma_sites:
            hit = False
            for cov in covered:
                found = lines.get(cov, set())
                if any((n == "all" and found)
                       or (n in known and n in found)
                       for n in names):
                    hit = True
                    break
            if hit:
                continue
            unknown = sorted(n for n in names
                             if n != "all" and n not in known)
            why = (f"names unknown rule(s) {', '.join(unknown)}"
                   if unknown else "suppresses no live finding")
            out.append(Finding(
                rule=rules.STALE_PRAGMA, path=sf.relpath, line=row,
                symbol="",
                message=f"pragma disable={','.join(sorted(names))} "
                        f"{why}; delete it (stale suppressions hide "
                        f"future regressions)"))
    return out


def _run_family(name: str) -> Tuple[str, List[Finding], float, int]:
    needs_graph, fn, count = _family_checks()[name]
    t = time.perf_counter()
    arg = _FORK_CTX["graph"] if needs_graph else _FORK_CTX["project"]
    out = fn(arg, emit_files=_FORK_CTX.get("emit_files"))
    return name, out, time.perf_counter() - t, count(arg)


def run_analysis(root: Optional[str] = None,
                 select: Optional[Iterable[str]] = None,
                 paths: Optional[Iterable[str]] = None,
                 jobs: int = 1,
                 emit_files: Optional[Iterable[str]] = None,
                 ) -> Tuple[List[Finding], Dict[str, float]]:
    """Run every (selected) checker over the package.

    Returns (findings, stats). Findings are pragma-filtered and carry
    fingerprints, but are NOT baseline-filtered — callers split against
    a Baseline themselves. ``paths`` restricts reported findings to
    files whose relpath starts with one of the given prefixes (the whole
    package is still parsed: the call graph needs it). ``jobs`` > 1
    forks that many workers and runs checker families in parallel
    (fork shares the parsed ASTs copy-on-write; falls back to serial
    where fork is unavailable). ``emit_files`` (exact relpaths — the
    --diff fast path) additionally skips per-file emission WORK inside
    the checkers; whole-program indexes still cover the package, so
    cross-file findings in the listed files stay sound.
    """
    from ray_tpu_torch.analysis.callgraph import CallGraph

    t0 = time.perf_counter()
    cpu0 = os.times()
    root = root or repo_root()
    project = Project.load(root)
    t_parse = time.perf_counter() - t0

    selected = set(select) if select else set(rules.ALL_RULES)
    families = [name for name, fam_rules in rules.FAMILIES.items()
                if selected & set(fam_rules)]
    findings: List[Finding] = []
    per_rule: Dict[str, float] = {}

    graph = None
    need_graph = any(_family_checks()[name][0] for name in families)
    if need_graph:
        t = time.perf_counter()
        graph = CallGraph(project)
        graph.edges()  # precompute once; forked workers share it COW
        per_rule["callgraph"] = time.perf_counter() - t

    _FORK_CTX["project"] = project
    _FORK_CTX["graph"] = graph
    _FORK_CTX["emit_files"] = set(emit_files) if emit_files else None
    try:
        if jobs > 1 and len(families) > 1 and hasattr(os, "fork"):
            import multiprocessing

            ctx = multiprocessing.get_context("fork")
            with ctx.Pool(min(jobs, len(families))) as pool:
                results = pool.map(_run_family, families)
        else:
            results = [_run_family(name) for name in families]
    finally:
        _FORK_CTX.clear()
    sites: Dict[str, int] = {}
    for name, fam_findings, dt, n_sites in results:
        findings += fam_findings
        per_rule[name] = dt
        sites[name] = n_sites

    findings = [f for f in findings if f.rule in selected]
    # Stale-pragma hygiene, computed centrally on FULL runs only (a
    # family-selected or path/diff-sliced run does not see every rule's
    # raw findings, so pragma liveness would read falsely stale there).
    # Uses pre-suppression findings: a pragma is live exactly when it
    # suppresses >= 1 finding some family would otherwise emit.
    stale: List[Finding] = []
    if select is None and paths is None and emit_files is None:
        stale = _stale_pragma_findings(project, findings)
    # per-rule counts BEFORE pragma suppression (the --stats-json
    # trajectory tracks total analyzer debt, suppressed or not)
    raw_counts: Dict[str, int] = {}
    for f in findings + stale:
        raw_counts[f.rule] = raw_counts.get(f.rule, 0) + 1
    if paths:
        prefixes = tuple(p.rstrip("/") for p in paths)
        findings = [f for f in findings
                    if any(f.path == p or f.path.startswith(p + "/")
                           or f.path.startswith(p)
                           for p in prefixes)]
    # pragma suppression (stale-pragma findings join afterwards: a
    # pragma must never be able to suppress its own staleness verdict)
    by_rel = {f.relpath: f for f in project.files}
    findings = [f for f in findings
                if not (f.path in by_rel
                        and by_rel[f.path].suppressed(f.rule, f.line))]
    findings += stale
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    assign_fingerprints(findings)

    cpu1 = os.times()
    stats = {"files": float(len(project.files)),
             "parse_s": t_parse,
             "total_s": time.perf_counter() - t0,
             # CPU seconds of this process and of the --jobs workers it
             # reaped: a budget that a loaded host's wall clock cannot
             # break
             "cpu_s": sum(cpu1[i] - cpu0[i] for i in range(4))}
    stats.update({f"{k}_s": v for k, v in per_rule.items()})
    stats.update({f"sites_{k}": float(v) for k, v in sites.items()})
    for rule, n in sorted(raw_counts.items()):
        stats[f"raw_{rule}"] = float(n)
    reported: Dict[str, int] = {}
    for f in findings:
        reported[f.rule] = reported.get(f.rule, 0) + 1
    for rule, n in sorted(reported.items()):
        stats[f"reported_{rule}"] = float(n)
    return findings, stats
