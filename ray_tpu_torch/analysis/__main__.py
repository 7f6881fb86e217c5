"""graftlint CLI: ``python -m ray_tpu_torch.analysis``.

Exit codes: 0 = clean (or non-strict), 1 = unbaselined findings with
``--strict``, 2 = bad usage. ``--write-baseline`` snapshots current
findings into analysis/baseline.json (reasons of surviving entries are
preserved; fill in new ones by hand — shipping ``TODO: triage`` reasons
is a review smell; the README's analyzer section lists the families).
"""

from __future__ import annotations

import argparse
import json
import sys

from ray_tpu_torch.analysis import (DEFAULT_BASELINE, Baseline, repo_root,
                              run_analysis)
from ray_tpu_torch.analysis import rules as _rules


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.analysis",
        description="graftlint: AST concurrency & trace-safety analysis")
    parser.add_argument("paths", nargs="*",
                        help="restrict findings to these repo-relative "
                             "path prefixes (default: whole package)")
    parser.add_argument("--root", default=None,
                        help="repo root (default: auto-detected)")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule subset")
    parser.add_argument("--list-rules", action="store_true")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--strict", action="store_true",
                        help="exit 1 on any unbaselined finding")
    parser.add_argument("--baseline", default=DEFAULT_BASELINE)
    parser.add_argument("--no-baseline", action="store_true",
                        help="report everything, ignoring the baseline")
    parser.add_argument("--write-baseline", action="store_true",
                        help="merge current findings into the baseline")
    parser.add_argument("--stats", action="store_true",
                        help="print per-checker timings and the sites "
                             "each family read")
    parser.add_argument("--stats-json", default=None, metavar="PATH",
                        help="write per-rule timing/finding-count JSON "
                             "artifact to PATH")
    parser.add_argument("--jobs", type=int, default=0, metavar="N",
                        help="fork N workers to run checker families in "
                             "parallel (0 = auto: one per family when "
                             "the platform supports fork)")
    parser.add_argument("--diff", default=None, metavar="REF",
                        help="only report findings in package files "
                             "changed vs this git ref (plus untracked "
                             "files); implies --jobs auto")
    parser.add_argument("--gen-stubs", nargs="?", const="", default=None,
                        metavar="PATH",
                        help="regenerate the typed RPC client stubs "
                             "from the handler index (default: "
                             "ray_tpu_torch/core/rpc_stubs.py) and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        for r in _rules.ALL_RULES:
            print(r)
        return 0

    select = None
    if args.rules:
        select = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in select if r not in _rules.ALL_RULES]
        if unknown:
            print(f"unknown rule(s): {', '.join(unknown)}",
                  file=sys.stderr)
            return 2

    root = args.root or repo_root()
    if args.gen_stubs is not None:
        return _gen_stubs(root, args.gen_stubs)
    paths = list(args.paths)
    emit_files = None
    if args.diff is not None:
        changed = _changed_package_files(root, args.diff)
        if changed is None:
            print(f"--diff: git diff against {args.diff!r} failed",
                  file=sys.stderr)
            return 2
        if not changed:
            print("graftlint: no package files changed "
                  f"vs {args.diff}; nothing to check")
            return 0
        emit_files = changed

    jobs = args.jobs
    if jobs <= 0:
        # auto: fork-parallel families when the box has the cores for
        # it; a single-core box runs serial (fork would only add
        # scheduler churn). --jobs 1 forces serial explicitly.
        import os as _os
        cores = _os.cpu_count() or 1
        jobs = min(len(_rules.FAMILIES), cores) \
            if hasattr(_os, "fork") else 1

    findings, stats = run_analysis(root=root, select=select,
                                   paths=paths or None, jobs=jobs,
                                   emit_files=emit_files)
    baseline = Baseline() if args.no_baseline \
        else Baseline.load(args.baseline)
    new, baselined, stale = baseline.split(findings)
    if args.diff is not None:
        # a diff run sees only a slice of the repo: absent findings say
        # nothing about baseline entries outside the slice
        stale = []

    if args.stats_json:
        _write_stats_json(args.stats_json, stats, new, baselined)

    if args.write_baseline:
        baseline.write(args.baseline, findings,
                       default_reason="TODO: triage")
        print(f"wrote {len(findings)} entries to {args.baseline}")
        return 0

    if args.format == "json":
        print(json.dumps({
            "findings": [f.to_json() for f in new],
            "baselined": len(baselined),
            "stale_baseline_entries": len(stale),
            "stats": stats}, indent=1))
    else:
        for f in new:
            print(f.render())
        counts = {}
        for f in new:
            counts[f.rule] = counts.get(f.rule, 0) + 1
        summary = ", ".join(f"{r}: {n}" for r, n in sorted(counts.items()))
        print(f"graftlint: {len(new)} finding(s)"
              + (f" [{summary}]" if summary else "")
              + f", {len(baselined)} baselined, "
              f"{len(stale)} stale baseline entr"
              f"{'y' if len(stale) == 1 else 'ies'}, "
              f"{int(stats['files'])} files in {stats['total_s']:.2f}s")
        if stale and args.strict:
            for e in stale:
                print(f"  stale baseline: {e.get('path')}:"
                      f"{e.get('line')} [{e.get('rule')}] "
                      f"{e.get('symbol')}")
        if args.stats:
            for k, v in stats.items():
                if k.endswith("_s"):
                    print(f"  {k[:-2]:>20}: {v * 1e3:7.1f} ms")
            for k, v in stats.items():
                if k.startswith("sites_"):
                    print(f"  {k[6:]:>20}: {int(v):7d} sites")

    if args.strict and (new or stale):
        return 1
    return 0


def _gen_stubs(root, out_path):
    """Regenerate ray_tpu_torch/core/rpc_stubs.py from the handler index."""
    import os

    from ray_tpu_torch.analysis import Project
    from ray_tpu_torch.analysis import rules as r
    from ray_tpu_torch.analysis import stubgen
    from ray_tpu_torch.analysis.callgraph import CallGraph

    project = Project.load(root)
    graph = CallGraph(project)
    src = stubgen.generate(graph)
    path = out_path or os.path.join(root, r.RPC_STUBS_PATH)
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(src)
    print(f"wrote {path} ({len(src.splitlines())} lines)")
    return 0


def _changed_package_files(root, ref):
    """Package .py files changed vs ``ref`` (plus untracked), or None on
    git failure."""
    import subprocess

    try:
        diff = subprocess.run(
            ["git", "diff", "--name-only", ref, "--"],
            capture_output=True, text=True, cwd=root, timeout=30)
        if diff.returncode != 0:
            return None
        untracked = subprocess.run(
            ["git", "ls-files", "--others", "--exclude-standard"],
            capture_output=True, text=True, cwd=root, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    names = diff.stdout.splitlines()
    if untracked.returncode == 0:
        names += untracked.stdout.splitlines()
    return sorted({n for n in names
                   if n.endswith(".py") and n.startswith("ray_tpu_torch/")})


def _write_stats_json(path, stats, new, baselined):
    """Per-rule JSON artifact: timings, raw/reported finding counts,
    and the number of pragma-suppressed sites per rule (raw - reported)
    — the analyzer-debt trajectory — and the sites each family read."""
    from ray_tpu_torch.analysis import rules as r

    per_rule = {}
    for rule in r.ALL_RULES:
        raw = int(stats.get(f"raw_{rule}", 0.0))
        reported = int(stats.get(f"reported_{rule}", 0.0))
        per_rule[rule] = {
            "raw": raw,
            "pragma_suppressed": raw - reported,
            "reported_unbaselined": sum(1 for f in new if f.rule == rule),
            "baselined": sum(1 for f in baselined if f.rule == rule),
        }
    artifact = {
        "files": int(stats.get("files", 0.0)),
        "total_s": round(stats.get("total_s", 0.0), 3),
        "cpu_s": round(stats.get("cpu_s", 0.0), 3),
        "sites": {k[6:]: int(v) for k, v in stats.items()
                  if k.startswith("sites_")},
        "timings_s": {k[:-2]: round(v, 4) for k, v in stats.items()
                      if k.endswith("_s") and k != "cpu_s"},
        "rules": per_rule,
    }
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(artifact, fh, indent=1, sort_keys=True)
        fh.write("\n")


if __name__ == "__main__":
    sys.exit(main())
