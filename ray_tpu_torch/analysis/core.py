"""graftlint core: findings, pragma suppression, project loading, baseline.

The analyzer is pure-AST (stdlib ``ast`` + ``tokenize`` only): it never
imports the modules it checks, so it runs in milliseconds, needs no jax,
and is safe to run on code that would crash on import. Everything here is
shared by the four checkers (reactor-safety, trace-safety, lock-discipline,
lifecycle-hygiene — see the sibling modules).

Suppression model, outermost to innermost:

* ``analysis/baseline.json`` — triaged-but-deferred findings, matched by a
  line-number-independent fingerprint (rule | path | enclosing symbol |
  occurrence index within that symbol) so unrelated edits don't churn it.
* ``# graftlint: disable=<rule>[,<rule>...]`` pragma comments — on the
  flagged line, or standing alone on the line above a statement. ``all``
  disables every rule for that line. Pragmas are for *deliberate* code
  ("this lock exists to serialize this blocking send"); the baseline is
  for debt.
"""

from __future__ import annotations

import ast
import hashlib
import io
import json
import re
import tokenize
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

PRAGMA_RE = re.compile(r"#\s*graftlint:\s*disable=([A-Za-z0-9_,\- ]+)")


@dataclass
class Finding:
    rule: str
    path: str        # repo-relative posix path
    line: int
    symbol: str      # enclosing function qualname, or "<module>"
    message: str
    fingerprint: str = ""

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.symbol}: " \
               f"{self.message}"

    def to_json(self) -> Dict[str, object]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "symbol": self.symbol, "message": self.message,
                "fingerprint": self.fingerprint}


class SourceFile:
    """One parsed module: AST, dotted module name, pragma map."""

    def __init__(self, abspath: str, relpath: str, text: str):
        self.abspath = abspath
        self.relpath = relpath.replace("\\", "/")
        self.text = text
        self.tree = ast.parse(text, filename=relpath)
        mod = self.relpath[:-3] if self.relpath.endswith(".py") else \
            self.relpath
        if mod.endswith("/__init__"):
            mod = mod[: -len("/__init__")]
        self.module = mod.replace("/", ".")
        # line -> set of disabled rule names ("all" disables everything)
        self.pragmas, self.pragma_sites = _extract_pragmas(text)

    def suppressed(self, rule: str, line: int) -> bool:
        rules = self.pragmas.get(line)
        return bool(rules) and ("all" in rules or rule in rules)


def _extract_pragmas(text: str) -> Tuple[Dict[int, Set[str]],
                                         List[Tuple[int, frozenset,
                                                    Tuple[int, ...]]]]:
    """-> (line -> disabled rules, pragma sites). A site is ONE pragma
    comment: (its own row, the rules it names, the code rows it covers
    — its row plus, for standalone comments, the next code row). Sites
    feed the stale-pragma liveness check: a pragma none of whose
    covered rows carries a live finding of a named rule is dead weight
    and fails strict."""
    out: Dict[int, Set[str]] = {}
    sites: List[Tuple[int, frozenset, Tuple[int, ...]]] = []
    standalone: List[Tuple[int, Set[str]]] = []
    code_rows: Set[int] = set()
    # Fast path: tokenizing every file dominates parse time, and most
    # files carry no pragma at all — a substring probe is enough to skip
    # them (a false hit here just pays the tokenize).
    if "graftlint" not in text:
        return out, sites
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(text).readline))
    except tokenize.TokenError:
        return out, sites
    for tok in tokens:
        if tok.type == tokenize.COMMENT:
            m = PRAGMA_RE.search(tok.string)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            row = tok.start[0]
            out.setdefault(row, set()).update(rules)
            if tok.line[: tok.start[1]].strip() == "":
                standalone.append((row, rules))
            else:
                sites.append((row, frozenset(rules), (row,)))
        elif tok.type not in (tokenize.NL, tokenize.NEWLINE,
                              tokenize.INDENT, tokenize.DEDENT,
                              tokenize.ENDMARKER):
            code_rows.add(tok.start[0])
    # A pragma on its own line also covers the next code line, so long
    # statements don't need the comment crammed onto them.
    for row, rules in standalone:
        nxt = min((r for r in code_rows if r > row), default=None)
        if nxt is not None:
            out.setdefault(nxt, set()).update(rules)
        sites.append((row, frozenset(rules),
                      (row,) if nxt is None else (row, nxt)))
    return out, sites


class Project:
    """All package sources under a root, parsed once and shared."""

    def __init__(self, root: str, files: List[SourceFile]):
        self.root = root
        self.files = sorted(files, key=lambda f: f.relpath)
        self.by_module: Dict[str, SourceFile] = {
            f.module: f for f in self.files}

    @classmethod
    def load(cls, root: str, package: str = "ray_tpu_torch",
             exclude: Iterable[str] = ()) -> "Project":
        import os

        files: List[SourceFile] = []
        pkg_dir = os.path.join(root, package)
        excl = tuple(exclude)
        for dirpath, dirnames, filenames in os.walk(pkg_dir):
            dirnames[:] = [d for d in dirnames
                           if d != "__pycache__" and not d.startswith(".")]
            for name in sorted(filenames):
                if not name.endswith(".py"):
                    continue
                abspath = os.path.join(dirpath, name)
                relpath = os.path.relpath(abspath, root)
                rp = relpath.replace("\\", "/")
                if any(rp.startswith(e) for e in excl):
                    continue
                try:
                    with open(abspath, "r", encoding="utf-8") as fh:
                        text = fh.read()
                    files.append(SourceFile(abspath, relpath, text))
                except (SyntaxError, UnicodeDecodeError, OSError):
                    # Unparseable files are a job for the test suite, not
                    # the linter; skip rather than crash the whole run.
                    continue
        return cls(root, files)


def qualname_of(stack: List[ast.AST]) -> str:
    """Dotted qualname for the innermost function in a nesting stack."""
    parts = [n.name for n in stack
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.ClassDef))]
    return ".".join(parts) if parts else "<module>"


def assign_fingerprints(findings: List[Finding]) -> None:
    """Stable IDs: occurrence index within (rule, path, symbol), so line
    drift from unrelated edits does not invalidate baseline entries."""
    groups: Dict[Tuple[str, str, str], List[Finding]] = {}
    for f in findings:
        groups.setdefault((f.rule, f.path, f.symbol), []).append(f)
    for (rule, path, symbol), group in groups.items():
        group.sort(key=lambda f: f.line)
        for occ, f in enumerate(group):
            raw = f"{rule}|{path}|{symbol}|{occ}"
            f.fingerprint = hashlib.sha1(raw.encode()).hexdigest()[:16]


@dataclass
class Baseline:
    entries: Dict[str, Dict[str, object]] = field(default_factory=dict)

    @classmethod
    def load(cls, path: str) -> "Baseline":
        try:
            with open(path, "r", encoding="utf-8") as fh:
                data = json.load(fh)
        except (OSError, ValueError):
            return cls()
        entries = {e["fingerprint"]: e
                   for e in data.get("entries", [])
                   if isinstance(e, dict) and "fingerprint" in e}
        return cls(entries)

    def split(self, findings: List[Finding]
              ) -> Tuple[List[Finding], List[Finding], List[Dict]]:
        """-> (new, baselined, stale-entries)."""
        new: List[Finding] = []
        hit: Set[str] = set()
        baselined: List[Finding] = []
        for f in findings:
            if f.fingerprint in self.entries:
                baselined.append(f)
                hit.add(f.fingerprint)
            else:
                new.append(f)
        stale = [e for fp, e in self.entries.items() if fp not in hit]
        return new, baselined, stale

    def write(self, path: str, findings: List[Finding],
              default_reason: str = "TODO: triage") -> None:
        """Merge current findings into the baseline, keeping the reasons
        of entries that still match."""
        merged = []
        for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
            old = self.entries.get(f.fingerprint, {})
            merged.append({
                "fingerprint": f.fingerprint, "rule": f.rule,
                "path": f.path, "line": f.line, "symbol": f.symbol,
                "message": f.message,
                "reason": old.get("reason", default_reason)})
        with open(path, "w", encoding="utf-8") as fh:
            json.dump({"version": 1, "entries": merged}, fh, indent=1)
            fh.write("\n")
