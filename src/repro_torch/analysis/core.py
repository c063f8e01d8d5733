"""Finding/reporting core shared by every ``repro_torch.analysis`` rule
family: a copy of ``repro/analysis/core.py``.

The analyzer turns the port's prose invariants ("no new compiled variant
through mutations", "in-place scatters", "apply_updates under the
backend lock") into machine-checked findings.  This module owns the
pieces every rule family shares:

* :class:`Finding` -- one violation: rule id, location, message;
* inline suppressions -- ``# repro: allow(<rule>): <justification>`` on
  the offending line (or the line directly above it).  A suppression
  **must** carry a justification; a bare ``allow`` is itself reported
  (``bad-suppression``), and a suppression that never matches a finding
  is reported too (``unused-suppression``) so stale waivers can't
  accumulate;
* file walking + the runner of the static rule families, which
  reconciles findings against suppressions.

The static passes are pure-AST -- they import neither torch nor the code
they read -- so the lint stays fast and runs anywhere.  The dynamic
recompile gate (:mod:`repro_torch.analysis.recompile`) is layered on top
by the CLI.  Waivers read the same in both trees.
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Iterable, Optional

__all__ = [
    "Finding", "Suppression", "collect_suppressions", "iter_py_files",
    "run_static_analysis", "STATIC_RULES",
]

# one catalog for --list-rules and the README; checkers register
# their ids here so an unknown id in an allow() is caught early
STATIC_RULES: dict[str, str] = {
    "bad-suppression":
        "a `# repro: allow(...)` without a one-line justification",
    "unknown-rule":
        "a suppression names a rule id the analyzer does not define",
    "unused-suppression":
        "a suppression that matched no finding (stale waiver)",
    "parse-error": "a file the analyzer could not read or parse",
    # dynamic (recompile-gate) rule ids, reported via --strict:
    "recompile":
        "a registered entry point's compiled variants changed across "
        "mutation-perturbed shapes",
    "entry-point-error":
        "a registered recompile-gate entry point failed to run",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at a source location."""

    rule: str
    path: str
    line: int
    col: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: " \
               f"{self.message}"


@dataclasses.dataclass
class Suppression:
    """One inline ``# repro: allow(rule[, rule...]): justification``."""

    path: str
    line: int               # line the comment sits on
    rules: tuple
    justification: str
    used: bool = False

    def covers(self, finding: Finding) -> bool:
        """A suppression covers findings on its own line and on the line
        directly below it (the standalone-comment-above idiom)."""
        return (finding.path == self.path
                and finding.rule in self.rules
                and finding.line in (self.line, self.line + 1))


_ALLOW_RE = re.compile(
    r"#\s*repro:\s*allow\(\s*([\w\-, ]+?)\s*\)\s*[:—-]?\s*(.*)$")


def collect_suppressions(path: str, source: str) -> list[Suppression]:
    out = []
    for i, line in enumerate(source.splitlines(), start=1):
        m = _ALLOW_RE.search(line)
        if m:
            rules = tuple(r.strip() for r in m.group(1).split(",")
                          if r.strip())
            out.append(Suppression(path=path, line=i, rules=rules,
                                   justification=m.group(2).strip()))
    return out


def iter_py_files(paths: Iterable[str]) -> list[str]:
    files = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
        else:
            for root, dirs, names in os.walk(p):
                dirs[:] = [d for d in dirs
                           if d not in ("__pycache__", ".git")]
                files.extend(os.path.join(root, n)
                             for n in sorted(names) if n.endswith(".py"))
    return sorted(files)


def _suppression_findings(sups: list[Suppression],
                          known_rules: set) -> list[Finding]:
    out = []
    for s in sups:
        if not s.justification:
            out.append(Finding(
                "bad-suppression", s.path, s.line, 1,
                f"allow({', '.join(s.rules)}) carries no justification -- "
                "say why the violation is acceptable"))
        for r in s.rules:
            if r not in known_rules:
                out.append(Finding(
                    "unknown-rule", s.path, s.line, 1,
                    f"allow({r}) names an unknown rule id"))
    return out


def run_static_analysis(
    paths: Iterable[str],
    *,
    rules: Optional[set] = None,
    extra_findings: Iterable[Finding] = (),
    flag_unused: bool = True,
) -> tuple[list[Finding], list[Finding]]:
    """Run the static rule families over ``paths``.

    Returns ``(active, suppressed)`` findings.  ``extra_findings`` lets
    the CLI merge dynamic (recompile-gate) findings into the same
    suppression reconciliation.  ``rules`` restricts which rule ids are
    reported (suppression hygiene rules always run).
    """
    from repro_torch.analysis.locks import check_module as check_locks
    from repro_torch.analysis.torchlint import check_module as check_torch

    known = set(STATIC_RULES)
    findings: list[Finding] = list(extra_findings)
    suppressions: list[Suppression] = []
    for path in iter_py_files(paths):
        try:
            source = open(path, encoding="utf-8").read()
            tree = ast.parse(source, filename=path)
        except (OSError, SyntaxError) as e:
            findings.append(Finding("parse-error", path, 1, 1, str(e)))
            continue
        sups = collect_suppressions(path, source)
        suppressions.extend(sups)
        findings.extend(_suppression_findings(sups, known))
        findings.extend(check_torch(path, tree))
        findings.extend(check_locks(path, tree))

    if rules is not None:
        hygiene = {"bad-suppression", "unknown-rule", "unused-suppression",
                   "parse-error"}
        findings = [f for f in findings
                    if f.rule in rules or f.rule in hygiene]

    active, suppressed = [], []
    for f in findings:
        hit = next((s for s in suppressions if s.covers(f)), None)
        if hit is None:
            active.append(f)
        else:
            hit.used = True
            suppressed.append(f)
    if flag_unused:
        for s in suppressions:
            if not s.used:
                active.append(Finding(
                    "unused-suppression", s.path, s.line, 1,
                    f"allow({', '.join(s.rules)}) matched no finding -- "
                    "drop the stale waiver"))
    active.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return active, suppressed
