"""CLI: ``python -m repro_torch.analysis [paths...] [--strict]
[--rules ...] [--list-rules] [--device cpu|cuda]``.

Exit code 0 when no unsuppressed finding remains, 1 otherwise.  Without
``--strict`` only the pure-AST passes run (sub-second, no torch import);
``--strict`` adds the recompile gate over the registered entry points,
which builds real backends on ``--device`` (the card when none is
named).
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="compile-path & concurrency lint for the port")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files/directories to analyze "
                         "(default: src/repro_torch)")
    ap.add_argument("--strict", action="store_true",
                    help="also run the recompile-stability gate (builds "
                         "real backends on --device)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids to report "
                         "(suppression-hygiene rules always run)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--device", default=None,
                    help="device of the --strict gate's backends "
                         "(default: the card)")
    args = ap.parse_args(argv)

    # importing the checkers populates the full rule catalog
    from repro_torch.analysis import core
    from repro_torch.analysis import locks, torchlint  # noqa: F401

    if args.list_rules:
        width = max(len(r) for r in
                    list(core.STATIC_RULES) + list(torchlint.NO_COUNTERPART))
        for rid in sorted(core.STATIC_RULES):
            print(f"{rid:<{width}}  {core.STATIC_RULES[rid]}")
        for rid, why in sorted(torchlint.NO_COUNTERPART.items()):
            print(f"{rid:<{width}}  (reference only, no port rule) {why}")
        return 0

    extra = []
    if args.strict:
        from repro_torch.analysis.recompile import run_recompile_gate

        extra = run_recompile_gate(device=args.device)

    rules = (set(r.strip() for r in args.rules.split(",") if r.strip())
             if args.rules else None)
    active, suppressed = core.run_static_analysis(
        args.paths, rules=rules, extra_findings=extra)
    for f in active:
        print(f.format())
    print(f"{len(active)} finding(s), {len(suppressed)} suppressed"
          + (" [strict]" if args.strict else ""),
          file=sys.stderr)
    return 1 if active else 0


if __name__ == "__main__":
    raise SystemExit(main())
