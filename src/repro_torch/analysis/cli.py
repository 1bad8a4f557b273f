"""Command-line front end: ``python -m repro_torch.analysis [paths]
[--strict]`` (port of ``repro.analysis.cli``).

Exit status: 0 when every checked file is clean, 1 when violations were
found, 2 on usage / unreadable-input errors.  ``--strict`` additionally
fails (exit 1) on unparsable files instead of skipping them with a warning
-- the gate is ``python -m repro_torch.analysis src/repro_torch --strict``.
"""
from __future__ import annotations

import argparse
import sys

from .invariants import RULES, Analyzer


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static invariant checker for the torch port's serving "
                    "stack "
                    "(rules RI001-RI007; suppress a line with "
                    "'# repro: allow[RI00x]').")
    parser.add_argument("paths", nargs="*", default=["src/repro_torch"],
                        help="files or directories to check (default: "
                             "src/repro_torch)")
    parser.add_argument("--strict", action="store_true",
                        help="also fail on unparsable files")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule table and exit")
    parser.add_argument("-q", "--quiet", action="store_true",
                        help="suppress the summary line")
    args = parser.parse_args(argv)

    if args.list_rules:
        for code in sorted(RULES):
            print(f"{code}  {RULES[code]}")
        return 0

    analyzer = Analyzer()
    try:
        analyzer.check_paths(args.paths)
    except OSError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    violations = analyzer.finish()

    for v in violations:
        print(v)
    for err in analyzer.errors:
        print(f"warning: {err}", file=sys.stderr)
    if not args.quiet:
        print(f"repro_torch.analysis: {len(violations)} violation(s) "
              f"in {len(args.paths)} path(s)"
              + (f", {len(analyzer.errors)} unparsable file(s)"
                 if analyzer.errors else ""),
              file=sys.stderr)
    if violations:
        return 1
    if args.strict and analyzer.errors:
        return 1
    return 0


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
