"""CLI: `python -m repro_torch.analysis [paths...] [--rules LCK,SRC,PUR]`.

Runs the three invariant pass families over the installed `repro_torch` tree
(or over explicit files/directories — the fixture tests use this),
prints findings as `file:line: RULE-ID message`, and exits non-zero if
there are any. This is the `static-analysis` CI gate.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="repro_torch invariant checks: lock order (LCK), "
                    "single-source rules (SRC), core purity (PUR), "
                    "single-source timing (TEL), single-source "
                    "freshness (FRS)")
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files or directories to scan (default: the "
                         "installed repro_torch tree)")
    ap.add_argument("--rules", default="LCK,SRC,PUR,TEL,FRS",
                    help="comma-separated rule families to run")
    args = ap.parse_args(argv)

    files = None
    if args.paths:
        files = []
        for p in args.paths:
            files.extend(sorted(p.rglob("*.py")) if p.is_dir() else [p])
    findings = run(files, rules=args.rules.split(","))
    for f in findings:
        print(f.render())
    if findings:
        print(f"{len(findings)} finding(s)", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
