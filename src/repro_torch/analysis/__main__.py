"""CLI: ``python -m repro_torch.analysis <paths...> [--format text|json]``.

Exit codes: 0 = clean, 1 = findings, 2 = usage error (missing path, no
paths). The port's gate is
``python -m repro_torch.analysis src/repro_torch chip_smoke.py
tests/test_torch_*.py``.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.analysis import engine
from repro_torch.analysis import rules as rules_mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST invariant linter encoding the port's shipped-bug "
                    "contracts")
    ap.add_argument("paths", nargs="*",
                    help="files or directories to scan (e.g. src/repro_torch "
                         "chip_smoke.py)")
    ap.add_argument("--format", choices=("text", "json"), default="text",
                    help="report format (default text)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule table and exit 0")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule in rules_mod.RULES:
            print(f"{rule.id:18s} [{rule.kind}] {rule.summary}")
        print(f"{len(rules_mod.RULES)} rules")
        return 0
    if not args.paths:
        ap.error("no paths given (e.g. src/repro_torch chip_smoke.py)")
    try:
        result = engine.analyze_paths(args.paths)
    except FileNotFoundError as e:
        ap.error(f"path does not exist: {e.args[0]}")
    print(engine.render(result, args.format))
    return 0 if result.ok else 1


if __name__ == "__main__":
    sys.exit(main())
