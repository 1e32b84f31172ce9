"""``python -m repro_torch.lint [paths...]`` — exit non-zero on findings."""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from repro_torch.lint.runner import format_json, format_text, lint_paths


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="determinism & feasibility lint for the repro simulator")
    ap.add_argument("paths", nargs="*", default=["src"],
                    help="files or directories to lint (default: src)")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as JSON instead of text")
    ap.add_argument("--errors-only", action="store_true",
                    help="exit non-zero only on error-severity findings")
    args = ap.parse_args(argv)

    findings = lint_paths(args.paths or ["src"])
    if args.json:
        print(format_json(findings))
    else:
        print(format_text(findings))
    gating = [f for f in findings
              if not args.errors_only or f.severity == "error"]
    return 1 if gating else 0


if __name__ == "__main__":
    sys.exit(main())
