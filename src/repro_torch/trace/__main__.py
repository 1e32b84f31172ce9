"""CLI: ``python -m repro_torch.trace diff a.jsonl b.jsonl [--context N]``.

Exit codes (lint-style): 0 = streams event-identical, 1 = divergence found,
2 = usage / unreadable input.
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.trace.diff import diff_events
from repro_torch.trace.jsonl import load_events


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.trace",
        description="event-stream tools (see docs/trace.md)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("diff", help="compare two JSONL event streams")
    d.add_argument("a")
    d.add_argument("b")
    d.add_argument("--context", type=int, default=3,
                   help="identical events to print before the divergence")
    args = ap.parse_args(argv)

    try:
        ea, eb = load_events(args.a), load_events(args.b)
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    res = diff_events(ea, eb, context=args.context,
                      label_a=args.a, label_b=args.b)
    print(res.report())
    return 0 if res.identical else 1


if __name__ == "__main__":
    sys.exit(main())
