"""CLI for repro_torch.obs — post-hoc analysis of JSONL event traces.

    python -m repro_torch.obs report trace.jsonl [--json] [--window S]
    python -m repro_torch.obs perfetto trace.jsonl -o trace.perfetto.json

``report`` prints the bottleneck report (text by default, ``--json`` for the
machine-readable dict); ``perfetto`` writes a Chrome-trace JSON loadable in
ui.perfetto.dev. Input is one JSON event per line, as written by
``REPRO_TRACE_OUT`` / the benchmarks' ``--trace-out``. Exit codes: 0 on
success, 2 on unreadable/empty input.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List


def _load(path: str) -> List[Dict[str, Any]]:
    rows: List[Dict[str, Any]] = []
    try:
        with open(path, "r") as f:
            for i, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except json.JSONDecodeError as e:
                    print(f"error: {path}:{i}: not JSON ({e})",
                          file=sys.stderr)
                    raise SystemExit(2)
                if not isinstance(row, dict) or "kind" not in row:
                    print(f"error: {path}:{i}: not an event row",
                          file=sys.stderr)
                    raise SystemExit(2)
                rows.append(row)
    except OSError as e:
        print(f"error: cannot read {path}: {e}", file=sys.stderr)
        raise SystemExit(2)
    if not rows:
        print(f"error: {path}: no events", file=sys.stderr)
        raise SystemExit(2)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="bottleneck attribution & timeline export over "
                    "repro_torch.trace JSONL traces")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_rep = sub.add_parser("report", help="print the bottleneck report")
    p_rep.add_argument("trace", help="JSONL trace file")
    p_rep.add_argument("--json", action="store_true",
                       help="emit the machine-readable report")
    p_rep.add_argument("--window", type=float, default=None, metavar="S",
                       help="window width in seconds (default: span/48)")

    p_perf = sub.add_parser("perfetto",
                            help="export a Chrome-trace JSON timeline")
    p_perf.add_argument("trace", help="JSONL trace file")
    p_perf.add_argument("-o", "--out", required=True,
                        help="output .json path")

    args = ap.parse_args(argv)
    rows = _load(args.trace)

    if args.cmd == "report":
        from repro_torch.obs.report import bottleneck_report, render_text
        rep = bottleneck_report(rows, window_s=args.window)
        if args.json:
            print(json.dumps(rep, indent=2, sort_keys=True))
        else:
            print(render_text(rep, title=args.trace))
        return 0

    from repro_torch.obs.perfetto import to_chrome_trace
    trace = to_chrome_trace(rows)
    with open(args.out, "w") as f:
        json.dump(trace, f)
    n = len(trace["traceEvents"])
    print(f"wrote {args.out}: {n} trace events "
          f"from {len(rows)} log events")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
