"""Run one cell several times, each run a process of its own, one after
another, as the benchmark's checks run it; keep every run's output lines
in a JSON-lines file and print one line a run.

    python3 bench/tools/repeat.py --workload <cell> --seeds 11 11 13 --seconds 45 \\
        [--trace 1] [--out chiprun_out/runs.jsonl] [-- extra arguments of run.py]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def main():
    argv = sys.argv[1:]
    extra = []
    if "--" in argv:
        at = argv.index("--")
        argv, extra = argv[:at], argv[at + 1:]
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/runs.jsonl")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    for seed in args.seeds:
        cmd = [sys.executable, str(BENCH / "run.py"), "--workload", args.workload,
               "--seed", str(seed), "--seconds", str(args.seconds),
               "--trace", str(args.trace), *extra]
        t0 = time.time()
        p = subprocess.run(cmd, capture_output=True, text=True)
        lines = []
        for line in p.stdout.splitlines():
            try:
                lines.append(json.loads(line))
            except ValueError:
                pass
        rec = {"cell": args.workload, "seed": seed, "trace": args.trace, "extra": extra,
               "rc": p.returncode, "wall_s": time.time() - t0, "lines": lines,
               "stderr_tail": p.stderr[-3000:]}
        with out.open("a") as f:
            f.write(json.dumps(rec) + "\n")
        summ = next((x["summary"] for x in lines if "summary" in x), {})
        res = lines[-1] if lines and "correct" in lines[-1] else {}
        print(json.dumps({
            "seed": seed, "rc": p.returncode, "wall_s": round(rec["wall_s"], 1),
            "correct": res.get("correct"),
            "metrics": {k: v["value"] for k, v in res.get("metrics", {}).items()},
            "checks": {k: v["value"] for k, v in res.get("checks", {}).items()},
            "summary": {k: summ.get(k) for k in (
                "setup_s", "steps", "decode_calls", "decode_ms_mean", "prefill_calls",
                "prefill_ms_mean", "output_tok_s_halves", "finished_in_window", "host")},
        }), flush=True)
        if p.returncode != 0:
            print(p.stderr[-2000:], file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
