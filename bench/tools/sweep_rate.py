"""Find the highest rate an open-loop cell sustains: one engine, the
cell's mix at each rate in turn (a warm-in, then a measured window, then
a drain), and for each rate the backlog's trend (requests due and not yet
given their first token, sampled every step, fitted by a line) and the
TTFT p95 of the requests due in the window.

    python3 bench/tools/sweep_rate.py --workload <cell> --rates 4 6 8 --seconds 30
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import numpy as np

    from harness import spec, stats, system
    from harness.loop import Loop, Spans, clock
    cell = spec.load_cell(args.workload)
    s = spec.model_sizes(cell.config)
    eng = system.build(cell.config, s, args.seed, args.device)
    spans = Spans()
    spans.wrap(eng.runner)
    for rate in args.rates:
        mix = dict(cell.traffic, rate_per_s=rate)
        loop = Loop(eng, spans, mix, args.seed, s["V"], eng.ecfg.max_num_seqs)
        loop.t_ref = clock() - eng.now
        plan = loop.schedule(args.seconds)
        at = loop.run_open(plan, clock() + float(mix["warmin_s"]), 0)
        t_start = clock()
        samples = []

        dues = np.array([t for t, _, _ in plan])

        def backlog():
            # due so far, less those given their first token
            now = clock()
            served = sum(1 for r in loop.requests if spans.times.get(r.rid))
            samples.append((now - t_start, int(np.searchsorted(dues, now, "right")) - served))
        loop.on_step = backlog
        loop.run_open(plan, t_start + args.seconds, at)
        t_close = clock()
        due = [t for t, _, _ in plan if t_start <= t < t_close]
        ttft = stats.ttfts(spans.times, loop.due, due, t_start, t_close)
        x, y = np.array(samples, dtype=np.float64).T
        slope = float(np.polyfit(x, y, 1)[0]) if len(x) > 2 else None
        print(json.dumps({"rate_per_s": rate, "due_in_window": len(due),
                          "backlog_slope_per_s": slope, "backlog_end": int(y[-1]),
                          "ttft_p50_ms": stats.percentile(ttft, 50) * 1e3,
                          "ttft_p95_ms": stats.percentile(ttft, 95) * 1e3,
                          "card": system.device_name(args.device)}), flush=True)
        loop.on_step = None
        deadline = clock() + 120
        while eng.has_work and clock() < deadline:
            loop.step()


if __name__ == "__main__":
    main()
