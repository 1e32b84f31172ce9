"""The bottleneck report: spans + windows + regimes folded into one verdict.

``bottleneck_report(events)`` returns a JSON-ready dict with three sections:

  * ``requests`` — the span-level latency decomposition aggregated over
    finished requests: per-phase total/mean/p95 seconds and each phase's
    share of summed end-to-end latency ("where the time went");
  * ``workers`` — per-worker dominant regime and regime-seconds;
  * ``regimes`` — fleet-level fraction of worker-seconds per regime, the
    dominant (non-idle) regime, and a one-line human verdict.

``render_text`` pretty-prints it for terminals; ``python -m repro_torch.obs
report trace.jsonl`` wraps both. Everything derives from the event stream —
run it post-hoc on any JSONL trace, or over a recorded in-process log.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

from repro_torch.core.metrics import latency_stats
from repro_torch.obs.regimes import RegimeRules, attribute
from repro_torch.obs.spans import PHASES, SpanFold, fold_spans
from repro_torch.obs.windows import build_windows

_VERDICT = {
    "compute_bound": "iteration time is the limit — scale compute or "
                     "batch wider",
    "capacity_bound": "KV pressure throttles the fleet (the capacity "
                      "trap) — add KV (right-size TP), cap concurrency, "
                      "or shed load",
    "queue_bound": "backlog without KV or compute saturation — raise the "
                   "concurrency cap or admission/token budgets",
    "comms_bound": "migration / cold-start dominated — faster interconnect, "
                   "fewer migrations, or warmer pools",
    "idle": "fleet mostly idle — nothing to bottleneck",
}


def span_summary(fold: SpanFold) -> Dict:
    """Aggregate the latency decomposition over finished spans."""
    spans = fold.spans
    e2e = [s.total_s for s in spans]
    total_e2e = math.fsum(e2e)
    phases = {}
    for p in PHASES:
        vals = [s.phases[p] for s in spans]
        tot = math.fsum(vals)
        phases[p] = {
            "total_s": tot,
            "mean_s": tot / len(vals) if vals else 0.0,
            "p95_s": latency_stats(vals)["p95"],
            "frac_of_e2e": tot / total_e2e if total_e2e > 0 else 0.0,
        }
    return {
        "n_finished": len(spans),
        "n_unfinished": len(fold.open_spans),
        "n_migrated": sum(1 for s in spans if len(s.workers) > 1),
        "n_preempted": sum(1 for s in spans if s.n_preemptions > 0),
        "e2e_s": latency_stats(e2e),
        "phases": phases,
    }


def bottleneck_report(events, window_s: Optional[float] = None,
                      rules: Optional[RegimeRules] = None) -> Dict:
    """The full machine-readable report (see module docstring)."""
    rows = [e for e in events]
    rules = rules or RegimeRules()
    spans = fold_spans(rows)
    ws = build_windows(rows, window_s=window_s)
    reg = attribute(ws, rules)
    return {
        "n_events": len(rows),
        "t_min": ws.t_min,
        "t_max": ws.t_max,
        "window_s": ws.window_s,
        "n_workers": len(ws.by_worker),
        "requests": span_summary(spans),
        "workers": reg.per_worker,
        "regimes": {
            "worker_seconds": reg.worker_seconds,
            "fractions": reg.fractions,
            "busy_fractions": reg.busy_fractions,
            "dominant": reg.dominant,
            "verdict": _VERDICT[reg.dominant],
        },
    }


def regime_fractions(report: Dict) -> Dict:
    """The slice of the report ``ClusterMetrics.summary(regimes=...)``
    merges into a fleet summary."""
    r = report["regimes"]
    return {"fractions": r["fractions"], "busy_fractions":
            r["busy_fractions"], "dominant": r["dominant"]}


def _pct(x: float) -> str:
    return f"{100.0 * x:5.1f}%"


def render_text(rep: Dict, title: str = "") -> str:
    """Terminal rendering of ``bottleneck_report`` output."""
    lines: List[str] = []
    head = "repro_torch.obs bottleneck report"
    if title:
        head += f" — {title}"
    lines.append(head)
    lines.append(f"  events {rep['n_events']}  workers {rep['n_workers']}  "
                 f"span [{rep['t_min']:.3f}, {rep['t_max']:.3f}]s  "
                 f"window {rep['window_s']:.3f}s")
    r = rep["regimes"]
    lines.append("  regime attribution (fraction of worker-seconds):")
    for name, frac in r["fractions"].items():
        busy = r["busy_fractions"].get(name)
        mark = " <== dominant" if (name == r["dominant"]
                                   and name != "idle") else ""
        extra = f"  ({_pct(busy)} of busy)" if busy is not None else ""
        lines.append(f"    {name:<15} {_pct(frac)}{extra}{mark}")
    lines.append(f"  verdict: {r['dominant']} — {r['verdict']}")
    q = rep["requests"]
    lines.append(f"  requests: {q['n_finished']} finished, "
                 f"{q['n_unfinished']} unfinished, "
                 f"{q['n_preempted']} preempted, {q['n_migrated']} migrated")
    lines.append("  latency decomposition (exact; fractions of summed e2e):")
    for p, st in q["phases"].items():
        lines.append(f"    {p:<17} {_pct(st['frac_of_e2e'])}  "
                     f"mean {st['mean_s']:.4f}s  p95 {st['p95_s']:.4f}s")
    lines.append("  per-worker dominant regime:")
    for name, info in rep["workers"].items():
        secs = info["seconds"]
        busy_s = sum(v for k, v in secs.items() if k != "idle")
        lines.append(f"    {name:<18} {info['dominant']:<15} "
                     f"busy {busy_s:.2f}s / idle {secs['idle']:.2f}s")
    return "\n".join(lines)


def attach(log, window_s: Optional[float] = None,
           rules: Optional[RegimeRules] = None):
    """Subscribe a recording tap to a live ``EventLog`` and return a
    zero-argument closure that builds the report once the run drains.

    This is the REP009-clean in-process hook: the tap is a pure subscriber
    (it only accumulates its own copy of the stream), so metrics stay
    bit-identical to an un-observed run."""
    rows: List = []
    log.subscribe(rows.append)
    return lambda: bottleneck_report(rows, window_s=window_s, rules=rules)
