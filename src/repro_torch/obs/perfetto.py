"""Chrome-trace (Perfetto / ``chrome://tracing``) export of a recorded run.

``to_chrome_trace(events)`` renders the stream as a standard trace-event
JSON object (``{"traceEvents": [...], "displayTimeUnit": "ms"}``):

  * one *process* per worker (pid = 1 + worker index, named via ``ph:"M"``
    ``process_name`` metadata), so each worker gets its own track group;
  * one *thread* per request (tid = rid) carrying the request's span
    segments as ``ph:"X"`` complete events — a per-worker Gantt chart of
    queue_wait / prefill / decode / preempted_stall / recompute_resume /
    kv_transfer, colored by phase name;
  * ``ph:"C"`` counter rows per worker sampled from ``step`` events:
    KV pages (used/free stacked), running batch + waiting queue depth.

Timestamps are microseconds (the sim clock's seconds * 1e6), durations
likewise; a segment spanning a migration is emitted on the worker that
owned the request during that interval, so hand-offs read left-to-right
across process tracks. Load the output directly in ``ui.perfetto.dev``.
"""
from __future__ import annotations

from typing import Any, Dict, List

from repro_torch.obs.spans import as_row, fold_spans

_US = 1e6


def _pid_table(rows: List[Dict[str, Any]]) -> Dict[str, int]:
    """worker name -> pid, in order of first appearance in the stream."""
    pids: Dict[str, int] = {}
    for row in rows:
        w = row["worker"]
        if w and w not in pids:
            pids[w] = 1 + len(pids)
    return pids


def to_chrome_trace(events) -> Dict[str, Any]:
    rows = [as_row(ev) for ev in events]
    pids = _pid_table(rows)
    out: List[Dict[str, Any]] = []

    for w, pid in pids.items():
        out.append({"ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                    "args": {"name": f"worker:{w}"}})

    # ---- request Gantt: one thread per rid, span segments as X events
    fold = fold_spans(rows)
    named: set = set()
    for span in fold.spans + fold.open_spans:
        for seg in span.segments:
            pid = pids.get(seg.worker)
            if pid is None:
                continue
            key = (pid, span.rid)
            if key not in named:
                named.add(key)
                out.append({"ph": "M", "name": "thread_name", "pid": pid,
                            "tid": span.rid,
                            "args": {"name": f"req {span.rid}"}})
            out.append({
                "ph": "X", "name": seg.phase, "cat": "request",
                "pid": pid, "tid": span.rid,
                "ts": seg.t0 * _US, "dur": (seg.t1 - seg.t0) * _US,
                "args": {"rid": span.rid, "worker": seg.worker},
            })

    # ---- per-worker counters from step samples
    for row in rows:
        if row["kind"] != "step":
            continue
        pid = pids.get(row["worker"])
        if pid is None:
            continue
        p, ts = row["payload"], row["t"] * _US
        out.append({"ph": "C", "name": "kv_pages", "cat": "kv",
                    "pid": pid, "tid": 0, "ts": ts,
                    "args": {"used": p.get("kv_pages_used", 0),
                             "free": p.get("kv_pages_free", 0)}})
        out.append({"ph": "C", "name": "batch", "cat": "sched",
                    "pid": pid, "tid": 0, "ts": ts,
                    "args": {"running": p["running"],
                             "waiting": p["waiting"]}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}
