"""Windowed per-worker time-series derived from the event stream.

The stream is sliced into fixed-width windows (``window_s``; ``None`` picks
``span / DEFAULT_N_WINDOWS`` from the trace itself, so the fold stays a pure
function of the stream) and each worker's events are folded into one
:class:`WindowStats` row per window it was alive in:

  * ``step`` events sample occupancy: running batch size, waiting-queue
    depth, KV utilisation and absolute page counts, the live concurrency
    cap (``max_seqs`` moves under the autotuner);
  * ``decode_step`` / ``prefill`` events count executed tokens exactly
    (independent of ``snapshot_every`` subsampling);
  * ``preempt`` / ``admit`` / ``resume`` events count scheduler churn;
  * ``kv_transfer`` + ``inject`` pairs attribute migration traffic — and
    the in-flight interval overlaps the *destination* worker's windows as
    ``transfer_overlap_s`` (time the adopter spent with KV inbound);
  * ``mint`` / ``join`` mark cold-start warming windows.

Everything here is computable from the stream alone (PR-9 extended the
``step`` payload precisely so this module needs no engine access), so the
same fold runs post-hoc over a JSONL trace or in-process as a subscriber.
Windows of two same-seed runs are identical because the streams are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs.spans import as_row

DEFAULT_N_WINDOWS = 48


@dataclasses.dataclass
class WindowStats:
    """One worker's activity inside one ``[t0, t1)`` window."""
    worker: str
    t0: float
    t1: float
    # occupancy samples (from ``step`` events; 0 samples => idle window)
    n_samples: int = 0
    running_mean: float = 0.0
    running_max: int = 0
    waiting_mean: float = 0.0
    waiting_max: int = 0
    kv_util_mean: float = 0.0
    kv_util_max: float = 0.0
    kv_pages_used_max: int = 0
    max_seqs: int = 0              # live concurrency cap (max over samples)
    # exact token counts (from decode_step / prefill events)
    decode_tokens: int = 0
    prefill_tokens: int = 0
    # scheduler churn
    preemptions: int = 0
    admits: int = 0
    resumes: int = 0
    # migration traffic
    migrations_out: int = 0        # ejects harvested off this worker
    migrations_in: int = 0         # injects adopted by this worker
    transfer_overlap_s: float = 0.0  # inbound KV in flight during the window
    warming: bool = False          # cold start (mint -> join) overlaps

    @property
    def width_s(self) -> float:
        return self.t1 - self.t0

    @property
    def decode_tok_s(self) -> float:
        return self.decode_tokens / self.width_s if self.width_s > 0 else 0.0

    @property
    def prefill_tok_s(self) -> float:
        return self.prefill_tokens / self.width_s if self.width_s > 0 else 0.0

    @property
    def preempt_rate(self) -> float:
        return self.preemptions / self.width_s if self.width_s > 0 else 0.0

    @property
    def busy(self) -> bool:
        return (self.decode_tokens > 0 or self.prefill_tokens > 0
                or self.running_max > 0 or self.waiting_max > 0)


@dataclasses.dataclass
class _Acc:
    """Raw per-(worker, window) accumulator before the mean division."""
    running_sum: float = 0.0
    waiting_sum: float = 0.0
    kv_util_sum: float = 0.0
    stats: WindowStats = None


class WindowSet:
    """All workers' windows plus the trace-wide frame they were cut from."""

    def __init__(self, t_min: float, t_max: float, window_s: float,
                 by_worker: Dict[str, List[WindowStats]]):
        self.t_min = t_min
        self.t_max = t_max
        self.window_s = window_s
        self.by_worker = by_worker

    @property
    def workers(self) -> List[str]:
        return list(self.by_worker)

    def all_windows(self) -> List[WindowStats]:
        return [w for ws in self.by_worker.values() for w in ws]


def _frame(events) -> Tuple[float, float]:
    t_min = t_max = None
    for ev in events:
        t = as_row(ev)["t"]
        t_min = t if t_min is None else min(t_min, t)
        t_max = t if t_max is None else max(t_max, t)
    return (t_min or 0.0), (t_max or 0.0)


def build_windows(events, window_s: Optional[float] = None) -> WindowSet:
    """Cut the stream into windows and fold per-worker stats (post-hoc; the
    events are iterated twice, so pass a list, not a generator)."""
    rows = [as_row(ev) for ev in events]
    t_min, t_max = _frame(rows)
    if window_s is None:
        span = max(t_max - t_min, 1e-9)
        window_s = span / DEFAULT_N_WINDOWS
    window_s = max(window_s, 1e-9)

    accs: Dict[Tuple[str, int], _Acc] = {}
    # worker lifecycle intervals for warming overlap: name -> [mint, join]
    warm_start: Dict[str, float] = {}
    warm_end: Dict[str, float] = {}
    # in-flight transfers: rid -> (t_eject,); closed by inject with dst
    pending: Dict[int, float] = {}
    transfers: List[Tuple[str, float, float]] = []   # (dst, t0, t1)

    def acc_i(worker: str, i: int) -> _Acc:
        key = (worker, i)
        a = accs.get(key)
        if a is None:
            a = _Acc(stats=WindowStats(
                worker=worker, t0=t_min + i * window_s,
                t1=t_min + (i + 1) * window_s))
            accs[key] = a
        return a

    def acc(worker: str, t: float) -> _Acc:
        return acc_i(worker, int((t - t_min) / window_s))

    for row in rows:
        kind, t, w = row["kind"], row["t"], row["worker"]
        p = row["payload"]
        if kind == "step":
            a = acc(w, t)
            s = a.stats
            s.n_samples += 1
            a.running_sum += p["running"]
            a.waiting_sum += p["waiting"]
            a.kv_util_sum += p["kv_util"]
            s.running_max = max(s.running_max, p["running"])
            s.waiting_max = max(s.waiting_max, p["waiting"])
            s.kv_util_max = max(s.kv_util_max, p["kv_util"])
            s.kv_pages_used_max = max(s.kv_pages_used_max,
                                      p.get("kv_pages_used", 0))
            s.max_seqs = max(s.max_seqs, p.get("max_seqs", 0))
        elif kind == "decode_step":
            acc(w, t).stats.decode_tokens += len(p["rids"])
        elif kind == "prefill":
            acc(w, t).stats.prefill_tokens += p["chunk"]
        elif kind == "preempt":
            acc(w, t).stats.preemptions += 1
        elif kind == "admit":
            acc(w, t).stats.admits += 1
        elif kind == "resume":
            acc(w, t).stats.resumes += 1
        elif kind == "eject":
            acc(w, t).stats.migrations_out += 1
        elif kind == "kv_transfer":
            pending[row["rid"]] = t
        elif kind == "inject":
            acc(w, t).stats.migrations_in += 1
            t0 = pending.pop(row["rid"], None)
            if t0 is not None:
                transfers.append((w, t0, t))
        elif kind == "mint":
            warm_start[w] = t
        elif kind == "join":
            warm_end[w] = t

    # inbound-transfer overlap: spread each (dst, t0, t1) interval over the
    # destination's windows it intersects
    for dst, a, b in transfers:
        i0 = int((a - t_min) / window_s)
        i1 = int((b - t_min) / window_s)
        for i in range(i0, i1 + 1):
            w0 = t_min + i * window_s
            ov = min(b, w0 + window_s) - max(a, w0)
            if ov > 0:
                acc_i(dst, i).stats.transfer_overlap_s += ov

    # warming overlap: mark the minted worker's windows inside
    # [mint, join) — cold start is comms/provisioning, not serving
    for name, w0 in warm_start.items():
        w1 = warm_end.get(name, t_max)
        i0 = int((w0 - t_min) / window_s)
        i1 = int((max(w1 - 1e-12, w0) - t_min) / window_s)
        for i in range(i0, i1 + 1):
            acc_i(name, i).stats.warming = True

    by_worker: Dict[str, List[WindowStats]] = {}
    for (worker, _i), a in sorted(accs.items()):
        s = a.stats
        if s.n_samples:
            s.running_mean = a.running_sum / s.n_samples
            s.waiting_mean = a.waiting_sum / s.n_samples
            s.kv_util_mean = a.kv_util_sum / s.n_samples
        by_worker.setdefault(worker, []).append(s)
    return WindowSet(t_min, t_max, window_s, by_worker)
