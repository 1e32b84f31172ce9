"""Regime classification: label each worker-window with the bottleneck that
governed it — the paper's diagnostic core made machine-readable.

The paper's claim is that reasoning workloads push serving out of the
Compute-Bound regime into a *Capacity-Bound* one where KV pressure (not
FLOPs) throttles throughput, and that the right mitigation depends on which
regime dominates. Decision rules, checked in order (first match wins):

  1. ``comms_bound`` / cold start — the window overlaps the worker's
     mint->join warming interval: it is paying weight-load, not serving.
  2. ``idle`` — no samples, no tokens, no queue. (If inbound KV transfers
     were in flight during an otherwise idle window, it is ``comms_bound``:
     the worker is starved by the migration wire, not by lack of demand.)
  3. ``capacity_bound`` / preemption storm — any preemption in the window.
     Preemption only happens when the page pool is exhausted mid-decode, so
     its presence is *direct* evidence of KV pressure (Obs 1: recompute
     waste collapses goodput past the capacity knee).
  4. ``capacity_bound`` / KV-throttled admission — peak KV utilisation at or
     above ``kv_saturated`` while work queues: the pool, not the batch cap,
     is what blocks admission.
  5. ``comms_bound`` / migration-dominated — inbound KV transfer in flight
     for at least ``comms_frac`` of the window while KV and preemptions are
     quiet: the wire (kv_transfer_time) gates progress.
  6. ``queue_bound`` — a backlog waits while the running batch sits below
     ``cap_frac`` of the live concurrency cap and KV has headroom: admission
     pacing / token-budget / burst arrival limits, not compute or capacity.
  7. ``compute_bound`` — the worker is busy (tokens flowed or the batch ran
     at/near its cap) with none of the above: iteration time is the limit.

Thresholds live in :class:`RegimeRules` so sweeps can calibrate; defaults
match the paper's testbed behaviour (capacity_trap at high concurrency
classifies ``capacity_bound``, at low concurrency ``compute_bound`` —
asserted in tests and in the ``obs-smoke`` CI job).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.obs.windows import WindowSet, WindowStats

REGIMES = ("compute_bound", "capacity_bound", "queue_bound", "comms_bound",
           "idle")


@dataclasses.dataclass(frozen=True)
class RegimeRules:
    kv_saturated: float = 0.90   # KV util at/above this = pool pressure
    queue_min: float = 1.0       # mean waiting depth that counts as backlog
    cap_frac: float = 0.90       # running/max_seqs below this = cap headroom
    comms_frac: float = 0.50     # transfer-overlap fraction that dominates


@dataclasses.dataclass(frozen=True)
class WindowVerdict:
    window: WindowStats
    regime: str
    reason: str


def classify(w: WindowStats, rules: RegimeRules = RegimeRules()
             ) -> Tuple[str, str]:
    """(regime, reason) for one worker-window — the decision table above."""
    if w.warming:
        return "comms_bound", "cold_start"
    if not w.busy:
        if w.transfer_overlap_s > 0:
            return "comms_bound", "starved_awaiting_kv_transfer"
        return "idle", "no_work"
    if w.preemptions > 0:
        return "capacity_bound", "preemption_storm"
    if w.kv_util_max >= rules.kv_saturated and w.waiting_mean > 0:
        return "capacity_bound", "kv_throttled_admission"
    if (w.width_s > 0 and w.transfer_overlap_s / w.width_s >= rules.comms_frac
            and w.kv_util_max < rules.kv_saturated):
        return "comms_bound", "migration_dominated"
    if (w.waiting_mean >= rules.queue_min and w.max_seqs > 0
            and w.running_max < rules.cap_frac * w.max_seqs
            and w.kv_util_max < rules.kv_saturated):
        return "queue_bound", "backlog_below_concurrency_cap"
    return "compute_bound", "busy_no_kv_pressure"


@dataclasses.dataclass
class RegimeReport:
    """Fleet-level attribution: worker-seconds spent in each regime."""
    verdicts: List[WindowVerdict]
    worker_seconds: Dict[str, float]          # regime -> seconds
    fractions: Dict[str, float]               # regime -> share of total
    busy_fractions: Dict[str, float]          # share excluding idle
    dominant: str                             # busiest non-idle regime
    per_worker: Dict[str, Dict]               # worker -> {dominant, seconds}

    def to_dict(self) -> Dict:
        return {
            "worker_seconds": dict(self.worker_seconds),
            "fractions": dict(self.fractions),
            "busy_fractions": dict(self.busy_fractions),
            "dominant": self.dominant,
            "per_worker": {k: dict(v) for k, v in self.per_worker.items()},
        }


def attribute(ws: WindowSet, rules: RegimeRules = RegimeRules()
              ) -> RegimeReport:
    """Classify every worker-window and integrate into fleet fractions.

    Each window contributes its width in worker-seconds to its regime (the
    same mint->drain accounting ``ClusterMetrics.worker_seconds`` uses, at
    window granularity); ``dominant`` is the regime holding the largest
    share of non-idle worker-seconds — the fleet's bottleneck verdict."""
    verdicts: List[WindowVerdict] = []
    seconds = {r: 0.0 for r in REGIMES}
    per_worker: Dict[str, Dict] = {}
    for worker, windows in ws.by_worker.items():
        wsec = {r: 0.0 for r in REGIMES}
        for w in windows:
            regime, reason = classify(w, rules)
            verdicts.append(WindowVerdict(w, regime, reason))
            seconds[regime] += w.width_s
            wsec[regime] += w.width_s
        busy = {r: s for r, s in wsec.items() if r != "idle" and s > 0}
        per_worker[worker] = {
            "dominant": max(busy, key=busy.get) if busy else "idle",
            "seconds": wsec,
        }
    total = sum(seconds.values())
    busy_total = total - seconds["idle"]
    fractions = {r: (s / total if total > 0 else 0.0)
                 for r, s in seconds.items()}
    busy_fractions = {r: (s / busy_total if busy_total > 0 else 0.0)
                      for r, s in seconds.items() if r != "idle"}
    candidates = {r: s for r, s in seconds.items() if r != "idle" and s > 0}
    dominant = max(candidates, key=candidates.get) if candidates else "idle"
    return RegimeReport(verdicts=verdicts, worker_seconds=seconds,
                        fractions=fractions, busy_fractions=busy_fractions,
                        dominant=dominant, per_worker=per_worker)
