"""Fleet-level metric aggregation: SLO attainment, goodput, and per-replica
KV-saturation timelines (the paper's serving-level claims — Obs 3/4: the
fleet's tail is set by the first replica to saturate its KV pool).

Accounting is makespan-honest: the runtime stamps ``t_end`` (the fleet clock
at drain) so ``duration_s`` covers the whole serving window — not just the
finished-request span, which shrinks while the tail is still in flight and
inflates goodput. Submitted-but-unfinished requests count as SLO misses
("tokens served outside the SLO are throughput, not goodput" — and a request
that never finished served them outside any SLO). ``summary(slos=...)``
reports each SLO class against its own targets; per-class goodputs sum to the
fleet goodput."""
from __future__ import annotations

import dataclasses
import statistics
from typing import Dict, List, Mapping, Optional, Union

from repro_torch.core.metrics import (SLO, SLOMap, class_slo_summary,
                                finished_window_s, latency_stats)
from repro_torch.core.request import Request
from repro_torch.cluster.worker import Worker


@dataclasses.dataclass(frozen=True)
class ScalingEvent:
    """One autoscaling lifecycle transition, stamped on the fleet clock.

    kinds: ``scale_up`` (replica minted, cold start begins), ``join``
    (weight load done, entered the route/dispatch pools), ``retire``
    (left the pools, draining in-flight work), ``drained`` (went dark;
    ``Worker.t_retire`` stamped)."""
    t: float
    kind: str
    worker: str
    role: str
    pool_size: int                # active pool size AFTER the transition


@dataclasses.dataclass
class MigrationRecord:
    rid: int
    src: str                      # prefill worker name
    dst: str                      # decode worker name
    t_eject: float
    t_ready: float                # eject + modeled KV-transfer time
    t_delivered: float            # when the decode worker adopted it
    context_tokens: int

    @property
    def transfer_s(self) -> float:
        return self.t_ready - self.t_eject


class ClusterMetrics:
    """Aggregates per-worker MetricsLog + cluster-level migration records —
    derived purely from the fleet event stream (``repro_torch.trace``).

    The runtime subscribes this object to its fleet ``EventLog`` at
    construction; every record here is a fold over that stream: ``arrival``
    grows the routed-request list, ``mint``/``join``/``retire``/``drained``
    become :class:`ScalingEvent` rows, a ``kv_transfer`` paired with its
    adopter's ``inject`` closes a :class:`MigrationRecord`, and ``run_end``
    stamps the fleet makespan. Nothing else may mutate this state (lint
    REP009). ``submitted`` is shared by reference with the runtime, so
    callers holding either see the same list."""

    # stream lifecycle kind -> ScalingEvent kind ("mint" is recorded as the
    # historical "scale_up" so scaling_events stay identical to the
    # pre-stream accounting)
    _SCALING_KINDS = {"mint": "scale_up", "join": "join",
                      "retire": "retire", "drained": "drained"}

    def __init__(self, workers: List[Worker],
                 submitted: Optional[List[Request]] = None):
        self.workers = workers
        self.migrations: List[MigrationRecord] = []
        self.scaling_events: List[ScalingEvent] = []
        self.submitted: List[Request] = submitted if submitted is not None \
            else []
        self.t_end: Optional[float] = None
        # stream-derived lifecycle stamps; workers present at t=0 (never
        # minted/drained on-stream) fall back to their Worker fields
        self._t_join: Dict[str, float] = {}
        self._t_retire: Dict[str, float] = {}
        self._pending_transfers: Dict[int, tuple] = {}

    # ---- the one mutation path: the fleet event stream -------------------
    def on_event(self, ev):
        kind = ev.kind
        if kind == "arrival":
            self.submitted.append(ev.ref)
        elif kind in self._SCALING_KINDS:
            self.scaling_events.append(ScalingEvent(
                t=ev.t, kind=self._SCALING_KINDS[kind], worker=ev.worker,
                role=ev.payload["role"], pool_size=ev.payload["pool_size"]))
            if kind == "mint":
                self._t_join[ev.worker] = ev.t
            elif kind == "drained":
                self._t_retire[ev.worker] = ev.t
        elif kind == "kv_transfer":
            self._pending_transfers[ev.rid] = (
                ev.worker, ev.t, ev.payload["ready"])
        elif kind == "inject" and ev.rid in self._pending_transfers:
            src, t_eject, t_ready = self._pending_transfers.pop(ev.rid)
            self.migrations.append(MigrationRecord(
                rid=ev.rid, src=src, dst=ev.worker,
                t_eject=t_eject, t_ready=t_ready, t_delivered=ev.t,
                context_tokens=ev.payload["context_tokens"]))
        elif kind == "run_end":
            self.t_end = ev.t

    # ------------------------------------------------------------- collection
    def _join_t(self, w: Worker) -> float:
        return self._t_join.get(w.name, w.t_join)

    def _retire_t(self, w: Worker) -> Optional[float]:
        return self._t_retire.get(w.name, w.t_retire)

    def finished_requests(self) -> List[Request]:
        return [r for w in self.workers for r in w.engine.metrics.finished]

    def saturation_timeline(self, worker: Worker) -> List[Dict[str, float]]:
        return [{"t": p.t, "kv_util": p.kv_util}
                for p in worker.engine.metrics.timeline]

    def time_to_saturation(self, worker: Worker,
                           threshold: float = 0.95) -> Optional[float]:
        """First time the worker's KV pool crossed `threshold` utilisation."""
        for p in worker.engine.metrics.timeline:
            if p.kv_util >= threshold:
                return p.t
        return None

    # -------------------------------------------------------------- summaries
    def _window(self, makespan: Optional[float]):
        """(duration, horizon): duration from the explicit makespan when one
        is known — runtime-stamped ``t_end`` or the caller's override —
        falling back to the finished-only span otherwise (no runtime
        attached). A known makespan doubles as the horizon for counting
        unfinished requests as misses."""
        reqs = self.submitted or self.finished_requests()
        end = makespan if makespan is not None else self.t_end
        if end is None:
            return finished_window_s(reqs), None
        t0 = min((r.arrival for r in reqs), default=0.0)
        return max(end - t0, 1e-9), end

    def worker_seconds(self, makespan: Optional[float] = None) -> float:
        """Total provisioned worker-seconds: each worker's active window
        (mint -> decommission, cold start included) integrated over the
        serving window. A static fleet yields ``n_workers * duration``;
        an autoscaled fleet pays only for the replicas it actually held —
        the denominator that makes elastic and fixed fleets cost-comparable
        (goodput per worker-second)."""
        reqs = self.submitted or self.finished_requests()
        end = makespan if makespan is not None else self.t_end
        t0 = min((r.arrival for r in reqs), default=0.0)
        if end is None:
            end = t0 + finished_window_s(reqs)
        # per-worker slice mirrors Worker.active_window, but over the
        # stream-derived mint/drain stamps
        total = 0.0
        for w in self.workers:
            tr = self._retire_t(w)
            w_end = tr if tr is not None else end
            total += max(min(w_end, end) - max(self._join_t(w), t0), 0.0)
        return total

    def summary(self, slo: Optional[Union[SLO, SLOMap]] = None,
                slos: Optional[SLOMap] = None,
                makespan: Optional[float] = None,
                regimes: Optional[Dict] = None) -> Dict:
        """Fleet summary. Pass a single ``slo`` or a ``slos`` class map for
        SLO accounting (a map adds a per-class breakdown under
        ``"classes"``); ``makespan`` overrides the runtime-stamped fleet
        clock. ``regimes`` (the dict from
        ``repro_torch.obs.report.regime_fractions``) merges bottleneck-regime
        fractions under a ``"regimes"`` key — obs stays a pure stream
        consumer, so the attribution is computed there and *handed in*
        here; omitted, the summary is byte-identical to pre-obs output."""
        finished = self.finished_requests()
        all_reqs = self.submitted or finished
        # served tokens include in-flight requests' partial decodes — the
        # denominator is the whole serving window, so the numerator must
        # cover everything served in it (truncated runs would otherwise
        # understate throughput)
        gen = sum(r.generated for r in all_reqs)
        dur, horizon = self._window(makespan)
        ws = self.worker_seconds(makespan)
        per_worker = {}
        for w in self.workers:
            tl = w.engine.metrics.timeline
            sat = self.time_to_saturation(w)
            per_worker[w.name] = {
                "role": w.role,
                "n_finished": len(w.engine.metrics.finished),
                "peak_kv_util": max((p.kv_util for p in tl), default=0.0),
                "mean_kv_util": statistics.fmean(
                    [p.kv_util for p in tl]) if tl else 0.0,
                "preemptions": w.engine.sched.n_preemptions,
                "time_to_saturation_s": sat,
                "t_join": self._join_t(w),
                "t_retire": self._retire_t(w),
            }
        out = {
            "n_submitted": len(all_reqs),
            "n_finished": len(finished),
            "n_unfinished": len(all_reqs) - len(finished),
            "gen_tokens": gen,
            "duration_s": dur,
            "throughput_tok_s": gen / dur,
            # cost-normalised rates: tokens per provisioned worker-second —
            # the number that makes an autoscaled fleet comparable to a
            # statically peak-provisioned one (same goodput, fewer
            # worker-seconds = the utilization gap recovered)
            "worker_seconds": ws,
            "throughput_tok_per_worker_s": gen / max(ws, 1e-9),
            "n_scaling_events": len(self.scaling_events),
            "n_migrations": len(self.migrations),
            "mean_transfer_s": statistics.fmean(
                [m.transfer_s for m in self.migrations])
            if self.migrations else 0.0,
            "workers": per_worker,
            # fleet tail is set by the FIRST saturating replica (Obs 4)
            "first_saturation_s": min(
                (v["time_to_saturation_s"] for v in per_worker.values()
                 if v["time_to_saturation_s"] is not None), default=None),
        }
        table = slos if slos is not None else slo
        if table is not None:
            pool = all_reqs if horizon is not None else finished
            s = class_slo_summary(pool, table, dur, horizon=horizon)
            out["slo_attainment"] = s["slo_attainment"]
            out["goodput_tok_s"] = s["goodput_tok_s"]
            # good tokens / provisioned worker-seconds (goodput_tok_s is
            # good tokens / duration, so multiply the duration back in)
            out["goodput_tok_per_worker_s"] = \
                s["goodput_tok_s"] * dur / max(ws, 1e-9)
            if isinstance(table, Mapping):
                out["classes"] = s["classes"]
        if regimes is not None:
            out["regimes"] = dict(regimes)
        return out

    def request_summary(self) -> Dict:
        """Latency distributions over all finished requests (fleet-wide)."""
        reqs = self.finished_requests()
        return {
            "ttft_s": latency_stats([r.ttft() for r in reqs]),
            "tpot_s": latency_stats([r.tpot() for r in reqs]),
            "e2e_s": latency_stats([r.e2e() for r in reqs]),
            "waiting_s": latency_stats([r.waiting_time() for r in reqs]),
        }
