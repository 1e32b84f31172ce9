"""Engine telemetry — the paper's §III-D metric set: TTFT, TPOT, generation
throughput, E2E, request lifecycle decomposition, KV saturation, preemptions,
plus modeled HBM-bandwidth utilisation in simulated mode, and SLO-goodput
accounting (tokens/s delivered within latency targets) for the cluster layer.

Goodput accounting ("tokens served outside the SLO are throughput, not
goodput") is honest about its denominators:

  * duration comes from an explicit makespan when the caller has one (the
    cluster runtime's fleet clock at drain) — a finished-only window ignores
    the tail still being served and inflates goodput;
  * with a ``horizon``, submitted-but-unfinished requests count as SLO
    misses — the worst violators are exactly the ones still in flight.

``slo_summary`` is class-conditional: requests carry an ``slo_class`` tag and
each class is judged against its own ``SLO`` (multi-tenant interactive/batch
tiers); class goodputs sum to fleet goodput by construction (shared duration,
disjoint request buckets).
"""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, List, Mapping, Optional, Union

from repro_torch.core.request import Request


@dataclasses.dataclass(frozen=True)
class SLO:
    """Per-request latency targets. A request attains the SLO iff its TTFT
    and its mean TPOT both meet their targets (the serving-level contract the
    paper's goodput discussions assume). A target of None is unconstrained.

    An *undefined measurement* (None) vacuously satisfies its target — the
    rule is symmetric for TTFT and TPOT. For finished requests TTFT is always
    defined; TPOT is undefined only for single-token outputs, which cannot
    violate an inter-token contract. Unfinished requests never attain here;
    counting them as misses against a horizon is the caller's job
    (``slo_attainment(horizon=...)``)."""
    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None

    def attained(self, req: Request) -> bool:
        if req.t_finished is None:
            return False
        if self.ttft_s is not None:
            ttft = req.ttft()
            if ttft is not None and ttft > self.ttft_s:
                return False
        if self.tpot_s is not None:
            tpot = req.tpot()
            if tpot is not None and tpot > self.tpot_s:
                return False
        return True


def attained_by(req: Request, slo: SLO,
                horizon: Optional[float] = None) -> bool:
    """``slo.attained`` windowed: with a horizon, only requests *finished by
    the horizon* can attain — one still in flight (or finishing later) is a
    miss within that window."""
    if horizon is not None and (req.t_finished is None
                                or req.t_finished > horizon):
        return False
    return slo.attained(req)


def finished_window_s(reqs: List[Request]) -> float:
    """First arrival -> last finish over finished requests: the legacy
    closed-loop duration fallback when no makespan is known. The ONE place
    this window is defined — it understates the serving window whenever
    work is still in flight, so callers with a makespan must pass it."""
    done = [r for r in reqs if r.t_finished is not None]
    if not done:
        return 1e-9
    return max(max(r.t_finished for r in done)
               - min(r.arrival for r in done), 1e-9)


def slo_attainment(reqs: List[Request], slo: SLO,
                   horizon: Optional[float] = None) -> float:
    """Fraction of requests meeting the SLO.

    Without a horizon: over finished requests only (the legacy closed-loop
    view). With a horizon: over every submitted request — a request still in
    flight at the horizon (or finishing after it) is an SLO miss, not a free
    pass (the worst violators are the ones that never finished)."""
    if horizon is None:
        pool = [r for r in reqs if r.t_finished is not None]
    else:
        pool = list(reqs)
    if not pool:
        return 0.0
    return sum(attained_by(r, slo, horizon) for r in pool) / len(pool)


def goodput_tok_s(reqs: List[Request], slo: SLO,
                  duration_s: Optional[float] = None,
                  horizon: Optional[float] = None) -> float:
    """Fleet goodput: generated tokens of SLO-attaining requests per second
    (tokens served outside the SLO are throughput, not goodput). Pass the
    run's actual makespan as ``duration_s`` — deriving the window from
    finished requests only shrinks the denominator while the tail is still
    being served, inflating goodput. With a ``horizon``, only requests
    finished by it contribute good tokens (same windowing as
    ``slo_attainment``)."""
    good = sum(r.generated for r in reqs if attained_by(r, slo, horizon))
    if duration_s is None:
        if not any(r.t_finished is not None for r in reqs):
            return 0.0
        duration_s = finished_window_s(reqs)
    return good / max(duration_s, 1e-9)


def latency_stats(vals: List[Optional[float]]) -> Dict[str, float]:
    """Summary stats over the defined (non-None) values: mean, true median
    (even-length lists average the two middle values), nearest-rank p95
    (the ceil(0.95 n)-th order statistic — NOT ``int(0.95 n)``, which lands
    on the max for n <= 20), and max. The one shared percentile helper —
    engine and cluster summaries must agree on what "p95" means."""
    s = sorted(v for v in vals if v is not None)
    if not s:
        return {"mean": 0.0, "p50": 0.0, "p95": 0.0, "max": 0.0}
    return {
        "mean": statistics.fmean(s),
        "p50": statistics.median(s),
        "p95": s[max(math.ceil(0.95 * len(s)) - 1, 0)],
        "max": s[-1],
    }


# ------------------------------------------------------- class-conditional SLO
SLOMap = Mapping[str, SLO]


def _as_slo_map(slo: Union[SLO, SLOMap]) -> Dict[str, SLO]:
    return dict(slo) if isinstance(slo, Mapping) else {"default": slo}


def class_slo_summary(reqs: List[Request], slos: Union[SLO, SLOMap],
                      duration_s: float,
                      horizon: Optional[float] = None) -> Dict:
    """Attainment + goodput, overall and per SLO class.

    ``slos`` maps class name -> SLO; a bare SLO means one class. Requests are
    bucketed by their ``slo_class`` tag (unknown/untagged requests fall into
    the first class, the default). Every request is judged against its own
    class's targets; the overall attainment is over all requests and the
    per-class goodputs sum to the overall goodput (same duration, disjoint
    buckets)."""
    table = _as_slo_map(slos)
    default = next(iter(table))
    buckets: Dict[str, List[Request]] = {name: [] for name in table}
    for r in reqs:
        buckets[r.slo_class if r.slo_class in table else default].append(r)

    classes = {}
    n_total = att_total = 0
    good_total = 0.0
    for name, slo in table.items():
        rs = buckets[name]
        pool = rs if horizon is not None \
            else [r for r in rs if r.t_finished is not None]
        att = sum(attained_by(r, slo, horizon) for r in pool)
        good = goodput_tok_s(rs, slo, duration_s, horizon=horizon)
        classes[name] = {
            "n": len(rs),
            "n_finished": sum(r.t_finished is not None for r in rs),
            "slo_attainment": att / len(pool) if pool else 0.0,
            "goodput_tok_s": good,
        }
        n_total += len(pool)
        att_total += att
        good_total += good
    return {
        "slo_attainment": att_total / n_total if n_total else 0.0,
        "goodput_tok_s": good_total,
        "classes": classes,
    }


@dataclasses.dataclass
class TimelinePoint:
    t: float
    running: int
    waiting: int
    kv_util: float
    kv_frag: float
    gen_tokens: int          # cumulative
    prefill_tokens: int      # cumulative
    preemptions: int         # cumulative
    hbm_busy: float = 0.0    # modeled fraction (sim mode)
    kv_pages_used: int = 0   # absolute page counts (repro.obs windows
    kv_pages_free: int = 0   # consume the stream without engine access)
    max_seqs: int = 0        # live concurrency cap (moves under autotune)


class MetricsLog:
    """Per-engine accounting, derived purely from the event spine.

    The engine subscribes this log to its ``repro.trace`` event stream at
    construction; every list here is a fold over that stream (``arrival`` /
    ``inject`` grow the submitted log, ``eject`` shrinks it — per-engine SLO
    accounting covers requests the engine is responsible for finishing —
    ``finish`` appends to ``finished``, ``step`` appends a
    ``TimelinePoint``). Nothing else may mutate this state (lint REP009)."""

    def __init__(self):
        self.timeline: List[TimelinePoint] = []
        self.submitted: List[Request] = []
        self.finished: List[Request] = []
        self.preemption_events: List[float] = []

    # ---- the one mutation path: the event stream -------------------------
    def on_event(self, ev):
        kind = ev.kind
        if kind == "arrival" or kind == "inject":
            # unfinished requests must be visible to the horizon-based SLO
            # accounting (they are misses, not omissions)
            self.submitted.append(ev.ref)
        elif kind == "eject":
            # the adopter records it on inject; fleet-level accounting
            # lives in ClusterMetrics
            if ev.ref in self.submitted:
                self.submitted.remove(ev.ref)
        elif kind == "finish":
            self.finished.append(ev.ref)
        elif kind == "preempt":
            self.preemption_events.append(ev.t)
        elif kind == "step":
            self.timeline.append(TimelinePoint(t=ev.t, **ev.payload))

    # ---- summaries ---------------------------------------------------------
    def summary(self, horizon: Optional[float] = None) -> Dict:
        reqs = self.finished
        gen_tokens = sum(r.generated for r in reqs)
        t_end = max((r.t_finished or 0.0) for r in reqs) if reqs else 0.0
        t_start = min(r.arrival for r in reqs) if reqs else 0.0
        dur = horizon or max(t_end - t_start, 1e-9)
        out = {
            "n_finished": len(reqs),
            "gen_tokens": gen_tokens,
            "gen_throughput_tok_s": gen_tokens / dur,
            "duration_s": dur,
            "ttft_s": latency_stats([r.ttft() for r in reqs]),
            "tpot_s": latency_stats([r.tpot() for r in reqs]),
            "e2e_s": latency_stats([r.e2e() for r in reqs]),
            "waiting_s": latency_stats([r.waiting_time() for r in reqs]),
            "preemptions": sum(r.n_preemptions for r in reqs),
            "recomputed_tokens": sum(r.recomputed_tokens for r in reqs),
            "peak_kv_util": max((p.kv_util for p in self.timeline), default=0.0),
            "mean_kv_util": statistics.fmean(
                [p.kv_util for p in self.timeline]) if self.timeline else 0.0,
        }
        return out

    def slo_summary(self, slo: Union[SLO, SLOMap],
                    duration_s: Optional[float] = None,
                    horizon: Optional[float] = None) -> Dict:
        """SLO attainment + goodput, per class and overall. With a horizon,
        submitted-but-unfinished requests count as misses and the horizon is
        the default duration."""
        reqs = self.submitted if (horizon is not None and self.submitted) \
            else self.finished
        if duration_s is None:
            if horizon is not None:
                t0 = min((r.arrival for r in reqs), default=0.0)
                duration_s = max(horizon - t0, 1e-9)
            else:
                duration_s = finished_window_s(reqs)
        return class_slo_summary(reqs, slo, duration_s, horizon=horizon)
