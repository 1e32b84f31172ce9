"""Request spans: fold a ``repro_torch.trace`` event stream into an exact
per-request latency decomposition.

Every request's end-to-end latency is partitioned into the six phases of its
lifecycle (the span taxonomy of docs/obs.md):

  queue_wait        arrival -> first admission (the request sits in the
                    waiting queue; KV-throttled admission shows up here)
  prefill           admission -> first decode participation (chunked prompt
                    processing, including the completing chunk's token)
  decode            steady-state token generation
  preempted_stall   preempt -> resume (KV pages evicted, request requeued)
  recompute_resume  resume -> decode re-entry (the regenerated prefix is
                    re-prefilled — pure waste, the cost of recompute-mode
                    preemption)
  kv_transfer       eject -> inject (disaggregated migration: modeled wire
                    time plus any wait for a decode slot)

**Exactness guarantee.** Phase boundaries are event timestamps; durations
are accumulated as exact rationals (``fractions.Fraction`` of the IEEE-754
doubles), so the per-span sum telescopes *exactly* to
``t_finished - arrival`` with zero floating-point drift: ``Span.total_s``
(the correctly-rounded float of the exact sum) equals the float subtraction
``t_finished - arrival`` to the last ulp, because IEEE subtraction is itself
correctly rounded. Tests assert both identities on every finished request of
colocated, disaggregated and autoscaled runs.

The fold is a pure stream consumer (REP009-clean): subscribe ``on_event`` to
a live ``EventLog``, or feed it recorded ``Event`` objects / JSONL dict rows
post-hoc — it never touches engine or metrics state.
"""
from __future__ import annotations

import dataclasses
from fractions import Fraction
from typing import Any, Dict, List, Optional, Union

PHASES = ("queue_wait", "prefill", "decode", "preempted_stall",
          "recompute_resume", "kv_transfer")


def as_row(ev: Union[Any, Dict[str, Any]]) -> Dict[str, Any]:
    """Normalise an ``Event`` object or a loaded JSONL dict to one shape."""
    if isinstance(ev, dict):
        return ev
    return ev.to_dict()


@dataclasses.dataclass(frozen=True)
class Segment:
    """One contiguous interval of a span, attributed to a phase and the
    worker the request occupied during it (the Perfetto Gantt row source)."""
    phase: str
    t0: float
    t1: float
    worker: str


@dataclasses.dataclass
class Span:
    """One request's folded lifecycle."""
    rid: int
    arrival: float
    slo_class: str = ""
    isl: int = 0
    t_finished: Optional[float] = None
    generated: int = 0
    n_preemptions: int = 0
    workers: List[str] = dataclasses.field(default_factory=list)
    segments: List[Segment] = dataclasses.field(default_factory=list)
    # exact per-phase durations (Fractions of the boundary doubles)
    phase_fracs: Dict[str, Fraction] = dataclasses.field(
        default_factory=lambda: {p: Fraction(0) for p in PHASES})

    @property
    def finished(self) -> bool:
        return self.t_finished is not None

    @property
    def phases(self) -> Dict[str, float]:
        """Per-phase seconds (floats, for reporting). Summing these floats
        can drift by ulps; use ``total_s`` for the exact total."""
        return {p: float(f) for p, f in self.phase_fracs.items()}

    @property
    def exact_total(self) -> Fraction:
        """Exact rational sum of the phase durations — telescopes to
        ``Fraction(t_finished) - Fraction(arrival)`` by construction."""
        return sum(self.phase_fracs.values(), Fraction(0))

    @property
    def total_s(self) -> float:
        """The exact total, correctly rounded to a double: equals the float
        subtraction ``t_finished - arrival`` to the last ulp."""
        return float(self.exact_total)


class _OpenSpan:
    __slots__ = ("span", "phase", "t_cur", "worker")

    def __init__(self, span: Span, t0: float, worker: str):
        self.span = span
        self.phase = "queue_wait"
        self.t_cur = t0
        self.worker = worker


class SpanFold:
    """Stream subscriber folding per-rid events into :class:`Span` rows.

    ``spans`` holds finished requests in finish order; ``open_spans`` the
    still-in-flight ones (a truncated trace leaves them open — the report
    counts them as unfinished, never silently drops them). A rid reused
    after a ``finish`` (concatenated benchmark traces) starts a new span.
    """

    def __init__(self):
        self.spans: List[Span] = []
        self._open: Dict[int, _OpenSpan] = {}

    @property
    def open_spans(self) -> List[Span]:
        return [o.span for o in self._open.values()]

    # ------------------------------------------------------------- the fold
    def on_event(self, ev):
        row = as_row(ev)
        kind = row["kind"]
        if kind == "decode_step":
            t = row["t"]
            for rid in row["payload"]["rids"]:
                o = self._open.get(rid)
                if o is not None and o.phase != "decode":
                    self._transition(o, t, "decode", row["worker"])
            return
        rid = row.get("rid")
        if rid is None:
            return
        t, worker, payload = row["t"], row["worker"], row["payload"]
        if kind == "arrival":
            arr = payload.get("arrival", t)
            span = Span(rid=rid, arrival=arr,
                        slo_class=payload.get("slo_class", ""),
                        isl=payload.get("isl", 0), workers=[worker])
            self._open[rid] = _OpenSpan(span, arr, worker)
        elif kind == "admit":
            self._on(rid, t, "prefill", worker)
        elif kind == "resume":
            self._on(rid, t, "recompute_resume", worker)
        elif kind == "preempt":
            self._on(rid, t, "preempted_stall", worker)
            o = self._open.get(rid)
            if o is not None:
                o.span.n_preemptions += 1
        elif kind == "eject":
            self._on(rid, t, "kv_transfer", worker)
        elif kind == "inject":
            # prefill-complete by construction: the adopter decodes next
            self._on(rid, t, "decode", worker)
            o = self._open.get(rid)
            if o is not None and worker not in o.span.workers:
                o.span.workers.append(worker)
        elif kind == "finish":
            o = self._open.pop(rid, None)
            if o is None:
                return
            self._close(o, t)
            o.span.t_finished = t
            o.span.generated = payload.get("generated", 0)
            self.spans.append(o.span)

    # ------------------------------------------------------------ internals
    def _on(self, rid: int, t: float, phase: str, worker: str):
        o = self._open.get(rid)
        if o is not None:
            self._transition(o, t, phase, worker)

    def _transition(self, o: _OpenSpan, t: float, phase: str, worker: str):
        self._close(o, t)
        o.phase = phase
        o.t_cur = t
        o.worker = worker

    def _close(self, o: _OpenSpan, t: float):
        o.span.phase_fracs[o.phase] += Fraction(t) - Fraction(o.t_cur)
        if t > o.t_cur:      # zero-width segments add nothing to the Gantt
            o.span.segments.append(
                Segment(phase=o.phase, t0=o.t_cur, t1=t, worker=o.worker))


def fold_spans(events) -> SpanFold:
    """Post-hoc fold over recorded events (``Event`` objects or JSONL dict
    rows)."""
    fold = SpanFold()
    for ev in events:
        fold.on_event(ev)
    return fold
