"""The event spine: one typed, ordered record of everything that happens.

Every state transition in the engine, scheduler, allocator, cluster runtime
and autoscaler is emitted exactly once, from the one place that performs it,
as a frozen :class:`Event` on an :class:`EventLog`. Everything downstream —
``MetricsLog`` timelines, ``ClusterMetrics`` scaling/migration records, the
sim sanitizer's mirrors, the JSONL trace writer — is a *subscriber*: pure
derivations of the stream, never independent bookkeeping. Two runs of one
``Scenario`` + seed must produce identical streams (``repro.trace diff``),
which is a strictly stronger guarantee than summary-identical.

Emission is push-based and unbuffered: the log fans each event out to its
subscribers at emit time and, by default, retains nothing (recording is
opt-in via ``EventLog(record=True)`` / ``enable_recording()``), so the spine
adds no per-run memory unless a trace is actually wanted.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

# Every transition the spine records. One emission site per kind:
#
#   arrival       engine.submit            request entered an engine's log
#   admit         scheduler admission      WAITING request became RUNNING
#   resume        scheduler admission      PREEMPTED request re-admitted
#   prefill       engine step              one executed prefill chunk
#   decode_step   engine step              one decode batch (rids list)
#   preempt       scheduler._preempt       victim freed + requeued (recompute)
#   eject         engine.eject             request left an engine unfinished
#   inject        engine.inject            migrated request adopted (success)
#   finish        engine step              request completed, left the engine
#   kv_alloc      allocator.grow           pages added to a rid's table
#   kv_free       allocator.free           a rid's table released
#   step          engine step              telemetry snapshot (TimelinePoint)
#   mint          runtime.add_worker       replica provisioned, cold start on
#   join          runtime (warm-up done)   replica entered its pool
#   retire        runtime.retire_worker    replica left the pools, draining
#   drained       runtime (drain done)     replica went dark, t_retire stamped
#   scale_decision autoscaler.tick         controller resolved a nonzero delta
#   kv_transfer   runtime (harvest)        migration in flight (src, ready)
#   rebalance     runtime (rebalance tick) decode→decode migration decided
#                                          (src pressure, dst, victim rid)
#   run_end       runtime.run              fleet drained, makespan stamped
KINDS = (
    "arrival", "admit", "resume", "prefill", "decode_step", "preempt",
    "eject", "inject", "finish", "kv_alloc", "kv_free", "step",
    "mint", "join", "retire", "drained", "scale_decision", "kv_transfer",
    "rebalance", "run_end",
)
_KIND_SET = frozenset(KINDS)


@dataclasses.dataclass(frozen=True)
class Event:
    """One transition: when, what, to whom, where, with what details.

    ``payload`` holds plain scalars (and lists of scalars) only — the event
    must serialise to JSONL and compare bit-exactly across runs. ``ref`` is
    the live ``Request`` (or ``Worker``) the transition acted on, carried for
    in-process subscribers (the metrics consumers need the object, not a
    copy); it is excluded from equality, repr and serialisation."""
    t: float
    kind: str
    rid: Optional[int] = None
    worker: str = ""
    payload: Dict[str, Any] = dataclasses.field(default_factory=dict)
    ref: Any = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        if self.kind not in _KIND_SET:
            raise ValueError(f"unknown event kind {self.kind!r} "
                             f"(have {KINDS})")

    def to_dict(self) -> Dict[str, Any]:
        """JSONL row — everything except the live ``ref``."""
        return {"t": self.t, "kind": self.kind, "rid": self.rid,
                "worker": self.worker, "payload": self.payload}


class EventLog:
    """Ordered fan-out point for one stream (an engine's, or the fleet's).

    Subscribers are called synchronously in subscription order at emit time
    — the stream IS the ordering, so consumers see transitions exactly as
    they happened. ``events`` is populated only when recording (memory stays
    O(1) on the default path). An engine log can forward into a fleet log by
    subscribing the fleet log's ``emit``."""

    def __init__(self, record: bool = False):
        self.events: Optional[List[Event]] = [] if record else None
        self._subs: List[Callable[[Event], None]] = []

    @property
    def recording(self) -> bool:
        return self.events is not None

    def enable_recording(self):
        if self.events is None:
            self.events = []

    def subscribe(self, fn: Callable[[Event], None]):
        self._subs.append(fn)

    def unsubscribe(self, fn: Callable[[Event], None]):
        self._subs.remove(fn)

    def emit(self, ev: Event):
        if self.events is not None:
            self.events.append(ev)
        for fn in self._subs:
            fn(ev)


class EventEmitter:
    """The one sanctioned way to put an event on a log.

    Bound to a clock (the owning engine's ``now``, or the fleet makespan)
    and a worker name, so emission sites stay one-liners:
    ``emitter.emit("preempt", rid=r.rid, generated=r.generated)``. The
    worker name is stamped by ``Worker.__post_init__`` — a standalone engine
    emits with an empty name."""

    def __init__(self, log: EventLog, clock: Callable[[], float],
                 worker: str = ""):
        self.log = log
        self.clock = clock
        self.worker = worker

    def emit(self, kind: str, rid: Optional[int] = None, ref: Any = None,
             t: Optional[float] = None, worker: Optional[str] = None,
             **payload) -> Event:
        # ``worker`` overrides the bound name: fleet-level emitters stamp the
        # SUBJECT replica on lifecycle events (mint/join/retire/drained),
        # not the emitting fleet
        ev = Event(t=self.clock() if t is None else t, kind=kind, rid=rid,
                   worker=self.worker if worker is None else worker,
                   payload=payload, ref=ref)
        self.log.emit(ev)
        return ev
