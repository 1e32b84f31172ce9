"""Engine sanitizer — dynamic event-loop invariants, checked every step.

A copy of ``repro.lint.sanitizer``'s ``EngineSanitizer``: a clock that
steps backwards, KV pages leaked or double-owned, a queue entry missing
from the submitted log. Every check is strictly read-only over engine
state, so a ``sanitize=True`` run produces metrics bit-identical to the
default path — the sanitizer observes, never steers. It reads only the
engine's scheduler, allocator and event stream, so it checks a real
(``TorchRunner``) engine as it checks a virtual-clock one.

Enable with ``EngineConfig(sanitize=True)``; violations raise
``SanitizerError`` at the step that broke the invariant, not thousands of
events later. The fleet-level ``ClusterSanitizer`` waits for the cluster
runtime.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.core.request import State


class SanitizerError(AssertionError):
    """An event-loop invariant broke. The message names the invariant and
    the state that contradicts it."""


def _fail(where: str, msg: str):
    raise SanitizerError(f"[{where}] {msg}")


class EngineSanitizer:
    """Per-engine invariants, checked after each ``step()``:

    - the virtual clock never moves backwards;
    - KV page conservation: free + held pages == pool size, every page
      owned exactly once;
    - only running requests hold page tables, and each table covers its
      request's used tokens;
    - running/waiting are duplicate-free and disjoint, with sane states;
    - the submitted log covers every queued/pending request (eject/inject
      keep the log consistent), finished requests stayed logged, and no
      rid was logged twice.

    The sanitizer is also a *subscriber* of the engine's event spine
    (``repro.trace``): it folds ``kv_alloc``/``kv_free`` into a page-count
    mirror and replays each rid's lifecycle (arrival -> admit -> preempt ->
    resume -> finish / eject / inject) as a state machine, failing at the
    first event that contradicts the stream's own history — a transition
    the stream missed (or double-emitted) shows up as a mirror/state
    divergence even when the engine state itself still looks consistent.
    """

    _LIFECYCLE_OK = {
        "admit": ("queued",),
        "resume": ("preempted",),
        "preempt": ("running",),
        "finish": ("running",),
    }

    def __init__(self, engine, name: str = "engine"):
        self.engine = engine
        self.name = name
        self._last_now: Optional[float] = None
        # stream mirrors, seeded from the allocator at attach time so an
        # engine sanitized mid-run (ClusterSanitizer attaches lazily) does
        # not misread pre-existing tables as stream divergence
        self._stream_pages: Dict[int, int] = {
            rid: len(t) for rid, t in engine.alloc._tables.items()}
        self._stream_state: Dict[int, str] = {}
        self._last_ev_t: Optional[float] = None
        engine.events.subscribe(self.on_event)

    def check(self):
        self._check_clock()
        self._check_kv_conservation()
        self._check_queues()
        self._check_submitted_log()
        # runs LAST: engine-state checks above report corruption with their
        # own (more specific) messages first
        self._check_stream_mirror()

    # --------------------------------------------------------- stream mirror
    def on_event(self, ev):
        if self._last_ev_t is not None and ev.t < self._last_ev_t - 1e-12:
            _fail(self.name, f"event stream clock moved backwards: "
                             f"{self._last_ev_t} -> {ev.t} ({ev.kind})")
        self._last_ev_t = ev.t
        kind, rid = ev.kind, ev.rid
        if kind == "kv_alloc":
            have = self._stream_pages.get(rid, 0) + ev.payload["pages"]
            self._stream_pages[rid] = have
            if have != ev.payload["held"]:
                _fail(self.name, f"kv_alloc stream mirror for rid {rid} has "
                                 f"{have} pages, event says "
                                 f"{ev.payload['held']}")
        elif kind == "kv_free":
            have = self._stream_pages.pop(rid, 0)
            if have != ev.payload["pages"]:
                _fail(self.name, f"kv_free of rid {rid} released "
                                 f"{ev.payload['pages']} pages, stream "
                                 f"mirror held {have}")
        elif kind == "arrival":
            self._stream_state[rid] = "queued"
        elif kind == "inject":
            self._stream_state[rid] = "running"
        elif kind == "eject":
            self._stream_state.pop(rid, None)
        elif kind in self._LIFECYCLE_OK:
            # lifecycle is replayed only for rids whose arrival/inject the
            # stream itself carried (attach-time in-flight rids are exempt)
            state = self._stream_state.get(rid)
            if state is not None:
                if state not in self._LIFECYCLE_OK[kind]:
                    _fail(self.name, f"stream lifecycle of rid {rid}: "
                                     f"{kind!r} while {state!r} (allowed "
                                     f"from {self._LIFECYCLE_OK[kind]})")
                self._stream_state[rid] = "preempted" \
                    if kind == "preempt" else "running"
                if kind == "finish":
                    del self._stream_state[rid]

    def _check_stream_mirror(self):
        actual = {rid: len(t)
                  for rid, t in self.engine.alloc._tables.items()}
        if self._stream_pages != actual:
            diff = {rid: (self._stream_pages.get(rid), actual.get(rid))
                    for rid in set(self._stream_pages) | set(actual)
                    if self._stream_pages.get(rid) != actual.get(rid)}
            _fail(self.name, f"KV stream mirror diverged from the allocator "
                             f"(rid: stream vs actual pages): {diff}")

    # ------------------------------------------------------------ invariants
    def _check_clock(self):
        now = self.engine.now
        if self._last_now is not None and now < self._last_now - 1e-12:
            _fail(self.name, f"virtual clock moved backwards: "
                             f"{self._last_now} -> {now}")
        self._last_now = now

    def _check_kv_conservation(self):
        alloc = self.engine.alloc
        held = sum(len(t) for t in alloc._tables.values())
        free = len(alloc._free)
        if free + held != alloc.n_pages:
            _fail(self.name, f"KV page leak: free({free}) + held({held}) "
                             f"!= pool({alloc.n_pages})")
        owners: Dict[int, str] = {}
        for p in alloc._free:
            if p in owners:
                _fail(self.name, f"page {p} appears twice in the free list")
            owners[p] = "free"
        for rid in sorted(alloc._tables):
            for p in alloc._tables[rid]:
                if p in owners:
                    _fail(self.name, f"page {p} double-owned: "
                                     f"{owners[p]} and rid {rid}")
                owners[p] = f"rid {rid}"
        for rid in sorted(alloc._tables):
            used = alloc._used_tokens.get(rid, 0)
            have = len(alloc._tables[rid])
            if alloc.pages_for(used) > have:
                _fail(self.name, f"rid {rid} uses {used} tokens but holds "
                                 f"only {have} pages "
                                 f"(needs {alloc.pages_for(used)})")

    def _check_queues(self):
        sched = self.engine.sched
        running = list(sched.running)
        waiting = list(sched.waiting)
        run_rids = [r.rid for r in running]
        wait_rids = [r.rid for r in waiting]
        if len(set(run_rids)) != len(run_rids):
            _fail(self.name, f"duplicate rids in running: {run_rids}")
        if len(set(wait_rids)) != len(wait_rids):
            _fail(self.name, f"duplicate rids in waiting: {wait_rids}")
        both = set(run_rids) & set(wait_rids)
        if both:
            _fail(self.name, f"rids both running and waiting: {sorted(both)}")
        for r in running:
            if r.state is not State.RUNNING:
                _fail(self.name, f"rid {r.rid} in running set with state "
                                 f"{r.state}")
        for r in waiting:
            if r.state not in (State.WAITING, State.PREEMPTED):
                _fail(self.name, f"rid {r.rid} in waiting queue with state "
                                 f"{r.state}")
        # only running requests may hold pages (waiting/preempted freed
        # theirs; finished/ejected freed on the way out)
        orphans = set(self.engine.alloc._tables) - set(run_rids)
        if orphans:
            _fail(self.name, f"page tables held by non-running rids: "
                             f"{sorted(orphans)}")
        for r in running:
            used = self.engine.alloc.tokens_of(r.rid)
            cap = r.isl + r.generated + 1
            if used > cap:
                _fail(self.name, f"rid {r.rid} KV tokens {used} exceed "
                                 f"context+1 ({cap})")

    def _check_submitted_log(self):
        m = self.engine.metrics
        sub_rids = [r.rid for r in m.submitted]
        sub_set = set(sub_rids)
        if len(sub_set) != len(sub_rids):
            dupes = sorted({r for r in sub_rids if sub_rids.count(r) > 1})
            _fail(self.name, f"rids submitted twice: {dupes}")
        queued = [*self.engine.sched.running, *self.engine.sched.waiting,
                  *(p[2] for p in self.engine._pending)]
        missing = [r.rid for r in queued if r.rid not in sub_set]
        if missing:
            _fail(self.name, f"queued rids missing from the submitted log "
                             f"(eject/inject accounting): {sorted(missing)}")
        fin_missing = [r.rid for r in m.finished if r.rid not in sub_set]
        if fin_missing:
            _fail(self.name, f"finished rids missing from the submitted "
                             f"log: {sorted(fin_missing)}")
