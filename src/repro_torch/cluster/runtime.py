"""Event-driven cluster runtime: many engines, one virtual clock.

Drives a heterogeneous fleet of `InferenceEngine` instances (possibly with
different `ParallelismPlan`s / `Hardware`) as a conservative discrete-event
simulation: each iteration advances the worker whose next action is earliest,
so worker clocks stay causally consistent and fleet-level timestamps
(arrival -> route -> admit -> first token -> migrate -> finish) are monotone
along every request's path.

Two serving modes:

  colocated     — every worker runs prefill+decode interleaved; new requests
                  are routed by a pluggable `RoutingPolicy` (the paper's DP
                  baseline, §V-B).
  disaggregated — prefill workers run chunked prefill only; on first token
                  the request is ejected, pays the modeled KV-transfer time
                  (`perf_model.kv_transfer_time` over the inter-node fabric),
                  and is adopted by a decode worker chosen by a
                  `DispatchPolicy` (§III phase divergence made structural).

Open-loop arrivals: the runtime holds the trace and routes each request when
the cluster clock reaches its arrival; engines additionally gate admission on
`arrival > now` (no scheduler sees a request from the future).

Elasticity: the pools are mutable mid-run. ``add_worker`` mints a replica
that joins its pool only after a modeled cold start (weight-shard load into
HBM, ``pm.weight_load_time``); ``retire_worker`` removes a replica from the
route/dispatch pools immediately but lets its in-flight requests finish
(graceful drain), stamping a decommission time so worker-second accounting
stays honest. An attached ``AutoscaleController`` ticks on the virtual clock
between fleet events; with no controller and no add/retire calls the event
loop is bit-identical to the static path.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.core import perf_model as pm
from repro_torch.core.admission import ClassPolicy
from repro_torch.core.request import Request
from repro_torch.cluster.arrivals import TraceEntry
from repro_torch.cluster.metrics import ClusterMetrics
from repro_torch.cluster.policies import (DispatchPolicy, RoutingPolicy,
                                    make_dispatcher, make_policy)
from repro_torch.cluster.rebalance import RebalancePolicy, make_rebalancer
from repro_torch.cluster.view import (FleetView, NoFeasibleWorker, StragglerTracker,
                                fleet_snapshot, snapshot)
from repro_torch.cluster.worker import Worker
from repro_torch.trace.events import EventEmitter, EventLog


@dataclasses.dataclass
class ClusterConfig:
    policy: Union[str, RoutingPolicy] = "memory_aware"
    dispatcher: Union[str, DispatchPolicy] = "least_headroom"
    transfer_dtype_bytes: int = 2     # KV wire format (fp8 transfer: 1)
    snapshot_every: int = 1
    # multi-tenant SLO classes: name -> urgency, consulted by routing and
    # dispatch (per-worker scheduling urgency lives in each EngineConfig)
    class_priorities: Dict[str, int] = dataclasses.field(default_factory=dict)
    name: str = ""                    # scenario name, surfaced in errors
    straggler_alpha: float = 0.2      # EWMA half-life of the straggler tracker
    # decode→decode rebalancing: a RebalancePolicy instance, a registry name
    # ("kv_pressure"), or None (disabled — the event loop is then
    # bit-identical to a fleet without the hook)
    rebalance: Union[None, str, RebalancePolicy] = None
    rebalance_every_s: float = 0.05   # how often the event loop consults it


class ClusterRuntime:
    def __init__(self, workers: Sequence[Worker],
                 cfg: Optional[ClusterConfig] = None,
                 autoscaler=None, sanitize: bool = False):
        if not workers:
            raise ValueError("cluster needs at least one worker")
        if not all(w.engine.virtual_clock for w in workers):
            raise ValueError("cluster co-simulation requires virtual-clock "
                             "engines (SimRunner)")
        self.workers = list(workers)
        names = [w.name for w in self.workers]
        if len(set(names)) != len(names):
            raise ValueError(f"worker names must be unique (metrics and "
                             f"migration records key on them): {names}")
        self.cfg = cfg or ClusterConfig()
        self.policy = self.cfg.policy if isinstance(self.cfg.policy,
                                                    RoutingPolicy) \
            else make_policy(self.cfg.policy)
        self.dispatcher = self.cfg.dispatcher \
            if isinstance(self.cfg.dispatcher, DispatchPolicy) \
            else make_dispatcher(self.cfg.dispatcher)
        # runtime-owned observation state: policies get it on the view
        self.straggler = StragglerTracker(alpha=self.cfg.straggler_alpha)
        self.rebalancer = self.cfg.rebalance \
            if isinstance(self.cfg.rebalance, RebalancePolicy) \
            else (make_rebalancer(self.cfg.rebalance)
                  if self.cfg.rebalance is not None else None)
        self._next_rebalance_check = float("-inf")

        self.prefill_pool = [w for w in self.workers if w.role == "prefill"]
        self.decode_pool = [w for w in self.workers if w.role == "decode"]
        self.colocated_pool = [w for w in self.workers
                               if w.role == "colocated"]
        self.disaggregated = bool(self.prefill_pool)
        if self.disaggregated and not self.decode_pool:
            raise ValueError("prefill workers need a decode pool to "
                             "migrate into")
        # new requests land on prefill workers (disaggregated) or on the
        # colocated fleet
        self.route_pool = self.prefill_pool if self.disaggregated \
            else self.colocated_pool
        if not self.route_pool:
            raise ValueError("no routable workers (prefill or colocated)")

        # request ids key allocator tables; migration moves requests between
        # engines, so the whole fleet shares one counter — seeded past any
        # rid an engine already issued before joining the cluster
        start = 1 + max((r for w in self.workers
                         for r in w.engine.issued_rids()), default=-1)
        self._rid_source = itertools.count(start)
        for w in self.workers:
            w.engine.adopt_rid_source(self._rid_source)

        self._arrivals: List = []          # (t, seq, TraceEntry) min-heap
        self._arr_seq = itertools.count()
        self._migrating: List[dict] = []   # in-flight KV transfers
        self._warming: List[Worker] = []   # minted, weight load in progress
        self._retire_requested: Dict[str, float] = {}
        self.autoscaler = autoscaler       # optional AutoscaleController
        self._classes = ClassPolicy(priority=dict(self.cfg.class_priorities))
        # the fleet event stream: every worker engine's stream forwards into
        # it, and the runtime emits its own fleet-level transitions (worker
        # lifecycle, migrations in flight, scaling decisions, run end) with
        # explicit fleet-clock timestamps. ClusterMetrics is a subscriber —
        # its scaling/migration/submitted records are derivations, not a
        # second bookkeeping path.
        self.events = EventLog()
        self.emitter = EventEmitter(self.events, clock=lambda: self.makespan)
        for w in self.workers:
            w.engine.events.subscribe(self.events.emit)
        self.submitted: List[Request] = []
        self.metrics = ClusterMetrics(self.workers, submitted=self.submitted)
        self.events.subscribe(self.metrics.on_event)
        # dynamic invariant checks (repro_torch.lint.sanitizer) every loop
        # iteration; read-only, so metrics stay bit-identical
        self._sanitizer = None
        if sanitize:
            from repro_torch.lint.sanitizer import ClusterSanitizer
            self._sanitizer = ClusterSanitizer()
            self._sanitizer.attach(self)

    # ------------------------------------------------------------------- api
    @property
    def makespan(self) -> float:
        """The fleet clock: the latest worker time (the honest goodput
        denominator — finished-only windows ignore the in-flight tail)."""
        return max(w.engine.now for w in self.workers)

    def submit(self, isl: int, osl: int, arrival: float = 0.0,
               slo_class: str = ""):
        if self.disaggregated:
            cap = max(w.kv_view().capacity_tokens for w in self.decode_pool)
            if isl + osl + 1 > cap:
                raise ValueError(f"request ({isl} in, {osl} out) exceeds "
                                 f"largest decode-pool KV capacity {cap}")
            pcap = max(w.kv_view().capacity_tokens for w in self.prefill_pool)
            if isl + 2 > pcap:
                raise ValueError(f"request prompt ({isl} tokens) exceeds "
                                 f"largest prefill-pool KV capacity {pcap}")
        else:
            cap = max(w.kv_view().capacity_tokens for w in self.route_pool)
            if isl + osl + 1 > cap:
                raise ValueError(f"request ({isl} in, {osl} out) exceeds "
                                 f"largest worker KV capacity {cap}")
        heapq.heappush(self._arrivals,
                       (arrival, next(self._arr_seq),
                        TraceEntry(arrival, isl, osl, slo_class)))

    def submit_trace(self, trace: Sequence[TraceEntry]):
        for e in trace:
            self.submit(e.isl, e.osl, e.arrival, slo_class=e.slo_class)

    # ---------------------------------------------------------- decision plane
    def fleet_view(self, t: Optional[float] = None, *,
                   series: bool = True) -> FleetView:
        """One frozen, read-only observation of the whole fleet — what the
        autoscaler and the rebalancer decide on (``repro_torch.cluster.view``)."""
        return fleet_snapshot(self, t=t, series=series)

    # ------------------------------------------------------------- elasticity
    def _role_pool(self, role: str) -> List[Worker]:
        return {"prefill": self.prefill_pool, "decode": self.decode_pool,
                "colocated": self.colocated_pool}[role]

    def active_pool(self, role: str) -> List[Worker]:
        """The routable/dispatchable replicas of a role — excludes warming
        (weight load in progress) and draining workers. What a scaling
        policy sizes."""
        return list(self._role_pool(role))

    def warming_count(self, role: str) -> int:
        return sum(1 for w in self._warming if w.role == role)

    def add_worker(self, worker: Worker, at: Optional[float] = None,
                   cold_start_extra_s: float = 0.0) -> float:
        """Mint a replica mid-run. The worker is provisioned (and paid for,
        in worker-seconds) from ``at``, but joins its route/dispatch pool
        only after the modeled cold start: weight-shard load into HBM
        (``pm.weight_load_time``) plus ``cold_start_extra_s`` for checkpoint
        fetch / container spin-up. Returns the pool-entry time."""
        if any(w.name == worker.name for w in self.workers):
            raise ValueError(f"worker name {worker.name!r} already in fleet")
        if not worker.engine.virtual_clock:
            raise ValueError("cluster co-simulation requires virtual-clock "
                             "engines (SimRunner)")
        if worker.role == "prefill" and not self.disaggregated:
            raise ValueError("cannot add a prefill worker to a colocated "
                             "fleet (no decode pool to migrate into)")
        t = self.makespan if at is None else at
        r = worker.engine.runner
        load = pm.weight_load_time(worker.engine.cfg_model, r.plan, r.hw,
                                   r.dtype_bytes) + cold_start_extra_s
        worker.t_join = t
        worker.t_active = t + load
        worker.engine.adopt_rid_source(self._rid_source)
        self.workers.append(worker)
        self._warming.append(worker)
        # forward the minted engine's stream into the fleet log BEFORE the
        # mint event — its first engine event must not beat its lifecycle
        worker.engine.events.subscribe(self.events.emit)
        self.emitter.emit("mint", t=t, worker=worker.name, ref=worker,
                          role=worker.role, load_s=load,
                          pool_size=len(self._role_pool(worker.role)))
        return worker.t_active

    def retire_worker(self, worker: Optional[Worker] = None,
                      role: str = "colocated",
                      at: Optional[float] = None) -> Worker:
        """Gracefully retire a replica: it leaves the route/dispatch pools
        immediately (no new routes, dispatches or arrivals land on it) but
        keeps stepping until its in-flight requests finish; the drain
        completion stamps ``Worker.t_retire`` (never earlier than the
        retirement request) so per-worker accounting stays honest. With no
        explicit ``worker``, the emptiest replica of ``role`` is chosen
        (fastest drain)."""
        if worker is None:
            pool = self._role_pool(role)
            if not pool:
                raise ValueError(f"no active {role!r} workers to retire")
            vs = [snapshot(w) for w in pool]
            worker = pool[min(range(len(pool)),
                              key=lambda i: (vs[i].queue_depth,
                                             vs[i].kv_util))]
        pool = self._role_pool(worker.role)
        if worker not in pool:
            raise ValueError(f"worker {worker.name!r} is not in the active "
                             f"{worker.role!r} pool")
        if pool is self.route_pool and len(pool) == 1:
            raise ValueError("cannot retire the last routable worker")
        if pool is self.decode_pool and self.disaggregated and len(pool) == 1:
            raise ValueError("cannot retire the last decode worker of a "
                             "disaggregated fleet (migrations would wedge)")
        pool.remove(worker)
        worker.draining = True
        t = worker.engine.now if at is None else at
        self._retire_requested[worker.name] = t
        # an idle retiree has no drain to wait for: its clock may lag the
        # fleet (idle engines only advance on work) — bring it to the
        # decommission decision time before it goes dark
        if not worker.engine.has_work:
            worker.engine.advance_to(t)
        self.emitter.emit("retire", t=t, worker=worker.name, ref=worker,
                          role=worker.role, pool_size=len(pool))
        self._finish_retirements()
        return worker

    def _finish_retirements(self):
        for w in self.workers:
            if w.draining and w.t_retire is None and not w.engine.has_work:
                w.t_retire = max(w.engine.now,
                                 self._retire_requested.get(w.name, 0.0))
                # a reused name must not inherit the retiree's straggle EWMA
                self.straggler.forget(w.name)
                self.emitter.emit(
                    "drained", t=w.t_retire, worker=w.name, ref=w,
                    role=w.role, pool_size=len(self._role_pool(w.role)))

    def _activate_warming(self, upto: float):
        ready = sorted((w for w in self._warming
                        if w.t_active <= upto + 1e-12),
                       key=lambda w: w.t_active)
        for w in ready:
            self._warming.remove(w)
            w.engine.advance_to(w.t_active)
            pool = self._role_pool(w.role)
            pool.append(w)
            self.emitter.emit("join", t=w.t_active, worker=w.name, ref=w,
                              role=w.role, pool_size=len(pool))

    def _next_event_time(self) -> Optional[float]:
        """Earliest upcoming fleet event of any kind — worker actions,
        KV-transfer completions, unrouted arrivals, warming pool entries.
        The controller ticks up to (never past) this time."""
        ts = [t for t in (self._next_action_time(w) for w in self.workers)
              if t is not None]
        ts += [m["ready"] for m in self._migrating]
        ts += [w.t_active for w in self._warming]
        if self._arrivals:
            ts.append(self._arrivals[0][0])
        return min(ts, default=None)

    def _autoscale_ticks(self):
        """Fire every controller tick due before the fleet's next event, in
        order, on the virtual clock. Signal observation reads fleet state
        without advancing any engine clock, so a controller that takes no
        action leaves the simulation bit-identical to the static path."""
        a = self.autoscaler
        while True:
            ne = self._next_event_time()
            if ne is None or a.next_tick is None or a.next_tick > ne:
                return
            t = a.next_tick
            self._activate_warming(t)
            a.tick(self, t)

    def run(self, max_steps: int = 10 ** 7) -> ClusterMetrics:
        for _ in range(max_steps):
            if self.autoscaler is not None:
                self._autoscale_ticks()
            self._deliver_migrations()
            self._route_arrivals()
            if self.rebalancer is not None:
                self._tick_rebalance()
            w = self._next_worker()
            if w is None:
                if self._migrating:
                    # adopter pool saturated and idle: let the retry clock of
                    # the earliest transfer pull the fleet forward — unless
                    # an unrouted arrival is the earlier fleet event (the
                    # work it spawns may land on these idle workers first)
                    t = min(m["ready"] for m in self._migrating)
                    if self._arrivals and self._arrivals[0][0] < t:
                        continue                 # routing releases it next
                    for dw in self._adopter_pool():
                        if not dw.engine.sched.has_work:
                            dw.engine.advance_to(t)
                    self._deliver_migrations()
                    if self._next_worker() is None and not self._arrivals:
                        if self._migrating:      # truly wedged: no KV room
                            raise RuntimeError(
                                f"{len(self._migrating)} migrated requests "
                                "cannot fit any decode worker")
                    continue
                if self._arrivals:
                    continue                     # routing will gate-release
                break                            # fleet drained
            t0 = w.engine.now
            w.engine.step()
            if w in self.route_pool:
                self.straggler.note_step(w.name, w.engine.now - t0)
            if w.role == "prefill":
                self._harvest_prefill_complete(w)
            if w.draining:
                self._finish_retirements()
            if self._sanitizer is not None:
                self._sanitizer.check(self)
        # stamp the fleet makespan (via the stream: ClusterMetrics folds it
        # into t_end) so summaries use the true serving window and can count
        # still-in-flight requests as SLO misses
        self.emitter.emit("run_end", t=self.makespan)
        return self.metrics

    # ------------------------------------------------------------- internals
    def _next_action_time(self, w: Worker) -> Optional[float]:
        if w.engine.sched.has_work:
            return w.engine.now
        nxt = w.engine.next_arrival()
        if nxt is not None:
            return max(w.engine.now, nxt)
        return None

    def _next_worker(self) -> Optional[Worker]:
        best, best_t = None, None
        for w in self.workers:
            t = self._next_action_time(w)
            if t is not None and (best_t is None or t < best_t):
                best, best_t = w, t
        return best

    def _horizon(self) -> Optional[float]:
        """Earliest time anything already in the system acts next."""
        ts = [t for t in (self._next_action_time(w) for w in self.workers)
              if t is not None]
        ts += [m["ready"] for m in self._migrating]
        return min(ts, default=None)

    def _route_arrivals(self):
        while self._arrivals:
            t = self._arrivals[0][0]
            horizon = self._horizon()
            if horizon is not None and t > horizon:
                break                  # the future: in-flight work acts first
            _, _, entry = heapq.heappop(self._arrivals)
            if self._warming:
                # replicas whose cold start completed by this arrival are
                # routable for it
                self._activate_warming(entry.arrival)
            # a fresh view per route decision: the previous route's admission
            # and KV growth must be visible to this one (live-read semantics)
            views = [snapshot(w, straggler=self.straggler)
                     for w in self.route_pool]
            try:
                i = self.policy.pick(
                    views, entry.isl, entry.osl,
                    urgency=self._classes.normalized_urgency(entry.slo_class))
            except NoFeasibleWorker as e:
                raise e.with_context(scenario=self.cfg.name,
                                     arrival=entry.arrival,
                                     slo_class=entry.slo_class) from None
            # the engine's "arrival" event (forwarded into the fleet log)
            # lands the request in self.submitted via ClusterMetrics
            self.route_pool[i].engine.submit(
                entry.isl, entry.osl, arrival=entry.arrival,
                slo_class=entry.slo_class)

    def _harvest_prefill_complete(self, w: Worker):
        done = [r for r in w.engine.sched.running
                if r.prefill_done and r.generated >= 1]
        for req in done:
            w.engine.eject(req)
            hw = w.engine.runner.hw
            tt = pm.kv_transfer_time(w.engine.cfg_model, req.context_len, hw,
                                     self.cfg.transfer_dtype_bytes)
            self._migrating.append({
                "req": req, "src": w.name,
                "eject": w.engine.now, "ready": w.engine.now + tt,
            })
            # migration in flight: the pairing "inject" on the adopter closes
            # the MigrationRecord in ClusterMetrics
            self.emitter.emit("kv_transfer", rid=req.rid, ref=req,
                              t=w.engine.now, worker=w.name,
                              ready=w.engine.now + tt,
                              context_tokens=req.context_len)

    def _deliver_migrations(self):
        pending = sorted(self._migrating, key=lambda m: m["ready"])
        still = []
        while pending:
            m = pending.pop(0)
            req, ready = m["req"], m["ready"]
            # Delivering to an idle worker fast-forwards its clock to the
            # transfer completion — only allowed when that completion is the
            # fleet's NEXT event. The horizon is recomputed after every
            # delivery (adopting an earlier transfer advances the target's
            # clock and queues work on it, moving the fleet's next event) and
            # counts events engines can't see yet: transfers still awaiting a
            # slot this pass and unrouted arrivals — either can spawn an
            # earlier delivery to this idle worker, and a stale horizon would
            # burn the idle time that delivery should have used.
            hz = min([t for t in (self._next_action_time(w)
                                  for w in self.workers) if t is not None]
                     + [p["ready"] for p in pending]
                     + [s["ready"] for s in still]
                     + ([self._arrivals[0][0]] if self._arrivals else []),
                     default=float("inf"))
            remaining = req.max_new_tokens - req.generated
            # rebalance transfers are pinned to the destination the policy
            # chose; if it retired while the KV was in flight, fall back to
            # any peer but the (pressured) source
            cands = self._adopter_pool()
            pin = m.get("dst")
            if pin is not None:
                pinned = [dw for dw in cands if dw.name == pin]
                if not pinned:
                    pinned = [dw for dw in cands if dw.name != m["src"]]
                cands = pinned or cands
            views = [snapshot(dw, straggler=self.straggler) for dw in cands]
            eligible = [i for i, v in enumerate(views)
                        if req.context_len + remaining + 1
                        <= v.capacity_tokens
                        and (v.now >= ready
                             or (ready <= hz and not v.sched_has_work))]
            urgency = self._classes.normalized_urgency(req.slo_class)
            j = self.dispatcher.pick([views[i] for i in eligible], req,
                                     urgency=urgency) if eligible else None
            if j is None:
                still.append(m)
                continue
            target = cands[eligible[j]]
            target.engine.advance_to(ready)
            if not target.engine.inject(req):
                still.append(m)        # no KV/seq room yet: retry next tick
                continue
            # the adopter's "inject" event (just forwarded into the fleet
            # log) paired with the pending "kv_transfer" closes the
            # MigrationRecord in ClusterMetrics — no separate note here
        self._migrating = still

    def _adopter_pool(self) -> List[Worker]:
        """Who can adopt an in-flight migration: the decode pool, or — for
        decode→decode rebalancing on a colocated fleet — the colocated pool
        (disaggregated fleets always have a decode pool)."""
        return self.decode_pool if self.decode_pool else self.colocated_pool

    # ------------------------------------------------------------- rebalancing
    def _tick_rebalance(self):
        """Consult the rebalance policy on a fresh fleet view, rate-limited
        to ``cfg.rebalance_every_s`` of virtual time (the policy itself
        additionally enforces its decision cooldown)."""
        t = self.makespan
        if t < self._next_rebalance_check:
            return
        self._next_rebalance_check = t + self.cfg.rebalance_every_s
        decision = self.rebalancer.decide(self.fleet_view(t, series=False))
        if decision is not None:
            self._apply_rebalance(decision)

    def _apply_rebalance(self, d):
        """Actuate one RebalanceDecision: emit the ``rebalance`` event, eject
        the victim from the source, pay the modeled KV transfer, and enqueue
        a destination-pinned migration. Decisions are made on a frozen view;
        any that no longer match live state (victim finished, was preempted,
        or moved) are dropped — deciding is cheap, acting on stale state is
        not."""
        by_name = {w.name: w for w in self.workers}
        src, dst = by_name.get(d.src), by_name.get(d.dst)
        if src is None or dst is None or dst.draining:
            return
        req = next((r for r in src.engine.sched.running
                    if r.rid == d.rid), None)
        if req is None or not req.prefill_done or req.generated < 1:
            return
        t = src.engine.now
        self.emitter.emit("rebalance", rid=req.rid, ref=req, t=t,
                          worker=d.src, src=d.src, dst=d.dst,
                          kv_util=d.kv_util, reason=d.reason)
        src.engine.eject(req)
        hw = src.engine.runner.hw
        tt = pm.kv_transfer_time(src.engine.cfg_model, req.context_len, hw,
                                 self.cfg.transfer_dtype_bytes)
        self._migrating.append({
            "req": req, "src": d.src, "eject": t, "ready": t + tt,
            "dst": d.dst, "rebalance": True,
        })
        self.emitter.emit("kv_transfer", rid=req.rid, ref=req, t=t,
                          worker=d.src, ready=t + tt,
                          context_tokens=req.context_len)
