"""The unified decision plane: frozen, read-only fleet state snapshots.

The paper frames navigating the Capacity-Bound regime as a *decision*
problem — memory-aware routing, preemption-storm avoidance (Obs 3/4) and
scaling policy all hinge on an accurate, consistent view of per-replica KV
headroom, queue depth and straggler state. This module is the ONE place
that view is built: a :func:`snapshot` reads an engine's allocator and
scheduler exactly once per decision point and freezes the result into a
:class:`WorkerView`; :func:`fleet_snapshot` assembles the per-role
:class:`FleetView` the autoscaler and the rebalancer consume. Policies
(``repro.cluster.policies``), scaling signals (``repro.cluster.autoscale``)
and rebalancing (``repro.cluster.rebalance``) see ONLY these views — lint
rule REP010 rejects any ``engine``/``alloc``/``sched`` access in those
modules, so headroom math cannot silently fork again.

Views are snapshots, not live handles: construction never mutates engine
state (property-tested under the sim sanitizer), and a view taken before a
state change keeps reporting the old state. Decision sites therefore build
a fresh view per decision (route pop, migration delivery, controller tick),
which matches the live-read semantics the policies had before the refactor
bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.kv_cache import KVView
from repro_torch.core.request import Request


class NoFeasibleWorker(ValueError):
    """No worker in the candidate pool can structurally hold a request.

    Raised by :func:`eligible_indices` (and surfaced by ``ClusterRuntime``
    with the scenario name attached) instead of a bare ``ValueError``, so an
    infeasible heterogeneous-fleet route aborts with full request context:
    the request's shape, its rid when one was already minted, and every
    candidate's KV capacity."""

    def __init__(self, prompt_len: int, max_new: int,
                 capacities: Sequence[Tuple[str, int]], *,
                 rid: Optional[int] = None, slo_class: str = "",
                 arrival: Optional[float] = None, scenario: str = ""):
        self.prompt_len = prompt_len
        self.max_new = max_new
        self.capacities = tuple(capacities)
        self.rid = rid
        self.slo_class = slo_class
        self.arrival = arrival
        self.scenario = scenario
        super().__init__(self._message())

    def _message(self) -> str:
        who = f"request rid={self.rid}" if self.rid is not None else "request"
        ctx = f" of scenario {self.scenario!r}" if self.scenario else ""
        when = f" arriving at t={self.arrival}" if self.arrival is not None \
            else ""
        cls = f" [class {self.slo_class!r}]" if self.slo_class else ""
        caps = ", ".join(f"{name}={cap}" for name, cap in self.capacities)
        return (f"no worker{ctx} can hold a ({self.prompt_len} in, "
                f"{self.max_new} out) {who}{cls}{when} "
                f"(per-worker KV capacities in tokens: {caps})")

    def with_context(self, *, rid: Optional[int] = None, slo_class: str = "",
                     arrival: Optional[float] = None,
                     scenario: str = "") -> "NoFeasibleWorker":
        """A copy enriched with request/scenario context (the runtime knows
        the scenario name and arrival; the policy that raised does not)."""
        return NoFeasibleWorker(
            self.prompt_len, self.max_new, self.capacities,
            rid=self.rid if rid is None else rid,
            slo_class=self.slo_class or slo_class,
            arrival=self.arrival if arrival is None else arrival,
            scenario=self.scenario or scenario)


@dataclasses.dataclass(frozen=True)
class RequestView:
    """One queued/running request, as victim-choice and rebalancing see it.

    ``urgency`` is the owning engine's raw class urgency (the scheduler's
    preemption-victim currency), so cluster-level migration victim choice
    orders candidates exactly like engine-level preemption does."""
    rid: int
    slo_class: str
    urgency: int
    arrival: float
    isl: int
    generated: int
    context_len: int
    remaining: int                # max_new_tokens - generated
    prefill_done: bool


@dataclasses.dataclass(frozen=True)
class WorkerView:
    """Frozen snapshot of one worker at a decision point.

    Everything a routing/dispatch/rebalance/scaling decision may consult:
    KV occupancy and predicted peak demand, batch occupancy vs the
    concurrency cap, queue depth by SLO class, lifecycle flags, and the
    runtime-tracked straggler EWMA. All derived quantities (headroom,
    feasibility, candidate page demand) are pure functions of the frozen
    fields — reading a view cannot touch the engine it was taken from."""
    name: str
    role: str
    prefill_only: bool
    warming: bool
    draining: bool
    now: float
    has_work: bool                # engine-level: queued work OR gated arrivals
    sched_has_work: bool          # scheduler-level: waiting/running only
    kv: KVView
    kv_util: float
    predicted_used: float         # predicted peak pages of queued+running
    osl_est: float                # admission estimator's current OSL estimate
    n_running: int
    n_waiting: int
    max_seqs: int
    preemptions: int              # cumulative engine preemption count
    step_ewma: Optional[float]    # straggler EWMA (None: never observed)
    waiting_by_class: Tuple[Tuple[str, int], ...]
    running_reqs: Tuple[RequestView, ...]

    # ------------------------------------------------------- pure derivations
    @property
    def n_pages(self) -> int:
        return self.kv.n_pages

    @property
    def page_size(self) -> int:
        return self.kv.page_size

    @property
    def capacity_tokens(self) -> int:
        return self.kv.capacity_tokens

    @property
    def queue_depth(self) -> int:
        return self.n_waiting + self.n_running

    def pages_for(self, tokens: int) -> int:
        return self.kv.pages_for(tokens)

    def fits(self, prompt_len: int, max_new: int) -> bool:
        """Hard KV-capacity feasibility: a prefill-only worker needs just
        the prompt (+first token) to fit; everyone else the full context."""
        need = prompt_len + (1 if self.prefill_only else max_new) + 1
        return need <= self.capacity_tokens

    def predicted_headroom_pages(self) -> float:
        return self.kv.n_pages - self.predicted_used

    def candidate_pages(self, prompt_len: int, max_new: int) -> int:
        """Role-aware page demand of a prospective request: prefill workers
        hold only the prompt (+first token); others grow by the predicted
        OSL — the same accounting ``predicted_used`` applies to what is
        already queued."""
        future = 0
        if self.role != "prefill":
            future = int(min(self.osl_est, max_new))
        return self.kv.pages_for(prompt_len + future + 1)


@dataclasses.dataclass(frozen=True)
class FleetView:
    """Frozen snapshot of the whole fleet at one decision point.

    ``workers`` covers every provisioned replica (warming and draining
    included, flagged on their views); ``pools`` maps each role to the
    indices of its *active* (routable/dispatchable) members, in pool order.
    ``arrivals`` and ``finished`` carry the fleet-level series the scaling
    signals fold (arrival times of everything submitted or still queued
    upstream; finished requests in worker order)."""
    t: float
    workers: Tuple[WorkerView, ...]
    pools: Tuple[Tuple[str, Tuple[int, ...]], ...]
    arrivals: Tuple[float, ...] = ()
    finished: Tuple[Request, ...] = ()
    inflight_migrations: int = 0
    inflight_rebalances: int = 0

    def pool(self, role: str) -> Tuple[WorkerView, ...]:
        for r, idx in self.pools:
            if r == role:
                return tuple(self.workers[i] for i in idx)
        return ()

    def warming_count(self, role: str) -> int:
        return sum(1 for v in self.workers if v.warming and v.role == role)

    def worker(self, name: str) -> Optional[WorkerView]:
        for v in self.workers:
            if v.name == name:
                return v
        return None


@dataclasses.dataclass(frozen=True)
class RebalanceDecision:
    """One decode→decode migration a ``RebalancePolicy`` asks for: move
    running request ``rid`` from worker ``src`` to worker ``dst``.
    ``kv_util`` records the source pressure that triggered it and ``reason``
    a human-readable justification — both land in the ``rebalance`` event's
    payload for the trace."""
    rid: int
    src: str
    dst: str
    kv_util: float = 0.0
    reason: str = ""


@dataclasses.dataclass
class StragglerTracker:
    """Per-worker EWMA of engine step latency, keyed by worker NAME.

    Owned by the runtime (one observation per engine step of a routable
    worker) and published to policies through ``WorkerView.step_ewma`` —
    policies read the view, never this tracker. Name keys survive pool
    mutation; ``forget`` drops a retiree's history so a future replica
    reusing the name cannot inherit a dead worker's straggle."""
    alpha: float = 0.2

    def __post_init__(self):
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {self.alpha}")
        self._ewma: Dict[str, float] = {}

    def note_step(self, name: str, dt: float):
        prev = self._ewma.get(name)
        # first observation seeds the EWMA (no bias toward zero at warmup)
        self._ewma[name] = dt if prev is None \
            else (1 - self.alpha) * prev + self.alpha * dt

    def forget(self, name: str):
        self._ewma.pop(name, None)

    def get(self, name: str) -> Optional[float]:
        return self._ewma.get(name)


# ------------------------------------------------------------- construction
def snapshot(worker, *, straggler: Optional[StragglerTracker] = None,
             warming: bool = False) -> WorkerView:
    """Build a :class:`WorkerView` from a live ``Worker``. The ONLY place
    (besides :class:`KVView.of`) that reads ``engine.alloc``/``engine.sched``
    on behalf of a decision — everything downstream is frozen."""
    e = worker.engine
    sched = e.sched
    alloc = e.alloc
    est = sched.admission.estimator
    osl_est = est._est if est._est is not None else est.prior
    urg = sched.admission.classes.urgency
    grow = worker.role != "prefill"

    def peak_pages(r: Request) -> int:
        # predicted PEAK context of an in-flight request: prompt + max of
        # (predicted OSL, already generated) — identical to the KV-aware
        # admission accounting, so router and admission agree on saturation
        future = max(min(osl_est, r.max_new_tokens), r.generated) if grow \
            else r.generated
        return alloc.pages_for(r.isl + int(future) + 1)

    predicted = sum(peak_pages(r) for r in sched.running)
    predicted += sum(peak_pages(r) for r in sched.waiting)

    by_class: Dict[str, int] = {}
    for r in sched.waiting:
        by_class[r.slo_class] = by_class.get(r.slo_class, 0) + 1

    running_reqs = tuple(
        RequestView(rid=r.rid, slo_class=r.slo_class,
                    urgency=urg(r.slo_class), arrival=r.arrival, isl=r.isl,
                    generated=r.generated, context_len=r.context_len,
                    remaining=r.max_new_tokens - r.generated,
                    prefill_done=r.prefill_done)
        for r in sched.running)

    return WorkerView(
        name=worker.name, role=worker.role,
        prefill_only=sched.cfg.prefill_only, warming=warming,
        draining=worker.draining, now=e.now, has_work=e.has_work,
        sched_has_work=sched.has_work,
        kv=KVView.of(alloc), kv_util=alloc.utilization(),
        predicted_used=predicted, osl_est=osl_est,
        n_running=len(sched.running), n_waiting=len(sched.waiting),
        max_seqs=sched.cfg.max_num_seqs, preemptions=sched.n_preemptions,
        step_ewma=straggler.get(worker.name) if straggler else None,
        waiting_by_class=tuple(sorted(by_class.items())),
        running_reqs=running_reqs)


def fleet_snapshot(rt, t: Optional[float] = None, *,
                   series: bool = True) -> FleetView:
    """Build a :class:`FleetView` from a live ``ClusterRuntime`` — one
    consistent observation of every replica, the role pools, the upstream
    arrival series and the in-flight migration counts. ``series=False``
    skips the fleet-level arrival/finished tuples (they grow with the run;
    the rebalance hot path only reads per-worker state)."""
    views = tuple(snapshot(w, straggler=rt.straggler,
                           warming=w in rt._warming) for w in rt.workers)
    index = {w.name: i for i, w in enumerate(rt.workers)}
    pools = tuple(
        (role, tuple(index[w.name] for w in rt._role_pool(role)))
        for role in ("prefill", "decode", "colocated"))
    arrivals: Tuple[float, ...] = ()
    finished: Tuple[Request, ...] = ()
    if series:
        arrivals = tuple(r.arrival for r in rt.submitted) \
            + tuple(ta for (ta, _, _) in rt._arrivals)
        finished = tuple(r for w in rt.workers
                         for r in w.engine.metrics.finished)
    n_rebal = sum(1 for m in rt._migrating if m.get("rebalance"))
    return FleetView(
        t=rt.makespan if t is None else t, workers=views, pools=pools,
        arrivals=arrivals, finished=finished,
        inflight_migrations=len(rt._migrating),
        inflight_rebalances=n_rebal)


# -------------------------------------------------------------- feasibility
def eligible_indices(views: Sequence[WorkerView], prompt_len: int,
                     max_new: int) -> List[int]:
    """Views that can hold the request at all — policies must not route to
    a worker whose pool is structurally too small (heterogeneous fleets), or
    the engine's fits-alone invariant breaks mid-run. Raises the typed
    :class:`NoFeasibleWorker` when the pool has no candidate."""
    idx = [i for i, v in enumerate(views) if v.fits(prompt_len, max_new)]
    if not idx:
        raise NoFeasibleWorker(
            prompt_len, max_new,
            [(v.name, v.capacity_tokens) for v in views])
    return idx
