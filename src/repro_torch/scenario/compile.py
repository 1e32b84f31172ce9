"""Compile a ``Scenario`` to its three fidelities.

All three compilers run the same resolution pass (``resolve``): model name ->
``ModelConfig``, hardware/workload names -> objects, and per-group engine
capacity defaults (``n_pages`` from ``pm.kv_capacity_tokens`` when unset,
role-default admission). That single pass is what keeps the fidelities
consistent — the planner's per-replica KV capacity is the engine's page pool
is the cluster workers' page pool, so disagreements between fidelities are
model error, never plumbing drift.
"""
from __future__ import annotations

import dataclasses
import statistics
from typing import List, Optional, Tuple

from repro_torch.core import perf_model as pm
from repro_torch.core import planner
from repro_torch.core.engine import InferenceEngine
from repro_torch.cluster.worker import (Worker, default_admission, default_n_pages,
                                        make_sim_worker)
from repro_torch.data.reasoning import WorkloadSpec
from repro_torch.scenario.spec import HARDWARE, Scenario, WorkerGroup, _lookup


# ------------------------------------------------------------------ resolve
@dataclasses.dataclass(frozen=True)
class ResolvedGroup:
    group: WorkerGroup
    hardware: pm.Hardware
    n_pages: int                  # concrete page pool per worker
    admission: str                # concrete admission mode
    kv_capacity_tokens: int       # n_pages * page_size

    @property
    def plan(self) -> pm.ParallelismPlan:
        return self.group.plan


@dataclasses.dataclass(frozen=True)
class Resolved:
    scenario: Scenario
    model: object                 # ModelConfig
    workload: WorkloadSpec
    groups: Tuple[ResolvedGroup, ...]


def resolve(sc: Scenario) -> Resolved:
    cfg = sc.model.resolve()
    workload = sc.traffic.workload_spec()
    groups = []
    for g in sc.fleet:
        hw = _lookup(HARDWARE, g.hardware, "hardware")
        n_pages = g.n_pages
        if n_pages is None:
            n_pages = default_n_pages(cfg, g.plan, hw, sc.model.dtype_bytes,
                                      g.page_size, sc.model.cache_dtype_bytes)
        admission = g.admission if g.admission is not None \
            else default_admission(g.role)
        groups.append(ResolvedGroup(
            group=g, hardware=hw, n_pages=n_pages, admission=admission,
            kv_capacity_tokens=n_pages * g.page_size))
    return Resolved(scenario=sc, model=cfg, workload=workload,
                    groups=tuple(groups))


def aggregate_plan(sc: Scenario) -> pm.ParallelismPlan:
    """The fleet as one planner-space plan (homogeneous colocated fleets:
    ``count`` replicas fold into the DP degree)."""
    if len(sc.fleet) != 1:
        raise ValueError(
            f"scenario {sc.name!r} has {len(sc.fleet)} worker groups; an "
            "aggregate plan is only defined for a single colocated group")
    g = sc.fleet[0]
    return dataclasses.replace(g.plan, dp=g.count * g.plan.dp)


# -------------------------------------------------------------------- trace
def _process(sc: Scenario):
    from repro_torch.cluster.arrivals import (GammaProcess, PiecewiseRateProcess,
                                              PoissonProcess, TraceProcess)
    t = sc.traffic
    if t.process == "closed":
        return TraceProcess((0.0,) * t.n_requests)
    if t.process == "poisson":
        return PoissonProcess(rate=t.rate)
    if t.process == "gamma":
        return GammaProcess(rate=t.rate, cv=t.cv)
    if t.process == "piecewise":
        return PiecewiseRateProcess(phases=t.phases)
    return TraceProcess(t.arrivals)


def trace(sc: Scenario):
    """The scenario's workload as replayable ``TraceEntry`` rows. Lengths
    depend only on (workload, n_requests, osl_cap, seed) — never on the
    arrival process — so fidelities and fleet variants see identical work.
    Entries are tagged with SLO classes from ``traffic.class_mix``
    (deterministic in the seed; class priorities never change the tagging,
    so class-aware and class-blind variants see the same tiered trace); a
    single-class scenario tags everything with its default class."""
    from repro_torch.cluster.arrivals import assign_classes, make_trace
    t = sc.traffic
    entries = make_trace(_process(sc), sc.traffic.workload_spec(),
                         t.n_requests, seed=t.seed, osl_cap=t.osl_cap)
    if t.class_mix:
        return assign_classes(entries, t.class_mix, seed=t.seed + 2)
    if sc.slos:
        default = sc.slos[0].name
        return [dataclasses.replace(e, slo_class=default) for e in entries]
    return entries


def requests(sc: Scenario) -> List[Tuple[int, int]]:
    """Closed-loop view of the trace: just the (isl, osl) pairs."""
    return [(e.isl, e.osl) for e in trace(sc)]


# ----------------------------------------------------------- fidelity 1: plan
def _reference_group(r: Resolved) -> ResolvedGroup:
    """The group whose replicas hold steady-state decode concurrency — what
    the planner's Workload/capacity statistics must describe. Prefill-only
    groups never grow KV, so the first decode-capable group wins (a
    disaggregated spec's prefill group would otherwise silently cap every
    candidate plan's concurrency)."""
    return next((rg for rg in r.groups if rg.group.role != "prefill"),
                r.groups[0])


def _kv_cap_override(rg: ResolvedGroup) -> Optional[int]:
    return rg.kv_capacity_tokens if rg.group.n_pages is not None else None


def planner_workload(sc: Scenario) -> planner.Workload:
    """The traffic spec reduced to the planner's sufficient statistics,
    measured on the scenario's *actual* trace (same seed, same caps)."""
    entries = trace(sc)
    return planner.Workload(
        n_requests=sc.traffic.n_requests,
        mean_isl=statistics.fmean(e.isl for e in entries),
        mean_osl=statistics.fmean(e.osl for e in entries),
        max_num_seqs=_reference_group(resolve(sc)).group.max_seqs)


def to_plan(sc: Scenario, n_devices: Optional[int] = None
            ) -> List[planner.PlanEstimate]:
    """Rank parallelism plans for the scenario's device budget (analytical
    fidelity). Hardware comes from the reference (decode-capable) group. An
    explicit ``n_pages`` on that group pins per-replica KV capacity for every
    candidate plan — the planner then ranks plans under the same page pool
    the engine/cluster fidelities actually allocate."""
    r = resolve(sc)
    g = _reference_group(r)
    return planner.plan(r.model, g.hardware, n_devices or sc.n_devices,
                        planner_workload(sc), sc.model.dtype_bytes,
                        cache_dtype_bytes=sc.model.cache_dtype_bytes,
                        kv_cap_tokens=_kv_cap_override(g))


def estimate_fleet(sc: Scenario) -> planner.PlanEstimate:
    """Planner estimate of the scenario's own (single-group) fleet, evaluated
    directly — exact even when the fleet's plan is outside
    ``candidate_plans``' ep=tp sweep (e.g. a custom ep)."""
    r = resolve(sc)
    g = r.groups[0]
    return planner.estimate(r.model, aggregate_plan(sc), g.hardware,
                            planner_workload(sc), sc.model.dtype_bytes,
                            cache_dtype_bytes=sc.model.cache_dtype_bytes,
                            kv_cap_tokens=_kv_cap_override(g))


# --------------------------------------------------------- fidelity 2: engine
def _build_worker(r: Resolved, rg: ResolvedGroup, name: str = "",
                  sanitize: bool = False) -> Worker:
    g = rg.group
    sc = r.scenario
    return make_sim_worker(
        r.model, g.plan, rg.hardware, role=g.role, name=name,
        n_pages=rg.n_pages, page_size=g.page_size, max_seqs=g.max_seqs,
        max_batched_tokens=g.max_batched_tokens, chunk_size=g.chunk_size,
        admission=rg.admission, autotune=g.autotune,
        dtype_bytes=sc.model.dtype_bytes,
        cache_dtype_bytes=sc.model.cache_dtype_bytes,
        class_priorities=sc.class_priorities(),
        class_kv_headroom=sc.class_kv_headroom,
        sanitize=sanitize)


def to_engine(sc: Scenario, group: int = 0,
              sanitize: bool = False) -> InferenceEngine:
    """One representative virtual-clock replica of ``fleet[group]`` (engine
    fidelity: real scheduler/allocator dynamics, no fleet effects).
    ``sanitize=True`` turns on per-step invariant checks
    (repro_torch.lint.sanitizer) — read-only, metrics stay bit-identical."""
    r = resolve(sc)
    return _build_worker(r, r.groups[group], sanitize=sanitize).engine


# -------------------------------------------------------- fidelity 3: cluster
def to_cluster(sc: Scenario, sanitize: bool = False):
    """The full fleet: every worker of every group, wired to the scenario's
    routing/dispatch policies and KV-transfer wire format. A spec with an
    ``autoscaler`` gets an ``AutoscaleController`` whose worker factory mints
    replicas from the scaled role's (resolved) group — same capacity, same
    admission, fresh monotonic names continuing the group's numbering.
    ``sanitize=True`` checks fleet + engine invariants every loop iteration
    (repro_torch.lint.sanitizer, covers autoscale-minted workers too) — read-only,
    metrics stay bit-identical."""
    from repro_torch.cluster.autoscale import make_autoscaler
    from repro_torch.cluster.runtime import ClusterConfig, ClusterRuntime
    r = resolve(sc)
    workers = []
    for rg in r.groups:
        prefix = rg.group.prefix or rg.group.role
        for i in range(rg.group.count):
            workers.append(_build_worker(r, rg, name=f"{prefix}{i}"))
    rebalance = None
    rebalance_every = ClusterConfig.rebalance_every_s
    if sc.rebalance is not None:
        from repro_torch.cluster.rebalance import make_rebalancer
        rb = sc.rebalance
        rebalance = make_rebalancer(
            rb.policy, kv_high=rb.kv_high, dst_headroom=rb.dst_headroom,
            min_remaining=rb.min_remaining, cooldown_s=rb.cooldown_s,
            max_inflight=rb.max_inflight)
        rebalance_every = rb.check_every_s
    ccfg = ClusterConfig(policy=sc.routing, dispatcher=sc.dispatch,
                         transfer_dtype_bytes=sc.transfer_dtype_bytes,
                         class_priorities=sc.class_priorities(),
                         name=sc.name, rebalance=rebalance,
                         rebalance_every_s=rebalance_every)
    autoscaler = None
    if sc.autoscaler is not None:
        a = sc.autoscaler
        rg = next(g for g in r.groups if g.group.role == a.role)
        prefix = rg.group.prefix or rg.group.role
        seq = iter(range(rg.group.count, 10 ** 9))

        def factory(r=r, rg=rg, prefix=prefix, seq=seq):
            return _build_worker(r, rg, name=f"{prefix}{next(seq)}")

        autoscaler = make_autoscaler(a, factory, slo=sc.slo())
    return ClusterRuntime(workers, ccfg, autoscaler=autoscaler,
                          sanitize=sanitize)
