"""Named paper scenarios — the §III-C testbed as reusable specs.

One entry per evaluated model family (8B / 14B / 32B / 405B / R1-671B), each
pinned to the deployment the paper found best on 8xH200 (tests/test_planner
regression points), plus the 4xH200 colocated-vs-disaggregated pair the
cluster benchmarks sweep. Sweeps iterate these (via ``dataclasses.replace``
for rate/size variants) instead of copy-pasting engine kwargs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.core.perf_model import ParallelismPlan
from repro_torch.scenario.spec import (Autoscaler, ModelRef, Rebalance, Scenario,
                                       SLOClass, Traffic, WorkerGroup)

INTERACTIVE = SLOClass(name="interactive", ttft_s=0.5, tpot_s=0.020,
                       priority=10)
BATCH = SLOClass(name="batch", ttft_s=30.0, tpot_s=0.5, priority=0)

# the paper's offline-throughput workload: Natural-Reasoning lengths,
# everything submitted at once (§III-B)
_REASONING_CLOSED = Traffic(process="closed", workload="reasoning",
                            n_requests=2000, seed=0)

# the serving-level workload the cluster layer sweeps: kilotoken prompts,
# capped reasoning decodes, open-loop Poisson arrivals past the colocated
# fleet's capacity knee
_LONG_OPEN = Traffic(process="poisson", rate=12.0, workload="long_reasoning",
                     n_requests=150, osl_cap=1200, seed=42)


SCENARIOS: Dict[str, Scenario] = {s.name: s for s in (
    # ---- cluster serving pair (disagg_sweep / serve_cluster) --------------
    Scenario(
        name="ds8b-4xh200-colocated",
        model=ModelRef("ds-distill-8b"),
        fleet=(WorkerGroup(role="colocated", count=4, n_pages=3000,
                           max_seqs=64, prefix="co"),),
        traffic=_LONG_OPEN,
        slos=(INTERACTIVE,),
        notes="4 DP replicas, prefill+decode interleaved (paper §V-B "
              "baseline); 48k KV tokens/worker saturates at paper-like "
              "scale"),
    Scenario(
        name="ds8b-4xh200-disagg",
        model=ModelRef("ds-distill-8b"),
        fleet=(WorkerGroup(role="prefill", count=1, n_pages=3000,
                           max_seqs=64, prefix="pre"),
               WorkerGroup(role="decode", count=3, n_pages=3000,
                           max_seqs=64, prefix="dec")),
        traffic=_LONG_OPEN,
        slos=(INTERACTIVE,),
        notes="same 4 devices split 1 prefill + 3 decode with modeled "
              "KV-transfer migration (§III phase divergence made "
              "structural)"),
    # ---- mixed tenancy: interactive + batch on one fleet (slo_tiers) ------
    Scenario(
        name="ds8b-4xh200-mixed",
        model=ModelRef("ds-distill-8b"),
        fleet=(WorkerGroup(role="colocated", count=4, n_pages=3000,
                           max_seqs=64, prefix="co"),),
        traffic=dataclasses.replace(
            _LONG_OPEN, class_mix=(("interactive", 0.4), ("batch", 0.6))),
        slos=(INTERACTIVE, BATCH),
        class_kv_headroom=0.10,
        notes="multi-tenant SLO classes: interactive jumps queues and keeps "
              "a 10% KV slice, batch absorbs backpressure — the fleet-level "
              "latency-vs-throughput tier trade-off (benchmarks/slo_tiers)"),
    # ---- elastic sizing under diurnal load (benchmarks/autoscale) ---------
    Scenario(
        name="ds8b-autoscale-diurnal",
        model=ModelRef("ds-distill-8b"),
        fleet=(WorkerGroup(role="colocated", count=2, n_pages=3000,
                           max_seqs=64, prefix="co"),),
        traffic=Traffic(process="piecewise", workload="long_reasoning",
                        phases=((20.0, 2.0), (15.0, 10.0), (30.0, 2.0)),
                        n_requests=200, osl_cap=1200, seed=42),
        slos=(INTERACTIVE,),
        autoscaler=Autoscaler(policy="slo_guard", role="colocated",
                              min_workers=2, max_workers=6, tick_s=1.0,
                              cooldown_s=4.0, ewma_alpha=0.7),
        notes="trough-provisioned fleet (2 replicas) rides a 5x diurnal "
              "swing: the slo_guard controller grows toward peak and shrinks "
              "back, holding attainment at peak-fleet level on a fraction of "
              "the worker-seconds (the fixed-degree utilization gap the "
              "paper's fleet sizing discussion leaves on the table)"),
    # ---- decode→decode rebalancing (benchmarks/rebalance) -----------------
    Scenario(
        name="ds8b-4xh200-rebalance",
        model=ModelRef("ds-distill-8b"),
        fleet=(WorkerGroup(role="prefill", count=1, n_pages=3000,
                           max_seqs=64, prefix="pre"),
               WorkerGroup(role="decode", count=3, n_pages=3000,
                           max_seqs=64, prefix="dec")),
        traffic=dataclasses.replace(_LONG_OPEN, rate=14.0),
        slos=(INTERACTIVE,),
        rebalance=Rebalance(policy="kv_pressure"),
        notes="the disagg fleet driven past its capacity knee, with "
              "KV-pressure rebalancing shedding load off the first decode "
              "worker to saturate (Obs 4: the fleet tail is set by that "
              "worker's preemption storm; benchmarks/rebalance compares "
              "against the same fleet with the hook disabled)"),
    # ---- the 8xH200 testbed points (one per model family) -----------------
    Scenario(
        name="ds8b-8xh200-dp8",
        model=ModelRef("ds-distill-8b"),
        fleet=(WorkerGroup(role="colocated", count=8),),
        traffic=_REASONING_CLOSED,
        slos=(BATCH,),
        notes="Obs 5: pure DP wins for small dense models"),
    Scenario(
        name="ds14b-8xh200-dp8",
        model=ModelRef("ds-distill-14b"),
        fleet=(WorkerGroup(role="colocated", count=8),),
        traffic=_REASONING_CLOSED,
        slos=(BATCH,),
        notes="Obs 5: DP8 beats every TP/PP mix at 14B"),
    Scenario(
        name="ds32b-8xh200-dp4tp2",
        model=ModelRef("ds-distill-32b"),
        fleet=(WorkerGroup(role="colocated", count=4,
                           plan=ParallelismPlan(tp=2, ep=2)),),
        traffic=_REASONING_CLOSED,
        slos=(BATCH,),
        notes="the right-sized-TP point: DP4xTP2 beats DP8 and TP8 "
              "(KV capacity vs weight replication trade-off)"),
    Scenario(
        name="llama405b-8xh200-tp8",
        model=ModelRef("llama3-405b"),
        fleet=(WorkerGroup(role="colocated", count=1,
                           plan=ParallelismPlan(tp=8, ep=8)),),
        traffic=_REASONING_CLOSED,
        slos=(BATCH,),
        notes="§V-C: TP8 wins at 405B; PP8 catastrophic (KV-starved "
              "bubbles)"),
    Scenario(
        name="r1-8xh200-pp4tp2",
        model=ModelRef("deepseek-r1-671b", dtype_bytes=1),  # fp8 weights
        fleet=(WorkerGroup(role="colocated", count=1,
                           plan=ParallelismPlan(tp=2, pp=4, ep=2)),),
        traffic=_REASONING_CLOSED,
        slos=(BATCH,),
        notes="Obs 6: sync-latency-bound sparse model prefers PP4xTP2 "
              "over TP8"),
)}


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise KeyError(f"unknown scenario {name!r} "
                       f"(have {sorted(SCENARIOS)})") from None


def register_scenario(sc: Scenario, overwrite: bool = False):
    if sc.name in SCENARIOS and not overwrite:
        raise ValueError(f"scenario {sc.name!r} already registered")
    SCENARIOS[sc.name] = sc


def variant(name: str, **changes) -> Scenario:
    """A registry scenario with top-level fields replaced (sweep helper)."""
    return dataclasses.replace(get_scenario(name), **changes)
