"""Cross-fidelity consistency checks for a ``Scenario``.

One spec compiles to three fidelities (plan / engine / cluster) that share a
single resolution pass, so their *large-scale* answers must agree: the
cluster's delivered throughput should be the single-replica engine's times
the replica count (within fleet effects — routing skew, migration overhead,
queueing), and both should sit below the planner's analytical decode bound.
``crosscheck`` runs all three on a small closed-loop variant of the spec and
flags ratios outside per-scenario bounds as lint-style ``Finding`` rows —
the dynamic counterpart of ``Scenario.check()``'s static diagnostics: a
misconfiguration that each fidelity tolerates in isolation (a replica with a
starved KV pool, an absurd KV wire format, a routing policy fighting the
fleet shape) shows up as the fidelities disagreeing about the same spec.

Codes:

  XCHK000  the spec itself fails ``Scenario.check()`` (static errors)
  XCHK001  cluster throughput vs replica-scaled engine throughput
  XCHK002  cluster throughput vs the planner's analytical decode bound
  XCHK003  cluster mean TPOT vs engine mean TPOT
  XCHK004  cluster mean TTFT vs engine mean TTFT
  XCHK005  cluster goodput vs replica-scaled engine goodput

Ratios are always cluster / reference. Bounds are deliberately loose —
fleet effects are real physics, not noise — and per-scenario overrides
(``BOUNDS``) encode the shapes where a fidelity is structurally expected to
deviate further (disaggregation pays transfer; autoscaling changes the
replica count mid-run).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.lint.rules import Finding
from repro_torch.scenario.spec import Scenario

# ratio -> (lo, hi), cluster / reference
DEFAULT_BOUNDS: Dict[str, Tuple[float, float]] = {
    "tput_vs_engine": (0.40, 2.00),
    "tput_vs_plan": (0.02, 1.50),
    "tpot_vs_engine": (0.40, 2.50),
    "ttft_vs_engine": (0.10, 6.00),
    "goodput_vs_engine": (0.30, 3.00),
}

# per-scenario overrides: shapes where a fidelity structurally deviates
BOUNDS: Dict[str, Dict[str, Tuple[float, float]]] = {
    # disaggregated: the engine fidelity is one colocated-style decode
    # replica, while the cluster adds dedicated prefill capacity and pays
    # KV transfer — throughput lands above the decode-pool-only scaling
    # and TTFT/TPOT shift with the migration path
    # (measured 2026-08: tput 0.53, ttft 2.4, goodput 0.12 at n=40 — the
    # closed burst funnels every request through the migration path, so
    # fleet TTFT-SLO goodput sits far below the replica-scaled engine's)
    "ds8b-4xh200-disagg": {
        "tput_vs_engine": (0.40, 3.00),
        "ttft_vs_engine": (0.05, 6.00),
        "goodput_vs_engine": (0.03, 3.00),
    },
    # autoscaling under a closed burst: the fleet grows past the initial
    # replica count the engine ratio is scaled by (measured: tput 0.62,
    # goodput 0.44, ttft 1.9)
    "ds8b-autoscale-diurnal": {
        "tput_vs_engine": (0.40, 4.00),
        "goodput_vs_engine": (0.30, 5.00),
    },
}

_CODES = {
    "tput_vs_engine": ("XCHK001", "cluster throughput vs replica-scaled "
                                  "engine throughput"),
    "tput_vs_plan": ("XCHK002", "cluster throughput vs planner decode "
                                "bound"),
    "tpot_vs_engine": ("XCHK003", "cluster mean TPOT vs engine mean TPOT"),
    "ttft_vs_engine": ("XCHK004", "cluster mean TTFT vs engine mean TTFT"),
    "goodput_vs_engine": ("XCHK005", "cluster goodput vs replica-scaled "
                                     "engine goodput"),
}


def bounds_for(name: str) -> Dict[str, Tuple[float, float]]:
    merged = dict(DEFAULT_BOUNDS)
    merged.update(BOUNDS.get(name, {}))
    return merged


def _closed_variant(sc: Scenario, n_requests: int) -> Scenario:
    """The spec with its traffic replaced by a small closed-loop burst:
    identical work across fidelities (same workload, same seed), no arrival
    process in the comparison."""
    traffic = dataclasses.replace(sc.traffic, process="closed",
                                  n_requests=n_requests, arrivals=())
    return dataclasses.replace(sc, traffic=traffic)


@dataclasses.dataclass(frozen=True)
class CrosscheckReport:
    """The measured ratios plus the findings they produced. ``ratios`` maps
    metric -> (ratio, cluster_value, reference_value); consult it when
    calibrating bounds for a new scenario."""
    scenario: str
    ratios: Dict[str, Tuple[float, float, float]]
    findings: Tuple[Finding, ...]

    @property
    def ok(self) -> bool:
        return not self.findings


def _run_engine(sc: Scenario, entries) -> Tuple[dict, Optional[dict]]:
    """One replica of the reference (decode-capable) group over its share of
    the closed trace. Returns (summary, slo_summary-or-None)."""
    ref = next((i for i, g in enumerate(sc.fleet) if g.role != "prefill"), 0)
    eng = sc.to_engine(group=ref)
    for e in entries:
        eng.submit(e.isl, e.osl, slo_class=e.slo_class)
    eng.run()
    summary = eng.metrics.summary()
    slos = sc.slo_map()
    slo_sum = eng.metrics.slo_summary(slos) if slos else None
    return summary, slo_sum


def _planner_tput(sc: Scenario) -> Optional[float]:
    """The analytical fleet decode-throughput bound: the spec's own fleet
    when it is a single group, the best feasible candidate plan for the
    device budget otherwise."""
    from repro_torch.scenario.compile import estimate_fleet, to_plan
    if len(sc.fleet) == 1:
        est = estimate_fleet(sc)
        return est.decode_tput_tok_s if est.feasible else None
    ests = [e for e in to_plan(sc) if e.feasible]
    return ests[0].decode_tput_tok_s if ests else None


def crosscheck(sc: Scenario, n_requests: int = 40) -> CrosscheckReport:
    """Run all three fidelities on a closed-loop shrink of ``sc`` and
    compare. Returns a report whose ``findings`` are empty when every ratio
    sits inside ``bounds_for(sc.name)``."""
    static = sc.check()
    if static:
        findings = tuple(Finding(
            rule_id="XCHK000", path=f"scenario:{sc.name}", line=0,
            severity="error",
            message=f"spec fails static check, crosscheck skipped: "
                    f"{d.format()}") for d in static)
        return CrosscheckReport(scenario=sc.name, ratios={},
                                findings=findings)

    small = _closed_variant(sc, n_requests)
    from repro_torch.scenario.compile import trace
    entries = trace(small)

    # cluster fidelity: the ground truth
    rt = small.to_cluster()
    rt.submit_trace(entries)
    m = rt.run()
    slos = small.slo_map()
    csum = m.summary(slos=slos or None)
    creq = m.request_summary()

    # engine fidelity: one reference replica over a 1/n_rep share
    n_rep = sum(g.count for g in small.fleet if g.role != "prefill")
    esum, eslo = _run_engine(small, entries[::max(n_rep, 1)])

    ratios: Dict[str, Tuple[float, float, float]] = {}

    def ratio(metric: str, cluster: float, reference: float):
        if reference <= 0 or cluster <= 0:
            return
        ratios[metric] = (cluster / reference, cluster, reference)

    ratio("tput_vs_engine", csum["throughput_tok_s"],
          esum["gen_throughput_tok_s"] * n_rep)
    plan_tput = _planner_tput(small)
    if plan_tput:
        ratio("tput_vs_plan", csum["throughput_tok_s"], plan_tput)
    ratio("tpot_vs_engine", creq["tpot_s"]["mean"], esum["tpot_s"]["mean"])
    ratio("ttft_vs_engine", creq["ttft_s"]["mean"], esum["ttft_s"]["mean"])
    if slos and eslo is not None and "goodput_tok_s" in csum:
        # scale the replica's goodput to the fleet; skip when either side
        # attains nothing (a 0/0 ratio says nothing about consistency)
        ratio("goodput_vs_engine", csum["goodput_tok_s"],
              eslo["goodput_tok_s"] * n_rep)

    bounds = bounds_for(sc.name)
    findings: List[Finding] = []
    for metric, (r, cv, rv) in sorted(ratios.items()):
        lo, hi = bounds[metric]
        if not lo <= r <= hi:
            code, label = _CODES[metric]
            findings.append(Finding(
                rule_id=code, path=f"scenario:{sc.name}", line=0,
                severity="error",
                message=f"{label}: ratio {r:.3f} outside [{lo}, {hi}] "
                        f"(cluster {cv:.3f} vs reference {rv:.3f}, "
                        f"n_requests={n_requests})"))
    return CrosscheckReport(scenario=sc.name, ratios=ratios,
                            findings=tuple(findings))
