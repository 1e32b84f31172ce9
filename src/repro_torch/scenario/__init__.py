"""Unified Scenario API: one declarative spec, three fidelities.

    sc = get_scenario("ds32b-8xh200-dp4tp2")
    sc.to_plan()      # ranked analytical PlanEstimates (seconds)
    sc.to_engine()    # one virtual-clock InferenceEngine replica
    sc.to_cluster()   # the full ClusterRuntime fleet

See docs/scenario.md for the spec schema and walkthrough. A copy of
``repro.scenario``: each module is its namesake there with the imports
renamed, compiled onto the port's planner, engine, ``SimRunner`` workers
and ``ClusterRuntime``; ``HARDWARE`` adds ``"h100"``.
"""
from repro_torch.scenario.compile import (Resolved, ResolvedGroup, aggregate_plan,
                                          estimate_fleet, planner_workload,
                                          requests, resolve, to_cluster, to_engine,
                                          to_plan, trace)
from repro_torch.scenario.crosscheck import (CrosscheckReport, bounds_for,
                                             crosscheck)
from repro_torch.scenario.registry import (SCENARIOS, get_scenario,
                                           register_scenario, variant)
from repro_torch.scenario.spec import (AUTOSCALE_POLICIES, HARDWARE, PROCESSES,
                                       ROLES, WORKLOADS, Autoscaler, Diagnostic,
                                       ModelRef, Scenario, SLOClass, Traffic,
                                       WorkerGroup, register_hardware,
                                       register_workload)

__all__ = [
    "Scenario", "ModelRef", "WorkerGroup", "Traffic", "SLOClass",
    "Autoscaler", "AUTOSCALE_POLICIES", "Diagnostic",
    "HARDWARE", "WORKLOADS", "ROLES", "PROCESSES",
    "register_hardware", "register_workload",
    "Resolved", "ResolvedGroup", "resolve", "aggregate_plan",
    "estimate_fleet", "planner_workload", "trace", "requests",
    "to_plan", "to_engine", "to_cluster",
    "crosscheck", "CrosscheckReport", "bounds_for",
    "SCENARIOS", "get_scenario", "register_scenario", "variant",
]
