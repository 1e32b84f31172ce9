"""Cluster serving layer: open-loop arrival replay, disaggregated
prefill/decode pools, pluggable routing, elastic autoscaling, and
SLO-goodput accounting. A copy of ``repro.cluster``: each module is its
namesake there with the imports renamed. The runtime co-simulates
virtual-clock engines (``SimRunner`` workers) and refuses real-clock ones,
as the reference does."""
from repro_torch.cluster.arrivals import (ArrivalProcess, GammaProcess,
                                    PiecewiseRateProcess, PoissonProcess,
                                    TraceEntry, TraceProcess, assign_classes,
                                    load_trace, make_trace, save_trace)
from repro_torch.cluster.autoscale import (AutoscaleController, AutoscalePolicy,
                                     ScalingSignals, SLOGuard,
                                     TargetUtilization, make_autoscale_policy,
                                     make_autoscaler)
from repro_torch.cluster.metrics import (ClusterMetrics, MigrationRecord,
                                   ScalingEvent)
from repro_torch.cluster.policies import (DispatchPolicy, JoinShortestQueue,
                                    LeastKVHeadroom, MemoryAware,
                                    MostKVHeadroom, RoundRobin, RoutingPolicy,
                                    make_dispatcher, make_policy)
from repro_torch.cluster.rebalance import (KVPressureRebalancer, RebalancePolicy,
                                     make_rebalancer)
from repro_torch.cluster.runtime import ClusterConfig, ClusterRuntime
from repro_torch.cluster.view import (FleetView, NoFeasibleWorker, RebalanceDecision,
                                RequestView, StragglerTracker, WorkerView,
                                eligible_indices, fleet_snapshot, snapshot)
from repro_torch.cluster.worker import Worker, make_sim_worker

__all__ = [
    "ArrivalProcess", "PoissonProcess", "GammaProcess", "TraceProcess",
    "PiecewiseRateProcess",
    "TraceEntry", "make_trace", "assign_classes", "save_trace", "load_trace",
    "ClusterMetrics", "MigrationRecord", "ScalingEvent",
    "ScalingSignals", "AutoscalePolicy", "TargetUtilization", "SLOGuard",
    "AutoscaleController", "make_autoscale_policy", "make_autoscaler",
    "RoutingPolicy", "RoundRobin", "JoinShortestQueue", "MemoryAware",
    "DispatchPolicy", "LeastKVHeadroom", "MostKVHeadroom",
    "make_policy", "make_dispatcher",
    "RebalancePolicy", "KVPressureRebalancer", "make_rebalancer",
    "WorkerView", "FleetView", "RequestView", "RebalanceDecision",
    "NoFeasibleWorker", "StragglerTracker",
    "snapshot", "fleet_snapshot", "eligible_indices",
    "ClusterConfig", "ClusterRuntime",
    "Worker", "make_sim_worker",
]
