"""What ``repro_torch.core.router.DPRouter`` needs of the cluster layer:
the decision plane's frozen views (``view``), the routing policies that
score them (``policies``) and the worker that wraps an engine
(``worker``), copies of ``repro.cluster``'s modules of those names. The
cluster runtime, arrivals and autoscaler are not ported."""
from repro_torch.cluster.policies import (DispatchPolicy, JoinShortestQueue,
                                          LeastKVHeadroom, MemoryAware,
                                          MostKVHeadroom, RoundRobin,
                                          RoutingPolicy, make_dispatcher,
                                          make_policy)
from repro_torch.cluster.view import (FleetView, NoFeasibleWorker,
                                      RebalanceDecision, RequestView,
                                      StragglerTracker, WorkerView,
                                      eligible_indices, fleet_snapshot,
                                      snapshot)
from repro_torch.cluster.worker import Worker, make_sim_worker

__all__ = [
    "RoutingPolicy", "RoundRobin", "JoinShortestQueue", "MemoryAware",
    "DispatchPolicy", "LeastKVHeadroom", "MostKVHeadroom",
    "make_policy", "make_dispatcher",
    "WorkerView", "FleetView", "RequestView", "RebalanceDecision",
    "NoFeasibleWorker", "StragglerTracker",
    "snapshot", "fleet_snapshot", "eligible_indices",
    "Worker", "make_sim_worker",
]
