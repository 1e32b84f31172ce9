"""Memory-aware DP routing + straggler mitigation (paper Obs 3/4).

"DP should be combined with admission control or memory-aware routing to
prevent each replica from independently entering a preemption-heavy regime"
and "tail latency is dominated by the replica that reaches KV saturation
first" — the router scores replicas by predicted KV headroom (not just queue
depth) and penalises stragglers via an EWMA of per-step latency.

The policies themselves live in ``repro.cluster.policies`` as pluggable
``RoutingPolicy`` objects shared with the cluster runtime; ``DPRouter`` is
the single-router colocated front-end that co-simulates its replicas on a
shared virtual clock (the pre-cluster API, kept for the DP benchmarks).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.core.engine import InferenceEngine
from repro_torch.core.request import Request


@dataclasses.dataclass
class RouterConfig:
    policy: str = "memory_aware"   # round_robin | jsq | memory_aware
    straggler_penalty: float = 2.0
    ewma_alpha: float = 0.2


class DPRouter:
    def __init__(self, replicas: List[InferenceEngine],
                 cfg: Optional[RouterConfig] = None):
        # deferred upward import: policies live with the cluster layer (they
        # score WorkerViews); core stays importable standalone and the cycle
        # (cluster.worker -> core.engine) is avoided. Keep cluster imports
        # out of core module scope.
        from repro_torch.cluster.policies import RoutingPolicy, make_policy
        from repro_torch.cluster.view import StragglerTracker, snapshot
        from repro_torch.cluster.worker import Worker
        self.replicas = replicas
        self.cfg = cfg or RouterConfig()
        self.workers = [Worker(engine=e, role="colocated", name=f"dp{i}")
                        for i, e in enumerate(replicas)]
        # per-replica step-latency EWMA, router-owned: policies read it from
        # the WorkerView snapshots built per pick (the decision plane)
        self.straggler = StragglerTracker(alpha=self.cfg.ewma_alpha)
        self._snapshot = snapshot
        if self.cfg.policy == "memory_aware":
            self.policy: RoutingPolicy = make_policy(
                "memory_aware", straggler_penalty=self.cfg.straggler_penalty)
        else:
            self.policy = make_policy(self.cfg.policy)

    def note_step(self, i: int, dt: float):
        self.straggler.note_step(self.workers[i].name, dt)

    def pick(self, prompt_len: int, max_new: int) -> int:
        views = [self._snapshot(w, straggler=self.straggler)
                 for w in self.workers]
        return self.policy.pick(views, prompt_len, max_new)

    def submit(self, prompt, max_new: int, arrival: float = None) -> Request:
        plen = prompt if isinstance(prompt, int) else len(prompt)
        i = self.pick(plen, max_new)
        return self.replicas[i].submit(prompt, max_new, arrival)

    def run_all(self, max_steps: int = 10 ** 7):
        """Co-simulate replicas on a shared virtual clock."""
        active = True
        steps = 0
        while active and steps < max_steps:
            active = False
            for i, e in enumerate(self.replicas):
                t0 = e.now
                if e.step():
                    active = True
                    self.note_step(i, e.now - t0)
            steps += 1
        return [e.metrics for e in self.replicas]
