"""Pluggable cluster scheduling policies, scored on the decision plane.

``RoutingPolicy``   — picks a worker for a *new* request (colocated fleets and
                      the prefill pool of a disaggregated fleet).
``DispatchPolicy``  — picks a decode worker for a *migrated* prefill-complete
                      request in a disaggregated fleet.

Policies consume frozen :class:`~repro.cluster.view.WorkerView` snapshots,
never live workers: all KV headroom / occupancy / feasibility math lives in
``repro.cluster.view`` (lint rule REP010 rejects ``engine``/``alloc``/
``sched`` access here), so routing, dispatch, admission and autoscaling
reason from one consistent observation instead of six ad-hoc re-derivations.

The memory-aware policy is the paper's Obs 3/4 recommendation ("DP should be
combined with ... memory-aware routing"; "tail latency is dominated by the
replica that reaches KV saturation first"): score replicas by predicted KV
headroom with a straggler penalty folded into one scalar — a replica whose
EWMA step latency runs above the fleet mean is charged a headroom-fraction
equivalent, so slowness and saturation trade off in the same unit. The
straggler EWMA itself is runtime-owned (``StragglerTracker``) and arrives on
the view as ``step_ewma``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from repro_torch.core.request import Request
from repro_torch.cluster.view import WorkerView, eligible_indices


class RoutingPolicy:
    """Chooses the worker index for a new request. ``urgency`` is the
    request's SLO-class urgency normalised to [0, 1] (0 = batch/untiered) —
    class-aware policies may weigh latency risk more heavily for urgent
    requests; class-blind policies ignore it."""

    def pick(self, views: List[WorkerView], prompt_len: int,
             max_new: int, urgency: float = 0.0) -> int:
        raise NotImplementedError


class RoundRobin(RoutingPolicy):
    def __init__(self):
        self._rr = -1

    def pick(self, views: List[WorkerView], prompt_len: int,
             max_new: int, urgency: float = 0.0) -> int:
        ok = set(eligible_indices(views, prompt_len, max_new))
        for step in range(1, len(views) + 1):
            i = (self._rr + step) % len(views)
            if i in ok:
                self._rr = i
                return i
        raise AssertionError("unreachable: eligible_indices is non-empty")


class JoinShortestQueue(RoutingPolicy):
    def pick(self, views: List[WorkerView], prompt_len: int,
             max_new: int, urgency: float = 0.0) -> int:
        return min(eligible_indices(views, prompt_len, max_new),
                   key=lambda i: views[i].queue_depth)


def relative_straggle(v: WorkerView,
                      pool: List[WorkerView]) -> float:
    """Relative EWMA step latency of ``v`` among the *observed* members of
    ``pool`` (its own view included): EWMA / pool-observed-mean - 1. Workers
    never observed carry no data, take no penalty and no reward, and do not
    drag the reference mean — the PR-3 warmup-bias fix, now expressed on
    view fields."""
    if v.step_ewma is None:
        return 0.0
    observed = [u.step_ewma for u in pool if u.step_ewma is not None]
    if not observed:
        return 0.0
    mean = sum(observed) / len(observed)
    if mean <= 0:
        return 0.0
    return v.step_ewma / mean - 1.0


@dataclasses.dataclass
class MemoryAware(RoutingPolicy):
    """score_i = -headroom_frac_i + straggler_penalty * straggle_i
               + urgency_weight * urgency * queue_frac_i.

    All terms are dimensionless: headroom as a fraction of the page pool,
    straggle as relative EWMA step latency among *observed* workers
    (``relative_straggle``), queue pressure as occupancy of the concurrency
    cap. The urgency term makes the router latency-averse for interactive
    requests (a deep queue is TTFT risk) while batch requests still pack by
    headroom."""
    straggler_penalty: float = 2.0
    urgency_weight: float = 1.0

    def pick(self, views: List[WorkerView], prompt_len: int,
             max_new: int, urgency: float = 0.0) -> int:
        def score(i):
            v = views[i]
            head = v.predicted_headroom_pages() \
                - v.candidate_pages(prompt_len, max_new)
            frac = head / max(v.n_pages, 1)
            queue_frac = v.queue_depth / max(v.max_seqs, 1)
            return (-frac
                    + self.straggler_penalty * relative_straggle(v, views)
                    + self.urgency_weight * urgency * queue_frac)
        return min(eligible_indices(views, prompt_len, max_new), key=score)


def make_policy(name: str, **kw) -> RoutingPolicy:
    table = {"round_robin": RoundRobin, "jsq": JoinShortestQueue,
             "memory_aware": MemoryAware}
    if name not in table:
        raise ValueError(f"unknown routing policy {name!r} "
                         f"(have {sorted(table)})")
    return table[name](**kw)


# ---------------------------------------------------------------- dispatchers
class DispatchPolicy:
    """Chooses the decode worker that adopts a migrated request. ``urgency``
    is the request's normalised SLO-class urgency (see RoutingPolicy)."""

    def pick(self, views: List[WorkerView], req: Request,
             urgency: float = 0.0) -> Optional[int]:
        raise NotImplementedError


class LeastKVHeadroom(DispatchPolicy):
    """Best-fit decode dispatch: among decode workers whose predicted
    headroom still fits the request's remaining growth, pick the one with the
    LEAST headroom — packing tight keeps the emptiest replica free for the
    long-decode tail (the requests that actually hit the capacity wall,
    Obs 4). Urgent (interactive) requests instead pick the least *loaded*
    fitting worker — a packed replica's batch depth is TPOT risk, and their
    short decodes never stress the capacity wall best-fit protects. Falls
    back to the most-headroom worker when none fits."""

    def pick(self, views: List[WorkerView], req: Request,
             urgency: float = 0.0) -> Optional[int]:
        if not views:
            return None
        need = [None] * len(views)
        fits = []
        for i, v in enumerate(views):
            remaining = req.max_new_tokens - req.generated
            pages = v.pages_for(req.context_len + remaining + 1)
            head = v.predicted_headroom_pages()
            need[i] = head
            if head >= pages:
                fits.append(i)
        if fits:
            if urgency > 0.5:
                return min(fits, key=lambda i: (views[i].queue_depth,
                                                need[i]))
            return min(fits, key=lambda i: need[i])
        return max(range(len(views)), key=lambda i: need[i])


class MostKVHeadroom(DispatchPolicy):
    """Worst-fit (load-levelling) decode dispatch: always the emptiest."""

    def pick(self, views: List[WorkerView], req: Request,
             urgency: float = 0.0) -> Optional[int]:
        if not views:
            return None
        return max(range(len(views)),
                   key=lambda i: views[i].predicted_headroom_pages())


def make_dispatcher(name: str) -> DispatchPolicy:
    table = {"least_headroom": LeastKVHeadroom,
             "most_headroom": MostKVHeadroom}
    if name not in table:
        raise ValueError(f"unknown dispatch policy {name!r} "
                         f"(have {sorted(table)})")
    return table[name]()
