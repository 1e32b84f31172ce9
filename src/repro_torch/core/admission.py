"""KV-aware admission control (paper Observations 1 & 8) and multi-tenant
SLO-class policy.

The paper's finding: admitting on *current* memory usage lets long-decode
requests blow through HBM later ("the reasoning cliff ... sometimes limiting
admission during prefill"). The KV-aware policy reserves headroom for the
*predicted* decode growth of everything already running before admitting more.

``ClassPolicy`` adds the multi-tenant tier semantics on top: SLO classes carry
an urgency (interactive > batch), the most urgent class(es) may draw on a
reserved KV headroom slice that lower tiers cannot, and the scheduler uses the
same urgencies for waiting-queue order and preemption-victim choice — batch
absorbs backpressure first, interactive latency stays flat under load (the
fleet-level latency-vs-throughput tier trade-off)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.kv_cache import PagedAllocator
from repro_torch.core.request import Request


@dataclasses.dataclass
class ClassPolicy:
    """Scheduling semantics of the SLO classes one engine serves.

    ``priority`` maps class name -> urgency (higher = more latency-critical;
    unknown/untagged classes get 0). ``kv_headroom`` is the pool fraction
    only top-urgency requests may use: lower tiers admit against a budget
    shrunk by that slice, so under pressure batch queues while interactive
    still admits. With no priorities (single-tenant) every class is top
    urgency and behaviour is identical to the class-blind policy."""
    priority: Dict[str, int] = dataclasses.field(default_factory=dict)
    kv_headroom: float = 0.0

    def urgency(self, slo_class: str) -> int:
        return self.priority.get(slo_class, 0)

    def max_urgency(self) -> int:
        return max(self.priority.values(), default=0)

    def protected(self, slo_class: str) -> bool:
        """May this class draw on the reserved KV headroom slice?"""
        return self.urgency(slo_class) >= self.max_urgency()

    def normalized_urgency(self, slo_class: str) -> float:
        """Urgency scaled to [0, 1] *relative to the least urgent known
        class* — urgency measures differentiation, so uniform priorities
        (single-tenant, or every class at one level) normalise to 0 and
        routing/dispatch stay class-blind, exactly like empty priorities."""
        if not self.priority:
            return 0.0
        lo, hi = min(self.priority.values()), max(self.priority.values())
        if hi <= lo:
            return 0.0
        return max(0.0, (self.urgency(slo_class) - lo) / (hi - lo))


@dataclasses.dataclass
class OSLEstimator:
    """EWMA of observed output lengths, seeded with a prior (the Natural-
    Reasoning profile: ~45% of responses exceed 5k tokens)."""
    prior: float = 4000.0
    alpha: float = 0.05
    _est: Optional[float] = None

    def observe(self, osl: int):
        self._est = osl if self._est is None else \
            (1 - self.alpha) * self._est + self.alpha * osl

    def predict_tokens(self, max_new: int) -> float:
        est = self._est if self._est is not None else self.prior
        return min(est, max_new)

    def predict(self, req: Request) -> float:
        return self.predict_tokens(req.max_new_tokens)


@dataclasses.dataclass
class AdmissionPolicy:
    """mode:
      naive    — admit while a prefill page fits (paper's baseline behaviour)
      kv_aware — admit only if predicted peak KV of running+candidate fits in
                 (1 - reserve) of the pool (Obs 1/8 recommendation)

    ``classes`` layers the multi-tenant tiers on top of either mode: a
    non-top-urgency candidate admits against a budget shrunk by the
    ``kv_headroom`` slice reserved for the most urgent class.
    """
    mode: str = "kv_aware"
    reserve: float = 0.05
    estimator: OSLEstimator = dataclasses.field(default_factory=OSLEstimator)
    classes: ClassPolicy = dataclasses.field(default_factory=ClassPolicy)

    def admit(self, req: Request, running: List[Request],
              alloc: PagedAllocator) -> bool:
        # tier slice: a lower-urgency candidate may not fill the headroom
        # reserved for the most urgent class (batch backpressures first)
        slice_ = 0.0 if self.classes.protected(req.slo_class) \
            else self.classes.kv_headroom
        if self.mode == "naive":
            used = alloc.n_pages - alloc.free_pages
            return used + alloc.pages_for(min(req.isl, 1)) \
                < alloc.n_pages * (1.0 - slice_)
        budget = alloc.n_pages * (1.0 - self.reserve - slice_)
        need = 0.0
        for r in [*running, req]:
            # predicted PEAK context: prompt + max(predicted OSL, already
            # generated) — Obs 8: "estimate future KV growth at admission
            # time ... instead of admitting on current memory usage"
            predicted = r.isl + max(self.estimator.predict(r), r.generated)
            need += alloc.pages_for(int(predicted) + 1)
        return need <= budget
