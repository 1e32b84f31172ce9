"""Decode→decode rebalancing: shed load off a saturating decode worker
*before* the preemption storm (paper Obs 4 mitigation).

The paper's Obs 4: "tail latency is dominated by the replica that reaches KV
saturation first" — once a decode worker's page pool fills, every further
token grows someone's context across a page boundary and the scheduler
starts evicting (recompute preemption), burning the very compute the fleet
is short of. Rebalancing is the whole-fleet answer: when one worker crosses
a KV-pressure threshold WHILE a peer still has headroom — a condition only
expressible on a fleet-wide view — migrate one victim to the peer over the
existing eject / ``kv_transfer_time`` / inject path, trading one bounded
transfer for the unbounded recompute a storm would cost.

``RebalancePolicy`` is a pure decision function on the frozen
:class:`~repro_torch.cluster.view.FleetView` (lint rule REP010 keeps engine
internals out); actuation — eject, transfer accounting, pinned-destination
delivery — lives in ``ClusterRuntime``, which ticks the policy in its event
loop and emits a ``rebalance`` event per decision. Victim choice uses the
scheduler's own :func:`~repro_torch.core.scheduler.victim_order` (least urgent,
most recently arrived), so migrating away and preempting agree about who is
cheapest to disturb.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.scheduler import victim_order
from repro_torch.cluster.view import FleetView, RebalanceDecision, WorkerView


class RebalancePolicy:
    """(fleet view) -> at most one migration decision per tick.

    Pure decision logic: the runtime actuates (ejects the victim, pays the
    modeled KV transfer, delivers to the pinned destination) and enforces
    nothing — a policy returning ``None`` forever leaves the event loop
    bit-identical to a fleet with rebalancing disabled."""

    def decide(self, fleet: FleetView) -> Optional[RebalanceDecision]:
        raise NotImplementedError


@dataclasses.dataclass
class KVPressureRebalancer(RebalancePolicy):
    """Migrate one victim off the most KV-pressured decode worker to the
    peer with the most post-adoption headroom.

    Triggers when a worker's KV utilization crosses ``kv_high`` (default
    0.90 — the same saturation threshold the ``repro_torch.obs`` regime classifier
    uses for Capacity-Bound, ``RegimeRules.kv_saturated``) while some peer
    could adopt the victim and keep ``dst_headroom`` of its pool free.
    ``cooldown_s`` rate-limits decisions and ``max_inflight`` keeps at most
    that many rebalance transfers in flight — one bad tick must not empty a
    worker through parallel migrations it decided on one stale view."""
    kv_high: float = 0.90
    dst_headroom: float = 0.10
    min_remaining: int = 64       # don't ship a nearly-finished decode: the
                                  # transfer costs more than it frees
    cooldown_s: float = 0.25
    max_inflight: int = 1
    _last_t: float = dataclasses.field(default=float("-inf"), init=False,
                                       repr=False)

    def decide(self, fleet: FleetView) -> Optional[RebalanceDecision]:
        if fleet.inflight_rebalances >= self.max_inflight:
            return None
        if fleet.t - self._last_t < self.cooldown_s:
            return None
        pool = fleet.pool("decode") or fleet.pool("colocated")
        if len(pool) < 2:
            return None
        pressured = [v for v in pool
                     if v.kv_util >= self.kv_high and v.n_running >= 2]
        if not pressured:
            return None
        src = max(pressured, key=lambda v: (v.kv_util, v.name))
        victim = self._pick_victim(src)
        if victim is None:
            return None
        dst = self._pick_destination(pool, src, victim)
        if dst is None:
            return None
        self._last_t = fleet.t
        return RebalanceDecision(
            rid=victim.rid, src=src.name, dst=dst.name,
            kv_util=src.kv_util,
            reason=f"kv_util {src.kv_util:.3f} >= {self.kv_high} "
                   f"with peer headroom on {dst.name}")

    # ------------------------------------------------------------- internals
    def _pick_victim(self, src: WorkerView):
        """The same total order engine preemption uses (least urgent class,
        most recent arrival): the request preemption would evict anyway is
        the one worth shipping out before it is. Only decode-phase requests
        qualify — a mid-prefill request has no KV worth moving, and inject
        adopts running (prefill-complete) requests only."""
        cands = [r for r in src.running_reqs
                 if r.prefill_done and r.generated >= 1
                 and r.remaining >= self.min_remaining]
        if not cands:
            return None
        return max(cands, key=lambda r: victim_order(r.urgency, r.arrival,
                                                     r.rid))

    def _pick_destination(self, pool, src: WorkerView, victim):
        """Peer with the most predicted headroom AFTER adopting the victim,
        required to keep ``dst_headroom`` of its pool free and a batch slot
        open — a destination this migration would itself push to the wall is
        no mitigation, it just moves the storm."""
        best = None
        for v in pool:
            if v.name == src.name or v.draining \
                    or v.n_running >= v.max_seqs:
                continue
            need = v.pages_for(victim.context_len + victim.remaining + 1)
            head = v.predicted_headroom_pages() - need
            if head < self.dst_headroom * v.n_pages:
                continue
            if best is None or (head, v.name) > best[0]:
                best = ((head, v.name), v)
        return best[1] if best is not None else None


REBALANCERS = {"kv_pressure": KVPressureRebalancer}


def make_rebalancer(name: str, **kw) -> RebalancePolicy:
    if name not in REBALANCERS:
        raise ValueError(f"unknown rebalance policy {name!r} "
                         f"(have {sorted(REBALANCERS)})")
    return REBALANCERS[name](**kw)
