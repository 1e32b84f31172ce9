"""Elastic autoscaling: grow/shrink worker pools under time-varying load.

The paper's Obs 3/4 put reasoning fleets in a Capacity-Bound regime — the
first replica to saturate its KV pool sets the fleet tail — so a *statically
sized* fleet must be provisioned for the peak and strands compute off-peak
(the utilization gap fixed-degree deployments pay). Long-CoT workloads make
load swings large and *slow*, which is exactly the regime where a controller
with hysteresis beats static sizing: swings persist for many controller
periods, so tracking them wins worker-seconds without flapping.

Three pieces:

``ScalingSignals``       — windowed EWMAs of the fleet state a controller
                           acts on: KV saturation, queue backlog, SLO
                           attainment, estimated arrival rate.
``AutoscalePolicy``      — pure decision functions (signals, pool size) ->
                           desired replica delta. ``TargetUtilization``
                           tracks a KV-utilization set-point inside a
                           hysteresis band; ``SLOGuard`` scales up whenever
                           SLO attainment dips (or saturation threatens) and
                           down only when attainment is safe AND the pool is
                           demonstrably oversized.
``AutoscaleController``  — ticks on the cluster's virtual clock between
                           fleet events, observes signals, applies per-role
                           min/max bounds and a cooldown, and mints/retires
                           replicas through ``ClusterRuntime.add_worker`` /
                           ``retire_worker``. New replicas pay the modeled
                           cold start (``pm.weight_load_time`` — the
                           HBM-ingest lower bound — plus an optional
                           ``cold_start_extra_s`` for checkpoint fetch /
                           container spin-up) before joining the pool.

Observation is read-only: a tick that takes no action leaves the simulation
bit-identical to the static path (the acceptance bar for pool-mutation
support).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence

from repro_torch.core.metrics import SLO
from repro_torch.cluster.view import FleetView, WorkerView
from repro_torch.cluster.worker import Worker
from repro_torch.obs.regimes import RegimeRules


# ------------------------------------------------------------------- signals
@dataclasses.dataclass
class ScalingSignals:
    """EWMA-smoothed fleet signals, updated once per controller tick.

    Raw per-tick observations are noisy (a tick may see zero finishes, or a
    transient queue spike); the EWMA gives the controller a windowed view
    whose memory is ``~1/ewma_alpha`` ticks — the hysteresis that keeps one
    burst from flapping the pool. ``None`` means "never observed" (attainment
    additionally holds its last value across ticks with no finishes)."""
    ewma_alpha: float = 0.4
    kv_util: Optional[float] = None         # mean pool KV-page utilization
    queue_depth: Optional[float] = None     # mean waiting requests / worker
    slo_attainment: Optional[float] = None  # attainment of recent finishes
    arrival_rate: Optional[float] = None    # est. arrivals/s into the fleet
    # fraction of the pool that is Capacity-Bound by the repro_torch.obs regime
    # rules (preemption evidence this tick, or KV at/above
    # ``RegimeRules.kv_saturated`` while requests queue). Preemptions are
    # *events*, not levels: one worker's storm barely moves the pool-mean
    # kv_util EWMA, but flips this fraction — the classifier's evidence,
    # available to the controller a tick earlier than the KV mean crosses
    # any ceiling
    capacity_frac: Optional[float] = None
    # slow-EWMA rate baseline (alpha/8): the load the pool has demonstrably
    # been absorbing. fast/slow >> 1 is a surge — the LEADING scale-up
    # indicator (KV fill and queue growth lag a rate step by seconds, and
    # attainment only reports a blown TTFT when the request finishes)
    arrival_rate_slow: Optional[float] = None
    warmup_ticks: int = 8         # observations before the slow baseline
                                  # (and thus the surge ratio) is trusted
    n_obs: int = 0

    def __post_init__(self):
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got "
                             f"{self.ewma_alpha}")

    def _blend(self, prev: Optional[float], raw: Optional[float],
               alpha: Optional[float] = None) -> Optional[float]:
        if raw is None:
            return prev                     # no observation: hold
        if prev is None:
            return raw                      # first observation seeds
        a = self.ewma_alpha if alpha is None else alpha
        return (1.0 - a) * prev + a * raw

    def observe(self, *, kv_util: Optional[float] = None,
                queue_depth: Optional[float] = None,
                attainment: Optional[float] = None,
                arrival_rate: Optional[float] = None,
                capacity_frac: Optional[float] = None):
        self.kv_util = self._blend(self.kv_util, kv_util)
        self.queue_depth = self._blend(self.queue_depth, queue_depth)
        self.slo_attainment = self._blend(self.slo_attainment, attainment)
        self.arrival_rate = self._blend(self.arrival_rate, arrival_rate)
        self.capacity_frac = self._blend(self.capacity_frac, capacity_frac)
        if arrival_rate is not None and self.n_obs < self.warmup_ticks:
            # arithmetic mean while warming up: an EWMA would anchor on the
            # first (noisy) observation for ~1/alpha_slow ticks, and a biased
            # baseline reads as a phantom surge
            prev = self.arrival_rate_slow or 0.0
            self.arrival_rate_slow = \
                prev + (arrival_rate - prev) / (self.n_obs + 1)
        else:
            self.arrival_rate_slow = self._blend(
                self.arrival_rate_slow, arrival_rate, self.ewma_alpha / 8.0)
        self.n_obs += 1

    def surge_ratio(self) -> float:
        """Fast-to-slow arrival-rate ratio: ~1 in steady state, >>1 within a
        tick or two of a load step. 1.0 when either estimate is missing or
        the slow baseline hasn't warmed up (a freshly seeded baseline tracks
        the fast EWMA too closely to mean anything)."""
        if self.n_obs < self.warmup_ticks:
            return 1.0
        if not self.arrival_rate or not self.arrival_rate_slow:
            return 1.0
        return self.arrival_rate / max(self.arrival_rate_slow, 1e-9)


# ------------------------------------------------------------------ policies
class AutoscalePolicy:
    """(signals, provisioned pool size) -> desired replica delta.

    Pure decision logic: bounds, cooldown and actuation live in the
    controller. ``n_provisioned`` counts warming replicas — capacity already
    bought must damp further scale-ups (no thundering herd while the first
    replica is still loading weights)."""

    def desired_delta(self, s: ScalingSignals, n_provisioned: int) -> int:
        raise NotImplementedError


@dataclasses.dataclass
class TargetUtilization(AutoscalePolicy):
    """Track a KV-utilization set-point inside a hysteresis band.

    Above ``target + band``: add a replica (two when saturation is imminent —
    past ``target + 2*band`` the KV wall is close and one cold start of lag
    costs a preemption storm, Obs 4). Below ``target - band`` with no queue
    backlog: remove one. Inside the band: hold — the dead zone is what keeps
    a noisy signal from flapping the pool."""
    target: float = 0.60
    band: float = 0.15
    up_queue_depth: float = 4.0       # backlog/worker that forces a scale-up
                                      # even below the band (admission-blocked
                                      # fleets pin kv_util while queues grow)
    down_queue_depth: float = 0.5     # max backlog/worker to allow scale-down

    def desired_delta(self, s: ScalingSignals, n_provisioned: int) -> int:
        u, q = s.kv_util, s.queue_depth
        if u is None:
            return 0
        if q is not None and q > self.up_queue_depth:
            return 2
        if u > self.target + self.band:
            return 2 if u > min(self.target + 2 * self.band, 0.95) else 1
        if u < self.target - self.band \
                and (q is None or q <= self.down_queue_depth):
            return -1
        return 0


@dataclasses.dataclass
class SLOGuard(AutoscalePolicy):
    """Scale up whenever the SLO is in danger; scale down only when it is
    demonstrably safe AND the pool is oversized.

    Danger = attainment EWMA below ``attain_floor``, KV utilization above
    ``util_ceiling`` (the saturation precursor — Obs 4's preemption storm
    follows it), queue backlog past ``up_queue_depth``, or an arrival-rate
    *surge* (fast/slow rate EWMAs diverging past ``surge_ratio``). The surge
    term is feedforward: every other signal lags a load step by seconds (KV
    fills at prefill speed, attainment only reports a blown TTFT when the
    request finishes), but the rate jump is visible within a tick — and a
    pool that was attaining at the slow rate needs capacity scaled by the
    rate ratio to keep attaining (utilization-preserving resize), so the
    surge delta is proportional, not incremental. Safe = attainment at/above
    the floor plus margin, utilization below ``scale_down_util``, and
    near-empty queues. The asymmetry is deliberate: an SLO miss costs
    goodput immediately, an extra replica costs worker-seconds slowly."""
    attain_floor: float = 0.90
    margin: float = 0.03
    util_ceiling: float = 0.85
    scale_down_util: float = 0.35
    up_queue_depth: float = 4.0
    down_queue_depth: float = 0.5
    surge_ratio: float = 1.5
    surge_hold: int = 2           # consecutive surging ticks before acting
                                  # (one Poisson spike is noise, two are load)
    # opt-in Capacity-Bound trigger: scale up when the EWMA fraction of the
    # pool classified Capacity-Bound (``ScalingSignals.capacity_frac`` — the
    # repro_torch.obs regime evidence: preemptions, or saturated KV while queued)
    # exceeds this. Fires a tick earlier than the pool-mean KV EWMA on a
    # surge: one replica's preemption storm flips its regime bit immediately
    # while the fleet KV mean is still averaging it away. ``None`` disables
    # (bit-identical to the pre-regime controller).
    capacity_frac_ceiling: Optional[float] = None
    _surge_run: int = dataclasses.field(default=0, init=False, repr=False)

    def desired_delta(self, s: ScalingSignals, n_provisioned: int) -> int:
        att, u, q = s.slo_attainment, s.kv_util, s.queue_depth
        ratio = s.surge_ratio()
        attaining = att is None or att >= self.attain_floor
        if ratio > self.surge_ratio and attaining:
            self._surge_run += 1
            if self._surge_run >= self.surge_hold:
                # the slow rate is a valid capacity reference only while
                # the pool still attains at it
                return max(1, math.ceil(n_provisioned * (ratio - 1.0)))
        else:
            self._surge_run = 0
        hurt = att is not None and att < self.attain_floor
        saturating = u is not None and u > self.util_ceiling
        backlogged = q is not None and q > self.up_queue_depth
        pressured = self.capacity_frac_ceiling is not None \
            and s.capacity_frac is not None \
            and s.capacity_frac > self.capacity_frac_ceiling
        if hurt or saturating or backlogged or pressured:
            # attainment already collapsing = the controller is late:
            # take two steps, cold starts are serial lag otherwise
            return 2 if (hurt and saturating) or backlogged else 1
        safe = att is None or att >= min(self.attain_floor + self.margin, 1.0)
        idle = u is not None and u < self.scale_down_util
        drained = q is None or q <= self.down_queue_depth
        if safe and idle and drained:
            return -1
        return 0


POLICIES = {"target_utilization": TargetUtilization, "slo_guard": SLOGuard}


def make_autoscale_policy(name: str, **kw) -> AutoscalePolicy:
    if name not in POLICIES:
        raise ValueError(f"unknown autoscale policy {name!r} "
                         f"(have {sorted(POLICIES)})")
    return POLICIES[name](**kw)


# ---------------------------------------------------------------- controller
class AutoscaleController:
    """Ticks on the cluster's virtual clock; observes, decides, actuates.

    ``worker_factory`` mints a fresh (virtual-clock) ``Worker`` for the
    scaled role — the Scenario compiler wires one up from the role's
    ``WorkerGroup``, so minted replicas match the group's capacity and
    admission settings exactly. Bounds are per-role: the provisioned count
    (active + warming) always stays in [min_workers, max_workers].
    ``cooldown_s`` rate-limits actions; the policies' hysteresis bands
    prevent flapping between them."""

    def __init__(self, policy: AutoscalePolicy,
                 worker_factory: Callable[[], Worker],
                 role: str = "colocated", min_workers: int = 1,
                 max_workers: int = 8, tick_s: float = 2.0,
                 cooldown_s: float = 10.0, slo: Optional[SLO] = None,
                 ewma_alpha: float = 0.4, cold_start_extra_s: float = 0.0):
        if min_workers < 1 or max_workers < min_workers:
            raise ValueError(f"need 1 <= min_workers <= max_workers, got "
                             f"[{min_workers}, {max_workers}]")
        if tick_s <= 0:
            raise ValueError(f"tick_s must be > 0, got {tick_s}")
        if cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got {cooldown_s}")
        self.policy = policy
        self.worker_factory = worker_factory
        self.role = role
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.tick_s = tick_s
        self.cooldown_s = cooldown_s
        self.slo = slo
        self.cold_start_extra_s = cold_start_extra_s
        self.signals = ScalingSignals(ewma_alpha=ewma_alpha)
        self.regime_rules = RegimeRules()
        self.next_tick: Optional[float] = tick_s
        self._last_tick_t = 0.0
        self._last_action_t: Optional[float] = None
        self._last_preempt: Dict[str, int] = {}
        self.n_scale_ups = 0
        self.n_scale_downs = 0

    # ----------------------------------------------------------- observation
    def _capacity_bound(self, v: WorkerView) -> bool:
        """The repro_torch.obs Capacity-Bound evidence, on view fields: the worker
        preempted since the last tick (storm), or its KV pool sits at/above
        the saturation threshold while requests queue behind it
        (KV-throttled admission)."""
        preempted = v.preemptions - self._last_preempt.get(v.name, 0) > 0
        throttled = v.kv_util >= self.regime_rules.kv_saturated \
            and v.n_waiting > 0
        return preempted or throttled

    def _observe(self, fleet: FleetView, t: float,
                 pool: Sequence[WorkerView]):
        dt = max(t - self._last_tick_t, 1e-9)
        kv = sum(v.kv_util for v in pool) / len(pool) if pool else None
        queue = sum(v.n_waiting for v in pool) / len(pool) if pool else None
        cap = sum(1 for v in pool
                  if self._capacity_bound(v)) / len(pool) if pool else None
        for v in pool:
            self._last_preempt[v.name] = v.preemptions
        # arrivals in (last_tick, t]: the view's arrival series covers routed
        # requests AND the not-yet-routed remainder in the runtime's heap —
        # disjoint sets, so each arrival is counted in exactly one window
        arrived = sum(1 for ta in fleet.arrivals
                      if self._last_tick_t < ta <= t)
        att = None
        if self.slo is not None:
            fin = [r for r in fleet.finished
                   if r.t_finished is not None
                   and self._last_tick_t < r.t_finished <= t]
            if fin:
                att = sum(self.slo.attained(r) for r in fin) / len(fin)
        self.signals.observe(kv_util=kv, queue_depth=queue, attainment=att,
                             arrival_rate=arrived / dt, capacity_frac=cap)

    # -------------------------------------------------------------- actuation
    def tick(self, rt, t: float):
        """One controller period: observe -> decide -> clamp -> actuate.
        Called by the runtime's event loop with the fleet quiescent at
        virtual time ``t``; always schedules the next tick. Observation is
        one frozen ``FleetView`` — the same decision plane routing, dispatch
        and rebalancing read."""
        fleet = rt.fleet_view(t)
        pool = fleet.pool(self.role)
        warming = fleet.warming_count(self.role)
        self._observe(fleet, t, pool)
        n = len(pool) + warming
        delta = self.policy.desired_delta(self.signals, n)
        if warming and delta < 0:
            delta = 0          # capacity already in flight: let it land first
        delta = max(self.min_workers - n, min(self.max_workers - n, delta))
        in_cooldown = self._last_action_t is not None \
            and t - self._last_action_t < self.cooldown_s
        if delta != 0:
            # the decision itself goes on the event spine (whether or not
            # cooldown suppresses actuation); the resulting mint/retire
            # lifecycle events are emitted by the runtime's mutators
            rt.emitter.emit("scale_decision", t=t, delta=delta,
                            actuated=not in_cooldown, n_active=len(pool),
                            n_warming=warming, role=self.role)
        if delta != 0 and not in_cooldown:
            if delta > 0:
                for _ in range(delta):
                    rt.add_worker(self.worker_factory(), at=t,
                                  cold_start_extra_s=self.cold_start_extra_s)
                self.n_scale_ups += delta
            else:
                for _ in range(-delta):
                    rt.retire_worker(role=self.role, at=t)
                self.n_scale_downs += -delta
            self._last_action_t = t
        self._last_tick_t = t
        self.next_tick = t + self.tick_s


def make_autoscaler(spec, worker_factory: Callable[[], Worker],
                    slo: Optional[SLO] = None) -> AutoscaleController:
    """Build a controller from a scenario's ``Autoscaler`` spec
    (``repro.scenario.spec``; duck-typed: anything carrying the spec's
    fields works). ``slo`` is the target
    the ``slo_guard`` policy's attainment signal is judged against —
    typically the scenario's default SLO class."""
    if spec.policy == "target_utilization":
        policy: AutoscalePolicy = TargetUtilization(
            target=spec.target_kv_util, band=spec.band)
    elif spec.policy == "slo_guard":
        policy = SLOGuard(attain_floor=spec.attain_floor,
                          util_ceiling=spec.util_ceiling,
                          scale_down_util=spec.scale_down_util,
                          surge_ratio=spec.surge_ratio,
                          capacity_frac_ceiling=getattr(
                              spec, "capacity_frac_ceiling", None))
    else:
        raise ValueError(f"unknown autoscale policy {spec.policy!r} "
                         f"(have {sorted(POLICIES)})")
    return AutoscaleController(
        policy=policy, worker_factory=worker_factory, role=spec.role,
        min_workers=spec.min_workers, max_workers=spec.max_workers,
        tick_s=spec.tick_s, cooldown_s=spec.cooldown_s, slo=slo,
        ewma_alpha=spec.ewma_alpha,
        cold_start_extra_s=spec.cold_start_extra_s)
