"""Declarative serving scenarios — the paper's decision framework as an API.

A ``Scenario`` is one frozen, dict/JSON-round-trippable answer to "what am I
deploying, on what, under which traffic, against which SLOs?". The same spec
compiles to three fidelities (``repro_torch.scenario.compile``):

  * ``to_plan()``    — ranked analytical ``PlanEstimate``s (seconds to run)
  * ``to_engine()``  — one virtual-clock ``InferenceEngine`` replica (minutes)
  * ``to_cluster()`` — a full ``ClusterRuntime`` fleet with routing, arrival
                       replay and migration (the serving-level ground truth)

so a what-if question ("Qwen-32B on 8xH200 at 12 req/s with interactive
SLOs — DP4xTP2 or disagg?") is asked once and answered at increasing cost.
Per-``WorkerGroup`` hardware makes heterogeneous fleets expressible (ROADMAP);
the ``slos`` tuple is the hook for multi-tenant SLO classes.

A copy of ``repro.scenario.spec`` with the imports renamed; its one
addition is ``"h100"`` in ``HARDWARE``, the card the port runs on.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

from repro_torch.cluster.worker import ROLES
from repro_torch.core import perf_model as pm
from repro_torch.core.metrics import SLO
from repro_torch.data.reasoning import CHAT, LONG_REASONING, REASONING, WorkloadSpec

# --------------------------------------------------------------- name tables
# Mutable registries so downstream code can add hardware / workload profiles
# without touching the spec schema; specs stay JSON-serialisable names.
# "h100" is the port's card (as ``repro_torch.launch.serve --hw h100``)
HARDWARE: Dict[str, pm.Hardware] = {"h100": pm.H100, "h200": pm.H200,
                                    "v5e": pm.V5E}
WORKLOADS: Dict[str, WorkloadSpec] = {
    "reasoning": REASONING,
    "chat": CHAT,
    "long_reasoning": LONG_REASONING,
}

PROCESSES = ("closed", "poisson", "gamma", "trace", "piecewise")

AUTOSCALE_POLICIES = ("target_utilization", "slo_guard")


def register_hardware(name: str, hw: pm.Hardware):
    HARDWARE[name] = hw


def register_workload(name: str, spec: WorkloadSpec):
    WORKLOADS[name] = spec


def _lookup(table: Dict[str, Any], name: str, kind: str):
    try:
        return table[name]
    except KeyError:
        raise KeyError(
            f"unknown {kind} {name!r} (have {sorted(table)})") from None


# -------------------------------------------------------------------- pieces
@dataclasses.dataclass(frozen=True)
class ModelRef:
    """A model by registry name plus its numeric formats."""
    name: str
    dtype_bytes: int = 2          # weight/activation width (fp8: 1)
    cache_dtype_bytes: int = 2    # KV-cache width (fp8/int8 cache: 1)

    def resolve(self):
        from repro_torch.configs.registry import get_config
        return get_config(self.name)


@dataclasses.dataclass(frozen=True)
class WorkerGroup:
    """``count`` identical workers sharing one role, hardware and plan.

    ``n_pages=None`` means paper-calibrated capacity: every KV token that
    fits after weights + runtime overhead (``pm.kv_capacity_tokens``).
    ``admission=None`` means the role default (prefill workers admit naively
    — their requests never grow KV; everyone else KV-aware, Obs 1/8).
    """
    role: str = "colocated"
    count: int = 1
    hardware: str = "h200"
    plan: pm.ParallelismPlan = pm.ParallelismPlan()
    n_pages: Optional[int] = None
    page_size: int = 16
    max_seqs: int = 256
    max_batched_tokens: int = 8192
    chunk_size: int = 512
    admission: Optional[str] = None
    autotune: bool = False
    prefix: str = ""              # worker-name prefix (defaults to role)

    def __post_init__(self):
        if self.role not in ROLES:
            raise ValueError(f"unknown role {self.role!r} (have {ROLES})")
        if self.count < 1:
            raise ValueError(f"group needs count >= 1, got {self.count}")
        if not isinstance(self.plan, pm.ParallelismPlan):
            object.__setattr__(self, "plan", pm.ParallelismPlan(**self.plan))

    @property
    def devices(self) -> int:
        return self.count * self.plan.devices


@dataclasses.dataclass(frozen=True)
class Traffic:
    """Arrival process x (ISL, OSL) distribution (paper §III-B).

    ``closed`` submits everything at t=0 (the pre-cluster benchmark mode);
    ``poisson``/``gamma`` are open-loop; ``trace`` replays explicit arrival
    times; ``piecewise`` is a nonhomogeneous Poisson process with a
    piecewise-constant rate (``phases`` = (duration_s, rate) segments — the
    diurnal/bursty traffic autoscaling exists for). The same ``seed`` always
    draws the same request lengths, so fleets compared under different
    processes see identical work.

    ``class_mix`` is the multi-tenant traffic split: (SLO-class name, weight)
    pairs; each request in the compiled trace is deterministically tagged
    with a class drawn from this mix (same seed -> same tagging, so
    class-aware and class-blind fleets see identical per-request tiers).
    Empty = single-tenant (every request gets the scenario's default class).
    """
    process: str = "closed"
    rate: float = 0.0             # req/s (poisson | gamma)
    cv: float = 2.0               # gamma burstiness (cv=1 is Poisson)
    arrivals: Tuple[float, ...] = ()   # explicit times (trace)
    phases: Tuple[Tuple[float, float], ...] = ()  # (duration_s, rate) segs
    workload: str = "reasoning"
    n_requests: int = 150
    osl_cap: Optional[int] = None
    seed: int = 0
    class_mix: Tuple[Tuple[str, float], ...] = ()

    def __post_init__(self):
        if self.process not in PROCESSES:
            raise ValueError(
                f"unknown arrival process {self.process!r} (have {PROCESSES})")
        if self.process in ("poisson", "gamma") and self.rate <= 0:
            raise ValueError(f"{self.process} traffic needs rate > 0")
        object.__setattr__(self, "arrivals", tuple(self.arrivals))
        if self.process == "trace" and len(self.arrivals) < self.n_requests:
            raise ValueError(f"trace has {len(self.arrivals)} arrivals, "
                             f"need {self.n_requests}")
        phases = tuple((float(d), float(r)) for d, r in self.phases)
        object.__setattr__(self, "phases", phases)
        if self.process == "piecewise":
            if not phases:
                raise ValueError("piecewise traffic needs at least one "
                                 "(duration_s, rate) phase")
            if any(d <= 0 for d, _ in phases) or any(r < 0 for _, r in phases):
                raise ValueError(f"piecewise phases need duration > 0 and "
                                 f"rate >= 0: {phases}")
            if all(r == 0 for _, r in phases):
                raise ValueError("piecewise traffic needs at least one "
                                 "phase with rate > 0")
        mix = tuple((str(n), float(w)) for n, w in self.class_mix)
        if any(w <= 0 for _, w in mix):
            raise ValueError(f"class_mix weights must be positive: {mix}")
        if len({n for n, _ in mix}) != len(mix):
            raise ValueError(f"class_mix names must be unique: {mix}")
        object.__setattr__(self, "class_mix", mix)

    def workload_spec(self) -> WorkloadSpec:
        return _lookup(WORKLOADS, self.workload, "workload")


@dataclasses.dataclass(frozen=True)
class SLOClass:
    """A named latency contract (the multi-tenant hook: interactive vs
    batch). ``None`` targets are unconstrained. ``priority`` is the class's
    scheduling urgency (higher = more latency-critical): urgent classes jump
    waiting queues, draw on the reserved KV headroom slice, and are preferred
    by class-aware routing; preemption victims come from the least urgent
    class first."""
    name: str = "interactive"
    ttft_s: Optional[float] = None
    tpot_s: Optional[float] = None
    priority: int = 0

    def slo(self) -> SLO:
        return SLO(ttft_s=self.ttft_s, tpot_s=self.tpot_s)


@dataclasses.dataclass(frozen=True)
class Autoscaler:
    """Elastic sizing for one fleet role (``repro_torch.cluster.autoscale``).

    The named ``role``'s WorkerGroup ``count`` becomes the *initial* pool
    size; the controller then holds the provisioned count (active + warming)
    inside [``min_workers``, ``max_workers``], deciding every ``tick_s``
    seconds of fleet time with ``cooldown_s`` between actions. New replicas
    pay the modeled weight-load cold start plus ``cold_start_extra_s``
    (checkpoint fetch / container spin-up) before serving.

    Policy knobs: ``target_utilization`` tracks ``target_kv_util`` inside a
    ``band`` hysteresis; ``slo_guard`` scales up when attainment drops below
    ``attain_floor`` (or KV utilization passes ``util_ceiling``) and down
    only below ``scale_down_util``."""
    policy: str = "target_utilization"
    role: str = "colocated"
    min_workers: int = 1
    max_workers: int = 8
    tick_s: float = 2.0
    cooldown_s: float = 10.0
    target_kv_util: float = 0.60
    band: float = 0.15
    attain_floor: float = 0.90
    util_ceiling: float = 0.85
    scale_down_util: float = 0.35
    surge_ratio: float = 1.5      # fast/slow arrival-rate ratio that counts
                                  # as a load surge (slo_guard feedforward)
    # opt-in slo_guard trigger: scale up when the EWMA fraction of the pool
    # classified Capacity-Bound by the repro_torch.obs regime rules (preemption
    # evidence, or saturated KV while queued) exceeds this; None disables
    capacity_frac_ceiling: Optional[float] = None
    ewma_alpha: float = 0.4
    cold_start_extra_s: float = 0.0

    def __post_init__(self):
        if self.policy not in AUTOSCALE_POLICIES:
            raise ValueError(f"unknown autoscale policy {self.policy!r} "
                             f"(have {AUTOSCALE_POLICIES})")
        if self.role not in ROLES:
            raise ValueError(f"unknown role {self.role!r} (have {ROLES})")
        if self.min_workers < 1 or self.max_workers < self.min_workers:
            raise ValueError(f"need 1 <= min_workers <= max_workers, got "
                             f"[{self.min_workers}, {self.max_workers}]")
        if self.tick_s <= 0:
            raise ValueError(f"tick_s must be > 0, got {self.tick_s}")
        if self.cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got "
                             f"{self.cooldown_s}")
        if not 0.0 < self.ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got "
                             f"{self.ewma_alpha}")
        if self.cold_start_extra_s < 0:
            raise ValueError(f"cold_start_extra_s must be >= 0, got "
                             f"{self.cold_start_extra_s}")
        if self.capacity_frac_ceiling is not None \
                and not 0.0 < self.capacity_frac_ceiling <= 1.0:
            raise ValueError(f"capacity_frac_ceiling must be in (0, 1], got "
                             f"{self.capacity_frac_ceiling}")


REBALANCE_POLICIES = ("kv_pressure",)


@dataclasses.dataclass(frozen=True)
class Rebalance:
    """Decode→decode rebalancing (``repro_torch.cluster.rebalance``): when a
    decode worker's KV utilization crosses ``kv_high`` while a peer could
    adopt one of its running requests and keep ``dst_headroom`` of its own
    pool free, migrate that victim over the eject/KV-transfer/inject path
    *before* the source's preemption storm (paper Obs 4 mitigation).
    ``cooldown_s`` rate-limits decisions, ``max_inflight`` bounds concurrent
    rebalance transfers, and ``check_every_s`` is how often the event loop
    consults the policy on a fresh ``FleetView``."""
    policy: str = "kv_pressure"
    kv_high: float = 0.90         # source trigger (RegimeRules.kv_saturated)
    dst_headroom: float = 0.10    # post-adoption pool fraction the
                                  # destination must keep free
    min_remaining: int = 64       # don't ship nearly-finished decodes
    cooldown_s: float = 0.25
    max_inflight: int = 1
    check_every_s: float = 0.05

    def __post_init__(self):
        if self.policy not in REBALANCE_POLICIES:
            raise ValueError(f"unknown rebalance policy {self.policy!r} "
                             f"(have {REBALANCE_POLICIES})")
        if not 0.0 < self.kv_high <= 1.0:
            raise ValueError(f"kv_high must be in (0, 1], got {self.kv_high}")
        if not 0.0 <= self.dst_headroom < 1.0:
            raise ValueError(f"dst_headroom must be in [0, 1), got "
                             f"{self.dst_headroom}")
        if self.min_remaining < 1:
            raise ValueError(f"min_remaining must be >= 1, got "
                             f"{self.min_remaining}")
        if self.cooldown_s < 0:
            raise ValueError(f"cooldown_s must be >= 0, got "
                             f"{self.cooldown_s}")
        if self.max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, got "
                             f"{self.max_inflight}")
        if self.check_every_s <= 0:
            raise ValueError(f"check_every_s must be > 0, got "
                             f"{self.check_every_s}")


# --------------------------------------------------------------- diagnostics
@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One feasibility finding from ``Scenario.check()``: ``code`` is a
    stable machine-readable kind, ``field`` the spec path it points at."""
    code: str
    severity: str                 # "error" | "warning"
    field: str
    message: str

    def format(self) -> str:
        return f"[{self.code}] {self.severity} at {self.field}: {self.message}"


# ------------------------------------------------------------------ scenario
@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    model: ModelRef
    fleet: Tuple[WorkerGroup, ...]
    traffic: Traffic = Traffic()
    slos: Tuple[SLOClass, ...] = ()
    routing: str = "memory_aware"        # RoutingPolicy name
    dispatch: str = "least_headroom"     # DispatchPolicy name
    transfer_dtype_bytes: int = 2        # KV wire format for migration
    class_kv_headroom: float = 0.0       # pool fraction only the top-urgency
                                         # SLO class may use (tier slice)
    autoscaler: Optional["Autoscaler"] = None  # elastic sizing (one role)
    rebalance: Optional["Rebalance"] = None    # decode→decode rebalancing
    notes: str = ""

    def __post_init__(self):
        if isinstance(self.model, dict):
            object.__setattr__(self, "model", ModelRef(**self.model))
        fleet = tuple(g if isinstance(g, WorkerGroup) else WorkerGroup(**g)
                      for g in self.fleet)
        slos = tuple(s if isinstance(s, SLOClass) else SLOClass(**s)
                     for s in self.slos)
        object.__setattr__(self, "fleet", fleet)
        object.__setattr__(self, "slos", slos)
        if not self.fleet:
            raise ValueError("scenario needs at least one worker group")
        roles = {g.role for g in self.fleet}
        if "prefill" in roles and "decode" not in roles:
            raise ValueError("prefill groups need a decode group to "
                             "migrate into")
        if not 0.0 <= self.class_kv_headroom < 1.0:
            raise ValueError(f"class_kv_headroom must be in [0, 1), got "
                             f"{self.class_kv_headroom}")
        known = {c.name for c in self.slos}
        unknown = [n for n, _ in self.traffic.class_mix if n not in known]
        if unknown:
            raise ValueError(
                f"traffic class_mix names {unknown} have no SLOClass in "
                f"scenario {self.name!r} (have {sorted(known)})")
        if isinstance(self.autoscaler, dict):
            object.__setattr__(self, "autoscaler",
                               Autoscaler(**self.autoscaler))
        if isinstance(self.rebalance, dict):
            object.__setattr__(self, "rebalance",
                               Rebalance(**self.rebalance))
        if self.autoscaler is not None:
            a = self.autoscaler
            grp = [g for g in self.fleet if g.role == a.role]
            if not grp:
                raise ValueError(
                    f"autoscaler targets role {a.role!r} but the fleet has "
                    f"no such group (roles: {sorted(roles)})")
            if len(grp) > 1:
                raise ValueError(
                    f"autoscaler targets role {a.role!r} but {len(grp)} "
                    f"groups share it — minted replicas would be ambiguous; "
                    f"use a single group for the scaled role")
            n0 = grp[0].count
            if not a.min_workers <= n0 <= a.max_workers:
                raise ValueError(
                    f"initial {a.role} count {n0} outside autoscaler bounds "
                    f"[{a.min_workers}, {a.max_workers}]")

    # ------------------------------------------------------------ properties
    @property
    def n_devices(self) -> int:
        return sum(g.devices for g in self.fleet)

    @property
    def disaggregated(self) -> bool:
        return any(g.role == "prefill" for g in self.fleet)

    def slo(self, name: Optional[str] = None) -> Optional[SLO]:
        """The named SLO class (default: the first one) as a core SLO."""
        if not self.slos:
            return None
        if name is None:
            return self.slos[0].slo()
        for c in self.slos:
            if c.name == name:
                return c.slo()
        raise KeyError(f"no SLO class {name!r} in scenario {self.name!r} "
                       f"(have {[c.name for c in self.slos]})")

    def slo_map(self) -> Dict[str, SLO]:
        """Every SLO class as name -> core SLO (the class-conditional
        metrics table; ``slos[0]`` is the default class)."""
        return {c.name: c.slo() for c in self.slos}

    def class_priorities(self) -> Dict[str, int]:
        """Class name -> scheduling urgency, for admission/scheduler/routing
        (empty or uniform = class-blind behaviour)."""
        return {c.name: c.priority for c in self.slos}

    # ------------------------------------------------- dict/JSON round trip
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Scenario":
        d = dict(d)
        d["model"] = ModelRef(**d["model"])
        d["fleet"] = tuple(WorkerGroup(**g) for g in d["fleet"])
        d["traffic"] = Traffic(**d.get("traffic", {}))
        d["slos"] = tuple(SLOClass(**s) for s in d.get("slos", ()))
        if d.get("autoscaler") is not None:
            d["autoscaler"] = Autoscaler(**d["autoscaler"])
        if d.get("rebalance") is not None:
            d["rebalance"] = Rebalance(**d["rebalance"])
        return cls(**d)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_json(cls, s: str) -> "Scenario":
        return cls.from_dict(json.loads(s))

    # ------------------------------------------------------------ feasibility
    def check(self, include_warnings: bool = False) -> list:
        """Static feasibility diagnostics — no engine or cluster is built,
        no trace is drawn. Catches the spec mistakes the constructor can't
        see (they need the *resolved* model/hardware/workload): a KV pool
        too small for the workload's structural max request, TP degrees
        that don't divide the head counts, PP deeper than the layer stack,
        a ``class_mix`` that doesn't sum to 1, autoscaler bounds that
        contradict the fleet, degenerate piecewise phases.

        Returns ``Diagnostic`` rows, errors only by default
        (``include_warnings=True`` adds advisory findings such as a PP
        degree that divides the layers unevenly). An empty list means the
        spec compiles and every structurally possible request fits."""
        diags: list = []

        def add(code, severity, field, message):
            diags.append(Diagnostic(code=code, severity=severity,
                                    field=field, message=message))

        cfg = None
        try:
            cfg = self.model.resolve()
        except KeyError as e:
            add("unknown_model", "error", "model.name", str(e))
        workload = None
        try:
            workload = self.traffic.workload_spec()
        except KeyError as e:
            add("unknown_workload", "error", "traffic.workload", str(e))

        self._check_fleet_capacity(cfg, workload, add)
        self._check_parallelism(cfg, add)
        self._check_traffic(add)
        self._check_autoscaler(add)
        self._check_rebalance(add)
        if include_warnings:
            return diags
        return [d for d in diags if d.severity == "error"]

    def _check_fleet_capacity(self, cfg, workload, add):
        """Per-group KV pool vs the workload's structural max request."""
        if workload is None:
            return
        osl_eff = min(workload.osl_max,
                      self.traffic.osl_cap or workload.osl_max)
        for i, g in enumerate(self.fleet):
            field = f"fleet[{i}]"
            try:
                hw = _lookup(HARDWARE, g.hardware, "hardware")
            except KeyError as e:
                add("unknown_hardware", "error", f"{field}.hardware", str(e))
                continue
            n_pages = g.n_pages
            if n_pages is None:
                if cfg is None:
                    continue          # capacity default needs the model
                from repro_torch.cluster.worker import default_n_pages
                n_pages = default_n_pages(cfg, g.plan, hw,
                                          self.model.dtype_bytes, g.page_size,
                                          self.model.cache_dtype_bytes)
            cap = n_pages * g.page_size
            # a prefill worker holds prompt + first token only; everyone
            # else must hold the full context at last decode
            need = workload.isl_max + 2 if g.role == "prefill" \
                else workload.isl_max + osl_eff + 1
            if cap < need:
                add("kv_pool_too_small", "error", f"{field}.n_pages",
                    f"{g.role} KV pool holds {cap} tokens but the "
                    f"{self.traffic.workload!r} workload's largest request "
                    f"needs {need} (isl_max {workload.isl_max}"
                    + ("" if g.role == "prefill"
                       else f" + capped osl {osl_eff}") + " + 1)")
            if g.max_batched_tokens < g.chunk_size:
                add("chunk_over_budget", "warning", f"{field}.chunk_size",
                    f"chunk_size {g.chunk_size} exceeds max_batched_tokens "
                    f"{g.max_batched_tokens}; prefill chunks will be "
                    f"truncated to the budget")

    def _check_parallelism(self, cfg, add):
        if cfg is None:
            return
        for i, g in enumerate(self.fleet):
            field = f"fleet[{i}].plan"
            p = g.plan
            if p.tp > 1:
                if cfg.n_heads % p.tp:
                    add("tp_heads", "error", field,
                        f"tp={p.tp} does not divide n_heads={cfg.n_heads}")
                if cfg.attention != "mla" and cfg.n_kv_heads % p.tp:
                    add("tp_kv_heads", "error", field,
                        f"tp={p.tp} does not divide "
                        f"n_kv_heads={cfg.n_kv_heads} (KV-head shards "
                        f"would be uneven)")
            if p.pp > 1:
                if p.pp > cfg.n_layers:
                    add("pp_layers", "error", field,
                        f"pp={p.pp} exceeds n_layers={cfg.n_layers} "
                        f"(empty pipeline stages)")
                elif cfg.n_layers % p.pp:
                    add("pp_imbalance", "warning", field,
                        f"pp={p.pp} does not divide "
                        f"n_layers={cfg.n_layers}; the deepest stage "
                        f"bounds every microbatch")
            if p.ep > 1 and cfg.moe is not None and cfg.moe.n_experts \
                    and cfg.moe.n_experts % p.ep:
                add("ep_imbalance", "warning", field,
                    f"ep={p.ep} does not divide "
                    f"n_experts={cfg.moe.n_experts}; expert shards would "
                    f"be uneven")

    def _check_traffic(self, add):
        t = self.traffic
        if t.class_mix:
            total = sum(w for _, w in t.class_mix)
            if abs(total - 1.0) > 1e-6:
                add("class_mix_sum", "error", "traffic.class_mix",
                    f"class_mix weights sum to {total}, not 1")
        if t.process == "piecewise":
            # re-validated without raising: a spec corrupted after
            # construction (or built through a future non-validating path)
            # still gets a diagnostic instead of a mid-run surprise
            if not t.phases:
                add("phases_empty", "error", "traffic.phases",
                    "piecewise traffic has no (duration_s, rate) phases")
            elif any(d <= 0 for d, _ in t.phases):
                add("phases_nonmonotone", "error", "traffic.phases",
                    f"piecewise phase durations must be > 0 (the phase "
                    f"clock must advance): {t.phases}")
            elif all(r == 0 for _, r in t.phases):
                add("phases_silent", "error", "traffic.phases",
                    "every piecewise phase has rate 0: no request ever "
                    "arrives")
        if t.process == "trace" and t.arrivals:
            if any(b < a for a, b in zip(t.arrivals, t.arrivals[1:])):
                add("trace_unsorted", "warning", "traffic.arrivals",
                    "trace arrival times are not sorted; the runtime "
                    "replays them in time order, which reorders rids "
                    "relative to the trace")

    def _check_autoscaler(self, add):
        a = self.autoscaler
        if a is None:
            return
        grp = [(i, g) for i, g in enumerate(self.fleet) if g.role == a.role]
        if not grp:
            add("autoscaler_role", "error", "autoscaler.role",
                f"autoscaler targets role {a.role!r} but the fleet has no "
                f"such group")
            return
        if len(grp) > 1:
            add("autoscaler_role", "error", "autoscaler.role",
                f"{len(grp)} groups share the scaled role {a.role!r}; "
                f"minted replicas would be ambiguous")
        i, g = grp[0]
        if a.min_workers < 1 or a.max_workers < a.min_workers:
            add("autoscaler_bounds", "error", "autoscaler.min_workers",
                f"need 1 <= min_workers <= max_workers, got "
                f"[{a.min_workers}, {a.max_workers}]")
        elif not a.min_workers <= g.count <= a.max_workers:
            add("autoscaler_bounds", "error", f"fleet[{i}].count",
                f"initial {a.role} count {g.count} outside autoscaler "
                f"bounds [{a.min_workers}, {a.max_workers}]")
        if a.min_workers == a.max_workers:
            add("autoscaler_pinned", "warning", "autoscaler.max_workers",
                f"min_workers == max_workers == {a.min_workers}: the "
                f"controller can never act")

    def _check_rebalance(self, add):
        if self.rebalance is None:
            return
        # the rebalancer moves load between decode peers (or colocated peers
        # when there is no decode pool): a singleton adopter pool can never
        # host a migration, so the hook would tick forever for nothing
        role = "decode" if self.disaggregated else "colocated"
        n = sum(g.count for g in self.fleet if g.role == role)
        if n < 2:
            add("rebalance_singleton_pool", "warning", "rebalance.policy",
                f"rebalancing needs >= 2 {role} workers to migrate between; "
                f"the fleet has {n} — the policy can never act")

    # ------------------------------------------------------------ compilers
    # Thin delegates so a spec in hand is one call away from any fidelity
    # (the real work — one shared resolution pass — lives in
    # repro_torch.scenario.compile).
    def resolve(self):
        from repro_torch.scenario.compile import resolve
        return resolve(self)

    def to_plan(self, n_devices: Optional[int] = None):
        from repro_torch.scenario.compile import to_plan
        return to_plan(self, n_devices=n_devices)

    def to_engine(self, group: int = 0, sanitize: bool = False):
        from repro_torch.scenario.compile import to_engine
        return to_engine(self, group=group, sanitize=sanitize)

    def to_cluster(self, sanitize: bool = False):
        from repro_torch.scenario.compile import to_cluster
        return to_cluster(self, sanitize=sanitize)

    def trace(self):
        from repro_torch.scenario.compile import trace
        return trace(self)

    def crosscheck(self, n_requests: int = 40):
        """Dynamic cross-fidelity consistency: run plan/engine/cluster on a
        small closed-loop shrink of this spec and flag goodput/latency
        ratios outside per-scenario bounds as lint-style ``Finding`` rows
        (``repro_torch.scenario.crosscheck``)."""
        from repro_torch.scenario.crosscheck import crosscheck
        return crosscheck(self, n_requests=n_requests)
