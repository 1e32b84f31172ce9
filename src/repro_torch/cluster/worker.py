"""A cluster worker: one `InferenceEngine` plus its fleet role.

Roles (paper §III phase divergence / disaggregated serving):
  colocated — runs chunked prefill and decode interleaved (the baseline the
              paper characterises; prefill chunks inflate decode TPOT).
  prefill   — runs prefill only; a request is migrated out right after its
              first token (its KV ships to a decode worker).
  decode    — receives migrated prefill-complete requests and decodes them
              to completion; never executes prefill.

Workers are state holders: the KV-headroom predictions the routing policies
score with live on the decision plane (``repro.cluster.view.WorkerView`` —
the same predicted-peak estimate KV-aware admission uses, Obs 1/8, so the
router and the admission controller agree about saturation); a worker only
exposes the raw accessors the view builder snapshots from.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core import perf_model as pm
from repro_torch.core.engine import EngineConfig, InferenceEngine
from repro_torch.core.kv_cache import KVView
from repro_torch.core.runner import SimRunner

ROLES = ("colocated", "prefill", "decode")

# auto-name sequence for unnamed workers: a module-level monotonic counter.
# (The old id(engine)&0xffff scheme could collide after GC id-reuse — and
# did, once the autoscaler minted workers in a loop — tripping the runtime's
# unique-name check.)
_WORKER_SEQ = itertools.count()


@dataclasses.dataclass
class Worker:
    engine: InferenceEngine
    role: str = "colocated"
    name: str = ""
    # elasticity lifecycle (static fleets keep the zero-defaults):
    #   t_join   — when the replica was minted (autoscale decision time; the
    #              worker-second meter starts here — cold start is paid for)
    #   t_active — when it entered the route/dispatch pools (join + weight
    #              load); equals t_join for workers present at t=0
    #   t_retire — decommission stamp once a drained retiree goes dark
    #   draining — retired from the pools, finishing its in-flight requests
    t_join: float = 0.0
    t_active: float = 0.0
    t_retire: Optional[float] = None
    draining: bool = False

    def __post_init__(self):
        if self.role not in ROLES:
            raise ValueError(f"unknown worker role {self.role!r}")
        if not self.name:
            self.name = f"{self.role}-{next(_WORKER_SEQ):04d}"
        # stamp the worker name onto the engine's event stream so fleet-level
        # consumers (ClusterMetrics, the sanitizer, trace JSONL) can attribute
        # every engine event to its replica
        self.engine.emitter.worker = self.name

    def active_window(self, t_end: float, t0: float = 0.0) -> float:
        """Seconds this worker was provisioned within [t0, t_end] — the
        per-worker slice of the fleet's worker-second cost (cold start
        included: the meter runs from minting, not from pool entry)."""
        end = self.t_retire if self.t_retire is not None else t_end
        return max(min(end, t_end) - max(self.t_join, t0), 0.0)

    # ------------------------------------------------------------ state views
    @property
    def now(self) -> float:
        return self.engine.now

    @property
    def has_work(self) -> bool:
        return self.engine.has_work

    @property
    def queue_depth(self) -> int:
        s = self.engine.sched
        return len(s.waiting) + len(s.running)

    def kv_util(self) -> float:
        return self.engine.alloc.utilization()

    def kv_view(self) -> KVView:
        """Frozen KV occupancy/capacity snapshot — what the runtime's
        structural capacity checks read instead of allocator internals. The
        full decision-plane snapshot (predicted headroom, queue composition,
        straggler EWMA) is ``repro.cluster.view.snapshot(worker)``."""
        return KVView.of(self.engine.alloc)


def default_admission(role: str) -> str:
    """Prefill workers admit naively (their requests never grow KV —
    predicting decode growth there would starve the pool), everyone else
    uses KV-aware admission (Obs 1/8)."""
    return "naive" if role == "prefill" else "kv_aware"


def default_n_pages(cfg: ModelConfig, plan: pm.ParallelismPlan,
                    hw: pm.Hardware, dtype_bytes: int = 2,
                    page_size: int = 16, cache_dtype_bytes: int = 2) -> int:
    """Paper-calibrated page pool: every KV token that fits after weights +
    runtime overhead. The single source of capacity truth shared by
    `make_sim_worker` and the Scenario compilers."""
    cap = pm.kv_capacity_tokens(cfg, plan, hw, dtype_bytes,
                                cache_dtype_bytes=cache_dtype_bytes)
    return max(cap // page_size, 64)


def make_sim_worker(cfg: ModelConfig, plan: pm.ParallelismPlan,
                    hw: pm.Hardware = pm.H200, *, role: str = "colocated",
                    name: str = "", n_pages: Optional[int] = None,
                    page_size: int = 16, max_seqs: int = 256,
                    max_batched_tokens: int = 8192,
                    chunk_size: int = 512, admission: Optional[str] = None,
                    autotune: bool = False, dtype_bytes: int = 2,
                    cache_dtype_bytes: int = 2, rid_source=None,
                    class_priorities: Optional[Dict[str, int]] = None,
                    class_kv_headroom: float = 0.0,
                    sanitize: bool = False) -> Worker:
    """Virtual-clock worker with paper-calibrated capacity and role-default
    admission (see `default_n_pages` / `default_admission`).
    ``class_priorities``/``class_kv_headroom`` enable multi-tenant SLO-class
    scheduling (urgent classes jump the queue and keep a KV slice)."""
    if n_pages is None:
        n_pages = default_n_pages(cfg, plan, hw, dtype_bytes, page_size,
                                  cache_dtype_bytes)
    if admission is None:
        admission = default_admission(role)
    ecfg = EngineConfig(n_pages=n_pages, page_size=page_size,
                        max_num_seqs=max_seqs,
                        max_num_batched_tokens=max_batched_tokens,
                        chunk_size=chunk_size, admission_mode=admission,
                        autotune=autotune, prefill_only=role == "prefill",
                        class_priorities=dict(class_priorities or {}),
                        class_kv_headroom=class_kv_headroom,
                        sanitize=sanitize)
    eng = InferenceEngine(cfg, ecfg, SimRunner(cfg, plan, hw, dtype_bytes),
                          rid_source=rid_source)
    return Worker(engine=eng, role=role, name=name)
