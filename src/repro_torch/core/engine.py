"""The inference engine: continuous batching + paged KV + chunked prefill +
preemption + KV-aware admission + online concurrency tuning, with identical
scheduling logic over a real runner (``TorchRunner``) or a virtual-clock
runner.

Open-loop replay: ``submit(arrival=t)`` with a future ``t`` holds the request
in a pending heap, invisible to the scheduler until the engine clock reaches
``t`` (the cluster layer's arrival-time gating). ``eject``/``inject`` are the
request hand-off hooks the disaggregated prefill/decode runtime uses to
migrate a prefill-complete request between engines."""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from typing import Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.admission import AdmissionPolicy, ClassPolicy
from repro_torch.core.autotuner import AutotunerConfig, ConcurrencyAutotuner
from repro_torch.core.kv_cache import PagedAllocator
from repro_torch.core.metrics import MetricsLog
from repro_torch.core.request import Request, State
from repro_torch.core.scheduler import Scheduler, SchedulerConfig
from repro_torch.trace.events import EventEmitter, EventLog


@dataclasses.dataclass
class EngineConfig:
    n_pages: int = 4096
    page_size: int = 16
    max_num_seqs: int = 256
    max_num_batched_tokens: int = 2048
    chunk_size: int = 512
    admission_mode: str = "kv_aware"     # naive | kv_aware
    autotune: bool = False
    snapshot_every: int = 1
    prefill_only: bool = False           # disaggregated prefill worker
    # multi-tenant SLO classes: name -> urgency (higher = more latency-
    # critical), and the pool fraction only top-urgency requests may use
    class_priorities: Dict[str, int] = dataclasses.field(default_factory=dict)
    class_kv_headroom: float = 0.0
    # dynamic invariant checks (repro_torch.lint.sanitizer) after every step;
    # read-only, so metrics stay bit-identical to the default path
    sanitize: bool = False


class InferenceEngine:
    def __init__(self, cfg_model: ModelConfig, ecfg: EngineConfig, runner,
                 virtual_clock: bool = True, rid_source=None):
        self.cfg_model = cfg_model
        self.ecfg = ecfg
        self.runner = runner
        self.alloc = PagedAllocator(ecfg.n_pages, ecfg.page_size)
        if not virtual_clock:
            # the runner's device pool is indexed by this allocator's page
            # ids: page i of every table is page i of the pool; recurrent
            # state takes one slot per running sequence
            runner.bind(self.alloc, ecfg.max_num_seqs)
        self.sched = Scheduler(
            SchedulerConfig(ecfg.max_num_seqs, ecfg.max_num_batched_tokens,
                            ecfg.chunk_size, prefill_only=ecfg.prefill_only),
            self.alloc, AdmissionPolicy(
                mode=ecfg.admission_mode,
                classes=ClassPolicy(priority=dict(ecfg.class_priorities),
                                    kv_headroom=ecfg.class_kv_headroom)))
        self.virtual_clock = virtual_clock
        self.now = 0.0
        # the event spine (repro.trace): every transition this engine (or
        # its scheduler/allocator) performs is emitted exactly once on this
        # log; metrics are a subscriber, not a parallel bookkeeping path
        self.events = EventLog()
        self.emitter = EventEmitter(self.events, clock=lambda: self.now)
        self.alloc.emitter = self.emitter
        self.sched.emitter = self.emitter
        self.metrics = MetricsLog()
        self.events.subscribe(self.metrics.on_event)
        # rid_source: share one counter across engines whose requests may
        # migrate between them (rids key the paged allocator tables)
        self._rid = rid_source if rid_source is not None else itertools.count()
        self._pending: List = []         # (arrival, rid, Request) min-heap
        self._gen_total = 0
        self._prefill_total = 0
        self._steps = 0
        self.autotuner = ConcurrencyAutotuner(
            AutotunerConfig(enabled=ecfg.autotune), ecfg.max_num_seqs)
        self._sanitizer = None
        if ecfg.sanitize:
            from repro_torch.lint.sanitizer import EngineSanitizer
            self._sanitizer = EngineSanitizer(self)

    # ------------------------------------------------------------------ api
    def submit(self, prompt, max_new_tokens: int,
               arrival: Optional[float] = None,
               slo_class: str = "") -> Request:
        if isinstance(prompt, int):
            prompt = [1] * prompt        # synthetic token ids (sim mode)
        req = Request(rid=next(self._rid), prompt=list(prompt),
                      max_new_tokens=max_new_tokens,
                      arrival=self.now if arrival is None else arrival,
                      slo_class=slo_class)
        # validation runs BEFORE the arrival event on both paths — a
        # rejected request must never reach the stream (the metrics
        # subscriber would log it as a phantom SLO miss)
        if req.arrival > self.now:
            self.sched.validate(req)     # fail fast, like sched.submit
            heapq.heappush(self._pending, (req.arrival, req.rid, req))
        else:
            self.sched.submit(req)       # validates internally
        self.emitter.emit("arrival", rid=req.rid, ref=req, isl=req.isl,
                          max_new_tokens=req.max_new_tokens,
                          arrival=req.arrival, slo_class=req.slo_class)
        return req

    def issued_rids(self) -> List[int]:
        """Every rid this engine currently knows about (for seeding a shared
        fleet-wide counter past them)."""
        reqs = [*self.sched.running, *self.sched.waiting,
                *self.metrics.finished, *(p[2] for p in self._pending)]
        return [r.rid for r in reqs]

    def adopt_rid_source(self, source):
        """Share a fleet-wide rid counter (migration moves requests between
        engines, and rids key the paged-allocator tables)."""
        self._rid = source

    @property
    def has_work(self) -> bool:
        return self.sched.has_work or bool(self._pending)

    def next_arrival(self) -> Optional[float]:
        return self._pending[0][0] if self._pending else None

    def advance_to(self, t: float):
        """Fast-forward an idle clock (no in-flight work ages)."""
        self.now = max(self.now, t)

    def _release_arrivals(self):
        while self._pending and self._pending[0][0] <= self.now:
            self.sched.submit(heapq.heappop(self._pending)[2])

    def eject(self, req: Request) -> Request:
        """Remove a request from this engine without finishing it (the
        disaggregated hand-off: its KV pages are freed here and re-allocated
        on the target via ``inject``). The request leaves this engine's
        submitted log too — per-engine SLO accounting covers requests the
        engine is responsible for finishing; the adopter records it on
        inject (fleet-level accounting lives in ClusterMetrics)."""
        if req in self.sched.running:
            self.sched.running.remove(req)
        elif req in self.sched.waiting:
            self.sched.waiting.remove(req)
        self.alloc.free(req.rid)
        self.emitter.emit("eject", rid=req.rid, ref=req,
                          generated=req.generated,
                          context_tokens=req.context_len)
        if not self.virtual_clock:
            self.runner.release(req)
        return req

    def inject(self, req: Request) -> bool:
        """Adopt a migrated prefill-complete request into the running set.
        Returns False when no KV/concurrency room (caller retries later)."""
        if not self.sched.inject_running(req):
            return False
        self.emitter.emit("inject", rid=req.rid, ref=req,
                          context_tokens=req.context_len)
        return True

    def step(self) -> bool:
        """One engine iteration. Returns False when idle."""
        self._release_arrivals()
        if not self.sched.has_work:
            nxt = self.next_arrival()
            if nxt is None:
                return False
            # open-loop idle gap: jump to the next arrival
            self.advance_to(nxt)
            self._release_arrivals()
        # lint: disable=REP002 (real-execution timing, not simulation)
        # (virtual-clock runs never read t0: the `if self.virtual_clock`
        # branch below uses the runner's modeled iteration_time instead)
        t0 = time.monotonic()
        plan = self.sched.plan_step()
        for r in plan.admitted:
            if r.t_admitted is None:
                r.t_admitted = self.now

        # --- execute prefill chunks (the completing chunk emits a token,
        #     vLLM-style: recompute-resume also re-emits its next token)
        completed_prefill = []
        for req, chunk in plan.prefill:
            completing = req.prompt_pos + chunk >= req.prefill_target
            if completing and not self.virtual_clock:
                tok = self.runner.prefill(req, chunk)
            else:
                tok = 0
            req.prompt_pos += chunk
            self._prefill_total += chunk
            if completing:
                # recompute-resume done: fold the regenerated prefix back out
                # of prompt_pos, else context_len double-counts it forever
                # (each resumed request would hold ~resume_extra phantom KV
                # tokens, inflating pool pressure for its whole decode)
                req.prompt_pos -= req.resume_extra
                req.resume_extra = 0
                req.output.append(tok)
                req.generated += 1
                self._gen_total += 1
                completed_prefill.append(req)
            self.emitter.emit("prefill", rid=req.rid, ref=req, chunk=chunk,
                              completing=completing)

        # --- execute decode batch
        if plan.decode and not self.virtual_clock:
            toks = self.runner.decode(plan.decode)
            for r, t in zip(plan.decode, toks):
                r.output.append(t)
                r.generated += 1
        elif plan.decode:
            for r in plan.decode:
                r.output.append(0)
                r.generated += 1
        self._gen_total += len(plan.decode)
        if plan.decode:
            self.emitter.emit("decode_step",
                              rids=[r.rid for r in plan.decode])

        # --- advance the clock
        if self.virtual_clock:
            dt, parts = self.runner.iteration_time(plan.prefill_tokens,
                                                   plan.decode)
            self.now += dt
            hbm_busy = self.runner.hbm_busy_fraction(parts, dt) \
                if dt else 0.0
        else:
            # lint: disable=REP002 (real-execution path: wall time IS now)
            # (the virtual-clock branch above never reaches this line)
            self.now += time.monotonic() - t0
            hbm_busy = 0.0

        # --- timestamps after the iteration completes
        for req in completed_prefill:
            if req.t_first_token is None:
                req.t_first_token = self.now
        for r in plan.decode:
            r.decode_times.append(self.now)

        # --- finish
        for req in [*plan.decode, *completed_prefill]:
            if req in self.sched.running and req.done and req.prefill_done:
                req.t_finished = self.now
                self.sched.finish(req)
                if not self.virtual_clock:
                    self.runner.release(req)
                self.emitter.emit("finish", rid=req.rid, ref=req,
                                  generated=req.generated,
                                  n_preemptions=req.n_preemptions)

        # --- preempted requests lose their runner slot
        if not self.virtual_clock:
            for r in plan.preempted:
                self.runner.release(r)

        # --- telemetry + autotune
        self._steps += 1
        if self._steps % self.ecfg.snapshot_every == 0:
            # the payload is the complete per-step telemetry surface: the
            # repro.obs window folds must be computable from the stream
            # alone (absolute page counts and the live concurrency cap, not
            # just ratios — the cap can move under the autotuner)
            self.emitter.emit(
                "step", running=len(self.sched.running),
                waiting=len(self.sched.waiting),
                kv_util=self.alloc.utilization(),
                kv_frag=self.alloc.internal_fragmentation(),
                gen_tokens=self._gen_total,
                prefill_tokens=self._prefill_total,
                preemptions=self.sched.n_preemptions,
                hbm_busy=hbm_busy,
                kv_pages_used=self.alloc.used_pages,
                kv_pages_free=self.alloc.free_pages,
                max_seqs=self.sched.cfg.max_num_seqs)
        if self.ecfg.autotune:
            self.sched.cfg.max_num_seqs = self.autotuner.update(
                kv_util=self.alloc.utilization(),
                preemptions_total=self.sched.n_preemptions,
                waiting=len(self.sched.waiting),
                running=len(self.sched.running))
        if self._sanitizer is not None:
            self._sanitizer.check()
        return True

    def run(self, max_steps: int = 10 ** 7):
        for _ in range(max_steps):
            if not self.step():
                break
        return self.metrics
