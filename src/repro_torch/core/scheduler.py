"""Continuous-batching FCFS scheduler with chunked prefill and preemption
(vLLM-v1 semantics, paper §II-C / §VI-C).

Each engine step builds one iteration batch:
  1. decode slots: one token for every RUNNING request past prefill;
     growing a sequence across a page boundary may require a new page —
     if the pool is exhausted, the *youngest* running request is preempted
     (freed + requeued at the waiting-front for recompute), matching vLLM's
     recompute-mode preemption.
  2. chunked prefill: remaining token budget (max_num_batched_tokens) is
     filled greedily from admitted requests' outstanding prompt chunks.
  3. admission: WAITING requests enter while the AdmissionPolicy allows and
     the concurrency cap (max_num_seqs, possibly autotuned) has room.

Multi-tenant SLO classes (the admission policy's ``ClassPolicy``): a newly
submitted request of a more urgent class is inserted ahead of waiting
lower-urgency requests (never ahead of preempted requests, whose
resume-first position is the forward-progress guarantee), and preemption
victims are drawn from the least urgent running class first — interactive
requests jump batch queues and evict batch KV, batch absorbs the
backpressure.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core.admission import AdmissionPolicy
from repro_torch.core.kv_cache import KVView, PagedAllocator
from repro_torch.core.request import Request, State


def victim_order(urgency: int, arrival: float, rid: int) -> Tuple:
    """The victim total order shared by engine preemption and cluster
    rebalancing: least urgent class first, then most recently arrived, ties
    broken by rid (strict total order). ``max`` under this key is the
    canonical victim — evicting (or migrating) it minimises lost work under
    FCFS and never touches the oldest request, preserving the
    forward-progress guarantee."""
    return (-urgency, arrival, rid)


@dataclasses.dataclass
class SchedulerConfig:
    max_num_seqs: int = 256
    max_num_batched_tokens: int = 2048
    chunk_size: int = 512
    prefill_only: bool = False   # disaggregated prefill worker: requests are
                                 # ejected after their first token, so only
                                 # the prompt (not the OSL) must fit the pool


@dataclasses.dataclass
class StepPlan:
    decode: List[Request]
    prefill: List[Tuple[Request, int]]       # (request, chunk_len)
    preempted: List[Request]
    admitted: List[Request]

    @property
    def prefill_tokens(self) -> int:
        return sum(c for _, c in self.prefill)


class Scheduler:
    def __init__(self, cfg: SchedulerConfig, alloc: PagedAllocator,
                 admission: Optional[AdmissionPolicy] = None):
        self.cfg = cfg
        self.alloc = alloc
        self.admission = admission or AdmissionPolicy()
        self.waiting: Deque[Request] = deque()
        self.running: List[Request] = []
        self.n_preemptions = 0
        # event spine (repro.trace): the owning engine wires its emitter in
        # — admit/resume/preempt are emitted HERE, at the transition itself
        self.emitter = None

    # ------------------------------------------------------------------ api
    def validate(self, req: Request):
        capacity = self.alloc.n_pages * self.alloc.page_size
        peak = req.isl + (1 if self.cfg.prefill_only else req.max_new_tokens)
        if peak + 1 > capacity:
            raise ValueError(
                f"request {req.rid}: context {peak} "
                f"exceeds KV pool capacity {capacity} tokens")

    def submit(self, req: Request):
        self.validate(req)
        self._enqueue(req)

    def _enqueue(self, req: Request):
        """Class-priority insert: jump ahead of strictly-less-urgent waiting
        requests, but never ahead of an equal/higher tier (FCFS within a
        class) and never ahead of a PREEMPTED request — preempted victims
        resume first or the recompute-livelock guard breaks."""
        urg = self.admission.classes.urgency
        pos = len(self.waiting)
        while pos > 0:
            ahead = self.waiting[pos - 1]
            if ahead.state is State.PREEMPTED \
                    or urg(ahead.slo_class) >= urg(req.slo_class):
                break
            pos -= 1
        self.waiting.insert(pos, req)

    def inject_running(self, req: Request) -> bool:
        """Adopt a migrated (prefill-complete) request directly into the
        running set, allocating pages for its existing context. Returns False
        when the concurrency cap or the page pool has no room."""
        if len(self.running) >= self.cfg.max_num_seqs:
            return False
        if not self.alloc.grow(req.rid, req.context_len):
            return False
        req.state = State.RUNNING
        self.running.append(req)
        return True

    @property
    def has_work(self) -> bool:
        return bool(self.waiting or self.running)

    def plan_step(self) -> StepPlan:
        preempted: List[Request] = []
        admitted: List[Request] = []

        # 1) decode set — grow pages; preempt youngest on exhaustion.
        # Strict FCFS order (arrival, rid): the oldest request is never a
        # victim, guaranteeing forward progress (no preemption livelock).
        decode: List[Request] = []
        for req in list(sorted(self.running, key=lambda r: (r.arrival, r.rid))):
            if not req.prefill_done:
                continue
            if req not in self.running:      # already preempted this step
                continue
            while not self.alloc.grow(req.rid, req.context_len + 1):
                victim = self._pick_victim(exclude=req)
                if victim is None:
                    # nothing younger to evict: requeue req itself (possible
                    # only transiently — submit() validates it fits alone)
                    self._preempt(req, preempted)
                    break
                self._preempt(victim, preempted)
                if victim in decode:
                    # victim already planned this step: un-plan it, or it
                    # would emit a token whose KV was just freed and then
                    # re-emit the same token after recompute-resume
                    decode.remove(victim)
            if req in self.running:
                decode.append(req)

        # 2) chunked prefill under the token budget
        budget = self.cfg.max_num_batched_tokens - len(decode)
        prefill: List[Tuple[Request, int]] = []
        for req in self.running:
            if req.prefill_done or budget <= 0 or req in preempted:
                continue
            chunk = min(self.cfg.chunk_size,
                        req.prefill_target - req.prompt_pos, budget)
            if chunk <= 0:
                continue
            if not self.alloc.grow(req.rid, req.prompt_pos + chunk):
                continue                      # prefill throttled (no preempt)
            prefill.append((req, chunk))
            budget -= chunk

        # 3) admission — backpressured: a step that preempted admits nothing
        # (otherwise the resumed victim steals back the pages the preemptor
        # just freed and the pair cycles forever — the thrash regime of Obs 1
        # turned into a livelock)
        while (not preempted and self.waiting
               and len(self.running) < self.cfg.max_num_seqs
               and budget > 0):
            cand = self.waiting[0]
            # the admission budget is judged against a frozen KV snapshot —
            # the same decision-plane view (repro.cluster.view) the cluster
            # policies consume — taken at this decision point (per candidate:
            # an admitted candidate's prefill grow must be visible to the
            # next admit, exactly as the live allocator read was)
            if not self.admission.admit(cand, self.running,
                                        KVView.of(self.alloc)):
                break
            chunk = min(self.cfg.chunk_size, cand.prefill_target, budget)
            if chunk <= 0 or not self.alloc.grow(cand.rid, chunk):
                break
            self.waiting.popleft()
            resumed = cand.state is State.PREEMPTED
            cand.state = State.RUNNING
            self.running.append(cand)
            admitted.append(cand)
            prefill.append((cand, chunk))
            budget -= chunk
            if self.emitter is not None:
                if resumed:
                    self.emitter.emit("resume", rid=cand.rid, ref=cand,
                                      resume_extra=cand.resume_extra)
                else:
                    self.emitter.emit("admit", rid=cand.rid, ref=cand)

        return StepPlan(decode=decode, prefill=prefill, preempted=preempted,
                        admitted=admitted)

    def finish(self, req: Request):
        self.running.remove(req)
        self.alloc.free(req.rid)
        req.state = State.FINISHED
        self.admission.estimator.observe(req.generated)

    # ------------------------------------------------------------- internals
    def _pick_victim(self, exclude: Request) -> Optional[Request]:
        """vLLM recompute preemption, class-aware: evict from the least
        urgent running class first, and within a class the most recently
        arrived request (minimises lost work under FCFS). Ties broken by rid
        so the order is a strict total order. Single-class fleets reduce to
        the original youngest-victim rule, keeping its forward-progress
        guarantee (the oldest request is never a victim); across classes the
        guarantee holds per tier — the preemptor always makes progress, so a
        batch victim thrashing under interactive pressure is backpressure,
        not livelock."""
        urg = self.admission.classes.urgency
        cands = [r for r in self.running if r is not exclude]
        if not cands:
            return None
        return max(cands, key=lambda r: victim_order(urg(r.slo_class),
                                                     r.arrival, r.rid))

    def _preempt(self, req: Request, out: List[Request]):
        if self.emitter is not None:
            # capture the victim's cost before the recompute reset wipes it
            self.emitter.emit("preempt", rid=req.rid, ref=req,
                              generated=req.generated,
                              lost_tokens=req.context_len)
        self.alloc.free(req.rid)
        self.running.remove(req)
        # recompute mode: the whole context (prompt + generated-so-far) must
        # be prefill-recomputed on resume
        req.recomputed_tokens += req.context_len
        req.resume_extra = req.generated
        req.prompt_pos = 0
        req.state = State.PREEMPTED
        req.n_preemptions += 1
        self.n_preemptions += 1
        self.waiting.appendleft(req)          # resumes first (FCFS order)
        out.append(req)
