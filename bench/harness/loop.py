"""The measured window: the benchmark's clock, its spans around the
runner's calls, each request's token times, and the closed and open
loops that feed the engine.

``InferenceEngine.step()`` runs in real-clock mode; before each step the
engine's clock is advanced to the benchmark's (``advance_to``), and a
request is submitted when it is due, with ``arrival=`` its due time. A
token's time is the end of the step that appended it to ``req.output``."""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Optional

import numpy as np

from torch.profiler import record_function

from harness import traffic as tr

clock = time.perf_counter
# the most seconds a set-up may step the engine before the run gives up
SETUP_LIMIT_S = 240.0


class Spans:
    """Host spans around ``runner.decode`` and ``runner.prefill`` (each
    ends in a copy of the tokens to the host, so a span ends when the
    device has finished its work), and the token times of every request."""

    def __init__(self):
        self.decode: List[tuple] = []       # (t0, t1, positions of the rows)
        self.prefill: List[tuple] = []      # (t0, t1, tokens prefilled)
        self.traced_decode: List[tuple] = []
        self.traced_prefill: List[tuple] = []
        self.tracing = False
        self.touched: List = []
        self.times: Dict[int, List[float]] = {}
        self.seen: Dict[int, int] = {}

    def range(self, name: str):
        return record_function(name) if self.tracing else contextlib.nullcontext()

    def wrap(self, runner):
        decode, prefill = runner.decode, runner.prefill

        def timed_decode(reqs):
            t0 = clock()
            positions = [r.context_len - 1 for r in reqs]
            with self.range("bench.decode"):
                out = decode(reqs)
            (self.traced_decode if self.tracing else self.decode).append(
                (t0, clock(), positions))
            self.touched.extend(reqs)
            return out

        def timed_prefill(req, chunk):
            t0 = clock()
            n = req.isl + req.resume_extra
            with self.range("bench.prefill"):
                out = prefill(req, chunk)
            (self.traced_prefill if self.tracing else self.prefill).append((t0, clock(), n))
            self.touched.append(req)
            return out

        runner.decode, runner.prefill = timed_decode, timed_prefill

    def clear(self):
        self.decode.clear()
        self.prefill.clear()

    def stamp(self, t: float) -> List:
        """After a step: the time of each new token; the requests the step
        touched."""
        touched, self.touched = self.touched, []
        for r in touched:
            n = len(r.output)
            if n > self.seen.get(r.rid, 0):
                self.times.setdefault(r.rid, []).extend([t] * (n - self.seen.get(r.rid, 0)))
                self.seen[r.rid] = n
        return touched


class Loop:
    """Feeds one engine from a mix and steps it.

    ``submit(prompt, n, due)`` records each request with its due time on
    the benchmark's clock (``t_ref`` is the engine's time 0)."""

    def __init__(self, eng, spans: Spans, mix: Dict, seed: int, vocab: int,
                 max_num_seqs: int):
        self.eng = eng
        self.spans = spans
        self.mix = mix
        self.seed = seed
        self.prompts = tr.Prompts(seed, vocab)
        self.max_num_seqs = max_num_seqs
        self.t_ref = clock()
        self.requests: List = []           # every request submitted, in order
        self.due: Dict[int, float] = {}    # rid -> due time (benchmark clock)
        self.late: Dict[int, float] = {}   # rid -> submitted after due (s)
        self.refused = 0
        self.fresh = None
        self.n_fresh = 0
        self._closed = set()               # rids whose client has resubmitted
        self.on_step: Optional[Callable] = None
        self.steps = 0                     # engine steps taken

    def submit(self, isl: int, osl: int, due: Optional[float] = None):
        now = clock()
        due = now if due is None else due
        try:
            req = self.eng.submit(self.prompts(isl), osl, arrival=due - self.t_ref)
        except ValueError:
            self.refused += 1
            return None
        self.requests.append(req)
        self.due[req.rid] = due
        self.late[req.rid] = now - due
        return req

    def step(self) -> bool:
        self.eng.advance_to(clock() - self.t_ref)
        with self.spans.range("bench.engine"):
            worked = self.eng.step()
        self.steps += 1
        touched = self.spans.stamp(clock())
        if self.mix["loop"] == "closed":
            for r in touched:
                if r.t_finished is not None and r.rid not in self._closed:
                    self._closed.add(r.rid)
                    self.submit(*self.next_fresh())
        return worked

    # ------------------------------------------------------------ closed
    def next_fresh(self):
        if self.fresh is None:
            n = int(self.mix.get("fresh_pool", 1024))
            pool = tr.size_pool(self.mix, n)
            self.fresh = [pool[i] for i in tr.order(self.seed, n, 2)]
        isl, osl = self.fresh[self.n_fresh % len(self.fresh)]
        self.n_fresh += 1
        return isl, osl

    def inflight(self, admission, alloc, request_type) -> List:
        """The largest stratified in-flight set that the engine's kv-aware
        admission takes at once, at most ``clients`` (or max_num_seqs)."""
        cap = int(self.mix.get("clients") or self.max_num_seqs)
        for n in range(min(cap, self.max_num_seqs), 0, -1):
            pool = tr.inflight_pool(self.mix, n)
            cand = [request_type(rid=-1 - i, prompt=[0] * (isl + prog),
                                 max_new_tokens=osl - prog)
                    for i, (isl, osl, prog) in enumerate(pool)]
            if admission.admit(cand[-1], cand[:-1], alloc):
                return pool
        raise ValueError("not one in-flight sequence fits the pool")

    def setup_closed(self, request_type):
        """Submit the in-flight set in the seed's order and step the
        engine until each of its sequences has its first token."""
        pool = self.inflight(self.eng.sched.admission, self.eng.alloc, request_type)
        seeded = [self.submit(isl + prog, osl - prog)
                  for isl, osl, prog in (pool[i] for i in tr.order(self.seed, len(pool), 1))]
        deadline = clock() + SETUP_LIMIT_S
        while any(r is not None and not r.output for r in seeded):
            if clock() > deadline:
                raise RuntimeError(f"the in-flight set was not prefilled in {SETUP_LIMIT_S} s")
            self.step()
        return len(pool)

    # ------------------------------------------------------------- open
    def warm_up(self):
        """Before the first arrival: one prompt of the mix's median length
        through prefill and decode, so that every kernel library is built
        and loaded in set-up (a checkout's first run builds them) and no
        arrival queues behind it. Its token ids come from a stream of
        their own, so the mix's prompts are the same with it as without."""
        rng = np.random.default_rng([self.seed, 5])
        warm = self.eng.submit(rng.integers(0, self.prompts.vocab,
                                            size=int(self.mix["isl"]["median"])).tolist(), 2)
        deadline = clock() + SETUP_LIMIT_S
        while warm.t_finished is None:
            if clock() > deadline:
                raise RuntimeError(f"the warm-up request did not finish in {SETUP_LIMIT_S} s")
            self.step()

    def schedule(self, seconds: float):
        """Due times from now over the warm-in and the window."""
        rate = float(self.mix["rate_per_s"])
        total = float(self.mix["warmin_s"]) + seconds
        n = int(rate * total * 1.25) + 16
        sizes = tr.size_pool(self.mix, n)
        sizes = [sizes[i] for i in tr.order(self.seed, n, 2)]
        gaps = tr.gaps(rate, n)[tr.order(self.seed, n, 3)]
        t0 = clock()
        dues = t0 + gaps.cumsum()
        return [(float(t), isl, osl) for t, (isl, osl) in zip(dues, sizes)]

    def run_open(self, plan, until: float, at: int) -> int:
        """Submit what falls due and step the engine until ``until``;
        returns the index of the next due request."""
        while True:
            now = clock()
            if now >= until:
                return at
            while at < len(plan) and plan[at][0] <= now:
                self.submit(plan[at][1], plan[at][2], due=plan[at][0])
                at += 1
            if self.eng.has_work:
                self.step()
                if self.on_step:
                    self.on_step()
            else:
                # idle until the next request is due
                nxt = min(plan[at][0] if at < len(plan) else until, until)
                time.sleep(min(max(0.0, nxt - clock()), 5e-4))

    def run_closed(self, until: float):
        while clock() < until:
            self.step()
            if self.on_step:
                self.on_step()
