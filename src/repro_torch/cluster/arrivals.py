"""Open-loop arrival processes and workload traces (paper §III-B).

Closed-loop, all-at-once submission (every benchmark before the cluster layer)
hides the serving-level dynamics the paper measures: queueing delay, the
first-saturating replica, and the goodput cliff under rising load. The
cluster runtime instead replays an *open-loop* trace — requests arrive on a
stochastic process regardless of completion — which is what "heavy traffic
from millions of users" looks like to a fleet.

``PoissonProcess``   — memoryless arrivals at `rate` req/s (M/G/k baseline).
``GammaProcess``     — gamma inter-arrivals with a coefficient of variation:
                       cv > 1 models bursty traffic, cv < 1 smoothed traffic.
``TraceProcess``     — explicit arrival times (replay a recorded trace).
``PiecewiseRateProcess`` — piecewise-constant-rate Poisson phases
                       (diurnal / ramp / burst): the time-varying load a
                       scaling controller exists to track — constant-rate
                       processes cannot exercise an autoscaler.

``make_trace`` glues a process to the Natural-Reasoning (ISL, OSL) sampler in
``repro_torch.data.reasoning`` producing ``TraceEntry`` rows the runtime replays.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.reasoning import WorkloadSpec, sample


@dataclasses.dataclass(frozen=True)
class TraceEntry:
    arrival: float
    isl: int
    osl: int
    slo_class: str = ""           # multi-tenant tier tag ("" = default class)


class ArrivalProcess:
    """Yields n monotone non-decreasing arrival times starting at t0."""

    def times(self, n: int, seed: int = 0, t0: float = 0.0) -> List[float]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class PoissonProcess(ArrivalProcess):
    rate: float                       # mean arrivals per second

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(
                f"PoissonProcess needs rate > 0 req/s, got {self.rate}")

    def times(self, n: int, seed: int = 0, t0: float = 0.0) -> List[float]:
        rng = np.random.default_rng(seed)
        gaps = rng.exponential(1.0 / self.rate, size=n)
        return (t0 + np.cumsum(gaps)).tolist()


@dataclasses.dataclass(frozen=True)
class GammaProcess(ArrivalProcess):
    """Gamma inter-arrival renewal process: cv=1 is Poisson; cv>1 bursty."""
    rate: float
    cv: float = 2.0                   # coefficient of variation of the gaps

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(
                f"GammaProcess needs rate > 0 req/s, got {self.rate}")
        if self.cv <= 0:
            raise ValueError(f"GammaProcess needs cv > 0 (the gap "
                             f"coefficient of variation), got {self.cv}")

    def times(self, n: int, seed: int = 0, t0: float = 0.0) -> List[float]:
        rng = np.random.default_rng(seed)
        shape = 1.0 / (self.cv ** 2)
        scale = 1.0 / (self.rate * shape)
        gaps = rng.gamma(shape, scale, size=n)
        return (t0 + np.cumsum(gaps)).tolist()


@dataclasses.dataclass(frozen=True)
class TraceProcess(ArrivalProcess):
    arrivals: Sequence[float]

    def times(self, n: int, seed: int = 0, t0: float = 0.0) -> List[float]:
        ts = sorted(self.arrivals)[:n]
        if len(ts) < n:
            raise ValueError(f"trace has {len(ts)} arrivals, need {n}")
        return [t0 + t for t in ts]


@dataclasses.dataclass(frozen=True)
class PiecewiseRateProcess(ArrivalProcess):
    """Nonhomogeneous Poisson with a piecewise-constant rate: ``phases`` is a
    sequence of (duration_s, rate) segments replayed in order. With
    ``repeat=True`` the schedule cycles (a diurnal day repeats); otherwise the
    final phase's rate extends forever. A zero-rate phase is a silent gap —
    arrivals jump over it. Memorylessness makes per-phase sampling exact:
    within a phase, gaps are Exp(rate); at a boundary the partial gap is
    re-drawn at the new rate (valid by the Markov property)."""
    phases: Tuple[Tuple[float, float], ...]
    repeat: bool = True

    def __post_init__(self):
        phases = tuple((float(d), float(r)) for d, r in self.phases)
        object.__setattr__(self, "phases", phases)
        if not phases:
            raise ValueError("PiecewiseRateProcess needs at least one "
                             "(duration_s, rate) phase")
        if any(d <= 0 for d, _ in phases):
            raise ValueError(f"phase durations must be > 0: {phases}")
        if any(r < 0 for _, r in phases):
            raise ValueError(f"phase rates must be >= 0: {phases}")
        if not any(r > 0 for _, r in phases):
            raise ValueError(f"at least one phase needs rate > 0: {phases}")

    def rate_at(self, t: float) -> float:
        """The instantaneous arrival rate at time t (relative to t0)."""
        period = sum(d for d, _ in self.phases)
        if self.repeat:
            t = t % period
        elif t >= period:
            return self.phases[-1][1]
        for d, r in self.phases:
            if t < d:
                return r
            t -= d
        return self.phases[-1][1]

    def times(self, n: int, seed: int = 0, t0: float = 0.0) -> List[float]:
        rng = np.random.default_rng(seed)
        out: List[float] = []
        t = 0.0                       # clock relative to t0
        k = 0                         # phase index
        phase_end = self.phases[0][0]
        while len(out) < n:
            rate = self.phases[k][1]
            if rate <= 0:
                t = phase_end
            else:
                t += rng.exponential(1.0 / rate)
            if t >= phase_end:
                if k + 1 < len(self.phases):
                    k += 1
                elif self.repeat:
                    k = 0
                else:                 # last phase extends forever
                    if rate > 0:
                        out.append(t0 + t)
                    else:
                        raise ValueError(
                            f"non-repeating schedule ends at rate 0 with "
                            f"only {len(out)}/{n} arrivals drawn")
                    continue
                t = phase_end         # re-draw the partial gap (memoryless)
                phase_end += self.phases[k][0]
                continue
            out.append(t0 + t)
        return out


def make_trace(process: ArrivalProcess, spec: WorkloadSpec, n: int,
               seed: int = 0, osl_cap: Optional[int] = None
               ) -> List[TraceEntry]:
    """Open-loop workload: arrival process x Natural-Reasoning (ISL, OSL)."""
    ts = process.times(n, seed=seed)
    lens = sample(spec, n, seed=seed + 1)
    cap = osl_cap or 10 ** 9
    return [TraceEntry(arrival=float(t), isl=int(i), osl=int(min(o, cap)))
            for t, (i, o) in zip(ts, lens)]


def assign_classes(trace: List[TraceEntry],
                   mix: Sequence[Tuple[str, float]],
                   seed: int = 0) -> List[TraceEntry]:
    """Deterministically tag each entry with an SLO class drawn from ``mix``
    (name, weight) pairs — the multi-tenant per-class traffic split. The same
    seed always produces the same tagging, so class-aware and class-blind
    fleets compared on one trace see identical per-request tiers."""
    if not mix:
        return list(trace)
    names = [n for n, _ in mix]
    w = np.asarray([x for _, x in mix], dtype=float)
    if (w < 0).any() or w.sum() <= 0:
        raise ValueError(f"class mix weights must be non-negative with a "
                         f"positive sum: {list(mix)}")
    rng = np.random.default_rng(seed)
    picks = rng.choice(len(names), size=len(trace), p=w / w.sum())
    return [dataclasses.replace(e, slo_class=names[k])
            for k, e in zip(picks, trace)]


def save_trace(path: str, trace: List[TraceEntry]):
    with open(path, "w") as f:
        for e in trace:
            f.write(json.dumps(dataclasses.asdict(e)) + "\n")


def load_trace(path: str) -> List[TraceEntry]:
    out = []
    with open(path) as f:
        for line in f:
            if line.strip():
                d = json.loads(line)
                out.append(TraceEntry(float(d["arrival"]), int(d["isl"]),
                                      int(d["osl"]),
                                      str(d.get("slo_class", ""))))
    return out
