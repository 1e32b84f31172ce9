"""Online concurrency autotuner (paper Observation 2).

"The optimal operating point is the batch size where TTFT reduction no longer
compensates for TPOT degradation. This motivates online batch-size tuning
using TTFT, TPOT, KV occupancy, and HBM bandwidth as feedback signals."

Hill-climbs max_num_seqs between bounds: backs off multiplicatively on
preemption/KV-pressure, probes upward additively when the queue is deep and
KV has headroom.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class AutotunerConfig:
    enabled: bool = True
    min_seqs: int = 8
    max_seqs: int = 4096
    kv_high: float = 0.92
    kv_low: float = 0.70
    backoff: float = 0.8
    probe: int = 16
    interval: int = 16          # engine steps between adjustments


class ConcurrencyAutotuner:
    def __init__(self, cfg: AutotunerConfig, initial: int):
        self.cfg = cfg
        self.value = initial
        self._steps = 0
        self._preempts_seen = 0

    def update(self, *, kv_util: float, preemptions_total: int,
               waiting: int, running: int) -> int:
        if not self.cfg.enabled:
            return self.value
        self._steps += 1
        if self._steps % self.cfg.interval:
            return self.value
        new_preempts = preemptions_total - self._preempts_seen
        self._preempts_seen = preemptions_total
        if new_preempts > 0 or kv_util > self.cfg.kv_high:
            # capacity trap territory: shed concurrency (Obs 1)
            self.value = max(int(self.value * self.cfg.backoff),
                             self.cfg.min_seqs)
        elif waiting > 0 and kv_util < self.cfg.kv_low:
            # queue-bound with headroom: admit more (TTFT side of Obs 2)
            self.value = min(self.value + self.cfg.probe, self.cfg.max_seqs)
        return self.value
