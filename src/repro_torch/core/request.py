"""Request lifecycle (paper §III-D Request Lifecycle Tracking)."""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional


class State(enum.Enum):
    WAITING = "waiting"
    RUNNING = "running"
    PREEMPTED = "preempted"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]                  # token ids (real exec) — len == ISL
    max_new_tokens: int                # OSL budget
    arrival: float = 0.0
    slo_class: str = ""                # SLO-class tag (multi-tenant tiers);
                                       # "" = the scenario's default class
    # progress
    state: State = State.WAITING
    prompt_pos: int = 0                # chunked-prefill progress
    resume_extra: int = 0              # generated tokens to re-prefill after preemption
    generated: int = 0
    output: List[int] = dataclasses.field(default_factory=list)
    slot: Optional[int] = None         # decode slot (real exec)
    # timestamps
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finished: Optional[float] = None
    n_preemptions: int = 0
    recomputed_tokens: int = 0         # prefill work redone after preemption
    # decode-time bookkeeping
    decode_times: List[float] = dataclasses.field(default_factory=list)

    @property
    def isl(self) -> int:
        return len(self.prompt)

    @property
    def prefill_target(self) -> int:
        """Tokens needing prefill: prompt + regenerated prefix after
        recompute-mode preemption."""
        return self.isl + self.resume_extra

    @property
    def context_len(self) -> int:
        """Tokens whose KV is in cache."""
        return self.prompt_pos + self.generated - self.resume_extra

    @property
    def prefill_done(self) -> bool:
        return self.prompt_pos >= self.prefill_target

    @property
    def done(self) -> bool:
        return self.generated >= self.max_new_tokens

    # ---- service metrics -------------------------------------------------
    def ttft(self) -> Optional[float]:
        return None if self.t_first_token is None else \
            self.t_first_token - self.arrival

    def tpot(self) -> Optional[float]:
        if self.t_finished is None or self.t_first_token is None \
                or self.generated <= 1:
            return None
        return (self.t_finished - self.t_first_token) / (self.generated - 1)

    def e2e(self) -> Optional[float]:
        return None if self.t_finished is None else \
            self.t_finished - self.arrival

    def waiting_time(self) -> Optional[float]:
        return None if self.t_admitted is None else \
            self.t_admitted - self.arrival
