"""Synthetic Natural-Reasoning workload (paper §III-B, Fig 1).

Matches the paper's published distribution stats:
  * ISL: 77% of prompts 50-150 tokens, very few > 300
  * OSL: 45% of responses exceed 5000 tokens (heavy-tailed reasoning traces)
plus a "chat" profile (OSL ~ 500) for the reasoning-vs-chat contrast.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str = "natural_reasoning"
    isl_mode: float = 95.0
    isl_sigma: float = 0.45
    isl_max: int = 1024
    osl_median: float = 4200.0
    osl_sigma: float = 1.05
    osl_max: int = 32768

    def chatty(self) -> "WorkloadSpec":
        return dataclasses.replace(self, name="chat", osl_median=350.0,
                                   osl_sigma=0.7, osl_max=2048)

    def long_context(self) -> "WorkloadSpec":
        """RAG/agentic profile: kilotoken prompts, same reasoning-heavy OSL —
        the regime where prefill chunks materially stall colocated decode
        (§III phase divergence)."""
        return dataclasses.replace(self, name="long_context_reasoning",
                                   isl_mode=1200.0, isl_sigma=0.5,
                                   isl_max=6000)


CHAT = WorkloadSpec().chatty()
REASONING = WorkloadSpec()
LONG_REASONING = WorkloadSpec().long_context()


def sample(spec: WorkloadSpec, n: int, seed: int = 0
           ) -> List[Tuple[int, int]]:
    """Returns [(isl, osl)] * n."""
    rng = np.random.default_rng(seed)
    isl = np.clip(rng.lognormal(np.log(spec.isl_mode), spec.isl_sigma, n),
                  8, spec.isl_max).astype(int)
    osl = np.clip(rng.lognormal(np.log(spec.osl_median), spec.osl_sigma, n),
                  16, spec.osl_max).astype(int)
    return list(zip(isl.tolist(), osl.tolist()))


def profile(spec: WorkloadSpec, n: int = 100_000, seed: int = 0):
    """Distribution stats mirroring the paper's Fig 1 analysis."""
    s = sample(spec, n, seed)
    isl = np.array([a for a, _ in s])
    osl = np.array([b for _, b in s])
    return {
        "isl_50_150": float(((isl >= 50) & (isl <= 150)).mean()),
        "isl_gt_300": float((isl > 300).mean()),
        "osl_gt_5000": float((osl > 5000).mean()),
        "mean_isl": float(isl.mean()),
        "mean_osl": float(osl.mean()),
    }
