"""The one traffic generator: it reads a mix's parameters and makes its
requests from ``--seed``.

Lengths are lognormal (``median``, ``sigma``), clipped to [``min``,
``max``] and floored, as the reasoning and chat profiles of the program's
``data/reasoning.py`` draw them. They are drawn by stratified quantiles,
so every seed gets the same set of sizes and of gaps between arrivals;
the seed orders them and picks the token ids. The work of a run is then
the same on every seed, and two seeds differ as two runs of one seed do.

Mixes:
  * ``closed``: at set-up the engine prefills an
    in-flight set, sequences caught at a random moment of their lives: an
    output length drawn in proportion to its length, a progress uniform in
    [0, OSL), a context of ISL plus progress. The set is as large as the
    engine's kv-aware admission takes (at most ``clients``, or
    ``max_num_seqs``). In the window each finished request's client sends
    a fresh one.
  * ``open``: arrivals at ``rate_per_s`` with exponential gaps, submitted
    when due whatever the engine is doing; a warm-in of ``warmin_s``
    seconds before the window is set-up that the traffic needs.
"""
from __future__ import annotations

import math
from statistics import NormalDist
from typing import Dict, List, Tuple

import numpy as np

# the order in which stratified quantiles are paired (ISL with OSL, OSL
# with progress) and in which the in-flight set is cut: fixed, so that no
# seed changes a size
_PAIRING = 20251019


def strata(n: int) -> np.ndarray:
    """n stratified uniform quantiles in (0, 1)."""
    return (np.arange(n) + 0.5) / n


def lengths(dist: Dict, u: np.ndarray) -> np.ndarray:
    """Lognormal lengths at quantiles ``u``, clipped and floored."""
    z = np.array([NormalDist().inv_cdf(float(x)) for x in u])
    x = np.exp(math.log(dist["median"]) + dist["sigma"] * z)
    return np.clip(x, dist["min"], dist["max"]).astype(np.int64)


def _paired(n: int, k: int) -> List[np.ndarray]:
    """k fixed permutations of n strata: column j's order."""
    rng = np.random.default_rng(_PAIRING)
    return [rng.permutation(n) for _ in range(k)]


def size_pool(mix: Dict, n: int) -> List[Tuple[int, int]]:
    """n (ISL, OSL) pairs, the same for every seed, in a fixed order."""
    u = strata(n)
    pi, po = _paired(n, 2)
    return list(zip(lengths(mix["isl"], u[pi]).tolist(),
                    lengths(mix["osl"], u[po]).tolist()))


def inflight_pool(mix: Dict, n: int) -> List[Tuple[int, int, int]]:
    """n (ISL, OSL, progress) triples of sequences in flight at a random
    moment: OSL drawn in proportion to its length, progress uniform in
    [0, OSL)."""
    fine = lengths(mix["osl"], strata(1 << 16)).astype(np.float64)
    cum = np.cumsum(fine) / fine.sum()
    u = strata(n)
    pi, po, pp = _paired(n, 3)
    osl = fine[np.minimum(np.searchsorted(cum, u[po]), len(fine) - 1)].astype(np.int64)
    isl = lengths(mix["isl"], u[pi])
    progress = np.minimum((u[pp] * osl).astype(np.int64), osl - 1)
    return list(zip(isl.tolist(), osl.tolist(), progress.tolist()))


def gaps(rate: float, n: int) -> np.ndarray:
    """n exponential gaps of mean 1/rate at stratified quantiles."""
    return -np.log1p(-strata(n)) / rate


class Prompts:
    """Token ids of every prompt, uniform over the vocabulary, from the seed."""

    def __init__(self, seed: int, vocab: int):
        self.rng = np.random.default_rng([seed, 1])
        self.vocab = vocab

    def __call__(self, n: int) -> List[int]:
        return self.rng.integers(0, self.vocab, size=n).tolist()


def order(seed: int, n: int, stream: int) -> np.ndarray:
    """The seed's order of n items (``stream`` tells the uses apart)."""
    return np.random.default_rng([seed, stream]).permutation(n)
