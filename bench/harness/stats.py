"""Percentiles and spreads, as the benchmark reports and bounds them."""
from __future__ import annotations

import statistics
from typing import Sequence

import numpy as np


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile of every value (numpy's linear interpolation)."""
    if not len(values):
        raise ValueError("no values")
    return float(np.percentile(np.asarray(values, np.float64), q))


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles, as Python's
    ``statistics.quantiles(values, n=4)`` gives them, as a share of the
    median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def tokens_in_window(times, t_start: float, t_close: float) -> int:
    """Tokens appended by steps that ended inside the window."""
    return sum(1 for ts in times.values() for t in ts if t_start <= t <= t_close)


def inter_token_gaps(times, t_start: float, t_close: float):
    """Every gap between two consecutive tokens of a request whose later
    token came in the window (the earlier one may precede it)."""
    out = []
    for ts in times.values():
        out.extend(b - a for a, b in zip(ts, ts[1:]) if t_start <= b <= t_close)
    return out


def ttfts(times, due, due_in_window, t_start: float, t_close: float):
    """Time to first token from the due time, of every request due in the
    window; one with no first token at the close counts its age then."""
    first = {}
    for rid, d in due.items():
        if t_start <= d < t_close:
            ts = times.get(rid)
            first[d] = (ts[0] if ts and ts[0] <= t_close else t_close) - d
    return [first.get(d, t_close - d) for d in due_in_window]
