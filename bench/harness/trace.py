"""The fold of a ``torch.profiler`` trace of a run of steps: device time by
kernel symbol, the device time under named host ranges (the MoE layer's
``moe_dispatch`` and ``moe_combine``), busy time as the union of every
device operation's interval, and the idle gaps between them, each named
by the benchmark's host span that held the host when the gap began."""
from __future__ import annotations

import re
from typing import Dict, Iterable, List, Tuple

import torch

# the benchmark's own host spans, innermost first when they nest
SPANS = ("bench.prefill", "bench.decode", "bench.engine", "bench.harness")


def union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Merged, sorted intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def short(name: str) -> str:
    """A device operation's name without its template arguments."""
    name = re.sub(r"<.*", "", name).strip()
    return re.sub(r"^(void|at::native::)\s*", "", name)[:100]


def symbol_of(name: str, symbols: Dict[str, Tuple[str, ...]]):
    for group, syms in symbols.items():
        for sym in syms:
            if re.search(rf"(^|[\s:]){sym}(<|\(|$)", name):
                return group, sym
    return None


def fold(events, symbols: Dict[str, Tuple[str, ...]], ranges: Tuple[str, ...],
         window: Tuple[float, float]) -> Dict:
    """``events``: the profiler's ``FunctionEvent``s; times in microseconds.
    ``window`` the traced window on the trace's clock. Returns seconds."""
    device, host = [], []
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append(e)
        elif not (getattr(e, "is_user_annotation", False) or e.name in SPANS
                  or e.name in ranges):
            # a host range's copy on the device timeline spans its first to
            # last kernel, gaps included: not an operation
            device.append(e)
    by_symbol: Dict[str, float] = {}
    by_op: Dict[str, float] = {}
    for e in device:
        dt = (e.time_range.end - e.time_range.start) * 1e-6
        hit = symbol_of(e.name, symbols)
        if hit:
            by_symbol[hit[1]] = by_symbol.get(hit[1], 0.0) + dt
        key = short(e.name)
        by_op[key] = by_op.get(key, 0.0) + dt
    in_ranges = {r: 0.0 for r in ranges}
    spans: List[Tuple[float, float, str]] = []
    for e in host:
        if e.name in in_ranges:
            # the CPU range's device time sums its kernels
            in_ranges[e.name] += e.device_time_total * 1e-6
        elif e.name in SPANS:
            spans.append((e.time_range.start, e.time_range.end, e.name))
    lo, hi = window
    busy = union((max(e.time_range.start, lo), min(e.time_range.end, hi)) for e in device
                 if e.time_range.end > lo and e.time_range.start < hi)
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps: Dict[str, float] = {}
    edges = [lo] + [x for ab in busy for x in ab] + [hi]
    rank = {n: i for i, n in enumerate(SPANS)}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        holding = [n for s, e, n in spans if s <= a < e]
        name = min(holding, key=rank.get) if holding else "outside the benchmark's spans"
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    return {
        "busy_s": busy_s,
        "window_s": (hi - lo) * 1e-6,
        "by_symbol_s": by_symbol,
        "in_ranges_s": in_ranges,
        "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
    }
