"""Event-level trace differ: are two runs the *same run*?

Summary-identical is a weak guarantee — two runs can agree on every
aggregate and still have routed, preempted and migrated differently (the
divergence just cancelled). The differ compares streams event by event and
reports the FIRST divergence with surrounding context, which is exactly
where a determinism bug entered: everything before the reported index is
identical, so the named event is the earliest observable symptom.

``python -m repro_torch.trace diff a.jsonl b.jsonl`` exits 0 when the streams are
event-identical and 1 otherwise (lint-style, CI-friendly).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Union

from repro_torch.trace.events import Event


def _rows(events: Sequence[Union[Event, Dict[str, Any]]]
          ) -> List[Dict[str, Any]]:
    return [e.to_dict() if isinstance(e, Event) else e for e in events]


def _fmt(row: Dict[str, Any]) -> str:
    rid = "" if row.get("rid") is None else f" rid={row['rid']}"
    w = f" @{row['worker']}" if row.get("worker") else ""
    payload = row.get("payload") or {}
    extra = " ".join(f"{k}={payload[k]}" for k in sorted(payload))
    return f"t={row['t']:.6f} {row['kind']}{rid}{w}" \
           + (f" {extra}" if extra else "")


@dataclasses.dataclass(frozen=True)
class DiffResult:
    """Outcome of comparing two streams. ``index`` is the first position
    where they disagree (None when identical); ``fields`` names the event
    fields that differ there (empty when one stream simply ended)."""
    n_a: int
    n_b: int
    index: Optional[int]
    fields: tuple = ()
    report_lines: tuple = ()

    @property
    def identical(self) -> bool:
        return self.index is None and self.n_a == self.n_b

    def report(self) -> str:
        return "\n".join(self.report_lines)


def diff_events(a: Sequence[Union[Event, Dict[str, Any]]],
                b: Sequence[Union[Event, Dict[str, Any]]],
                context: int = 3,
                label_a: str = "a", label_b: str = "b") -> DiffResult:
    """Positional comparison of two event streams.

    Returns a :class:`DiffResult` whose ``report()`` is human-readable: the
    first diverging index, the differing fields, both events, and the last
    ``context`` identical events leading up to the divergence (the shared
    prefix that localises the bug)."""
    ra, rb = _rows(a), _rows(b)
    n = min(len(ra), len(rb))
    for i in range(n):
        if ra[i] == rb[i]:
            continue
        fields = tuple(k for k in ("t", "kind", "rid", "worker", "payload")
                       if ra[i].get(k) != rb[i].get(k))
        lines = [f"streams diverge at event {i} "
                 f"(of {len(ra)} in {label_a}, {len(rb)} in {label_b}); "
                 f"differing fields: {', '.join(fields) or '?'}"]
        lo = max(i - context, 0)
        for j in range(lo, i):
            lines.append(f"  = [{j}] {_fmt(ra[j])}")
        lines.append(f"  < [{i}] {_fmt(ra[i])}   ({label_a})")
        lines.append(f"  > [{i}] {_fmt(rb[i])}   ({label_b})")
        return DiffResult(n_a=len(ra), n_b=len(rb), index=i, fields=fields,
                          report_lines=tuple(lines))
    if len(ra) != len(rb):
        longer, ln = (label_a, ra) if len(ra) > len(rb) else (label_b, rb)
        lines = [f"streams identical for {n} events, then {longer} "
                 f"continues ({len(ra)} vs {len(rb)} events)"]
        for j in range(n, min(n + context, len(ln))):
            lines.append(f"  + [{j}] {_fmt(ln[j])}   ({longer} only)")
        return DiffResult(n_a=len(ra), n_b=len(rb), index=n,
                          report_lines=tuple(lines))
    return DiffResult(
        n_a=len(ra), n_b=len(rb), index=None,
        report_lines=(f"streams identical: {len(ra)} events",))
