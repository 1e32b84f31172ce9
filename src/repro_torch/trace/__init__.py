"""repro_torch.trace — the typed event spine under engine, cluster and autoscaler.

See ``docs/trace.md`` for the schema and ``python -m repro_torch.trace diff`` for
the replay differ."""
from repro_torch.trace.diff import DiffResult, diff_events
from repro_torch.trace.events import KINDS, Event, EventEmitter, EventLog
from repro_torch.trace.jsonl import (JsonlWriter, dump_events, iter_events,
                               load_events)

__all__ = [
    "KINDS", "Event", "EventEmitter", "EventLog",
    "JsonlWriter", "dump_events", "iter_events", "load_events",
    "DiffResult", "diff_events",
]
