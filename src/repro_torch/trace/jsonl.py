"""JSONL serialisation for event streams.

One event per line, keys in a fixed order, floats serialised by ``repr``
(Python's ``json`` round-trips doubles exactly), so two identical runs
produce byte-identical files and the differ can compare lines structurally
without tolerance fuzz.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Iterable, Iterator, List, Union

from repro_torch.trace.events import Event, EventLog


def event_line(ev: Union[Event, Dict[str, Any]]) -> str:
    d = ev.to_dict() if isinstance(ev, Event) else ev
    return json.dumps(d, sort_keys=True)


def dump_events(events: Iterable[Union[Event, Dict[str, Any]]],
                path: str) -> int:
    """Write a recorded stream to ``path``; returns the event count."""
    n = 0
    with open(path, "w") as f:
        for ev in events:
            f.write(event_line(ev) + "\n")
            n += 1
    return n


def load_events(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def iter_events(path: str) -> Iterator[Dict[str, Any]]:
    with open(path) as f:
        for line in f:
            if line.strip():
                yield json.loads(line)


class JsonlWriter:
    """Streaming subscriber: writes each event as it is emitted, so tracing
    a run needs no in-memory recording. Use as a context manager, or call
    ``close()`` when the run drains::

        with JsonlWriter(path) as w:
            rt.events.subscribe(w)
            rt.run()
    """

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "w")
        self.n = 0

    def __call__(self, ev: Event):
        self._f.write(event_line(ev) + "\n")
        self.n += 1

    def close(self):
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
