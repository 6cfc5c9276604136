"""Spans and counts at the port's layer boundaries, on the profiler's clock.

    from minotaur_tpu_torch.utils import trace
    with trace.span("ipm.solve", lanes=B):
        ...
        trace.count("iters", 1)       # to the innermost open span

Tracing is on exactly while a `torch.profiler` session runs, which each
span checks at its entry: a profiled slice gets the program's spans with
no switch, and an unprofiled run pays one check a span (`span` then
returns one shared no-op object).  `count` returns at once unless the
session is live, and ends it if the profiler has stopped, so counts made
after a profiled slice never reach its records.

A record holds its name, its start and end in Unix nanoseconds
(`time.time_ns()`, the clock on which `torch.profiler` stamps its host
events), the index of its parent record (-1 for none) and its counts.
A record's index is its place in the session:
`spans()[i].index == i + dropped()`.

Each time tracing turns on after being off, a new session starts:
`spans()` returns the newest session's records, the newest `KEEP` of
them.  `self_ns(records)` gives each record's self time: its duration
less the union of its children's.  The tracer never synchronises the
device: every count is a value the host already holds.  Parents assume
one thread opens the spans.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List

from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

KEEP = 1 << 20


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class Record:
    """One span: a context manager while open, a record once closed."""
    __slots__ = ("name", "t0", "t1", "index", "parent", "counts",
                 "_tracer", "_range")

    def __init__(self, tracer, name, index, parent, counts, range_):
        self._tracer, self._range = tracer, range_
        self.name, self.index, self.parent = name, index, parent
        self.counts: Dict[str, float] = counts
        self.t0 = self.t1 = 0

    def __enter__(self):
        self._range.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        self._range.__exit__(None, None, None)
        stack = self._tracer._stack
        if stack and stack[-1] is self:     # not so after a reset()
            stack.pop()
        return False

    def __repr__(self):
        return (f"Record({self.name!r}, {self.t0}, {self.t1}, "
                f"index={self.index}, parent={self.parent}, "
                f"counts={self.counts})")


class Tracer:
    def __init__(self, keep: int = KEEP):
        self._keep = keep
        self._live = False          # the profiler ran at the last check
        self._records: deque = deque(maxlen=keep)
        self._opened = 0            # records opened this session
        self._stack: List[Record] = []

    def reset(self) -> None:
        """Drops every record (the open spans still close)."""
        self._records = deque(maxlen=self._keep)
        self._opened = 0
        self._stack = []
        self._live = False

    def _end(self) -> None:
        """The profiler has stopped: the session's open spans take no
        more counts (they still close, and keep their records)."""
        self._live = False
        self._stack = []

    def span(self, name: str, **counts):
        if not _profiler_enabled():
            if self._live:
                self._end()
            return NOOP
        if not self._live:
            self.reset()
            self._live = True
        stack = self._stack
        parent = stack[-1].index if stack else -1
        rec = Record(self, name, self._opened, parent, counts,
                     _RecordFunctionFast(name))
        self._opened += 1
        self._records.append(rec)
        stack.append(rec)
        return rec

    def count(self, key: str, n=1) -> None:
        if not self._live:
            return
        if not _profiler_enabled():
            self._end()
            return
        stack = self._stack
        if stack:
            c = stack[-1].counts
            c[key] = c.get(key, 0) + n

    def spans(self) -> List[Record]:
        return list(self._records)

    def dropped(self) -> int:
        return self._opened - len(self._records)


def self_ns(records: List[Record]) -> List[int]:
    """Each record's duration less the union of its children's intervals
    (children whose parent record was dropped count for nobody)."""
    first = records[0].index if records else 0
    kids: List[list] = [[] for _ in records]
    for r in records:
        p = r.parent - first
        if 0 <= p < len(records):
            kids[p].append((r.t0, r.t1))
    out = []
    for r, iv in zip(records, kids):
        covered, end = 0, r.t0
        for a, b in sorted(iv):
            a, b = max(a, end), min(b, r.t1)
            if b > a:
                covered += b - a
                end = b
        out.append(r.t1 - r.t0 - covered)
    return out


_TRACER = Tracer()
span = _TRACER.span
count = _TRACER.count
reset = _TRACER.reset
spans = _TRACER.spans
dropped = _TRACER.dropped
