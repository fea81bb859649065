"""The program's host spans over a traced slice, and its engine counters
over a window: what the ``program_span`` and ``program_counter``
readers of the serving tick read.

A ``repro_torch.obs.Tracer(spans=True)`` attached to the engine records
one ``host.tick`` tree a ``Scheduler.tick``.  :func:`of` turns its
events into :class:`Span` records on ``time.time_ns``, the clock the
profiler stamps device activity with, so a device idle stretch can be
put down to the innermost span open while it lasted
(:func:`idle_by_span`).  A run record carries the slice's spans as
``spans`` and the engine's counters, the window's close less its
opening, as ``counters``; a record without them gives the readers
nothing to read.
"""
from __future__ import annotations

import bisect
import re
import statistics
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DTOH = re.compile(r"Memcpy DtoH")
#: idle outside every ``host.tick``: the harness's work between ticks
BETWEEN = "between ticks"


@dataclass
class Span:
    kind: str
    start_ns: int
    end_ns: int
    parent: int                 # index in the span list, -1 for a root
    rid: int = -1
    args: Dict = field(default_factory=dict)
    children: List[int] = field(default_factory=list)

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


def attach(engine):
    """A span-recording tracer, attached to ``engine``."""
    from repro_torch.obs.tracer import Tracer
    tracer = Tracer(spans=True)
    engine.set_tracer(tracer)
    return tracer


def detach(engine, tracer) -> None:
    """Stop ``tracer``'s clock mapping and give ``engine`` the no-op
    tracer back."""
    from repro_torch.obs.tracer import NULL_TRACER
    tracer.stop()
    engine.set_tracer(NULL_TRACER)


def of(tracer) -> List[Span]:
    """The tracer's host spans, in the order they opened, on
    ``time.time_ns``, each with the indices of its children."""
    out: List[Span] = []
    index: Dict[int, int] = {}          # event index -> span index
    for i, ev in enumerate(tracer.events):
        if not ev.kind.startswith("host."):
            continue
        a, b = tracer.wall_ns(ev)
        parent = index.get(ev.args.get("parent", -1), -1)
        index[i] = len(out)
        out.append(Span(ev.kind, a, b, parent, ev.rid,
                        {k: v for k, v in ev.args.items() if k != "parent"}))
        if parent >= 0:
            out[parent].children.append(index[i])
    return out


def self_ns(spans: List[Span], i: int) -> int:
    """Span ``i``'s duration less what its children cover."""
    s = spans[i]
    return s.ns - sum(spans[c].ns for c in s.children)


def self_seconds(spans: List[Span], kind: str) -> float:
    return sum(self_ns(spans, i) for i, s in enumerate(spans)
               if s.kind == kind) / 1e9


def ticks(spans: List[Span]) -> int:
    return sum(1 for s in spans if s.kind == "host.tick")


def ms_per_tick(run, kind: str) -> Optional[float]:
    """Self milliseconds of ``kind`` over the slice's ticks (None where
    the run holds no spans)."""
    spans = getattr(run, "spans", None)
    n = ticks(spans) if spans else 0
    return 1e3 * self_seconds(spans, kind) / n if n else None


def delta(after: Dict[str, int], before: Dict[str, int]) -> Dict[str, int]:
    return {k: after[k] - before.get(k, 0) for k in after}


def segments(spans: List[Span]) -> List[Tuple[int, int, str]]:
    """The traced time cut into ``(start, end, kind)`` pieces, each
    labelled with the innermost span open over it, in time order."""
    out: List[Tuple[int, int, str]] = []

    def walk(i: int) -> None:
        s = spans[i]
        t = s.start_ns
        for c in sorted(s.children, key=lambda c: spans[c].start_ns):
            if spans[c].start_ns > t:
                out.append((t, spans[c].start_ns, s.kind))
            walk(c)
            t = max(t, spans[c].end_ns)
        if s.end_ns > t:
            out.append((t, s.end_ns, s.kind))

    for i in sorted((i for i, s in enumerate(spans) if s.parent < 0),
                    key=lambda i: spans[i].start_ns):
        walk(i)
    return out


def idle_by_span(sl, spans: List[Span]) -> Dict[str, float]:
    """Seconds of the slice's device idle time by the innermost span open
    while it lasted (``host.tick`` itself: the tick's own code outside
    its children); :data:`BETWEEN` outside every tick."""
    busy = sl.busy_intervals()
    idle, t = [], sl.start_ns
    for a, b in busy:
        if a > t:
            idle.append((t, min(a, sl.end_ns)))
        t = max(t, b)
    if sl.end_ns > t:
        idle.append((t, sl.end_ns))
    segs = segments(spans)
    out: Dict[str, float] = {}
    j = 0
    for a, b in idle:
        covered = 0
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                lab = segs[k][2]
                out[lab] = out.get(lab, 0.0) + (hi - lo) / 1e9
                covered += hi - lo
            k += 1
        if b - a > covered:
            out[BETWEEN] = out.get(BETWEEN, 0.0) + (b - a - covered) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def fetch_clock(sl, spans: List[Span]) -> Tuple[Optional[float],
                                                 Optional[float]]:
    """The share of ``host.fetch`` spans inside which a device-to-host
    copy of the slice ends, and the median microseconds from that copy's
    end to the span's end: a check of the clock mapping, since a fetch
    returns only after its copy."""
    ends = sorted(o.end_ns for o in sl.ops if DTOH.search(o.name))
    hit, lag = 0, []
    fetches = [s for s in spans if s.kind == "host.fetch"]
    for s in fetches:
        i = bisect.bisect_right(ends, s.end_ns) - 1
        if i >= 0 and ends[i] >= s.start_ns:
            hit += 1
            lag.append((s.end_ns - ends[i]) / 1e3)
    if not fetches:
        return None, None
    return hit / len(fetches), (statistics.median(lag) if lag else None)


def coverage(spans: List[Span]) -> Optional[float]:
    """The median over ticks of the share of a ``host.tick``'s wall time
    its child spans cover."""
    shares = [1.0 - self_ns(spans, i) / s.ns for i, s in enumerate(spans)
              if s.kind == "host.tick" and s.ns > 0]
    return statistics.median(shares) if shares else None
