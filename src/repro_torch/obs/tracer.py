"""Structured lifecycle tracing for the serving path (a copy of
``repro.obs.tracer``, so the engine's emitters stay as they are).

One :class:`Tracer` collects typed :class:`TraceEvent` records from the
``Router`` (dispatch, ship), the ``Scheduler`` (arrival / admit), the
engines (prefill chunks, decode steps, fused ticks, growth / preemption,
finishes) and ``PagedCache`` (CoW forks, defrag, migration).  The
schema is the reference's, so an engine trace of either package can be
diffed event by event.

Tracing must never perturb the tokens: every emitter sits behind an
``if tracer.enabled`` branch and the default :data:`NULL_TRACER` is a
no-op whose ``enabled`` attribute is a plain ``False``.

Timestamps are seconds on ``time.perf_counter`` relative to the tracer's
origin (the first event unless ``t0`` is given).  ``dur`` is the span
length; instantaneous events carry ``dur == 0``.  The exporters
(Perfetto JSON, JSONL save/replay, ``trace_report``) live in
:mod:`repro_torch.obs.export`.

A ``Tracer(spans=True)`` also records the port's host spans
(:data:`SPAN_KINDS`): one ``host.tick`` tree per ``Scheduler.tick``,
opened with :meth:`Tracer.begin` and closed with :meth:`Tracer.end`,
each child carrying its parent's event index in ``args["parent"]``.
The tracer takes a ``(perf_counter, time_ns)`` anchor pair when it is
made and another at :meth:`Tracer.stop`; :meth:`Tracer.wall_ns` maps an
event onto ``time.time_ns``, the clock ``torch.profiler`` stamps device
activity with.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

#: The event schema.  One entry per lifecycle edge; ``args`` carries the
#: per-kind payload (documented in README "Observability"):
#:
#: arrival        request entered a scheduler queue (args: arrival_s,
#:                prompt_len)
#: dispatch       router picked a replica (args: policy)
#: admit          scheduler admission succeeded (args: requeued)
#: prefill_chunk  one prefill chunk advanced (args: tokens, pos, last)
#: decode_step    one per-tick decode iteration (args: batch, finished)
#: fused_tick     one K-step fused lax.scan tick (args: batch, horizon,
#:                clamp in {fuse_steps, page_edge, budget}, device_s)
#: grow           on-demand page growth before a decode step (args: pages)
#: preempt        youngest-first preemption (args: preemptions)
#: cow_fork       copy-on-write fork of a shared page (args: block, page)
#: defrag         page-pool compaction ran (args: moved, cost_s)
#: migrate        spilled pages re-homed (args: pages, cost_s)
#: ship           KV pages shipped between tiers at prefill handoff
#:                (args: pages, bytes, cost_s, src, dst); sims charge
#:                dur on the modeled clock
#: reconfigure    substrate shape-profile change (args: old, new,
#:                modeled_reconfig_s); sims charge dur on their clock
#: finish         request retired (args: reason, tokens)
#: gauge          per-tick counter sample (args: one value per counter
#:                track, e.g. free_pages / min_region_free /
#:                modeled_tokens_per_s)
EVENT_KINDS = (
    "arrival", "dispatch", "admit", "prefill_chunk", "decode_step",
    "fused_tick", "grow", "preempt", "cow_fork", "defrag", "migrate",
    "ship", "reconfigure", "finish", "gauge",
)

#: The port's host spans (not in the reference's schema; only a
#: ``Tracer(spans=True)`` records them).  Each is one stretch of the
#: host's work inside a scheduler tick (args, documented in README
#: "Observability"):
#:
#: host.tick      one ``Scheduler.tick``, the root (args: chunk_tokens,
#:                lanes, horizon, clamp)
#: host.admit     one admission attempt (args: requeued, admitted)
#: host.chunk     one prefill chunk: gather, extend_step issue, scatter,
#:                prefix commit, the first token's fetch (args: tokens,
#:                pos)
#: host.grow      one page-growth pass (args: pages)
#: host.horizon   the fused horizon's computation (args: k, clamp)
#: host.decode    the host issue of a tick's decode steps (args: lanes,
#:                steps)
#: host.fetch     the host blocked on a token fetch from the device
#: host.retire    token appends, finishes, slot release (args: finished)
SPAN_KINDS = (
    "host.tick", "host.admit", "host.chunk", "host.grow", "host.horizon",
    "host.decode", "host.fetch", "host.retire",
)
#: the ``slot`` of every host span: a Perfetto track of their own, apart
#: from the engine lane's lifecycle spans
HOST_LANE = -2


@dataclass
class TraceEvent:
    ts: float                   # seconds since tracer origin (span start)
    kind: str                   # one of EVENT_KINDS
    replica: int = 0            # Perfetto pid (one process per replica)
    slot: int = -1              # Perfetto tid - 1 (-1: engine-level lane)
    rid: int = -1               # request id (-1: not request-scoped)
    dur: float = 0.0            # span length (0: instantaneous)
    args: Dict[str, Any] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"ts": self.ts, "kind": self.kind, "replica": self.replica,
                "slot": self.slot, "rid": self.rid, "dur": self.dur,
                "args": self.args}

    @classmethod
    def from_json(cls, d: dict) -> "TraceEvent":
        return cls(ts=d["ts"], kind=d["kind"],
                   replica=d.get("replica", 0), slot=d.get("slot", -1),
                   rid=d.get("rid", -1), dur=d.get("dur", 0.0),
                   args=d.get("args", {}))


class NullTracer:
    """No-op tracer: the hot path's default.  ``enabled`` is a plain
    class attribute so the guard is one load + branch; ``emit`` accepts
    the full signature and drops everything."""

    enabled = False
    spans = False

    def emit(self, kind: str, *, ts: Optional[float] = None,
             replica: Optional[int] = None, slot: int = -1, rid: int = -1,
             dur: float = 0.0, **args) -> None:
        return None

    def begin(self, kind: str, *, replica: Optional[int] = None,
              rid: int = -1, **args) -> int:
        return -1

    def end(self, index: int, **args) -> None:
        return None

    def for_replica(self, replica: int) -> "NullTracer":
        return self

    @property
    def events(self) -> List[TraceEvent]:
        return []


NULL_TRACER = NullTracer()


class Tracer(NullTracer):
    """Collects :class:`TraceEvent` records in emission order.

    ``t0`` anchors the time origin.  ``None`` (the default) locks it to
    the first emitted event's timestamp — right for wall-clock tracing,
    where ``time.perf_counter`` values are arbitrary.  Pass ``t0=0.0``
    when emitting modeled-clock timestamps (the analytic sims).
    ``spans`` also records the host spans of :data:`SPAN_KINDS`.
    """

    enabled = True

    def __init__(self, t0: Optional[float] = None, spans: bool = False):
        self._t0 = t0
        self._events: List[TraceEvent] = []
        self.spans = spans
        self._open: List[int] = []      # indices of the open spans
        self.anchors = [(time.perf_counter(), time.time_ns())]

    def emit(self, kind: str, *, ts: Optional[float] = None,
             replica: Optional[int] = None, slot: int = -1, rid: int = -1,
             dur: float = 0.0, **args) -> None:
        if kind not in EVENT_KINDS and kind not in SPAN_KINDS:
            raise ValueError(f"unknown trace event kind {kind!r} "
                             f"(know {EVENT_KINDS + SPAN_KINDS})")
        if ts is None:
            ts = time.perf_counter()
        if self._t0 is None:
            self._t0 = ts
        self._events.append(TraceEvent(
            ts=ts - self._t0, kind=kind,
            replica=0 if replica is None else replica,
            slot=slot, rid=rid, dur=dur, args=args))

    def begin(self, kind: str, *, replica: Optional[int] = None,
              rid: int = -1, **args) -> int:
        """Open a host span now, inside the innermost open one; returns
        its event index, for :meth:`end`."""
        args["parent"] = self._open[-1] if self._open else -1
        self.emit(kind, replica=replica, slot=HOST_LANE, rid=rid, **args)
        i = len(self._events) - 1
        self._open.append(i)
        return i

    def end(self, index: int, **args) -> None:
        """Close span ``index`` now (and any span left open inside it),
        adding ``args``."""
        ev = self._events[index]
        ev.dur = time.perf_counter() - self._t0 - ev.ts
        ev.args.update(args)
        while self._open and self._open.pop() != index:
            pass

    def stop(self) -> None:
        """Take the closing anchor pair of the clock mapping."""
        self.anchors.append((time.perf_counter(), time.time_ns()))

    def wall_ns(self, ev: TraceEvent) -> Tuple[int, int]:
        """``ev``'s start and end on ``time.time_ns``: linear between the
        first and the last anchor pair (one pair: a second per 1e9 ns)."""
        (p0, w0), (p1, w1) = self.anchors[0], self.anchors[-1]
        per_s = (w1 - w0) / (p1 - p0) if p1 > p0 else 1e9
        t = ev.ts + (self._t0 or 0.0) - p0
        return (w0 + round(t * per_s),
                w0 + round((t + ev.dur) * per_s))

    def for_replica(self, replica: int) -> "_BoundTracer":
        """A view of this tracer whose events default to ``replica`` —
        each engine replica gets one (its Perfetto process id)."""
        return _BoundTracer(self, replica)

    @property
    def events(self) -> List[TraceEvent]:
        return self._events


class _BoundTracer:
    """Replica-bound view over a shared :class:`Tracer`."""

    __slots__ = ("_tracer", "replica", "enabled", "spans")

    def __init__(self, tracer: Tracer, replica: int):
        self._tracer = tracer
        self.replica = replica
        self.enabled = tracer.enabled
        self.spans = tracer.spans

    def emit(self, kind: str, *, ts: Optional[float] = None,
             replica: Optional[int] = None, slot: int = -1, rid: int = -1,
             dur: float = 0.0, **args) -> None:
        self._tracer.emit(kind, ts=ts,
                          replica=self.replica if replica is None
                          else replica,
                          slot=slot, rid=rid, dur=dur, **args)

    def begin(self, kind: str, *, replica: Optional[int] = None,
              rid: int = -1, **args) -> int:
        return self._tracer.begin(
            kind, replica=self.replica if replica is None else replica,
            rid=rid, **args)

    def end(self, index: int, **args) -> None:
        self._tracer.end(index, **args)

    def for_replica(self, replica: int) -> "_BoundTracer":
        return _BoundTracer(self._tracer, replica)

    @property
    def events(self) -> List[TraceEvent]:
        return self._tracer.events
