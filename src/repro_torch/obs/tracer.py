"""Structured lifecycle tracing for the serving path (a copy of
``repro.obs.tracer``, so the engine's emitters stay as they are).

One :class:`Tracer` collects typed :class:`TraceEvent` records from the
``Scheduler`` (arrival / admit), the engines (prefill chunks, decode
steps, growth / preemption, finishes) and ``PagedCache`` (defrag).  The
schema is the reference's, so an engine trace of either package can be
diffed event by event.

Tracing must never perturb the tokens: every emitter sits behind an
``if tracer.enabled`` branch and the default :data:`NULL_TRACER` is a
no-op whose ``enabled`` attribute is a plain ``False``.

Timestamps are seconds on ``time.perf_counter`` relative to the tracer's
origin (the first event unless ``t0`` is given).  ``dur`` is the span
length; instantaneous events carry ``dur == 0``.  The Perfetto exporter
arrives with a later slice.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

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

    def emit(self, kind: str, *, ts: Optional[float] = None,
             replica: Optional[int] = None, slot: int = -1, rid: int = -1,
             dur: float = 0.0, **args) -> None:
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
    """

    enabled = True

    def __init__(self, t0: Optional[float] = None):
        self._t0 = t0
        self._events: List[TraceEvent] = []

    def emit(self, kind: str, *, ts: Optional[float] = None,
             replica: Optional[int] = None, slot: int = -1, rid: int = -1,
             dur: float = 0.0, **args) -> None:
        if kind not in EVENT_KINDS:
            raise ValueError(f"unknown trace event kind {kind!r} "
                             f"(know {EVENT_KINDS})")
        if ts is None:
            ts = time.perf_counter()
        if self._t0 is None:
            self._t0 = ts
        self._events.append(TraceEvent(
            ts=ts - self._t0, kind=kind,
            replica=0 if replica is None else replica,
            slot=slot, rid=rid, dur=dur, args=args))

    def for_replica(self, replica: int) -> "_BoundTracer":
        """A view of this tracer whose events default to ``replica`` —
        each engine replica gets one (its Perfetto process id)."""
        return _BoundTracer(self, replica)

    @property
    def events(self) -> List[TraceEvent]:
        return self._events


class _BoundTracer:
    """Replica-bound view over a shared :class:`Tracer`."""

    __slots__ = ("_tracer", "replica", "enabled")

    def __init__(self, tracer: Tracer, replica: int):
        self._tracer = tracer
        self.replica = replica
        self.enabled = tracer.enabled

    def emit(self, kind: str, *, ts: Optional[float] = None,
             replica: Optional[int] = None, slot: int = -1, rid: int = -1,
             dur: float = 0.0, **args) -> None:
        self._tracer.emit(kind, ts=ts,
                          replica=self.replica if replica is None
                          else replica,
                          slot=slot, rid=rid, dur=dur, **args)

    def for_replica(self, replica: int) -> "_BoundTracer":
        return _BoundTracer(self._tracer, replica)

    @property
    def events(self) -> List[TraceEvent]:
        return self._tracer.events
