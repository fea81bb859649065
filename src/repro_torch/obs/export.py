"""Trace exporters: Perfetto JSON, JSONL save/replay, phase report (a
copy of ``repro.obs.export``; for the same events the output is the
reference's).

* :func:`export_perfetto` — Chrome-trace/Perfetto ``traceEvents`` JSON:
  one *process* per replica, one *thread* lane per slot (tid 0 is the
  engine/scheduler lane, tid -1 the port's host spans), complete
  events (``ph: "X"``) for spans, counter tracks (``ph: "C"``) fed by
  ``gauge`` events.  Open the file at https://ui.perfetto.dev (or
  chrome://tracing).
* :func:`save_jsonl` / :func:`load_jsonl` — lossless event log, one
  JSON object per line.  ``json`` round-trips Python floats exactly, so
  a replayed log reproduces :func:`trace_report` bit for bit.
* :func:`trace_report` — phase attribution: prefill vs decode vs ship vs
  reconfig vs stall.  Span events are disjoint host (or modeled-clock)
  intervals, so the phases sum to the makespan by construction;
  ``stall_s`` is the residual the engine spent idle or in bookkeeping.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

from repro_torch.obs.tracer import TraceEvent

#: event kinds whose duration is decode work (per-tick or fused)
_DECODE_KINDS = ("decode_step", "fused_tick")


def export_perfetto(events: Sequence[TraceEvent],
                    path: Optional[str] = None) -> dict:
    """Build (and optionally write) a Chrome-trace JSON object.

    Timestamps and durations convert to microseconds.  Events are sorted
    by (pid, tid, ts), so every track's timestamps are non-decreasing.
    """
    spans: List[dict] = []
    tracks: Dict[int, set] = {}
    for ev in events:
        pid = ev.replica
        if ev.kind == "gauge":
            # one counter track per gauge key, engine lane
            for k, v in ev.args.items():
                spans.append({"ph": "C", "name": k, "pid": pid, "tid": 0,
                              "ts": ev.ts * 1e6, "args": {k: v}})
            tracks.setdefault(pid, set()).add(0)
            continue
        args = dict(ev.args)
        if ev.rid >= 0:
            args["rid"] = ev.rid
        spans.append({"ph": "X", "name": ev.kind, "cat": "serving",
                      "pid": pid, "tid": ev.slot + 1, "ts": ev.ts * 1e6,
                      "dur": ev.dur * 1e6, "args": args})
        tracks.setdefault(pid, set()).add(ev.slot + 1)
    spans.sort(key=lambda e: (e["pid"], e["tid"], e["ts"]))
    meta: List[dict] = []
    for pid in sorted(tracks):
        meta.append({"ph": "M", "name": "process_name", "pid": pid,
                     "tid": 0, "ts": 0, "args": {"name": f"replica {pid}"}})
        for tid in sorted(tracks[pid]):
            lane = ("engine" if tid == 0 else "host" if tid < 0
                    else f"slot {tid - 1}")
            meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                         "tid": tid, "ts": 0, "args": {"name": lane}})
    obj = {"traceEvents": meta + spans, "displayTimeUnit": "ms"}
    if path is not None:
        with open(path, "w") as f:
            json.dump(obj, f)
    return obj


def save_jsonl(events: Sequence[TraceEvent], path: str) -> None:
    """One event per line; lossless (floats round-trip exactly)."""
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev.to_json()) + "\n")


def load_jsonl(path: str) -> List[TraceEvent]:
    out: List[TraceEvent] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(TraceEvent.from_json(json.loads(line)))
    return out


def trace_report(events: Sequence[TraceEvent]) -> dict:
    """Phase-attribution summary over one event stream.

    ``phases`` partitions the makespan: prefill-chunk spans, decode spans
    (per-tick + fused), tier-handoff page shipments (the engine's ship
    events are instantaneous and carry the modeled cost in ``args``; the
    sims charge it as the span), reconfiguration charge (likewise), and
    ``stall_s``, the residual (idle waits, admission, host bookkeeping).
    Because span events never overlap, ``sum(phases) == makespan_s``.
    """
    counts: Dict[str, int] = {}
    prefill_s = decode_s = ship_s = reconfig_s = 0.0
    t_lo, t_hi = float("inf"), float("-inf")
    finished = 0
    for ev in events:
        counts[ev.kind] = counts.get(ev.kind, 0) + 1
        if ev.kind == "prefill_chunk":
            prefill_s += ev.dur
        elif ev.kind in _DECODE_KINDS:
            decode_s += ev.dur
        elif ev.kind == "ship":
            ship_s += ev.dur
        elif ev.kind == "reconfigure":
            reconfig_s += ev.dur
        elif ev.kind == "finish":
            finished += 1
        t_lo = min(t_lo, ev.ts)
        t_hi = max(t_hi, ev.ts + ev.dur)
    makespan = (t_hi - t_lo) if counts else 0.0
    stall = max(0.0, makespan - prefill_s - decode_s - ship_s
                - reconfig_s)
    return {"makespan_s": makespan,
            "finished": finished,
            "events": dict(sorted(counts.items())),
            "phases": {"prefill_s": prefill_s, "decode_s": decode_s,
                       "ship_s": ship_s, "reconfig_s": reconfig_s,
                       "stall_s": stall}}
