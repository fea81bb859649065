"""Drive ``Scheduler.tick`` over a backlog and record what each tick did.

The harness keeps the backlog topped up before every tick, then calls
``Scheduler.tick(now)`` once and looks at the requests it handed in:
tokens gained (a client's deliveries, stamped when the tick returns),
first tokens, finishes and preemptions.  Everything recorded comes from
the requests themselves, the scheduler's queue, the engine's
``requeue`` and the page pool's ``pages_in_use()``; nothing reaches
into the engine's own state.

From these a tick's work follows: its decode steps (lanes and contexts:
a lane that gained ``g`` decode tokens ran ``g`` steps) and the prefill
chunk it advanced (the engine co-schedules one chunk of the one prompt
in flight a tick, so chunk ``i`` of a request admitted at tick ``t0``
runs at tick ``t0 + i``).  When a prompt's first token arrives at
another tick than that rule gives, the chunk counts are marked unsound
and the metrics built on them read nothing.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from bench.harness import spec


@dataclass
class Tick:
    t0: float                       # perf_counter at the call
    t1: float                       # perf_counter at its return
    wall_ns: Tuple[int, int]        # time.time_ns() at call and return
    delivered: int                  # new tokens to clients
    decode_tokens: int
    steps: List[Tuple[int, int]]    # (lanes, sum of attended contexts)
    chunk: Optional[Tuple[int, int]]   # (tokens, offset) of the chunk
    pages: Optional[int]            # pages in use after it

    @property
    def horizon(self) -> int:
        return len(self.steps)


class Backlog:
    """The request stream of a mix, turned into the program's requests."""

    def __init__(self, mix: Dict, vocab: int, seed: int, request_cls):
        gen = spec.generator(mix)
        self.stream = gen.Stream(mix, vocab, seed)
        self.min_waiting = int(mix["min_waiting"])
        self.request_cls = request_cls
        self.enqueued: Dict[int, float] = {}    # rid -> perf_counter

    def top_up(self, sched) -> None:
        short = self.min_waiting - len(sched.pending)
        if short > 0:
            reqs = [self.request_cls(rid, prompt, arrival_s=0.0,
                                     decode_len=out)
                    for rid, prompt, out in self.stream.take(short)]
            now = time.perf_counter()
            for r in reqs:
                self.enqueued[r.rid] = now
            sched.enqueue(reqs)


@dataclass
class Observer:
    """Per-tick records over one engine and its scheduler."""
    sched: object
    backlog: Backlog
    chunk_size: int
    pages_fn: Optional[object] = None
    ticks: List[Tick] = field(default_factory=list)
    in_flight: Dict[int, object] = field(default_factory=dict)
    high: Dict[int, int] = field(default_factory=dict)   # tokens delivered
    last_t: Dict[int, float] = field(default_factory=dict)
    gaps: List[Tuple[float, float]] = field(default_factory=list)
    ttft: List[float] = field(default_factory=list)
    prefill: Optional[Tuple[object, int]] = None   # (request, admit tick)
    chunks_sound: bool = True
    preemptions: int = 0
    finished: List = field(default_factory=list)

    def tick(self, now: float) -> Tick:
        sched = self.sched
        eng = sched.engine
        waiting = {r.rid for r in sched.pending}
        requeued = {r.rid for r in eng.requeue}
        queued = {r.rid: r for r in sched.pending}
        queued.update({r.rid: r for r in eng.requeue})
        before = {rid: len(r.tokens_out) for rid, r in self.in_flight.items()}
        wall0 = time.time_ns()
        t0 = time.perf_counter()
        sched.tick(now)
        t1 = time.perf_counter()
        wall1 = time.time_ns()
        idx = len(self.ticks)
        # admissions: requests that left the queue in this tick
        still = {r.rid for r in sched.pending} | {r.rid for r in eng.requeue}
        for rid in (waiting | requeued) - still:
            r = queued[rid]
            self.in_flight[rid] = r
            before[rid] = 0
            if self.prefill is not None:
                self.chunks_sound = False     # two prompts in flight
            self.prefill = (r, idx)
        chunk = None
        if self.prefill is not None:
            r, at = self.prefill
            off = (idx - at) * self.chunk_size
            chunk = (min(self.chunk_size, len(r.prompt) - off), off)
            if chunk[0] <= 0:
                self.chunks_sound = False
                chunk = None
        delivered = dec = 0
        lanes: Dict[int, int] = {}          # decode tokens -> lanes
        ctx_sum: Dict[int, int] = {}        # step j -> contexts attended
        for rid, r in list(self.in_flight.items()):
            n0, n1 = before.get(rid, 0), len(r.tokens_out)
            if n1 < n0:                     # preempted: back in requeue
                del self.in_flight[rid]
                self.preemptions += 1
                continue
            if n1 == n0:
                continue
            d = n1 - n0
            if n0 == 0:                     # prefill done: first token
                d -= 1
                if r.first_token_s is not None:
                    self.ttft.append(r.first_token_s
                                     - self.backlog.enqueued[rid])
                if self.prefill is not None and self.prefill[0] is r:
                    want = -(-len(r.prompt) // self.chunk_size) - 1
                    if idx - self.prefill[1] != want:
                        self.chunks_sound = False
                    self.prefill = None
            base = len(r.prompt) + max(n0, 1)
            for j in range(d):
                lanes[j] = lanes.get(j, 0) + 1
                ctx_sum[j] = ctx_sum.get(j, 0) + base + j
            dec += d
            new = max(0, n1 - self.high.get(rid, 0))
            if new:
                self.high[rid] = n1
                delivered += new
                if rid in self.last_t and n0 > 0:
                    self.gaps.append((t1, t1 - self.last_t[rid]))
                self.last_t[rid] = t1
            if r.finish_s > 0:
                del self.in_flight[rid]
                self.finished.append(r)
        steps = [(lanes[j], ctx_sum[j]) for j in sorted(lanes)]
        t = Tick(t0=t0, t1=t1, wall_ns=(wall0, wall1), delivered=delivered,
                 decode_tokens=dec, steps=steps, chunk=chunk,
                 pages=self.pages_fn() if self.pages_fn else None)
        self.ticks.append(t)
        return t

    def decoding(self) -> int:
        """Requests holding a slot that have their first token."""
        return sum(1 for r in self.in_flight.values() if r.tokens_out)


def run_until(obs: Observer, backlog: Backlog, stop, t_base: float) -> None:
    """Tick until ``stop(obs)`` holds (checked after each tick)."""
    while True:
        backlog.top_up(obs.sched)
        obs.tick(time.perf_counter() - t_base)
        if stop(obs):
            return
