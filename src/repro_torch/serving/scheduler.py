"""Scheduling loop for one engine replica (a copy of
``repro.serving.scheduler``; only the imports differ).

* :class:`RequestState` — one request's lifecycle record;
* trace makers — :func:`make_trace` (Poisson, optionally eos-aware via
  ``eos_rate``), :func:`make_shared_prefix_trace` (one common system
  prompt), :func:`make_grouped_prefix_trace` (N prefix groups with Zipf
  popularity skew), and recorded replay via :func:`load_trace` /
  :func:`save_trace`.  The same numpy seed gives the same trace in both
  packages;
* :class:`Scheduler` — the arrival-driven continuous-batching loop for
  ONE engine replica.

A replica is anything exposing ``admit(req) -> bool``, ``tick() -> int``,
``load_report()``, ``requeue``, ``completed`` and ``busy()``.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.obs.metrics import serving_registry
from repro_torch.obs.tracer import NULL_TRACER


@dataclass
class RequestState:
    rid: int
    prompt: np.ndarray
    arrival_s: float = 0.0
    slot: int = -1
    prefill_done_s: float = 0.0
    tokens_out: List[int] = field(default_factory=list)
    token_times: List[float] = field(default_factory=list)
    finish_s: float = 0.0
    # wall-clock instant the first token was emitted; None until then (a
    # plain 0.0 sentinel would drop a legitimate sample taken at exactly
    # t=0 from the TTFT statistics)
    first_token_s: Optional[float] = None
    preemptions: int = 0
    # eos-aware traces: per-request decode budget sampled at trace build
    # time (None: the engine's max_new_tokens applies); stopping at a
    # sampled budget below max_new_tokens is reported as an "eos" finish
    decode_len: Optional[int] = None
    # router affinity keys (None: keyed by rid / prompt bytes)
    session: Optional[int] = None
    finish_reason: str = ""

    @property
    def done(self) -> bool:
        return self.finish_s > 0.0

    def reset_generation(self) -> None:
        """Drop generated state for re-queueing after a preemption."""
        self.slot = -1
        self.tokens_out = []
        self.token_times = []
        self.prefill_done_s = 0.0
        self.first_token_s = None
        self.finish_reason = ""


# ---------------------------------------------------------------------------
# Trace makers
# ---------------------------------------------------------------------------
def _decode_lens(rng, n: int, eos_rate: Optional[float]
                 ) -> List[Optional[int]]:
    """Geometric early-stop lengths: each decode step "emits eos" with
    probability ``eos_rate``."""
    if not eos_rate:
        return [None] * n
    if not 0.0 < eos_rate <= 1.0:
        raise ValueError(f"eos_rate must be in (0, 1], got {eos_rate}")
    return [int(v) for v in rng.geometric(eos_rate, size=n)]


def make_trace(vocab: int, *, rate_req_s: float, n_requests: int,
               prompt_len: int, seed: int = 0,
               prompt_lens: Optional[np.ndarray] = None,
               eos_rate: Optional[float] = None,
               sessions: Optional[np.ndarray] = None
               ) -> List[RequestState]:
    """Deterministic Poisson trace; identical across engines for a seed.

    ``prompt_lens`` overrides the constant ``prompt_len`` per request
    (skewed-length traces); ``eos_rate`` samples per-request early-stop
    decode lengths (geometric — each step stops with that probability);
    ``sessions`` attaches session ids for affinity routing.
    """
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_req_s, size=n_requests)
    arrivals = np.cumsum(gaps)
    if prompt_lens is None:
        prompt_lens = np.full(n_requests, prompt_len, np.int64)
    prompts = [rng.integers(0, vocab, size=int(prompt_lens[i])
                            ).astype(np.int32) for i in range(n_requests)]
    stops = _decode_lens(rng, n_requests, eos_rate)
    return [RequestState(i, prompts[i], arrival_s=float(arrivals[i]),
                         decode_len=stops[i],
                         session=(int(sessions[i]) if sessions is not None
                                  else None))
            for i in range(n_requests)]


def make_shared_prefix_trace(vocab: int, *, rate_req_s: float,
                             n_requests: int, prefix_len: int,
                             tail_len: int, seed: int = 0,
                             eos_rate: Optional[float] = None
                             ) -> List[RequestState]:
    """Poisson trace where every prompt is one common prefix plus a unique
    tail — the shared-system-prompt workload prefix sharing exists for.
    ``prefix_len=0`` degenerates to fully unique prompts.  Deterministic
    per seed, so the same trace can be replayed through dense, paged, and
    sharing engines for token-exact comparison."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_req_s, size=n_requests)
    arrivals = np.cumsum(gaps)
    prefix = rng.integers(0, vocab, size=prefix_len).astype(np.int32)
    stops = _decode_lens(rng, n_requests, eos_rate)
    reqs = []
    for i in range(n_requests):
        tail = rng.integers(0, vocab, size=tail_len).astype(np.int32)
        reqs.append(RequestState(i, np.concatenate([prefix, tail]),
                                 arrival_s=float(arrivals[i]),
                                 decode_len=stops[i]))
    return reqs


def make_grouped_prefix_trace(vocab: int, *, rate_req_s: float,
                              n_requests: int, n_groups: int,
                              prefix_len: int, tail_len: int,
                              skew: float = 1.0, seed: int = 0,
                              eos_rate: Optional[float] = None
                              ) -> List[RequestState]:
    """Multi-tenant shared-prefix trace: ``n_groups`` distinct system
    prompts with Zipf(``skew``) popularity; each request samples a group
    and carries that group's ``prefix_len``-token prefix plus a unique
    tail.  ``session`` is set to the group id, so ``session_affinity``
    and ``prefix_affinity`` routing agree on the ideal placement — this
    is the workload the front-end router's dedup-compounding exists for.
    """
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_req_s, size=n_requests)
    arrivals = np.cumsum(gaps)
    prefixes = [rng.integers(0, vocab, size=prefix_len).astype(np.int32)
                for _ in range(n_groups)]
    weights = 1.0 / np.arange(1, n_groups + 1) ** skew
    weights /= weights.sum()
    groups = rng.choice(n_groups, size=n_requests, p=weights)
    stops = _decode_lens(rng, n_requests, eos_rate)
    reqs = []
    for i in range(n_requests):
        g = int(groups[i])
        tail = rng.integers(0, vocab, size=tail_len).astype(np.int32)
        reqs.append(RequestState(i, np.concatenate([prefixes[g], tail]),
                                 arrival_s=float(arrivals[i]),
                                 decode_len=stops[i], session=g))
    return reqs


def save_trace(reqs: List[RequestState], path: str) -> None:
    """Record a trace (arrivals / prompts / decode budgets / sessions) to
    JSON for later replay with :func:`load_trace`."""
    out = [{"rid": r.rid, "arrival_s": r.arrival_s,
            "prompt": [int(t) for t in r.prompt],
            "decode_len": r.decode_len, "session": r.session}
           for r in reqs]
    with open(path, "w") as f:
        json.dump({"requests": out}, f)


def load_trace(path: str, vocab: Optional[int] = None,
               seed: int = 0) -> List[RequestState]:
    """Replay a recorded trace from JSON.

    Each entry carries ``arrival_s`` plus either explicit ``prompt``
    tokens or a ``prompt_len`` (tokens then drawn deterministically from
    ``seed`` — ``vocab`` required); optional ``decode_len`` (early-stop
    budget) and ``session`` (affinity key) pass straight through.
    """
    with open(path) as f:
        data = json.load(f)
    entries = data["requests"] if isinstance(data, dict) else data
    rng = np.random.default_rng(seed)
    reqs = []
    for i, d in enumerate(entries):
        if "prompt" in d:
            prompt = np.asarray(d["prompt"], np.int32)
        else:
            if vocab is None:
                raise ValueError(
                    "trace entries with prompt_len need vocab to draw "
                    "tokens")
            prompt = rng.integers(0, vocab,
                                  size=int(d["prompt_len"])
                                  ).astype(np.int32)
        dl = d.get("decode_len")
        reqs.append(RequestState(
            int(d.get("rid", i)), prompt,
            arrival_s=float(d.get("arrival_s", 0.0)),
            decode_len=None if dl is None else int(dl),
            session=d.get("session")))
    return reqs


# ---------------------------------------------------------------------------
# Single-replica loop
# ---------------------------------------------------------------------------
class Scheduler:
    """Arrival-driven continuous-batching loop for one engine replica.

    Owns the pending queue and the wall clock; the engine owns slots,
    caches, and preemption.  ``run_trace`` reproduces the seed engine's
    scheduling bit-for-bit: preempted requests re-enter before new
    arrivals, at most one prefill chunk is co-scheduled per decode
    iteration, and admission stops at the first refusal (FIFO order is
    never reshuffled).  The router drives the same object incrementally
    via ``enqueue`` + ``tick(now)``.
    """

    def __init__(self, engine):
        self.engine = engine
        self.pending: List[RequestState] = []

    @property
    def tracer(self):
        """The engine's (replica-bound) tracer; stub engines used by the
        policy unit tests don't carry one, so fall back to the null."""
        return getattr(self.engine, "tracer", NULL_TRACER)

    # -- incremental interface (used by the router) --------------------
    def enqueue(self, reqs) -> None:
        if isinstance(reqs, RequestState):
            reqs = [reqs]
        tracer = self.tracer
        if tracer.enabled:
            for r in reqs:
                tracer.emit("arrival", rid=r.rid, arrival_s=r.arrival_s,
                            prompt_len=len(r.prompt))
        self.pending.extend(reqs)
        self.pending.sort(key=lambda r: (r.arrival_s, r.rid))

    @property
    def backlog(self) -> int:
        """Requests queued but not yet resident on the replica."""
        return len(self.pending) + len(self.engine.requeue)

    def idle(self) -> bool:
        return not self.engine.busy() and not self.backlog

    def tick(self, now: float) -> int:
        """One scheduling iteration at wall-time ``now``: re-admit
        preempted requests first, admit arrived pending requests, then
        advance the replica (one prefill chunk + one decode step)."""
        eng = self.engine
        tracer = self.tracer
        while eng.requeue:          # preempted requests re-enter first
            if not eng.admit(eng.requeue[0]):
                break
            r = eng.requeue.pop(0)
            if tracer.enabled:
                tracer.emit("admit", rid=r.rid, slot=r.slot,
                            requeued=True)
        while self.pending and self.pending[0].arrival_s <= now \
                and not eng.requeue:
            if not eng.admit(self.pending[0]):
                break
            r = self.pending.pop(0)
            if tracer.enabled:
                tracer.emit("admit", rid=r.rid, slot=r.slot,
                            requeued=False)
        return eng.tick()

    # -- standalone trace loop ------------------------------------------
    def run_trace(self, reqs: List[RequestState]) -> dict:
        """Drive an explicit request trace to completion and report."""
        n_requests = len(reqs)
        self.enqueue(reqs)
        eng = self.engine
        t0 = time.perf_counter()
        while len(eng.completed) < n_requests:
            now = time.perf_counter() - t0
            self.tick(now)
            if not eng.busy() and self.pending:
                time.sleep(max(0.0, min(0.01,
                                        self.pending[0].arrival_s - now)))
        wall = time.perf_counter() - t0
        return self.metrics(wall, t0)

    def metrics(self, wall: float, t0: float) -> dict:
        eng = self.engine
        tbts, ttfts = [], []
        for r in eng.completed:
            if len(r.token_times) > 1:
                tbts.extend(np.diff(r.token_times))
            if r.first_token_s is not None:
                ttfts.append(r.first_token_s - t0 - r.arrival_s)
        toks = sum(len(r.tokens_out) for r in eng.completed)
        reasons = [r.finish_reason for r in eng.completed]
        kv = eng.kv_report()
        # live co-design channel ({} on engines without it, incl. stubs)
        cd = getattr(eng, "codesign_report", dict)()
        # fused decode-loop channel ({} on per-tick / dense engines)
        fr = getattr(eng, "fused_report", dict)()
        # single producer for every statistical value below: histograms
        # retain the exact samples, so mean/quantile match the old inline
        # np.mean/np.percentile math bit-for-bit
        reg = serving_registry()
        tbt_h = reg.observe_all("tpot_s", tbts)
        ttft_h = reg.observe_all("ttft_s", ttfts)
        reg.observe_all("gather_cost_s",
                        getattr(eng, "gather_cost_samples", []))
        reg.observe_all("fused_horizon",
                        getattr(eng, "fused_horizons", []))
        reg.counter("requests").inc(len(eng.completed))
        reg.counter("decoded_tokens").inc(toks)
        reg.counter("preemptions").inc(eng.preemption_count)
        reg.counter("finish_eos").inc(
            sum(1 for x in reasons if x == "eos"))
        reg.counter("finish_budget").inc(
            sum(1 for x in reasons if x == "budget"))
        return {"wall_s": wall, "requests": len(eng.completed),
                "decoded_tokens": toks,
                # an empty / all-preempted trace can complete at wall == 0
                "tokens_per_s": toks / wall if wall > 0 else 0.0,
                "tbt_mean_s": tbt_h.mean,
                "tbt_p99_s": tbt_h.quantile(99),
                "ttft_mean_s": ttft_h.mean,
                "tpot_mean_s": tbt_h.mean,
                "preemptions": reg.counter("preemptions").value,
                "finish_eos": reg.counter("finish_eos").value,
                "finish_budget": reg.counter("finish_budget").value,
                "kv_mode": kv["mode"],
                "kv_reserved_tokens": kv["reserved_tokens"],
                "kv_peak_tokens": kv["peak_tokens"],
                "kv_logical_peak_pages": kv.get("logical_peak_pages", 0),
                "kv_shared_pages": kv.get("shared_pages", 0),
                "kv_dedup_ratio_peak": kv.get("dedup_ratio_peak", 1.0),
                "cow_forks": kv.get("cow_forks", 0),
                "defrag_runs": kv.get("defrag_runs", 0),
                "prefill_skipped_tokens":
                    kv.get("prefill_skipped_tokens", 0),
                "kv_migrated_pages": kv.get("migrated_pages", 0),
                "kv_migration_cost_s": kv.get("migration_cost_s", 0.0),
                # stack-aware placement (engines with a placement map)
                "placement_policy": kv.get("placement_policy", "none"),
                "kv_gather_cost_mean_s": kv.get("gather_cost_mean_s", 0.0),
                "kv_gather_concentration":
                    kv.get("gather_concentration_mean", 1.0),
                "kv_region_peak": kv.get("region_peak", {}),
                # live co-design (EngineConfig.codesign engines)
                "codesign_substrate": cd.get("substrate", "none"),
                "modeled_time_s": cd.get("modeled_time_s", 0.0),
                "modeled_tokens_per_s": (
                    toks / cd["modeled_time_s"]
                    if cd.get("modeled_time_s") else 0.0),
                "reconfigurations": cd.get("reconfigurations", 0),
                "substrate_configs": cd.get("substrate_configs", 0),
                "array_util_mean": cd.get("array_util_mean", 0.0),
                # fused decode loop (EngineConfig.fuse_steps > 1 engines)
                "fused_ticks": fr.get("fused_ticks", 0),
                "fused_steps_mean": fr.get("fused_steps_mean", 0.0),
                "fused_host_frac": fr.get("host_frac", 0.0),
                # bucketed distribution summaries (live path only — the
                # analytic mirrors report scalar stats, not samples)
                "hists": reg.summaries()["histograms"]}
