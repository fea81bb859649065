"""Serving-level simulator (paper §6.4, Fig. 10; Duplex-style framework).

Poisson request injection -> prefill on the xPU (H100) -> continuous-batching
decode on the device under test (NMP substrate or GPU).  Reports end-to-end
(E2E) latency and time-between-tokens (TBT) under varying request rates.

Deterministic: arrivals use an explicit seeded generator (exponential gaps).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.dataflow import mean_utilization
from repro_torch.core.gemm import ceil_div
from repro_torch.core.gpu_model import gpu_decode_step
from repro_torch.core.hw import H100, GPUConfig, NMPSystem
from repro_torch.core.operators import ModelSpec
from repro_torch.core.pipeline import decode_step
from repro_torch.core.noc import page_ship
from repro_torch.core.placement import (COMMUNAL, PLACEMENT_POLICIES,
                                        default_system, gather_cost,
                                        kv_bytes_per_token)
from repro_torch.core.schedule import exec_config, shape_profile
from repro_torch.serving.replica_api import LoadReport


@dataclass
class Request:
    rid: int
    arrival_s: float
    input_len: int
    output_len: int
    prefill_done_s: float = math.inf
    tokens_out: int = 0
    finish_s: float = math.inf
    token_times: List[float] = field(default_factory=list)
    pages_held: int = 0
    prefill_remaining: int = 0
    # cluster routing keys (simulate_cluster): which shared-prefix group
    # the prompt belongs to, and the session affinity id
    group: int = 0
    session: int = 0
    # stack-aware placement (simulate_serving placement=...): private
    # pages per channel region, and the home region chosen at admission
    region_pages: Dict[int, int] = field(default_factory=dict)
    home: int = 0

    def ctx(self) -> int:
        return self.input_len + self.tokens_out


@dataclass
class ServingReport:
    system: str
    model: str
    rate_req_s: float
    e2e_mean_s: float
    e2e_p90_s: float
    tbt_mean_s: float
    completed: int
    # paged / chunked-prefill extensions (defaults keep old call sites)
    ttft_mean_s: float = 0.0
    kv_util_mean: float = 0.0       # time-weighted used/reserved KV tokens
    kv_peak_tokens: int = 0
    max_decode_stall_s: float = 0.0  # longest gap decode waited on prefill
    preemptions: int = 0
    dedup_ratio: float = 1.0        # peak logical/physical pages (sharing)
    # stack-aware placement metrics (placement=... only)
    gather_cost_mean_s: float = 0.0  # mean per-slot block-table DMA cost
    gather_concentration: float = 1.0  # mean majority-channel page share
    region_peak_pages: Tuple[int, ...] = ()  # peak occupancy per region
    # live co-design metrics (TickLatencyModel callers only)
    reconfigurations: int = 0       # cross-tick shape-profile changes
    substrate_configs: int = 0      # distinct per-op configurations seen
    array_util_mean: float = 0.0    # mean per-tick MAC utilization
    makespan_s: float = 0.0         # modeled clock when the last request ends
    decoded_tokens: int = 0
    tokens_per_s: float = 0.0       # decoded_tokens / makespan_s
    # fused decode loop mirror (fuse_steps > 1 only)
    fused_ticks: int = 0            # boundaries that ran a k>1 horizon
    fused_steps_mean: float = 0.0   # mean horizon length over fused ticks

    def normalized_to(self, base: "ServingReport") -> Tuple[float, float]:
        return (self.e2e_mean_s / base.e2e_mean_s,
                self.tbt_mean_s / base.tbt_mean_s)


def _prefill_time(spec: ModelSpec, input_len: int,
                  gpu: GPUConfig = H100, n_gpus: int = 8) -> float:
    flops = 2 * spec.active_params() * input_len
    return flops / (gpu.peak_flops * 0.55 * n_gpus)


class DecodeLatencyModel:
    """Caches per-(batch, ctx-bucket) decode-iteration latency."""

    def __init__(self, step_fn: Callable[[int, int], float],
                 ctx_bucket: int = 1024):
        self.step_fn = step_fn
        self.ctx_bucket = ctx_bucket
        self._cache: Dict[Tuple[int, int], float] = {}

    def __call__(self, batch: int, ctx: int) -> float:
        cb = max(self.ctx_bucket,
                 ((ctx + self.ctx_bucket - 1) // self.ctx_bucket)
                 * self.ctx_bucket)
        key = (batch, cb)
        if key not in self._cache:
            self._cache[key] = self.step_fn(batch, cb)
        return self._cache[key]


def nmp_latency_model(sys: NMPSystem, spec: ModelSpec,
                      tp: int = 1) -> DecodeLatencyModel:
    return DecodeLatencyModel(
        lambda b, c: decode_step(sys, spec, b, c, tp=tp).time_s)


def gpu_latency_model(spec: ModelSpec, tp: int = 8) -> DecodeLatencyModel:
    return DecodeLatencyModel(
        lambda b, c: gpu_decode_step(spec, b, c, tp=tp).time_s)


# ---------------------------------------------------------------------------
# Live microarchitecture-scheduling co-design (composition-keyed ticks)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class TickDecision:
    """One serving tick's substrate decision: the per-operator array
    shape + dataflow configuration the §5 scheduler picked for the tick's
    actual batch composition, and the resulting modeled latency."""

    time_s: float                  # decode_s + prefill_s
    decode_s: float                # decode half of the tick
    prefill_s: float               # co-scheduled prefill-chunk half
    config: tuple                  # exec_config fingerprint (per-op)
    shapes: tuple                  # distinct logical shapes used
    util: float                    # cycle-weighted MAC utilization
    # fill/drain penalty charged because this tick's shape profile
    # differs from the previous tick's on the same stream; 0.0 on
    # non-reconfiguring ticks (and on the memoized cache entry)
    reconfig_s: float = 0.0


class TickLatencyModel:
    """Composition-keyed per-tick latency model — the live co-design loop.

    Where :class:`DecodeLatencyModel` caches a shape-blind
    ``(batch, ctx-bucket)`` scalar, this model reruns the full §5
    scheduling search (``mode_candidates`` / ``best_logical_shape``
    through :func:`~repro_torch.core.pipeline.decode_step`) for the tick's
    actual composition — decode batch size, per-slot context lengths, a
    co-scheduled chunked-prefill span, and the MoE expert fan-out carried
    by ``spec`` — and returns the chosen substrate configuration together
    with its latency.  Results are memoized on a *reduced shape
    signature* (batch, bucketed mean context, bucketed prefill span) so
    the serving hot path stays O(1) per tick after warm-up.

    Reconfiguration accounting: a tick pays a reconfiguration when its
    :func:`~repro_torch.core.schedule.shape_profile` differs from the previous
    tick's on the same ``stream`` (one stream per engine/replica).  A
    non-reconfigurable substrate has a single legal shape, so its count
    stays 0 by construction — the benchmark's fixed-shape baselines.

    Each reconfiguration is *priced*, not just counted: the tick's
    decision carries ``reconfig_s`` — ``reconfig_cost_s`` when given,
    else the substrate's pipeline fill/drain, ``(phys_rows + phys_cols
    - 2 + reconfig_cycles)`` cycles (SystolicArrayConfig's audit note;
    MAC trees have no systolic pipeline, so their derived cost is 0).

    Drop-in compatible with :class:`DecodeLatencyModel` call sites via
    ``__call__(batch, ctx)``; co-design-aware callers use :meth:`step`.
    """

    def __init__(self, sys: NMPSystem, spec: ModelSpec, tp: int = 1,
                 ctx_bucket: int = 256, prefill_bucket: int = 32,
                 reconfig_cost_s: Optional[float] = None):
        self.sys = sys
        self.spec = spec
        self.tp = tp
        self.ctx_bucket = ctx_bucket
        self.prefill_bucket = prefill_bucket
        self._cache: Dict[tuple, TickDecision] = {}
        self._last_shapes: Dict[object, tuple] = {}
        self.reconfigurations = 0
        self.configs_seen: set = set()
        self.reconfig_cost_s = (self._derived_reconfig_cost()
                                if reconfig_cost_s is None
                                else float(reconfig_cost_s))

    def _derived_reconfig_cost(self) -> float:
        """Fill/drain of the new configuration's systolic pipeline."""
        sub = self.sys.substrate
        rows = getattr(sub, "phys_rows", None)
        cols = getattr(sub, "phys_cols", None)
        if rows is None or cols is None:
            return 0.0          # MAC tree: no pipeline to refill
        cycles = rows + cols - 2 + getattr(sub, "reconfig_cycles", 1)
        return cycles / self.sys.freq_hz

    @staticmethod
    def _bucket(v: int, b: int) -> int:
        return max(b, ((v + b - 1) // b) * b) if v > 0 else 0

    def signature(self, batch: int, ctxs: Optional[List[int]],
                  prefill_tokens: int, prefill_ctx: int) -> tuple:
        """The reduced shape signature a tick memoizes on."""
        ctx = (int(np.mean(ctxs)) if ctxs else 0) if batch else 0
        return (batch, self._bucket(ctx, self.ctx_bucket),
                self._bucket(prefill_tokens, self.prefill_bucket),
                self._bucket(prefill_ctx, self.ctx_bucket))

    def _evaluate(self, sig: tuple) -> TickDecision:
        batch, ctx_b, pf_b, pfctx_b = sig
        execs = []
        decode_s = prefill_s = 0.0
        if batch > 0:
            rep = decode_step(self.sys, self.spec, batch, ctx_b,
                              tp=self.tp)
            decode_s = rep.time_s
            execs.extend(rep.op_execs)
        if pf_b > 0:
            # a prefill chunk of c tokens is a step with M = c rows
            # attending the chunk-end context; the lm_head is skipped
            # (only the final chunk's last token samples)
            rep = decode_step(self.sys, self.spec, pf_b,
                              max(pfctx_b, pf_b), include_head=False,
                              tp=self.tp)
            prefill_s = rep.time_s
            execs.extend(rep.op_execs)
        return TickDecision(
            time_s=decode_s + prefill_s, decode_s=decode_s,
            prefill_s=prefill_s, config=exec_config(execs),
            shapes=shape_profile(execs),
            util=mean_utilization([e.core for e in execs
                                   if e.core is not None]))

    def step(self, batch: int, ctxs: Optional[List[int]] = None,
             prefill_tokens: int = 0, prefill_ctx: int = 0,
             stream: object = 0) -> TickDecision:
        """Price one serving tick and record its substrate configuration."""
        sig = self.signature(batch, ctxs, prefill_tokens, prefill_ctx)
        d = self._cache.get(sig)
        if d is None:
            d = self._cache[sig] = self._evaluate(sig)
        last = self._last_shapes.get(stream)
        reconfigured = last is not None and last != d.shapes
        if reconfigured:
            self.reconfigurations += 1
        self._last_shapes[stream] = d.shapes
        self.configs_seen.add(d.config)
        if reconfigured and self.reconfig_cost_s > 0.0:
            # priced copy; the cached entry stays penalty-free so
            # non-reconfiguring ticks keep returning it unchanged
            return replace(d, reconfig_s=self.reconfig_cost_s)
        return d

    def __call__(self, batch: int, ctx: int) -> float:
        d = self.step(batch, [ctx] * max(1, batch))
        return d.time_s + d.reconfig_s


def nmp_tick_model(sys: NMPSystem, spec: ModelSpec, tp: int = 1,
                   ctx_bucket: int = 256,
                   reconfig_cost_s: Optional[float] = None
                   ) -> TickLatencyModel:
    return TickLatencyModel(sys, spec, tp=tp, ctx_bucket=ctx_bucket,
                            reconfig_cost_s=reconfig_cost_s)


def _pages(n_tokens: int, page_size: int) -> int:
    return ceil_div(n_tokens, page_size)


def simulate_serving(latency: DecodeLatencyModel, spec: ModelSpec,
                     rate_req_s: float, *, system: str,
                     n_requests: int = 128, input_len: int = 8192,
                     output_len: int = 1024, max_batch: int = 64,
                     seed: int = 0, cache_mode: str = "dense",
                     page_size: int = 16, num_pages: Optional[int] = None,
                     prefill_chunk: Optional[int] = None,
                     prefill_on_device: bool = False,
                     prefix_sharing: bool = False,
                     shared_prefix_len: int = 0,
                     placement: Optional[str] = None,
                     n_regions: int = 4,
                     hw: Optional[NMPSystem] = None,
                     fuse_steps: int = 1,
                     tracer=None) -> ServingReport:
    """Analytical serving simulation.

    Mirrors the real-JAX engine's two policy axes (same defaults keep the
    seed behavior bit-for-bit):

    * ``cache_mode``: ``"dense"`` reserves ``max_batch x (in+out)`` KV
      tokens; ``"paged"`` admits against a page pool (``num_pages`` of
      ``page_size`` tokens, defaulting to the dense-equivalent capacity),
      grows contexts on demand, and preempts the youngest request when the
      pool runs dry.  ``kv_util_mean`` reports time-weighted used/reserved
      KV — the Fig. 10 paged-vs-dense occupancy comparison.
    * ``prefill_on_device``: instead of the serialized external H100x8
      prefill stream, prefill work runs on the decode device itself.
      Without ``prefill_chunk`` an admission stalls the whole decode batch
      for the full prompt; with it, at most one chunk of prefill is
      co-scheduled per decode iteration (Sarathi), bounding the stall
      (reported as ``max_decode_stall_s``).
    * ``prefix_sharing`` (paged only): every request's first
      ``shared_prefix_len`` prompt tokens are a common system prompt whose
      *full* pages are resident once and mapped by every concurrent
      holder (the engine's refcounted trie, analytically).  The first
      admission materializes the communal prefix pages; later admissions
      reserve only their unshared tail, and the prefix pages free when the
      last holder releases.  ``dedup_ratio`` reports the peak
      logical/physical page ratio — the admissible-batch multiplier per
      resident page.  Tails are unique, so copy-on-write forks never
      trigger in this analytical mirror.
    * ``placement`` (paged only): mirror of the engine's stack-aware page
      placement.  The page pool splits into ``n_regions`` per-channel
      regions (plus a communal region sized exactly for the shared
      prefix, which every holder reads remotely); private pages place
      under ``free-first`` (lowest region first — the legacy free-list
      layout), ``interleave`` (striped round-robin), or ``affinity``
      (home region chosen at admission, spill to the emptiest other
      region).  Each decode iteration scores every active request's
      region histogram with ``core.placement.gather_cost`` on ``hw``
      (default: the SNAKE template) — reported as ``gather_cost_mean_s``
      / ``gather_concentration`` / ``region_peak_pages``.  Placement
      never changes admission (spill keeps success a function of the
      global free count alone), so latency/throughput stay identical
      across policies; the gather-cost metric is what separates them.
    * ``fuse_steps`` (paged only): mirror of the engine's fused decode
      loop.  Each boundary picks a horizon ``k = min(fuse_steps,
      steps-until-any-request-needs-a-new-page, min remaining decode
      budget)`` and runs ``k`` decode iterations with no admission or
      growth in between — exactly when the real engine's ``lax.scan``
      keeps the host out of the loop.  ``fused_ticks`` /
      ``fused_steps_mean`` report how often and how deep the fusion ran.
    * ``tracer``: an :class:`repro_torch.obs.tracer.Tracer` (construct with
      ``t0=0.0``) receiving the same event schema the live engine emits,
      with timestamps on the *modeled* clock — admissions, prefill
      chunks, decode/fused-tick spans (reconfiguration charge split into
      its own ``reconfigure`` event so spans stay disjoint), preemptions,
      and finishes.  ``None`` (the default) traces nothing and the
      report is bit-identical either way.
    """
    from repro_torch.obs.tracer import NULL_TRACER
    tr = NULL_TRACER if tracer is None else tracer
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_req_s, size=n_requests)
    arrivals = np.cumsum(gaps)
    reqs = [Request(i, float(arrivals[i]), input_len, output_len,
                    prefill_remaining=input_len if prefill_on_device else 0)
            for i in range(n_requests)]
    if tr.enabled:
        for r in reqs:
            tr.emit("arrival", rid=r.rid, ts=r.arrival_s,
                    arrival_s=r.arrival_s, prompt_len=r.input_len)

    t_pf = _prefill_time(spec, input_len)
    if not prefill_on_device:
        # --- prefill: single serialized H100x8 stream -----------------------
        t = 0.0
        for r in reqs:
            t = max(t, r.arrival_s) + t_pf
            r.prefill_done_s = t

    paged = cache_mode == "paged"
    pages_cap = (num_pages if num_pages is not None
                 else max_batch * _pages(input_len + output_len, page_size))
    if paged and pages_cap < _pages(input_len + output_len, page_size):
        raise ValueError(
            f"num_pages={pages_cap} cannot hold even one full context "
            f"({_pages(input_len + output_len, page_size)} pages)")
    if prefix_sharing and not paged:
        raise ValueError("prefix_sharing requires cache_mode='paged'")
    if shared_prefix_len > input_len:
        raise ValueError(f"shared_prefix_len={shared_prefix_len} exceeds "
                         f"input_len={input_len}")
    # only whole pages of the common prefix dedupe (tails are unique)
    shared_full = (shared_prefix_len // page_size
                   if paged and prefix_sharing else 0)
    sharing = shared_full > 0
    prefix_refs = 0                 # analytical refcount on prefix pages
    free_pages = pages_cap
    dense_reserved = max_batch * (input_len + output_len)

    # --- stack-aware placement (per-channel region pools) -------------------
    if placement is not None:
        if placement not in PLACEMENT_POLICIES:
            raise ValueError(f"unknown placement {placement!r}; "
                             f"choose from {PLACEMENT_POLICIES}")
        if not paged:
            raise ValueError("placement requires cache_mode='paged'")
    place = placement is not None
    slot_cap = pages_cap - shared_full      # communal region carved off
    n_reg = max(1, min(n_regions, slot_cap)) if place else 1
    region_cap = [slot_cap // n_reg + (1 if r < slot_cap % n_reg else 0)
                  for r in range(n_reg)]
    region_free = list(region_cap)
    region_peak = [0] * n_reg
    hw_sys = hw or default_system()
    bytes_per_page = kv_bytes_per_token(spec) * page_size
    rr_cursor = 0                   # interleave striping cursor
    gather_sum = conc_sum = 0.0
    gather_iters = 0

    def place_private(r: Request, k: int) -> None:
        """Distribute ``k`` freshly charged private pages over the slot
        regions per the placement policy (mirrors PageAllocator)."""
        nonlocal rr_cursor
        if not place or k == 0:
            return
        if placement == "interleave":       # one page per region in turn
            avail = list(region_free)
            order = []
            while len(order) < k and any(a > 0 for a in avail):
                x = rr_cursor % n_reg
                rr_cursor += 1
                if avail[x] > 0:
                    avail[x] -= 1
                    order.append(x)
            takes = [(x, 1) for x in order]
        else:
            if placement == "affinity":
                order = [r.home] + sorted(
                    (x for x in range(n_reg) if x != r.home),
                    key=lambda x: (-region_free[x], x))
            else:                           # free-first: lowest region up
                order = list(range(n_reg))
            takes, left = [], k
            for x in order:
                got = min(left, region_free[x])
                if got:
                    takes.append((x, got))
                    left -= got
        for x, got in takes:
            region_free[x] -= got
            r.region_pages[x] = r.region_pages.get(x, 0) + got
            region_peak[x] = max(region_peak[x],
                                 region_cap[x] - region_free[x])
            k -= got
        assert k == 0, "private pages exceeded the slot regions"

    def unplace(r: Request) -> None:
        if not place:
            return
        for x, cnt in r.region_pages.items():
            region_free[x] += cnt
        r.region_pages = {}

    def ready_time(r: Request) -> float:
        return r.arrival_s if prefill_on_device else r.prefill_done_s

    # --- continuous-batching decode -----------------------------------------
    clock = 0.0
    pending = sorted(reqs, key=ready_time)
    active: List[Request] = []
    done: List[Request] = []
    util_integral = 0.0
    util_time = 0.0
    kv_peak = 0
    max_stall = 0.0
    preemptions = 0
    dedup_peak = 1.0
    # live co-design: a TickLatencyModel prices each tick from its actual
    # composition (per-request contexts + the co-scheduled prefill chunk)
    # instead of the shape-blind (batch, ctx-bucket) scalar
    tick_step = getattr(latency, "step", None)
    tick_stream = object()          # fresh reconfig stream per run
    reconfigs0 = getattr(latency, "reconfigurations", 0)
    tick_util_sum = 0.0
    tick_iters = 0
    # fused decode-loop mirror (engine lax.scan horizons)
    fused_ticks_n = 0
    fused_steps_sum = 0

    def admit_pages(r: Request) -> bool:
        nonlocal free_pages, prefix_refs
        if not paged:
            return True
        need = _pages(r.input_len + 1, page_size) - shared_full
        # the first holder also materializes the communal prefix pages
        extra = shared_full if (sharing and prefix_refs == 0) else 0
        if free_pages < need + extra:
            return False
        free_pages -= need + extra
        r.pages_held = need
        if place:
            # home region = most free pages at admission, ties lowest id
            r.home = min(range(n_reg), key=lambda x: (-region_free[x], x))
            place_private(r, need)
        if sharing:
            prefix_refs += 1
        return True

    def release(r: Request) -> None:
        nonlocal free_pages, prefix_refs
        if paged:
            free_pages += r.pages_held
            r.pages_held = 0
            unplace(r)
            if sharing:
                prefix_refs -= 1
                if prefix_refs == 0:    # last holder frees the prefix
                    free_pages += shared_full

    preempted_rids: set = set()

    def preempt_youngest(exclude: Request) -> bool:
        nonlocal preemptions
        cands = [r for r in active
                 if r is not exclude and r.prefill_remaining == 0]
        if not cands:
            return False
        victim = max(cands, key=lambda r: (r.arrival_s, r.rid))
        active.remove(victim)
        release(victim)
        victim.tokens_out = 0
        victim.token_times = []
        if prefill_on_device:
            victim.prefill_remaining = victim.input_len
        else:                       # must re-prefill on the xPU stream
            victim.prefill_done_s = clock + t_pf
        pending.append(victim)
        pending.sort(key=ready_time)
        preemptions += 1
        if tr.enabled:
            preempted_rids.add(victim.rid)
            tr.emit("preempt", rid=victim.rid, ts=clock,
                    preemptions=preemptions)
        return True

    while len(done) < n_requests:
        while pending and ready_time(pending[0]) <= clock \
                and len(active) < max_batch and admit_pages(pending[0]):
            r_adm = pending.pop(0)
            active.append(r_adm)
            if tr.enabled:
                tr.emit("admit", rid=r_adm.rid, ts=clock,
                        requeued=r_adm.rid in preempted_rids)
        if not active:
            clock = max(clock, ready_time(pending[0]))
            continue

        decoding = [r for r in active if r.prefill_remaining == 0]
        # --- fused multi-step horizon (engine lax.scan mirror) --------------
        # k_h = min(fuse_steps, steps until any request crosses its page
        # coverage after the boundary's grow-to-ctx+1, min remaining
        # budget): no admission, growth, or finish happens mid-horizon
        k_h = 1
        k_clamp = "fuse_steps"
        if fuse_steps > 1 and paged and decoding:
            caps = [max(r.pages_held + shared_full,
                        _pages(r.ctx() + 1, page_size)) * page_size
                    - r.ctx() for r in decoding]
            buds = [r.output_len - r.tokens_out for r in decoding]
            k_h = max(1, min([fuse_steps] + caps + buds))
            if tr.enabled:
                # same strict-< cascade as the engine's _fused_horizon
                if min(caps) < fuse_steps:
                    k_clamp = "page_edge"
                if min(buds) < min([fuse_steps] + caps):
                    k_clamp = "budget"
            if k_h > 1:
                fused_ticks_n += 1
                fused_steps_sum += k_h
        # --- co-scheduled on-device prefill ---------------------------------
        stall = 0.0
        rc_s = 0.0                  # reconfiguration charge this tick
        step_toks = 0
        pf = next((r for r in active if r.prefill_remaining > 0), None)
        if pf is not None:
            step_toks = (pf.prefill_remaining if prefill_chunk is None
                         else min(prefill_chunk, pf.prefill_remaining))
        if tick_step is not None:
            # co-design: one scheduling decision for the whole tick —
            # the prefill chunk is priced on the decode substrate too
            dec = tick_step(len(decoding), [r.ctx() for r in decoding],
                            prefill_tokens=step_toks,
                            prefill_ctx=(pf.input_len
                                         - pf.prefill_remaining
                                         + step_toks) if pf else 0,
                            stream=tick_stream)
            it, stall = dec.decode_s + dec.reconfig_s, dec.prefill_s
            rc_s = dec.reconfig_s
            tick_util_sum += dec.util
            tick_iters += 1
        else:
            if pf is not None:
                stall = _prefill_time(spec, step_toks, n_gpus=1)
            it = (latency(len(decoding),
                          int(np.mean([r.ctx() for r in decoding])))
                  if decoding else 0.0)
        # price the horizon's trailing decode-only steps (the prefill
        # chunk rides step 0, exactly like the engine's fused tick)
        for j in range(1, k_h):
            if tick_step is not None:
                d2 = tick_step(len(decoding),
                               [r.ctx() + j for r in decoding],
                               stream=tick_stream)
                it += d2.decode_s + d2.reconfig_s
                rc_s += d2.reconfig_s
                tick_util_sum += d2.util
                tick_iters += 1
            else:
                it += latency(len(decoding),
                              int(np.mean([r.ctx() + j
                                           for r in decoding])))
        if pf is not None:
            pf.prefill_remaining -= step_toks
        clock += it + stall
        if tr.enabled:
            # disjoint modeled-clock spans: prefill chunk, then the
            # reconfiguration charge, then the decode work — per tick
            # they sum to exactly `it + stall`
            t_tick0 = clock - it - stall
            if pf is not None and step_toks:
                tr.emit("prefill_chunk", ts=t_tick0, dur=stall,
                        rid=pf.rid, tokens=step_toks,
                        pos=(pf.input_len - pf.prefill_remaining
                             - step_toks),
                        last=pf.prefill_remaining == 0)
            if rc_s > 0:
                tr.emit("reconfigure", ts=t_tick0 + stall, dur=rc_s,
                        modeled_reconfig_s=rc_s)
            if decoding:
                if k_h > 1:
                    tr.emit("fused_tick", ts=t_tick0 + stall + rc_s,
                            dur=it - rc_s, batch=len(decoding),
                            horizon=k_h, clamp=k_clamp)
                else:
                    tr.emit("decode_step", ts=t_tick0 + stall + rc_s,
                            dur=it - rc_s, batch=len(decoding))
        if decoding:                # stall only counts against hot decode
            max_stall = max(max_stall, stall)
        if pf is not None and pf.prefill_remaining == 0:
            pf.prefill_done_s = clock

        # --- occupancy accounting (resident KV over this interval) ---------
        used = sum(r.input_len - r.prefill_remaining + r.tokens_out
                   for r in active)
        reserved = ((pages_cap - free_pages) * page_size if paged
                    else dense_reserved)
        kv_peak = max(kv_peak, reserved)
        if sharing and free_pages < pages_cap:
            # logical pages mapped across block tables vs. physical pages
            logical = (sum(r.pages_held for r in active)
                       + prefix_refs * shared_full)
            dedup_peak = max(dedup_peak,
                             logical / (pages_cap - free_pages))
        dt = it + stall
        if dt > 0 and reserved > 0:
            util_integral += (used / reserved) * dt
            util_time += dt

        # --- gather-cost scoring (stack-aware placement) --------------------
        if place and decoding:
            costs, concs = [], []
            for r in decoding:
                counts = dict(r.region_pages)
                if sharing:     # every holder also reads the communal pages
                    counts[COMMUNAL] = shared_full
                gc = gather_cost(hw_sys, counts, bytes_per_page)
                costs.append(gc.time_s)
                concs.append(gc.concentration)
            gather_sum += float(np.mean(costs))
            conc_sum += float(np.mean(concs))
            gather_iters += 1

        # --- decode token(s) + on-demand page growth ------------------------
        # k_h tokens per request per boundary; the horizon rule puts all
        # growth at j == 0 and budget finishes exactly on the final step
        for r in decoding:
            if r not in active:     # preempted earlier in this iteration
                continue
            for j in range(k_h):
                if paged:
                    need = (_pages(r.ctx() + 1, page_size)
                            - r.pages_held - shared_full)
                    while need > free_pages:
                        if not preempt_youngest(exclude=r):
                            raise RuntimeError("page pool too small for "
                                               "one request")
                    free_pages -= need
                    r.pages_held += need
                    place_private(r, need)
                r.tokens_out += 1
                r.token_times.append(clock - (k_h - 1 - j) * it / k_h)
                if paged:           # growth may move the peak mid-iteration
                    kv_peak = max(kv_peak,
                                  (pages_cap - free_pages) * page_size)
                if r.tokens_out >= r.output_len:
                    r.finish_s = r.token_times[-1]
                    if tr.enabled:
                        tr.emit("finish", rid=r.rid, ts=r.finish_s,
                                reason="budget", tokens=r.tokens_out)
                    release(r)
                    active.remove(r)
                    done.append(r)
                    break

    e2e = np.array([r.finish_s - r.arrival_s for r in done])
    tbts, ttfts = [], []
    for r in done:
        tt = np.asarray(r.token_times)
        first = r.prefill_done_s
        gaps_r = np.diff(np.concatenate([[first], tt]))
        tbts.append(gaps_r.mean())
        ttfts.append(tt[0] - r.arrival_s)
    return ServingReport(system=system, model=spec.name,
                         rate_req_s=rate_req_s,
                         e2e_mean_s=float(e2e.mean()),
                         e2e_p90_s=float(np.percentile(e2e, 90)),
                         tbt_mean_s=float(np.mean(tbts)),
                         completed=len(done),
                         ttft_mean_s=float(np.mean(ttfts)),
                         kv_util_mean=(util_integral / util_time
                                       if util_time else 0.0),
                         kv_peak_tokens=int(kv_peak),
                         max_decode_stall_s=max_stall,
                         preemptions=preemptions,
                         dedup_ratio=dedup_peak,
                         gather_cost_mean_s=(gather_sum / gather_iters
                                             if gather_iters else 0.0),
                         gather_concentration=(conc_sum / gather_iters
                                               if gather_iters else 1.0),
                         region_peak_pages=(tuple(region_peak)
                                            if place else ()),
                         reconfigurations=(
                             getattr(latency, "reconfigurations", 0)
                             - reconfigs0),
                         substrate_configs=len(
                             getattr(latency, "configs_seen", ())),
                         array_util_mean=(tick_util_sum / tick_iters
                                          if tick_iters else 0.0),
                         makespan_s=clock,
                         decoded_tokens=sum(r.tokens_out for r in done),
                         tokens_per_s=(sum(r.tokens_out for r in done)
                                       / clock if clock > 0 else 0.0),
                         fused_ticks=fused_ticks_n,
                         fused_steps_mean=(fused_steps_sum / fused_ticks_n
                                           if fused_ticks_n else 0.0))


# ---------------------------------------------------------------------------
# Multi-replica cluster (the serving/router.py analytical mirror)
# ---------------------------------------------------------------------------
CLUSTER_POLICIES = ("round_robin", "least_loaded", "session_affinity",
                    "prefix_affinity")


@dataclass
class ClusterReport:
    policy: str
    replicas: int
    rate_req_s: float
    completed: int
    throughput_tok_s: float
    e2e_p50_s: float
    e2e_p99_s: float
    tbt_mean_s: float
    per_replica_util: List[float]
    per_replica_completed: List[int]
    dedup_ratio: float          # aggregate peak logical/physical pages
    preemptions: int
    # live co-design metrics (TickLatencyModel callers only)
    reconfigurations: int = 0   # cross-tick shape changes, all replicas
    substrate_configs: int = 0  # distinct per-op configurations seen
    array_util_mean: float = 0.0  # mean per-tick MAC utilization
    # prefill/decode disaggregation (tiers= callers only)
    tiers: str = ""             # "P:D"; "" for colocated clusters
    shipments: int = 0          # prefill->decode KV-page handoffs
    shipped_pages: int = 0
    ship_cost_s: float = 0.0    # modeled cross-stack link time, summed


@dataclass
class _SimShipment:
    """Analytic counterpart of ``serving.paged_cache.PageShipment``: the
    request plus the priced page movement, no arrays."""
    req: Request
    n_pages: int
    bytes_on_wire: int
    cost_s: float
    src: int = -1
    dst: int = -1


def make_cluster_trace(rate_req_s: float, n_requests: int, input_len: int,
                       output_len: int, *, n_groups: int = 4,
                       skew: float = 1.0, seed: int = 0) -> List[Request]:
    """Poisson arrivals tagged with a Zipf(``skew``)-popular prefix group
    (``session`` = group: a multi-turn tenant reusing its system prompt).
    The real-engine counterpart is
    ``serving.scheduler.make_grouped_prefix_trace``."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate_req_s, size=n_requests)
    arrivals = np.cumsum(gaps)
    weights = 1.0 / np.arange(1, n_groups + 1) ** skew
    weights /= weights.sum()
    groups = rng.choice(n_groups, size=n_requests, p=weights)
    return [Request(i, float(arrivals[i]), input_len, output_len,
                    group=int(groups[i]), session=int(groups[i]))
            for i in range(n_requests)]


class _Replica:
    """One decode engine in the analytical cluster: its own clock, xPU
    prefill stream, page pool, and per-group prefix refcounts (the
    per-replica ``PrefixIndex``, analytically).

    Conforms to ``serving.replica_api.Replica`` (``admit`` / ``tick`` /
    ``busy`` / ``load_report`` / ``requeue`` / ``export_slot_pages`` /
    ``import_slot_pages``) so the analytic mirror and the live engine
    present the same surface; the mirror-drift checker pins this.
    ``role="prefill"`` replicas run prompts on their serialized xPU
    stream but never decode — finished prefills wait in ``queue`` until
    ``export_slot_pages`` ships them to a decode-tier replica.
    """

    def __init__(self, latency: DecodeLatencyModel, spec: ModelSpec,
                 max_batch: int, pages_cap: int, page_size: int,
                 shared_full: int, tracer=None, role: str = "mixed",
                 ship_sys: Optional[NMPSystem] = None,
                 page_bytes: int = 0):
        self.latency = latency
        self.spec = spec
        self.max_batch = max_batch
        self.pages_cap = pages_cap
        self.page_size = page_size
        self.shared_full = shared_full
        self.clock = 0.0
        self.busy_s = 0.0
        self.pf_stream = 0.0
        self.queue: List[Request] = []
        self.active: List[Request] = []
        self.done: List[Request] = []
        self.free_pages = pages_cap
        self.prefix_refs: Dict[int, int] = {}
        self.preemptions = 0
        self.logical_peak = 0
        self.physical_peak = 0
        # live co-design: each replica is its own reconfiguration stream
        self._tick_stream = object()
        self.tick_util_sum = 0.0
        self.tick_iters = 0
        if tracer is None:
            from repro_torch.obs.tracer import NULL_TRACER
            tracer = NULL_TRACER
        self.tracer = tracer
        self._preempted_rids: set = set()
        # replica_api.Replica surface: role + (always-empty here —
        # preemptions re-enter this replica's own queue directly)
        self.role = role
        self.requeue: List[Request] = []
        self.ship_sys = ship_sys
        self.page_bytes = page_bytes

    # -- replica_api.Replica protocol surface --------------------------
    def admit(self, r: Request) -> bool:
        """Protocol alias: dispatch-level admission (the queue always
        accepts; page admission happens at decode entry)."""
        self.enqueue(r)
        return True

    def tick(self) -> int:
        return int(self._step_once())

    def busy(self) -> bool:
        return bool(self.active or self.queue)

    def load_report(self) -> LoadReport:
        return LoadReport(
            active=len(self.active), prefilling=0,
            queue_depth=len(self.active) + len(self.queue),
            free_slots=self.max_batch - len(self.active),
            free_pages=self.free_pages,
            min_region_free=self.free_pages)

    def export_slot_pages(self, rid: int) -> Optional[_SimShipment]:
        """Tier handoff, analytically: pull a finished prefill out of the
        queue and price its page movement with ``noc.page_ship``.
        ``None`` while the prefill hasn't completed yet (deferral — the
        mirror of the engine's mid-chunked-prefill refusal)."""
        r = next((q for q in self.queue if q.rid == rid), None)
        if r is None:
            raise KeyError(f"request {rid} is not resident")
        if r.prefill_done_s > self.clock:
            return None
        self.queue.remove(r)
        n_pages = _pages(r.input_len, self.page_size)
        cost = page_ship(self.ship_sys or default_system(),
                         n_pages * self.page_bytes, n_pages, hops=1)
        return _SimShipment(req=r, n_pages=n_pages,
                            bytes_on_wire=cost.bytes_on_wire,
                            cost_s=cost.time_s)

    def import_slot_pages(self, shipment: _SimShipment) -> bool:
        """Receive a shipped prefill: decode cannot start until the
        pages land, so the link time extends ``prefill_done_s`` on the
        modeled clock."""
        r = shipment.req
        r.prefill_done_s += shipment.cost_s
        self.queue.append(r)
        self.queue.sort(key=lambda q: (q.prefill_done_s, q.rid))
        return True

    # -- load signals read by the dispatch policy ----------------------
    def load(self) -> Tuple[int, int]:
        return (len(self.active) + len(self.queue), -self.free_pages)

    def holds_group(self, g: int) -> bool:
        return self.prefix_refs.get(g, 0) > 0

    # -- paged admission with per-group prefix dedup -------------------
    def _admit(self, r: Request) -> bool:
        need = _pages(r.input_len + 1, self.page_size) - self.shared_full
        extra = (self.shared_full
                 if self.shared_full and not self.holds_group(r.group)
                 else 0)
        if self.free_pages < need + extra:
            return False
        self.free_pages -= need + extra
        r.pages_held = need
        if self.shared_full:
            self.prefix_refs[r.group] = \
                self.prefix_refs.get(r.group, 0) + 1
        return True

    def _release(self, r: Request) -> None:
        self.free_pages += r.pages_held
        r.pages_held = 0
        if self.shared_full:
            self.prefix_refs[r.group] -= 1
            if self.prefix_refs[r.group] == 0:
                self.free_pages += self.shared_full
                del self.prefix_refs[r.group]

    def _preempt_youngest(self, exclude: Request) -> bool:
        cands = [r for r in self.active if r is not exclude]
        if not cands:
            return False
        victim = max(cands, key=lambda r: (r.arrival_s, r.rid))
        self.active.remove(victim)
        self._release(victim)
        victim.tokens_out = 0
        victim.token_times = []
        victim.prefill_done_s = self.clock + _prefill_time(
            self.spec, victim.input_len)
        self.queue.append(victim)
        self.queue.sort(key=lambda q: (q.prefill_done_s, q.rid))
        self.preemptions += 1
        if self.tracer.enabled:
            self._preempted_rids.add(victim.rid)
            self.tracer.emit("preempt", rid=victim.rid, ts=self.clock,
                             preemptions=self.preemptions)
        return True

    def enqueue(self, r: Request) -> None:
        """Dispatch: the replica's serialized xPU stream prefills it."""
        self.pf_stream = (max(self.pf_stream, r.arrival_s)
                          + _prefill_time(self.spec, r.input_len))
        r.prefill_done_s = self.pf_stream
        self.queue.append(r)
        # a preempted victim re-queued at clock+t_pf may sit ahead of a
        # later arrival that is ready sooner; head-only admission needs
        # the queue sorted by readiness or an idle replica can livelock
        self.queue.sort(key=lambda q: (q.prefill_done_s, q.rid))

    def _note_peaks(self) -> None:
        physical = self.pages_cap - self.free_pages
        logical = (sum(r.pages_held for r in self.active)
                   + sum(self.prefix_refs.values()) * self.shared_full)
        self.physical_peak = max(self.physical_peak, physical)
        self.logical_peak = max(self.logical_peak, logical)

    def _step_once(self) -> bool:
        """Admit what's ready, run one decode iteration.  False when
        there is nothing to do at the current clock."""
        if self.role == "prefill":
            return False        # prefill tier never decodes; the
            # cluster harvester ships finished prompts off the queue
        while self.queue and self.queue[0].prefill_done_s <= self.clock \
                and len(self.active) < self.max_batch \
                and self._admit(self.queue[0]):
            r_adm = self.queue.pop(0)
            self.active.append(r_adm)
            if self.tracer.enabled:
                self.tracer.emit(
                    "admit", rid=r_adm.rid, ts=self.clock,
                    requeued=r_adm.rid in self._preempted_rids)
        if not self.active:
            return False
        tick_step = getattr(self.latency, "step", None)
        rc_s = 0.0
        if tick_step is not None:
            dec = tick_step(len(self.active),
                            [r.ctx() for r in self.active],
                            stream=self._tick_stream)
            it = dec.time_s + dec.reconfig_s
            rc_s = dec.reconfig_s
            self.tick_util_sum += dec.util
            self.tick_iters += 1
        else:
            it = self.latency(len(self.active),
                              int(np.mean([r.ctx()
                                           for r in self.active])))
        self.clock += it
        self.busy_s += it
        if self.tracer.enabled:
            if rc_s > 0:
                self.tracer.emit("reconfigure", ts=self.clock - it,
                                 dur=rc_s, modeled_reconfig_s=rc_s)
            self.tracer.emit("decode_step", ts=self.clock - it + rc_s,
                             dur=it - rc_s, batch=len(self.active))
        self._note_peaks()
        for r in list(self.active):
            if r not in self.active:    # preempted mid-iteration
                continue
            need = (_pages(r.ctx() + 1, self.page_size)
                    - r.pages_held - self.shared_full)
            while need > self.free_pages:
                if not self._preempt_youngest(exclude=r):
                    raise RuntimeError(
                        "replica page pool too small for one request")
            self.free_pages -= need
            r.pages_held += need
            r.tokens_out += 1
            r.token_times.append(self.clock)
            if r.tokens_out >= r.output_len:
                r.finish_s = self.clock
                if self.tracer.enabled:
                    self.tracer.emit("finish", rid=r.rid, ts=self.clock,
                                     reason="budget", tokens=r.tokens_out)
                self._release(r)
                self.active.remove(r)
                self.done.append(r)
        self._note_peaks()
        return True

    def advance_to(self, t: float) -> None:
        """Run the replica's loop up to wall-time ``t`` (dispatch-time
        synchronization point: load signals are current as of ``t``)."""
        if self.role == "prefill":
            # no decode loop to run; prompts progress on the serialized
            # xPU stream, which already carries its own timeline
            self.clock = max(self.clock, t)
            return
        while self.clock < t:
            if self._step_once():
                continue
            nxt = min((r.prefill_done_s for r in self.queue), default=t)
            if nxt >= t:
                self.clock = t
                return
            self.clock = max(self.clock, nxt)

    def run_to_completion(self) -> None:
        while self.active or self.queue:
            if not self._step_once():
                self.clock = max(self.clock,
                                 min(r.prefill_done_s
                                     for r in self.queue))


def simulate_cluster(latency: DecodeLatencyModel, spec: ModelSpec,
                     rate_req_s: float, *, policy: str = "round_robin",
                     n_replicas: int = 2, n_requests: int = 64,
                     input_len: int = 8192, output_len: int = 1024,
                     max_batch: int = 64, seed: int = 0,
                     page_size: int = 16, num_pages: Optional[int] = None,
                     prefix_sharing: bool = False,
                     shared_prefix_len: int = 0, n_groups: int = 4,
                     skew: float = 1.0,
                     trace: Optional[List[Request]] = None,
                     tracer=None,
                     tiers: Optional[Tuple[int, int]] = None,
                     sys: Optional[NMPSystem] = None) -> ClusterReport:
    """Analytical mirror of ``serving/router.py``: N independent paged
    decode replicas behind one dispatch policy.

    Requests are dispatched in arrival order; before each dispatch every
    replica is advanced to the arrival instant so the policy reads load
    signals as the real front end would.  Replicas then mirror
    ``simulate_serving``'s paged machinery per replica: serialized xPU
    prefill stream, continuous-batching decode via the shared latency
    model, on-demand page growth with youngest-first preemption, and —
    with ``prefix_sharing`` — per-group communal prefix pages refcounted
    per replica, so colocating a group's requests (prefix/session
    affinity) raises the aggregate dedup ratio exactly as the engine's
    trie does.

    ``dedup_ratio`` aggregates peak logical pages over peak physical
    pages across replicas; ``per_replica_util`` is busy decode time over
    the cluster makespan.

    ``tiers=(P, D)`` disaggregates the cluster exactly as
    ``Router(tiers=...)`` does: replicas ``0..P-1`` only prefill (their
    serialized xPU streams), the rest only decode.  Each finished
    prefill is shipped to the decode replica already holding its prefix
    group (ties / no residency: least-loaded), and the
    ``noc.page_ship`` link time delays decode start on the modeled
    clock (``ship`` trace events carry it as their duration).
    """
    if policy not in CLUSTER_POLICIES:
        raise ValueError(f"unknown policy {policy!r}; "
                         f"choose from {CLUSTER_POLICIES}")
    if tiers is not None:
        p_n, d_n = int(tiers[0]), int(tiers[1])
        if p_n < 1 or d_n < 1:
            raise ValueError("tiers needs >=1 prefill and >=1 decode "
                             f"replica, got {p_n}:{d_n}")
        if p_n + d_n != n_replicas:
            raise ValueError(f"tiers {p_n}:{d_n} must sum to the "
                             f"{n_replicas} replicas")
    if trace is None:
        trace = make_cluster_trace(rate_req_s, n_requests, input_len,
                                   output_len, n_groups=n_groups,
                                   skew=skew, seed=seed)
    n_requests = len(trace)
    # size the guard off the actual trace — an explicit ``trace`` may
    # carry longer contexts than the input_len/output_len defaults, and
    # an unsatisfiable admission would spin forever instead of raising
    worst = max(_pages(r.input_len + r.output_len, page_size)
                for r in trace)
    pages_cap = (num_pages if num_pages is not None
                 else max_batch * worst)
    if pages_cap < worst:
        raise ValueError("num_pages cannot hold even one full context")
    shared_full = (shared_prefix_len // page_size
                   if prefix_sharing else 0)
    # validate against the actual trace, not the input_len default —
    # a shorter explicit prompt would drive page accounting negative
    if shared_prefix_len > min(r.input_len for r in trace):
        raise ValueError("shared_prefix_len exceeds a trace prompt")
    ship_sys = sys if sys is not None else default_system()
    page_bytes = kv_bytes_per_token(spec) * page_size
    prefill_idx: Tuple[int, ...] = ()
    decode_idx: Tuple[int, ...] = tuple(range(n_replicas))
    if tiers is not None:
        prefill_idx = tuple(range(tiers[0]))
        decode_idx = tuple(range(tiers[0], n_replicas))
    reps = [_Replica(latency, spec, max_batch, pages_cap, page_size,
                     shared_full,
                     tracer=(tracer.for_replica(i) if tracer is not None
                             else None),
                     role=("prefill" if i in prefill_idx else "mixed"),
                     ship_sys=ship_sys, page_bytes=page_bytes)
            for i in range(n_replicas)]
    reconfigs0 = getattr(latency, "reconfigurations", 0)

    rr = 0
    sessions: Dict[int, int] = {}
    hints: Dict[int, int] = {}

    def least_loaded(among=None) -> int:
        idxs = among if among is not None else range(n_replicas)
        return min(idxs, key=lambda i: reps[i].load() + (i,))

    def select(r: Request) -> int:
        nonlocal rr
        if tiers is not None:
            # disaggregated: arrivals land on the prefill tier; decode
            # placement happens at the ship point below
            return least_loaded(prefill_idx)
        if policy == "round_robin":
            i = rr % n_replicas
            rr += 1
            return i
        if policy == "least_loaded":
            return least_loaded()
        if policy == "session_affinity":
            if r.session not in sessions:
                sessions[r.session] = least_loaded()
            return sessions[r.session]
        holders = [i for i in range(n_replicas)
                   if reps[i].holds_group(r.group)]
        if holders:
            return (holders[0] if len(holders) == 1
                    else least_loaded(holders))
        if r.group in hints:
            return hints[r.group]
        return least_loaded()

    for req in sorted(trace, key=lambda r: (r.arrival_s, r.rid)):
        for rep in reps:
            rep.advance_to(req.arrival_s)
        i = select(req)
        hints[req.group] = i
        if tracer is not None and tracer.enabled:
            tracer.emit("dispatch", replica=i, rid=req.rid,
                        ts=req.arrival_s, policy=policy)
        reps[i].enqueue(req)

    shipments = shipped_pages = 0
    ship_cost = 0.0
    if tiers is not None:
        # tier handoff: ship each finished prefill, in completion order,
        # to the decode replica holding its prefix group (mirror of
        # Router._ship_ready's residency-then-pressure choice), advancing
        # the decode tier to the ship instant so load signals are read
        # exactly when the real harvester would read them
        ready = sorted(((r, i) for i in prefill_idx
                        for r in reps[i].queue),
                       key=lambda pair: (pair[0].prefill_done_s,
                                         pair[0].rid))
        for r, i in ready:
            t_ready = r.prefill_done_s
            reps[i].advance_to(t_ready)
            for j in decode_idx:
                reps[j].advance_to(t_ready)
            holders = [j for j in decode_idx
                       if reps[j].holds_group(r.group)]
            j = (holders[0] if len(holders) == 1
                 else least_loaded(holders if holders else decode_idx))
            ship = reps[i].export_slot_pages(r.rid)
            assert ship is not None and reps[j].import_slot_pages(ship)
            shipments += 1
            shipped_pages += ship.n_pages
            ship_cost += ship.cost_s
            if tracer is not None and tracer.enabled:
                tracer.emit("ship", replica=i, rid=r.rid, ts=t_ready,
                            dur=ship.cost_s, pages=ship.n_pages,
                            bytes=ship.bytes_on_wire,
                            cost_s=ship.cost_s, src=i, dst=j)
    for rep in reps:
        rep.run_to_completion()

    all_done = [r for rep in reps for r in rep.done]
    assert len(all_done) == n_requests
    wall = max(max((r.finish_s for r in all_done)),
               max(r.arrival_s for r in all_done))
    e2e = np.array([r.finish_s - r.arrival_s for r in all_done])
    tbts = [float(np.diff(np.concatenate(
                [[r.prefill_done_s], np.asarray(r.token_times)])).mean())
            for r in all_done]
    logical = sum(rep.logical_peak for rep in reps)
    physical = sum(rep.physical_peak for rep in reps)
    return ClusterReport(
        policy=policy, replicas=n_replicas, rate_req_s=rate_req_s,
        completed=len(all_done),
        throughput_tok_s=sum(r.tokens_out for r in all_done) / wall,
        e2e_p50_s=float(np.percentile(e2e, 50)),
        e2e_p99_s=float(np.percentile(e2e, 99)),
        tbt_mean_s=float(np.mean(tbts)),
        per_replica_util=[rep.busy_s / wall for rep in reps],
        per_replica_completed=[len(rep.done) for rep in reps],
        dedup_ratio=(logical / physical if physical else 1.0),
        preemptions=sum(rep.preemptions for rep in reps),
        reconfigurations=(getattr(latency, "reconfigurations", 0)
                          - reconfigs0),
        substrate_configs=len(getattr(latency, "configs_seen", ())),
        array_util_mean=(sum(rep.tick_util_sum for rep in reps)
                         / max(1, sum(rep.tick_iters for rep in reps))
                         if any(rep.tick_iters for rep in reps) else 0.0),
        tiers=(f"{tiers[0]}:{tiers[1]}" if tiers is not None else ""),
        shipments=shipments, shipped_pages=shipped_pages,
        ship_cost_s=ship_cost)
