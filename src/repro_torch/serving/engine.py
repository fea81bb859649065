"""Continuous-batching serving engines (port of
``repro.serving.engine``, per-tick path).

Two KV residency modes, as in the reference:

* **Dense** (:class:`ServingEngine`) — the engine owns a
  ``max_batch x max_seq`` cache; finished requests free their slot and
  newly prefilled requests are written into a free one.
* **Paged** (:class:`PagedServingEngine`) — KV lives in a page pool
  (``serving/paged_cache.py``) and each slot maps its context through a
  block table.  Prompt pages are reserved at admission, decode growth
  allocates on demand, and an exhausted pool preempts the youngest
  request.  Decode either gathers the slots' pages into the dense view
  (the plain path) or, with ``use_pallas_decode``, reads pages through
  the block table with the paged flash-decode kernel.  A recurrent
  family (RWKV6, ``ssm``; RecurrentGemma, ``hybrid``) has no sequence
  leaf: its state stays slot-dense in the paged engine too, and no page
  is ever allocated.  The encoder-decoder (``audio``) pages its
  self-attention K/V and keeps the cross K/V slot-dense.

With ``prefill_chunk`` set, prompts of the attention families advance
one Sarathi chunk of ``transformer.extend_step`` per tick, co-scheduled
with the decode batch; the paged engine writes those chunks straight
into pages.  Families without ``extend_step`` prefill whole prompts and
decode per tick with no kernel but RWKV6's WKV6.  The
trace-driving loop lives in ``serving/scheduler.py``.

With ``fuse_steps`` > 1 the paged engine of an attention family fuses up
to that many decode steps per tick (``transformer.decode_fused_paged``);
on the card each power-of-two bucket of that horizon is one CUDA graph,
captured at its first use and replayed (``serving/fused_graph.py``); a
tick whose horizon is one step replays the 1-step graph.

With ``prefix_sharing`` the paged engine maps the leading prompt pages
already resident onto the existing pages, starts chunked prefill at the
shared-page boundary, and forks a shared page before a decode write
touches it (copy-on-write): per tick in ``_pre_decode_grow``, and for a
whole fused horizon in ``_cow_horizon``.

With ``placement`` the paged engine places pages by channel region of
the near-memory substrate model (``core/placement.py``), re-homes
spilled pages at defrag, and samples each decode iteration's block-table
gather cost on that model.  With ``codesign`` either engine prices every
tick's operator mix on the reconfigurable substrate
(``core/serving_sim.TickLatencyModel``) and reports the modeled clock
beside the wall clock; neither changes a token.

For prefill/decode disaggregation (``serving/router.py`` tiers) an
engine takes a ``role``: a ``"prefill"`` engine runs prompts but never
decodes, and the router harvests its finished prefills with
``export_slot_pages`` into a ``"decode"`` engine's pool
(``import_slot_pages``); the shipped slot then joins that engine's
decode batch, per tick or inside its fused horizons.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.hw import fixed_sa_system
from repro_torch.core.placement import PlacementMap, default_system
from repro_torch.core.serving_sim import nmp_tick_model
from repro_torch.device import resolve
from repro_torch.kernels import ops as kops
from repro_torch.models import registry
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.serving.fused_graph import FusedGraph
from repro_torch.serving.paged_cache import (PagedCache, PageShipment,
                                             num_blocks)
from repro_torch.serving.replica_api import LoadReport
from repro_torch.serving.scheduler import RequestState, Scheduler, make_trace

__all__ = ["EngineConfig", "ServingEngine", "PagedServingEngine",
           "make_engine"]

# transformer-module families: chunkable prefill (extend_step) and the
# flash-decode attention paths all key off this one set
_ATTN_FAMILIES = registry.TRANSFORMER_FAMILIES

#: the engine's always-on counts (``counters()``): ticks, ticks that
#: advanced a prefill chunk, decoding ticks, their decode steps and
#: lane-steps (tokens), each decoding tick's horizon by the constraint
#: that set it, admissions, finishes, pages grown for decode, and the
#: decode steps a fused-decode graph ran (a horizon's K, a 1-step tick's
#: 1; on the CPU the graph's body runs them eagerly)
COUNTERS = ("ticks", "chunk_ticks", "decode_ticks", "decode_steps",
            "decode_lanes", "clamp_fuse_steps", "clamp_page_edge",
            "clamp_budget", "admissions", "finishes", "pages_grown",
            "graph_steps")


@dataclass
class EngineConfig:
    max_batch: int = 8
    max_seq: int = 512
    max_new_tokens: int = 32
    eos_id: int = -1            # <0: never stops early (synthetic load)
    # the port's CUDA kernels (the name is the reference's): flash-decode
    # attention for the attention families; for the ssm family (RWKV6),
    # where the reference has no kernel to take, the WKV6 recurrence
    # kernel in prefill and decode; nothing for the hybrid and audio
    # families
    use_pallas_decode: bool = False
    prefill_chunk: Optional[int] = None   # Sarathi-style chunked prefill
    paged: bool = False               # block-table KV residency
    page_size: int = 16
    num_pages: Optional[int] = None   # default: dense-equivalent capacity
    prefix_sharing: bool = False      # refcounted prompt-prefix pages + CoW
    # run PagedCache.defrag() when the fraction of holes below the
    # high-water page index exceeds this (None disables the trigger)
    defrag_threshold: Optional[float] = 0.5
    # stack-aware page placement (core/placement.py): None keeps the
    # plain layout with no region accounting; "free-first" keeps the
    # plain layout but scores it; "affinity" co-locates a slot's pages
    # in one per-channel region; "interleave" stripes them
    placement: Optional[str] = None
    placement_regions: Optional[int] = None   # default: one per PU, capped
    # fraction of the pool carved off for shared prefix pages (placement
    # + prefix_sharing only)
    communal_frac: float = 0.25
    # live microarchitecture-scheduling co-design (core/serving_sim.py
    # TickLatencyModel): price every tick's actual operator mix on an NMP
    # substrate model and report the chosen array shapes, reconfiguration
    # count and utilization beside the wall-clock metrics.  The modeled
    # clock is an accounting channel: scheduling stays wall-clock-driven,
    # so decoded tokens are identical with it on or off
    codesign: bool = False
    # price a fixed-shape substrate (rows x PEs/rows at the same PE count
    # as the reconfigurable default) instead
    codesign_rows: Optional[int] = None
    # price this ModelSpec instead of the engine's own (a reduced config
    # can be priced at its full-size spec), and at this tensor-parallel
    # width
    codesign_spec: Optional[object] = None
    codesign_tp: Optional[int] = None
    # seconds charged to the modeled clock per substrate reconfiguration
    # (shape-profile change); None derives the pipeline fill/drain cost
    # from the substrate geometry
    codesign_reconfig_cost_s: Optional[float] = None
    # fuse up to K decode steps into one device-resident loop with
    # tokens, lengths, and eos/finish masks on the device (paged engine
    # only; 1 keeps the per-tick host loop), one CUDA graph per bucketed
    # horizon on the card.  The actual horizon each tick is
    # min(fuse_steps, steps-until-any-slot-needs-a-new-page,
    # min-remaining-decode-budget), so allocation and token streams stay
    # exactly identical to the per-tick engine
    fuse_steps: int = 1
    device: str = "cuda"


def _insert_slot(cache, new, slot: int) -> None:
    """Write request 0 of ``new`` (batch-1 prefill output) into ``slot``
    of ``cache``, in place."""
    for c, n in zip(cache, new):
        if c.ndim == 1:                       # lengths-like, batch axis 0
            c[slot] = n[0]
        else:                                 # (L, B, ...) batch axis 1
            c[:, slot] = n[:, 0]


class ServingEngine:
    """Fixed-slot dense-cache engine."""

    def __init__(self, entry: registry.ArchEntry, ecfg: EngineConfig,
                 tp: int = 1, params: Optional[Dict[str, Any]] = None):
        self.entry = entry
        self.cfg = entry.config
        self.ecfg = ecfg
        self.tp = tp
        self.device = resolve(ecfg.device)
        self.params = (params if params is not None else
                       entry.module.init(self.cfg, tp, device=self.device,
                                         seed=0))
        self.free_slots = list(range(ecfg.max_batch))
        self.active: Dict[int, RequestState] = {}
        self.completed: List[RequestState] = []
        self.preemption_count = 0
        self.requeue: List[RequestState] = []   # preempted, awaiting re-admit
        self._prefilling: Optional[dict] = None   # chunk-scheduler state
        # disaggregation tier: "mixed" engines prefill and decode (the
        # colocated default); a "prefill" engine runs prompts but never
        # decodes, its finished slots are harvested by the router and
        # shipped to a "decode" engine's page pool
        self.role = "mixed"
        # lifecycle tracing: NULL_TRACER keeps the hot path branch-cheap
        self.tracer = NULL_TRACER
        # always-on counts, and what the current tick did (its host.tick
        # span's args); the constraint that set the last decode horizon
        self._counts = dict.fromkeys(COUNTERS, 0)
        self._tick_chunk = self._tick_lanes = self._tick_horizon = 0
        self._last_horizon_clamp = "fuse_steps"
        self._init_cache()
        self._init_codesign()

        mod, cfg = entry.module, self.cfg
        # the kernel hook each family's steps take (the recurrent hybrid
        # and the encoder-decoder have none, as in the reference)
        prefill_kw, decode_kw = {}, {}
        if cfg.family in _ATTN_FAMILIES:
            prefill_kw = {"chunk": ecfg.prefill_chunk}
            if ecfg.use_pallas_decode:
                decode_kw = {"attn_fn": kops.attention_decode}
        elif cfg.family == "ssm" and ecfg.use_pallas_decode:
            prefill_kw = decode_kw = {"wkv_fn": kops.wkv6_scan}

        def _prefill(params, tokens):
            kw = prefill_kw
            if cfg.family == "audio":
                # the frontend stub: zero frames, in float32 as the
                # reference passes them
                kw = {"frames": torch.zeros(
                    (tokens.shape[0], cfg.encoder_frames, cfg.d_model),
                    dtype=torch.float32, device=tokens.device)}
            return mod.prefill(params, cfg, tokens, tp=tp,
                               max_seq=ecfg.max_seq, **kw)

        def _decode(params, cache, tokens):
            return mod.decode_step(params, cfg, tokens, cache, tp=tp,
                                   **decode_kw)

        self._prefill = _prefill
        self._decode = _decode
        self._extend = None
        if cfg.family in _ATTN_FAMILIES:
            self._extend = (lambda params, tokens, cache: mod.extend_step(
                params, cfg, tokens, cache, tp=tp))
        self._next_tok = np.zeros((ecfg.max_batch,), np.int32)

    def set_tracer(self, tracer, replica: int = 0) -> None:
        """Attach an ``obs.tracer`` Tracer; this replica's events carry
        ``replica`` as their process id."""
        self.tracer = tracer.for_replica(replica)

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def _greedy(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy ids over the real vocab (the padded tail excluded), on
        the device."""
        return logits[..., : self.cfg.vocab].argmax(-1)

    def _fetch(self, ids: torch.Tensor) -> np.ndarray:
        """``ids`` on the host: the step's only synchronisation, a
        ``host.fetch`` span."""
        tr = self.tracer
        if not tr.spans:
            return ids.cpu().numpy()
        i = tr.begin("host.fetch")
        out = ids.cpu().numpy()
        tr.end(i)
        return out

    def _argmax(self, logits: torch.Tensor) -> np.ndarray:
        return self._fetch(self._greedy(logits))

    # -- cache backend hooks (overridden by PagedServingEngine) ------------
    def _init_cache(self):
        self.cache = self.entry.cache_zeros(self.ecfg.max_batch,
                                            self.ecfg.max_seq, self.tp,
                                            device=self.device)

    def _claim(self, req: RequestState) -> Optional[int]:
        """Reserve a slot (and, when paged, the prompt's pages)."""
        if not self.free_slots:
            return None
        return self.free_slots.pop()

    def _insert(self, slot: int, new_cache, n_tokens: int) -> None:
        _insert_slot(self.cache, new_cache, slot)

    def _release(self, slot: int) -> None:
        self.free_slots.append(slot)

    def _decode_batch(self, toks: torch.Tensor) -> torch.Tensor:
        """One decode iteration over all slots; returns logits."""
        logits, self.cache = self._decode(self.params, self.cache, toks)
        return logits

    def _pre_decode_grow(self) -> None:
        """Hook: ensure capacity for the token the step is about to write."""

    # -- always-on counters ----------------------------------------------
    def counters(self) -> Dict[str, int]:
        """The counts of :data:`COUNTERS` since the engine was made (a
        window's are the difference of two readings)."""
        return dict(self._counts)

    def tick_args(self) -> dict:
        """What the last tick did: its chunk's tokens, its decode batch,
        horizon and the constraint that set it (``host.tick``'s args)."""
        return {"chunk_tokens": self._tick_chunk, "lanes": self._tick_lanes,
                "horizon": self._tick_horizon,
                "clamp": (self._last_horizon_clamp if self._tick_horizon
                          else None)}

    def _start_tick(self) -> None:
        self._counts["ticks"] += 1
        self._tick_chunk = self._tick_lanes = self._tick_horizon = 0

    def _count_decode(self, steps: int, lanes: int, tokens: int) -> None:
        """One decoding tick: ``steps`` steps over a batch of ``lanes``
        that emitted ``tokens``, its horizon set by
        ``_last_horizon_clamp``."""
        c = self._counts
        c["decode_ticks"] += 1
        c["decode_steps"] += steps
        c["decode_lanes"] += tokens
        c["clamp_" + self._last_horizon_clamp] += 1
        self._tick_horizon, self._tick_lanes = steps, lanes

    def kv_report(self) -> dict:
        """Resident-KV accounting (tokens of cache reserved vs. in use)."""
        used = sum(len(r.prompt) + len(r.tokens_out)
                   for r in self.active.values())
        cap = self.ecfg.max_batch * self.ecfg.max_seq
        return {"mode": "dense", "reserved_tokens": cap,
                "peak_tokens": cap, "used_tokens": used}

    def prefix_residency(self, prompt: np.ndarray) -> int:
        """Prompt pages already resident on this replica (0: the dense
        engine shares nothing)."""
        return 0

    def _budget(self, req: RequestState) -> int:
        """Decode budget: the engine ceiling, tightened by the request's
        trace-sampled early stop (eos-aware traces)."""
        if req.decode_len is not None:
            return min(self.ecfg.max_new_tokens, max(1, req.decode_len))
        return self.ecfg.max_new_tokens

    def _finish(self, slot: int, req: RequestState, now: float,
                hit_eos: bool) -> None:
        req.finish_s = now
        self._counts["finishes"] += 1
        req.finish_reason = (
            "eos" if (hit_eos or self._budget(req) < self.ecfg.max_new_tokens)
            else "budget")
        self.completed.append(req)
        if self.tracer.enabled:
            self.tracer.emit("finish", ts=now, slot=slot, rid=req.rid,
                             reason=req.finish_reason,
                             tokens=len(req.tokens_out))

    def _activate(self, slot: int, req: RequestState) -> None:
        """Prefill done, first token emitted: either the request is
        already finished (budget of one, or the first token IS eos) or it
        joins the decode batch."""
        hit_eos = (self.ecfg.eos_id >= 0
                   and req.tokens_out[-1] == self.ecfg.eos_id)
        if hit_eos or len(req.tokens_out) >= self._budget(req):
            self._finish(slot, req, time.perf_counter(), hit_eos)
            self._release(slot)
            return
        self.active[slot] = req

    def _first_token(self, slot: int, req: RequestState, logits, t0: float,
                     ts: float, take: int) -> None:
        """Prefill boundary: emit the first token and activate the slot."""
        first = int(self._argmax(logits[0]))
        self._next_tok[slot] = first
        req.slot = slot
        req.prefill_done_s = time.perf_counter() - t0
        req.first_token_s = time.perf_counter()
        req.tokens_out.append(first)
        if self.tracer.enabled:
            self.tracer.emit("prefill_chunk", ts=ts,
                             dur=req.first_token_s - ts, slot=slot,
                             rid=req.rid, tokens=take, pos=len(req.prompt),
                             last=True)
        self._activate(slot, req)

    # ------------------------------------------------------------------
    def submit(self, req: RequestState) -> bool:
        """Prefill the request into a free slot; False if engine is full."""
        slot = self._claim(req)
        if slot is None:
            return False
        t0 = time.perf_counter()
        tokens = self._tensor(req.prompt[None, :])
        logits, new_cache = self._prefill(self.params, tokens)
        self._insert(slot, new_cache, len(req.prompt))
        # whole-prompt prefill is one maximal "chunk"
        self._first_token(slot, req, logits, t0, t0, len(req.prompt))
        return True

    def step(self) -> int:
        """One decode iteration for all active slots; returns #finished."""
        if not self.active or self.role == "prefill":
            # a prefill-tier engine holds finished prompts for harvest
            # (export_slot_pages) instead of decoding them
            return 0
        tr = self.tracer
        t_step0 = time.perf_counter() if tr.enabled else 0.0
        batch0 = len(self.active)
        self._pre_decode_grow()
        lanes = len(self.active)
        self._count_decode(1, lanes, lanes)
        d = tr.begin("host.decode", lanes=lanes, steps=1) if tr.spans else -1
        ids = self._greedy(self._decode_batch(self._tensor(self._next_tok)))
        if tr.spans:
            tr.end(d)
        nxt = self._fetch(ids)
        now = time.perf_counter()
        r = tr.begin("host.retire") if tr.spans else -1
        finished = 0
        for slot, req in list(self.active.items()):
            tok = int(nxt[slot])
            req.tokens_out.append(tok)
            req.token_times.append(now)
            hit_eos = self.ecfg.eos_id >= 0 and tok == self.ecfg.eos_id
            if hit_eos or len(req.tokens_out) >= self._budget(req):
                self._finish(slot, req, now, hit_eos)
                del self.active[slot]
                self._release(slot)
                finished += 1
            else:
                self._next_tok[slot] = tok
        if tr.spans:
            tr.end(r, finished=finished)
        if tr.enabled:
            tr.emit("decode_step", ts=t_step0, dur=now - t_step0,
                    batch=batch0, finished=finished)
        return finished

    # -- Sarathi chunk scheduler ---------------------------------------
    def _chunkable(self) -> bool:
        return (self._extend is not None
                and self.ecfg.prefill_chunk is not None)

    def _start_chunked(self, req: RequestState) -> bool:
        """Claim a slot and set up incremental prefill state for ``req``."""
        if self._prefilling is not None:
            return False
        slot = self._claim(req)
        if slot is None:
            return False
        buf = self.entry.cache_zeros(1, self.ecfg.max_seq, self.tp,
                                     device=self.device)
        self._prefilling = {"req": req, "slot": slot, "buf": buf,
                            "pos": 0, "t0": time.perf_counter()}
        return True

    def _chunk_tokens(self, st: dict) -> torch.Tensor:
        req = st["req"]
        take = min(self.ecfg.prefill_chunk, len(req.prompt) - st["pos"])
        return self._tensor(req.prompt[None, st["pos"]: st["pos"] + take])

    def _chunk_progress(self, st: dict, take: int, t_ck0: float) -> None:
        if self.tracer.enabled:
            self.tracer.emit("prefill_chunk", ts=t_ck0,
                             dur=time.perf_counter() - t_ck0,
                             slot=st["slot"], rid=st["req"].rid,
                             tokens=take, pos=st["pos"], last=False)

    def _prefill_chunk_tick(self) -> bool:
        """Advance the in-flight prefill by ONE chunk.  True when the
        request became active (prefill complete)."""
        st = self._prefilling
        if st is None:
            return False
        t_ck0 = time.perf_counter()
        c = self._begin_chunk(st)
        toks = self._chunk_tokens(st)
        take = toks.shape[1]
        logits, st["buf"] = self._extend(self.params, toks, st["buf"])
        st["pos"] += take
        n = len(st["req"].prompt)
        if st["pos"] < n:
            self._chunk_progress(st, take, t_ck0)
            self._end_chunk(c)
            return False
        # prompt fully consumed: move the buffer into the slot
        slot = st["slot"]
        self._insert(slot, st["buf"], n)
        self._prefilling = None
        self._first_token(slot, st["req"], logits, st["t0"], t_ck0, take)
        self._end_chunk(c)
        return True

    def _begin_chunk(self, st: dict) -> int:
        """Count a tick's prefill chunk and open its ``host.chunk``
        span (-1 with spans off)."""
        take = min(self.ecfg.prefill_chunk, len(st["req"].prompt) - st["pos"])
        self._counts["chunk_ticks"] += 1
        self._tick_chunk = take
        tr = self.tracer
        if not tr.spans:
            return -1
        return tr.begin("host.chunk", rid=st["req"].rid, tokens=take,
                        pos=st["pos"])

    def _end_chunk(self, index: int) -> None:
        if index >= 0:
            self.tracer.end(index)

    # -- narrow replica interface (driven by Scheduler) ----------------
    def admit(self, req: RequestState) -> bool:
        """Claim a slot for ``req`` — chunked prefill start when chunking
        is configured, full prefill otherwise.  False when saturated."""
        ok = (self._start_chunked(req) if self._chunkable()
              else self.submit(req))
        if ok:
            self._counts["admissions"] += 1
        return ok

    # -- live co-design (TickLatencyModel accounting channel) ----------
    def _init_codesign(self) -> None:
        self._tick_model = None
        self.modeled_time_s = 0.0
        self._tick_util_sum = 0.0
        self._tick_steps = 0
        if not self.ecfg.codesign:
            return
        hw = default_system()
        if self.ecfg.codesign_rows:
            sa = hw.substrate
            pes = sa.phys_rows * sa.phys_cols
            hw = fixed_sa_system(self.ecfg.codesign_rows,
                                 pes // self.ecfg.codesign_rows)
        self._codesign_hw = hw
        spec = self.ecfg.codesign_spec or self.cfg.nmp_spec()
        self._tick_model = nmp_tick_model(
            hw, spec, tp=self.ecfg.codesign_tp or self.tp,
            reconfig_cost_s=self.ecfg.codesign_reconfig_cost_s)

    def _note_tick(self, batch: int, ctxs: List[int], pf_tokens: int,
                   pf_ctx: int) -> None:
        """Price this tick's actual composition on the modeled substrate."""
        if self._tick_model is None or not (batch or pf_tokens):
            return
        prev = (self._tick_model._last_shapes.get(0)
                if self.tracer.enabled else None)
        d = self._tick_model.step(batch, ctxs, prefill_tokens=pf_tokens,
                                  prefill_ctx=pf_ctx)
        self.modeled_time_s += d.time_s + d.reconfig_s
        self._tick_util_sum += d.util
        self._tick_steps += 1
        if prev is not None and prev != d.shapes:
            # instantaneous on the wall clock; the modeled charge rides
            # in the args
            self.tracer.emit("reconfigure", old=str(prev),
                             new=str(d.shapes),
                             modeled_reconfig_s=d.reconfig_s)

    def _pending_chunk(self) -> Tuple[int, int]:
        """(tokens, context) of the prefill chunk this tick advances, for
        the tick model ((0, 0) with pricing off or no chunk in flight)."""
        st = self._prefilling
        if st is None or self._tick_model is None:
            return 0, 0
        take = min(self.ecfg.prefill_chunk,
                   len(st["req"].prompt) - st["pos"])
        return take, st["pos"] + take

    def _active_ctxs(self) -> List[int]:
        """Contexts of the decode batch about to run (none on a
        prefill-tier engine, which never decodes)."""
        if self.role == "prefill":
            return []
        return [len(r.prompt) + len(r.tokens_out)
                for r in self.active.values()]

    def codesign_report(self) -> dict:
        """Substrate decisions accumulated over the run ({} when off)."""
        if self._tick_model is None:
            return {}
        tm = self._tick_model
        return {"substrate": self._codesign_hw.name,
                "modeled_time_s": self.modeled_time_s,
                "reconfigurations": tm.reconfigurations,
                "substrate_configs": len(tm.configs_seen),
                "array_util_mean": (self._tick_util_sum / self._tick_steps
                                    if self._tick_steps else 0.0)}

    def tick(self) -> int:
        """Advance one iteration: at most one prefill chunk co-scheduled
        with one decode step.  Returns #finished requests."""
        self._start_tick()
        pf_tokens = pf_ctx = 0
        if self._chunkable():
            pf_tokens, pf_ctx = self._pending_chunk()
            self._prefill_chunk_tick()
        if self._tick_model is not None:
            # the decode step about to run (the chunk just ticked may
            # have activated its request into this batch)
            ctxs = self._active_ctxs()
            self._note_tick(len(ctxs), ctxs, pf_tokens, pf_ctx)
        n_fin = self.step()
        if self.tracer.enabled:
            self._trace_gauges()
        return n_fin

    def _gauges(self) -> dict:
        args = {"active": len(self.active),
                "free_slots": len(self.free_slots)}
        args.update(self._pool_gauges())
        if self._tick_model is not None and self.modeled_time_s > 0:
            toks = (sum(len(r.tokens_out) for r in self.completed)
                    + sum(len(r.tokens_out) for r in self.active.values()))
            args["modeled_tokens_per_s"] = toks / self.modeled_time_s
        return args

    def _pool_gauges(self) -> dict:
        """Page-pool gauges (none for the dense engine)."""
        return {}

    def _trace_gauges(self) -> None:
        """One ``gauge`` event per tick (tracing only)."""
        self.tracer.emit("gauge", **self._gauges())

    def busy(self) -> bool:
        return bool(self.active) or self._prefilling is not None

    def load_report(self) -> LoadReport:
        """Load snapshot: resident work (``queue_depth``) and headroom
        (``free_slots`` / ``free_pages``)."""
        prefilling = int(self._prefilling is not None)
        free = len(self.free_slots)
        # dense engines have no page pool; slots are the capacity
        return LoadReport(
            active=len(self.active), prefilling=prefilling,
            queue_depth=(len(self.active) + prefilling
                         + len(self.requeue)),
            free_slots=free, free_pages=free, min_region_free=free)

    # -- disaggregation hooks (the paged engine overrides them) ---------
    def export_slot_pages(self, rid: int) -> Optional[PageShipment]:
        raise RuntimeError("page shipping requires the paged engine "
                           "(EngineConfig.paged)")

    def import_slot_pages(self, shipment: PageShipment) -> bool:
        raise RuntimeError("page shipping requires the paged engine "
                           "(EngineConfig.paged)")

    # -- single-replica trace loops ------------------------------------
    def run_trace(self, reqs: List[RequestState]) -> dict:
        """Drive an explicit request trace through a single-replica
        :class:`~repro_torch.serving.scheduler.Scheduler`."""
        return Scheduler(self).run_trace(reqs)

    def run_workload(self, *, rate_req_s: float, n_requests: int,
                     prompt_len: int, seed: int = 0,
                     prompt_lens: Optional[np.ndarray] = None,
                     **trace_kwargs) -> dict:
        """Poisson arrivals, wall-clock continuous batching; returns the
        metrics.  ``prompt_lens`` overrides the constant ``prompt_len``
        per request; the other ``trace_kwargs`` (``eos_rate``,
        ``sessions``) go to :func:`make_trace`."""
        reqs = make_trace(self.cfg.vocab, rate_req_s=rate_req_s,
                          n_requests=n_requests, prompt_len=prompt_len,
                          seed=seed, prompt_lens=prompt_lens,
                          **trace_kwargs)
        return self.run_trace(reqs)


# ---------------------------------------------------------------------------
# Paged engine
# ---------------------------------------------------------------------------
class PagedServingEngine(ServingEngine):
    """Block-table KV residency + on-demand page growth + preemption."""

    def _init_cache(self):
        ecfg = self.ecfg
        if ecfg.page_size <= 0:
            raise ValueError(f"page_size must be positive, "
                             f"got {ecfg.page_size}")
        max_blocks = num_blocks(ecfg.max_seq, ecfg.page_size)
        n_pages = ecfg.num_pages or ecfg.max_batch * max_blocks
        if n_pages < max_blocks:
            raise ValueError(
                f"num_pages={n_pages} cannot hold even one max-length "
                f"context ({max_blocks} pages)")
        pmap = None
        self._hw = None
        if ecfg.placement is not None:
            self._hw = default_system()
            pmap = PlacementMap.from_system(
                self._hw, n_pages,
                communal_frac=(ecfg.communal_frac
                               if ecfg.prefix_sharing else 0.0),
                n_regions=ecfg.placement_regions)
        self.paged = PagedCache(self.entry, max_batch=ecfg.max_batch,
                                max_seq=ecfg.max_seq,
                                page_size=ecfg.page_size,
                                num_pages=n_pages, tp=self.tp,
                                share=ecfg.prefix_sharing,
                                placement=pmap,
                                placement_policy=(ecfg.placement
                                                  or "free-first"),
                                device=self.device)
        # PagedCache rounds max_seq up to a whole number of pages; adopt
        # the rounded value so prefill buffers, gather views and occupancy
        # math all agree with the table capacity (kv_report asserts this)
        ecfg.max_seq = self.paged.max_seq
        self._lengths_host = np.zeros((ecfg.max_batch,), np.int64)
        self.pages_peak = 0
        self.pages_logical_peak = 0
        self.dedup_ratio_peak = 1.0
        self.defrag_runs = 0
        # prompt tokens whose extend_step compute was skipped because the
        # shared-prefix trie already held their KV (chunked prefill)
        self.prefill_tokens_skipped = 0
        self._gather_cost_sum = 0.0
        self._gather_conc_sum = 0.0
        self._gather_cost_steps = 0
        # per-iteration gather-cost samples (the gather_cost_s histogram;
        # one float per decode iteration under a placement map)
        self.gather_cost_samples: List[float] = []
        self._region_peak: Dict[int, int] = {}
        # fused multi-step decode: one FusedGraph per bucketed horizon
        # length (the reference's jit per bucket), all in one graph memory
        # pool, plus the host/device wall split for the host-overhead
        # metric
        self._fused_graphs: Dict[int, FusedGraph] = {}
        self._graph_pool = None
        self._fused_ticks = 0
        self._fused_steps_sum = 0
        self._fused_host_s = 0.0
        self._fused_device_s = 0.0
        # realized horizons (obs histogram source) and the constraint
        # that clamped the most recent one (fused_tick trace events)
        self.fused_horizons: List[int] = []
        self._last_horizon_clamp = "fuse_steps"
        # host seconds the fused ticks spent pricing (_note_gather_cost
        # and the per-step _note_tick), a share of _fused_host_s
        self.pricing_host_s = 0.0

    def set_tracer(self, tracer, replica: int = 0) -> None:
        super().set_tracer(tracer, replica)
        self.paged.tracer = self.tracer   # CoW / defrag / migrate events

    # -- capacity ------------------------------------------------------
    def _claim(self, req: RequestState) -> Optional[int]:
        if not self.free_slots:
            return None
        slot = self.free_slots.pop()
        tokens = req.prompt if self.paged.share else None
        if not self.paged.alloc_slot(slot, len(req.prompt) + 1,
                                     tokens=tokens):
            self.free_slots.append(slot)
            return None
        self._note_pages()
        return slot

    def _insert(self, slot: int, new_cache, n_tokens: int) -> None:
        self.paged.write_slot(slot, new_cache, n_tokens)
        self._lengths_host[slot] = n_tokens

    def _release(self, slot: int) -> None:
        self.paged.free_slot(slot)
        self._lengths_host[slot] = 0
        self._maybe_defrag()
        super()._release(slot)

    def _maybe_defrag(self) -> None:
        """Fragmentation-threshold defrag trigger: compact the page pool
        when the live set has drifted too far from the lowest indices.
        Under placement, defrag also re-homes spilled pages, priced on
        the engine's substrate model."""
        thr = self.ecfg.defrag_threshold
        if thr is not None and self.paged.fragmentation() > thr:
            self.paged.defrag(self._hw)
            self.defrag_runs += 1

    def _note_pages(self) -> None:
        physical = self.paged.pages_in_use()
        self.pages_peak = max(self.pages_peak, physical)
        logical = self.paged.logical_pages()
        self.pages_logical_peak = max(self.pages_logical_peak, logical)
        if physical:
            self.dedup_ratio_peak = max(self.dedup_ratio_peak,
                                        logical / physical)
        if self.paged.placement is not None:
            for r, u in self.paged.alloc.region_used().items():
                self._region_peak[r] = max(self._region_peak.get(r, 0), u)

    def _note_gather_cost(self) -> None:
        """Score the active slots' block tables against the substrate
        (one sample per decode iteration)."""
        if self.paged.placement is None or not self.active:
            return
        cost, conc = self.paged.gather_cost_mean(
            self._hw, slots=sorted(self.active))
        self._gather_cost_sum += cost
        self._gather_conc_sum += conc
        self._gather_cost_steps += 1
        self.gather_cost_samples.append(cost)

    def _slot_region_free(self) -> List[int]:
        """Free pages of each slot region (the communal region left out)."""
        free = self.paged.alloc.region_free()
        return [free[r] for r in free if r >= 0]

    def load_report(self) -> LoadReport:
        base = super().load_report()
        if not self.paged.has_seq:
            return base
        free_pages = self.paged.alloc.free_pages
        region_free: tuple = ()
        min_region_free = free_pages
        if self.paged.placement is not None:
            # the scarcest slot region gates an affinity admission
            # staying fully co-located
            region_free = tuple(self._slot_region_free())
            min_region_free = min(region_free)
        return LoadReport(
            active=base.active, prefilling=base.prefilling,
            queue_depth=base.queue_depth, free_slots=base.free_slots,
            free_pages=free_pages, min_region_free=min_region_free,
            region_free=region_free)

    def prefix_residency(self, prompt: np.ndarray) -> int:
        return self.paged.prefix_residency(prompt)

    # -- prefill/decode disaggregation ---------------------------------
    def export_slot_pages(self, rid: int) -> Optional[PageShipment]:
        """Package request ``rid``'s finished-prefill slot for shipment to
        a decode-tier replica, and release the slot here.

        ``None`` while the request is still mid chunked prefill (the
        harvester retries next tick).  The shipment carries the request,
        its first decoded token (produced at the prefill boundary here,
        so the decode tier continues the exact greedy stream) and the
        priced movement cost."""
        st = self._prefilling
        if st is not None and st["req"].rid == rid:
            return None                 # mid-prefill: defer the handoff
        slot = next((s for s, r in self.active.items() if r.rid == rid),
                    None)
        if slot is None:
            raise KeyError(f"request {rid} is not resident")
        req = self.active.pop(slot)
        shipment = self.paged.export_slot_pages(
            slot, int(self._lengths_host[slot]), tokens=req.prompt,
            sys=self._hw, hops=1)
        shipment.req = req
        shipment.next_tok = int(self._next_tok[slot])
        self._lengths_host[slot] = 0
        self._maybe_defrag()
        self.free_slots.append(slot)
        return shipment

    def import_slot_pages(self, shipment: PageShipment) -> bool:
        """Splice a prefill-tier shipment into a free slot and join the
        request to this replica's decode batch (the next per-tick step or
        fused horizon reads its table row, length and next token).
        ``False`` when no slot or too few pages are free; atomic either
        way."""
        if not self.free_slots:
            return False
        slot = self.free_slots.pop()
        if not self.paged.import_slot_pages(slot, shipment):
            self.free_slots.append(slot)
            return False
        req = shipment.req
        self._lengths_host[slot] = shipment.n_tokens
        self._next_tok[slot] = shipment.next_tok
        req.slot = slot
        self.active[slot] = req
        self._note_pages()
        return True

    # -- chunked prefill straight into block-table pages ---------------
    def _start_chunked(self, req: RequestState) -> bool:
        if not self.paged.has_seq:
            # recurrent families: state is slot-dense, keep the buffer path
            return super()._start_chunked(req)
        if self._prefilling is not None:
            return False
        slot = self._claim(req)     # reserves prompt pages, maps shared ones
        if slot is None:
            return False
        # shared-prefix compute skip: pages mapped from the trie already
        # hold the prompt's leading KV, so the prefill starts at the
        # shared-page boundary.  The last prompt token is always computed
        # (its logits give the first output token), which is also the
        # exact-tail case where the whole prompt is resident
        n = len(req.prompt)
        resident = min(int(self.paged.shared_count[slot])
                       * self.ecfg.page_size, n)
        start = min(resident, n - 1)
        self.prefill_tokens_skipped += start
        self._prefilling = {"req": req, "slot": slot, "pos": start,
                            "t0": time.perf_counter()}
        return True

    def _prefill_chunk_tick(self) -> bool:
        """Advance the in-flight prefill by ONE chunk, written directly
        into the slot's pages (gather window -> extend_step -> scatter
        chunk): no dense staging buffer, no admission-time copy."""
        st = self._prefilling
        if st is None:
            return False
        t_ck0 = time.perf_counter()
        c = self._begin_chunk(st)
        slot = st["slot"]
        toks = self._chunk_tokens(st)
        take = toks.shape[1]
        view = self.paged.gather_slot(slot, st["pos"])
        logits, view = self._extend(self.params, toks, view)
        self.paged.scatter_chunk(slot, view, st["pos"], take)
        st["pos"] += take
        n = len(st["req"].prompt)
        if st["pos"] < n:
            self._chunk_progress(st, take, t_ck0)
            self._end_chunk(c)
            return False
        # prompt fully consumed: publish its pages, activate the slot
        self.paged.commit_prefix(slot)
        self._lengths_host[slot] = n
        self._note_pages()
        self._prefilling = None
        self._first_token(slot, st["req"], logits, st["t0"], t_ck0, take)
        self._end_chunk(c)
        return True

    def kv_report(self) -> dict:
        # _init_cache reconciled the engine's max_seq with the paged
        # cache's page-rounded window; occupancy math is wrong if the two
        # (or the table capacity) ever drift apart again
        assert (self.paged.max_seq == self.ecfg.max_seq
                == self.paged.max_blocks * self.ecfg.page_size), \
            "engine max_seq out of sync with page-table capacity"
        used = sum(len(r.prompt) + len(r.tokens_out)
                   for r in self.active.values())
        rep = {"mode": "paged",
               "reserved_tokens": self.paged.kv_tokens_resident(),
               "peak_tokens": self.pages_peak * self.ecfg.page_size,
               "used_tokens": used,
               "logical_peak_pages": self.pages_logical_peak,
               "dedup_ratio_peak": self.dedup_ratio_peak,
               "defrag_runs": self.defrag_runs,
               "prefill_skipped_tokens": self.prefill_tokens_skipped,
               "migrated_pages": self.paged.migrated_pages,
               "migration_cost_s": self.paged.migration_cost_s,
               "shipped_pages": self.paged.shipped_pages,
               "ship_cost_s": self.paged.ship_cost_s}
        rep.update(self.paged.sharing_report())
        if self.paged.placement is not None:
            steps = max(1, self._gather_cost_steps)
            rep.update(self.paged.placement_report().to_dict())
            rep["region_peak"] = {str(r): u
                                  for r, u in self._region_peak.items()}
            rep["gather_cost_mean_s"] = self._gather_cost_sum / steps
            rep["gather_concentration_mean"] = (
                self._gather_conc_sum / steps
                if self._gather_cost_steps else 1.0)
        return rep

    # -- decode --------------------------------------------------------
    def _pre_decode_grow(self) -> None:
        """Grow every active slot to cover the token this step writes;
        preempt the youngest request when the pool runs dry."""
        tr = self.tracer
        g = tr.begin("host.grow") if tr.spans else -1
        pages0 = self.paged.pages_in_use() if tr.enabled else 0
        grown0 = self.paged.grown_pages
        for slot in sorted(self.active):
            if slot not in self.active:      # preempted mid-loop
                continue
            need = num_blocks(int(self._lengths_host[slot]) + 1,
                              self.ecfg.page_size)
            if need > self.paged.max_blocks:
                # preemption can never fix a max_seq overflow — don't
                # evict innocents on the way to an inevitable failure
                raise RuntimeError(
                    f"slot {slot} context {self._lengths_host[slot] + 1} "
                    f"exceeds max_seq={self.paged.max_seq}")
            ln = int(self._lengths_host[slot])
            self._preempt_until(
                slot, lambda: self.paged.extend_slot(slot, ln + 1), "")
            if self.paged.share:
                # the write may target a shared page (identical-prompt
                # tail): fork it now, so the scatter and the paged kernel
                # only ever write pages with refcount 1
                self._preempt_until(
                    slot, lambda: self.paged.cow_for_write(slot, ln),
                    " (copy-on-write fork)")
        self._note_pages()
        self._counts["pages_grown"] += self.paged.grown_pages - grown0
        if tr.enabled:
            grown = self.paged.pages_in_use() - pages0
            if grown > 0:
                tr.emit("grow", pages=grown)
        if tr.spans:
            tr.end(g, pages=self.paged.grown_pages - grown0)

    def _preempt_until(self, slot: int, op, why: str) -> None:
        """Run ``op()`` until it succeeds (a page allocation for
        ``slot``), preempting the youngest other request after each
        failure."""
        while not op():
            victim = self._pick_victim(exclude=slot)
            if victim is None:
                raise RuntimeError("page pool exhausted with no "
                                   f"preemptible request{why}")
            self._preempt(victim)

    def _pick_victim(self, exclude: int) -> Optional[int]:
        cands = [s for s in self.active if s != exclude]
        if not cands:
            return None
        # youngest request (latest arrival) loses its pages
        return max(cands, key=lambda s: (self.active[s].arrival_s,
                                         self.active[s].rid))

    def _preempt(self, slot: int) -> None:
        req = self.active.pop(slot)
        if self.tracer.enabled:
            self.tracer.emit("preempt", slot=slot, rid=req.rid,
                             preemptions=req.preemptions + 1)
        self._release(slot)
        req.reset_generation()
        req.preemptions += 1
        self.preemption_count += 1
        self.requeue.append(req)

    def _decode_batch(self, toks: torch.Tensor) -> torch.Tensor:
        self._note_gather_cost()
        lengths_pre = self._lengths_host.copy()
        active = np.zeros((self.ecfg.max_batch,), bool)
        active[list(self.active)] = True
        if self.ecfg.use_pallas_decode and self.cfg.family in _ATTN_FAMILIES:
            logits = self._decode_paged_kernel(toks, active)
        else:
            cache = self.paged.gather()
            logits, new_cache = self._decode(self.params, cache, toks)
            self.paged.scatter_token(new_cache, lengths_pre, active)
        self._lengths_host[active] += 1
        return logits

    def _decode_paged_kernel(self, toks: torch.Tensor,
                             active: np.ndarray) -> torch.Tensor:
        """Block-table read-through decode: no dense gather materialised."""
        ki, vi = [i for i, s in enumerate(self.paged.is_seq) if s]
        li = self.paged.is_seq.index(False)      # the lengths leaf
        store = list(self.paged.store)
        act = self._tensor(active)
        lengths = self._tensor(np.where(active, self._lengths_host, 0)
                               .astype(np.int32))
        # a lane outside the decode batch can still have pages mapped (a
        # slot mid chunked-prefill; with sharing, live shared prefix
        # pages); every lane writes its K/V, so route
        # each inactive lane's window to the scratch page — on device,
        # over the incrementally maintained table mirror
        tables = torch.where(act[:, None], self.paged.tables_device(),
                             self.paged.num_pages)
        logits, (_, _, new_len) = self.entry.module.decode_step_paged(
            self.params, self.cfg, toks, store[ki], store[vi], tables,
            lengths, tp=self.tp, attn_fn=kops.attention_decode_paged)
        store[li] = torch.where(act, new_len, store[li])
        self.paged.store = store
        return logits

    # -- fused multi-step decode (one CUDA graph per bucketed horizon) --
    def tick(self) -> int:
        # a prefill-tier engine never decodes: it stays on the per-tick
        # path, whose step returns at once
        if (self.ecfg.fuse_steps <= 1 or not self.paged.has_seq
                or self.cfg.family not in _ATTN_FAMILIES
                or self.role == "prefill"
                or not hasattr(self.entry.module, "decode_fused_paged")):
            return super().tick()
        return self._fused_tick()

    def _fused_horizon(self) -> int:
        """K = min(fuse_steps, steps until any active slot crosses its
        mapped page window, min remaining decode budget) — computed from
        ``_lengths_host`` so nothing inside the fused loop ever needs a
        page allocation, and budget finishes land exactly on the final
        step.  Token-level eos cannot be predicted from host state; those
        lanes freeze on device instead (``emitted`` masks their tail
        steps)."""
        tr = self.tracer
        h = tr.begin("host.horizon") if tr.spans else -1
        ps = self.ecfg.page_size
        k = self.ecfg.fuse_steps
        clamp = "fuse_steps"            # which constraint set the horizon
        for slot, req in self.active.items():
            cap = (len(self.paged.blocks_of(slot)) * ps
                   - int(self._lengths_host[slot]))
            if cap < k:
                k, clamp = cap, "page_edge"
            bud = self._budget(req) - len(req.tokens_out)
            if bud < k:
                k, clamp = bud, "budget"
        self._last_horizon_clamp = clamp
        if tr.spans:
            tr.end(h, k=max(1, k), clamp=clamp)
        return max(1, k)

    def _cow_horizon(self, k: int) -> None:
        """Fork every shared page the next ``k`` writes can touch.  A
        shared page is immutable while its refcount is > 1, so forking at
        the horizon boundary copies the same bytes as forking at the
        write step.  Preempts on a failed fork, as the per-tick pass
        does; the horizon stays valid, since lanes only leave."""
        if not self.paged.share:
            return
        tr = self.tracer
        g = tr.begin("host.grow") if tr.spans else -1
        forks0 = self.paged.cow_forks
        ps = self.ecfg.page_size
        for slot in sorted(self.active):
            if slot not in self.active:      # preempted mid-loop
                continue
            ln = int(self._lengths_host[slot])
            for blk in range(ln // ps, (ln + k - 1) // ps + 1):
                self._preempt_until(
                    slot, lambda: self.paged.cow_for_write(slot, blk * ps),
                    " (fused copy-on-write fork)")
        self._note_pages()
        if tr.spans:
            tr.end(g, pages=self.paged.cow_forks - forks0)

    def _fused_fn(self, n_steps: int) -> FusedGraph:
        """The fused loop of ``n_steps`` steps, cached per bucket: a CUDA
        graph captured on first use on the card, the eager loop on the
        CPU."""
        graph = self._fused_graphs.get(n_steps)
        if graph is not None:
            return graph
        mod, cfg, tp = self.entry.module, self.cfg, self.tp
        attn_fn = (kops.attention_decode_paged
                   if self.ecfg.use_pallas_decode else None)
        eos, b = self.ecfg.eos_id, self.ecfg.max_batch
        scratch = self.paged.num_pages
        ki, vi = [i for i, s in enumerate(self.paged.is_seq) if s]
        kp, vp = self.paged.store[ki], self.paged.store[vi]
        params = self.params

        def body(packed, tables):
            toks, lengths = packed[:b], packed[b:2 * b]
            alive, k_active = packed[2 * b:3 * b] != 0, packed[3 * b]
            # inactive lanes (a slot mid chunked-prefill has pages
            # mapped) route to the scratch page, on device
            tables = torch.where(alive[:, None], tables, scratch)
            tok_seq, emit_seq, _, _, ln = mod.decode_fused_paged(
                params, cfg, toks, kp, vp, tables, lengths, alive,
                k_active, n_steps, tp=tp, attn_fn=attn_fn, eos_id=eos)
            return torch.stack([tok_seq, emit_seq.to(tok_seq.dtype)]), ln

        if self.device.type == "cuda" and self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        graph = FusedGraph(body, n_steps, b, self.paged.max_blocks,
                           self.device, (kp, vp), self._graph_pool)
        self._fused_graphs[n_steps] = graph
        return graph

    def _fused_tick(self) -> int:
        """One scheduler tick = one prefill chunk + a K-step fused loop.

        The host surfaces only here, at the fusion-horizon boundary:
        admission/chunk advance, page growth + preemption, then ONE graph
        replay and ONE fetch for all K tokens, then finish bookkeeping.
        A horizon of one step replays the 1-step graph as the per-step
        tick (:meth:`_graph_step`)."""
        t_tick0 = time.perf_counter()
        self._start_tick()
        tr = self.tracer
        pf_tokens = pf_ctx = 0
        if self._chunkable():
            pf_tokens, pf_ctx = self._pending_chunk()
            self._prefill_chunk_tick()
        t_dec0 = time.perf_counter() if tr.enabled else 0.0
        if not self.active:
            self._note_tick(0, [], pf_tokens, pf_ctx)
            if tr.enabled:
                self._trace_gauges()
            return 0
        self._pre_decode_grow()
        k = self._fused_horizon()
        if k <= 1:
            return self._graph_step(pf_tokens, pf_ctx)
        # fork the shared pages the next k writes touch before the table
        # reaches the graph's buffer; a preemption in the pass may defrag,
        # so the mask, lengths and table are read after it
        self._cow_horizon(k)
        batch = len(self.active)
        d = tr.begin("host.decode", lanes=batch, steps=k) if tr.spans else -1
        t_price0 = time.perf_counter()
        self._note_gather_cost()     # one placement sample per fused tick
        self.pricing_host_s += time.perf_counter() - t_price0
        base_ctx = {s: len(r.prompt) + len(r.tokens_out)
                    for s, r in self.active.items()}
        # bucket the loop length to a power of two: a handful of captured
        # horizons serve every K, and lanes freeze at idx >= k on device
        fn = self._fused_fn(1 << (k - 1).bit_length())
        t_dev0 = time.perf_counter()
        out, new_len, active = self._launch(fn, k)
        if tr.spans:
            tr.end(d)
        out = self._fetch(out)
        t_dev1 = time.perf_counter()
        tok_h, emit_h = out[0], out[1].astype(bool)
        self._count_decode(k, batch, int(emit_h[:k].sum()))
        r = tr.begin("host.retire") if tr.spans else -1
        self._set_lengths(active, new_len)
        finished = self._apply_fused(tok_h, emit_h, k, t_dev1)
        if tr.spans:
            tr.end(r, finished=finished)
        if self._tick_model is not None:
            # post-hoc per-step attribution: step j's batch is the lanes
            # that actually ran it (eos'd lanes drop out mid-horizon, as
            # they would tick by tick); the prefill chunk rides step 0
            t_price0 = time.perf_counter()
            for j in range(k):
                ctxs = [base_ctx[s] + j for s in base_ctx
                        if emit_h[j, s]]
                self._note_tick(len(ctxs), ctxs,
                                pf_tokens if j == 0 else 0,
                                pf_ctx if j == 0 else 0)
            self.pricing_host_s += time.perf_counter() - t_price0
        t_tick1 = time.perf_counter()
        self._fused_ticks += 1
        self._fused_steps_sum += k
        self.fused_horizons.append(k)
        dev = t_dev1 - t_dev0
        self._fused_device_s += dev
        self._fused_host_s += (t_tick1 - t_tick0) - dev
        if tr.enabled:
            # the span starts after the co-scheduled prefill chunk so
            # prefill/decode phases stay disjoint
            tr.emit("fused_tick", ts=t_dec0, dur=t_tick1 - t_dec0,
                    batch=batch, horizon=k, clamp=self._last_horizon_clamp,
                    device_s=dev, finished=finished)
            self._trace_gauges()
        return finished

    def _graph_step(self, pf_tokens: int, pf_ctx: int) -> int:
        """The tick's decode when its horizon is one step: the 1-step
        graph replayed in place of :meth:`step`'s launches, with the
        per-step tick's pricing, counts, spans, retirement and
        ``decode_step`` event.  The tick has already mapped every slot's
        next token, so ``step()``'s growth pass, which would grow
        nothing, is not repeated.  Not a fused tick: ``fused_ticks`` and
        ``fused_horizons`` count horizons of two steps and more."""
        tr = self.tracer
        if self._tick_model is not None:
            ctxs = self._active_ctxs()
            self._note_tick(len(ctxs), ctxs, pf_tokens, pf_ctx)
        t_step0 = time.perf_counter() if tr.enabled else 0.0
        lanes = len(self.active)
        self._count_decode(1, lanes, lanes)
        d = tr.begin("host.decode", lanes=lanes, steps=1) if tr.spans else -1
        self._note_gather_cost()
        out, new_len, active = self._launch(self._fused_fn(1), 1)
        if tr.spans:
            tr.end(d)
        out = self._fetch(out)
        now = time.perf_counter()
        r = tr.begin("host.retire") if tr.spans else -1
        self._set_lengths(active, new_len)
        finished = self._apply_fused(out[0], out[1].astype(bool), 1, now)
        if tr.spans:
            tr.end(r, finished=finished)
        if tr.enabled:
            tr.emit("decode_step", ts=t_step0, dur=now - t_step0,
                    batch=lanes, finished=finished)
            self._trace_gauges()
        return finished

    def _launch(self, fn: FusedGraph, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor, np.ndarray]:
        """Queue ``fn`` for a horizon of ``k`` steps over the active
        slots; returns the unfetched ``out``, the lanes' new lengths on
        the device and the active mask."""
        b = self.ecfg.max_batch
        active = np.zeros((b,), bool)
        active[list(self.active)] = True
        packed = np.empty((3 * b + 1,), np.int32)
        packed[:b] = self._next_tok
        packed[b:2 * b] = np.where(active, self._lengths_host, 0)
        packed[2 * b:3 * b] = active
        packed[3 * b] = k
        pools = [t for t, seq in zip(self.paged.store, self.paged.is_seq)
                 if seq]
        out, new_len = fn.launch(packed, self.paged.tables_device(), pools)
        self._counts["graph_steps"] += k
        return out, new_len, active

    def _set_lengths(self, active: np.ndarray, new_len: torch.Tensor) -> None:
        """The active lanes' new lengths into the cache's lengths leaf,
        after the fetch: the mask's pageable copy would otherwise wait
        for the queued replay inside ``host.decode``."""
        store = list(self.paged.store)
        li = self.paged.is_seq.index(False)      # the lengths leaf
        store[li] = torch.where(self._tensor(active), new_len, store[li])
        self.paged.store = store

    def _apply_fused(self, tok_seq: np.ndarray, emit_seq: np.ndarray,
                     k: int, now: float) -> int:
        """Host bookkeeping for one graph launch: append each lane's
        emitted tokens, advance host lengths, retire finished requests.
        ``emit_seq[j, slot]`` masks the steps a lane actually ran — a
        lane frozen by an eos mid-horizon emits nothing afterwards, so
        every append stays behind the emit guard (an unguarded append
        double-counts the finished lane's last token).  Every token of
        the horizon is stamped ``now``, when the fetch returned: no
        client can have one earlier."""
        ecfg = self.ecfg
        finished = 0
        for slot, req in list(self.active.items()):
            for j in range(k):
                if not emit_seq[j, slot]:
                    continue
                req.tokens_out.append(int(tok_seq[j, slot]))
                req.token_times.append(now)
                self._lengths_host[slot] += 1
            hit_eos = (ecfg.eos_id >= 0
                       and req.tokens_out[-1] == ecfg.eos_id)
            if hit_eos or len(req.tokens_out) >= self._budget(req):
                self._finish(slot, req, now, hit_eos)
                del self.active[slot]
                self._release(slot)
                finished += 1
            else:
                self._next_tok[slot] = req.tokens_out[-1]
        return finished

    def fused_report(self) -> dict:
        """Fused-tick accounting ({} before any fused tick ran)."""
        if not self._fused_ticks:
            return {}
        tot = self._fused_host_s + self._fused_device_s
        return {"fused_ticks": self._fused_ticks,
                "fused_steps_mean": (self._fused_steps_sum
                                     / self._fused_ticks),
                "host_frac": self._fused_host_s / tot if tot > 0 else 0.0}

    def reset_fused_counters(self) -> None:
        """Zero the fused-tick accounting — warmup-then-measure callers
        call this between the capture run and the timed run so the
        report covers only the measured region."""
        self._fused_ticks = 0
        self._fused_steps_sum = 0
        self._fused_host_s = 0.0
        self._fused_device_s = 0.0
        self.fused_horizons = []
        self.pricing_host_s = 0.0

    def _pool_gauges(self) -> dict:
        # a family with no sequence leaf (rwkv6, rglru) holds no pages: the
        # reference samples free_pages only where pages exist
        if not self.paged.has_seq:
            return {}
        args = {"free_pages": self.paged.alloc.free_pages}
        if self.paged.placement is not None:
            slot_free = self._slot_region_free()
            if slot_free:
                args["min_region_free"] = min(slot_free)
        return args


def make_engine(entry: registry.ArchEntry, ecfg: EngineConfig,
                tp: int = 1, params: Optional[Dict[str, Any]] = None
                ) -> ServingEngine:
    """The paged or dense engine for ``ecfg`` on ``ecfg.device``;
    ``params`` defaults to ``entry.module.init`` seeded with 0."""
    cls = PagedServingEngine if ecfg.paged else ServingEngine
    return cls(entry, ecfg, tp=tp, params=params)
