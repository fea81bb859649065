"""Multi-replica front-end router (port of ``repro.serving.router``).

The paper's scheduling framework distributes decode work across many
compute stacks; this module is its serving-layer face: a front end that
owns N engine replicas (each driven by a
:class:`~repro_torch.serving.scheduler.Scheduler`) and dispatches an
arrival trace across them under one of four policies:

* ``round_robin`` — cycle replicas in dispatch order;
* ``least_loaded`` — fewest resident+queued requests, ties broken by
  most free pages (both from ``load_report``);
* ``session_affinity`` — a session's first request is placed
  least-loaded, every later request of the session sticks to that
  replica;
* ``prefix_affinity`` — probe each replica's prefix trie for the
  request's leading prompt pages (``prefix_residency``) and route to the
  replica holding the most of them, so refcounted dedup compounds on one
  replica.  Before the first holder's pages commit, a host-side hint map
  (first-page token bytes -> replica) keeps a burst of same-prefix
  arrivals together; with no signal it falls back to least-loaded.

Dispatch is a host-side decision; replicas then run their own
continuous-batching loops.  :func:`make_cluster` builds replicas that
share one set of weights (on the card, once) but never a page pool or a
captured fused-tick graph.  On one card the replicas tick one after
another, so a cluster's tokens/s is not N times one replica's.

Prefill/decode disaggregation
-----------------------------
``tiers=(P, D)`` splits the cluster: replicas ``0..P-1`` are the
prefill tier (``role="prefill"``: they run prompt chunks but never
decode), ``P..P+D-1`` the decode tier.  Arrivals go to the least-loaded
prefill replica; when a request's prefill completes the router harvests
it: ``export_slot_pages`` on the source packages the KV pages,
block-table row and prefix coverage as a
:class:`~repro_torch.serving.paged_cache.PageShipment` priced by
``core/noc.py::page_ship``, and a decode replica chosen by prefix
residency, then ``min_region_free`` pressure, imports it into its
existing pools.  Tokens equal a colocated run's: the first token is
argmaxed at the prefill boundary on the source and travels with the
shipment.  A shipment no decode replica can take is deferred in place
and retried next tick.
"""
from __future__ import annotations

import time
from dataclasses import replace
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.obs.metrics import serving_registry
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.serving.paged_cache import num_blocks
from repro_torch.serving.scheduler import RequestState, Scheduler

POLICIES = ("round_robin", "least_loaded", "session_affinity",
            "prefix_affinity")


class Router:
    """Front end owning N engine replicas and a dispatch policy.

    ``engines`` need only the
    :class:`repro_torch.serving.replica_api.Replica` protocol (``admit``
    / ``tick`` / ``busy`` / ``load_report`` / ``requeue`` /
    ``export_slot_pages`` / ``import_slot_pages``, plus ``completed`` and
    ``prefix_residency`` for prefix affinity): unit tests drive the
    policies with stub replicas.
    """

    def __init__(self, engines: Sequence, policy: str = "round_robin",
                 tiers: Optional[Tuple[int, int]] = None):
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}; "
                             f"choose from {POLICIES}")
        if not engines:
            raise ValueError("router needs at least one replica")
        self.engines = list(engines)
        self.schedulers = [Scheduler(e) for e in self.engines]
        self.policy = policy
        self.tiers: Optional[Tuple[int, int]] = None
        self.prefill_idx: Tuple[int, ...] = ()
        self.decode_idx: Tuple[int, ...] = ()
        if tiers is not None:
            p, d = int(tiers[0]), int(tiers[1])
            if p < 1 or d < 1:
                raise ValueError("tiers needs >=1 prefill and >=1 "
                                 f"decode replica, got {p}:{d}")
            if p + d != len(engines):
                raise ValueError(f"tiers {p}:{d} must sum to the "
                                 f"{len(engines)} replicas")
            self.tiers = (p, d)
            self.prefill_idx = tuple(range(p))
            self.decode_idx = tuple(range(p, p + d))
            for i in self.prefill_idx:
                self.engines[i].role = "prefill"
            for i in self.decode_idx:
                self.engines[i].role = "decode"
        self._rr = 0
        self._sessions: Dict[int, int] = {}
        self._prefix_hint: Dict[bytes, int] = {}
        # (rid, replica) in dispatch order — deterministic policy audit
        self.dispatch_log: List[Tuple[int, int]] = []
        # (rid, src, dst) per shipped handoff — deterministic tier audit
        self.ship_log: List[Tuple[int, int, int]] = []
        self.shipments = 0
        self.shipped_pages = 0
        self.ship_cost_s = 0.0
        self._tracer = NULL_TRACER

    def set_tracer(self, tracer) -> None:
        """Attach one shared tracer: replica ``i``'s engine gets the
        ``for_replica(i)`` view (its Perfetto process id); the router's
        own dispatch events carry the chosen replica."""
        self._tracer = tracer
        for i, eng in enumerate(self.engines):
            if hasattr(eng, "set_tracer"):
                eng.set_tracer(tracer, replica=i)

    # -- policy --------------------------------------------------------
    def _load_score(self, i: int) -> Tuple[int, int, int, int]:
        rep = self.engines[i].load_report()
        backlog = rep.queue_depth + len(self.schedulers[i].pending)
        # placement-aware tiebreak: of two replicas with equal total
        # headroom, prefer the one whose scarcest per-channel region has
        # the most free pages — an affinity admission there stays
        # co-located instead of spilling across the NoC (replicas
        # without a placement map report min_region_free == free_pages,
        # so the extra component is inert for them)
        return (backlog, -rep.free_pages, -rep.min_region_free, i)

    def _least_loaded(self, among: Optional[Sequence[int]] = None) -> int:
        return min(among if among is not None
                   else range(len(self.engines)), key=self._load_score)

    def _prefix_key(self, prompt: np.ndarray) -> bytes:
        """Hint-map key: the first full page of prompt tokens (whole
        prompt when shorter than a page — the exact-tail-sharing case)."""
        page = getattr(getattr(self.engines[0], "ecfg", None),
                       "page_size", 16)
        head = np.ascontiguousarray(prompt[:page], dtype=np.int64)
        return head.tobytes()

    def select(self, req: RequestState) -> int:
        n = len(self.engines)
        if self.tiers is not None:
            # disaggregated: arrivals always land on the prefill tier;
            # the decode placement decision happens at harvest time
            return self._least_loaded(self.prefill_idx)
        if self.policy == "round_robin":
            i = self._rr % n
            self._rr += 1
            return i
        if self.policy == "least_loaded":
            return self._least_loaded()
        if self.policy == "session_affinity":
            sid = req.session if req.session is not None else req.rid
            if sid not in self._sessions:
                self._sessions[sid] = self._least_loaded()
            return self._sessions[sid]
        # prefix_affinity
        res = [eng.prefix_residency(req.prompt) for eng in self.engines]
        best = max(res)
        if best > 0:
            ties = [i for i, v in enumerate(res) if v == best]
            return ties[0] if len(ties) == 1 else self._least_loaded(ties)
        hint = self._prefix_hint.get(self._prefix_key(req.prompt))
        return hint if hint is not None else self._least_loaded()

    def dispatch(self, req: RequestState) -> int:
        i = self.select(req)
        if self.policy == "prefix_affinity":   # only reader of the hints
            self._prefix_hint[self._prefix_key(req.prompt)] = i
        self.dispatch_log.append((req.rid, i))
        if self._tracer.enabled:
            self._tracer.emit("dispatch", replica=i, rid=req.rid,
                              policy=self.policy)
        self.schedulers[i].enqueue(req)
        return i

    # -- tier handoff (prefill -> decode page shipping) ----------------
    def _decode_target(self, req: RequestState, need: int
                       ) -> Optional[int]:
        """Decode replica for a finished prefill: among replicas with a
        free slot and ``need`` free pages (conservative — prefix sharing
        on import only shrinks the bill), prefer the one already holding
        the most of the request's prefix pages, then break ties by load
        with ``min_region_free`` pressure.  ``None``: defer, retry."""
        reports = {j: self.engines[j].load_report()
                   for j in self.decode_idx}
        fit = [j for j in self.decode_idx
               if reports[j].free_slots > 0
               and reports[j].free_pages >= need]
        if not fit:
            return None
        res = {j: self.engines[j].prefix_residency(req.prompt)
               for j in fit}
        best = max(res.values())
        ties = [j for j in fit if res[j] == best] if best > 0 else fit
        return min(ties, key=self._load_score)

    def _ship_ready(self) -> int:
        """Harvest finished prefills off the prefill tier and ship each
        to its decode target.  Requests still mid chunked-prefill export
        as ``None`` (deferred); a target refusal re-imports into the
        source (which just freed exactly those pages) and retries next
        tick, so a handoff is atomic either way."""
        if self.tiers is None:
            return 0
        shipped = 0
        for i in self.prefill_idx:
            src = self.engines[i]
            page = src.ecfg.page_size
            for r in sorted(src.active.values(),
                            key=lambda r: (r.arrival_s, r.rid)):
                need = num_blocks(len(r.prompt), page)
                j = self._decode_target(r, need)
                if j is None:
                    continue        # decode tier full — defer in place
                ship = src.export_slot_pages(r.rid)
                if ship is None:
                    continue        # mid chunked-prefill — defer
                if not self.engines[j].import_slot_pages(ship):
                    ok = src.import_slot_pages(ship)
                    assert ok, "source must re-absorb a refused shipment"
                    continue
                self.shipments += 1
                self.shipped_pages += ship.n_pages
                self.ship_cost_s += ship.cost_s
                self.ship_log.append((r.rid, i, j))
                if self._tracer.enabled:
                    self._tracer.emit(
                        "ship", replica=i, rid=r.rid, pages=ship.n_pages,
                        bytes=ship.bytes_on_wire, cost_s=ship.cost_s,
                        src=i, dst=j)
                shipped += 1
        return shipped

    # -- cluster trace loop --------------------------------------------
    def run_trace(self, reqs: List[RequestState]) -> dict:
        """Dispatch the trace at arrival time and drive every replica's
        scheduling loop to completion; returns aggregate metrics."""
        n_requests = len(reqs)
        pending = sorted(reqs, key=lambda r: (r.arrival_s, r.rid))
        t0 = time.perf_counter()
        while sum(len(e.completed) for e in self.engines) < n_requests:
            now = time.perf_counter() - t0
            while pending and pending[0].arrival_s <= now:
                self.dispatch(pending.pop(0))
            for sch in self.schedulers:
                sch.tick(now)
            self._ship_ready()
            if pending and all(sch.idle() for sch in self.schedulers):
                time.sleep(max(0.0, min(0.01,
                                        pending[0].arrival_s - now)))
        wall = time.perf_counter() - t0
        return self.metrics(wall, t0)

    def metrics(self, wall: float, t0: float) -> dict:
        """Aggregate cluster report + per-replica breakdown.

        ``dedup_ratio_agg`` is the cluster-wide peak logical/physical
        page ratio (sum of per-replica peaks) — the number prefix
        affinity is supposed to push above round-robin's.
        """
        per_replica = []
        all_done: List[RequestState] = []
        logical_peak = physical_peak = 0
        reconfigs = 0
        substrate_cfgs = 0
        modeled_rate = 0.0
        util_sum, util_n = 0.0, 0
        for i, (eng, sch) in enumerate(zip(self.engines,
                                           self.schedulers)):
            m = sch.metrics(wall, t0)
            kv = eng.kv_report()
            # live co-design aggregates (replicas run in parallel, so
            # the cluster's modeled rate is the sum of per-replica rates)
            reconfigs += m.get("reconfigurations", 0)
            # each replica owns its tick model, so the cluster-level
            # figure is the busiest replica's distinct-config count
            substrate_cfgs = max(substrate_cfgs,
                                 m.get("substrate_configs", 0))
            modeled_rate += m.get("modeled_tokens_per_s", 0.0)
            if m.get("modeled_time_s", 0.0) > 0:
                util_sum += m.get("array_util_mean", 0.0)
                util_n += 1
            page = getattr(getattr(eng, "ecfg", None), "page_size", 1)
            phys = kv["peak_tokens"] // max(1, page) \
                if kv["mode"] == "paged" else 0
            logi = kv.get("logical_peak_pages", 0)
            logical_peak += logi
            physical_peak += phys
            per_replica.append({
                "replica": i, "requests": m["requests"],
                "decoded_tokens": m["decoded_tokens"],
                "preemptions": m["preemptions"],
                "kv_peak_tokens": m["kv_peak_tokens"],
                "dedup_ratio_peak": m["kv_dedup_ratio_peak"],
                "tokens_per_s": m["decoded_tokens"] / max(1e-9, wall)})
            all_done.extend(eng.completed)
        e2e = [r.finish_s - t0 - r.arrival_s for r in all_done]
        tbts = []
        for r in all_done:
            if len(r.token_times) > 1:
                tbts.extend(np.diff(r.token_times))
        toks = sum(len(r.tokens_out) for r in all_done)
        # same single-producer registry as Scheduler.metrics: exact
        # samples behind the bucketed summaries, identical statistics
        reg = serving_registry()
        e2e_h = reg.observe_all("e2e_s", e2e)
        tbt_h = reg.observe_all("tpot_s", tbts)
        return {
            "policy": self.policy,
            "replicas": len(self.engines),
            "wall_s": wall,
            "requests": len(all_done),
            "decoded_tokens": toks,
            "tokens_per_s": toks / wall if wall > 0 else 0.0,
            "e2e_p50_s": e2e_h.quantile(50),
            "e2e_p99_s": e2e_h.quantile(99),
            "tbt_mean_s": tbt_h.mean,
            "tbt_p99_s": tbt_h.quantile(99),
            "preemptions": sum(e.preemption_count for e in self.engines),
            "finish_eos": sum(1 for r in all_done
                              if r.finish_reason == "eos"),
            "finish_budget": sum(1 for r in all_done
                                 if r.finish_reason == "budget"),
            "dedup_ratio_agg": (logical_peak / physical_peak
                                if physical_peak else 1.0),
            # live co-design aggregates (0 when no replica runs codesign)
            "reconfigurations": reconfigs,
            "substrate_configs": substrate_cfgs,
            "modeled_tokens_per_s": modeled_rate,
            "array_util_mean": util_sum / util_n if util_n else 0.0,
            # disaggregation channel ("" / 0 for colocated clusters)
            "tiers": (f"{self.tiers[0]}:{self.tiers[1]}"
                      if self.tiers else ""),
            "shipments": self.shipments,
            "shipped_pages": self.shipped_pages,
            "ship_cost_s": self.ship_cost_s,
            "per_replica": per_replica,
            # bucketed cluster-level distribution summaries (live only)
            "hists": reg.summaries()["histograms"],
        }


def make_cluster(entry, ecfg, n_replicas: int,
                 policy: str = "round_robin",
                 tiers: Optional[Tuple[int, int]] = None,
                 params: Optional[Dict[str, Any]] = None) -> Router:
    """Build N identical engine replicas behind a :class:`Router`.

    Each replica gets its own ``EngineConfig`` copy (the paged engine
    adopts the page-rounded ``max_seq`` in place), its own page pool,
    slots and fused-graph cache.  ``params`` are the weights (default:
    ``entry.module.init`` seeded with 0, as ``make_engine``); the first
    replica's weights serve every replica, so they sit on the device
    once.

    ``tiers=(P, D)`` disaggregates the cluster (``P + D == n_replicas``;
    requires a paged config: page shipping moves block-table rows).
    """
    from repro_torch.serving.engine import make_engine
    if tiers is not None and not ecfg.paged:
        raise ValueError("tiers requires a paged EngineConfig "
                         "(page shipping moves KV pages)")
    first = make_engine(entry, replace(ecfg), params=params)
    engines = [first] + [make_engine(entry, replace(ecfg),
                                     params=first.params)
                         for _ in range(n_replicas - 1)]
    return Router(engines, policy=policy, tiers=tiers)
