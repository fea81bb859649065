"""Multi-PU scheduling via spatial and spatio-temporal partitioning (§5).

For every projection/FFN/expert GEMM the scheduler evaluates the paper's four
partitioning modes and picks the fastest:

  IS-S  : K split spatially across PUs, N temporal         -> all-reduce(MxN)
  IS-ST : IS-S + N blocked in time (overlaps the reduce)
  OS-S  : N split spatially across PUs, K temporal         -> all-gather(MxN)
  OS-ST : OS-S + K blocked in time (overlaps gather/vector)

M is never split across PUs (weight replication cost, §3.1).  Attention
QK/AV use head-level parallelism with softmax interleaving; MoE experts are
PU-distributed with all-to-all token dispatch.  Output-layout chaining lets
an OS-S producer feed an IS-S consumer without the all-gather (the consumer's
spatial K split matches the producer's N shard).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import List, Optional, Sequence, Tuple

from repro_torch.core import noc
from repro_torch.core.dataflow import (CoreExec, best_logical_shape, mactree_gemm,
                                       sa_gemm)
from repro_torch.core.energy import EnergyReport, gemm_energy
from repro_torch.core.gemm import Dataflow, Gemm, OpClass, ceil_div
from repro_torch.core.hw import (FP16_BYTES, MacTreeConfig, NMPSystem,
                                 SystolicArrayConfig)


class Mode(Enum):
    IS_S = "IS-S"
    IS_ST = "IS-ST"
    OS_S = "OS-S"
    OS_ST = "OS-ST"


IS_MODES = (Mode.IS_S, Mode.IS_ST)
OS_MODES = (Mode.OS_S, Mode.OS_ST)
ST_BLOCKS = 4                      # temporal blocks in ST modes
OVERLAP_FRACTION = {Dataflow.OS: 0.6, Dataflow.IS: 0.2}  # tile-level (§5b)
VECTOR_OPS_PER_ELEM = 6.0          # avg lane-ops per nonlinear element


@dataclass(frozen=True)
class OpExec:
    """System-level execution report for one operator."""

    op: Gemm
    mode: str
    time_s: float
    compute_s: float               # array-occupancy component (per unit)
    memory_s: float                # DRAM-supply component (per unit)
    comm_s: float                  # exposed collective time
    vector_s: float                # exposed vector/nonlinear time
    energy: EnergyReport
    core: Optional[CoreExec] = None
    out_layout: str = "replicated"  # or "n_sharded"

    @property
    def stalled(self) -> bool:
        return self.memory_s > self.compute_s


# ---------------------------------------------------------------------------
# Substrate helpers
# ---------------------------------------------------------------------------
def _is_sa(sys: NMPSystem) -> bool:
    return isinstance(sys.substrate, SystolicArrayConfig)


def exec_units(sys: NMPSystem) -> int:
    """Independent compute units system-wide (SA cores or MAC-tree PUs)."""
    return sys.cores if _is_sa(sys) else sys.pus


def unit_bw(sys: NMPSystem) -> float:
    return sys.dram_bw_per_core if _is_sa(sys) else sys.dram_bw_per_pu


def core_exec(sys: NMPSystem, g: Gemm, dataflow: Dataflow) -> CoreExec:
    if _is_sa(sys):
        sa = sys.substrate
        rows, cols = best_logical_shape(sa, g.m)
        return sa_gemm(g, rows, cols, dataflow, sa.buffers,
                       sa.pipelined_fills)
    return mactree_gemm(g, sys.substrate)


def _vector_time(sys: NMPSystem, elems: float, pus_active: int = 0) -> float:
    pus_active = pus_active or sys.pus
    lanes = sys.vector.lanes * (sys.cores_per_pu if _is_sa(sys) else 1)
    rate = pus_active * lanes * sys.freq_hz
    return elems * VECTOR_OPS_PER_ELEM / rate


def _vector_ops(elems: float) -> float:
    return elems * VECTOR_OPS_PER_ELEM


# ---------------------------------------------------------------------------
# Projection scheduling: the 4-mode search
# ---------------------------------------------------------------------------
def _mode_exec(sys: NMPSystem, g: Gemm, mode: Mode,
               consumer_chains_k: bool = False) -> OpExec:
    """Evaluate one (projection GEMM, mode) pair on the full system."""
    p = sys.pus
    df = Dataflow.IS if mode in IS_MODES else Dataflow.OS
    # --- spatial split across PUs ------------------------------------------
    g_pu = g.split_k(p) if df == Dataflow.IS else g.split_n(p)
    # --- within a PU, cores split the temporal dimension --------------------
    combine_elems = 0.0
    if _is_sa(sys):
        c = sys.cores_per_pu
        if df == Dataflow.IS:
            g_core = g_pu.split_n(c)
        else:
            # OS temporal = K; per-core partials summed by the vector core.
            g_core = g_pu.split_k(c)
            combine_elems = (c - 1) * g.m * g_pu.n
    else:
        g_core = g_pu
    core = core_exec(sys, g_core, df)
    bw = unit_bw(sys)
    compute_s = core.compute_time(sys.freq_hz)
    memory_s = core.memory_time(bw)
    linear_s = max(compute_s, memory_s)

    # --- collectives ---------------------------------------------------------
    out_bytes = g.m * g.n * FP16_BYTES
    if df == Dataflow.IS:
        cc = noc.all_reduce(sys, out_bytes)
        out_layout = "replicated"
    else:
        if consumer_chains_k:
            cc = noc.CollectiveCost(0, 0.0)
            out_layout = "n_sharded"
        else:
            cc = noc.all_gather(sys, out_bytes // p)
            out_layout = "replicated"

    vec_s = _vector_time(sys, g.nonlinear_elems + combine_elems)
    tail = cc.time_s + vec_s

    if mode in (Mode.IS_S, Mode.OS_S):
        ov = OVERLAP_FRACTION[df]
        exposed_tail = cc.time_s + vec_s * (1 - ov)
        time_s = linear_s + exposed_tail
        comm_exposed, vec_exposed = cc.time_s, vec_s * (1 - ov)
    else:
        # ST: temporal blocking pipelines linear against (comm + vector).
        fill_overhead = 0.0
        if core.spatial_tiles and _is_sa(sys):
            r, c_ = core.logical_shape
            tiles = (1 if sys.substrate.pipelined_fills
                     else core.spatial_tiles)
            fill_overhead = ((ST_BLOCKS - 1) * tiles
                             * (r + c_ - 2) / sys.freq_hz)
        time_s = (max(linear_s, tail) + min(linear_s, tail) / ST_BLOCKS
                  + fill_overhead)
        hidden = min(linear_s, tail) * (1 - 1 / ST_BLOCKS)
        comm_exposed = max(0.0, cc.time_s - hidden)
        vec_exposed = max(0.0, tail - hidden - comm_exposed)

    energy = gemm_energy(
        sys, macs=g.macs,
        sram_bytes=core.sram_bytes * exec_units(sys),
        dram_bytes=core.dram_bytes * exec_units(sys),
        exec_time_s=time_s, noc_bytes=cc.bytes_on_wire,
        vector_ops=_vector_ops(g.nonlinear_elems + combine_elems))
    return OpExec(op=g, mode=mode.value, time_s=time_s, compute_s=compute_s,
                  memory_s=memory_s, comm_s=comm_exposed, vector_s=vec_exposed,
                  energy=energy, core=core, out_layout=out_layout)


def schedule_projection(sys: NMPSystem, g: Gemm,
                        consumer_chains_k: bool = False,
                        modes: Sequence[Mode] = tuple(Mode)) -> OpExec:
    """Per-operator lightweight search over the 4 partitioning modes."""
    cands = [_mode_exec(sys, g, m, consumer_chains_k) for m in modes]
    return min(cands, key=lambda e: e.time_s)


def mode_candidates(sys: NMPSystem, g: Gemm,
                    consumer_chains_k: bool = False) -> List[OpExec]:
    return [_mode_exec(sys, g, m, consumer_chains_k) for m in Mode]


# ---------------------------------------------------------------------------
# Multi-port logical sub-array packing (§4.2.1 / §4.2.2)
#
# SNAKE provisions g = 8 weight-injection ports (4 left + 4 right boundary),
# so the physical fabric can be partitioned into up to 8 independent logical
# sub-arrays, each streaming its OWN stationary-side operand.  Small-M units
# with distinct B matrices (attention (request, kv-head) units, MoE experts,
# MLA per-head absorbs) therefore run CONCURRENTLY on one core.  Fixed-shape
# baselines have a single injection port and process one unit at a time.
# ---------------------------------------------------------------------------
WEIGHT_PORTS = 8


def slice_pack(sys: NMPSystem, m: int) -> Tuple[int, Optional[Tuple[int, int]]]:
    """(units per core, per-slice logical shape) for concurrent small-M units.

    Returns (1, None) when packing is impossible (MAC tree, fixed SA, or M
    exceeding the physical row budget of a slice)."""
    if not _is_sa(sys):
        return 1, None
    sa = sys.substrate
    if not sa.reconfigurable:
        return 1, None
    # slice rows must divide the physical fabric exactly (serpentine remap
    # concatenates whole row groups): round M up to the next legal logical
    # row count
    rows = None
    for r in sorted(sa.logical_row_options):
        if m <= r:
            rows = r
            break
    if rows is None:
        return 1, None
    slices = min(WEIGHT_PORTS, sa.phys_rows // rows)
    cols = sa.pes // (slices * rows)
    return slices, (rows, cols)


def _pack_exec(sys: NMPSystem, g1: Gemm, df: Dataflow,
               pack: int) -> CoreExec:
    sa = sys.substrate
    _, shape = slice_pack(sys, g1.m)
    rows = shape[0]
    cols = sa.pes // (pack * rows)
    return sa_gemm(g1, rows, cols, df, sa.buffers, sa.pipelined_fills)


def _best_unit_exec(sys: NMPSystem, g1: Gemm, df: Dataflow,
                    units: int = 1, n_units: Optional[int] = None
                    ) -> Tuple[CoreExec, int]:
    """Best (exec, units-per-core) between whole-array and sliced mappings.

    Packing p concurrent units on one core shares that core's DRAM supply
    p ways, so it only wins when it reduces the number of waves and the
    sliced mapping stays compute-supplied — the scheduler minimizes
    waves(p) * max(t_compute(p), t_memory(bw / p)) over legal p.
    """
    n_units = n_units or exec_units(sys)
    bw = unit_bw(sys)
    f = sys.freq_hz

    def total(ex: CoreExec, p: int) -> float:
        return ceil_div(units, n_units * p) * max(
            ex.compute_time(f), ex.memory_time(bw / p))

    base = core_exec(sys, g1, df)
    best, best_t = (base, 1), total(base, 1)
    max_slices, _ = slice_pack(sys, g1.m)
    p = 2
    while p <= max_slices:
        ex = _pack_exec(sys, g1, df, p)
        t = total(ex, p)
        if t < best_t:
            best, best_t = (ex, p), t
        p *= 2
    return best


def slice_pack_exec(sys: NMPSystem, g1: Gemm, df: Dataflow,
                    units: int = 1) -> Tuple[CoreExec, int]:
    """Public alias of the (exec, packing) selection for other schedulers."""
    return _best_unit_exec(sys, g1, df, units)


# ---------------------------------------------------------------------------
# Attention: head-level parallelism with softmax interleaving (§5b)
# ---------------------------------------------------------------------------
def schedule_attention(sys: NMPSystem, qk: Gemm, av: Gemm) -> OpExec:
    """Map (request, kv-head) units round-robin over compute units.

    Per unit: QK (IS: N=ctx temporal) -> softmax -> AV (OS: K=ctx temporal);
    the softmax of unit i overlaps the GEMMs of unit i+1 on the same core, so
    only the last softmax is exposed (vector throughput permitting).

    When there are fewer units than cores (large-M MLA attention, or few
    requests per device under TP), the M (head) dimension is further split
    across unit groups — the paper's head-level parallelism applied *within*
    one request — and, if cores still remain idle, the context dimension is
    split too (QK's N / AV's K), with the partial softmaxes merged by the
    vector core via an lse-combine (exactly the flash-decode shard merge).
    """
    assert qk.count == av.count
    units0 = qk.count
    n_units = exec_units(sys)
    bw = unit_bw(sys)
    f = sys.freq_hz
    gran = getattr(sys.substrate, "reconfig_granularity", 8)
    can_pack = _is_sa(sys) and sys.substrate.reconfigurable

    # --- joint search over (head-split, ctx-split, slice-pack) --------------
    # hgroups splits the per-unit M (head) dimension; sgroups splits the
    # context (QK's N / AV's K) with an lse-combine epilogue; pack runs that
    # many units concurrently on one core's multi-port logical sub-arrays.
    best = None
    hg_opts = [h for h in (1, 2, 4, 8, 16)
               if h == 1 or (qk.m > gran and ceil_div(qk.m, h) >= gran)]
    for hgroups in hg_opts:
        m_sub = ceil_div(qk.m, hgroups)
        for sgroups in (1, 2, 4, 8, 16, 32):
            n_sub = ceil_div(qk.n, sgroups)
            if sgroups > 1 and n_sub < 512:
                continue                      # shards too thin to amortize
            units = units0 * hgroups * sgroups
            qk1 = qk.scaled(count=1, m=m_sub, n=n_sub)
            av1 = av.scaled(count=1, m=m_sub, k=n_sub)
            packs = (1, 2, 4, 8) if can_pack else (1,)
            for pack in packs:
                if pack > 1:
                    mx, _ = slice_pack(sys, m_sub)
                    if pack > mx:
                        continue
                    eqk = _pack_exec(sys, qk1, Dataflow.IS, pack)
                    eav = _pack_exec(sys, av1, Dataflow.OS, pack)
                else:
                    eqk = core_exec(sys, qk1, Dataflow.IS)
                    eav = core_exec(sys, av1, Dataflow.OS)
                waves = ceil_div(units, n_units * pack)
                t_unit = (max(eqk.compute_time(f), eqk.memory_time(bw / pack))
                          + max(eav.compute_time(f),
                                eav.memory_time(bw / pack)))
                combine = (sgroups - 1) * units0 * hgroups * m_sub * av.n
                t = waves * t_unit + _vector_time(sys, combine)
                if best is None or t < best[0]:
                    best = (t, eqk, eav, pack, waves, t_unit, combine,
                            qk1, av1, units)
    (_, eqk, eav, pack, waves, t_unit, combine_elems, qk1, av1,
     units) = best
    qk = qk1.scaled(count=units)
    av = av1.scaled(count=units)
    # Exposed first-tile KV fetch (one head's K-block cannot hide DRAM
    # latency behind compute, §5b) — one refill per wave is exposed.
    first_fill = min(eqk.dram_bytes, sys.substrate.buffers.half("weight"))
    t_unit_first = first_fill / bw

    softmax_elems = qk1.m * qk1.n       # per-unit score-row softmax
    t_softmax = _vector_time(sys, softmax_elems, pus_active=1)
    # interleaved: exposed softmax = last unit only (plus any spill where
    # softmax is longer than the next unit's GEMM time)
    spill = max(0.0, t_softmax - t_unit) * max(0, waves - 1)
    t_combine = _vector_time(sys, combine_elems)
    time_s = waves * t_unit + t_unit_first + t_softmax + spill + t_combine

    active_units = min(units, n_units)
    dram = (eqk.dram_bytes + eav.dram_bytes) * units
    sram = (eqk.sram_bytes + eav.sram_bytes) * units
    energy = gemm_energy(sys, macs=qk.macs + av.macs, sram_bytes=sram,
                         dram_bytes=dram, exec_time_s=time_s,
                         vector_ops=_vector_ops(softmax_elems * units
                                                + combine_elems))
    compute_s = waves * (eqk.compute_time(sys.freq_hz)
                         + eav.compute_time(sys.freq_hz))
    memory_s = waves * (eqk.memory_time(bw) + eav.memory_time(bw))
    del active_units
    return OpExec(op=qk.scaled(), mode="HEAD-P", time_s=time_s,
                  compute_s=compute_s, memory_s=memory_s, comm_s=0.0,
                  vector_s=t_softmax + spill + t_combine, energy=energy,
                  core=eqk)


# ---------------------------------------------------------------------------
# MoE experts: PU-distributed with all-to-all dispatch
# ---------------------------------------------------------------------------
def schedule_experts(sys: NMPSystem, experts: Sequence[Gemm],
                     dispatch_bytes: int,
                     force_df: Optional[Dataflow] = None) -> OpExec:
    """Distribute expert GEMMs over PUs; cores split each expert's N.

    Dispatch (tokens -> expert PUs) and the weighted-sum combine ride the
    NoC; expert weight streaming is the dominant DRAM traffic (decode MoE has
    tiny per-expert M).
    """
    assert experts
    units = experts[0].count
    n_units = exec_units(sys)          # SA: cores; MAC tree: PUs
    # Experts map to compute units at unit granularity (one expert per SA
    # core / MAC-tree PU).  Only when there are fewer active experts than
    # units is each expert's N split across a unit group so the whole die
    # stays busy (intra-operator spatial partitioning at the expert level).
    group = max(1, n_units // units) if units < n_units else 1
    eff_units = n_units // group
    bw = unit_bw(sys)
    t_wave = 0.0
    compute_s = memory_s = 0.0
    dram = sram = 0
    macs = 0
    vec_elems = 0.0
    waves = ceil_div(units, eff_units)
    for g in experts:
        g_core = g.scaled(count=1).split_n(group)
        # per-operator dataflow search (forced in the fixed-mode study);
        # §4.2.1 slice packing: tiny-M experts (decode MoE) share one core's
        # fabric across multi-port logical sub-arrays.
        cands = (force_df,) if force_df else (Dataflow.IS, Dataflow.OS)
        best = None
        for df in cands:
            ex_c, pack_c = (_best_unit_exec(sys, g_core, df, units,
                                            eff_units)
                            if group == 1
                            else (core_exec(sys, g_core, df), 1))
            t_c = (ceil_div(units, eff_units * pack_c)
                   * max(ex_c.compute_time(sys.freq_hz),
                         ex_c.memory_time(bw / pack_c)))
            if best is None or t_c < best[0]:
                best = (t_c, ex_c, pack_c)
        _, ex, pack = best
        waves = ceil_div(units, eff_units * pack)
        t_wave += max(ex.compute_time(sys.freq_hz),
                      ex.memory_time(bw / pack))
        compute_s += ex.compute_time(sys.freq_hz)
        memory_s += ex.memory_time(bw / pack)
        dram += ex.dram_bytes * group * units
        sram += ex.sram_bytes * group * units
        macs += g.macs
        vec_elems += g.nonlinear_elems * units

    cc = noc.all_to_all(sys, dispatch_bytes)
    t_vec = _vector_time(sys, vec_elems)
    # Dispatch overlaps the previous layer tail in practice; we charge it
    # here fully (conservative), combine partially overlaps expert waves.
    time_s = cc.time_s + waves * t_wave + t_vec * 0.4
    energy = gemm_energy(sys, macs=macs, sram_bytes=sram, dram_bytes=dram,
                         exec_time_s=time_s, noc_bytes=cc.bytes_on_wire,
                         vector_ops=_vector_ops(vec_elems))
    return OpExec(op=experts[0], mode="EXPERT-P", time_s=time_s,
                  compute_s=waves * compute_s, memory_s=waves * memory_s,
                  comm_s=cc.time_s, vector_s=t_vec * 0.4, energy=energy)


# ---------------------------------------------------------------------------
# Chained scheduling over an operator sequence (assembles the best combo)
# ---------------------------------------------------------------------------
def schedule_chain(sys: NMPSystem, ops: Sequence[Gemm]) -> List[OpExec]:
    """DP over output layouts: OS-S producers may skip the all-gather when
    the next projection takes the sharded dim as its K (§5b "assembles the
    corresponding best scheduling combination for the full network")."""
    n = len(ops)
    if n == 0:
        return []
    # state: output layout after op i ("replicated" | "n_sharded")
    # n_sharded is only consumable if next op's K == this op's N.
    INF = float("inf")
    best: List[dict] = [dict() for _ in range(n + 1)]
    best[0]["replicated"] = (0.0, None, None)
    for i, g in enumerate(ops):
        for layout, (t_acc, _, _) in list(best[i].items()):
            chainable = [False]
            if i + 1 < n and ops[i + 1].k == g.n and ops[i + 1].count == g.count == 1:
                chainable.append(True)
            for chain in chainable:
                for m in Mode:
                    if chain and m not in OS_MODES:
                        continue
                    ex = _mode_exec(sys, g, m, consumer_chains_k=chain)
                    # consuming a sharded input requires an IS (K-split) mode
                    if layout == "n_sharded" and m not in IS_MODES:
                        continue
                    out_l = ex.out_layout
                    t_new = t_acc + ex.time_s
                    cur = best[i + 1].get(out_l, (INF, None, None))
                    if t_new < cur[0]:
                        best[i + 1][out_l] = (t_new, (layout, m, chain), ex)
    # backtrack cheapest end state that is replicated (layer boundary)
    end = best[n].get("replicated") or min(best[n].values(), key=lambda v: v[0])
    # Reconstruct by re-walking (stores only one predecessor per state;
    # sufficient since we kept argmin transitions).
    schedule: List[OpExec] = []
    state = "replicated" if "replicated" in best[n] else list(best[n])[0]
    for i in range(n, 0, -1):
        t, pred, ex = best[i][state]
        schedule.append(ex)
        state = pred[0]
    schedule.reverse()
    del end
    return schedule


# ---------------------------------------------------------------------------
# Substrate-configuration fingerprints (live co-design loop)
# ---------------------------------------------------------------------------
def exec_config(execs: Sequence[OpExec]) -> tuple:
    """Hashable substrate-configuration fingerprint of a scheduled step:
    per operator, the partitioning mode and the logical array shape it
    ran on.  Two steps with equal fingerprints drive an identically
    configured substrate, which is what the serving tick memoizes on."""
    return tuple(
        (ex.mode,
         tuple(ex.core.logical_shape) if ex.core is not None else ())
        for ex in execs)


def shape_profile(execs: Sequence[OpExec]) -> tuple:
    """The distinct logical array shapes a scheduled step uses, sorted.
    A serving tick pays a substrate reconfiguration only when this
    profile changes between consecutive ticks — a fixed-shape array has a
    single legal shape, so its profile never changes."""
    return tuple(sorted({tuple(ex.core.logical_shape) for ex in execs
                         if ex.core is not None}))
