"""Single-core systolic / MAC-tree execution models (paper §3.1, Fig. 3-4).

The model is tile-level, SCALE-Sim-style: closed-form array cycles with
explicit pipeline fill/drain per spatial tile, plus a DRAM traffic model with
buffer-capacity-driven re-read multipliers, plus SRAM (boundary-injection)
traffic for the energy model.  Execution time on one core is

    t = max(array_cycles / f,  dram_bytes / bw_core) + first_fill_latency

i.e. double-buffered refill perfectly overlaps compute except for the first
tile; whichever of compute or memory supply is slower throttles the core
(this is exactly the decomposition shown in the paper's Fig. 1b).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.gemm import Dataflow, Gemm, ceil_div
from repro_torch.core.hw import (FP16_BYTES, BufferConfig, MacTreeConfig,
                                 SystolicArrayConfig)


@dataclass(frozen=True)
class CoreExec:
    """Execution report for one GEMM on one core."""

    array_cycles: int          # pure compute occupancy (incl. fill/drain)
    fill_drain_cycles: int     # portion of the above that is pipeline bubble
    dram_bytes: int            # DRAM traffic incl. capacity-induced re-reads
    sram_bytes: int            # SRAM <-> array boundary traffic
    spatial_tiles: int
    util: float                # MAC utilization of the occupied cycles
    dataflow: Dataflow
    logical_shape: tuple       # (rows, cols) used

    def compute_time(self, freq_hz: float) -> float:
        return self.array_cycles / freq_hz

    def memory_time(self, bw_bytes: float) -> float:
        return self.dram_bytes / bw_bytes

    def exec_time(self, freq_hz: float, bw_bytes: float,
                  first_fill_bytes: int = 0) -> float:
        t = max(self.compute_time(freq_hz), self.memory_time(bw_bytes))
        return t + first_fill_bytes / bw_bytes


# ---------------------------------------------------------------------------
# Systolic array
# ---------------------------------------------------------------------------
def sa_gemm(g: Gemm, rows: int, cols: int, dataflow: Dataflow,
            bufs: BufferConfig, pipelined: bool = False) -> CoreExec:
    """Model one GEMM replica on an R x C logical systolic array.

    OS: M->rows, N->cols spatial; K temporal (partials stay in PEs).
    IS: M->rows, K->cols spatial; N temporal (inputs stay in PEs); partial
        sums across K-tiles accumulate through the output buffer.

    ``pipelined`` (paper §4.2.4, SNAKE only): matmul instructions split into
    Weight Load / Feed / Drain sub-stages so consecutive tiles overlap fill
    with drain — only the first fill is exposed.  Conventional fixed-shape
    baselines expose the (rows + cols - 2)-cycle bubble on every tile.
    """
    m, n, k = g.m, g.n, g.k
    fill = rows + cols - 2

    if dataflow == Dataflow.OS:
        tm, tn = ceil_div(m, rows), ceil_div(n, cols)
        tiles = tm * tn
        fd = fill if pipelined else tiles * fill
        cycles = tiles * k + fd
        # --- DRAM traffic: choose the loop order that minimizes it.
        a_tile = rows * k * FP16_BYTES
        b_tile = k * cols * FP16_BYTES
        a_all = m * k * FP16_BYTES
        b_all = k * n * FP16_BYTES
        c_all = m * n * FP16_BYTES
        # n-inner: A_mt held if it fits the act buffer -> read once per m-row;
        # B re-read for every m-row (unless all of B fits the weight buffer).
        a_reads_ni = 1 if a_tile <= bufs.half("act") else tn
        b_reads_ni = 1 if b_all <= bufs.half("weight") else tm
        # m-inner: B_nt held if it fits weight buffer; A re-read per n-col.
        b_reads_mi = 1 if b_tile <= bufs.half("weight") else tm
        a_reads_mi = 1 if a_all <= bufs.half("act") else tn
        dram = min(a_all * a_reads_ni + b_all * b_reads_ni,
                   a_all * a_reads_mi + b_all * b_reads_mi) + c_all
        # --- SRAM boundary traffic: every tile injects its operands once and
        # drains its outputs once.
        sram = (tn * a_all) + (tm * b_all) + 2 * c_all
        util = (m * n * k) / (cycles * rows * cols) if cycles else 0.0
        return CoreExec(cycles, fd, dram, sram, tiles, util,
                        Dataflow.OS, (rows, cols))

    # ---- IS ----------------------------------------------------------------
    tm, tk = ceil_div(m, rows), ceil_div(k, cols)
    tiles = tm * tk
    fd = fill if pipelined else tiles * fill
    cycles = tiles * n + fd
    a_all = m * k * FP16_BYTES          # stationary: touched exactly once
    b_all = k * n * FP16_BYTES
    c_all = m * n * FP16_BYTES
    # B is streamed per (m,k) tile; each k-tile uses a disjoint row-block of B
    # so re-reads only happen across m-tiles.
    b_reads = 1 if (tm == 1 or b_all <= bufs.half("weight")) else tm
    # Partial sums: R x N accumulated across the Tk tiles of each m-row.
    out_rows_bytes = min(m, rows) * n * FP16_BYTES
    if tk > 1 and out_rows_bytes > bufs.half("out"):
        # Partials spill to DRAM: one extra write+read round per extra k-tile.
        partial_dram = 2 * (tk - 1) * out_rows_bytes * tm
    else:
        partial_dram = 0
    dram = a_all + b_all * b_reads + c_all + partial_dram
    sram = a_all + tm * b_all + 2 * c_all + 2 * (tk - 1) * out_rows_bytes * tm
    util = (m * n * k) / (cycles * rows * cols) if cycles else 0.0
    return CoreExec(cycles, fd, dram, sram, tiles, util,
                    Dataflow.IS, (rows, cols))


def best_logical_shape(sa: SystolicArrayConfig, m: int) -> tuple:
    """Pick the serpentine logical shape for an operator's M dimension.

    SNAKE picks the narrowest legal shape whose row count covers M (padded to
    the reconfiguration granularity of 8); M larger than the widest option
    folds over the physical rows (paper §4.2.2).
    """
    shapes = sorted(sa.logical_shapes())  # ascending rows
    for r, c in shapes:
        if m <= r:
            return (r, c)
    return shapes[-1]


def sa_gemm_best(g: Gemm, sa: SystolicArrayConfig, dataflow: Dataflow) -> CoreExec:
    rows, cols = best_logical_shape(sa, g.m)
    return sa_gemm(g, rows, cols, dataflow, sa.buffers, sa.pipelined_fills)


def sa_gemm_auto(g: Gemm, sa: SystolicArrayConfig) -> CoreExec:
    """Shape + dataflow auto-selection (cycle count as the first-order key).

    Matches the paper's first-order rule: IS preferred when N > K (N goes
    temporal), OS when K >= N — both fall out of minimizing tile folds.
    The final scheduler re-evaluates with memory stalls included.
    """
    rows, cols = best_logical_shape(sa, g.m)
    os_ = sa_gemm(g, rows, cols, Dataflow.OS, sa.buffers, sa.pipelined_fills)
    is_ = sa_gemm(g, rows, cols, Dataflow.IS, sa.buffers, sa.pipelined_fills)
    # Tie-break on spatial tiles: fewer, longer-running tiles amortize
    # data-loading/startup and reduce tile switching (§3.1) — this is what
    # makes IS preferable for N > K and OS for K >= N.
    return min((os_, is_), key=lambda e: (e.array_cycles, e.spatial_tiles,
                                          e.dram_bytes))


# ---------------------------------------------------------------------------
# MAC tree
# ---------------------------------------------------------------------------
def mactree_gemm(g: Gemm, mt: MacTreeConfig) -> CoreExec:
    """MAC-tree model: per cycle, one (m x n) output block advances k steps.

    Fully pipelined (no systolic fill/drain), but dimension padding to the
    (m,n,k) organization wastes lanes — the M dimension is the painful one
    for decode — and operand delivery is broadcast: (m*k + k*n) operand
    fetches per cycle for m*n*k MACs, which the energy model charges.
    """
    tm, tn, tk = (ceil_div(g.m, mt.m), ceil_div(g.n, mt.n), ceil_div(g.k, mt.k))
    cycles = tm * tn * tk
    a_all = g.m * g.k * FP16_BYTES
    b_all = g.k * g.n * FP16_BYTES
    c_all = g.m * g.n * FP16_BYTES
    # Same capacity logic as the SA, at tree-block granularity.
    b_block = mt.k * mt.n * tk * FP16_BYTES  # one n-column strip, full K
    a_reads = 1 if a_all <= mt.buffers.half("act") else tn
    b_reads = 1 if (tm == 1 or b_all <= mt.buffers.half("weight")) else tm
    del b_block
    dram = a_all * a_reads + b_all * b_reads + c_all
    # Broadcast operand fetches: every cycle (m*k + k*n) elements from SRAM.
    sram = cycles * mt.operand_elems_per_cycle * FP16_BYTES + 2 * c_all
    util = (g.m * g.n * g.k) / (cycles * mt.pes)
    return CoreExec(cycles, 0, dram, sram, tm * tn, util,
                    Dataflow.OS, (mt.m, mt.n))


def mean_utilization(cores) -> float:
    """Array-cycle-weighted mean MAC utilization over a step's per-core
    executions (the live co-design loop's per-tick occupancy signal).
    0.0 when nothing ran on an array."""
    total = sum(c.array_cycles for c in cores)
    if total == 0:
        return 0.0
    return sum(c.util * c.array_cycles for c in cores) / total
