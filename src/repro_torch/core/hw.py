"""Hardware configurations for the 3D-stacked NMP substrate study.

Everything here is calibrated to the paper's §6.1/§6.2 setup:

* Stratum-class HBM3 system template: 16 processing units (PUs) on one logic
  die, each PU bound to one memory channel; effective internal DRAM bandwidth
  fixed at 24 TB/s (midpoint of Stratum's reported range); lightweight NoC for
  coarse-grained collectives only.
* Per-PU logic area budget 2.35 mm^2.  Under that budget the paper's RTL
  calibration fits:
    - MAC-tree baseline:      16x16x16  =  4,096 MACs / PU @ 1.0 GHz
    - conventional SA + VC:   4 x 48x48 =  9,216 MACs / PU @ 1.0 GHz
      (also instantiated as 4 x 8x288 with the same MAC count)
    - SNAKE (this work):      4 x 64x64 = 16,384 MACs / PU @ 0.8 GHz
  giving the paper's 2.25x / 4.00x compute-area-efficiency ratios.
* Logic-die power envelope 62 W (85C cap): 38.5 W matrix, 14.2 W vector,
  4.4 W PE control, 4.8 W NoC at peak -> used to calibrate energy constants.

This is the port's copy of the reference's ``core/hw.py``.  The TPU v5e
constants at the bottom are the reference's model inputs, copied as they
are: the partition planner (``repro_torch.distributed.planner``) prices
its collectives with ``TPU_V5E_ICI_BW``.  They describe no card the port
runs on, and no measurement of the port is stated against them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Sequence, Tuple

FP16_BYTES = 2


# ---------------------------------------------------------------------------
# Buffers
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class BufferConfig:
    """Per-core SRAM buffer capacities in bytes.

    ``weight`` is the boundary buffer feeding the stationary-side operand
    (paper: left/right boundary buffers, largest allocation).  ``act`` is the
    streaming-side (input under OS / output-activation under IS) buffer and
    ``out`` the banked 2R/2W output buffer shared with the vector core.
    All buffers are double-buffered: half the capacity stages the live tile,
    half prefetches the next one.
    """

    weight: int
    act: int
    out: int

    @property
    def total(self) -> int:
        return self.weight + self.act + self.out

    def half(self, which: str) -> int:
        """Usable single-buffer capacity (double buffering halves it)."""
        return getattr(self, which) // 2


# ---------------------------------------------------------------------------
# Compute substrates
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SystolicArrayConfig:
    """A fixed-shape or reconfigurable systolic array core."""

    name: str
    phys_rows: int
    phys_cols: int
    freq_ghz: float
    buffers: BufferConfig
    # Reconfigurability: legal logical row counts (serpentine remap).  A fixed
    # array has exactly one entry equal to phys_rows.
    logical_row_options: Tuple[int, ...] = ()
    reconfig_granularity: int = 8
    # Pipeline fill/drain is (rows + cols - 2) cycles per spatial tile chain.
    # Mode switch (paper 4.2.1) costs one cycle -> negligible, kept for audit.
    reconfig_cycles: int = 1
    # §4.2.4: SNAKE's decoder splits each matmul into pipelined sub-stages
    # (Weight Load / Feed First/Second / Drain) so consecutive tiles overlap
    # their fill with the previous tile's drain — only the first fill is
    # exposed.  Conventional fixed-shape SA baselines expose fill per tile.
    pipelined_fills: bool = False
    # §4.2.3: the unified systolic-vector substrate (shared 2R/2W output
    # buffer) lets vector post-processing overlap GEMM tiles; baselines with
    # a private vector core get no tile-level overlap.
    unified_vector: bool = False

    def __post_init__(self):
        if not self.logical_row_options:
            object.__setattr__(self, "logical_row_options", (self.phys_rows,))
        for r in self.logical_row_options:
            assert self.pes % r == 0, f"rows {r} must divide PE count"

    @property
    def pes(self) -> int:
        return self.phys_rows * self.phys_cols

    def logical_shapes(self) -> Tuple[Tuple[int, int], ...]:
        return tuple((r, self.pes // r) for r in self.logical_row_options)

    @property
    def reconfigurable(self) -> bool:
        return len(self.logical_row_options) > 1


@dataclass(frozen=True)
class MacTreeConfig:
    """MAC-tree compute unit (Stratum-style baseline).

    Organized as an (m x n x k) block of multipliers feeding adder trees:
    every cycle it can retire an m x n output block of depth-k partial
    reductions.  No systolic fill/drain, but operand delivery is broadcast
    (high fan-out) so per-MAC SRAM traffic is higher (`operand_fetch_ratio`
    relative to a systolic array's boundary injection).
    """

    name: str
    m: int
    n: int
    k: int
    freq_ghz: float
    buffers: BufferConfig
    # SRAM elements fetched per MAC: tree fetches m*k + k*n operands per cycle
    # for m*n*k MACs; SA injects rows+cols per cycle for rows*cols MACs.
    @property
    def pes(self) -> int:
        return self.m * self.n * self.k

    @property
    def operand_elems_per_cycle(self) -> int:
        return self.m * self.k + self.k * self.n


@dataclass(frozen=True)
class VectorCoreConfig:
    lanes: int = 512            # elementwise ops / cycle / core
    special_func_factor: float = 4.0   # exp/div etc. cost this many lane-ops


# ---------------------------------------------------------------------------
# System template (Stratum-class)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class NMPSystem:
    """One 3D-stacked NMP device: a logic die under a DRAM stack."""

    name: str
    substrate: object                  # SystolicArrayConfig | MacTreeConfig
    pus: int = 16
    cores_per_pu: int = 4
    dram_bw_bytes: float = 24e12       # effective internal bandwidth, total
    dram_bw_efficiency: float = 0.90   # bank-bundle scheduling efficiency
    noc_link_bw_bytes: float = 512e9   # per-PU NoC injection bandwidth
    noc_latency_cycles: int = 64       # per-hop/segment latency
    # Cross-device interconnect for multi-device tensor parallelism (the
    # paper's §6.1.3 8-device TP=8 system rides the Duplex host links; we
    # keep the Duplex/NVLink-class numbers).
    xlink_bw_bytes: float = 450e9      # per device, per direction
    xlink_latency_s: float = 4e-6      # per collective
    vector: VectorCoreConfig = field(default_factory=VectorCoreConfig)
    # Energy constants (pJ), calibrated against the paper's 61.8 W breakdown.
    e_mac_pj: float = 0.184            # per MAC (2 FLOPs), fp16, 7 nm
    e_sram_pj_per_byte: float = 0.08
    e_dram_pj_per_byte: float = 2.0    # 3D TSV/hybrid-bond stack access
    e_noc_pj_per_byte: float = 0.10
    e_vector_pj_per_op: float = 0.55   # calibrated: 14.2 W vector at peak
    ctrl_power_w: float = 4.4          # PE control, always-on while active
    noc_idle_power_w: float = 1.0
    mactree_fetch_energy_scale: float = 1.0

    # ---- derived -----------------------------------------------------------
    @property
    def cores(self) -> int:
        return self.pus * self.cores_per_pu

    @property
    def macs_per_pu(self) -> int:
        if isinstance(self.substrate, SystolicArrayConfig):
            return self.cores_per_pu * self.substrate.pes
        return self.substrate.pes  # MAC tree configured at PU granularity

    @property
    def freq_hz(self) -> float:
        return self.substrate.freq_ghz * 1e9

    @property
    def peak_flops(self) -> float:
        return self.pus * self.macs_per_pu * 2 * self.freq_hz

    @property
    def ridge_point(self) -> float:
        """FLOP/byte at which compute and memory times balance."""
        return self.peak_flops / self.effective_dram_bw

    @property
    def effective_dram_bw(self) -> float:
        return self.dram_bw_bytes * self.dram_bw_efficiency

    @property
    def dram_bw_per_pu(self) -> float:
        return self.effective_dram_bw / self.pus

    @property
    def dram_bw_per_core(self) -> float:
        if isinstance(self.substrate, SystolicArrayConfig):
            return self.dram_bw_per_pu / self.cores_per_pu
        return self.dram_bw_per_pu


# ---------------------------------------------------------------------------
# Concrete instances (paper §6.1.2 / §6.2)
# ---------------------------------------------------------------------------
def snake_system(**over) -> NMPSystem:
    """SNAKE: reconfigurable 64x64 serpentine array, 4/PU, 16 PUs, 0.8 GHz."""
    sa = SystolicArrayConfig(
        name="snake-64x64",
        phys_rows=64,
        phys_cols=64,
        freq_ghz=0.8,
        # Post-reallocation buffers (paper Fig. 11: buffering area shrinks
        # from 53.6% -> 28.1% of the PU; reclaimed area went to PEs).
        buffers=BufferConfig(weight=256 * 1024, act=64 * 1024, out=128 * 1024),
        logical_row_options=(8, 16, 32, 64),
        pipelined_fills=True,
        unified_vector=True,
    )
    return NMPSystem(name="SNAKE", substrate=sa, **over)


def fixed_sa_system(rows: int, cols: int, **over) -> NMPSystem:
    """Conventional fixed-shape SA + private vector core baseline @1 GHz."""
    sa = SystolicArrayConfig(
        name=f"sa-{rows}x{cols}",
        phys_rows=rows,
        phys_cols=cols,
        freq_ghz=1.0,
        # Conventional allocation: large double buffers (53.6% of PU area).
        buffers=BufferConfig(weight=512 * 1024, act=128 * 1024, out=256 * 1024),
        logical_row_options=(rows,),
    )
    return NMPSystem(name=f"SA-{rows}x{cols}", substrate=sa, **over)


def mactree_system(**over) -> NMPSystem:
    """Stratum-configured MAC-tree baseline: 16x16x16 per PU @ 1 GHz.

    Energy: the paper's RTL calibration found the MAC tree needs 8.23x the
    area of a SA at equal PE-level function; switched capacitance tracks
    area, and the broadcast/reduction networks burn additional wire energy —
    charged via a higher per-MAC energy and an SRAM fetch-energy scale.
    """
    mt = MacTreeConfig(
        name="mactree-16x16x16",
        m=16,
        n=16,
        k=16,
        freq_ghz=1.0,
        buffers=BufferConfig(weight=512 * 1024, act=128 * 1024, out=256 * 1024),
    )
    over.setdefault("e_mac_pj", 0.46)
    over.setdefault("mactree_fetch_energy_scale", 2.5)
    return NMPSystem(name="MAC-Tree", substrate=mt, **over)


@dataclass(frozen=True)
class GPUConfig:
    """H100-class decode baseline (per device)."""

    name: str = "H100"
    peak_flops: float = 989e12          # bf16/fp16 dense
    hbm_bw_bytes: float = 3.35e12
    # Decode-serving achieved efficiencies: unfused GEMV/attention kernels on
    # H100 sustain ~45-55% of HBM peak and well under half of tensor-core
    # peak at small M (vLLM/TensorRT-LLM decode profiles).
    mem_efficiency: float = 0.50        # achieved fraction on decode GEMV/GEMM
    compute_efficiency: float = 0.40    # achieved fraction of peak on decode
    nvlink_bw_bytes: float = 450e9      # per direction, per GPU
    # device memory per card (H100 SXM5 80GB): a class constant (no
    # annotation), kept out of the dataclass fields the reference's model
    # compares
    hbm_gb = 80.0
    kernel_overhead_s: float = 5e-6     # launch+sync per fused op group
    power_w: float = 550.0              # sustained decode board power
    tdp_w: float = 700.0
    # Per-op silicon/DRAM energy accounting (comparable to the NMP model's
    # logic-die + stack accounting rather than wall-plug board power):
    e_flop_pj: float = 0.5              # tensor-core + datapath, 4N-class
    e_hbm_pj_per_byte: float = 5.5      # off-chip HBM3 access
    static_w: float = 18.0              # leakage share attributed to decode


H100 = GPUConfig()

# TPU v5e constants: the reference's inputs to its partition planner and
# TPU roofline (not this port's hardware).
TPU_V5E_PEAK_FLOPS = 197e12     # bf16
TPU_V5E_HBM_BW = 819e9          # bytes/s
TPU_V5E_ICI_BW = 50e9           # bytes/s per link
TPU_V5E_HBM_GB = 16.0


def area_model() -> dict:
    """Paper Fig. 11 PU-level compute-area-efficiency calibration.

    All three designs fit the same 2.35 mm^2 PU budget; compute-area
    efficiency is MACs per budget, normalized to the MAC tree.
    """
    budget_mm2 = 2.35
    rows = {
        "MAC-Tree": dict(macs=4096, freq_ghz=1.0,
                         breakdown=dict(compute=0.285, buffers=0.49,
                                        vector=0.16, control=0.065)),
        "SA+VectorCore": dict(macs=9216, freq_ghz=1.0,
                              breakdown=dict(compute=0.30, buffers=0.536,
                                             vector=0.11, control=0.054)),
        "SNAKE": dict(macs=16384, freq_ghz=0.8,
                      breakdown=dict(compute=0.543, buffers=0.281,
                                     vector=0.088, control=0.088)),
    }
    base = rows["MAC-Tree"]["macs"]
    out = {}
    for name, r in rows.items():
        out[name] = dict(
            budget_mm2=budget_mm2,
            macs=r["macs"],
            freq_ghz=r["freq_ghz"],
            breakdown=r["breakdown"],
            compute_area_efficiency=r["macs"] / base,
        )
    return out
