"""Energy model for the logic die + DRAM stack (paper §6.2-6.3).

Calibrated so that SNAKE at peak matches the paper's reported logic-die power
breakdown (61.8 W = 38.5 matrix + 14.2 vector + 4.4 PE control + 4.8 NoC at
800 MHz).  Energy ratios between substrates come from (a) execution time
(control/static energy integrates over it), (b) SRAM traffic (MAC trees
broadcast operands; SAs inject at boundaries and reuse in-fabric), and
(c) DRAM traffic (capacity-induced re-reads).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.hw import NMPSystem


@dataclass
class EnergyReport:
    mac_j: float = 0.0
    sram_j: float = 0.0
    dram_j: float = 0.0
    noc_j: float = 0.0
    vector_j: float = 0.0
    ctrl_j: float = 0.0

    @property
    def total_j(self) -> float:
        return (self.mac_j + self.sram_j + self.dram_j + self.noc_j
                + self.vector_j + self.ctrl_j)

    @property
    def logic_die_j(self) -> float:
        """Paper compares logic-die energy (thermal-limited component)."""
        return self.total_j - self.dram_j

    def __add__(self, o: "EnergyReport") -> "EnergyReport":
        return EnergyReport(self.mac_j + o.mac_j, self.sram_j + o.sram_j,
                            self.dram_j + o.dram_j, self.noc_j + o.noc_j,
                            self.vector_j + o.vector_j, self.ctrl_j + o.ctrl_j)


def gemm_energy(sys: NMPSystem, macs: int, sram_bytes: int, dram_bytes: int,
                exec_time_s: float, noc_bytes: int = 0,
                vector_ops: int = 0) -> EnergyReport:
    scale = getattr(sys, "mactree_fetch_energy_scale", 1.0)
    return EnergyReport(
        mac_j=macs * sys.e_mac_pj * 1e-12,
        sram_j=sram_bytes * sys.e_sram_pj_per_byte * scale * 1e-12,
        dram_j=dram_bytes * sys.e_dram_pj_per_byte * 1e-12,
        noc_j=(noc_bytes * sys.e_noc_pj_per_byte * 1e-12
               + sys.noc_idle_power_w * exec_time_s),
        vector_j=vector_ops * sys.e_vector_pj_per_op * 1e-12,
        ctrl_j=sys.ctrl_power_w * exec_time_s,
    )


def peak_power_breakdown(sys: NMPSystem) -> dict:
    """Sanity: power at 100% MAC + vector occupancy (compare paper's 61.8 W)."""
    macs_per_s = sys.pus * sys.macs_per_pu * sys.freq_hz
    vec_per_s = sys.pus * sys.cores_per_pu * sys.vector.lanes * sys.freq_hz
    # Boundary SRAM traffic at peak: every core injects (rows+cols) elems/cyc.
    sub = sys.substrate
    if hasattr(sub, "phys_rows"):
        elems = (sub.phys_rows + sub.phys_cols)
        sram_bps = sys.cores * elems * 2 * sys.freq_hz
    else:
        sram_bps = sys.pus * sub.operand_elems_per_cycle * 2 * sys.freq_hz
    return dict(
        matrix_w=macs_per_s * sys.e_mac_pj * 1e-12,
        vector_w=vec_per_s * sys.e_vector_pj_per_op * 1e-12,
        sram_w=sram_bps * sys.e_sram_pj_per_byte * 1e-12,
        ctrl_w=sys.ctrl_power_w,
        noc_w=sys.noc_idle_power_w + 3.8,  # active collective allowance
    )
