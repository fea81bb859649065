"""H100 decode baseline (paper §6.1.3: Duplex-framework GPU model).

Roofline-style per-operator model with achieved-efficiency factors for the
decode regime (small-M GEMM/GEMV leaves both the tensor cores and HBM well
below peak), kernel launch overhead, and TP=8 NVLink all-reduces per layer.
Energy is board power integrated over time (the paper compares its logic-die
energy against GPU energy the same way).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

from repro_torch.core.gemm import Gemm
from repro_torch.core.hw import GPUConfig, H100
from repro_torch.core.operators import ModelSpec, layer_ops


@dataclass
class GPUDecodeReport:
    model: str
    batch: int
    ctx: int
    time_s: float
    energy_j: float          # per-op silicon + HBM + static (see GPUConfig)
    board_energy_j: float    # wall-plug board power integrated over time
    tp: int

    @property
    def tokens_per_s(self) -> float:
        return self.batch / self.time_s

    @property
    def energy_per_token_j(self) -> float:
        return self.energy_j / self.batch


def _op_time(gpu: GPUConfig, g: Gemm, tp: int) -> float:
    """One operator, weights/work sharded over `tp` GPUs."""
    flops = g.flops / tp
    bytes_ = g.min_dram_bytes / tp
    t = max(flops / (gpu.peak_flops * gpu.compute_efficiency),
            bytes_ / (gpu.hbm_bw_bytes * gpu.mem_efficiency))
    return t


def gpu_decode_step(spec: ModelSpec, batch: int, ctx: int,
                    gpu: GPUConfig = H100, tp: int = 8) -> GPUDecodeReport:
    lo = layer_ops(spec, batch, ctx)
    t_layer = 0.0
    flops = bytes_ = 0.0
    groups = 0
    for g in list(lo.projections) + list(lo.attention) + list(lo.experts):
        t_layer += _op_time(gpu, g, tp)
        flops += g.flops
        bytes_ += g.min_dram_bytes
        groups += 1
    # fused-kernel accounting: ~1 launch per op group
    t_layer += groups * gpu.kernel_overhead_s
    t_ar = 0.0
    if tp > 1:
        # TP: two all-reduces per layer (attention out + FFN out) of the
        # activation tensor, ring over NVLink.
        ar_bytes = batch * spec.d_model * 2
        t_ar = (2 * (2 * (tp - 1) / tp) * ar_bytes / gpu.nvlink_bw_bytes
                + 2 * 4e-6)
    t_layer += t_ar
    total = t_layer * spec.num_layers
    head = Gemm("lm_head", m=batch, n=spec.vocab, k=spec.d_model)
    total += _op_time(gpu, head, tp) + gpu.kernel_overhead_s
    flops = (flops * spec.num_layers + head.flops)
    bytes_ = (bytes_ * spec.num_layers + head.min_dram_bytes)
    energy = (flops * gpu.e_flop_pj * 1e-12
              + bytes_ * gpu.e_hbm_pj_per_byte * 1e-12
              + gpu.static_w * total)
    return GPUDecodeReport(model=spec.name, batch=batch, ctx=ctx,
                           time_s=total, energy_j=energy,
                           board_energy_j=gpu.power_w * max(1, tp) * total,
                           tp=tp)
