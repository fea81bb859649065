"""End-to-end decode-step latency/energy for one model on one NMP device.

Builds the per-layer operator graph (projections -> attention -> FFN/MoE),
schedules every operator with the §5 framework, and aggregates time + energy
for one decode iteration (all `batch` requests advance one token).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.core.energy import EnergyReport
from repro_torch.core.gemm import FP16_BYTES, Gemm
from repro_torch.core.hw import NMPSystem
from repro_torch.core.operators import ModelSpec, layer_ops, layer_ops_tp
from repro_torch.core.schedule import (Mode, OpExec, ceil_div, core_exec,
                                       exec_units, schedule_attention,
                                       schedule_chain, schedule_experts,
                                       schedule_projection, unit_bw, _vector_time,
                                       _vector_ops)
from repro_torch.core import schedule as _sched
from repro_torch.core.gemm import Dataflow
from repro_torch.core.energy import gemm_energy


# Fraction of the cross-device all-reduce left exposed after tile-level
# overlap with neighbouring operators (paper Fig. 9 pipelines collectives
# against expert/linear tiles; the first and last tile chunks stay exposed).
XLINK_EXPOSED = 0.25


@dataclass
class DecodeReport:
    model: str
    system: str
    batch: int
    ctx: int
    time_s: float
    energy: EnergyReport
    op_execs: List[OpExec] = field(default_factory=list)

    @property
    def tokens_per_s(self) -> float:
        return self.batch / self.time_s

    @property
    def logic_energy_per_token_j(self) -> float:
        return self.energy.logic_die_j / self.batch

    def mode_histogram(self) -> Dict[str, int]:
        hist: Dict[str, int] = {}
        for ex in self.op_execs:
            hist[ex.mode] = hist.get(ex.mode, 0) + 1
        return hist


def _schedule_batched_small(sys: NMPSystem, g: Gemm,
                            force_df=None) -> OpExec:
    """count>1 projection-like ops (e.g. MLA per-head absorbs): round-robin
    the replicas over compute units (multi-port slice-packed on SNAKE),
    no cross-PU split."""
    n_units = exec_units(sys)
    bw = unit_bw(sys)
    g1 = g.scaled(count=1)
    cands = (force_df,) if force_df else (Dataflow.IS, Dataflow.OS)
    best = None
    for df in cands:
        ex_c, pk = _sched.slice_pack_exec(sys, g1, df, g.count)
        t_c = (ceil_div(g.count, n_units * pk)
               * max(ex_c.compute_time(sys.freq_hz),
                     ex_c.memory_time(bw / pk)))
        if best is None or t_c < best[0]:
            best = (t_c, ex_c, pk)
    _, ex, pack = best
    waves = ceil_div(g.count, n_units * pack)
    t_unit = max(ex.compute_time(sys.freq_hz), ex.memory_time(bw / pack))
    vec_s = _vector_time(sys, g.nonlinear_elems * g.count)
    time_s = waves * t_unit + vec_s * 0.4
    energy = gemm_energy(sys, macs=g.macs,
                         sram_bytes=ex.sram_bytes * g.count,
                         dram_bytes=ex.dram_bytes * g.count,
                         exec_time_s=time_s,
                         vector_ops=_vector_ops(g.nonlinear_elems * g.count))
    return OpExec(op=g, mode="BATCH-RR", time_s=time_s,
                  compute_s=waves * ex.compute_time(sys.freq_hz),
                  memory_s=waves * ex.memory_time(bw), comm_s=0.0,
                  vector_s=vec_s * 0.4, energy=energy, core=ex)


def decode_step(sys: NMPSystem, spec: ModelSpec, batch: int, ctx: int,
                include_head: bool = True,
                fixed_mode: Optional[Mode] = None,
                tp: int = 1) -> DecodeReport:
    """Latency/energy of one decode iteration on a ``tp``-device NMP system.

    ``tp`` > 1 models the paper's §6.1.3 8-device tensor-parallel setup:
    every operator is Megatron-sharded across devices (attention by heads)
    and each layer pays two cross-device all-reduces of the (B, d_model)
    activation over the host-side links (Duplex/NVLink-class).  Reported
    time is per-system; energy is the per-device logic-die energy times tp.
    ``fixed_mode`` forces a single partitioning mode for every projection
    (paper Fig. 13b's fixed-strategy comparison); default searches per-op.
    """
    lo = layer_ops_tp(spec, batch, ctx, tp)
    execs: List[OpExec] = []

    # projections: chained per-op search (or fixed mode)
    chain_ops = [g for g in lo.projections if g.count == 1]
    small_ops = [g for g in lo.projections if g.count > 1]
    force_df = None
    if fixed_mode is not None:
        force_df = (Dataflow.IS if fixed_mode in _sched.IS_MODES
                    else Dataflow.OS)
    if fixed_mode is None:
        execs.extend(schedule_chain(sys, chain_ops))
    else:
        execs.extend(schedule_projection(sys, g, modes=(fixed_mode,))
                     for g in chain_ops)
    execs.extend(_schedule_batched_small(sys, g, force_df)
                 for g in small_ops)

    # attention (QK, AV pairs) — always head-parallel (§5b)
    attn = list(lo.attention)
    for i in range(0, len(attn), 2):
        execs.append(schedule_attention(sys, attn[i], attn[i + 1]))

    # MoE experts: the fixed-mode study forces their dataflow too
    if lo.experts:
        execs.append(schedule_experts(sys, list(lo.experts),
                                      lo.moe_dispatch_bytes,
                                      force_df=force_df))

    layer_time = sum(e.time_s for e in execs)
    layer_energy = sum((e.energy for e in execs), EnergyReport())

    # Cross-device TP all-reduces (attn-out + ffn-out per layer), ring over
    # the host-side links.  Off-die: charged to time, not logic-die energy.
    # The ST schedules stream output tiles into the collective as they
    # drain (Fig. 9), hiding most of it behind the next operator's tiles;
    # only XLINK_EXPOSED of the wire time + latency stays on the critical
    # path (identical treatment for every substrate under comparison).
    if tp > 1:
        ar_bytes = batch * spec.d_model * FP16_BYTES
        t_ar = 2 * (2 * (tp - 1) / tp * ar_bytes / sys.xlink_bw_bytes
                    + sys.xlink_latency_s)
        layer_time += XLINK_EXPOSED * t_ar

    total_time = layer_time * spec.num_layers
    total_energy = EnergyReport(*[getattr(layer_energy, f) * spec.num_layers
                                  for f in ("mac_j", "sram_j", "dram_j",
                                            "noc_j", "vector_j", "ctrl_j")])
    if include_head:
        head = Gemm("lm_head", m=batch, n=ceil_div(spec.vocab, tp),
                    k=spec.d_model)
        hex_ = (schedule_projection(sys, head) if fixed_mode is None
                else schedule_projection(sys, head, modes=(fixed_mode,)))
        execs.append(hex_)
        total_time += hex_.time_s
        if tp > 1:   # all-gather of the vocab-sharded logits
            total_time += ((tp - 1) / tp * batch * spec.vocab * FP16_BYTES
                           / sys.xlink_bw_bytes + sys.xlink_latency_s)
        total_energy = total_energy + hex_.energy

    if tp > 1:       # system energy = per-device logic+stack energy x tp
        total_energy = EnergyReport(*[getattr(total_energy, f) * tp
                                      for f in ("mac_j", "sram_j", "dram_j",
                                                "noc_j", "vector_j",
                                                "ctrl_j")])

    return DecodeReport(model=spec.name, system=sys.name, batch=batch,
                        ctx=ctx, time_s=total_time, energy=total_energy,
                        op_execs=execs)


def decode_sweep(sys: NMPSystem, spec: ModelSpec,
                 batches: Sequence[int], ctx: int,
                 tp: int = 1) -> List[DecodeReport]:
    return [decode_step(sys, spec, b, ctx, tp=tp) for b in batches]
