"""Decode-step operator extraction (paper §5b, Table 1).

A ``ModelSpec`` describes one transformer-family LLM at the granularity the
NMP scheduler cares about; ``decode_ops`` expands one decode step (one new
token for each of ``batch`` requests against ``ctx`` cached tokens) into the
list of GEMMs + vector stages that the multi-PU scheduler maps.

Conventions:
* fp16 everywhere (paper evaluates IEEE 754 FP16).
* GQA: attention score/value GEMMs are batched per (request, kv-head) with
  M = group size (Hq / Hkv) — grouping is what lifts decode attention's M.
* MLA (DeepSeek): decode uses the absorbed form — per request one
  M=Hq, K=(d_c + d_rope), N=ctx score GEMM and one M=Hq, K=ctx, N=d_c value
  GEMM against the compressed KV cache.
* MoE: uniform expert routing (paper follows Duplex); per-expert token count
  M_e = batch * topk / E, all E experts active when batch*topk >= E.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple

from repro_torch.core.gemm import Gemm, OpClass, ceil_div


@dataclass(frozen=True)
class MoESpec:
    num_experts: int
    topk: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0


@dataclass(frozen=True)
class MLASpec:
    d_compressed: int = 512
    d_rope: int = 64
    d_q_lora: int = 1536


@dataclass(frozen=True)
class ModelSpec:
    name: str
    num_layers: int
    d_model: int
    d_ff: int
    num_q_heads: int
    num_kv_heads: int
    vocab: int
    d_head: Optional[int] = None
    gated_ffn: bool = True
    moe: Optional[MoESpec] = None
    mla: Optional[MLASpec] = None

    def __post_init__(self):
        if self.d_head is None:
            object.__setattr__(self, "d_head",
                               self.d_model // self.num_q_heads)

    @property
    def group_size(self) -> int:
        return self.num_q_heads // self.num_kv_heads

    @property
    def is_moe(self) -> bool:
        return self.moe is not None

    # ---- parameter counts (for roofline / sanity) --------------------------
    def params(self) -> int:
        H, Dh = self.d_model, self.d_head
        attn = H * (self.num_q_heads * Dh) + 2 * H * (self.num_kv_heads * Dh) \
            + (self.num_q_heads * Dh) * H
        if self.mla is not None:
            c, r, ql = (self.mla.d_compressed, self.mla.d_rope,
                        self.mla.d_q_lora)
            attn = (H * (c + r) + H * ql + ql * self.num_q_heads * (Dh + r)
                    + c * self.num_q_heads * 2 * Dh
                    + self.num_q_heads * Dh * H)
        if self.is_moe:
            e = self.moe
            ffn_mults = 3 if self.gated_ffn else 2
            ffn = (e.num_experts * ffn_mults * H * e.d_ff_expert
                   + e.num_shared_experts * ffn_mults * H * e.d_ff_shared
                   + H * e.num_experts)
        else:
            ffn = (3 if self.gated_ffn else 2) * H * self.d_ff
        return self.num_layers * (attn + ffn) + 2 * self.vocab * H

    def active_params(self) -> int:
        """Per-token active parameters (MoE: only routed experts)."""
        if not self.is_moe:
            return self.params()
        e = self.moe
        H = self.d_model
        ffn_mults = 3 if self.gated_ffn else 2
        full = self.params()
        all_expert = self.num_layers * e.num_experts * ffn_mults * H * e.d_ff_expert
        active_expert = self.num_layers * e.topk * ffn_mults * H * e.d_ff_expert
        return full - all_expert + active_expert


# ---------------------------------------------------------------------------
# Operator extraction
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class LayerOps:
    """Ordered operator list for one decoder layer's decode step."""

    projections: Tuple[Gemm, ...]      # scheduled via the 4-mode framework
    attention: Tuple[Gemm, ...]        # head-parallel (QK, AV)
    experts: Tuple[Gemm, ...]          # MoE expert GEMMs (PU-distributed)
    moe_dispatch_bytes: int = 0        # all-to-all token traffic over NoC


def _attention_ops(spec: ModelSpec, batch: int, ctx: int) -> List[Gemm]:
    Dh = spec.d_head
    if spec.mla is not None:
        c, r = spec.mla.d_compressed, spec.mla.d_rope
        qk = Gemm("attn.qk", m=spec.num_q_heads, n=ctx, k=c + r, count=batch,
                  op_class=OpClass.ATTENTION_QK,
                  nonlinear_elems=spec.num_q_heads * ctx,
                  weight_reuse_across_count=False)
        av = Gemm("attn.av", m=spec.num_q_heads, n=c, k=ctx, count=batch,
                  op_class=OpClass.ATTENTION_AV,
                  weight_reuse_across_count=False)
        return [qk, av]
    g = spec.group_size
    qk = Gemm("attn.qk", m=g, n=ctx, k=Dh, count=batch * spec.num_kv_heads,
              op_class=OpClass.ATTENTION_QK, nonlinear_elems=g * ctx,
              weight_reuse_across_count=False)
    av = Gemm("attn.av", m=g, n=Dh, k=ctx, count=batch * spec.num_kv_heads,
              op_class=OpClass.ATTENTION_AV,
              weight_reuse_across_count=False)
    return [qk, av]


def _proj_ops(spec: ModelSpec, batch: int) -> List[Gemm]:
    H, Dh = spec.d_model, spec.d_head
    ops: List[Gemm] = []
    if spec.mla is not None:
        mla = spec.mla
        c, r, ql = mla.d_compressed, mla.d_rope, mla.d_q_lora
        ops.append(Gemm("proj.kv_down", m=batch, n=c + r, k=H))
        ops.append(Gemm("proj.q_down", m=batch, n=ql, k=H))
        ops.append(Gemm("proj.q_up", m=batch, n=spec.num_q_heads * (Dh + r),
                        k=ql))
        # absorbed W_UK fold: q_nope @ W_UK^T per head
        ops.append(Gemm("proj.q_absorb", m=batch, n=c, k=Dh,
                        count=spec.num_q_heads, weight_reuse_across_count=False))
        ops.append(Gemm("proj.o_up", m=batch, n=Dh, k=c,
                        count=spec.num_q_heads, weight_reuse_across_count=False))
        ops.append(Gemm("proj.o", m=batch, n=H, k=spec.num_q_heads * Dh))
    else:
        n_qkv = (spec.num_q_heads + 2 * spec.num_kv_heads) * Dh
        ops.append(Gemm("proj.qkv", m=batch, n=n_qkv, k=H,
                        nonlinear_elems=n_qkv * batch))  # rope+cache update
        ops.append(Gemm("proj.o", m=batch, n=H, k=spec.num_q_heads * Dh,
                        nonlinear_elems=batch * H))      # residual add
    return ops


def _ffn_ops(spec: ModelSpec, batch: int) -> Tuple[List[Gemm], List[Gemm], int]:
    """Returns (dense projections, expert gemms, dispatch bytes)."""
    H = spec.d_model
    if not spec.is_moe:
        ups = []
        if spec.gated_ffn:
            ups.append(Gemm("ffn.up_gate", m=batch, n=2 * spec.d_ff, k=H,
                            nonlinear_elems=batch * spec.d_ff))
        else:
            ups.append(Gemm("ffn.up", m=batch, n=spec.d_ff, k=H,
                            nonlinear_elems=batch * spec.d_ff))
        down = Gemm("ffn.down", m=batch, n=H, k=spec.d_ff,
                    nonlinear_elems=batch * H)
        return ups + [down], [], 0

    e = spec.moe
    ops: List[Gemm] = [Gemm("moe.router", m=batch, n=e.num_experts, k=H,
                            nonlinear_elems=batch * e.num_experts)]
    if e.num_shared_experts:
        fs = e.d_ff_shared * e.num_shared_experts
        if spec.gated_ffn:
            ops.append(Gemm("moe.shared.up_gate", m=batch, n=2 * fs, k=H,
                            nonlinear_elems=batch * fs))
        ops.append(Gemm("moe.shared.down", m=batch, n=H, k=fs))
    tokens = batch * e.topk
    active = min(e.num_experts, tokens)
    m_e = max(1, round(tokens / e.num_experts))
    experts: List[Gemm] = []
    if spec.gated_ffn:
        experts.append(Gemm("moe.exp.up_gate", m=m_e, n=2 * e.d_ff_expert,
                            k=H, count=active, op_class=OpClass.EXPERT_FFN,
                            nonlinear_elems=m_e * e.d_ff_expert,
                            weight_reuse_across_count=False))
    else:
        experts.append(Gemm("moe.exp.up", m=m_e, n=e.d_ff_expert, k=H,
                            count=active, op_class=OpClass.EXPERT_FFN,
                            weight_reuse_across_count=False))
    experts.append(Gemm("moe.exp.down", m=m_e, n=H, k=e.d_ff_expert,
                        count=active, op_class=OpClass.EXPERT_FFN,
                        nonlinear_elems=m_e * H,
                        weight_reuse_across_count=False))
    dispatch = 2 * tokens * H * 2  # to-expert + back, fp16
    return ops, experts, dispatch


def layer_ops(spec: ModelSpec, batch: int, ctx: int) -> LayerOps:
    proj = _proj_ops(spec, batch)
    attn = _attention_ops(spec, batch, ctx)
    ffn, experts, dispatch = _ffn_ops(spec, batch)
    return LayerOps(projections=tuple(proj + ffn), attention=tuple(attn),
                    experts=tuple(experts), moe_dispatch_bytes=dispatch)


# ---------------------------------------------------------------------------
# Multi-device tensor parallelism (paper §6.1.3: 8-device system, TP=8)
# ---------------------------------------------------------------------------
_COL_PARALLEL = ("qkv", "q_down", "kv_down", "q_up", "up_gate", "up",
                 "router")
_ROW_PARALLEL = ("o", "down")


def _tp_proj(g: Gemm, tp: int) -> Gemm:
    """Megatron-style split: column-parallel ops shard N, row-parallel shard
    K (paired so each layer needs only the attn-out + ffn-out all-reduces).
    Expert FFNs stay TP-sharded the same way (paper §6.1.3 retains TP for
    MoE layers); per-head ops (count>1, MLA absorb/up) divide the heads."""
    leaf = g.name.split(".")[-1]
    if g.count > 1 and g.op_class != OpClass.EXPERT_FFN:
        return g.scaled(count=max(1, ceil_div(g.count, tp)))
    if leaf in _ROW_PARALLEL:
        return g.split_k(tp)
    # default: shard the fat N dim; the local nonlinear epilogue shards too
    return replace(g, n=max(1, ceil_div(g.n, tp)),
                   nonlinear_elems=ceil_div(g.nonlinear_elems, tp))


def _tp_attn(g: Gemm, tp: int) -> Gemm:
    """Head-parallel: (request, kv-head) units divide across devices; MLA
    (count=batch, m=heads) splits the head M dim instead."""
    if g.count > 1 and g.count % tp == 0:
        return g.scaled(count=g.count // tp)
    return replace(g, m=max(1, ceil_div(g.m, tp)),
                   nonlinear_elems=ceil_div(g.nonlinear_elems, tp))


def layer_ops_tp(spec: ModelSpec, batch: int, ctx: int, tp: int) -> LayerOps:
    """Per-device operator list under tp-way tensor parallelism."""
    lo = layer_ops(spec, batch, ctx)
    if tp <= 1:
        return lo
    proj = tuple(_tp_proj(g, tp) for g in lo.projections)
    attn = tuple(_tp_attn(g, tp) for g in lo.attention)
    experts = tuple(_tp_proj(g, tp) for g in lo.experts)
    return LayerOps(projections=proj, attention=attn, experts=experts,
                    moe_dispatch_bytes=ceil_div(lo.moe_dispatch_bytes, tp))


def decode_ops(spec: ModelSpec, batch: int, ctx: int,
               include_head: bool = True) -> List[Gemm]:
    """Flat per-layer-weighted operator list for one decode step."""
    lo = layer_ops(spec, batch, ctx)
    per_layer = list(lo.projections) + list(lo.attention) + list(lo.experts)
    ops = [g.scaled(count=g.count * spec.num_layers) for g in per_layer]
    if include_head:
        ops.append(Gemm("lm_head", m=batch, n=spec.vocab, k=spec.d_model))
    return ops


# ---------------------------------------------------------------------------
# Paper Table 1 models
# ---------------------------------------------------------------------------
OPT_66B = ModelSpec("OPT-66B", num_layers=64, d_model=9216, d_ff=36864,
                    num_q_heads=72, num_kv_heads=72, vocab=50272,
                    gated_ffn=False)
LLAMA3_70B = ModelSpec("LLaMA3-70B", num_layers=80, d_model=8192, d_ff=28672,
                       num_q_heads=64, num_kv_heads=8, vocab=128256)
MIXTRAL_8X22B = ModelSpec("Mixtral-8x22B", num_layers=56, d_model=6144,
                          d_ff=16384, num_q_heads=48, num_kv_heads=8,
                          vocab=32768,
                          moe=MoESpec(num_experts=8, topk=2, d_ff_expert=16384))
QWEN3_30B_A3B = ModelSpec("Qwen3-30B-A3B", num_layers=48, d_model=2048,
                          d_ff=768, num_q_heads=32, num_kv_heads=4,
                          vocab=151936, d_head=128,
                          moe=MoESpec(num_experts=128, topk=8, d_ff_expert=768))
DEEPSEEK_236B = ModelSpec("DeepSeek-236B", num_layers=60, d_model=5120,
                          d_ff=12288, num_q_heads=128, num_kv_heads=128,
                          vocab=102400, d_head=128,
                          moe=MoESpec(num_experts=160, topk=8,
                                      d_ff_expert=1536,
                                      num_shared_experts=2, d_ff_shared=1536),
                          mla=MLASpec(d_compressed=512, d_rope=64,
                                      d_q_lora=1536))

PAPER_MODELS = {m.name: m for m in
                (OPT_66B, LLAMA3_70B, MIXTRAL_8X22B, QWEN3_30B_A3B,
                 DEEPSEEK_236B)}
