"""Operator-aware partition planner (a copy of
``repro.distributed.planner``): the paper's §5 scheduling framework
mapped onto tensor parallelism.  The collective times price bytes at the
reference's ``TPU_V5E_ICI_BW``, a model input; the port's sharded steps
follow the same column -> row chains over ``torch.distributed``.

For each projection GEMM (M = tokens, K = in-features, N = out-features) and
a TP degree P, the two spatial modes translate to:

  IS-S  (split K)  -> row-parallel weight P("model", None):  each shard
        holds K/P rows, produces a full (M, N) partial sum, followed by an
        all-reduce (2*(P-1)/P * M*N*b bytes on ICI);
  OS-S  (split N)  -> column-parallel weight P(None, "model"): each shard
        produces an (M, N/P) output shard, followed by an all-gather where
        the full activation is next consumed ((P-1)/P * M*N*b bytes) — or NO
        collective when the consumer contracts exactly this dimension
        (column -> row chaining, the paper's OS-S -> IS-S layout chain).

The planner picks per-GEMM modes by the same cost model the NMP scheduler
uses: compute is identical across modes (M*N*K/P), so the decision reduces
to collective bytes + utilization corrections — with the paper's first-order
N-vs-K rule recovered when both collectives are exposed.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Literal, Optional, Sequence, Tuple

from repro_torch.core.hw import TPU_V5E_ICI_BW

Mode = Literal["column", "row", "replicate"]


@dataclass(frozen=True)
class GemmPlan:
    name: str
    m: int
    n: int
    k: int
    mode: Mode
    comm_bytes: int        # exposed collective payload per step
    chained: bool = False  # column output consumed directly by a row consumer
    note: str = ""

    @property
    def comm_time_s(self) -> float:
        return self.comm_bytes / TPU_V5E_ICI_BW


def _ar_bytes(m: int, n: int, p: int, b: int = 2) -> int:
    return int(2 * (p - 1) / p * m * n * b)


def _ag_bytes(m: int, n: int, p: int, b: int = 2) -> int:
    return int((p - 1) / p * m * n * b)


def plan_projection(name: str, m: int, n: int, k: int, p: int,
                    consumer_contracts_n: bool = False,
                    divisible_n: bool = True,
                    divisible_k: bool = True) -> GemmPlan:
    """Pick column (OS-S) vs row (IS-S) for one weight (K, N)."""
    cands: List[GemmPlan] = []
    if divisible_n:
        if consumer_contracts_n:
            cands.append(GemmPlan(name, m, n, k, "column", 0, chained=True,
                                  note="OS-S -> IS-S chain, gather skipped"))
        else:
            cands.append(GemmPlan(name, m, n, k, "column",
                                  _ag_bytes(m, n, p), note="all-gather"))
    if divisible_k:
        cands.append(GemmPlan(name, m, n, k, "row", _ar_bytes(m, n, p),
                              note="all-reduce of partials"))
    if not cands:
        return GemmPlan(name, m, n, k, "replicate", 0,
                        note="no divisible axis; replicated")
    return min(cands, key=lambda c: c.comm_bytes)


def plan_ffn(name: str, m: int, d_model: int, d_ff: int, p: int
             ) -> Tuple[GemmPlan, GemmPlan]:
    """The canonical pair: up/gate column-parallel chained into down
    row-parallel — one all-reduce for the whole FFN (Megatron = the paper's
    OS-S -> IS-S chain)."""
    up = plan_projection(f"{name}.up", m, d_ff, d_model, p,
                         consumer_contracts_n=True)
    down = plan_projection(f"{name}.down", m, d_model, d_ff, p,
                           divisible_n=False)
    return up, down


def plan_decode_attention(batch: int, ctx: int, heads: int, d_head: int,
                          p: int) -> GemmPlan:
    """Sequence-sharding the KV cache = IS-S on the AV operator (K = ctx):
    each shard computes partial attention over ctx/P cached tokens, combined
    with a log-sum-exp all-reduce of (B, Hq, D) + stats — tiny vs moving the
    cache."""
    payload = _ar_bytes(batch, heads * (d_head + 2), p, 4)
    return GemmPlan("attn.decode", batch * heads, d_head, ctx, "row",
                    payload, note="seq-sharded cache + lse-combine psum")


def describe(plans: Sequence[GemmPlan]) -> str:
    lines = ["name            mode     M       N       K      comm_bytes"]
    for pl in plans:
        lines.append(f"{pl.name:15s} {pl.mode:8s} {pl.m:<7d} {pl.n:<7d} "
                     f"{pl.k:<7d}{pl.comm_bytes:>10d}  {pl.note}")
    return "\n".join(lines)
