"""GEMM abstraction for LLM decode operators (paper §3.1, Fig. 3).

Every linear operator is abstracted as ``A[M,K] @ B[K,N] -> C[M,N]`` in fp16.
Decode operators satisfy ``M << N, K`` (M tracks the effective batch and
attention grouping), which is exactly the regime that motivates SNAKE's
shape/dataflow reconfigurability.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from enum import Enum
from typing import Optional

from repro_torch.core.hw import FP16_BYTES


class OpClass(Enum):
    PROJECTION = "projection"      # QKV / O / FFN / router / head GEMMs
    ATTENTION_QK = "attention_qk"  # per (request, kv-group) score GEMM
    ATTENTION_AV = "attention_av"  # per (request, kv-group) value GEMM
    EXPERT_FFN = "expert_ffn"      # per-expert MoE GEMM


class Dataflow(Enum):
    OS = "OS"   # output-stationary: M,N spatial; K temporal
    IS = "IS"   # input-stationary:  M,K spatial; N temporal


@dataclass(frozen=True)
class Gemm:
    """One decode GEMM (possibly replicated ``count`` times, e.g. heads)."""

    name: str
    m: int
    n: int
    k: int
    count: int = 1
    op_class: OpClass = OpClass.PROJECTION
    # Element count of the nonlinear/vector stage consuming this GEMM's
    # output (softmax, SiLU*mul, norm...).  Used by the overlap model.
    nonlinear_elems: int = 0
    # Whether B (weights / K,V) must be (re)streamed from DRAM.  Attention
    # reads the KV cache (always DRAM); projections read weights (DRAM, but
    # shared across the `count` replicas).
    weight_reuse_across_count: bool = True

    def __post_init__(self):
        assert self.m >= 1 and self.n >= 1 and self.k >= 1 and self.count >= 1

    # ---- closed-form quantities --------------------------------------------
    @property
    def macs(self) -> int:
        return self.m * self.n * self.k * self.count

    @property
    def flops(self) -> int:
        return 2 * self.macs

    @property
    def a_bytes(self) -> int:
        return self.m * self.k * FP16_BYTES * self.count

    @property
    def b_bytes_once(self) -> int:
        """Bytes of B read once (weights shared across count if reusable)."""
        per = self.k * self.n * FP16_BYTES
        return per if self.weight_reuse_across_count else per * self.count

    @property
    def c_bytes(self) -> int:
        return self.m * self.n * FP16_BYTES * self.count

    @property
    def min_dram_bytes(self) -> int:
        """Compulsory DRAM traffic (each operand touched exactly once)."""
        return self.a_bytes + self.b_bytes_once + self.c_bytes

    @property
    def arithmetic_intensity(self) -> float:
        """FLOP per compulsory DRAM byte (paper Fig. 1a x-axis)."""
        return self.flops / self.min_dram_bytes

    def scaled(self, *, m: Optional[int] = None, n: Optional[int] = None,
               k: Optional[int] = None, count: Optional[int] = None) -> "Gemm":
        kw = {}
        if m is not None:
            kw["m"] = m
        if n is not None:
            kw["n"] = n
        if k is not None:
            kw["k"] = k
        if count is not None:
            kw["count"] = count
        return replace(self, **kw)

    def split_n(self, parts: int) -> "Gemm":
        assert parts >= 1
        return self.scaled(n=max(1, -(-self.n // parts)))

    def split_k(self, parts: int) -> "Gemm":
        assert parts >= 1
        return self.scaled(k=max(1, -(-self.k // parts)))


def ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def pad_to(x: int, g: int) -> int:
    return ceil_div(x, g) * g
