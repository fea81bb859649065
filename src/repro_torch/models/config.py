"""Architecture configuration (a copy of ``repro.models.config``).

One ``ArchConfig`` describes any of the supported model families (the
ids the port resolves are in ``registry``).  ``padded_heads`` /
``padded_vocab`` pad head count and vocab to the tensor-parallel degree
exactly as the reference does, so a bridged parameter tree has the same
shapes on both sides.  ``nmp_spec`` projects the architecture into the
near-memory simulator's ``ModelSpec`` (``repro_torch.core.operators``),
which the engines' co-design pricing reads.  ``ShapeCell`` / ``SHAPES``
are the reference's (arch x shape) cells, which the sharded steps and
``registry.input_specs`` / ``cache_specs`` take.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

from repro_torch.core.operators import ModelSpec, MoESpec


def _pad_to(x: int, g: int) -> int:
    return -(-x // g) * g


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_q_heads: int
    num_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    # ---- MoE ----------------------------------------------------------------
    num_experts: int = 0
    topk: int = 0
    d_ff_expert: int = 0
    num_shared_experts: int = 0
    capacity_factor: float = 1.25
    # ---- attention / ffn ----------------------------------------------------
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    gated_ffn: bool = True
    act: str = "silu"            # silu | gelu
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    tie_embeddings: bool = False
    mrope: bool = False          # Qwen2-VL multimodal rope
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    # ---- ssm (rwkv6) ---------------------------------------------------------
    rwkv_head_size: int = 64
    # ---- hybrid (recurrentgemma) ---------------------------------------------
    block_pattern: Tuple[str, ...] = ()
    window: int = 0
    lru_width: int = 0
    conv_width: int = 4
    # ---- encoder-decoder (whisper) --------------------------------------------
    encoder_layers: int = 0
    encoder_frames: int = 1500
    # ---- misc -----------------------------------------------------------------
    max_seq: int = 1 << 19
    dtype: str = "bfloat16"
    scan_unroll: int = 1

    @property
    def sub_quadratic(self) -> bool:
        """Supports O(1)-state decode (long_500k eligible)."""
        return self.family in ("ssm", "hybrid")

    @property
    def is_encdec(self) -> bool:
        return self.family == "audio"

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def group_size(self) -> int:
        return self.num_q_heads // max(1, self.num_kv_heads)

    def padded_heads(self, tp: int) -> Tuple[int, int]:
        """(q_heads, kv_heads) padded for a TP degree.  MHA (kv == q) pads
        both together; GQA kv heads smaller than tp are replicated (not
        padded).  Invariant: hq % hkv == 0."""
        hq = _pad_to(self.num_q_heads, tp)
        if self.num_kv_heads == self.num_q_heads:
            return hq, hq
        hkv = self.num_kv_heads if self.num_kv_heads < tp \
            else _pad_to(self.num_kv_heads, tp)
        if hq % hkv:
            hq = _pad_to(hq, hkv)
        return hq, hkv

    def padded_vocab(self, tp: int) -> int:
        return _pad_to(self.vocab, 128 * tp)

    def nmp_spec(self) -> ModelSpec:
        """Project this architecture into the NMP simulator's ModelSpec."""
        moe = None
        if self.num_experts:
            moe = MoESpec(num_experts=self.num_experts, topk=self.topk,
                          d_ff_expert=self.d_ff_expert,
                          num_shared_experts=self.num_shared_experts,
                          d_ff_shared=self.d_ff_expert)
        return ModelSpec(name=self.name, num_layers=self.num_layers,
                         d_model=self.d_model, d_ff=self.d_ff,
                         num_q_heads=self.num_q_heads,
                         num_kv_heads=max(1, self.num_kv_heads),
                         vocab=self.vocab, d_head=self.d_head,
                         gated_ffn=self.gated_ffn, moe=moe)

    def reduced(self, **over) -> "ArchConfig":
        """Tiny same-family config for CPU tests (the reference's sizes)."""
        small = dict(
            num_layers=5 if self.block_pattern else min(self.num_layers, 2),
            d_model=128,
            num_q_heads=4,
            num_kv_heads=min(4, max(1, self.num_kv_heads)),
            d_head=32,
            d_ff=256,
            vocab=512,
            max_seq=256,
            lru_width=128 if self.lru_width else 0,
            window=min(self.window, 64) if self.window else 0,
            num_experts=min(self.num_experts, 8) if self.num_experts else 0,
            topk=min(self.topk, 2) if self.topk else 0,
            d_ff_expert=128 if self.d_ff_expert else 0,
            encoder_layers=min(self.encoder_layers, 2),
            encoder_frames=32 if self.encoder_frames else 0,
            rwkv_head_size=32,
            dtype="float32",
        )
        small.update(over)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# Input-shape cells assigned to every LM architecture
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str       # train | prefill | decode


SHAPES = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ArchConfig, shape: str) -> Tuple[bool, str]:
    """Cell applicability per the assignment's skip policy."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, "SKIP(full-attention: 500k decode needs sub-quadratic)"
    return True, ""
