"""Operations and bytes of a decoder-only transformer's served work.

Counted from shapes, never read from the program: a configuration file
(``configs/<name>.json``, Hugging Face key names) gives the sizes, and
the harness gives what the traffic asked for in each tick (the decode
steps with their batch and contexts, the prefill chunk with its length
and offset).  Everything counts what these inputs need, read once and
written once, in the configuration's dtype:

* a linear product streams its weights once per sequential step; the
  chunk of a tick and the tick's first decode step could share one
  read, so a tick's weights are read once per decode step (once for a
  chunk alone);
* an MoE layer reads only the experts its tokens route to.  The
  harness does not see the routing, so the count takes the expected
  number of distinct experts that ``T`` tokens with ``k`` experts each
  reach under uniform routing, ``E (1 - (1 - k/E)^T)``; 64 tokens of
  Qwen3-30B-A3B reach ~125.9 of 128;
* decode attention reads the K/V of each lane's context and writes the
  new token's; a chunk reads the context before it and writes its own;
* activations between products are left out (a lower bound on bytes),
  and so are the logits a fused argmax would not need.

The least time of a piece of work is the larger of its FLOPs over the
peak and its bytes over the bandwidth (``least_s``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Sequence, Tuple

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


@dataclass(frozen=True)
class Shape:
    layers: int
    d: int
    hq: int
    hkv: int
    dh: int
    ff: int
    vocab: int
    experts: int = 0
    topk: int = 0
    ff_expert: int = 0
    wbytes: int = 2
    tied: bool = False

    @staticmethod
    def of(cfg: Dict) -> "Shape":
        hq = int(cfg["num_attention_heads"])
        return Shape(
            layers=int(cfg["num_hidden_layers"]),
            d=int(cfg["hidden_size"]), hq=hq,
            hkv=int(cfg["num_key_value_heads"]),
            dh=int(cfg.get("head_dim") or cfg["hidden_size"] // hq),
            ff=int(cfg["intermediate_size"]),
            vocab=int(cfg["vocab_size"]),
            experts=int(cfg.get("num_experts") or 0),
            topk=int(cfg.get("num_experts_per_tok") or 0),
            ff_expert=int(cfg.get("moe_intermediate_size") or 0),
            wbytes=BYTES[cfg["torch_dtype"]],
            tied=bool(cfg.get("tie_word_embeddings", False)))

    @property
    def moe(self) -> bool:
        return self.experts > 0

    # -- parameters ---------------------------------------------------------
    @property
    def attn_params(self) -> int:
        """q, k, v and o projections of one layer."""
        return self.d * (self.hq + 2 * self.hkv) * self.dh \
            + self.hq * self.dh * self.d

    @property
    def ffn_params(self) -> int:
        """The gated FFN of one dense layer."""
        return 3 * self.d * self.ff

    @property
    def expert_params(self) -> int:
        """One expert's gated FFN."""
        return 3 * self.d * self.ff_expert

    @property
    def router_bytes(self) -> int:
        """One layer's router, float32."""
        return self.d * self.experts * 4

    @property
    def head_params(self) -> int:
        return self.d * self.vocab

    @property
    def norm_bytes(self) -> int:
        """Every RMSNorm scale (float32), read once a forward."""
        return (2 * self.layers + 1) * self.d * 4

    @property
    def kv_bytes_per_token(self) -> int:
        return self.layers * self.hkv * self.dh * 2 * self.wbytes

    def weights_bytes(self) -> int:
        """Every parameter: the embedding table, the head, the layers."""
        per_layer = self.attn_params * self.wbytes
        if self.moe:
            per_layer += self.router_bytes \
                + self.experts * self.expert_params * self.wbytes
        else:
            per_layer += self.ffn_params * self.wbytes
        table = self.vocab * self.d * self.wbytes
        head = 0 if self.tied else self.head_params * self.wbytes
        return table + head + self.layers * per_layer + self.norm_bytes

    def step_weight_bytes(self, experts_read: float = 0.0) -> float:
        """Weights one forward step streams: every layer outside its
        experts (the router included), ``experts_read`` experts a layer,
        the norms and the head (not the embedding table: a step gathers
        a few of its rows)."""
        per_layer = self.attn_params * self.wbytes
        if self.moe:
            per_layer += self.router_bytes \
                + experts_read * self.expert_params * self.wbytes
        else:
            per_layer += self.ffn_params * self.wbytes
        return self.layers * per_layer + self.norm_bytes \
            + self.head_params * self.wbytes

    def distinct_experts(self, tokens: int) -> float:
        """Expected experts ``tokens`` tokens reach under uniform routing."""
        if not self.moe or tokens <= 0:
            return 0.0
        e, k = self.experts, self.topk
        return e * (1.0 - (1.0 - k / e) ** tokens)

    # -- FLOPs ---------------------------------------------------------------
    def linear_flops_per_token(self) -> int:
        """Every product of one token through the layers (the router and
        the k routed experts of an MoE layer), without the head."""
        per_layer = 2 * self.attn_params
        if self.moe:
            per_layer += 2 * self.d * self.experts \
                + 2 * self.topk * self.expert_params
        else:
            per_layer += 2 * self.ffn_params
        return self.layers * per_layer

    @property
    def head_flops(self) -> int:
        return 2 * self.d * self.vocab

    def attn_flops(self, q_tokens_x_keys: float) -> float:
        """QK^T and PV over ``sum of keys each query attends``."""
        return 4.0 * self.hq * self.dh * q_tokens_x_keys * self.layers


@dataclass
class Work:
    """FLOPs and bytes of some served work, whole and by part."""
    flops: float = 0.0
    bytes: float = 0.0
    gemm_flops: float = 0.0
    gemm_bytes: float = 0.0
    flash_bytes: float = 0.0        # the paged decode kernel's q, K/V, out


def least_s(flops: float, nbytes: float, peak_flops: float,
            peak_bw: float) -> float:
    return max(flops / peak_flops, nbytes / peak_bw)


Step = Tuple[int, int]          # (lanes, sum of their attended contexts)
Chunk = Tuple[int, int]         # (tokens, offset)


def tick_work(s: Shape, steps: Sequence[Step],
              chunk: Optional[Chunk]) -> Work:
    """One tick's work: ``steps`` decode steps in sequence, each over
    ``lanes`` slots attending ``sum_ctx`` positions in all (the new
    token's included), and at most one prefill ``chunk``."""
    w = Work()
    reads = max(len(steps), 1 if chunk else 0)
    for j in range(reads):
        toks = steps[j][0] if j < len(steps) else 0
        if j == 0 and chunk:
            toks += chunk[0]
        wb = s.step_weight_bytes(s.distinct_experts(toks))
        w.bytes += wb
        w.gemm_bytes += wb
    kvt = s.kv_bytes_per_token
    act = s.wbytes * s.hq * s.dh * s.layers       # one token's q (or out)
    for lanes, sum_ctx in steps:
        lin = lanes * (s.linear_flops_per_token() + s.head_flops)
        att = s.attn_flops(sum_ctx)
        w.flops += lin + att
        w.gemm_flops += lin
        # K/V of the context before the new token, then the new token's
        w.bytes += (sum_ctx - lanes) * kvt + lanes * kvt
        w.flash_bytes += sum_ctx * kvt + 2 * lanes * act
    if chunk:
        c, off = chunk
        pairs = c * off + c * (c + 1) / 2         # causal (query, key) pairs
        lin = c * s.linear_flops_per_token() + s.head_flops
        att = s.attn_flops(pairs)
        w.flops += lin + att
        # the chunk's attention runs as matrix products (its q, the K/V
        # window up to the chunk's end, its output)
        w.gemm_flops += lin + att
        w.gemm_bytes += (off + c) * kvt + 2 * c * act
        w.bytes += off * kvt + c * kvt
    return w


def total(ticks: Iterable[Tuple[Sequence[Step], Optional[Chunk]]],
          s: Shape, peak_flops: float, peak_bw: float) -> Dict[str, float]:
    """Least seconds of a run of ticks: the whole work, its matrix
    products and the paged decode kernel's bytes, each tick bounded on
    its own and summed."""
    out = {"least_s": 0.0, "gemm_least_s": 0.0, "flash_least_s": 0.0,
           "flops": 0.0, "bytes": 0.0, "decode_steps": 0}
    for steps, chunk in ticks:
        w = tick_work(s, steps, chunk)
        out["least_s"] += least_s(w.flops, w.bytes, peak_flops, peak_bw)
        out["gemm_least_s"] += least_s(w.gemm_flops, w.gemm_bytes,
                                       peak_flops, peak_bw)
        out["flash_least_s"] += w.flash_bytes / peak_bw
        out["flops"] += w.flops
        out["bytes"] += w.bytes
        out["decode_steps"] += len(steps)
    return out
