"""Kimi K2: trillion-parameter MoE, 384 experts top-8 + 1 shared, GQA.
[arXiv:2501.kimi2; unverified]  d_head = 7168/64 = 112."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_q_heads=64, num_kv_heads=8,
    d_head=112, d_ff=2048, vocab=163840,
    num_experts=384, topk=8, d_ff_expert=2048, num_shared_experts=1,
    gated_ffn=True, act="silu", rope_theta=50000.0,
)
