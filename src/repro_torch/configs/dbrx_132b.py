"""DBRX-132B: fine-grained MoE, 16 experts top-4, GQA.
[hf:databricks/dbrx-base; unverified]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_q_heads=48, num_kv_heads=8,
    d_head=128, d_ff=10752, vocab=100352,
    num_experts=16, topk=4, d_ff_expert=10752,
    gated_ffn=True, act="silu", norm="layernorm", rope_theta=500000.0,
)
