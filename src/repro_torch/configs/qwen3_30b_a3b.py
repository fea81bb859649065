"""Qwen3-30B-A3B — the paper's Table 1 fine-grained MoE (128e top-8).
[arXiv:2505.09388]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-30b-a3b", family="moe",
    num_layers=48, d_model=2048, num_q_heads=32, num_kv_heads=4,
    d_head=128, d_ff=6144, vocab=151936,
    num_experts=128, topk=8, d_ff_expert=768,
)
