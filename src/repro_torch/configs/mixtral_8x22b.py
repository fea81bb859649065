"""Mixtral-8x22B — the paper's Table 1 MoE model (8e top-2).
[arXiv:2401.04088]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe",
    num_layers=56, d_model=6144, num_q_heads=48, num_kv_heads=8,
    d_head=128, d_ff=16384, vocab=32768,
    num_experts=8, topk=2, d_ff_expert=16384,
)
