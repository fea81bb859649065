"""Qwen1.5-110B: dense GQA with QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b", family="dense",
    num_layers=80, d_model=8192, num_q_heads=64, num_kv_heads=8,
    d_head=128, d_ff=49152, vocab=152064,
    qkv_bias=True, gated_ffn=True, act="silu", rope_theta=1000000.0,
)
