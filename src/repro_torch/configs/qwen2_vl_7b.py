"""Qwen2-VL-7B text backbone: M-RoPE, dynamic resolution (vision frontend
STUB per the assignment: input_specs provides precomputed patch embeddings).
[arXiv:2409.12191; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    num_layers=28, d_model=3584, num_q_heads=28, num_kv_heads=4,
    d_head=128, d_ff=18944, vocab=152064,
    qkv_bias=True, mrope=True, mrope_sections=(16, 24, 24),
    gated_ffn=True, act="silu", rope_theta=1000000.0,
)
