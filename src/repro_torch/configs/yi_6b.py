"""Yi-6B: llama-architecture dense GQA (kv=4). [arXiv:2403.04652; hf]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="yi-6b", family="dense",
    num_layers=32, d_model=4096, num_q_heads=32, num_kv_heads=4,
    d_head=128, d_ff=11008, vocab=64000,
    gated_ffn=True, act="silu", rope_theta=5000000.0,
)
