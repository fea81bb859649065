"""StableLM-2 3B class: dense MHA (kv = q = 32).
[hf:stabilityai/stablelm-2-1_6b; unverified]  d_head = 2560/32 = 80."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="stablelm-3b", family="dense",
    num_layers=32, d_model=2560, num_q_heads=32, num_kv_heads=32,
    d_head=80, d_ff=6912, vocab=50304,
    gated_ffn=True, act="silu", norm="layernorm",
)
