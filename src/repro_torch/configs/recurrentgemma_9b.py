"""RecurrentGemma-9B: RG-LRU + local attention, 1 attention per 2 recurrent.
[arXiv:2402.19427; unverified]  MQA (kv=1), d_head = 4096/16 = 256,
window 2048: a decode state that does not grow with the context."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-9b", family="hybrid",
    num_layers=38, d_model=4096, num_q_heads=16, num_kv_heads=1,
    d_head=256, d_ff=12288, vocab=256000,
    block_pattern=("rec", "rec", "attn"), window=2048, lru_width=4096,
    conv_width=4, gated_ffn=True, act="gelu",
)
