"""Granite-3 8B: dense GQA kv=8. [hf:ibm-granite/granite-3.0-2b-base; hf]
vocab 49155 is padded to a TP-divisible multiple by padded_vocab()."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-8b", family="dense",
    num_layers=40, d_model=4096, num_q_heads=32, num_kv_heads=8,
    d_head=128, d_ff=12800, vocab=49155,
    gated_ffn=True, act="silu", tie_embeddings=True,
)
