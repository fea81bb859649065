"""LLaMA3-70B — the paper's Table 1 dense GQA model. [arXiv:2407.21783]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="llama3-70b", family="dense",
    num_layers=80, d_model=8192, num_q_heads=64, num_kv_heads=8,
    d_head=128, d_ff=28672, vocab=128256, rope_theta=500000.0,
)
