"""RWKV6 'Finch' 7B: attention-free SSM with data-dependent decay.
[arXiv:2404.05892; hf]  d_ff is the channel-mix width."""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm",
    num_layers=32, d_model=4096, num_q_heads=1, num_kv_heads=1,
    d_head=64, d_ff=14336, vocab=65536,
    rwkv_head_size=64, gated_ffn=False, norm="layernorm",
)
