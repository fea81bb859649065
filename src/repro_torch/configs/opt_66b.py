"""OPT-66B — the paper's Table 1 dense MHA model, as a runnable config
(RoPE stands in for OPT's learned positions; systems shapes unaffected).
[arXiv:2205.01068]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="opt-66b", family="dense",
    num_layers=64, d_model=9216, num_q_heads=72, num_kv_heads=72,
    d_head=128, d_ff=36864, vocab=50272,
    gated_ffn=False, act="gelu", norm="layernorm",
)
