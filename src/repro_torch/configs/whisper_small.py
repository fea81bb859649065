"""Whisper-small: encoder-decoder audio backbone, conv frontend STUB
(input_specs provides precomputed frame embeddings). [arXiv:2212.04356]"""
from repro_torch.models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="audio",
    num_layers=12, encoder_layers=12, d_model=768, num_q_heads=12,
    num_kv_heads=12, d_head=64, d_ff=3072, vocab=51865,
    gated_ffn=False, act="gelu", norm="layernorm", encoder_frames=1500,
    max_seq=32768,
)
