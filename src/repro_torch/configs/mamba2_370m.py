"""Mamba2-370M — attention-free SSD (state-space duality).
[arXiv:2405.21060]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50_280,
    ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_headdim=64,
    n_ssm_groups=1, tie_embeddings=True,
)
