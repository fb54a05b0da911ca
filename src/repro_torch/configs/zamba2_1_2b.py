"""Zamba2-1.2B — Mamba2 backbone + one *shared* attention(+MLP) block applied
after every 6th mamba layer (tied weights). [arXiv:2411.15242]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32_000,
    ssm_state=64, ssm_conv=4, ssm_expand=2, ssm_headdim=64,
    n_ssm_groups=1, attn_every=6, tie_embeddings=True, rope_theta=1e4,
)
