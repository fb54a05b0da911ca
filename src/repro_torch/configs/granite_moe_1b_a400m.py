"""Granite-3.0-1B-A400M — MoE, 32 experts top-8, 512-dim expert FFN.
[hf:ibm-granite/granite-3.0-1b-a400m-base]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab_size=49_155,
    n_experts=32, experts_per_token=8, moe_d_ff=512,
    tie_embeddings=True, rope_theta=1e4,
)
