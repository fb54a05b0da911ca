"""Qwen1.5-0.5B — dense, QKV bias, kv=16 (full MHA). [hf:Qwen/Qwen1.5-0.5B]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=2816, vocab_size=151_936,
    qkv_bias=True, tie_embeddings=True, rope_theta=1e6,
)
