"""Llama-3.2-1B — dense, GQA kv=8, SwiGLU. [hf:meta-llama/Llama-3.2-1B]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab_size=128_256,
    tie_embeddings=True, rope_theta=5e5,
)
