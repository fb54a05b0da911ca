"""H2O-Danube-1.8B — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab_size=32_000,
    sliding_window=4096, rope_theta=1e4,
)
