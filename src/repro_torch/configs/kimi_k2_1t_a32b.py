"""Kimi-K2 — trillion-parameter MoE: 61L, d=7168, 384 experts top-8 plus one
shared expert (paper-table scale). GQA kv=8 per the assignment (the released
model uses MLA; the assignment pins GQA — noted in DESIGN.md).
[arXiv:2501.kimi2]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
    d_ff=2048, vocab_size=163_840, head_dim=112,
    n_experts=384, experts_per_token=8, moe_d_ff=2048,
    n_shared_experts=1, rope_theta=5e4,
)
