"""InternVL2-2B — InternViT frontend STUBBED (precomputed patch embeddings),
InternLM2-1.8B backbone. [arXiv:2404.16821]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab_size=92_553, head_dim=128,
    rope_theta=1e6, n_patches=256, frontend_dim=1024,
)
