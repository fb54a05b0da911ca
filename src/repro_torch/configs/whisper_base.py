"""Whisper-base — enc-dec audio; conv frontend STUBBED (precomputed frame
embeddings via input_specs). [arXiv:2212.04356]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=12,  # 6 enc + 6 dec (bookkeeping; enc/dec fields are canonical)
    n_enc_layers=6, n_dec_layers=6,
    d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab_size=51_865,
    pos_emb="abs", max_abs_positions=40_960, mlp_act="gelu",
    dec_ratio=8, frontend_dim=512,
)
