"""Model/shape configuration records for the assigned architectures.

``ModelConfig`` is a frozen dataclass consumed by ``repro_torch.models``;
``ShapeSpec`` describes one assigned input-shape cell.  ``reduced()`` yields
the CPU-smoke-test variant of a config (same family/topology, tiny sizes).
A copy of the JAX package's ``configs/base.py`` whose dtype property gives
a torch dtype.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    sliding_window: int | None = None
    pos_emb: str = "rope"          # rope | abs
    rope_theta: float = 1e6
    mlp_act: str = "swiglu"        # swiglu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    max_abs_positions: int = 0
    # --- MoE ---
    n_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    norm_topk_prob: bool = True
    aux_loss_coef: float = 0.01
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64
    n_ssm_groups: int = 1
    # --- hybrid (zamba2): shared attn block after every `attn_every` layers
    attn_every: int = 0
    # --- enc-dec (whisper) ---
    n_enc_layers: int = 0
    n_dec_layers: int = 0
    dec_ratio: int = 8             # dec_len = seq_len // dec_ratio
    # --- vlm / audio frontend stubs ---
    n_patches: int = 0
    frontend_dim: int = 0
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0 and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def torch_dtype(self) -> torch.dtype:
        """``dtype`` ("bfloat16", "float32", ...) as a torch dtype."""
        dt = getattr(torch, self.dtype, None)
        if not isinstance(dt, torch.dtype):
            raise ValueError(f"{self.name}: unknown dtype {self.dtype!r}")
        return dt

    @property
    def padded_vocab(self) -> int:
        """Embedding/head tables are padded to a multiple of 256 so the vocab
        dim shards evenly over any tp width <= 256 and stays 128-lane aligned
        (MaxText-style).  Token ids never reach the padding; the extra logits
        are just unused classes."""
        return -(-self.vocab_size // 256) * 256

    @property
    def d_inner(self) -> int:       # mamba
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    # ---- parameter counting (roofline MODEL_FLOPS = 6*N*D) ----------------
    def _attn_params(self) -> int:
        hd = self.head_dim
        p = self.d_model * (self.n_heads + 2 * self.n_kv_heads) * hd
        p += self.n_heads * hd * self.d_model
        if self.qkv_bias:
            p += (self.n_heads + 2 * self.n_kv_heads) * hd
        return p

    def _mlp_params(self, f: int) -> int:
        n = 3 * self.d_model * f if self.mlp_act == "swiglu" \
            else 2 * self.d_model * f + f + self.d_model
        return n

    def _mamba_params(self) -> int:
        di, g, n, h = self.d_inner, self.n_ssm_groups, self.ssm_state, self.n_ssm_heads
        conv_dim = di + 2 * g * n
        return (self.d_model * (2 * di + 2 * g * n + h)
                + self.ssm_conv * conv_dim + conv_dim
                + 3 * h + di + di * self.d_model)

    def param_count(self, active_only: bool = False) -> int:
        """Total (or active-per-token) parameters, embeddings included."""
        emb = self.vocab_size * self.d_model
        if self.pos_emb == "abs":
            emb += self.max_abs_positions * self.d_model
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        if self.family == "encdec":
            per_enc = self._attn_params() + self._mlp_params(self.d_ff) + 2 * self.d_model
            per_dec = 2 * self._attn_params() + self._mlp_params(self.d_ff) + 3 * self.d_model
            return emb + head + self.n_enc_layers * per_enc + self.n_dec_layers * per_dec
        if self.family == "ssm":
            return emb + head + self.n_layers * (self._mamba_params() + self.d_model)
        if self.family == "hybrid":
            body = self.n_layers * (self._mamba_params() + self.d_model)
            shared = self._attn_params() + self._mlp_params(self.d_ff) + 2 * self.d_model
            return emb + head + body + shared
        per = self._attn_params() + 2 * self.d_model
        if self.n_experts:
            e = self.experts_per_token if active_only else self.n_experts
            per += e * 3 * self.d_model * self.moe_d_ff
            per += self.d_model * self.n_experts  # router
            per += self.n_shared_experts * 3 * self.d_model * self.moe_d_ff
        else:
            per += self._mlp_params(self.d_ff)
        n = emb + head + self.n_layers * per
        if self.family == "vlm":
            n += self.frontend_dim * self.d_model  # projector
        return n

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2),
            d_model=64,
            d_ff=128 if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 256),
            head_dim=0,
        )
        if self.n_heads:
            kw["n_heads"] = 4
            kw["n_kv_heads"] = min(self.n_kv_heads, 2) or 2
        if self.sliding_window:
            kw["sliding_window"] = 16
        if self.n_experts:
            kw["n_experts"] = 4
            kw["experts_per_token"] = 2
            kw["moe_d_ff"] = 32
        if self.ssm_state:
            kw["ssm_state"] = 16
            kw["ssm_headdim"] = 16
        if self.attn_every:
            kw["attn_every"] = 2
            kw["n_layers"] = 4
        if self.family == "encdec":
            kw["n_enc_layers"] = 2
            kw["n_dec_layers"] = 2
            kw["max_abs_positions"] = 512
        if self.family == "vlm":
            kw["n_patches"] = 4
            kw["frontend_dim"] = 32
        return self.replace(**kw)


@dataclass(frozen=True)
class ShapeSpec:
    """One assigned (input-shape) cell."""

    name: str
    kind: str                      # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def smoke_shape(kind: str) -> ShapeSpec:
    return {
        "train": ShapeSpec("smoke_train", "train", 32, 2),
        "prefill": ShapeSpec("smoke_prefill", "prefill", 32, 2),
        "decode": ShapeSpec("smoke_decode", "decode", 32, 2),
    }[kind]
