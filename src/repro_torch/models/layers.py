"""Transformer layer primitives for inference: plain functions on tensors.

The PyTorch port of the JAX package's ``models/layers.py``, its inference
half.  Conventions kept from there:

* Parameters sit in :class:`Params` bags named as the JAX package's param
  dicts (``p["wq"]``, ``"wg" in p``), in its layouts: a projection is
  ``x @ w`` with w (d_in, d_out), so weights carry across unchanged
  (``models/convert.py``).
* Activations are ``cfg.dtype``; norms, softmax and the logits accumulate in
  f32 (the JAX package's ``preferred_element_type=f32`` becomes an f32
  product of the widened operands).
* Attention is GQA with RoPE on two paths: ``dense`` materialises the
  (B, H, Sq, Sk) scores in plain torch; ``chunked`` is the flash-attention
  recurrence, which on a CUDA tensor is the hand-written kernel
  (``kernels/flash_attn``) and on a CPU tensor its plain twin.
* Sliding-window attention (h2o-danube) masks both paths.

Not ported yet: the chunked path's custom VJP and backward (training),
and the tensor-parallel head padding and sharding hints (a ``Runtime``
with a mesh raises).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.flash_attn import flash_attention
from ..kernels.flash_attn.ref import attention_mask


class Params(nn.Module):
    """A named bag of parameter tensors and nested bags (or other
    modules), indexed like the JAX package's param dicts: ``p["wq"]`` is a
    tensor, ``p["shared"]["wg"]`` a tensor of a nested bag.  Inference
    only: no tensor requires a gradient."""

    def __init__(self, **items):
        super().__init__()
        for name, t in items.items():
            if isinstance(t, nn.Module):
                self.add_module(name, t)
            else:
                self.register_parameter(name,
                                        nn.Parameter(t, requires_grad=False))

    def __getitem__(self, name: str):
        if name in self._parameters:
            return self._parameters[name]
        return self._modules[name]

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


# --------------------------------------------------------------------------
# initialisation helpers
# --------------------------------------------------------------------------
def _dense_init(gen: torch.Generator, shape, dtype,
                scale: float | None = None):
    fan_in = shape[0] if len(shape) >= 2 else 1
    std = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * std).to(dtype)


def _zeros(gen: torch.Generator, shape, dtype):
    return torch.zeros(shape, dtype=dtype, device=gen.device)


def init_rmsnorm(gen: torch.Generator, d: int, dtype) -> Params:
    return Params(scale=torch.ones(d, dtype=dtype, device=gen.device))


def rms_norm(x, params: Params, eps: float = 1e-5):
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------
def rope_angles(positions, head_dim: int, theta: float):
    """(..., S) int positions -> cos/sin tables (..., S, head_dim/2), fp32."""
    half = head_dim // 2
    freqs = torch.pow(theta, -torch.arange(0, half, dtype=torch.float32,
                                           device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., S, H, D). cos/sin: (..., S, D/2) broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if x.ndim == 4 and cos.ndim == 2:         # (B, S, H, D) with (S, half)
        c = cos[None, :, None, :].to(x.dtype)
        s = sin[None, :, None, :].to(x.dtype)
    elif x.ndim == cos.ndim + 2:
        c, s = cos[..., None, :].to(x.dtype), sin[..., None, :].to(x.dtype)
    else:
        c, s = cos.to(x.dtype), sin.to(x.dtype)
    # rotate-half convention (llama/qwen)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


# --------------------------------------------------------------------------
# attention (GQA + optional sliding window), dense and chunked paths
# --------------------------------------------------------------------------
def init_attention(gen: torch.Generator, cfg) -> Params:
    d, hd = cfg.d_model, cfg.head_dim
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    dt = cfg.torch_dtype
    p = {
        "wq": _dense_init(gen, (d, nq * hd), dt),
        "wk": _dense_init(gen, (d, nkv * hd), dt),
        "wv": _dense_init(gen, (d, nkv * hd), dt),
        "wo": _dense_init(gen, (nq * hd, d), dt),
    }
    if cfg.qkv_bias:
        p["bq"] = _zeros(gen, (nq * hd,), dt)
        p["bk"] = _zeros(gen, (nkv * hd,), dt)
        p["bv"] = _zeros(gen, (nkv * hd,), dt)
    return Params(**p)


def _qkv(params: Params, x, cfg):
    B, S, _ = x.shape
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    q = q.reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    return q, k, v


def _repeat_kv(k, n_rep: int):
    if n_rep == 1:
        return k
    B, S, H, D = k.shape
    return k[:, :, :, None, :].expand(B, S, H, n_rep, D).reshape(
        B, S, H * n_rep, D)


def dense_attention(q, k, v, *, causal: bool, window: int | None,
                    q_offset: int = 0, scale: float | None = None):
    """Materialised-scores attention. q:(B,Sq,H,D) k/v:(B,Sk,Hkv,D)."""
    Sq, H, D = q.shape[1], q.shape[2], q.shape[3]
    Sk, Hkv = k.shape[1], k.shape[2]
    k = _repeat_kv(k, H // Hkv)
    v = _repeat_kv(v, H // Hkv)
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = attention_mask(torch.arange(Sq, device=q.device) + q_offset,
                          torch.arange(Sk, device=q.device), Sk, causal,
                          window)
    scores = torch.where(mask, scores, -torch.inf)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def chunked_attention(q, k, v, *, causal: bool, window: int | None,
                      q_offset: int = 0, scale: float | None = None):
    """Flash-style online-softmax attention, O(S·tile) working set.

    In the JAX package, the pure-jnp twin of its Pallas kernel; here the
    name the model code calls for :func:`flash_attention` itself: on a
    CUDA tensor the hand-written ``flash_fwd`` kernel, on a CPU tensor its
    plain recurrence (``flash_fwd_ref``).  Both compute the Pallas
    kernel's function, which keeps p and q·scale in f32: in bf16 the JAX
    twin rounds both to bf16, so the two part by a bf16 rounding.  Forward
    only.  The JAX version's ``q_blk``/``kv_blk`` have no counterpart: the
    kernel's tiles are fixed.
    """
    return flash_attention(q, k, v, causal=causal, window=window,
                           scale=scale, q_offset=q_offset)


def resolve_mode(mode: str, S: int) -> str:
    """``auto`` is ``chunked`` past 2048 tokens, else ``dense``."""
    if mode == "auto":
        return "chunked" if S > 2048 else "dense"
    return mode


def attention_fwd(params: Params, x, cfg, *, positions=None, causal=True,
                  mode: str = "auto", q_offset: int = 0,
                  return_kv: bool = False):
    """Self-attention over x:(B,S,D) -> (B,S,D), or with ``return_kv``
    (out, k, v): the roped keys and the values, (B,S,Hkv,hd), that prefill
    writes into the KV cache."""
    B, S, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    if positions is None:
        positions = torch.arange(S, device=x.device) + q_offset
    if cfg.pos_emb == "rope":
        cos, sin = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    window = cfg.sliding_window
    if resolve_mode(mode, S) == "chunked":
        out = chunked_attention(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)
    else:
        out = dense_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    out = out.reshape(B, S, cfg.n_heads * cfg.head_dim) @ params["wo"]
    return (out, k, v) if return_kv else out


def attention_decode(params: Params, x, cfg, cache_k, cache_v,
                     cache_len: int):
    """One-token decode with a KV cache.

    x: (B, 1, D); cache_k/v: (B, S_max, Hkv, hd); cache_len: number of
    valid cache positions.  Returns (out, cache_k, cache_v).  Unlike the
    JAX package, which returns updated copies, the new position is
    written into cache_k/cache_v in place: a step allocates no cache.
    """
    B = x.shape[0]
    q, k, v = _qkv(params, x, cfg)
    if cfg.pos_emb == "rope":
        pos = torch.full((1,), cache_len, dtype=torch.int32, device=x.device)
        cos, sin = rope_angles(pos, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    cache_k[:, cache_len] = k[:, 0].to(cache_k.dtype)
    cache_v[:, cache_len] = v[:, 0].to(cache_v.dtype)

    S_max, Hkv = cache_k.shape[1], cache_k.shape[2]
    H = cfg.n_heads
    rep = H // Hkv
    # grouped-GQA einsum: the kv cache is never repeated
    qg = q.reshape(B, 1, Hkv, rep, cfg.head_dim)
    scale = 1.0 / math.sqrt(cfg.head_dim)
    s = torch.einsum("bqkrd,bskd->bkrqs", qg.float(), cache_k.float()) * scale
    kpos = torch.arange(S_max, device=x.device)
    valid = kpos <= cache_len
    if cfg.sliding_window is not None:
        valid &= kpos > cache_len - cfg.sliding_window
    s = torch.where(valid, s, -torch.inf)
    p = torch.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("bkrqs,bskd->bqkrd", p, cache_v)
    out = out.reshape(B, 1, H * cfg.head_dim) @ params["wo"]
    return out, cache_k, cache_v


def cross_attention_fwd(params: Params, x, enc_out, cfg):
    """Decoder cross-attention: queries from x (B,Sq,D), keys and values
    from enc_out (B,Sk,D), no mask.  Past 2048 positions on either side it
    takes the chunked path (the kernel on a CUDA tensor), else dense."""
    B, Sq, _ = x.shape
    Sk = enc_out.shape[1]
    q = (x @ params["wq"]).reshape(B, Sq, cfg.n_heads, cfg.head_dim)
    k = (enc_out @ params["wk"]).reshape(B, Sk, cfg.n_kv_heads, cfg.head_dim)
    v = (enc_out @ params["wv"]).reshape(B, Sk, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qkv_bias:
        q = q + params["bq"].reshape(1, 1, cfg.n_heads, cfg.head_dim)
        k = k + params["bk"].reshape(1, 1, cfg.n_kv_heads, cfg.head_dim)
        v = v + params["bv"].reshape(1, 1, cfg.n_kv_heads, cfg.head_dim)
    attn = chunked_attention if max(Sq, Sk) > 2048 else dense_attention
    out = attn(q, k, v, causal=False, window=None)
    return out.reshape(B, Sq, cfg.n_heads * cfg.head_dim) @ params["wo"]


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
def init_mlp(gen: torch.Generator, cfg, d_ff: int | None = None) -> Params:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    dt = cfg.torch_dtype
    if cfg.mlp_act == "swiglu":
        return Params(wg=_dense_init(gen, (d, f), dt),
                      wu=_dense_init(gen, (d, f), dt),
                      wd=_dense_init(gen, (f, d), dt))
    return Params(wu=_dense_init(gen, (d, f), dt),     # gelu 2-matrix MLP
                  bu=_zeros(gen, (f,), dt),
                  wd=_dense_init(gen, (f, d), dt),
                  bd=_zeros(gen, (d,), dt))


def mlp_fwd(params: Params, x, cfg):
    if "wg" in params:
        return (F.silu(x @ params["wg"]) * (x @ params["wu"])) @ params["wd"]
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(x @ params["wu"] + params["bu"], approximate="tanh")
    return h @ params["wd"] + params["bd"]


# --------------------------------------------------------------------------
# embeddings / unembedding
# --------------------------------------------------------------------------
def init_embedding(gen: torch.Generator, cfg) -> Params:
    dt = cfg.torch_dtype
    p = {"table": _dense_init(gen, (cfg.padded_vocab, cfg.d_model), dt,
                              scale=0.02)}
    if cfg.pos_emb == "abs":
        p["pos"] = _dense_init(gen, (cfg.max_abs_positions, cfg.d_model), dt,
                               scale=0.02)
    return Params(**p)


def embed(params: Params, tokens, cfg, *, offset: int = 0):
    x = params["table"][tokens]
    if cfg.pos_emb == "abs":
        S = tokens.shape[-1]
        x = x + params["pos"][offset:offset + S]
    return x


def unembed(params_emb: Params, params_head: Params | None, x, cfg):
    """Project to vocab logits (fp32). Tied or separate head."""
    if params_head is None:
        return x.float() @ params_emb["table"].float().T
    return x.float() @ params_head["w"].float()


def lm_head(model) -> Params | None:
    """A model's separate LM head, or None where it is tied to the
    embedding table."""
    return model["head"] if "head" in model else None


def init_lm_head(gen: torch.Generator, cfg) -> Params | None:
    if cfg.tie_embeddings:
        return None
    return Params(w=_dense_init(gen, (cfg.d_model, cfg.padded_vocab),
                                cfg.torch_dtype, scale=0.02))
