"""Whisper-style encoder-decoder (audio backbone; conv frontend stubbed).

The PyTorch port of the JAX package's ``models/encdec.py``.  The modality
frontend is a stub: the caller hands *precomputed frame embeddings*
(B, S_enc, frontend_dim), and a learned linear adapter maps them to
d_model.  The encoder's self-attention is non-causal and, past 2048
frames, chunked (the ``flash_fwd`` kernel on the card); the decoder's
cross-attention is chunked where the decoder's or the encoder's length
passes 2048 (``layers.cross_attention_fwd``), decode steps included.

As in the JAX package, every decode step recomputes the cross-attention's
keys and values from the cached encoder output: there is no cross-KV
cache.  ``encode`` serves without autograd; ``encode_fwd``,
``decode_train`` and ``loss`` run with it, each layer checkpointed under
the runtime's remat.

On a mesh (``rt.mesh``) the self- and cross-attentions run in
``layers.attention_region`` on each rank's heads, the decoder's decode
step in ``layers.decode_region`` on the stacked self-attention cache, the
token embedding in ``layers.embed_rows``; the residual streams are
constrained to ``rt.act_spec(3)`` where the JAX package constrains them
(after the adapter, the embedding and each block).
"""
from __future__ import annotations

import torch
from torch import nn

from . import layers as L
from .runtime import resolve_device
from .transformer import cross_entropy, mesh_context, stack_padded


class EncDecLM(L.Params):
    """adapter, enc_pos, embed, enc_layers, enc_norm, dec_layers,
    final_norm[, head]."""

    def lm_head(self) -> L.Params | None:
        return L.lm_head(self)


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------
def _init_enc_block(gen: torch.Generator, cfg) -> nn.ModuleDict:
    dt = cfg.torch_dtype
    return nn.ModuleDict({"ln1": L.init_rmsnorm(gen, cfg.d_model, dt),
                          "attn": L.init_attention(gen, cfg),
                          "ln2": L.init_rmsnorm(gen, cfg.d_model, dt),
                          "mlp": L.init_mlp(gen, cfg)})


def _init_dec_block(gen: torch.Generator, cfg) -> nn.ModuleDict:
    dt = cfg.torch_dtype
    return nn.ModuleDict({"ln1": L.init_rmsnorm(gen, cfg.d_model, dt),
                          "attn": L.init_attention(gen, cfg),
                          "lnx": L.init_rmsnorm(gen, cfg.d_model, dt),
                          "xattn": L.init_attention(gen, cfg),
                          "ln2": L.init_rmsnorm(gen, cfg.d_model, dt),
                          "mlp": L.init_mlp(gen, cfg)})


def _enc_block_fwd(p, x, cfg, rt):
    x = rt.residual(x, L.attention_fwd(
        p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps), cfg, causal=False,
        mode=rt.attn_mode, rt=rt))
    x = rt.residual(x, L.mlp_fwd(p["mlp"], L.rms_norm(x, p["ln2"],
                                                      cfg.norm_eps), cfg))
    return rt.constrain(x, *rt.act_spec(3))


def _cross_and_mlp(p, x, enc_out, cfg, rt):
    """A decoder block past its self-attention: cross-attention to the
    encoder output, then the MLP."""
    x = rt.residual(x, L.cross_attention_fwd(
        p["xattn"], L.rms_norm(x, p["lnx"], cfg.norm_eps), enc_out, cfg,
        rt=rt))
    x = rt.residual(x, L.mlp_fwd(p["mlp"], L.rms_norm(x, p["ln2"],
                                                      cfg.norm_eps), cfg))
    return rt.constrain(x, *rt.act_spec(3))


def _dec_block_fwd(p, x, enc_out, cfg, rt):
    """A full-sequence decoder block: causal self-attention (chunked past
    2048 positions under ``auto``), then :func:`_cross_and_mlp`."""
    x = rt.residual(x, L.attention_fwd(
        p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps), cfg, causal=True,
        mode=rt.attn_mode, rt=rt))
    return _cross_and_mlp(p, x, enc_out, cfg, rt)


# --------------------------------------------------------------------------
# model
# --------------------------------------------------------------------------
@torch.no_grad()
def init(gen: torch.Generator, cfg) -> EncDecLM:
    """Random weights from ``gen``, on ``gen``'s device, in ``cfg.dtype``.
    The JAX package's draws differ: carry its params across with
    ``models/convert.py``."""
    dt = cfg.torch_dtype
    mods = {
        "adapter": L.Params(w=L._dense_init(
            gen, (cfg.frontend_dim, cfg.d_model), dt)),
        "enc_pos": L._dense_init(gen, (cfg.max_abs_positions, cfg.d_model),
                                 dt, scale=0.02),
        "embed": L.init_embedding(gen, cfg),      # decoder tokens (+abs pos)
        "enc_layers": nn.ModuleList(_init_enc_block(gen, cfg)
                                    for _ in range(cfg.n_enc_layers)),
        "enc_norm": L.init_rmsnorm(gen, cfg.d_model, dt),
        "dec_layers": nn.ModuleList(_init_dec_block(gen, cfg)
                                    for _ in range(cfg.n_dec_layers)),
        "final_norm": L.init_rmsnorm(gen, cfg.d_model, dt),
    }
    head = L.init_lm_head(gen, cfg)
    if head is not None:
        mods["head"] = head
    return EncDecLM(**mods)


def encode_fwd(model, frames, cfg, rt):
    """:func:`encode` with autograd wherever the caller records it."""
    S = frames.shape[1]
    x = frames.to(cfg.torch_dtype) @ model["adapter"]["w"]
    x = rt.constrain(x + model["enc_pos"][:S], *rt.act_spec(3))
    x = L.run_layers(model["enc_layers"],
                     lambda p, x: _enc_block_fwd(p, x, cfg, rt), x, rt.remat)
    return L.rms_norm(x, model["enc_norm"], cfg.norm_eps)


@torch.no_grad()
def encode(model, frames, cfg, rt):
    """frames: (B, S_enc, frontend_dim) precomputed stub embeddings ->
    the encoder output (B, S_enc, d_model)."""
    with mesh_context(rt):
        return encode_fwd(model, frames, cfg, rt)


def decode_train(model, enc_out, tokens, cfg, rt):
    """The decoder over a whole token sequence (B,S_dec), teacher-forced,
    cross-attending enc_out -> logits (B,S_dec,V) fp32."""
    x = rt.constrain(L.embed(model["embed"], tokens, cfg, rt=rt),
                     *rt.act_spec(3))
    x = L.run_layers(model["dec_layers"],
                     lambda p, x: _dec_block_fwd(p, x, enc_out, cfg, rt), x,
                     rt.remat)
    x = L.rms_norm(x, model["final_norm"], cfg.norm_eps)
    return L.unembed(model["embed"], model.lm_head(), x, cfg)


def loss(model, batch, cfg, rt):
    """batch: {frames (B,S_enc,F), tokens (B,S_dec), labels (B,S_dec)
    [, mask]} -> (nll, metrics {nll, aux = 0})."""
    with mesh_context(rt):
        enc_out = encode_fwd(model, batch["frames"], cfg, rt)
        logits = decode_train(model, enc_out, batch["tokens"], cfg, rt)
        nll = cross_entropy(logits, batch["labels"], batch.get("mask"))
        return nll, {"nll": nll,
                     "aux": torch.zeros((), dtype=torch.float32,
                                        device=nll.device)}


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
def init_cache(cfg, batch: int, max_len: int, rt, dtype=None, enc_len=None,
               device="cuda"):
    """An empty cache on ``device`` (``cuda`` unless the caller asks for
    another): the encoder states (batch, enc_len, d_model), the decoder's
    self-attention k and v (n_dec_layers, batch, max_len, n_kv_heads,
    head_dim), len 0."""
    device = resolve_device(device, "init_cache")
    dtype = dtype or cfg.torch_dtype
    enc_len = enc_len or max_len
    shape = (cfg.n_dec_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"enc_out": torch.zeros(batch, enc_len, cfg.d_model, dtype=dtype,
                                   device=device),
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": 0}


@torch.no_grad()
def prefill(model, batch, cfg, rt, *, max_len: int | None = None):
    """Encode ``batch["frames"]`` and run the decoder prompt
    ``batch["tokens"]`` -> (last logits, cache).  The decoder's
    self-attention is dense here, as in the JAX package (on a mesh in
    ``layers.attention_region``).  On a mesh the cache's leaves are
    DTensors as the layers leave them (``launch/steps.py::build_prefill``
    places them)."""
    enc_out = encode(model, batch["frames"], cfg, rt)
    tokens = batch["tokens"]
    B, S = tokens.shape
    ks, vs = [], []
    with mesh_context(rt):
        x = rt.constrain(L.embed(model["embed"], tokens, cfg, rt=rt),
                         *rt.act_spec(3))
        for p in model["dec_layers"]:
            h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
            q, k, v = L._qkv(p["attn"], h, cfg)
            o = _self_attend(q, k, v, rt)
            x = x + o.reshape(B, S, -1) @ L.attn_wo(p["attn"], cfg, rt)
            x = _cross_and_mlp(p, x, enc_out, cfg, rt)
            ks.append(k)
            vs.append(v)
        n = max(S, max_len or 0)
        ks, vs = stack_padded(ks, n), stack_padded(vs, n)
        x = L.rms_norm(x, model["final_norm"], cfg.norm_eps)
        logits = L.unembed(model["embed"], model.lm_head(), x[:, -1:], cfg)
    return logits, {"enc_out": enc_out, "k": ks, "v": vs, "len": S}


def _self_attend(q, k, v, rt):
    """The prompt's dense causal self-attention, on a mesh on each rank's
    heads."""
    def fn(q, k, v):
        return L.dense_attention(q, k, v, causal=True, window=None)
    if rt.mesh is None:
        return fn(q, k, v)
    return L.attention_region(rt, fn, q, k, v)


@torch.no_grad()
def decode_step(model, cache, tokens, cfg, rt):
    """One decoder token (B,1) -> (logits (B,1,V), cache); cross-attends
    the cached encoder states.  The self-attention cache is updated in
    place; the returned dict holds it with ``len`` + 1."""
    pos = cache["len"]
    with mesh_context(rt):
        x = L.embed_rows(model["embed"]["table"], tokens, rt) \
            + model["embed"]["pos"][pos:pos + 1]
        x = rt.constrain(x, *rt.act_spec(3))
        for i, p in enumerate(model["dec_layers"]):
            h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
            att, _, _ = L.attention_decode(p["attn"], h, cfg, cache["k"],
                                           cache["v"], pos, rt=rt, layer=i)
            x = _cross_and_mlp(p, x + att, cache["enc_out"], cfg, rt)
        x = L.rms_norm(x, model["final_norm"], cfg.norm_eps)
        logits = L.unembed(model["embed"], model.lm_head(), x, cfg)
    return logits, {**cache, "len": pos + 1}
