"""Decoder-only transformer LM (dense and MoE families).

The PyTorch port of the JAX package's ``models/transformer.py``.  There the
layers are scanned over params stacked on a leading ``n_layers`` axis; here
the model is an ``nn.ModuleDict`` holding an ``nn.ModuleList`` of
:class:`Block`\\ s, walked by a Python loop (``models/convert.py`` unstacks
the JAX package's params into it).  A block's feed-forward is a dense MLP
or, where the config has experts, the MoE layer (``models/moe.py``).

API (used by ``models/registry.py``):
    init(gen, cfg)                          -> model
    forward(model, tokens, cfg, rt)         -> (logits, aux)
    loss(model, batch, cfg, rt)             -> (loss, metrics)
    prefill(model, tokens, cfg, rt)         -> (last_logits, cache)
    init_cache(cfg, batch, max_len, rt)     -> cache
    decode_step(model, cache, tokens, cfg, rt) -> (logits, cache)

``forward`` and ``prefill`` take ``embeds``: precomputed embeddings put
ahead of the tokens' (the VLM's projected patches).  ``forward``,
``prefill`` and ``decode_step`` run without autograd; ``loss`` runs the
same layers with it, under the runtime's remat (``torch.utils.checkpoint``
a layer, or a group of ``remat_group`` layers) and, with a ``loss_chunk``,
the chunked cross-entropy.

On a mesh (``rt.mesh``) the parameters and inputs are DTensors and the
same code runs SPMD, one process a rank: the residual stream is
constrained to ``rt.act_spec(3)`` where the JAX package constrains it
(after the embedding and after each residual add; with ``act_shard="seq"``
its sequence over tp, gathered where a block reads it), the attention, decode and embedding run in
``layers``' ``local_map`` regions, and prefill's cache is built by
stacking the layers' keys and values (``launch/steps.py::build_prefill``
redistributes it to ``launch/plans.py::cache_pspecs``).  Plain tensors
that the code makes (positions, masks, zeros) act as replicated
(:func:`mesh_context`).
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from . import layers as L
from . import moe as M
from .runtime import resolve_device


# --------------------------------------------------------------------------
# one decoder block
# --------------------------------------------------------------------------
class Block(nn.ModuleDict):
    """ln1, attn, ln2, and mlp or (MoE) moe: one decoder block's params."""


def init_block(gen: torch.Generator, cfg) -> Block:
    p = {"ln1": L.init_rmsnorm(gen, cfg.d_model, cfg.torch_dtype),
         "attn": L.init_attention(gen, cfg),
         "ln2": L.init_rmsnorm(gen, cfg.d_model, cfg.torch_dtype)}
    if cfg.n_experts:
        p["moe"] = M.init_moe(gen, cfg)
    else:
        p["mlp"] = L.init_mlp(gen, cfg)
    return Block(p)


def _ffn(p: Block, h, cfg, rt):
    """The block's feed-forward on h: (y, aux)."""
    if cfg.n_experts:
        return M.moe_fwd(p["moe"], h, cfg, rt)
    return (L.mlp_fwd(p["mlp"], h, cfg),
            torch.zeros((), dtype=torch.float32, device=h.device))


def mesh_context(rt):
    """On a mesh, plain tensors mixed with DTensors act as replicated
    (``implicit_replication``); without one, nothing."""
    if rt is None or rt.mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _whole_sequence(x, rt):
    """Under ``act_shard="seq"`` the residual stream's sequence gathered
    where a block (or the final norm) reads it; ``x`` itself otherwise.
    The block adds its outputs to the gathered stream and shards the sum
    again, so the gradients that reach the projections are whole along the
    sequence too (Megatron-SP's all-gather; the stream between blocks, what
    remat saves, stays sequence-sharded)."""
    if rt.mesh is None or rt.act_shard != "seq":
        return x
    return rt.constrain(x, rt.dp_axes, None, None)


def block_fwd(p: Block, x, cfg, rt, *, return_kv: bool = False):
    """Full-sequence block. x: (B,S,D) -> (x', aux[, (k,v)])."""
    x = _whole_sequence(x, rt)
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    out = L.attention_fwd(p["attn"], h, cfg, mode=rt.attn_mode,
                          return_kv=return_kv, rt=rt)
    attn_out, kv = (out[0], out[1:]) if return_kv else (out, None)
    x = rt.residual(x, attn_out)
    x = _whole_sequence(rt.constrain(x, *rt.act_spec(3)), rt)
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    y, aux = _ffn(p, h, cfg, rt)
    x = rt.constrain(rt.residual(x, y), *rt.act_spec(3))
    return (x, aux, kv) if return_kv else (x, aux)


def block_decode(p: Block, x, cfg, rt, cache_k, cache_v, cache_len: int,
                 layer: int | None = None):
    """One-token block step; writes the new KV position into the cache
    (one layer's, or with ``layer`` that layer of the stacked cache).  On
    a mesh the residual stream keeps ``rt.act_spec(3)`` after each add, so
    DTensor does not shard the step's one position."""
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    attn_out, nk, nv = L.attention_decode(p["attn"], h, cfg,
                                          cache_k, cache_v, cache_len,
                                          rt=rt, layer=layer)
    x = rt.constrain(x + attn_out, *rt.act_spec(3))
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    return rt.constrain(x + _ffn(p, h, cfg, rt)[0], *rt.act_spec(3)), nk, nv


# --------------------------------------------------------------------------
# full model
# --------------------------------------------------------------------------
class TransformerLM(nn.ModuleDict):
    """embed, layers (one :class:`Block` each), final_norm[, head]; the
    VLM adds its projector."""

    def lm_head(self) -> L.Params | None:
        return L.lm_head(self)


@torch.no_grad()
def init(gen: torch.Generator, cfg) -> TransformerLM:
    """Random weights from ``gen``, on ``gen``'s device, in ``cfg.dtype``.
    The JAX package's ``jax.random`` draws differ: to compute what it
    computes, carry its params across with ``models/convert.py``."""
    mods = {"embed": L.init_embedding(gen, cfg),
            "layers": nn.ModuleList(init_block(gen, cfg)
                                    for _ in range(cfg.n_layers)),
            "final_norm": L.init_rmsnorm(gen, cfg.d_model, cfg.torch_dtype)}
    head = L.init_lm_head(gen, cfg)
    if head is not None:
        mods["head"] = head
    return TransformerLM(mods)


def _blocks(model, x, cfg, rt, *, return_kv: bool = False):
    """The decoder stack on x -> (x, aux summed over layers, [(k, v)] a
    layer with ``return_kv``).  With ``rt.remat`` and a gradient being
    recorded, each layer is checkpointed, or each group of
    ``rt.remat_group`` layers with the layers that fill no group
    checkpointed one by one (``layers.run_layers``), as the JAX package's
    ``_scan_blocks``."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_kv:
        kvs = []
        for p in model["layers"]:
            x, a, kv = block_fwd(p, x, cfg, rt, return_kv=True)
            kvs.append(kv)
            aux = aux + a
        return x, aux, kvs

    def step(p, carry):
        x, a = block_fwd(p, carry[0], cfg, rt)
        return x, carry[1] + a
    x, aux = L.run_layers(model["layers"], step, (x, aux), rt.remat,
                          rt.remat_group)
    return x, aux, []


def _embed(model, tokens, cfg, embeds, rt=None):
    x = L.embed(model["embed"], tokens, cfg, rt=rt)
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    return rt.constrain(x, *rt.act_spec(3)) if rt is not None else x


def _hidden(model, tokens, cfg, rt, embeds=None):
    """The final-normed hidden states (B,S',D) and aux, with autograd
    wherever the caller records it."""
    x = _embed(model, tokens, cfg, embeds, rt)
    x, aux, _ = _blocks(model, x, cfg, rt)
    return L.rms_norm(_whole_sequence(x, rt), model["final_norm"],
                      cfg.norm_eps), aux


def logits_fwd(model, tokens, cfg, rt, *, embeds=None):
    """:func:`forward` with autograd wherever the caller records it."""
    x, aux = _hidden(model, tokens, cfg, rt, embeds)
    return L.unembed(model["embed"], model.lm_head(), x, cfg), aux


@torch.no_grad()
def forward(model, tokens, cfg, rt, *, embeds=None):
    """tokens (B,S) int -> (logits (B,S',V) fp32, aux), S' = S plus the
    positions of ``embeds`` (B,P,D), which go ahead of the tokens."""
    with mesh_context(rt):
        return logits_fwd(model, tokens, cfg, rt, embeds=embeds)


# --------------------------------------------------------------------------
# training: losses
# --------------------------------------------------------------------------
def label_logits(logits, labels):
    """Each position's logit of its label: ``logits`` (B,S,V), ``labels``
    (B,S) int -> (B,S).  A DTensor's on each rank's own rows, under
    ``local_map`` on the logits' placements (their vocab whole): DTensor's
    own gather has a backward that makes a zero tensor of the global
    (B,S,V) shape on every rank."""
    from torch.distributed.tensor import DTensor
    idx = labels[..., None].long()
    if not isinstance(logits, DTensor):
        return torch.gather(logits, -1, idx)[..., 0]
    from torch.distributed.tensor.experimental import local_map
    pl = tuple(logits.placements)
    return local_map(lambda lg, i: torch.gather(lg, -1, i),
                     out_placements=list(pl), in_placements=(pl, pl),
                     device_mesh=logits.device_mesh,
                     redistribute_inputs=True)(logits, idx)[..., 0]


def cross_entropy(logits, labels, mask=None):
    """Mean token NLL in fp32. logits (B,S,V), labels (B,S) int."""
    lse = torch.logsumexp(logits.float(), dim=-1)
    ll = label_logits(logits, labels)
    nll = lse - ll.float()
    if mask is None:
        return nll.mean()
    m = mask.float()
    return (nll * m).sum() / m.sum().clamp_min(1.0)


def _xent_chunk(x, labels, mask, emb, head, cfg):
    """One chunk's summed NLL and its count of unmasked tokens."""
    logits = L.unembed(emb, head, x, cfg)
    lse = torch.logsumexp(logits.float(), dim=-1)
    ll = label_logits(logits, labels)
    m = mask.float()
    return ((lse - ll.float()) * m).sum(), m.sum()


def chunked_xent(x, model, labels, cfg, rt, mask=None):
    """Cross-entropy without materialising (B,S,V): the sequence in chunks
    of ``rt.loss_chunk`` positions, each chunk's logits recomputed in the
    backward (checkpointed), so peak logits memory is B·chunk·V, not
    B·S·V.  The JAX package pads S to a multiple of the chunk with masked
    positions; here the last chunk is shorter, which adds the same
    terms."""
    S = x.shape[1]
    c = rt.loss_chunk
    if mask is None:
        mask = torch.ones_like(labels, dtype=torch.bool)
    emb, head = model["embed"], model.lm_head()
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, c):
        t, n = L.checkpoint(
            lambda xi, li, mi: _xent_chunk(xi, li, mi, emb, head, cfg),
            x[:, c0:c0 + c], labels[:, c0:c0 + c], mask[:, c0:c0 + c])
        tot, cnt = tot + t, cnt + n
    return tot / cnt.clamp_min(1.0)


def nll_of(model, x, labels, cfg, rt, mask=None):
    """The NLL of final-normed hidden states x against labels: chunked
    where ``rt.loss_chunk`` is set, else over the full logits."""
    if rt.loss_chunk:
        return chunked_xent(x, model, labels, cfg, rt, mask)
    logits = L.unembed(model["embed"], model.lm_head(), x, cfg)
    return cross_entropy(logits, labels, mask)


def loss(model, batch, cfg, rt):
    """batch: {tokens (B,S), labels (B,S)[, mask]} -> (scalar, metrics
    {nll, aux}); the MoE's load-balance loss enters as
    ``aux_loss_coef·aux``."""
    with mesh_context(rt):
        x, aux = _hidden(model, batch["tokens"], cfg, rt)
        nll = nll_of(model, x, batch["labels"], cfg, rt, batch.get("mask"))
        return nll + cfg.aux_loss_coef * aux, {"nll": nll, "aux": aux}


# --------------------------------------------------------------------------
# serving: prefill + decode
# --------------------------------------------------------------------------
def init_cache(cfg, batch: int, max_len: int, rt, dtype=None,
               device="cuda"):
    """An empty KV cache on ``device`` (``cuda`` unless the caller asks
    for another): k and v (n_layers, batch, max_len, n_kv_heads,
    head_dim), len 0."""
    device = resolve_device(device, "init_cache")
    dtype = dtype or cfg.torch_dtype
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": 0}


@torch.no_grad()
def prefill(model, tokens, cfg, rt, *, embeds=None,
            max_len: int | None = None):
    """Run the prompt (``embeds`` ahead of the tokens), return
    (last-position logits, filled cache).

    ``max_len`` pads the KV cache's sequence axis so ``decode_step`` can
    append up to ``max_len - prompt_len`` generated tokens.  On a mesh the
    cache is the layers' keys and values stacked as DTensors
    (``launch/steps.py`` puts it on the cache's placements)."""
    with mesh_context(rt):
        x = _embed(model, tokens, cfg, embeds, rt)
        x, _, kvs = _blocks(model, x, cfg, rt, return_kv=True)
        x = L.rms_norm(_whole_sequence(x, rt), model["final_norm"],
                       cfg.norm_eps)
        logits = L.unembed(model["embed"], model.lm_head(), x[:, -1:, :],
                           cfg)
        n = max(x.shape[1], max_len or 0)
        cache = {name: stack_padded([kv[j] for kv in kvs], n)
                 for j, name in enumerate(("k", "v"))}   # (L, B, n, Hkv, hd)
        return logits, {**cache, "len": x.shape[1]}


def stack_padded(ts, n: int):
    """(B, S, ...) tensors stacked to (L, B, n, ...), zeros past S.  Plain
    tensors are copied into one buffer of that size; DTensors (which have
    no write into a slice) are stacked, then padded by a concatenation."""
    from torch.distributed.tensor import DTensor
    t0, S = ts[0], ts[0].shape[1]
    if not isinstance(t0, DTensor):
        out = t0.new_zeros((len(ts), t0.shape[0], n) + t0.shape[2:])
        for i, t in enumerate(ts):
            out[i, :, :S] = t
        return out
    t = torch.stack(ts)
    if n > S:
        z = torch.zeros(t.shape[:2] + (n - S,) + t.shape[3:], dtype=t.dtype,
                        device=t.device)
        t = torch.cat([t, z], dim=2)
    return t


@torch.no_grad()
def decode_step(model, cache, tokens, cfg, rt):
    """tokens (B,1) -> (logits (B,1,V), cache).  The cache's tensors are
    updated in place; the returned dict holds them with ``len`` + 1."""
    pos = cache["len"]
    with mesh_context(rt):
        x = L.embed_rows(model["embed"]["table"], tokens, rt)
        if cfg.pos_emb == "abs":
            x = x + model["embed"]["pos"][pos:pos + 1]
        x = rt.constrain(x, *rt.act_spec(3))
        for i, p in enumerate(model["layers"]):
            x, _, _ = block_decode(p, x, cfg, rt, cache["k"], cache["v"], pos,
                                   layer=i)
        x = L.rms_norm(x, model["final_norm"], cfg.norm_eps)
        logits = L.unembed(model["embed"], model.lm_head(), x, cfg)
    return logits, {"k": cache["k"], "v": cache["v"], "len": pos + 1}
