"""Mamba2 LM (attention-free) and Zamba2-style hybrid LM, for inference.

The PyTorch port of the JAX package's ``models/ssm_lm.py``.  Zamba2
layout: ``n_layers`` Mamba2 blocks; after every ``attn_every``-th block
one *shared* (weight-tied) attention+MLP block is applied.  The JAX
package scans the stack in groups; here the model holds ``groups``, an
``nn.ModuleList`` of ``g`` groups of ``attn_every`` blocks, walked by
Python loops, the one ``shared`` block, and the ``tail`` blocks that fill
no group (``models/convert.py`` unstacks the JAX package's doubly
stacked params into it).  The attention-free Mamba2 LM has no groups: all
its blocks are the tail.

API (used by ``models/registry.py``): ``init``, ``forward``,
``init_cache``, ``prefill`` and ``decode_step``, as
``models/transformer.py``, and ``loss``, which runs the backbone with
autograd under the runtime's remat, as the JAX package's ``_backbone``:
each Mamba block checkpointed, and each group (its blocks and the shared
block) checkpointed around them; the tail by groups of ``remat_group``
blocks where that divides it, else block by block.

On a mesh (``rt.mesh``) the mixers run in ``models/ssm.py``'s regions,
the shared block's attention in ``layers.attention_region`` and its
decode step in ``layers.decode_region`` on the stacked ``shared_k`` /
``shared_v`` caches, the embedding in ``layers.embed_rows``; the residual
stream is constrained to ``rt.act_spec(3)`` where the JAX package
constrains it (after the embedding and after the shared block).
"""
from __future__ import annotations

import torch
from torch import nn

from . import layers as L
from . import transformer as T
from .runtime import resolve_device
from .ssm import init_mamba, init_mamba_cache, mamba_fwd, mamba_step


class SSMLM(nn.ModuleDict):
    """embed, final_norm, [groups, shared,] [tail,] [head]."""

    def lm_head(self) -> L.Params | None:
        return L.lm_head(self)


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------
def init_mamba_block(gen: torch.Generator, cfg) -> nn.ModuleDict:
    return nn.ModuleDict({"ln": L.init_rmsnorm(gen, cfg.d_model,
                                               cfg.torch_dtype),
                          "mixer": init_mamba(gen, cfg)})


def mamba_block_fwd(p, x, cfg, rt):
    return rt.residual(x, mamba_fwd(p["mixer"], L.rms_norm(
        x, p["ln"], cfg.norm_eps), cfg, chunk=rt.ssd_chunk, rt=rt))


def init_shared_attn_block(gen: torch.Generator, cfg) -> nn.ModuleDict:
    return nn.ModuleDict({
        "ln1": L.init_rmsnorm(gen, cfg.d_model, cfg.torch_dtype),
        "attn": L.init_attention(gen, cfg),
        "ln2": L.init_rmsnorm(gen, cfg.d_model, cfg.torch_dtype),
        "mlp": L.init_mlp(gen, cfg)})


def _shared_mlp(p, x, cfg, rt):
    return rt.residual(x, L.mlp_fwd(p["mlp"], L.rms_norm(x, p["ln2"],
                                                         cfg.norm_eps), cfg))


def shared_attn_fwd(p, x, cfg, rt, *, return_kv: bool = False):
    """The shared block on x; with ``return_kv`` also its roped keys and
    values for the KV cache."""
    out = L.attention_fwd(p["attn"], L.rms_norm(x, p["ln1"], cfg.norm_eps),
                          cfg, mode=rt.attn_mode, return_kv=return_kv, rt=rt)
    att, kv = (out[0], out[1:]) if return_kv else (out, None)
    x = rt.constrain(_shared_mlp(p, rt.residual(x, att), cfg, rt),
                     *rt.act_spec(3))
    return (x, kv) if return_kv else x


def _group_split(cfg) -> tuple[int, int]:
    """(#full groups, #tail layers) for the hybrid layout."""
    if not cfg.attn_every:
        return 0, cfg.n_layers
    g = cfg.n_layers // cfg.attn_every
    return g, cfg.n_layers - g * cfg.attn_every


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------
@torch.no_grad()
def init(gen: torch.Generator, cfg) -> SSMLM:
    """Random weights from ``gen``, on ``gen``'s device, in ``cfg.dtype``
    (``A_log``, ``dt_bias`` and ``D`` f32).  The JAX package's draws
    differ: carry its params across with ``models/convert.py``."""
    mods = {"embed": L.init_embedding(gen, cfg),
            "final_norm": L.init_rmsnorm(gen, cfg.d_model, cfg.torch_dtype)}
    g, tail = _group_split(cfg)
    if g:
        mods["groups"] = nn.ModuleList(
            nn.ModuleList(init_mamba_block(gen, cfg)
                          for _ in range(cfg.attn_every)) for _ in range(g))
        mods["shared"] = init_shared_attn_block(gen, cfg)
    if tail:
        mods["tail"] = nn.ModuleList(init_mamba_block(gen, cfg)
                                     for _ in range(tail))
    head = L.init_lm_head(gen, cfg)
    if head is not None:
        mods["head"] = head
    return SSMLM(mods)


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------
def _backbone(model, x, cfg, rt):
    def mamba(blk, x):
        return mamba_block_fwd(blk, x, cfg, rt)

    def group_fwd(group, x):
        return shared_attn_fwd(model["shared"],
                               L.run_layers(group, mamba, x, rt.remat),
                               cfg, rt)

    if "groups" in model:
        x = L.run_layers(model["groups"], group_fwd, x, rt.remat)
    if "tail" in model:
        # grouped where the group divides the tail, else a block at a time
        n, g = len(model["tail"]), rt.remat_group
        x = L.run_layers(model["tail"], mamba, x, rt.remat,
                         g if n % g == 0 else 1)
    return x


def _hidden(model, tokens, cfg, rt, embeds=None):
    x = T._embed(model, tokens, cfg, embeds, rt)
    return L.rms_norm(_backbone(model, x, cfg, rt), model["final_norm"],
                      cfg.norm_eps)


@torch.no_grad()
def forward(model, tokens, cfg, rt, *, embeds=None):
    """tokens (B,S) int -> (logits (B,S',V) fp32, aux = 0), ``embeds``
    (B,P,D) ahead of the tokens."""
    with T.mesh_context(rt):
        x = _hidden(model, tokens, cfg, rt, embeds)
        return (L.unembed(model["embed"], model.lm_head(), x, cfg),
                torch.zeros((), dtype=torch.float32, device=x.device))


def loss(model, batch, cfg, rt):
    """batch: {tokens (B,S), labels (B,S)[, mask]} -> (nll, metrics
    {nll, aux = 0}); the NLL chunked where ``rt.loss_chunk`` is set."""
    with T.mesh_context(rt):
        x = _hidden(model, batch["tokens"], cfg, rt)
        nll = T.nll_of(model, x, batch["labels"], cfg, rt,
                       batch.get("mask"))
        return nll, {"nll": nll,
                     "aux": torch.zeros((), dtype=torch.float32,
                                        device=x.device)}


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------
def init_cache(cfg, batch: int, max_len: int, rt, dtype=None,
               device="cuda"):
    """An empty cache on ``device`` (``cuda`` unless the caller asks for
    another), in the JAX package's layout: per Mamba block the last K-1
    pre-conv activations (in ``dtype``) and the (H, P, N) state (f32),
    stacked (g, attn_every, ...) under ``groups`` and (tail, ...) under
    ``tail``; the shared block's keys and values, one KV cache a call,
    (g, batch, max_len, n_kv_heads, head_dim); len 0."""
    device = resolve_device(device, "init_cache")
    dtype = dtype or cfg.torch_dtype
    g, tail = _group_split(cfg)
    one = init_mamba_cache(cfg, batch, dtype, device)
    cache = {"len": 0}
    if g:
        cache["groups"] = {k: a.new_zeros((g, cfg.attn_every) + a.shape)
                           for k, a in one.items()}
        shape = (g, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        cache["shared_k"] = torch.zeros(shape, dtype=dtype, device=device)
        cache["shared_v"] = torch.zeros(shape, dtype=dtype, device=device)
    if tail:
        cache["tail"] = {k: a.new_zeros((tail,) + a.shape)
                         for k, a in one.items()}
    return cache


def _step_blocks(blocks, x, states, cfg, rt, index=()):
    """Each block's recurrent step in turn; its new state is written into
    ``states`` (the stacked cache tensors, the blocks' own at ``index``)
    in place."""
    for j, blk in enumerate(blocks):
        h = L.rms_norm(x, blk["ln"], cfg.norm_eps)
        y, _ = mamba_step(blk["mixer"], h, states, cfg, rt, index + (j,))
        x = x + y
    return x


@torch.no_grad()
def decode_step(model, cache, tokens, cfg, rt):
    """tokens (B,1) -> (logits (B,1,V), cache).  O(1) state for the Mamba
    blocks; the shared attention block reads its KV cache of that call.
    The cache's tensors are updated in place; the returned dict holds them
    with ``len`` + 1."""
    pos = cache["len"]
    with T.mesh_context(rt):
        x = rt.constrain(L.embed_rows(model["embed"]["table"], tokens, rt),
                         *rt.act_spec(3))
        if "groups" in model:
            sp = model["shared"]
            for gi, group in enumerate(model["groups"]):
                x = _step_blocks(group, x, cache["groups"], cfg, rt, (gi,))
                h = L.rms_norm(x, sp["ln1"], cfg.norm_eps)
                att, _, _ = L.attention_decode(
                    sp["attn"], h, cfg, cache["shared_k"], cache["shared_v"],
                    pos, rt=rt, layer=gi)
                x = rt.constrain(_shared_mlp(sp, x + att, cfg, rt),
                                 *rt.act_spec(3))
        if "tail" in model:
            x = _step_blocks(model["tail"], x, cache["tail"], cfg, rt)
        x = L.rms_norm(x, model["final_norm"], cfg.norm_eps)
        logits = L.unembed(model["embed"], model.lm_head(), x, cfg)
    return logits, {**cache, "len": pos + 1}


def _prefill_blocks(blocks, x, cfg, rt):
    """Each block on the prompt; its decode state, stacked."""
    states = []
    for blk in blocks:
        h = L.rms_norm(x, blk["ln"], cfg.norm_eps)
        y, st = mamba_fwd(blk["mixer"], h, cfg, chunk=rt.ssd_chunk,
                          return_state=True, rt=rt)
        x = x + y
        states.append(st)
    return x, {k: torch.stack([st[k] for st in states]) for k in states[0]}


@torch.no_grad()
def prefill(model, tokens, cfg, rt, *, max_len: int | None = None):
    """Prompt pass -> (last logits, cache).  The chunked SSD gives each
    block's final recurrent state and the conv cache is the last K-1
    pre-conv activations, so the cache is exact.  The shared block's
    attention is chunked past 2048 tokens under ``auto``.  On a mesh the
    cache's leaves are DTensors as the blocks leave them
    (``launch/steps.py::build_prefill`` places them)."""
    B, S = tokens.shape
    cache = {"len": S}
    with T.mesh_context(rt):
        x = T._embed(model, tokens, cfg, None, rt)
        if "groups" in model:
            sts, ks, vs = [], [], []
            for group in model["groups"]:
                x, st = _prefill_blocks(group, x, cfg, rt)
                x, (k, v) = shared_attn_fwd(model["shared"], x, cfg, rt,
                                            return_kv=True)
                sts.append(st)
                ks.append(k)
                vs.append(v)
            cache["groups"] = {k: torch.stack([st[k] for st in sts])
                               for k in sts[0]}
            n = max(S, max_len or 0)
            cache["shared_k"] = T.stack_padded(ks, n)
            cache["shared_v"] = T.stack_padded(vs, n)
        if "tail" in model:
            x, cache["tail"] = _prefill_blocks(model["tail"], x, cfg, rt)
        x = L.rms_norm(x, model["final_norm"], cfg.norm_eps)
        logits = L.unembed(model["embed"], model.lm_head(), x[:, -1:], cfg)
    return logits, cache
