"""InternVL2-style VLM: stubbed ViT frontend + LM backbone.

The PyTorch port of the JAX package's ``models/vlm.py``.  The vision
frontend is a stub: the caller hands *precomputed patch embeddings*
(B, n_patches, frontend_dim), and a learned projector maps them into the
backbone's embedding space, ahead of the text tokens.  The backbone is
``models/transformer.py``'s; its cache holds the patches' positions and
the text's.  ``loss`` is the cross-entropy of the text positions' logits,
past the patches.

``prefill``'s ``max_len`` counts text positions, as ``ServeEngine`` passes
it (prompt + new tokens + 1), and the cache adds the P patch positions.
The JAX package passes ``max_len`` through unchanged, so its engine's VLM
cache is P positions short and ``dynamic_update_slice`` clamps the last
steps' writes onto its last slot (``ROADMAP.md`` queue 3).
"""
from __future__ import annotations

import torch

from . import layers as L
from . import transformer as T


@torch.no_grad()
def init(gen: torch.Generator, cfg) -> T.TransformerLM:
    model = T.init(gen, cfg)
    model["projector"] = L.Params(
        w=L._dense_init(gen, (cfg.frontend_dim, cfg.d_model),
                        cfg.torch_dtype),
        b=torch.zeros(cfg.d_model, dtype=cfg.torch_dtype, device=gen.device))
    return model


def _project(model, patches, cfg):
    p = model["projector"]
    return patches.to(cfg.torch_dtype) @ p["w"] + p["b"]


@torch.no_grad()
def forward(model, batch, cfg, rt):
    """batch {patches (B,P,F), tokens (B,S)} -> (logits (B,P+S,V), aux)."""
    return T.forward(model, batch["tokens"], cfg, rt,
                     embeds=_project(model, batch["patches"], cfg))


def loss(model, batch, cfg, rt):
    """batch: {patches (B,P,F), tokens (B,S_text), labels (B,S_text)
    [, mask]} -> (nll + aux_loss_coef·aux, metrics {nll, aux})."""
    logits, aux = T.logits_fwd(model, batch["tokens"], cfg, rt,
                               embeds=_project(model, batch["patches"], cfg))
    nll = T.cross_entropy(logits[:, batch["patches"].shape[1]:],
                          batch["labels"], batch.get("mask"))
    return nll + cfg.aux_loss_coef * aux, {"nll": nll, "aux": aux}


def init_cache(cfg, batch: int, max_len: int, rt, dtype=None,
               device="cuda"):
    return T.init_cache(cfg, batch, max_len, rt, dtype, device)


@torch.no_grad()
def prefill(model, batch, cfg, rt, *, max_len: int | None = None):
    """batch {patches (B,P,F), tokens (B,S)} -> (last logits, cache of
    P + max(S, max_len) positions)."""
    P = batch["patches"].shape[1]
    return T.prefill(model, batch["tokens"], cfg, rt,
                     embeds=_project(model, batch["patches"], cfg),
                     max_len=None if max_len is None else max_len + P)


def decode_step(model, cache, tokens, cfg, rt):
    return T.decode_step(model, cache, tokens, cfg, rt)
