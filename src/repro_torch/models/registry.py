"""Uniform model API: ``get_model(cfg)`` returns a :class:`ModelApi`
wrapping the family module.

The PyTorch port of the JAX package's ``models/registry.py``, for every
family: dense and MoE (``transformer``), SSM and hybrid (``ssm_lm``),
enc-dec (``encdec``) and VLM (``vlm``), serving and training
(``loss(model, batch, rt) -> (loss, metrics)``), on one device or on a
mesh.

``input_specs``, ``cache_specs`` and ``param_specs`` are the JAX
package's ``ShapeDtypeStruct`` stand-ins as ``meta``-device tensors: the
shapes and dtypes of a step's inputs, of the decode cache and of the
parameters (keyed by the port's parameter names), with nothing allocated;
``meta_model`` is a model built of ``param_specs``' tensors.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from ..configs.base import ModelConfig, ShapeSpec
from . import encdec, ssm_lm, transformer, vlm

#: the module of each family
FAMILIES = {"dense": transformer, "moe": transformer, "ssm": ssm_lm,
            "hybrid": ssm_lm, "encdec": encdec, "vlm": vlm}
#: the families whose prefill takes the token array alone; enc-dec and VLM
#: take the batch dict (their frontend stub inputs too)
TOKEN_ONLY = ("dense", "moe", "ssm", "hybrid")


@dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init: Callable
    loss: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable
    forward: Callable | None = None


def get_model(cfg: ModelConfig) -> ModelApi:
    try:
        m = FAMILIES[cfg.family]
    except KeyError:
        raise KeyError(f"unknown family {cfg.family!r}") from None
    tok_only = cfg.family in TOKEN_ONLY

    def _prefill(model, batch, rt, **kw):
        inp = batch["tokens"] if (tok_only and isinstance(batch, dict)) \
            else batch
        return m.prefill(model, inp, cfg, rt, **kw)

    return ModelApi(
        cfg=cfg,
        init=lambda gen: m.init(gen, cfg),
        loss=lambda model, batch, rt: m.loss(model, batch, cfg, rt),
        init_cache=lambda batch, max_len, rt, **kw: m.init_cache(
            cfg, batch, max_len, rt, **kw),
        prefill=_prefill,
        decode_step=lambda model, cache, tokens, rt: m.decode_step(
            model, cache, tokens, cfg, rt),
        forward=(lambda model, tokens, rt, **kw: m.forward(
            model, tokens, cfg, rt, **kw))
        if hasattr(m, "forward") else None,
    )


# --------------------------------------------------------------------------
# input, cache and parameter specs (meta tensors) per shape cell
# --------------------------------------------------------------------------
def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Batch-input stand-ins for the step of this cell: train -> the
    loss's batch; prefill -> prefill's inputs; decode -> the token (the
    cache from :func:`cache_specs`)."""
    B, S = shape.global_batch, shape.seq_len
    i32, dt = torch.int32, cfg.torch_dtype
    if cfg.family == "encdec":
        S_dec = max(S // cfg.dec_ratio, 8)
        if shape.kind == "train":
            return {"frames": _meta((B, S, cfg.frontend_dim), dt),
                    "tokens": _meta((B, S_dec), i32),
                    "labels": _meta((B, S_dec), i32)}
        if shape.kind == "prefill":
            return {"frames": _meta((B, S, cfg.frontend_dim), dt),
                    "tokens": _meta((B, S_dec), i32)}
        return {"tokens": _meta((B, 1), i32)}
    if cfg.family == "vlm":
        P = cfg.n_patches
        S_text = max(S - P, 8)
        if shape.kind == "train":
            return {"patches": _meta((B, P, cfg.frontend_dim), dt),
                    "tokens": _meta((B, S_text), i32),
                    "labels": _meta((B, S_text), i32)}
        if shape.kind == "prefill":
            return {"patches": _meta((B, P, cfg.frontend_dim), dt),
                    "tokens": _meta((B, S_text), i32)}
        return {"tokens": _meta((B, 1), i32)}
    if shape.kind == "train":
        return {"tokens": _meta((B, S), i32), "labels": _meta((B, S), i32)}
    if shape.kind == "prefill":
        return {"tokens": _meta((B, S), i32)}
    return {"tokens": _meta((B, 1), i32)}


def cache_specs(cfg: ModelConfig, shape: ShapeSpec, rt=None) -> dict:
    """The decode cache of this cell as meta tensors (``len`` 0)."""
    m = FAMILIES[cfg.family]
    B, S = shape.global_batch, shape.seq_len
    kw = {}
    if cfg.family == "encdec":
        kw["enc_len"] = S
        max_len = max(S // cfg.dec_ratio, 8) + 8
    else:
        max_len = S
    return m.init_cache(cfg, B, max_len, rt, device="meta", **kw)


def param_specs(cfg: ModelConfig) -> dict:
    """{port parameter name: meta tensor} of ``cfg``'s model: the JAX
    layout's leaves (``models/convert.py::param_shapes``) unstacked into
    the port's names, a layer each (``layers.3.attn.wq``,
    ``groups.1.0.mixer.in_proj``)."""
    from .convert import param_shapes
    lead = {"layers": 1, "enc_layers": 1, "dec_layers": 1, "tail": 1,
            "groups": 2}
    out = {}
    for path, shp in _shape_leaves(param_shapes(cfg)):
        parts = path.split("/")
        n = lead.get(parts[0], 0)
        stack, leaf = shp[:n], shp[n:]
        dt = torch.float32 if path.endswith(_F32_LEAVES) else cfg.torch_dtype
        for idx in _indices(stack):
            name = ".".join([parts[0], *map(str, idx), *parts[1:]])
            out[name] = _meta(leaf, dt)
    return out


def meta_model(cfg: ModelConfig):
    """``cfg``'s model with :func:`param_specs`' ``meta`` tensors as its
    parameters (requiring no gradient, as ``init`` makes them): the same
    modules and names as ``get_model(cfg).init``'s, with nothing drawn or
    allocated (the dry-run's model, at any width)."""
    from torch import nn

    from .layers import Params
    from .transformer import Block, TransformerLM
    tree: dict = {}
    for name, t in param_specs(cfg).items():
        *head, last = name.split(".")
        node = tree
        for h in head:
            node = node.setdefault(h, {})
        node[last] = t

    def build(node: dict, path: tuple):
        if any(isinstance(v, torch.Tensor) for v in node.values()):
            return Params(**{k: v if isinstance(v, torch.Tensor)
                             else build(v, path + (k,))
                             for k, v in node.items()})
        if all(k.isdigit() for k in node):
            return nn.ModuleList(build(node[str(i)], path + (str(i),))
                                 for i in range(len(node)))
        kids = {k: build(v, path + (k,)) for k, v in node.items()}
        return Block(kids) if path[:1] == ("layers",) and len(path) == 2 \
            else nn.ModuleDict(kids)
    # init's order of the top-level modules
    order = ("adapter", "enc_pos", "embed", "layers", "enc_layers",
             "enc_norm", "dec_layers", "final_norm", "groups", "shared",
             "tail", "head", "projector")
    top = {k: tree[k] if isinstance(tree[k], torch.Tensor)
           else build(tree[k], (k,)) for k in order if k in tree}
    if cfg.family in ("ssm", "hybrid"):
        return ssm_lm.SSMLM(top)
    if cfg.family == "encdec":
        return encdec.EncDecLM(**top)
    return TransformerLM(top)


#: the parameters the JAX package keeps in f32 whatever the config's dtype
_F32_LEAVES = ("moe/router", "mixer/A_log", "mixer/dt_bias", "mixer/D")


def _shape_leaves(tree: dict, prefix: str = ""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _shape_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tuple(v)


def _indices(stack: tuple):
    if not stack:
        yield ()
        return
    for i in range(stack[0]):
        for rest in _indices(stack[1:]):
            yield (i, *rest)
