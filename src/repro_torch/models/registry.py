"""Uniform model API: ``get_model(cfg)`` returns a :class:`ModelApi`
wrapping the family module.

The PyTorch port of the JAX package's ``models/registry.py``, for every
family: dense and MoE (``transformer``), SSM and hybrid (``ssm_lm``),
enc-dec (``encdec``) and VLM (``vlm``), serving and training
(``loss(model, batch, rt) -> (loss, metrics)``).  ``input_specs``,
``cache_specs`` and ``param_specs`` are XLA dry-run helpers and wait for
``launch/``'s dry-runs (``ROADMAP.md`` queue 1, item 13).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..configs.base import ModelConfig
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
