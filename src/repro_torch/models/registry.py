"""Uniform model API: ``get_model(cfg)`` returns a :class:`ModelApi`
wrapping the family module.

The PyTorch port of the JAX package's ``models/registry.py``, dense family
only; the other families raise.  ``input_specs``, ``cache_specs`` and
``param_specs`` are XLA dry-run helpers and wait for ``launch/``'s dry-run
(``ROADMAP.md`` queue 1, item 13).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from ..configs.base import ModelConfig
from . import transformer


@dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init: Callable
    init_cache: Callable
    prefill: Callable
    decode_step: Callable
    forward: Callable


def get_model(cfg: ModelConfig) -> ModelApi:
    transformer._dense_only(cfg)
    m = transformer

    def _prefill(model, batch, rt, **kw):
        inp = batch["tokens"] if isinstance(batch, dict) else batch
        return m.prefill(model, inp, cfg, rt, **kw)

    return ModelApi(
        cfg=cfg,
        init=lambda gen: m.init(gen, cfg),
        init_cache=lambda batch, max_len, rt, **kw: m.init_cache(
            cfg, batch, max_len, rt, **kw),
        prefill=_prefill,
        decode_step=lambda model, cache, tokens, rt: m.decode_step(
            model, cache, tokens, cfg, rt),
        forward=lambda model, tokens, rt: m.forward(model, tokens, cfg, rt),
    )
