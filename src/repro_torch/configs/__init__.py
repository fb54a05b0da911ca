"""Config registry: ``--arch <id>`` -> ModelConfig; assigned shape cells."""
from __future__ import annotations

from .base import SHAPES, ModelConfig, ShapeSpec, smoke_shape
from .qwen1_5_0_5b import CONFIG as _qwen15
from .llama3_2_1b import CONFIG as _llama32
from .qwen2_5_32b import CONFIG as _qwen25
from .h2o_danube_1_8b import CONFIG as _danube
from .whisper_base import CONFIG as _whisper
from .internvl2_2b import CONFIG as _internvl
from .granite_moe_1b_a400m import CONFIG as _granite
from .kimi_k2_1t_a32b import CONFIG as _kimi
from .mamba2_370m import CONFIG as _mamba2
from .zamba2_1_2b import CONFIG as _zamba2

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (_qwen15, _llama32, _qwen25, _danube, _whisper,
              _internvl, _granite, _kimi, _mamba2, _zamba2)
}

ARCH_NAMES = tuple(ARCHS)

# Sub-quadratic decode support: SSM/hybrid state is O(1) in context; SWA caps
# the KV window. Pure full-attention archs skip long_500k (see DESIGN.md).
SUBQUADRATIC = ("h2o-danube-1.8b", "mamba2-370m", "zamba2-1.2b")


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def cells(include_skipped: bool = False):
    """All assigned (arch × shape) cells; skipped ones flagged."""
    out = []
    for arch in ARCH_NAMES:
        for shape in SHAPES.values():
            skip = (shape.name == "long_500k" and arch not in SUBQUADRATIC)
            if include_skipped or not skip:
                out.append((arch, shape.name, skip))
    return out


__all__ = ["ARCHS", "ARCH_NAMES", "SHAPES", "SUBQUADRATIC", "ModelConfig",
           "ShapeSpec", "cells", "get_config", "smoke_shape"]
