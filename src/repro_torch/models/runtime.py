"""Runtime: how a model executes (orthogonal to ModelConfig).

The PyTorch port of the JAX package's ``models/runtime.py``, trimmed to
one device: ``ModelConfig`` says *what* the network is; ``Runtime`` says
which attention path prefill takes, how the MoE layer dispatches (on one
device: ``local``), the SSD scan's chunk, and for training the remat
policy and the loss chunk.  The mesh, the tensor- and expert-parallel
axes, the expert-parallel MoE dispatches and the other sharding fields
are not ported yet (``ROADMAP.md`` queue 1, item 11): a ``Runtime``
given a mesh, or ``moe_impl`` ``"ep"`` or ``"ep_a2a"``, raises.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

ATTN_MODES = ("dense", "chunked", "auto")
MOE_IMPLS = ("local", "ep", "ep_a2a")


@dataclass(frozen=True)
class Runtime:
    attn_mode: str = "auto"             # dense | chunked | auto
    mesh: Any = None                    # sharding: not ported yet
    moe_impl: str = "local"             # local (ep | ep_a2a: not ported yet)
    ssd_chunk: int = 256                # tokens a chunk of the SSD scan
    remat: bool = False                 # recompute each layer in backward
    remat_group: int = 1                # layers per remat block (g>1: save
                                        # only every g-th residual)
    loss_chunk: int = 0                 # 0 = unchunked cross-entropy

    def __post_init__(self):
        if self.attn_mode not in ATTN_MODES:
            raise ValueError(f"attn_mode must be one of {ATTN_MODES}, got "
                             f"{self.attn_mode!r}")
        if self.moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl must be one of {MOE_IMPLS}, got "
                             f"{self.moe_impl!r}")
        if self.ssd_chunk < 1:
            raise ValueError(f"ssd_chunk must be >= 1, got {self.ssd_chunk}")
        if self.remat_group < 1:
            raise ValueError(f"remat_group must be >= 1, got "
                             f"{self.remat_group}")
        if self.loss_chunk < 0:
            raise ValueError(f"loss_chunk must be >= 0, got "
                             f"{self.loss_chunk}")
        if self.mesh is not None:
            raise NotImplementedError(
                "Runtime(mesh=...): sharded execution is not ported yet "
                "(ROADMAP.md queue 1, item 11)")
        if self.moe_impl != "local":
            raise NotImplementedError(
                f"Runtime(moe_impl={self.moe_impl!r}): the expert-parallel "
                f"MoE dispatch is not ported yet (ROADMAP.md queue 1, item "
                f"11)")


def resolve_device(device, who: str) -> torch.device:
    """``device`` as a ``torch.device``.  The LM path's entry points take
    ``"cuda"`` unless the caller passes another device, and ``cuda``
    without a visible card raises rather than run on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}(device={str(dev)!r}) needs a visible CUDA card and none "
            f"is available; pass device='cpu' to run the plain PyTorch path "
            f"on the CPU")
    return dev
