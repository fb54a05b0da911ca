"""Parallelism plans, their one-device half.

The PyTorch port of the JAX package's ``launch/plans.py``: a
:class:`ParallelPlan` holds how a step runs, and :func:`default_plan` is
the baseline plan of an (arch x shape) cell.  Here only the fields that
name no mesh axis are ported (remat, the loss chunk, the attention path,
accumulation, the optimizer's memory policy) with the JAX package's
defaults, and ``default_plan`` takes its branches for one device: a train
cell remats every layer (groups of 4 for stacks of 32 layers or more) and
chunks the loss by 512 positions; Kimi-K2's optimizer state is factored,
bf16 and momentum-free; a serving cell does neither remat nor loss chunks.
The mesh axes, FSDP, the expert-parallel MoE dispatch (one device runs
``local``), sequence-sharded activations and caches, and the sharding
rules wait for the mesh (``ROADMAP.md`` queue 1, item 11).
"""
from __future__ import annotations

from dataclasses import dataclass

from ..configs.base import ModelConfig, ShapeSpec
from ..models.runtime import Runtime


@dataclass(frozen=True)
class ParallelPlan:
    name: str = "default"
    remat: bool = True
    remat_group: int = 1                     # layers per remat block
    loss_chunk: int = 512
    attn_mode: str = "auto"
    accum: int = 1                           # gradient-accumulation steps
    # optimizer memory policy (per-plan: the 1T cell needs factored+bf16)
    opt_state_dtype: str = "float32"
    opt_factored: bool = False
    opt_momentum: bool = True

    def runtime(self) -> Runtime:
        """The port's ``Runtime`` for this plan, on one device."""
        return Runtime(attn_mode=self.attn_mode, remat=self.remat,
                       remat_group=self.remat_group,
                       loss_chunk=self.loss_chunk)


def default_plan(cfg: ModelConfig, shape: ShapeSpec) -> ParallelPlan:
    """Baseline one-device plan of an (arch x shape) cell."""
    kw: dict = dict(name=f"{cfg.name}:{shape.name}:baseline")
    if shape.kind == "train":
        if cfg.n_layers >= 32:
            kw.update(remat_group=4)                  # deep stacks
    else:
        kw.update(remat=False, loss_chunk=0)
    if cfg.name == "kimi-k2-1t-a32b":
        # 1T params: factored second moment, bf16 state, no momentum
        # buffer.  remat_group stays 1: grouped remat keeps g layers of
        # expert weights live in the group's backward
        kw.update(opt_factored=True, opt_state_dtype="bfloat16",
                  opt_momentum=False)
        if shape.kind == "train":
            kw.update(remat_group=1)
    return ParallelPlan(**kw)
