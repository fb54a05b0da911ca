"""Port of the JAX package's ``tpu/autoplan.py``: plan-space DSE (paper
use case 3).

Where the FPGA DSE explores CE arrangements, the step model explores the
port's plans.  On a mesh the JAX package's space: FSDP on or off,
sequence-sharded activations, remat grouping, the MoE dispatch (``ep_a2a``
or ``ep``) and the loss chunk for a training cell; FSDP and the MoE
dispatch for a serving cell.  On one card (no mesh), where FSDP,
sequence sharding and the expert-parallel dispatch have width 1 and change
nothing the model computes, remat grouping and the loss chunk.  The
analytical cost model ranks them in microseconds; the top plan can then be
checked with one timed step on the card (``chip_smoke.py`` phase 18 (d)),
the paper's fast-model-then-validate loop.
"""
from __future__ import annotations

import dataclasses
import itertools
from dataclasses import dataclass

from ..configs.base import ModelConfig, ShapeSpec
from ..launch.plans import ParallelPlan, default_plan
from .chip import H100, ChipSpec
from .cost_model import CostEstimate, estimate

#: (remat, remat_group) and loss-chunk choices of a training cell
REMAT_OPTS = ((True, 1), (True, 2), (True, 4), (True, 8), (False, 1))
CHUNK_OPTS = (0, 512, 2048)
#: activation-sharding choices of a training cell on a mesh
ACT_OPTS = ("none", "seq")


@dataclass
class RankedPlan:
    plan: ParallelPlan
    est: CostEstimate

    @property
    def step_s(self) -> float:
        """Serial roofline bound: max of the three terms (perfect overlap
        would approach this; summing is the no-overlap bound)."""
        return max(self.est.compute_s, self.est.memory_s,
                   self.est.collective_s)


def candidate_plans(cfg: ModelConfig, shape: ShapeSpec,
                    mesh=None) -> list[ParallelPlan]:
    """The plans of a cell, in the JAX package's order: on a mesh, a
    training cell's FSDP x activation sharding x remat x MoE dispatch x
    loss chunk and a serving cell's FSDP x MoE dispatch; on one card a
    training cell's 15 (remat x loss chunk) and a serving cell's one
    default plan."""
    base = default_plan(cfg, shape, mesh)
    if mesh is None:
        if shape.kind != "train":
            return [base]
        return [dataclasses.replace(
            base, remat=rm, remat_group=g, loss_chunk=ck,
            name=f"{cfg.name}:{shape.name}:g{g}-remat{int(rm)}-ck{ck}")
            for (rm, g), ck in itertools.product(REMAT_OPTS, CHUNK_OPTS)]
    moe_opts = ["ep_a2a", "ep"] if cfg.n_experts else [base.moe_impl]
    fsdp_opts = [(), tuple(base.dp_axes)]
    if shape.kind != "train":
        return [dataclasses.replace(
            base, fsdp_axes=fsdp, moe_impl=moe,
            name=f"{cfg.name}:{shape.name}:fsdp{len(fsdp)}-{moe}")
            for fsdp, moe in itertools.product(fsdp_opts, moe_opts)]
    return [dataclasses.replace(
        base, fsdp_axes=fsdp, act_shard=act, remat=rm, remat_group=g,
        moe_impl=moe, loss_chunk=ck,
        name=f"{cfg.name}:{shape.name}:fsdp{len(fsdp)}-{act}-g{g}"
             f"-{moe}-ck{ck}")
        for fsdp, act, (rm, g), moe, ck in itertools.product(
            fsdp_opts, ACT_OPTS, REMAT_OPTS, moe_opts, CHUNK_OPTS)]


def rank(cfg: ModelConfig, shape: ShapeSpec, chip: ChipSpec = H100, *,
         mesh=None) -> list[RankedPlan]:
    """Evaluate every candidate plan analytically; feasible-first, fastest
    first."""
    out = [RankedPlan(p, estimate(cfg, shape, p, chip, mesh=mesh))
           for p in candidate_plans(cfg, shape, mesh)]
    out.sort(key=lambda r: (not r.est.fits, r.step_s))
    return out


def best_plan(cfg: ModelConfig, shape: ShapeSpec, chip: ChipSpec = H100, *,
              mesh=None) -> RankedPlan:
    return rank(cfg, shape, chip, mesh=mesh)[0]
