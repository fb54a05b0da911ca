"""Port of the JAX package's ``tpu/autoplan.py``, its one-device half:
plan-space DSE on one card (paper use case 3).

Where the FPGA DSE explores CE arrangements, the step model explores the
port's plans: remat grouping and the loss chunk.  The analytical cost
model ranks them in microseconds; the top plan can then be checked with
one timed step on the card (``chip_smoke.py`` phase 18 (d)), the paper's
fast-model-then-validate loop.  FSDP, sequence-sharded activations and the
expert-parallel dispatch have width 1 on one device, where they change
nothing the model computes; they come back with the mesh (``ROADMAP.md``
item 11).
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


def candidate_plans(cfg: ModelConfig, shape: ShapeSpec) -> list[ParallelPlan]:
    """A training cell's 15 plans (remat x loss chunk, in the JAX
    package's order); a serving cell's one default plan."""
    base = default_plan(cfg, shape)
    if shape.kind != "train":
        return [base]
    return [dataclasses.replace(
        base, remat=rm, remat_group=g, loss_chunk=ck,
        name=f"{cfg.name}:{shape.name}:g{g}-remat{int(rm)}-ck{ck}")
        for (rm, g), ck in itertools.product(REMAT_OPTS, CHUNK_OPTS)]


def rank(cfg: ModelConfig, shape: ShapeSpec,
         chip: ChipSpec = H100) -> list[RankedPlan]:
    """Evaluate every candidate plan analytically; feasible-first, fastest
    first."""
    out = [RankedPlan(p, estimate(cfg, shape, p, chip))
           for p in candidate_plans(cfg, shape)]
    out.sort(key=lambda r: (not r.est.fits, r.step_s))
    return out


def best_plan(cfg: ModelConfig, shape: ShapeSpec,
              chip: ChipSpec = H100) -> RankedPlan:
    return rank(cfg, shape, chip)[0]
