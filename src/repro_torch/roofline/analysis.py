"""Port of the JAX package's ``roofline/analysis.py``: roofline analysis
of walked steps on the H100.

For every (arch × shape × mesh) cell this derives, from a walk of one step
(``gpu.op_walk``, recorded in the JAX dry-run's JSON layout by
:func:`cell_record`):

    compute_s    = walked FLOPs per device / the bf16 tensor-core peak
    memory_s     = walked bytes per device / HBM bandwidth
    collective_s = collective wire bytes per device / (links × link bw)

plus MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE) and the MODEL/walk
ratio (remat and padding waste), the dominant term, and a one-line "what
would move it" recommendation.  ``compute_s`` prices every FLOP at the
bf16 peak, as the JAX package prices every FLOP at its MXU's;
:func:`dtype_bound_s` prices each dtype's FLOPs at the card's rate for it.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass

from ..configs import SHAPES, get_config
from ..configs.base import ShapeSpec
from ..gpu.chip import H100, ChipSpec
from ..gpu.op_stats import collective_stats
from ..gpu.op_walk import WalkCosts
from .constants import HBM_BW, LINK_BW, LINKS, PEAK_BF16

#: where phase 18 of ``chip_smoke.py`` writes its records (not committed)
ART_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "chiprun_out", "roofline")
#: where ``launch/dryrun.py`` writes its records (not committed)
DRYRUN_DIR = os.path.join(os.path.dirname(ART_DIR), "dryrun")
#: the mesh name and shape of a record of one card
ONE_CARD, ONE_CARD_SHAPE = "1xH100", {"gpu": 1}


def model_flops(arch: str, shape: str | ShapeSpec) -> float:
    """6·N·D with N = total (dense) or active (MoE) params, D = tokens
    processed per step; decode steps process global_batch tokens.
    ``shape`` is a name of ``SHAPES`` or a shape of its own (a cut one)."""
    cfg = get_config(arch)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    n = cfg.param_count(active_only=bool(cfg.n_experts))
    if shape.kind == "train":
        tokens, mult = shape.tokens, 6.0
    elif shape.kind == "prefill":
        tokens, mult = shape.tokens, 2.0
    else:
        tokens, mult = float(shape.global_batch), 2.0
    return mult * n * tokens


def dtype_bound_s(flops_by_dtype: dict, chip: ChipSpec = H100) -> float:
    """The least compute time of a walk's FLOPs, each dtype's at the card's
    rate for it: bf16 and f16 on the tensor cores, anything else at the
    f32 rate (TF32 stays off in the port)."""
    return sum(f / (chip.peak_flops_bf16 if dt in ("bfloat16", "float16")
                    else chip.peak_flops_f32)
               for dt, f in flops_by_dtype.items())


@dataclass
class CellRoofline:
    cell: str
    arch: str
    shape: str
    mesh: str
    n_dev: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    hlo_flops_per_dev: float     # the walk's FLOPs (the JAX field's name)
    useful_ratio: float          # MODEL / (walk × devices)
    peak_fraction: float         # compute_s / max(term)s — roofline fraction
    hbm_args_gib: float
    hbm_temp_gib: float
    recommendation: str

    def as_row(self) -> list:
        return [self.arch, self.shape, self.mesh,
                f"{self.compute_s*1e3:.1f}", f"{self.memory_s*1e3:.1f}",
                f"{self.collective_s*1e3:.1f}", self.dominant,
                f"{self.useful_ratio:.2f}", f"{self.peak_fraction:.2f}",
                f"{self.hbm_args_gib + self.hbm_temp_gib:.1f}"]


_RECS = {
    "compute": "compute-bound: keep the tensor cores fed (64-aligned "
               "tiles, bf16 products in place of f32 ones, larger "
               "per-card matmuls: widen the batch)",
    "memory": "HBM-bound: cut activation traffic (fused kernels in place "
              "of eager elementwise passes, fewer saved residuals, a "
              "fused optimizer) or shard reads wider",
    "collective": "NVLink-bound: reduce wire bytes (coarser FSDP gathers, "
                  "a2a instead of psum, gradient compression) or overlap "
                  "collectives with compute",
}


def cell_record(cell: str, arch: str, shape: str, kind: str,
                costs: WalkCosts, memory: dict, plan: dict | None = None,
                shape_cut: dict | None = None, mesh: str = ONE_CARD,
                mesh_shape: dict | None = None) -> dict:
    """One walked step as a record in the JAX dry-run's layout
    (``launch/dryrun.py``): ``costs`` a finished walk's ``OpWalk.costs()``
    (one device's), ``memory`` the dry-run's memory keys
    (``argument_size_in_bytes``, ``temp_size_in_bytes``, ...) as the card's
    allocator or the dry-run's count reported them, ``shape_cut`` the
    fields of ``SHAPES[shape]`` the cell changed (``seq_len``,
    ``global_batch``), ``mesh`` and ``mesh_shape`` ({axis: width}) the
    mesh's name and shape (one card unless given)."""
    rec = {"cell": cell, "arch": arch, "shape": shape, "mesh": mesh,
           "mesh_shape": dict(ONE_CARD_SHAPE if mesh_shape is None
                              else mesh_shape), "kind": kind, "plan": plan,
           "ok": True, "memory": dict(memory),
           "collectives": collective_stats(costs).as_dict(),
           "walk": costs.as_dict()}
    if shape_cut:
        rec["shape_cut"] = dict(shape_cut)
    return rec


def analyze_cell(rec: dict) -> CellRoofline:
    walk = rec["walk"]
    n_dev = 1
    for v in rec["mesh_shape"].values():
        n_dev *= v
    comp = walk["flops"] / PEAK_BF16
    mem = walk["bytes_accessed"] / HBM_BW
    coll = walk["total_wire_bytes"] / (LINK_BW * LINKS)
    terms = {"compute": comp, "memory": mem, "collective": coll}
    dom = max(terms, key=terms.get)
    shape = dataclasses.replace(SHAPES[rec["shape"]],
                                **rec.get("shape_cut", {}))
    mf = model_flops(rec["arch"], shape)
    useful = mf / max(walk["flops"] * n_dev, 1.0)
    peak_frac = comp / max(max(terms.values()), 1e-12)
    memo = rec.get("memory", {})
    return CellRoofline(
        cell=rec["cell"], arch=rec["arch"], shape=rec["shape"],
        mesh=rec["mesh"], n_dev=n_dev,
        compute_s=comp, memory_s=mem, collective_s=coll, dominant=dom,
        model_flops=mf, hlo_flops_per_dev=walk["flops"],
        useful_ratio=useful, peak_fraction=peak_frac,
        hbm_args_gib=memo.get("argument_size_in_bytes", 0) / 2**30,
        hbm_temp_gib=memo.get("temp_size_in_bytes", 0) / 2**30,
        recommendation=_RECS[dom],
    )


def load_artifacts(art_dir: str = DRYRUN_DIR, mesh: str | None = None
                   ) -> list[dict]:
    """The ``ok`` untagged records of ``art_dir`` (the dry-run's, or
    phase 18's ``ART_DIR``), of ``mesh`` where it is given."""
    recs = []
    if not os.path.isdir(art_dir):
        return recs
    for name in sorted(os.listdir(art_dir)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(art_dir, name)) as f:
            rec = json.load(f)
        if not rec.get("ok"):
            continue
        if mesh and rec.get("mesh") != mesh:
            continue
        if rec["cell"].count("__") > 2:
            continue  # tagged (hillclimb) records are reported separately
        recs.append(rec)
    return recs
