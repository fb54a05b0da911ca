"""Step-model plan exploration on the PyTorch port (the paper's DSE,
hardware-adapted): rank parallelism plans for an assigned (arch × shape)
cell analytically, in milliseconds — then the top plan is what the
dry-run verifies on the production mesh.  The twin of
``examples/autoplan_tpu.py``.

    PYTHONPATH=src python examples/torch/autoplan_gpu.py --arch qwen2.5-32b
    PYTHONPATH=src python examples/torch/autoplan_gpu.py --device cpu

The numbers are the H100 model's (``repro_torch.gpu.chip.H100``: NVIDIA's
data-sheet rates of an H100 SXM at its 700 W limit, on a 16 × 16 mesh of
such cards), not a TPU's and not a measurement: a step time here is the
model's bound.  The ranking runs on the host.  With ``--device cuda``
(the default) the model takes the visible card's SM count and memory
size, so ``fits`` answers for that card, and it raises without a card;
``--device cpu`` ranks on the data-sheet H100.
"""
import argparse
import dataclasses
import sys
import time

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.gpu.autoplan import rank
from repro_torch.gpu.chip import H100


class MeshView:     # mesh *shape* is all the analytical model needs
    def __init__(self, shape):
        self.shape = shape


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-32b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    chip = H100
    if args.device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("autoplan_gpu --device cuda needs a visible "
                               "CUDA card; pass --device cpu to rank on "
                               "the data-sheet H100")
        props = torch.cuda.get_device_properties(0)
        chip = dataclasses.replace(H100, sms=props.multi_processor_count,
                                   hbm_capacity=props.total_memory)
    table(args.arch, args.shape, chip)
    return 0


def table(arch: str, shape_name: str, chip, mesh_shape=None) -> list:
    """Rank the cell's plans on ``chip`` over a mesh of ``mesh_shape``
    (default 16 × 16), print the eight best and the best-to-worst ratio,
    and return the ranking."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = MeshView(mesh_shape or {"data": 16, "model": 16})

    t0 = time.time()
    ranked = rank(cfg, shape, chip, mesh=mesh)
    dt = time.time() - t0
    print(f"{arch} × {shape_name} on 16×16 {chip.name}: ranked "
          f"{len(ranked)} plans in {dt*1e3:.1f} ms "
          f"({dt/len(ranked)*1e6:.0f} µs/plan)\n")

    print(f"{'plan':52s} {'step':>8s} {'dominant':>10s} {'HBM':>7s} fits")
    for r in ranked[:8]:
        e = r.est
        print(f"{r.plan.name[:52]:52s} {r.step_s*1e3:6.1f}ms "
              f"{e.dominant():>10s} {e.hbm_capacity_bytes/2**30:5.1f}GB "
              f"{'✓' if e.fits else '✗'}")
    worst = ranked[-1]
    best = ranked[0]
    print(f"\nbest plan is {worst.step_s/best.step_s:.1f}× faster than the "
          f"worst candidate — arrangement choice matters (the paper's "
          f"thesis).")
    return ranked


if __name__ == "__main__":
    sys.exit(main())
