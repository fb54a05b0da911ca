"""Walks of the same steps on a real world and on a fake one.

For ``tests/test_torch_dryrun.py``'s walk equality: the reduced Llama and
Mamba2, a train step and a decode step each (``CASES``), built by
``launch.steps.build_step`` on a 2 x 2 (data, model) CPU mesh and walked
by ``launch.dryrun.walk_step``:

* :func:`spawn_real` runs them in four spawned gloo ranks on seeded
  weights and real inputs (a ``synth_batch``; a zero cache and zero
  tokens), with torch's own all-gathers, rank 0 writing its walks;
* :func:`fake_main` (``python torch_dryrun_check.py OUT``) runs them as
  rank 0 of a fake world of four on ``meta`` stand-ins, as the dry-run
  does.

Each writes {case: the walk's ``as_dict()`` and its hand kernels'
charges} as JSON.  :func:`split_main` (``python torch_dryrun_check.py
--split OUT``) walks each of ``SPLIT_ARCHS``' reduced train steps as rank
0 of a fake 1 x 1 world and of a fake 1 x ``SPLIT_TP`` one, and writes
{arch: [its products' FLOPs on 1 x 1, on 1 x SPLIT_TP]}.  It imports the
port alone.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile

import torch

#: (arch, kind, seq_len, batch) of each walked step
CASES = (("llama3.2-1b", "train", 32, 4), ("llama3.2-1b", "decode", 32, 4),
         ("mamba2-370m", "train", 32, 4), ("mamba2-370m", "decode", 32, 4))


#: the archs whose train step's products all split over tp (their
#: reduced heads and widths divide ``SPLIT_TP``; InternVL2's projector,
#: which the plan keeps whole over tp, is 0.2 % of its products).  Not
#: here: Whisper, whose adapter the plan keeps whole over tp (its reduced
#: config keeps the 512-wide frames: 15 % of the products), and the MoE,
#: whose experts' capacity rounds up per rank at reduced sizes.  The tp
#: width, the step's (seq_len, batch), and the walk's ops that are products
SPLIT_ARCHS = ("llama3.2-1b", "mamba2-370m", "zamba2-1.2b", "internvl2-2b")
SPLIT_TP, SPLIT_SHAPE = 4, (64, 2)
PRODUCTS = ("aten.mm", "aten.bmm", "aten.addmm", "aten.baddbmm")


def _walks(real: bool) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import synth_batch, to_device
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch.steps import build_step
    from repro_torch.models.registry import get_model
    mesh = MESH.make_mesh_spec(2, 2, device="cpu")
    out = {}
    for arch, kind, S, B in CASES:
        cfg = get_config(arch).reduced()
        shape = ShapeSpec("walk", kind, S, B)
        built = build_step(cfg, shape, mesh)
        model = inputs = None
        if real:
            api = get_model(cfg)
            model = api.init(torch.Generator().manual_seed(0))
            if kind == "decode":
                inputs = (api.init_cache(B, S, None, device="cpu"),
                          torch.zeros((B, 1), dtype=torch.int32))
            else:
                inputs = to_device(synth_batch(cfg, shape, 0), "cpu")
        costs, _ = dryrun.walk_step(built, model, inputs)
        out[f"{arch}/{kind}"] = dict(costs.as_dict(),
                                     charges=dict(costs.charges))
    return out


def _rank(rank: int, world: int, init: str, out_path: str) -> None:
    import torch.distributed as dist
    torch.set_num_threads(1)
    # torch's own all-gathers, as an NCCL world and the fake world run
    # them (launch.mesh.init_process_group routes a gloo world's through
    # all-to-alls, which the card's gloo needs and the CPU's does not)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        walks = _walks(real=True)
        if rank == 0:
            with open(out_path, "w") as f:
                json.dump(walks, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn_real(out_path: str) -> None:
    """The real 2 x 2 world's walks (rank 0's), written to ``out_path``."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        mp.spawn(_rank, args=(4, "file://" + os.path.join(d, "rdv"),
                              out_path), nprocs=4)


def fake_main(out_path: str) -> None:
    """The fake world's walks, written to ``out_path``."""
    from repro_torch.launch import mesh as MESH
    torch.set_num_threads(1)
    MESH.join_fake_world(4)
    with open(out_path, "w") as f:
        json.dump(_walks(real=False), f)


def split_main(out_path: str) -> None:
    """The products' FLOPs of each ``SPLIT_ARCHS`` train step on a fake
    1 x 1 world and a fake 1 x ``SPLIT_TP`` one, written to ``out_path``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as MESH
    from repro_torch.launch.steps import build_step
    torch.set_num_threads(1)
    torch.set_grad_enabled(True)
    S, B = SPLIT_SHAPE
    out: dict = {a: [] for a in SPLIT_ARCHS}
    for tp in (1, SPLIT_TP):
        MESH.join_fake_world(tp)
        mesh = MESH.make_mesh_spec(1, tp, device="cpu")
        for arch in SPLIT_ARCHS:
            built = build_step(get_config(arch).reduced(),
                               ShapeSpec("split", "train", S, B), mesh)
            costs, _ = dryrun.walk_step(built)
            out[arch].append(sum(costs.flops_by_op.get(k, 0.0)
                                 for k in PRODUCTS))
        torch.distributed.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


if __name__ == "__main__":
    if sys.argv[1] == "--split":
        split_main(sys.argv[2])
    else:
        fake_main(sys.argv[1])
