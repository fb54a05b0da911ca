"""Multi-pod dry-run: walk every (arch × shape × mesh) cell's step at full
width on the production mesh, without the devices.

The PyTorch port of the JAX package's ``launch/dryrun.py``.  There each
cell is lowered and compiled on 256 or 512 placeholder host devices and
its compiled module's memory analysis, collectives and HLO walk are
recorded.  The port has no compiler, so each cell here:

* joins a fake world of 256 (``single``: 16 x 16 (data, model)) or 512
  ranks (``multi``: 2 x 16 x 16 (pod, data, model)), this process being
  rank 0 (``launch/mesh.py::join_fake_world``: the ``fake`` backend, whose
  collectives complete at once and move nothing), and builds the mesh on
  ``--device``'s device type;
* runs ``default_plan`` (or the caller's plan) and ``build_step``;
* builds the model from ``registry.param_specs``' ``meta`` tensors
  (``registry.meta_model``: nothing is drawn or allocated) and puts it on
  the mesh with ``place_model``, the optimizer state, batch and cache too;
* runs rank 0's step once under ``gpu.op_walk.OpWalk`` (FLOPs, bytes,
  transcendentals and collective wire bytes of this rank's shards, each
  hand kernel charged by formula: ``flash_attention``'s ``meta`` route
  computes nothing) and ``gpu.op_walk.MemCount`` (the bytes the rank
  holds).

Each record is rank 0's view: ``DeviceMesh.get_local_rank`` is 0 on every
axis of a fake world.  The JAX records are per device of a symmetric
program, and so is the port's SPMD step, except where a rank's share
depends on its place (heads padded over tp).  A record keeps the JAX
dry-run's keys (``cell``, ``arch``, ``shape``, ``mesh``, ``mesh_shape``,
``kind``, ``plan``, ``ok``, ``memory``, ``collectives``, ``walk``,
``total_s``), with ``walk_s`` in place of ``lower_s`` and ``compile_s``;
it has no ``cost`` or ``hlo_bytes`` (there is no compiler).
``roofline.analysis.analyze_cell`` and ``load_artifacts`` read them.

Records go to ``chiprun_out/dryrun/<cell>.json`` (not committed).  An
existing record is read back unless ``--force``; a failing cell is
recorded with ``ok: false``, its ``error`` and ``traceback``, and the
sweep goes on; the exit code is 1 if any cell failed.  The tensors are
``meta`` whatever ``--device`` is; the mesh's device type is ``cuda``
unless the caller asks for the CPU, and ``cuda`` without a visible card
raises, as everywhere in the port.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --device cpu \\
        --arch llama3.2-1b --shape train_4k --mesh single,multi
    PYTHONPATH=src python -m repro_torch.launch.dryrun --list
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from ..configs import ARCH_NAMES, SHAPES, cells, get_config
from ..roofline.analysis import DRYRUN_DIR, cell_record

ART_DIR = DRYRUN_DIR
#: the production meshes: name -> (multi_pod, world size)
MESHES = {"single": (False, 256), "multi": (True, 512)}


def cell_id(arch: str, shape: str, mesh: str) -> str:
    return f"{arch}__{shape}__{mesh}"


def _artifact_path(cid: str, out_dir: str) -> str:
    return os.path.join(out_dir, cid + ".json")


def fake_mesh(mesh_name: str, device: str = "cuda"):
    """The production mesh ``mesh_name`` on a fake world of its size:
    this process joins one (leaving a fake world of another size first)."""
    import torch.distributed as dist

    from .mesh import join_fake_world, make_production_mesh
    multi, world = MESHES[mesh_name]
    if dist.is_initialized() and dist.get_world_size() != world:
        if dist.get_backend() != "fake":
            raise RuntimeError("this process belongs to a real process "
                               "group; the dry-run needs one of its own")
        dist.destroy_process_group()
    if not dist.is_initialized():
        join_fake_world(world)
    return make_production_mesh(multi_pod=multi, device=device)


def walk_step(built, model=None, inputs=None) -> tuple:
    """Rank 0's step of ``built`` (a ``launch.steps.BuiltStep`` on a mesh)
    run once under ``OpWalk`` and ``MemCount`` -> (the walk's
    ``WalkCosts``, the memory keys).  The model, and the inputs (the batch,
    or for a decode step the cache and the tokens), are ``meta`` stand-ins
    unless given; the model is placed on the mesh, the inputs too."""
    from ..gpu.op_walk import MemCount, OpWalk
    from ..models import registry
    from ..train.train_step import init_state, shard_batch
    from .steps import cache_specs_of, place_cache
    rt, cfg = built.rt, built.cfg
    model = built.place_model(registry.meta_model(cfg) if model is None
                              else model)
    params = dict(model.named_parameters())
    mem = MemCount()
    if built.kind == "decode":
        cache, tokens = inputs or built.arg_specs[1:]
        cache = place_cache(cache, cache_specs_of(cache, built.plan, cfg,
                                                  rt.mesh), rt.mesh)
        tokens = shard_batch({"tokens": tokens}, rt)["tokens"]
        mem.hold((params, cache, tokens))

        def run():
            return built.fn(model, cache, tokens)
    else:
        batch = shard_batch(dict(inputs or built.arg_specs[1]), rt)
        if built.kind == "train":
            state = init_state(registry.get_model(cfg), built.opt,
                               model=model, device=rt.mesh.device_type)
            mem.hold((params, state.opt, batch))

            def run():
                return built.fn(state, batch)
        else:
            mem.hold((params, batch))

            def run():
                return built.fn(model, batch)
    with mem, OpWalk() as walk:
        out = run()
    memory = mem.memory()
    del out
    return walk.costs(), memory


def run_cell(arch: str, shape_name: str, mesh_name: str,
             out_dir: str = ART_DIR, plan=None, tag: str | None = None,
             force: bool = False, *, device: str = "cuda") -> dict:
    """Walk one cell; return (and persist) its record."""
    from .steps import build_step
    os.makedirs(out_dir, exist_ok=True)
    cid = cell_id(arch, shape_name, mesh_name) + (f"__{tag}" if tag else "")
    path = _artifact_path(cid, out_dir)
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec: dict = {"cell": cid, "arch": arch, "shape": shape_name,
                 "mesh": mesh_name, "mesh_shape": None, "kind": shape.kind,
                 "plan": None, "ok": False}
    t0 = time.time()
    try:
        mesh = fake_mesh(mesh_name, device)
        rec["mesh_shape"] = dict(zip(mesh.mesh_dim_names, mesh.shape))
        built = build_step(cfg, shape, mesh, plan)
        rec["plan"] = {k: v for k, v in vars(built.plan).items()
                       if isinstance(v, (str, int, float, bool, tuple,
                                         type(None)))}
        t1 = time.time()
        costs, memory = walk_step(built)
        rec.update(cell_record(cid, arch, shape_name, shape.kind, costs,
                               memory, rec["plan"], mesh=mesh_name,
                               mesh_shape=rec["mesh_shape"]))
        rec["walk_s"] = round(time.time() - t1, 2)
    except Exception as e:  # noqa: BLE001 -- recorded, the sweep goes on
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    rec["total_s"] = round(time.time() - t0, 2)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default=None,
                    help="comma-separated arch ids (default: all)")
    ap.add_argument("--shape", default=None,
                    help="comma-separated shape names (default: all)")
    ap.add_argument("--mesh", default="single,multi")
    ap.add_argument("--out", default=ART_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true",
                    help="list the assigned cells and exit")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type (the tensors are meta "
                         "either way); cuda without a card raises")
    args = ap.parse_args(argv)

    assigned = cells(include_skipped=True)
    if args.list:
        for arch, shape, skip in assigned:
            print(f"{arch:24s} {shape:12s} {'SKIP' if skip else ''}")
        return 0
    torch.set_grad_enabled(True)
    archs = args.arch.split(",") if args.arch else list(ARCH_NAMES)
    shapes = args.shape.split(",") if args.shape else list(SHAPES)
    meshes = args.mesh.split(",")
    want_skip = {(a, s): sk for a, s, sk in assigned}
    failed = 0
    for mesh in meshes:              # one fake world a mesh, joined once
        for arch in archs:
            for shape in shapes:
                skip = want_skip.get((arch, shape))
                if skip is None:
                    continue
                if skip:
                    if mesh == meshes[0]:
                        print(f"[skip] {arch} × {shape} — sub-quadratic "
                              "only (DESIGN.md §Arch-applicability)")
                    continue
                rec = run_cell(arch, shape, mesh, args.out, force=args.force,
                               device=args.device)
                status = "ok" if rec["ok"] else "FAIL"
                peak = rec.get("memory", {}).get("peak_memory_in_bytes", 0)
                extra = (f"peak={peak/2**30:.2f}GiB "
                         f"wire={rec['collectives']['total_wire']/2**30:.2f}"
                         f"GiB" if rec["ok"] else rec.get("error", ""))
                print(f"[{status}] {rec['cell']}  "
                      f"(walk {rec.get('walk_s', '-')}s)  {extra}",
                      flush=True)
                failed += 0 if rec["ok"] else 1
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
