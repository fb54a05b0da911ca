"""End-to-end training driver with fault tolerance and a mesh.

The PyTorch port of the JAX package's ``launch/train.py``, on the card
unless ``--device cpu`` (without a card it raises; it never falls back to
the CPU):

* checkpoint/restart: atomic committed checkpoints every ``--ckpt-every``
  steps; on start the driver restores the latest committed step and the
  data pipeline regenerates the exact stream from it;
* crash injection: ``--crash-at N`` kills the process after step N (between
  a step and its checkpoint) to prove restart recovers;
* straggler mitigation: per-step wall times feed an EWMA; steps slower
  than ``--straggler-factor`` x the EWMA are logged;
* a mesh: ``--dp N --tp M`` trains on a (data N, model M) mesh of N·M
  ranks, SPMD (``launch/mesh.py``): under ``torchrun`` (``RANK``/
  ``WORLD_SIZE`` set) this process is one rank, else it spawns the N·M
  ranks itself, as the JAX launcher's one command runs its mesh.  The
  backend is ``--backend`` (``gloo`` on the CPU, ``nccl`` on cards by
  default); NCCL with more ranks than cards raises before anything runs.
  The checkpoint holds full arrays and records the mesh, so a restart may
  take another mesh (the elastic reshard);
* gradient compression: ``--compress`` takes the int8 error-feedback
  data-parallel step over the data axis (``make_compressed_train_step``).

The plan is ``launch/plans.py``'s ``default_plan`` (one device: remat a
layer, the loss in chunks of 512; on a mesh, ZeRO-3 over data and tensor
parallelism over model).  Weights are random from a generator seeded 0
(the JAX package's ``jax.random`` draws differ); every rank makes the
same and keeps its shards.

Usage (CPU smoke):
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --reduced --steps 40 --ckpt-dir "$TMPDIR/ckpt" --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --reduced \\
        --device cpu --dp 2 --tp 2 --steps 20
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import torch

from ..configs import SHAPES, get_config
from ..configs.base import ShapeSpec
from ..data.pipeline import Pipeline
from ..models import registry as model_registry
from ..models.runtime import resolve_device
from ..train import checkpoint as ckpt
from ..train.optimizer import make_optimizer
from ..train.train_step import (init_residuals, init_state,
                                make_compressed_train_step, make_train_step)
from . import mesh as MESH
from . import plans as PL


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--crash-at", type=int, default=None)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--dp", type=int, default=None)
    ap.add_argument("--tp", type=int, default=None)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="mesh backend (default: nccl on cuda, gloo on "
                         "the cpu)")
    return ap


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    device = resolve_device(args.device, "launch.train")
    if not (args.dp or args.tp or args.compress):
        return _run(args, device, None)
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    world = (args.dp or 1) * (args.tp or 1)
    if backend == "nccl":
        MESH.check_cards(world)
    if "RANK" in os.environ:                      # one rank under torchrun
        MESH.init_process_group(backend)
        return _run(args, device, backend)
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as d:
        init = "file://" + os.path.join(d, "rendezvous")
        try:
            mp.spawn(_rank, args=(argv, world, backend, init), nprocs=world)
        except mp.ProcessExitedException as e:
            return e.exit_code
    return 0


def _rank(rank: int, argv, world: int, backend: str, init: str) -> None:
    """One spawned rank of the mesh."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device, "launch.train")
    MESH.init_process_group(backend, rank=rank, world_size=world,
                            init_method=init)
    code = _run(args, device, backend)
    if code:
        sys.exit(code)


def _run(args, device, backend) -> int:
    """The training loop, on one device (``backend`` None) or as one rank
    of the mesh."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = SHAPES.get(args.shape) or ShapeSpec(
        args.shape, "train", args.seq, args.batch)
    if args.reduced:
        shape = ShapeSpec("train_smoke", "train", args.seq, args.batch)

    mesh, lead = None, True
    if backend is not None:
        mesh = MESH.make_mesh_spec(args.dp or 1, args.tp or 1,
                                   device=device.type)
        lead = torch.distributed.get_rank() == 0
    say = print if lead else (lambda *a, **k: None)
    plan = PL.default_plan(cfg, shape, mesh)
    opt = make_optimizer("adamw", peak_lr=args.lr, warmup=20,
                         total_steps=max(args.steps, 100),
                         state_dtype=plan.opt_state_dtype,
                         factored=plan.opt_factored,
                         momentum=plan.opt_momentum)
    api = model_registry.get_model(cfg)
    where = {"device": str(device)} if mesh is None else {
        "mesh": PL.mesh_shape(mesh), "backend": backend}

    # ---- init or restore ---------------------------------------------------
    model = api.init(torch.Generator(device=device).manual_seed(0))
    residuals = None
    if args.compress:
        dp_axis = plan.dp_axes[0] if plan.dp_axes else "data"
        step = make_compressed_train_step(
            api, plan.runtime(mesh), opt, mesh=mesh, axis=dp_axis,
            n_shards=PL.mesh_shape(mesh)[dp_axis], device=device)
        residuals = init_residuals(model)
    else:
        if mesh is not None:
            PL.distribute_model(model, plan, mesh)
        step = make_train_step(api, plan.runtime(mesh), opt,
                               accum=plan.accum, device=device)
    state = init_state(api, opt, model=model, device=device)
    start = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        state = ckpt.restore(args.ckpt_dir, state)
        start = state.step
        say(f"[restore] resumed from committed step {start} "
            f"({', '.join(f'{k} {v}' for k, v in where.items())})")

    pipe = Pipeline(cfg, shape, device=device, start_step=start)
    it = iter(pipe)
    ewma, stragglers, loss = None, 0, float("nan")
    t_run = time.time()
    try:
        for i in range(start, args.steps):
            _, batch = next(it)
            t0 = time.time()
            if args.compress:
                state, residuals, metrics = step(state, residuals, batch)
            else:
                state, metrics = step(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if i > start + 1:  # skip the warm-up steps
                ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
                if ewma and dt > args.straggler_factor * ewma:
                    stragglers += 1
                    say(f"[straggler] step {i}: {dt:.3f}s vs "
                        f"EWMA {ewma:.3f}s")
            if i % args.log_every == 0 or i == args.steps - 1:
                say(f"step {i:5d}  loss {loss:.4f}  "
                    f"gnorm {float(metrics['grad_norm']):.2f}  "
                    f"{dt*1e3:.0f} ms")
            if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
                path = ckpt.save(args.ckpt_dir, i + 1, state,
                                 extra={"arch": cfg.name, **where,
                                        "plan": plan.name})
                say(f"[ckpt] committed step {i+1} -> {path}")
            if args.crash_at is not None and i + 1 >= args.crash_at:
                say(f"[crash] simulated failure after step {i+1}",
                    flush=True)
                sys.stdout.flush()
                os._exit(42)
    finally:
        pipe.close()
    total = time.time() - t_run
    say(f"done: {args.steps - start} steps in {total:.1f}s; "
        f"final loss {loss:.4f}; stragglers {stragglers}")
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
