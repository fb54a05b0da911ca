"""End-to-end training driver with fault tolerance, on one device.

The PyTorch port of the JAX package's ``launch/train.py``, on the card
unless ``--device cpu`` (without a card it raises; it never falls back to
the CPU):

* checkpoint/restart: atomic committed checkpoints every ``--ckpt-every``
  steps; on start the driver restores the latest committed step and the
  data pipeline regenerates the exact stream from it;
* crash injection: ``--crash-at N`` kills the process after step N (between
  a step and its checkpoint) to prove restart recovers;
* straggler mitigation: per-step wall times feed an EWMA; steps slower
  than ``--straggler-factor`` x the EWMA are logged.

The plan is ``launch/plans.py``'s ``default_plan`` (remat a layer, the loss
in chunks of 512).  Weights are random from a generator seeded 0 (the JAX
package's ``jax.random`` draws differ).  ``--dp``, ``--tp`` and
``--compress`` need the mesh and raise (``ROADMAP.md`` queue 1, item 11).

Usage (CPU smoke):
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --reduced --steps 40 --ckpt-dir "$TMPDIR/ckpt" --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from ..configs import SHAPES, get_config
from ..configs.base import ShapeSpec
from ..data.pipeline import Pipeline
from ..models import registry as model_registry
from ..models.runtime import resolve_device
from ..train import checkpoint as ckpt
from ..train.optimizer import make_optimizer
from ..train.train_step import init_state, make_train_step
from . import plans as PL


def main(argv=None) -> int:
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
    args = ap.parse_args(argv)
    if args.dp or args.tp or args.compress:
        raise NotImplementedError(
            "--dp, --tp and --compress need the mesh, which is not ported "
            "yet (ROADMAP.md queue 1, item 11)")
    device = resolve_device(args.device, "launch.train")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    shape = SHAPES.get(args.shape) or ShapeSpec(
        args.shape, "train", args.seq, args.batch)
    if args.reduced:
        shape = ShapeSpec("train_smoke", "train", args.seq, args.batch)

    plan = PL.default_plan(cfg, shape)
    opt = make_optimizer("adamw", peak_lr=args.lr, warmup=20,
                         total_steps=max(args.steps, 100),
                         state_dtype=plan.opt_state_dtype,
                         factored=plan.opt_factored,
                         momentum=plan.opt_momentum)
    api = model_registry.get_model(cfg)
    step = make_train_step(api, plan.runtime(), opt, accum=plan.accum,
                           device=device)

    # ---- init or restore ---------------------------------------------------
    state = init_state(api, opt, torch.Generator(device=device).manual_seed(0),
                       device=device)
    start = 0
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        state = ckpt.restore(args.ckpt_dir, state)
        start = state.step
        print(f"[restore] resumed from committed step {start} "
              f"(device {device})")

    pipe = Pipeline(cfg, shape, device=device, start_step=start)
    it = iter(pipe)
    ewma, stragglers, loss = None, 0, float("nan")
    t_run = time.time()
    try:
        for i in range(start, args.steps):
            _, batch = next(it)
            t0 = time.time()
            state, metrics = step(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if i > start + 1:  # skip the warm-up steps
                ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
                if ewma and dt > args.straggler_factor * ewma:
                    stragglers += 1
                    print(f"[straggler] step {i}: {dt:.3f}s vs "
                          f"EWMA {ewma:.3f}s")
            if i % args.log_every == 0 or i == args.steps - 1:
                print(f"step {i:5d}  loss {loss:.4f}  "
                      f"gnorm {float(metrics['grad_norm']):.2f}  "
                      f"{dt*1e3:.0f} ms")
            if args.ckpt_dir and (i + 1) % args.ckpt_every == 0:
                path = ckpt.save(args.ckpt_dir, i + 1, state,
                                 extra={"arch": cfg.name,
                                        "device": str(device),
                                        "plan": plan.name})
                print(f"[ckpt] committed step {i+1} -> {path}")
            if args.crash_at is not None and i + 1 >= args.crash_at:
                print(f"[crash] simulated failure after step {i+1}",
                      flush=True)
                os._exit(42)
    finally:
        pipe.close()
    total = time.time() - t_run
    print(f"done: {args.steps - start} steps in {total:.1f}s; "
          f"final loss {loss:.4f}; stragglers {stragglers}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
