"""Serving entry point: batched generation on any ``--arch`` (every
family: dense, MoE, SSM, hybrid, enc-dec, VLM) with random weights from
seed 0, on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
        --reduced --batch 4 --new-tokens 16 --device cpu

The VLM gets stub patch embeddings and the enc-dec 64 stub frames, drawn
from the prompts' generator after them, as the JAX package's launcher
draws them.  Without ``--device cpu`` it needs a visible CUDA card and
raises without one; it never falls back to the CPU.  On the card,
attention runs the hand-written ``flash_fwd`` kernel wherever it is
longer than 2048 tokens (``--prompt-len``).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..configs import get_config
from ..kernels import launches
from ..models.runtime import Runtime
from ..serve.engine import ServeEngine


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    engine = ServeEngine(cfg, rt=Runtime(), temperature=args.temperature,
                         device=args.device)
    gen = torch.Generator(device=engine.device).manual_seed(0)
    model = engine.api.init(gen)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab_size,
                            rng.integers(4, args.prompt_len + 1)).tolist()
               for _ in range(args.batch)]
    extra = None
    if cfg.family == "vlm":
        extra = {"patches": rng.standard_normal(
            (args.batch, cfg.n_patches, cfg.frontend_dim), dtype=np.float32)}
    if cfg.family == "encdec":
        S_enc = 64
        extra = {"frames": rng.standard_normal(
            (args.batch, S_enc, cfg.frontend_dim), dtype=np.float32)}
    res = engine.generate(model, prompts, max_new_tokens=args.new_tokens,
                          extra_inputs=extra)
    for i, toks in enumerate(res.tokens):
        print(f"req {i}: prompt {len(prompts[i])} toks -> {toks[:12]}"
              f"{'...' if len(toks) > 12 else ''}")
    print(f"{cfg.name} on {engine.device}: prefill {res.prefill_s*1e3:.0f} "
          f"ms; decode {res.n_steps} steps in {res.decode_s*1e3:.0f} ms "
          f"({res.tokens_per_s:.1f} tok/s); kernel launches {launches()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
