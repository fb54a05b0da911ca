"""Batched serving on the PyTorch port with the ServeEngine: prefill a
request batch, decode with greedy sampling, report prefill/decode
throughput.  The twin of ``examples/serve_lm.py``: the reduced
Llama-3.2-1B and the same prompts.

    PYTHONPATH=src python examples/torch/serve_lm.py                # card
    PYTHONPATH=src python examples/torch/serve_lm.py --device cpu

The weights are random, from the port's own init on a CPU generator
seeded 0 (the JAX package's ``jax.random`` draws differ), moved to the
engine's device, so the card and the CPU serve the same model.  The
sampled variant draws from a ``torch.Generator`` seeded 7, not from
``jax.random``.  Without ``--device cpu`` it needs a visible CUDA card
and raises without one.
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import get_model
from repro_torch.models.runtime import Runtime, resolve_device
from repro_torch.serve.engine import ServeEngine

PROMPT_LENS = (12, 24, 7, 18)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config("llama3.2-1b").reduced()
    device = resolve_device(args.device, "serve_lm")
    model = get_model(cfg).init(torch.Generator().manual_seed(0))
    serve(cfg, model.to(device), device)
    return 0


def prompts_of(cfg) -> list[list[int]]:
    rng = np.random.default_rng(0)
    return [rng.integers(1, cfg.vocab_size, n).tolist() for n in PROMPT_LENS]


def serve(cfg, model, device):
    """Greedy generation of 24 tokens on the four prompts, then 12 sampled
    at T = 0.8 on the first two, printed; returns both results."""
    prompts = prompts_of(cfg)
    engine = ServeEngine(cfg, rt=Runtime(), temperature=0.0, device=device)
    res = engine.generate(model, prompts, max_new_tokens=24)
    for i, (p, toks) in enumerate(zip(prompts, res.tokens)):
        print(f"request {i}: {len(p):2d} prompt toks -> "
              f"{toks[:10]}{'...' if len(toks) > 10 else ''}")
    print(f"\nprefill: {res.n_prefill} positions in {res.prefill_s*1e3:.0f} "
          f"ms")
    print(f"decode : {res.n_steps} steps in {res.decode_s*1e3:.0f} ms "
          f"({res.tokens_per_s:.1f} tok/s across the batch)")

    # temperature sampling variant
    engine_t = ServeEngine(cfg, rt=Runtime(), temperature=0.8, seed=7,
                           device=device)
    res_t = engine_t.generate(model, prompts[:2], max_new_tokens=12)
    print(f"\nsampled (T=0.8): {res_t.tokens[0][:10]}")
    return res, res_t


if __name__ == "__main__":
    sys.exit(main())
