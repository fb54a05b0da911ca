"""End-to-end training of a ~100M-param transformer for a few hundred steps
on the PyTorch port, using the same launcher a mesh run would use
(checkpointing, prefetching, straggler log).  The twin of
``examples/train_lm.py``: the same config and launcher arguments.

    PYTHONPATH=src python examples/torch/train_lm.py [--steps 300]
    PYTHONPATH=src python examples/torch/train_lm.py --device cpu \
        --steps 3 --ckpt-every 2

~100M params: 8 layers, d_model=512, d_ff=2048, vocab 32000.  A run
resumes from the latest committed checkpoint in ``--ckpt-dir``.  Weights
are random from a generator seeded 0 (the JAX package's draws differ).
Without ``--device cpu`` it needs a visible CUDA card and raises without
one.
"""
import argparse
import os
import sys
import tempfile

import repro_torch.configs as C
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.train import main as train_main

# a ~100M llama-style config
CFG = ModelConfig(
    name="lm-100m", family="dense", n_layers=8, d_model=512, n_heads=8,
    n_kv_heads=8, d_ff=2048, vocab_size=32_000, rope_theta=1e4,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    print(f"model: {CFG.name}, {CFG.param_count()/1e6:.1f}M params")
    # register it so the launcher can find it, then delegate
    C.ARCHS[CFG.name] = CFG
    return train_main([
        "--arch", CFG.name, "--steps", str(args.steps),
        "--batch", "8", "--seq", "128", "--shape", "custom",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", str(args.ckpt_every),
        "--lr", "1e-3", "--log-every", "25", "--device", args.device,
    ])


if __name__ == "__main__":
    sys.exit(main())
