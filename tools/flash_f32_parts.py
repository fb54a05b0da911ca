"""Where the f32 flash kernel's time goes: time ``csrc/flash_fwd.cu``
against copies of it that each leave out one part, at the shape
``chip_smoke.py``'s phase 8 times (Llama-3.2-1B's attention: B 4, S 4096,
32 query heads, 8 KV heads, head dim 64, causal, f32), in the order
A B C D E F F E D C B A on one card.

    python3 tools/flash_f32_parts.py [--reps N]

The copies, written under ``build/flash_f32_parts/``, compute wrong
answers and are only timed; each changes the source in one place:

- ``no_qk``: no Q·Kᵀ (its loop runs no step, the scores stay 0);
- ``no_pv``: no P·V (neither the p stores nor the products);
- ``no_copy``: only the first K/V tile a CTA is copied;
- ``no_exp``: ``exp2f(x)`` becomes ``x``;
- ``no_rescale``: the accumulator is not multiplied by alpha.

The time a part takes is the source's time less its copy's.  Prints the
card's name and power limit, one JSON line a timing (device ms a launch by
CUDA events, the mean of ``--reps`` launches), and a last JSON line with
each copy's mean and the share of the source's mean its part takes.
Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: each copy: text of the source, what it becomes, and how often it occurs
VARIANTS = {
    "no_qk": ("for (int c40 = 0; c40 < C4; c40 += CU)",
              "for (int c40 = 0; c40 < 0; c40 += CU)", 1),
    "no_pv": ("for (int ch = 0; ch < NCH; ++ch) {",
              "for (int ch = 0; ch < 0; ++ch) {", 1),
    "no_copy": ("if (it + 1 < n_tiles) load_tile(it + 1);", "", 1),
    "no_exp": ("exp2f(__fsub_rn(", "(__fsub_rn(", 2),
    "no_rescale": ("acc[r][n] = __fmul_rn(acc[r][n], alpha);", ";", 1),
}
ORDER = ("source", *VARIANTS, *reversed(VARIANTS), "source")


def variant_sources(source: Path, out_dir: Path) -> dict[str, Path]:
    """Write each copy of ``source`` and return the paths by name."""
    text = source.read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, (old, new, count) in VARIANTS.items():
        if text.count(old) != count:
            raise SystemExit(f"{name}: {old!r} is not {count} places of "
                             f"{source.name}")
        path = out_dir / f"{source.stem}_{name}.cu"
        path.write_text(text.replace(old, new))
        paths[name] = path
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("flash_f32_parts: no CUDA card is visible", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from repro_torch.configs import get_config
    from repro_torch.kernels._nvcc import load
    from repro_torch.kernels.flash_attn import flash_attention, ops

    print(smoke.nvidia_smi(), flush=True)
    source = ops.SOURCES[torch.float32]
    paths = variant_sources(source, ROOT / "build" / "flash_f32_parts")
    with ThreadPoolExecutor(len(paths) + 1) as ex:
        futs = {n: ex.submit(load, p) for n, p in paths.items()}
        futs["source"] = ex.submit(ops.library, torch.float32)
        built = {n: f.result() for n, f in futs.items()}
    entry = built["source"].lib.flash_fwd
    for name, b in built.items():
        b.lib.flash_fwd.argtypes = entry.argtypes
        b.lib.flash_fwd.restype = entry.restype
        print(json.dumps(dict(variant=name, ptxas=[
            e for e in smoke.ptxas_entries(b) if "ILi64E" in e["entry"]])),
            flush=True)

    cfg = get_config("llama3.2-1b")
    device = torch.device("cuda:0")
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn(smoke.FLASH_B, smoke.FLASH_S, h, cfg.head_dim,
                           generator=gen, device=device)
               for h in (cfg.n_heads, cfg.n_kv_heads, cfg.n_kv_heads))
    readings: dict[str, list[float]] = {n: [] for n in built}
    for name in ORDER:
        ops._BUILT[torch.float32] = built[name]
        ms = smoke.cuda_ms(lambda: flash_attention(q, k, v, causal=True),
                           args.reps)
        readings[name].append(ms)
        print(json.dumps(dict(variant=name, ms=ms)), flush=True)
    ops._BUILT[torch.float32] = built["source"]
    base = statistics.mean(readings["source"])
    print(json.dumps({"reps": args.reps, "means": {
        n: dict(ms=statistics.mean(r), readings=r,
                share=1 - statistics.mean(r) / base)
        for n, r in readings.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
