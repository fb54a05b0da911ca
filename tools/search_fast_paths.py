"""Time the search kernel against copies of its source that each lack one
fast path, on the chunk ``chip_smoke.py``'s phase 4 times (ResNet-50 on
ZCU102, the first 2048 of 100,000 ``sample_mixed`` designs from seed 0),
in the order A B C C B A on one card.

    python3 tools/search_fast_paths.py [--reps N]

The copies, written under ``build/search_fast_paths/``, each with one line
of ``csrc/parallelism_search.cu`` changed:

- ``bsearch``: pw's index by a binary search over the candidates always,
  not by the block's table;
- ``scalar``: fc and coh staged a float a load, not 16 bytes a load.

Each copy is held to the plain version bit for bit on the chunk before it
is timed.  Prints the card's name and power limit, one JSON line a timing
(device ms a launch by CUDA events, the mean of ``--reps`` launches), and
a last JSON line with each copy's mean and its change against the
source's mean.  Needs a CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: each copy: the line of the source it changes, and what it becomes
VARIANTS = {
    "bsearch": ("  const bool use_lut = K <= 32 &&",
                "  const bool use_lut = false && K <= 32 &&"),
    "scalar": ("  if (((reinterpret_cast<uintptr_t>(fc_pair) |",
               "  if (false && ((reinterpret_cast<uintptr_t>(fc_pair) |"),
}
ORDER = ("source", "bsearch", "scalar", "scalar", "bsearch", "source")


def variant_sources(source: Path, out_dir: Path) -> dict[str, Path]:
    """Write each copy of ``source`` and return the paths by name."""
    text = source.read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, (old, new) in VARIANTS.items():
        if text.count(old) != 1:
            raise SystemExit(f"{name}: {old!r} is not one line of "
                             f"{source.name}")
        path = out_dir / f"{source.stem}_{name}.cu"
        path.write_text(text.replace(old, new))
        paths[name] = path
    return paths


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("search_fast_paths: no CUDA card is visible", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from repro_torch.api import get_board, get_cnn
    from repro_torch.core.batch_eval import DEFAULT_CHUNK
    from repro_torch.core.dse import sample_mixed
    from repro_torch.kernels._nvcc import load
    from repro_torch.kernels.mccm_eval import ops
    from repro_torch.kernels.mccm_eval import parallelism_search

    print(smoke.nvidia_smi(), flush=True)
    paths = variant_sources(ops.SOURCE, ROOT / "build" / "search_fast_paths")
    _, symbol, argtypes = ops._KERNELS["parallelism_search"]
    with ThreadPoolExecutor(len(paths) + 1) as ex:
        futs = {n: ex.submit(load, p) for n, p in paths.items()}
        futs["source"] = ex.submit(ops.library, "parallelism_search")
        built = {n: f.result() for n, f in futs.items()}
    for b in built.values():
        fn = getattr(b.lib, symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int

    device = torch.device("cuda:0")
    net, board = get_cnn("resnet50"), get_board("zcu102")
    batch = sample_mixed(np.random.default_rng(0), len(net), 100_000)
    chunk = smoke._search_inputs(net, board,
                                 batch.take(slice(0, DEFAULT_CHUNK)), device)
    plan = ops.search_plan(DEFAULT_CHUNK, *chunk[2].shape, chunk[5].numel())
    npl = f"ILi{plan.npl}E"
    for name, b in built.items():
        ops._BUILT["parallelism_search"] = b
        smoke._compare(chunk, name, dict(max_abs_err=0.0, cases=0,
                                         designs=0))
        regs = [e for e in smoke.ptxas_entries(b) if npl in e["entry"]]
        print(json.dumps(dict(variant=name, bit_equal=True, ptxas=regs)),
              flush=True)

    readings: dict[str, list[float]] = {n: [] for n in built}
    for name in ORDER:
        ops._BUILT["parallelism_search"] = built[name]
        ms = smoke.cuda_ms(lambda: parallelism_search(*chunk), args.reps)
        readings[name].append(ms)
        print(json.dumps(dict(variant=name, ms=ms)), flush=True)
    ops._BUILT["parallelism_search"] = built["source"]
    base = statistics.mean(readings["source"])
    print(json.dumps({"reps": args.reps, "means": {
        n: dict(ms=statistics.mean(r), readings=r,
                change=statistics.mean(r) / base - 1)
        for n, r in readings.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
