"""Run one cell of the benchmark of ``repro_torch`` on the card.

    python3 mccm_bench/run.py --workload resnet50-zcu102.bulk --seed 7 \
        --seconds 10 --trace 0

Prints one JSON line of detail, then the result as the last line of
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics),
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
compared number beside its limit; the same numbers end standard error.
Exits non-zero, with no result, where no card or too few cards are
visible, where the program is missing, or where JAX or the JAX package
was loaded.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

    import torch

    from mccm_bench import bench, cells
    cell = cells.find_cell(cells.load_spec(), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f" visible", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    out = bench.run(args.workload, args.seed, args.seconds,
                    bool(args.trace), device="cuda", t_start=_T0)
    found = bench.forbidden_modules()
    if found:
        print(f"the run loaded {', '.join(found)}: JAX and the JAX package "
              f"may not run in the benchmark", file=sys.stderr)
        return 3
    print(json.dumps(out["detail"]), flush=True)
    print(json.dumps(out["result"]), flush=True)
    for line in out["check_lines"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
