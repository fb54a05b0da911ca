"""The readings the comparison's limits are set from: for each seed, the
widest relative gap of the program from the reference over a short window
at the cell's own size (the lower reading), and the same gap of the
control, the reference computed in bfloat16 and put in the program's
place, on the same rows (the upper reading).  One process, one session.

    python3 mccm_bench/calibrate.py --workload resnet50-zcu102.bulk \
        --seeds 11,12,13 --seconds 4

Prints a JSON line a seed.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell_name: str, seeds, seconds: float, device: str,
             mix_override: dict | None = None):
    """Yield, for each seed, the program's and the control's widest gap
    on the rows a window of ``seconds`` keeps."""
    import torch

    from mccm_bench import bench, cells, check, traffic
    from mccm_bench.reference import Reference
    from mccm_bench.system import System
    spec = cells.load_spec()
    cell = cells.find_cell(spec, cell_name)
    cfg = cells.load_config(spec, cell)
    mix = {**cells.load_mix(cell["traffic"]), **(mix_override or {})}
    system = System(cfg, mix, device)
    ref = Reference(cfg, device)
    control = Reference(cfg, device, dtype=torch.bfloat16)
    n_layers = len(cfg["network"]["layers"])
    for seed in seeds:
        pool = traffic.design_pool(mix, n_layers, seed)
        for i in range(mix["warmup_calls"]):
            system.call(system.designs(pool[i % len(pool)]))
        w = bench.window(system, pool, seconds, traffic.seed_rng(seed, 1),
                         mix["check_rows_per_call"], check.METRICS)
        t0 = time.perf_counter()
        want = check.reference_rows(w["records"], pool, ref)
        prog, where = check.widest_gap(w["records"], want)
        ref_s = time.perf_counter() - t0
        ctl, ctl_where = check.widest_gap(check.replay(
            w["records"], check.reference_rows(w["records"], pool, control)),
            want)
        yield {"cell": cell_name, "seed": seed, "calls": w["attempted"],
               "failed": w["failed"],
               "rows": sum(len(r) for _, r, _ in w["records"]),
               "program": prog, "program_at": where, "control": ctl,
               "control_at": ctl_where, "reference_s": ref_s}
    system.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    import torch
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    seeds = [int(s) for s in args.seeds.split(",")]
    for r in readings(args.workload, seeds, args.seconds, "cuda"):
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
