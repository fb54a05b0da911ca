"""Design-space exploration on the PyTorch port (paper use case 3, Fig.
10) — find custom multiple-CE designs that dominate the fixed templates,
comparing the paper's blind random sampling with the guided
multi-objective search.  The twin of ``examples/dse_explore.py``: the
same seeds draw the same designs, so it prints the same fronts.

    PYTHONPATH=src python examples/torch/dse_explore.py [--n 20000]
    PYTHONPATH=src python examples/torch/dse_explore.py --device cpu

Each generation's batch path runs on the session's device: one
``parallelism_search`` kernel launch a chunk on the card, its plain
PyTorch version with ``--device cpu``.  Without ``--device cpu`` it
needs a visible CUDA card and raises without one.
"""
import argparse
import sys

import numpy as np

from repro_torch.api import Session
from repro_torch.cnn.registry import get_cnn
from repro_torch.core.dse import decode_design, dominating_indices, orient
from repro_torch.core.notation import format_spec
from repro_torch.fpga.archs import make_arch
from repro_torch.fpga.boards import get_board

OBJ = ("throughput_ips", "buffer_bytes")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000,
                    help="evaluation budget for EACH strategy")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    net, dev = get_cnn("xception"), get_board("vcu110")
    with Session(dev, device=args.device) as ses:  # tables shared by calls
        explore(ses, net, args.n)
    return 0


def explore(ses, net, n: int) -> None:
    # templates to beat
    best_seg = max((ses.evaluate(make_arch("segmented", net, k), net)
                    for k in range(2, 12)), key=lambda m: m.throughput_ips)
    print(f"template best: segmented tp {best_seg.throughput_ips:.1f}/s, "
          f"buffers {best_seg.buffer_bytes/2**20:.2f} MiB")

    rnd = ses.explore(net, n, family="mixed", seed=0, objectives=OBJ)
    print(f"random: {rnd.n_evals} designs in {rnd.seconds:.1f}s "
          f"({rnd.per_design_us:.0f} µs/design — paper: 6300 µs)")
    srch = ses.explore(net, n, family="mixed", strategy="search",
                       seed=1, objectives=OBJ)
    print(f"search: {srch.n_evals} designs in {srch.seconds:.1f}s "
          f"({srch.per_design_us:.0f} µs/design incl. search overhead)")

    show_front("random", rnd, net)
    show_front("search", srch, net)

    # side by side: does the guided front dominate the random picks?
    rp = orient(rnd.metrics, OBJ)
    sp = orient(srch.metrics, OBJ)
    ref = rp[int(np.argmin(rp[:, 0]))]      # random's best-throughput design
    dom = dominating_indices(sp, ref)
    print(f"\nsearch designs strictly dominating random's best-throughput "
          f"design: {len(dom)}")

    for label, res in (("random", rnd), ("search", srch)):
        tp = res.metrics["throughput_ips"]
        buf = res.metrics["buffer_bytes"]
        match = tp >= best_seg.throughput_ips * 0.995
        if match.any():
            save = 1 - buf[match].min() / best_seg.buffer_bytes
            print(f"{label}: same throughput as the best template with "
                  f"{save:.0%} less buffer (paper: up to 48%)")


def show_front(label, res, net) -> None:
    tp = res.metrics["throughput_ips"]
    buf = res.metrics["buffer_bytes"]
    front = res.front
    print(f"\n{label} Pareto front ({len(front)} designs):")
    for i in front[np.argsort(-tp[front])][:8]:
        spec = decode_design(res.batch, int(i), len(net))
        print(f"  tp {tp[i]:6.1f}/s  buf {buf[i]/2**20:6.2f} MiB  "
              f"{format_spec(spec, len(net))[:70]}")


if __name__ == "__main__":
    sys.exit(main())
