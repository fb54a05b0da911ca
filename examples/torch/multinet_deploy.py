"""Multi-tenant deployment walkthrough on the PyTorch port: co-schedule
CNNs on one FPGA.  The twin of ``examples/multinet_deploy.py``: the same
arms, configs and seeds, so it prints the same deployments.

Part 1 shows the three co-execution options for serving ResNet-50 and
MobileNetV2 from a single zc706 and what partition-aware joint DSE buys
over the obvious baselines:

1. equal split          — half the DSPs/BRAM/bandwidth each, designs
                          searched for that fixed split;
2. time multiplexing    — full board per model, round-robin (weights
                          re-stream on every context switch);
3. joint search         — budget split AND per-model CE arrangements
                          searched together.

Part 2 adds a third model and tight per-model SLOs, and lets the
SLO-driven search (``objective="slo"``) pick over the full hybrid space:
each model either owns a dedicated slice or joins the time-multiplexed
shared slice, and the front is driven by graded deadline attainment.

    PYTHONPATH=src python examples/torch/multinet_deploy.py [--n 2048]
    PYTHONPATH=src python examples/torch/multinet_deploy.py --device cpu

Each model lane of a generation is one batch-path call: one
``parallelism_search`` kernel launch a chunk on the card, its plain
PyTorch version with ``--device cpu``.  Without ``--device cpu`` it
needs a visible CUDA card and raises without one.
"""
import argparse
import sys

import numpy as np

from repro_torch.api import Session
from repro_torch.cnn.registry import get_cnn
from repro_torch.core.dse import decode_design
from repro_torch.core.dse.pareto import knee_point
from repro_torch.core.multinet import MultinetSearchConfig
from repro_torch.core.notation import format_spec
from repro_torch.fpga.boards import get_board


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048,
                    help="deployment-evaluation budget for EACH arm")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    # one session: every arm reuses the same megabatch tables
    with Session(get_board("zc706"), device=args.device) as ses:
        pair(ses, args.n)
        slo_mix(ses, args.n)
    return 0


def pair(ses, n: int) -> None:
    names = ("resnet50", "mobilenetv2")
    nets = [get_cnn(k) for k in names]
    cfg = MultinetSearchConfig(pop_size=min(256, n), seed=0)

    arms = {}
    for arm in ("equal_split", "temporal", "search"):
        res = ses.deploy(nets, n, strategy=arm, config=cfg)
        arms[arm] = res
        pts = res.front_points()
        best = pts[np.argmin(pts[:, 0])]
        print(f"{arm:>12}: {res.n_evals} deployments in {res.seconds:.1f}s "
              f"({res.per_eval_us:.0f} µs/deployment) — best worst-model "
              f"latency {best[0] * 1e3:.1f} ms at min-throughput "
              f"{-best[1]:.1f}/s")

    # ---- unpack the searched deployment at the knee of the front ----------
    res = arms["search"]
    pts = res.front_points()
    knee = res.front[int(np.argmin(np.abs(pts - knee_point(pts)).sum(1)))]
    m = res.metrics
    print(f"\nknee deployment (row {knee}):")
    print(f"  worst latency {m['worst_latency_s'][knee] * 1e3:.1f} ms | "
          f"aggregate {m['agg_throughput_ips'][knee]:.1f}/s | "
          f"fairness {m['fairness'][knee]:.2f}")
    for i, name in enumerate(names):
        pes = m["pes_split"][knee][i]
        buf = m["buf_split"][knee][i]
        bw = m["bw_split"][knee][i]
        spec = decode_design(res.designs.model(i), int(knee), len(nets[i]))
        print(f"  {name}: {pes:.0f} DSPs, {buf / 2**20:.2f} MiB BRAM, "
              f"{bw:.0%} bandwidth")
        print(f"    lat {m['per_model_latency_s'][knee][i] * 1e3:.1f} ms, "
              f"tp {m['per_model_throughput_ips'][knee][i]:.1f}/s")
        print(f"    {format_spec(spec, len(nets[i]))}")

    eq = arms["equal_split"].front_points()
    print(f"\nequal split never beats {eq[:, 0].min() * 1e3:.1f} ms worst "
          f"latency; the searched split reaches "
          f"{pts[:, 0].min() * 1e3:.1f} ms at the same budget.")


def slo_mix(ses, n: int) -> None:
    # ---- part 2: tight SLOs on a 3-model mix — the hybrid deployment space
    print("\n=== SLO-driven hybrid deployments (3-model mix) ===")
    names3 = ("resnet50", "mobilenetv2", "densenet121")
    nets3 = [get_cnn(k) for k in names3]
    slo_s = (0.120, 0.030, 0.130)        # per-model latency SLOs (s)
    weights = (1.0, 2.0, 1.0)            # mobilenetv2 carries 2x the traffic
    cfg = MultinetSearchConfig(pop_size=min(256, n), seed=0,
                               objective="slo", slo_s=slo_s, weights=weights)
    slo_arms = {}
    for arm in ("search", "temporal", "hybrid"):
        res = ses.deploy(nets3, n, strategy=arm, config=cfg)
        slo_arms[arm] = res
        best = res.metrics["slo_attainment_dist"].max()
        label = {"search": "pure spatial", "temporal": "pure temporal",
                 "hybrid": "hybrid"}[arm]
        print(f"{label:>14}: best SLO attainment {best:.2f} "
              f"({res.n_evals} deployments, {res.seconds:.1f}s)")

    res = slo_arms["hybrid"]
    i = int(np.argmax(res.metrics["slo_attainment_dist"]))
    m = res.metrics
    print(f"\nbest hybrid deployment (attainment "
          f"{m['slo_attainment_dist'][i]:.2f}):")
    for j, name in enumerate(names3):
        shared = m["assign"][i][j] > 0.5
        kind = "shared slice (RR)" if shared else "dedicated slice"
        extra = f", {m['time_share'][i][j]:.0%} of its slice's rounds" \
            if shared else ""
        print(f"  {name}: {kind} — {m['pes_split'][i][j]:.0f} DSPs{extra}; "
              f"lat {m['per_model_latency_s'][i][j] * 1e3:.1f} ms "
              f"(SLO {slo_s[j] * 1e3:.0f} ms)")


if __name__ == "__main__":
    sys.exit(main())
