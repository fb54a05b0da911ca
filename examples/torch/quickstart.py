"""Quickstart on the PyTorch port: express, build, and evaluate
multiple-CE accelerators with MCCM through the port's one front door —
``repro_torch.api.Session`` — using the paper's §III-B notation end to
end.  The twin of ``examples/quickstart.py``: the same report, line for
line.

    PYTHONPATH=src python examples/torch/quickstart.py                # card
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu

On the card the batched re-evaluation is one ``parallelism_search``
kernel launch a chunk; ``--device cpu`` runs its plain PyTorch version.
Without ``--device cpu`` it needs a visible CUDA card and raises without
one.
"""
import argparse
import sys

from repro_torch.api import Session
from repro_torch.cnn.registry import get_cnn
from repro_torch.core.notation import format_spec, parse
from repro_torch.fpga.archs import make_arch
from repro_torch.fpga.boards import get_board


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    net = get_cnn("resnet50")           # paper Table III workload
    dev = get_board("zcu102")           # paper Table II board
    with Session(dev, device=args.device) as ses:  # owns the tables
        report(ses, net, dev)
    return 0


def report(ses, net, dev) -> None:
    print(f"CNN: {net.name} ({len(net)} conv layers, "
          f"{net.total_weights/1e6:.1f}M weights); board: {dev.name} "
          f"({dev.pes} DSPs, {dev.on_chip_bytes/2**20:.1f} MiB BRAM)\n")

    # -- 1. the paper's notation --------------------------------------------
    designs = {
        "SegmentedRR {L1-Last:CE1-CE4}": parse("{L1-Last:CE1-CE4}",
                                               len(net)),
        "Hybrid      {L1:CE1, L2:CE2, L3:CE3, L4-Last:CE4}":
            parse("{L1:CE1, L2:CE2, L3:CE3, L4-Last:CE4}", len(net)),
        "Segmented   (4 MAC-balanced single-CE segments)":
            make_arch("segmented", net, 4),
    }

    print(f"{'design':55s} {'latency':>9s} {'thpt':>7s} {'buffer':>9s} "
          f"{'access':>9s}")
    for name, spec in designs.items():
        m = ses.evaluate(spec, net)     # scalar: full Metrics, exact
        print(f"{name:55s} {m.latency_s*1e3:7.1f}ms "
              f"{m.throughput_ips:6.1f}/s "
              f"{m.buffer_bytes/2**20:7.2f}MiB {m.access_bytes/1e6:7.1f}MB")

    # -- 2. fine-grained bottleneck view (paper use case 2) ------------------
    m = ses.evaluate(make_arch("segmented", net, 4), net)
    print("\nper-segment breakdown (Segmented, 4 CEs):")
    for s in m.per_segment:
        kind = "MEM-bound" if s.mem_s > s.compute_s else "compute-bound"
        print(f"  seg {s.index}: {s.n_layers:3d} layers  busy "
              f"{s.busy_s*1e3:6.1f}ms  util {s.utilization:5.1%}  {kind}")

    # -- 3. any custom arrangement in one line -------------------------------
    custom = "{L1-L10:CE1-CE5, L11-L30:CE6, L31-Last:CE7}"
    m = ses.evaluate(custom, net)       # notation strings parse in place
    print(f"\ncustom {format_spec(parse(custom, len(net)), len(net))}:")
    print(f"  latency {m.latency_s*1e3:.1f} ms, throughput "
          f"{m.throughput_ips:.1f}/s, buffers {m.buffer_bytes/2**20:.2f} MiB")

    # -- 4. the same session batches: one search-kernel launch a chunk on the
    # card over many designs, through the session's shared tables --------
    batch = ses.evaluate(list(designs.values()) + [parse(custom, len(net))],
                         net)
    print(f"\nbatched re-evaluation of all {len(batch['latency_s'])} designs "
          f"(shared tables + one compiled program):")
    print("  latencies:",
          " ".join(f"{x*1e3:.1f}ms" for x in batch["latency_s"]))


if __name__ == "__main__":
    sys.exit(main())
