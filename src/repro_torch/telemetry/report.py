"""Bottleneck attribution: the paper's use-case-2 story as an API.

MCCM's fine-grained evaluation exists to answer *where does the time go*
— which segment stalls on memory (Fig. 6), whether weights or feature
maps dominate off-chip traffic (Fig. 7), and which CE bounds steady-state
throughput (Eq. 8's busy-time max).  The scalar evaluator already
computes all of it (``Metrics.per_segment`` / ``.blocks`` /
``.ce_busy_s``); :func:`bottleneck_report` turns those raw breakdowns
into one ranked, machine-readable attribution dict, and
:func:`format_report` renders it for humans.  ``Session.explain`` is the
front-door wrapper.

A copy of the JAX package's ``telemetry/report.py`` without its
``schedule`` section, which comes with the port's schedule layer.
"""
from __future__ import annotations

from ..core.accelerator import Metrics

__all__ = ["bottleneck_report", "format_report"]


def bottleneck_report(m: Metrics) -> dict:
    """Rank where a design's time and traffic go.

    Returns a dict with:

    * ``segments`` — per-segment compute vs memory seconds, bound kind
      and stall time, **ranked** by occupancy (``max(compute, mem)``)
      descending: the first row is the segment to fix;
    * ``ces`` — per-CE steady-state busy seconds ranked descending; the
      first row is the CE bounding pipelined throughput;
    * ``mem_bound_layers`` / ``idle_fraction`` — Fig. 6's layer-granular
      view: layers whose memory time exceeds compute time, and the
      fraction of occupied time CEs spend waiting for data;
    * ``access`` — Fig. 7's off-chip breakdown (weights vs feature
      maps) with the dominant class called out;
    * ``bottleneck`` — the one-line verdict: the ranked-first segment,
      its bound kind, and the busiest CE.
    """
    total_occ = sum(max(s.compute_s, s.mem_s) for s in m.per_segment) or 1.0
    segments = []
    for s in m.per_segment:
        occ = max(s.compute_s, s.mem_s)
        segments.append({
            "index": s.index,
            "n_layers": s.n_layers,
            "compute_s": s.compute_s,
            "mem_s": s.mem_s,
            "busy_s": s.busy_s,
            "latency_s": s.latency_s,
            "occupancy_s": occ,
            "share": occ / total_occ,
            "bound": "memory" if s.mem_s > s.compute_s else "compute",
            "stall_s": max(s.mem_s - s.compute_s, 0.0),
            "utilization": s.utilization,
            "buffer_bytes": s.buffer_bytes,
            "access_bytes": s.access_bytes,
        })
    # stable rank: occupancy descending, original order breaking ties —
    # deterministic, so the ranking is reproducible bit-for-bit
    segments.sort(key=lambda d: (-d["occupancy_s"], d["index"]))
    for rank, d in enumerate(segments):
        d["rank"] = rank

    # ---- Fig. 6 layer granularity (the SegmentedRR story) -------------
    mem_bound_layers = [r.layer.index for b in m.blocks for r in b.per_layer
                        if r.mem_cycles > r.compute_cycles]
    occ_cycles = sum(max(r.mem_cycles, r.compute_cycles)
                     for b in m.blocks for r in b.per_layer)
    stall_cycles = sum(max(r.mem_cycles - r.compute_cycles, 0.0)
                       for b in m.blocks for r in b.per_layer)
    idle_fraction = stall_cycles / occ_cycles if occ_cycles else 0.0

    # ---- Eq. 8 busy-time ranking: the CE bounding throughput ----------
    ces = [{"ce": ce, "busy_s": busy}
           for ce, busy in m.ce_busy_s.items()]
    total_busy = sum(c["busy_s"] for c in ces) or 1.0
    for c in ces:
        c["share"] = c["busy_s"] / total_busy
    ces.sort(key=lambda d: (-d["busy_s"], d["ce"]))
    for rank, c in enumerate(ces):
        c["rank"] = rank

    # ---- Fig. 7 off-chip access breakdown ------------------------------
    access = {
        "weights_bytes": float(m.weight_access_bytes),
        "fm_bytes": float(m.fm_access_bytes),
        "total_bytes": float(m.access_bytes),
        "weights_frac": (float(m.weight_access_bytes)
                         / float(m.access_bytes) if m.access_bytes else 0.0),
        "dominant": ("weights" if m.weight_access_bytes > m.fm_access_bytes
                     else "fms"),
    }

    top = segments[0] if segments else None
    return {
        "summary": {
            "latency_s": m.latency_s,
            "throughput_ips": m.throughput_ips,
            "buffer_bytes": int(m.buffer_bytes),
            "access_bytes": float(m.access_bytes),
        },
        "segments": segments,
        "ces": ces,
        "mem_bound_layers": mem_bound_layers,
        "idle_fraction": idle_fraction,
        "access": access,
        "bottleneck": {
            "segment": top["index"] if top else None,
            "bound": top["bound"] if top else None,
            "share": top["share"] if top else 0.0,
            "ce": ces[0]["ce"] if ces else None,
            "ce_busy_s": ces[0]["busy_s"] if ces else 0.0,
        },
    }


def format_report(rep: dict) -> str:
    """Human-readable rendering of :func:`bottleneck_report`."""
    s = rep["summary"]
    b = rep["bottleneck"]
    lines = [
        f"latency {s['latency_s'] * 1e3:.3f} ms | "
        f"throughput {s['throughput_ips']:.1f} inf/s | "
        f"buffer {s['buffer_bytes'] / 2**20:.2f} MiB | "
        f"off-chip {s['access_bytes'] / 1e6:.1f} MB",
        f"bottleneck: segment {b['segment']} ({b['bound']}-bound, "
        f"{b['share']:.0%} of occupancy), CE{b['ce']} busiest "
        f"({b['ce_busy_s'] * 1e3:.3f} ms/input)",
        f"idle fraction {rep['idle_fraction']:.1%} "
        f"({len(rep['mem_bound_layers'])} memory-bound layer(s))",
        f"off-chip split: weights {rep['access']['weights_frac']:.0%} "
        f"(dominant: {rep['access']['dominant']})",
        "",
        "rank  seg  bound    occupancy_s    stall_s      share  layers",
    ]
    for d in rep["segments"]:
        lines.append(
            f"{d['rank']:>4}  {d['index']:>3}  {d['bound']:<7}"
            f"{d['occupancy_s']:>12.6f} {d['stall_s']:>10.6f}"
            f"{d['share']:>10.1%}  {d['n_layers']}")
    lines.append("")
    lines.append("rank  CE   busy_s        share")
    for c in rep["ces"]:
        lines.append(f"{c['rank']:>4}  {c['ce']:<4}"
                     f"{c['busy_s']:>10.6f} {c['share']:>10.1%}")
    return "\n".join(lines)
