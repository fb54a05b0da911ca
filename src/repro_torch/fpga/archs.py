"""The three state-of-the-art multiple-CE architecture templates (paper §II-C).

* Segmented    — Shen et al. [33]: n single-CE segments, coarse pipelining.
* SegmentedRR  — Wei et al. [41] tiling + Ma et al. [23] engines: one
                 pipelined-CEs block processing all layers round-robin.
* Hybrid       — Qararyah et al. [30] (FiBHA): n-1 per-layer pipelined CEs,
                 then one pooled CE for the rest, coarse pipelining between.
"""
from __future__ import annotations

from ..core.notation import AcceleratorSpec, SegmentSpec
from ..core.workload import Network

ARCH_NAMES = ("segmented", "segmented_rr", "hybrid")


def balanced_partition(weights: list[float], n: int) -> list[int]:
    """Contiguous partition of ``weights`` into n parts with near-equal sums.

    Returns the (exclusive) end index of each part.  Prefix-crossing
    heuristic: boundary i at the first prefix >= (i+1)/n of the total.
    """
    n = min(n, len(weights))
    total = sum(weights)
    bounds, acc, k = [], 0.0, 1
    for i, x in enumerate(weights):
        acc += x
        remaining_items = len(weights) - (i + 1)
        remaining_parts = n - k
        if (acc >= total * k / n and remaining_items >= remaining_parts) or (
            remaining_items == remaining_parts and len(bounds) < k
        ):
            if len(bounds) < k - 0:
                bounds.append(i + 1)
                k += 1
            if k > n - 1:
                break
    while len(bounds) < n - 1:  # degenerate fill
        bounds.append(min(len(weights) - (n - 1 - len(bounds)), len(weights) - 1))
    bounds.append(len(weights))
    return bounds


def segmented(net: Network, n_ces: int) -> AcceleratorSpec:
    """n single-CE segments, MAC-balanced, coarse (inter-segment) pipelining."""
    macs = [float(l.macs) for l in net]
    bounds = balanced_partition(macs, n_ces)
    segs, lo = [], 0
    for ce, hi in enumerate(bounds):
        segs.append(SegmentSpec(lo, hi - 1, ce, ce))
        lo = hi
    return AcceleratorSpec(
        name=f"segmented[{len(segs)}]",
        segments=tuple(segs),
        inter_segment_pipelining=True,
    )


def segmented_rr(net: Network, n_ces: int) -> AcceleratorSpec:
    """{L1-Last:CE1-CEn}: tile-grained pipelined round-robin block."""
    return AcceleratorSpec(
        name=f"segmented_rr[{n_ces}]",
        segments=(SegmentSpec(0, len(net) - 1, 0, n_ces - 1),),
        inter_segment_pipelining=False,
    )


def hybrid(net: Network, n_ces: int) -> AcceleratorSpec:
    """First n-1 layers on per-layer pipelined CEs; the rest on one big CE."""
    if n_ces < 2:
        raise ValueError("hybrid needs >= 2 CEs")
    first = n_ces - 1
    segs = (
        SegmentSpec(0, first - 1, 0, first - 1),
        SegmentSpec(first, len(net) - 1, first, first),
    )
    return AcceleratorSpec(
        name=f"hybrid[{n_ces}]",
        segments=segs,
        inter_segment_pipelining=True,
    )


def make_arch(arch: str, net: Network, n_ces: int) -> AcceleratorSpec:
    if arch == "segmented":
        return segmented(net, n_ces)
    if arch == "segmented_rr":
        return segmented_rr(net, n_ces)
    if arch == "hybrid":
        return hybrid(net, n_ces)
    raise KeyError(f"unknown architecture {arch!r}; known: {ARCH_NAMES}")
