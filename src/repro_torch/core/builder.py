"""Multiple-CE Builder (paper §III-A): notation + CNN + board -> concrete accelerator.

Implements the resource-distribution heuristics the paper attributes to the
Builder module (inspired by [3], [23], [30], [33], [41]):

* **PEs** are distributed across all CEs proportionally to the MAC workload
  each CE is responsible for (largest-remainder rounding, >=1 PE each);
* **parallelism** per CE is the 3-D <filters, OFM-rows, OFM-cols> vector that
  minimises the CE's total cycles over its assigned layers (Ma et al. [23]);
* **buffers**: every block first receives a floor (minimal working tiles),
  inter-segment double buffers are placed on-chip smallest-first while they
  fit, and the remaining budget is distributed proportionally to each block's
  outstanding minimum-access requirement (Eq. 4 / Eq. 5), capped at it.

A copy of the JAX package's ``core/builder.py``.  It runs on the host in
plain Python, whatever device a Session evaluates batches on.
"""
from __future__ import annotations

from dataclasses import dataclass

from .accelerator import ConcreteAccelerator, ConcreteSegment
from .blocks import CE, best_parallelism, pipelined_min_buffer, single_ce_min_buffer
from .device import DeviceSpec
from .notation import AcceleratorSpec
from .workload import ConvLayer, Network


@dataclass
class BuilderOptions:
    fm_tile_rows: int = 2
    par_candidates: tuple[int, ...] | None = None


def _largest_remainder(shares: list[float], total: int, floor: int = 1) -> list[int]:
    """Distribute ``total`` integers proportionally to ``shares`` (>= floor)."""
    n = len(shares)
    total = max(total, n * floor)
    s = sum(shares) or 1.0
    raw = [max(x / s * total, floor) for x in shares]
    out = [max(int(r), floor) for r in raw]
    rem = total - sum(out)
    # hand out remaining units to the largest fractional remainders
    order = sorted(range(n), key=lambda i: raw[i] - int(raw[i]), reverse=True)
    i = 0
    while rem > 0 and n:
        out[order[i % n]] += 1
        rem -= 1
        i += 1
    while rem < 0 and n:  # over-allocated due to floors: take from largest
        j = max(range(n), key=lambda k: out[k])
        if out[j] > floor:
            out[j] -= 1
            rem += 1
        else:
            break
    return out


def _ce_layer_map(spec: AcceleratorSpec, net: Network) -> dict[int, list[ConvLayer]]:
    """Which layers each physical CE id processes (round-robin for pipelined).

    CEs with no layers (a pipelined block wider than its segment) are dead
    silicon: present with an empty list, allotted no resources."""
    assign: dict[int, list[ConvLayer]] = {}
    for seg in spec.segments:
        n_ces = seg.n_ces
        for ce_id in range(seg.ce_lo, seg.ce_hi + 1):
            assign.setdefault(ce_id, [])
        for k, li in enumerate(range(seg.layer_lo, seg.layer_hi + 1)):
            ce_id = seg.ce_lo + (k % n_ces)
            assign[ce_id].append(net[li])
    return assign


def _wtile_bytes(layer: ConvLayer, par_f: int, wb: int) -> int:
    c = 1 if layer.kind == "dw" else layer.in_ch
    return min(par_f, layer.out_ch) * c * layer.kh * layer.kw * wb


def build(
    spec: AcceleratorSpec,
    net: Network,
    dev: DeviceSpec,
    opts: BuilderOptions | None = None,
) -> ConcreteAccelerator:
    opts = opts or BuilderOptions()
    spec.validate(len(net))
    wb = dev.wordbytes

    # ---- 1. PE distribution (proportional to per-CE MACs) ----------------
    assign = _ce_layer_map(spec, net)
    ce_ids = sorted(assign)
    live = [c for c in ce_ids if assign[c]]
    macs = [sum(l.macs for l in assign[c]) for c in live]
    pes = dict(zip(live, _largest_remainder(macs, dev.pes)))
    for c in ce_ids:           # dead slots (block wider than segment)
        pes.setdefault(c, 0)

    # ---- 2. parallelism vectors ------------------------------------------
    pars = {
        c: (best_parallelism(pes[c], assign[c], opts.par_candidates)
            if assign[c] else {"f": 1, "oh": 1, "ow": 1})
        for c in ce_ids
    }

    # ---- 3. buffer floors and desires per block --------------------------
    floors: list[int] = []
    desires: list[int] = []
    for seg in spec.segments:
        layers = net.slice(seg.layer_lo, seg.layer_hi)
        if seg.pipelined:
            floor = 0
            for k, l in enumerate(layers):
                ce_id = seg.ce_lo + (k % seg.n_ces)
                floor += 2 * l.out_ch * l.ow * opts.fm_tile_rows * wb
                floor += _wtile_bytes(l, pars[ce_id].get("f", 1), wb)
            desire = pipelined_min_buffer(layers, dev, opts.fm_tile_rows)
        else:
            par_f = pars[seg.ce_lo].get("f", 1)
            floor = max(
                _wtile_bytes(l, par_f, wb)
                + l.in_ch * l.kh * l.iw * wb  # kh-row IFM band
                + l.out_ch * l.ow * wb        # one OFM row
                for l in layers
            )
            desire = single_ce_min_buffer(layers, par_f, wb)
        floors.append(floor)
        desires.append(max(desire, floor))

    budget = dev.on_chip_bytes
    alloc = list(floors)
    if sum(alloc) > budget:  # degenerate: scale floors down proportionally
        scale = budget / sum(alloc)
        alloc = [int(a * scale) for a in alloc]
    remaining = budget - sum(alloc)

    # ---- 4. inter-segment double buffers, smallest-first -----------------
    n_bounds = len(spec.segments) - 1
    inter_sizes = [
        net[spec.segments[i].layer_hi].ofm_size * wb for i in range(n_bounds)
    ]
    inter_onchip = [False] * n_bounds
    if spec.inter_segment_pipelining:
        for i in sorted(range(n_bounds), key=lambda k: inter_sizes[k]):
            if 2 * inter_sizes[i] <= remaining:
                inter_onchip[i] = True
                remaining -= 2 * inter_sizes[i]

    # ---- 5. distribute remaining budget toward minimum-access sizes ------
    gaps = [max(d - a, 0) for d, a in zip(desires, alloc)]
    gap_sum = sum(gaps)
    if gap_sum and remaining > 0:
        grant = min(remaining, gap_sum)
        for i, g in enumerate(gaps):
            alloc[i] += int(grant * (g / gap_sum))

    # ---- 6. materialise CEs ----------------------------------------------
    segments: list[ConcreteSegment] = []
    for i, seg in enumerate(spec.segments):
        layers = net.slice(seg.layer_lo, seg.layer_hi)
        if seg.pipelined:
            # split the block budget across its CEs by per-CE desire share
            ce_list = []
            ce_desires = []
            for slot in range(seg.n_ces):
                ls = [l for k, l in enumerate(layers) if k % seg.n_ces == slot]
                ce_desires.append(
                    sum(
                        (l.weights_size + 2 * l.out_ch * l.ow * opts.fm_tile_rows) * wb
                        for l in ls
                    )
                )
            d_sum = sum(ce_desires) or 1
            for slot in range(seg.n_ces):
                ce_id = seg.ce_lo + slot
                ce_list.append(
                    CE(
                        name=f"CE{ce_id + 1}",
                        pes=pes[ce_id],
                        par=pars[ce_id],
                        buffer_bytes=int(alloc[i] * ce_desires[slot] / d_sum),
                    )
                )
            resident = alloc[i] >= desires[i]
            segments.append(ConcreteSegment(spec=seg, ces=ce_list, weights_resident=resident))
        else:
            ce_id = seg.ce_lo
            ce = CE(
                name=f"CE{ce_id + 1}",
                pes=pes[ce_id],
                par=pars[ce_id],
                buffer_bytes=alloc[i],
            )
            segments.append(ConcreteSegment(spec=seg, ces=[ce]))

    return ConcreteAccelerator(
        spec=spec,
        network=net,
        device=dev,
        segments=segments,
        inter_seg_onchip=inter_onchip,
        inter_seg_buffer_bytes=inter_sizes,
    )
