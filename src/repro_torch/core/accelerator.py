"""Bottom-up composition: from block models to a full accelerator (paper §IV-B).

Given a *concrete* accelerator (CE resources already distributed by the
Builder), evaluates latency, throughput, on-chip buffers and off-chip accesses
using generalized versions of Eqs. 1-7, i.e. Eqs. 8-9 and the §IV-B1 rules:

* inter-segment pipelining  -> throughput = 1 / slowest-stage busy time,
  latency = sum of segment latencies (+ inter-segment communication);
* no inter-segment pipelining -> throughput = 1 / latency;
* a CE serving multiple segments is busy for the sum of those segments
  (its buffer was sized for the worst case by the Builder, Eq. 8);
* inter-segment double buffers spill to off-chip when they do not fit,
  adding 2x their size to accesses (Eq. 9).

A copy of the JAX package's ``core/accelerator.py`` (plain Python).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from .blocks import CE, BlockResult, eval_pipelined, eval_single_ce
from .device import DeviceSpec
from .notation import AcceleratorSpec, SegmentSpec
from .workload import Network


@dataclass
class ConcreteSegment:
    spec: SegmentSpec
    ces: list[CE]                       # one (single) or many (pipelined)
    weights_resident: bool | None = None  # pipelined blocks only


@dataclass
class ConcreteAccelerator:
    """Builder output: spec + concrete resources, ready to evaluate."""

    spec: AcceleratorSpec
    network: Network
    device: DeviceSpec
    segments: list[ConcreteSegment]
    inter_seg_onchip: list[bool] = field(default_factory=list)  # per boundary
    inter_seg_buffer_bytes: list[int] = field(default_factory=list)


@dataclass
class SegmentMetrics:
    index: int
    n_layers: int
    latency_s: float
    busy_s: float
    compute_s: float
    mem_s: float
    buffer_bytes: int
    access_bytes: float
    utilization: float


@dataclass
class Metrics:
    """The four headline MCCM outputs + fine-grained breakdowns.

    ``buffer_bytes`` is the Eq. 8 *requirement* — the on-chip buffer the
    design needs to guarantee minimum off-chip accesses (Σ per-segment
    Eq. 4/5 + all inter-segment double buffers), the quantity the paper
    reports in Table I/V and Figs. 8–10.  ``buffer_alloc_bytes`` is what
    the Builder could actually allocate within the board's BRAM (used by
    the access model, Eq. 6/7)."""

    latency_s: float
    throughput_ips: float
    buffer_bytes: int              # requirement (Eq. 8)
    buffer_alloc_bytes: int        # allocation within the board budget
    access_bytes: float
    weight_access_bytes: float
    fm_access_bytes: float
    per_segment: list[SegmentMetrics]
    blocks: list[BlockResult]
    #: steady-state busy seconds charged to each physical CE id (the
    #: Eq. 8 busy-time ledger; its max bounds pipelined throughput) —
    #: what `repro_torch.telemetry.report` ranks for bottleneck attribution
    ce_busy_s: dict[int, float] = field(default_factory=dict)

    def as_dict(self) -> dict:
        return {
            "latency_s": self.latency_s,
            "throughput_ips": self.throughput_ips,
            "buffer_mib": self.buffer_bytes / 2**20,
            "access_mb": self.access_bytes / 1e6,
        }


def evaluate(acc: ConcreteAccelerator) -> Metrics:
    dev, net, spec = acc.device, acc.network, acc.spec
    bps = dev.off_chip_gbps * 1e9

    blocks: list[BlockResult] = []
    seg_metrics: list[SegmentMetrics] = []
    # steady-state busy time charged to each physical CE id (Eq. 8 note:
    # one CE may serve several segments -> its busy times add up)
    ce_busy: dict[int, float] = {}

    for i, (sseg, cseg) in enumerate(zip(spec.segments, acc.segments)):
        layers = net.slice(sseg.layer_lo, sseg.layer_hi)
        prev_onchip = i > 0 and acc.inter_seg_onchip[i - 1]
        if sseg.pipelined:
            res = eval_pipelined(
                layers, cseg.ces, dev, weights_resident=cseg.weights_resident
            )
        else:
            res = eval_single_ce(layers, cseg.ces[0], dev, ifm_onchip_first=prev_onchip)
        blocks.append(res)
        for off, ce_id in enumerate(range(sseg.ce_lo, sseg.ce_hi + 1)):
            if sseg.pipelined:
                # per-CE busy recorded inside block busy (max); approximate by
                # charging the block busy to its slowest CE and 0 to others —
                # the block-level max is what bounds throughput.
                ce_busy[ce_id] = ce_busy.get(ce_id, 0.0)
            else:
                ce_busy[ce_id] = ce_busy.get(ce_id, 0.0) + res.busy_cycles
        if sseg.pipelined:
            slow = sseg.ce_lo  # representative slot for the block max
            ce_busy[slow] = ce_busy.get(slow, 0.0) + res.busy_cycles

        comp = sum(r.compute_cycles for r in res.per_layer)
        mem = sum(r.mem_cycles for r in res.per_layer)
        util = (
            sum(r.utilization * r.layer.macs for r in res.per_layer)
            / max(sum(r.layer.macs for r in res.per_layer), 1)
        )
        seg_metrics.append(
            SegmentMetrics(
                index=i,
                n_layers=sseg.n_layers,
                latency_s=res.latency_cycles / dev.clock_hz,
                busy_s=res.busy_cycles / dev.clock_hz,
                compute_s=comp / dev.clock_hz,
                mem_s=mem / dev.clock_hz,
                buffer_bytes=res.buffer_bytes,
                access_bytes=res.access_bytes,
                utilization=util,
            )
        )

    # ---- interfaces: mandatory first-IFM load / last-OFM store + Eq. 9 ----
    wb = dev.wordbytes
    access = sum(b.access_bytes for b in blocks)
    w_access = sum(b.weight_access_bytes for b in blocks)
    fm_access = sum(b.fm_access_bytes for b in blocks)
    mandatory = (net.layers[0].ifm_size + net.layers[-1].ofm_size) * wb
    access += mandatory
    fm_access += mandatory

    comm_cycles = 0.0
    for i in range(len(spec.segments) - 1):
        boundary = net.layers[spec.segments[i].layer_hi]
        size = boundary.ofm_size * wb
        if not acc.inter_seg_onchip[i]:
            access += 2 * size          # Eq. 9: store + load
            fm_access += 2 * size
            comm_cycles += 2 * size / bps * dev.clock_hz
        else:
            comm_cycles += size / bps * dev.clock_hz  # on-chip hand-off: modelled free-ish

    latency_cycles = sum(s.latency_s for s in seg_metrics) * dev.clock_hz + comm_cycles
    latency_s = latency_cycles / dev.clock_hz

    if spec.inter_segment_pipelining and len(spec.segments) > 1:
        bottleneck = max(ce_busy.values()) if ce_busy else latency_cycles
        throughput = dev.clock_hz / bottleneck if bottleneck else math.inf
    else:
        # single block (e.g. SegmentedRR): its internal pipelining still
        # decouples throughput from latency via block busy time
        busy = max((b.busy_cycles for b in blocks), default=latency_cycles)
        if len(blocks) > 1:
            busy = latency_cycles  # sequential segments, no overlap
        throughput = dev.clock_hz / busy if busy else math.inf

    buffer_alloc = sum(b.buffer_bytes for b in blocks) + sum(
        2 * sz for sz, on in zip(acc.inter_seg_buffer_bytes, acc.inter_seg_onchip) if on
    )
    # Eq. 8 requirement: per-segment minimum-access buffers + double buffers
    # on every boundary (when inter-segment pipelining is used)
    buffer_req = sum(b.min_access_buffer_bytes for b in blocks)
    if spec.inter_segment_pipelining:
        buffer_req += sum(2 * sz for sz in acc.inter_seg_buffer_bytes)

    return Metrics(
        latency_s=latency_s,
        throughput_ips=throughput,
        buffer_bytes=buffer_req,
        buffer_alloc_bytes=buffer_alloc,
        access_bytes=access,
        weight_access_bytes=w_access,
        fm_access_bytes=fm_access,
        per_segment=seg_metrics,
        blocks=blocks,
        ce_busy_s={ce: busy / dev.clock_hz
                   for ce, busy in sorted(ce_busy.items())},
    )
