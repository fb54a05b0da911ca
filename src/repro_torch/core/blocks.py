"""MCCM building-block models: single-CE and pipelined-CEs (paper §IV-A).

Implements Eq. 1 (single-CE latency with PE underutilisation), Eq. 2/3
(pipelined-CEs latency/throughput), Eq. 4/5 (minimum-access buffer
requirements) and Eq. 6/7 (off-chip accesses under a finite buffer budget).

Conventions
-----------
* latencies are in **cycles** (DeviceSpec converts to seconds),
* sizes are in **elements** unless the name says ``_bytes``,
* a *block* evaluation returns per-layer records so the fine-grained
  use case (paper Fig. 6/7/9) can break results down.

A copy of the JAX package's ``core/blocks.py``: plain Python on ints, no
tensors.  The port keeps its own, so that it imports nothing of that
package, and the scalar Builder (``core.builder``) and the batch path's
candidate list (``CANDIDATES_DEFAULT``) both come from here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Sequence

from .device import DeviceSpec
from .workload import DIMS, ConvLayer


# --------------------------------------------------------------------------
# Compute engines
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class CE:
    """A compute engine: a PE grid with a parallelism vector and a buffer."""

    name: str
    pes: int
    par: dict[str, int]          # parallelism per loop dim, prod <= pes
    buffer_bytes: int = 0        # on-chip buffer allocated to this CE

    def __post_init__(self):
        prod = 1
        for d in DIMS:
            prod *= self.par.get(d, 1)
        if prod > max(self.pes, 1):
            raise ValueError(
                f"CE {self.name}: parallelism product {prod} exceeds PEs {self.pes}"
            )

    def par_of(self, d: str) -> int:
        return self.par.get(d, 1)


def layer_cycles(layer: ConvLayer, ce: CE) -> int:
    """Eq. 1 inner term: Lat(L_i, CE_j) = prod_d ceil(|d| / Par(CE_j, d))."""
    cyc = 1
    dims = layer.dims()
    for d in DIMS:
        cyc *= -(-dims[d] // ce.par_of(d))
    return cyc


def layer_utilization(layer: ConvLayer, ce: CE) -> float:
    """Fraction of PE-cycles doing useful MACs (1 - underutilisation)."""
    cyc = layer_cycles(layer, ce)
    par = 1
    for d in DIMS:
        par *= ce.par_of(d)
    return layer.macs / (cyc * par) if cyc else 0.0


CANDIDATES_DEFAULT = (1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128,
                      192, 256, 384, 512)


def best_parallelism(
    pes: int, layers: Sequence[ConvLayer], candidates: Sequence[int] | None = None
) -> dict[str, int]:
    """Builder heuristic: pick <par_f, par_oh, par_ow> minimising total cycles.

    3-D parallelism across filters and within OFM rows/cols, per the
    exhaustive FPGA analysis of Ma et al. [23] cited by the paper.
    """
    if candidates is None:
        candidates = list(CANDIDATES_DEFAULT)
    pes = max(pes, 1)
    best, best_cost = {"f": 1, "oh": 1, "ow": 1}, None
    for pf in candidates:
        if pf > pes:
            break
        for ph in candidates:
            if pf * ph > pes:
                break
            # greedily take the largest feasible pw candidate
            pw = 1
            for c in candidates:
                if pf * ph * c <= pes:
                    pw = c
                else:
                    break
            par = {"f": pf, "oh": ph, "ow": pw}
            ce = CE(name="probe", pes=pes, par=par)
            cost = sum(layer_cycles(l, ce) for l in layers)
            if best_cost is None or cost < best_cost:
                best, best_cost = par, cost
    return best


# --------------------------------------------------------------------------
# Per-layer / per-block result records
# --------------------------------------------------------------------------
@dataclass
class LayerResult:
    layer: ConvLayer
    compute_cycles: int
    mem_cycles: float
    access_bytes: float
    weight_access_bytes: float
    fm_access_bytes: float
    utilization: float

    @property
    def cycles(self) -> float:
        # double-buffered overlap: the slower of compute and memory wins
        return max(self.compute_cycles, self.mem_cycles)


@dataclass
class BlockResult:
    kind: str                       # 'single' | 'pipelined'
    latency_cycles: float           # one-input latency
    busy_cycles: float              # steady-state per-input occupancy (1/thpt)
    buffer_bytes: int               # allocated
    min_access_buffer_bytes: int    # Eq. 4 / Eq. 5 requirement
    access_bytes: float             # per-input steady state
    weight_access_bytes: float
    fm_access_bytes: float
    per_layer: list[LayerResult] = field(default_factory=list)

    @property
    def throughput(self) -> float:
        return 1.0 / self.busy_cycles if self.busy_cycles else math.inf


# --------------------------------------------------------------------------
# single-CE block (paper Fig. 4a)
# --------------------------------------------------------------------------
def single_ce_min_buffer(layers: Sequence[ConvLayer], ce_par_f: int, wordbytes: int) -> int:
    """Eq. 4: max FMs + max weights tile (elements -> bytes)."""
    max_fms = max(l.fms_size for l in layers)
    max_wtile = max(_weight_tile(l, ce_par_f) for l in layers)
    return (max_fms + max_wtile) * wordbytes


def _weight_tile(layer: ConvLayer, par_f: int) -> int:
    """Weights slice in flight: the filters currently being computed."""
    c = 1 if layer.kind == "dw" else layer.in_ch
    return min(par_f, layer.out_ch) * c * layer.kh * layer.kw


def _single_layer_access(
    layer: ConvLayer,
    buffer_bytes: int,
    par_f: int,
    wordbytes: int,
    ifm_onchip: bool,
) -> tuple[float, float, float, bool]:
    """Eq. 6 for one layer.

    Returns (total_access_bytes, weight_bytes, fm_bytes, ofm_stays_onchip).
    """
    wb = wordbytes
    w, ifm, ofm = layer.weights_size * wb, layer.ifm_size * wb, layer.ofm_size * wb
    extra = layer.ofm_size * wb if layer.residual else 0
    wtile = _weight_tile(layer, par_f) * wb

    # Ideal: IFM + OFM (+res) + streaming weight tile fit -> one access/weight.
    if ifm + ofm + extra + wtile <= buffer_bytes:
        fm_acc = 0.0 if ifm_onchip else ifm
        return w + fm_acc, w, fm_acc, True

    # OFM kept on-chip if it fits next to minimal working tiles.
    ifm_tile = min(ifm, layer.in_ch * layer.kh * layer.iw * wb)  # kh-row band
    ofm_onchip = ofm + extra + wtile + ifm_tile <= buffer_bytes
    ofm_resident = (ofm + extra) if ofm_onchip else 0
    ofm_acc = 0.0 if ofm_onchip else float(ofm)

    if ifm_onchip:
        # Whole IFM already resident from the previous layer: weights stream once.
        return ofm_acc + w, w, ofm_acc, ofm_onchip

    # Option A — output-stationary, locally input-stationary:
    ifm_buf = max(buffer_bytes - ofm_resident - wtile, ifm_tile)
    loads_a = w * math.ceil(ifm / ifm_buf) + ifm if ifm_buf < ifm else w + ifm
    wacc_a = loads_a - ifm
    # Option B — output-stationary, locally weight-stationary:
    w_buf = max(buffer_bytes - ofm_resident - ifm_tile, wtile)
    loads_b = ifm * math.ceil(w / w_buf) + w if w_buf < w else ifm + w
    facc_b = loads_b - w

    if loads_a <= loads_b:
        return ofm_acc + loads_a, wacc_a, ofm_acc + ifm, ofm_onchip
    return ofm_acc + loads_b, float(w), ofm_acc + facc_b, ofm_onchip


def eval_single_ce(
    layers: Sequence[ConvLayer],
    ce: CE,
    dev: DeviceSpec,
    ifm_onchip_first: bool = False,
) -> BlockResult:
    """Evaluate a single-CE block over a layer range (Eq. 1 + 4 + 6)."""
    bpc = dev.off_chip_bytes_per_cycle
    results: list[LayerResult] = []
    ifm_onchip = ifm_onchip_first
    for layer in layers:
        comp = layer_cycles(layer, ce)
        acc, wacc, facc, ofm_onchip = _single_layer_access(
            layer, ce.buffer_bytes, ce.par_of("f"), dev.wordbytes, ifm_onchip
        )
        results.append(
            LayerResult(
                layer=layer,
                compute_cycles=comp,
                mem_cycles=acc / bpc,
                access_bytes=acc,
                weight_access_bytes=wacc,
                fm_access_bytes=facc,
                utilization=layer_utilization(layer, ce),
            )
        )
        ifm_onchip = ofm_onchip
    latency = sum(r.cycles for r in results)
    return BlockResult(
        kind="single",
        latency_cycles=latency,
        busy_cycles=latency,
        buffer_bytes=ce.buffer_bytes,
        min_access_buffer_bytes=single_ce_min_buffer(layers, ce.par_of("f"), dev.wordbytes),
        access_bytes=sum(r.access_bytes for r in results),
        weight_access_bytes=sum(r.weight_access_bytes for r in results),
        fm_access_bytes=sum(r.fm_access_bytes for r in results),
        per_layer=results,
    )


# --------------------------------------------------------------------------
# pipelined-CEs block (paper Fig. 4b)
# --------------------------------------------------------------------------
def pipelined_min_buffer(
    layers: Sequence[ConvLayer], dev: DeviceSpec, fm_tile_rows: int = 2
) -> int:
    """Eq. 5: sum of all weights + 2x FM tile buffers (double buffering)."""
    wb = dev.wordbytes
    total = 0
    for l in layers:
        fm_tile = l.out_ch * l.ow * fm_tile_rows
        total += l.weights_size * wb + 2 * fm_tile * wb
    return total


def fm_tile_buffer(layer: ConvLayer, fm_tile_rows: int = 2) -> int:
    return layer.out_ch * layer.ow * fm_tile_rows


def _pipeline_rounds(n_layers: int, n_ces: int) -> list[list[int]]:
    """Round-robin layer assignment: round r -> layers [r*n .. r*n+n-1]."""
    return [
        list(range(r * n_ces, min((r + 1) * n_ces, n_layers)))
        for r in range(-(-n_layers // n_ces))
    ]


def pipeline_stage_sum(tile_lats: Sequence[float], n_tiles: int) -> float:
    """Eq. 2 closed form: sum over stages of max over active CEs.

    CE_j (0-based) processes tile t at stage t + j; stages run
    0 .. n_tiles + n_ces - 2; active at stage s: {j : s - n_tiles < j <= s}.
    """
    n = len(tile_lats)
    if n == 0:
        return 0.0
    total = 0.0
    for s in range(n_tiles + n - 1):
        lo, hi = max(0, s - n_tiles + 1), min(n - 1, s)
        total += max(tile_lats[lo : hi + 1])
    return total


def eval_pipelined(
    layers: Sequence[ConvLayer],
    ces: Sequence[CE],
    dev: DeviceSpec,
    weights_resident: bool | None = None,
    fm_tile_rows: int = 2,
) -> BlockResult:
    """Evaluate a pipelined-CEs block (Eq. 2 + 3 + 5 + 7).

    ``weights_resident``: all weights of the block's layers stay on-chip after
    the first image (the Eq. 5 minimum-access regime).  If None it is derived
    from the CE buffer allocations.
    """
    wb, bpc = dev.wordbytes, dev.off_chip_bytes_per_cycle
    n_ces = len(ces)
    rounds = _pipeline_rounds(len(layers), n_ces)
    multi_round = len(rounds) > 1

    if weights_resident is None:
        need = pipelined_min_buffer(layers, dev, fm_tile_rows)
        weights_resident = (not multi_round) and sum(c.buffer_bytes for c in ces) >= need

    per_layer: list[LayerResult] = []
    latency = 0.0
    busy = [0.0] * n_ces  # per-CE steady-state occupancy per input (Eq. 3)
    for rnd in rounds:
        n_tiles = max(layers[li].oh for li in rnd)  # row-granular tiles
        tile_lats = []
        for slot, li in enumerate(rnd):
            layer, ce = layers[li], ces[slot]
            comp = layer_cycles(layer, ce)
            # Eq. 7: weight traffic if not resident; reload per round.
            w_bytes = layer.weights_size * wb
            if weights_resident:
                w_acc = 0.0  # amortised after first image
            elif ce.buffer_bytes >= w_bytes:
                w_acc = float(w_bytes)  # buffered per round, streamed once/image
            else:
                # cannot hold the layer's weights: re-streamed every tile-stage
                w_acc = float(w_bytes) * n_tiles
            mem_cyc = w_acc / bpc
            tile_lat = max(comp, mem_cyc) / n_tiles
            tile_lats.append(tile_lat)
            busy[slot] += max(comp, mem_cyc)
            per_layer.append(
                LayerResult(
                    layer=layer,
                    compute_cycles=comp,
                    mem_cycles=mem_cyc,
                    access_bytes=w_acc,
                    weight_access_bytes=w_acc,
                    fm_access_bytes=0.0,
                    utilization=layer_utilization(layer, ce),
                )
            )
        latency += pipeline_stage_sum(tile_lats, n_tiles)

    return BlockResult(
        kind="pipelined",
        latency_cycles=latency,
        busy_cycles=max(busy) if busy else 0.0,
        buffer_bytes=sum(c.buffer_bytes for c in ces),
        min_access_buffer_bytes=pipelined_min_buffer(layers, dev, fm_tile_rows),
        access_bytes=sum(r.access_bytes for r in per_layer),
        weight_access_bytes=sum(r.weight_access_bytes for r in per_layer),
        fm_access_bytes=0.0,
        per_layer=per_layer,
    )
