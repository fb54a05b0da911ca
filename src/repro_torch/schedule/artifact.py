"""The executable schedule artifact: what ``Session.schedule`` returns.

A copy of the JAX package's ``schedule/artifact.py``.

A :class:`ScheduleArtifact` is the decoded, host-side form of one
design's schedule search — per-layer chosen mappings, per-CE buffer
plans, per-segment refined-vs-coarse costs, and the refined
latency/energy headline.  It is plain dataclasses over plain Python
scalars, JSON-serializable and bit-identically round-trippable
(``to_json``/``from_json``; floats survive exactly because every stored
value is a Python float — json's repr round-trip is exact for binary64).

Energy is a documented first-order proxy (the repo's cost model has no
energy term of its own): off-chip traffic at ``E_DRAM_J_PER_BYTE`` plus
MACs at ``E_MAC_J`` — Horowitz-style constants (~20 pJ/bit DRAM,
~0.5 pJ/16-bit MAC), useful for *comparing* schedules, not for absolute
board power.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

import numpy as np

from ..kernels.schedule_score import NCAND, decode_candidate

#: off-chip DRAM access energy, J/byte (~20 pJ/bit)
E_DRAM_J_PER_BYTE = 160.0e-12
#: one 16-bit MAC, J (~0.5 pJ)
E_MAC_J = 0.5e-12


@dataclass(frozen=True)
class LayerSchedule:
    """One layer's chosen temporal mapping and its refined cost."""

    layer: int
    ce: int
    segment: int
    pipelined: bool
    order: str              # loop order (kernels.schedule_score.ORDER_NAMES)
    tile_frac: float
    double_buffer: bool
    phi: float              # resident weight fraction (pipelined orders)
    tile_bytes: float       # chosen streamed-operand / resident-slice tile
    buffer_bytes: float     # budget the tile was chosen under
    pf: float
    ph: float
    pw: float
    n_tiles: float
    latency_cyc: float      # refined per-layer cycles (busy for pipelined)
    coarse_cyc: float
    access_bytes: float     # refined off-chip bytes attributed to the layer


@dataclass(frozen=True)
class CEPlan:
    """One compute engine's buffer plan under the chosen schedule."""

    ce: int
    segment: int
    pipelined: bool
    buffer_bytes: float             # this CE's on-chip slice
    weight_resident_bytes: float    # resident weights across its layers
    layers: tuple[int, ...]


@dataclass(frozen=True)
class SegmentCost:
    """Per-segment refined-vs-coarse occupancy (explain attribution)."""

    segment: int
    pipelined: bool
    buffer_bytes: float
    coarse_cyc: float
    refined_cyc: float


@dataclass(frozen=True)
class ScheduleArtifact:
    """Everything the schedule search decided for one design."""

    net: str
    board: str
    design: str                     # notation / repr of the scheduled spec
    latency_s: float                # schedule-refined
    coarse_latency_s: float
    throughput_ips: float
    access_bytes: float             # schedule-refined off-chip traffic
    coarse_access_bytes: float
    energy_j: float                 # refined first-order proxy (module doc)
    coarse_energy_j: float
    buffer_bytes: float
    n_candidates: int               # mappings scored (valid layers x NCAND)
    layers: tuple[LayerSchedule, ...] = ()
    ce_plans: tuple[CEPlan, ...] = ()
    segments: tuple[SegmentCost, ...] = ()
    meta: dict = field(default_factory=dict)

    # ---- serialization ---------------------------------------------------
    def to_dict(self) -> dict:
        return asdict(self)

    def to_json(self, **kw) -> str:
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: dict) -> "ScheduleArtifact":
        d = dict(d)
        d["layers"] = tuple(LayerSchedule(**l) for l in d.get("layers", ()))
        d["ce_plans"] = tuple(CEPlan(ce=c["ce"], segment=c["segment"],
                                     pipelined=c["pipelined"],
                                     buffer_bytes=c["buffer_bytes"],
                                     weight_resident_bytes=c[
                                         "weight_resident_bytes"],
                                     layers=tuple(c["layers"]))
                              for c in d.get("ce_plans", ()))
        d["segments"] = tuple(SegmentCost(**s) for s in d.get("segments", ()))
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "ScheduleArtifact":
        return cls.from_dict(json.loads(s))


def energy_proxy(access_bytes: float, total_macs: float) -> float:
    """First-order energy in joules (see module docstring)."""
    return float(access_bytes) * E_DRAM_J_PER_BYTE \
        + float(total_macs) * E_MAC_J


def build_artifact(detail: dict, index: int, *, net, board_name: str,
                   design_repr: str, wordbytes: float) -> ScheduleArtifact:
    """Decode one design row of ``schedule_specs`` output into the
    artifact.  ``detail`` holds the host arrays (leading axis = designs);
    ``net`` is the Network (for layer weight sizes / total MACs)."""
    def row(key):
        return np.asarray(detail[key])[index]

    n_layers = len(net)
    valid = np.asarray(row("valid_l"), bool)
    pipe = np.asarray(row("pipe_l"), bool)
    choice = np.asarray(row("choice"), np.int64)
    ce_of = np.asarray(row("ce_of_layer"), np.int64)
    seg_of = np.asarray(row("seg_of_layer"), np.int64)

    layers = []
    for l in range(n_layers):
        if not valid[l]:
            continue
        mapping = decode_candidate(int(choice[l]))
        layers.append(LayerSchedule(
            layer=l, ce=int(ce_of[l]), segment=int(seg_of[l]),
            pipelined=bool(pipe[l]),
            order=mapping["order"], tile_frac=mapping["tile_frac"],
            double_buffer=mapping["double_buffer"],
            phi=float(row("phi")[l]),
            tile_bytes=float(row("tile_bytes")[l]),
            buffer_bytes=float(row("budget_bytes")[l]),
            pf=float(row("pf_l")[l]), ph=float(row("ph_l")[l]),
            pw=float(row("pw_l")[l]),
            n_tiles=float(row("n_tiles_l")[l]),
            latency_cyc=float(row("lat_ref_l")[l]),
            coarse_cyc=float(row("lat_coarse_l")[l]),
            access_bytes=float(row("acc_ref_l")[l])))

    plans: dict[int, dict] = {}
    for ls in layers:
        p = plans.setdefault(ls.ce, {
            "segment": ls.segment, "pipelined": ls.pipelined,
            "buffer_bytes": float(
                row("ce_buf_l")[ls.layer] if ls.pipelined
                else row("buf_l")[ls.layer]),
            "resident": 0.0, "layers": []})
        p["layers"].append(ls.layer)
        wl = float(net[ls.layer].weights_size) * float(wordbytes)
        if ls.pipelined:
            p["resident"] += float(ls.phi) * wl
    ce_plans = tuple(
        CEPlan(ce=ce, segment=p["segment"], pipelined=p["pipelined"],
               buffer_bytes=p["buffer_bytes"],
               weight_resident_bytes=p["resident"],
               layers=tuple(p["layers"]))
        for ce, p in sorted(plans.items()))

    seg_valid = np.asarray(row("seg_valid"), bool)
    segments = tuple(
        SegmentCost(segment=s,
                    pipelined=bool(np.any(pipe & valid & (seg_of == s))),
                    buffer_bytes=float(row("alloc_seg")[s]),
                    coarse_cyc=float(row("seg_cyc_coarse")[s]),
                    refined_cyc=float(row("seg_cyc_ref")[s]))
        for s in range(seg_valid.size) if seg_valid[s])

    access = float(row("ref_access_bytes"))
    coarse_access = float(row("coarse_access_bytes"))
    macs = float(net.total_macs)
    return ScheduleArtifact(
        net=net.name, board=board_name, design=design_repr,
        latency_s=float(row("ref_latency_s")),
        coarse_latency_s=float(row("coarse_latency_s")),
        throughput_ips=float(row("ref_throughput_ips")),
        access_bytes=access, coarse_access_bytes=coarse_access,
        energy_j=energy_proxy(access, macs),
        coarse_energy_j=energy_proxy(coarse_access, macs),
        buffer_bytes=float(row("ref_buffer_bytes")),
        n_candidates=int(valid.sum()) * NCAND,
        layers=tuple(layers), ce_plans=ce_plans, segments=segments,
        meta={"n_layers": n_layers,
              "n_refined": int(sum(l.order != "ideal" for l in layers))})
