"""Per-design temporal-mapping search on the tables' device.

The port of the JAX package's ``schedule/search.py``.  For every evaluated
design, each valid layer gets a ``(B, L, NCAND)`` plane of mapping
candidates (loop order x tile fraction x buffering choice,
``kernels.schedule_score``) scored in the same MCCM cost terms the design
search runs on: compute cycles, off-chip weight/feature-map traffic,
bandwidth contention.  An argmin on the plane's device picks the winner per
layer; the chosen per-layer costs are substituted back into the
:class:`~repro_torch.core.batch_eval.LayerState` and re-composed through
the same Eq. 2–9 reduction, so refined and coarse metrics stay in one
currency.  Candidate 0 carries the coarse (ideal-mapping) cost verbatim
and the composition is monotone in every per-layer field, so **refined
latency never exceeds the coarse estimate**.

A batch runs in blocks as ``evaluate_batch`` runs it: ``chunk`` designs a
block on the card (one search-kernel launch each), ``tile`` on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.batch_eval import (DEFAULT_CHUNK, DEFAULT_TILE, F32, NEG,
                               DeviceSpec, DeviceTables, LayerState,
                               NetTables, SearchTables, _blocks, _cat_blocks,
                               _ce_maps, _evaluate_specs, _per_layer,
                               _search_ce, _seg_max, _seg_sum,
                               compose_metrics, layer_state)
from ..core.dse.encoding import DesignBatch
from ..kernels.mccm_eval import parallelism_search
from ..kernels.schedule_score import NCAND, score_plane_dispatch


def plane_inputs(t: NetTables, dev: DeviceTables, st: LayerState, pipe,
                 valid) -> dict:
    """Assemble ``score_plane`` inputs from the per-layer state."""
    wb = dev.wordbytes
    W, IFM, OFM, BAND = t.W[None], t.IFM[None], t.OFM[None], t.BAND[None]
    ifml = IFM * wb
    return dict(
        comp=st.comp, wl=W * wb, ifml=ifml, ofml=OFM * wb,
        wtile=st.wtile, fm_tile2=st.fm_tile2,
        ifm_tile=torch.minimum(ifml, BAND * wb),
        buf=st.buf_l, ce_buf=st.ce_buf_l, n_tiles=st.n_tiles_l,
        ofm_res=st.ofm_res, ofm_acc=st.ofm_acc,
        lat_coarse=st.lat_single, acc_coarse=st.acc_single,
        wacc_coarse=st.wacc_single, facc_coarse=st.facc_single,
        busy_coarse=st.busy_pipe, wacc_pipe_coarse=st.w_acc_pipe,
        ideal=st.ideal, ifm_onchip=st.ifm_onchip, resident=st.resident_l,
        pipe=pipe, valid=valid, bpc=dev.bpc)


def _chosen(a, idx):
    """A plane field (broadcastable to (B, L, NCAND)) at each layer's
    chosen candidate ``idx`` (B, L) int64 -> (B, L)."""
    full = a.expand(*idx.shape, NCAND)
    return torch.gather(full, -1, idx[..., None])[..., 0]


def _refine_state(st: LayerState, plane: dict, idx, bpc) -> LayerState:
    """Substitute each layer's chosen candidate costs into the state."""
    acc = _chosen(plane["acc_single"], idx)
    wacc_p = _chosen(plane["w_acc_pipe"], idx)
    return st._replace(
        lat_single=_chosen(plane["lat_single"], idx), acc_single=acc,
        wacc_single=_chosen(plane["wacc_single"], idx),
        facc_single=_chosen(plane["facc_single"], idx),
        mem_cyc_single=acc / bpc,
        busy_pipe=_chosen(plane["busy_pipe"], idx), w_acc_pipe=wacc_p,
        mem_cyc_pipe=wacc_p / bpc)


def _coarse_state(design: DesignBatch, t: NetTables, dev: DeviceTables,
                  search: SearchTables, fm_tile_rows: int):
    """CE maps -> fused ⟨pf, ph, pw⟩ search -> coarse layer state."""
    m = _ce_maps(design, t, dev)
    par = parallelism_search(m.pes_ce, _search_ce(m), *search)[:3]
    return m, par, layer_state(design, t, dev, m, par, fm_tile_rows)


def plane_of_state(t: NetTables, dev: DeviceTables, st: LayerState, pipe,
                   valid) -> dict[str, torch.Tensor]:
    """The candidate plane of a layer state, with its argmin ``choice``
    (B, L) int32 (ties go to the first candidate), on the state's
    device."""
    plane = score_plane_dispatch(**plane_inputs(t, dev, st, pipe, valid))
    plane["choice"] = torch.argmin(plane["score"], dim=-1).to(torch.int32)
    return plane


def coarse_state(design: DesignBatch, t: NetTables, dev: DeviceTables, *,
                 fm_tile_rows: int = 2):
    """``(CE maps, LayerState)`` of one block of designs on the tables'
    device: the state the plane is scored from."""
    _, search, _ = _blocks(design, t, dev)
    m, _par, st = _coarse_state(design.to(t.device), t, dev, search,
                                fm_tile_rows)
    return m, st


def device_plane(design: DesignBatch, t: NetTables, dev: DeviceTables, *,
                 fm_tile_rows: int = 2) -> dict[str, torch.Tensor]:
    """The plane and its ``choice`` for one block of designs, without the
    compose step, on the tables' device (the tests and ``chip_smoke.py``
    hold it to the JAX package's numpy plane and to the CPU's)."""
    m, st = coarse_state(design, t, dev, fm_tile_rows=fm_tile_rows)
    return plane_of_state(t, dev, st, m.pipe_bool, m.valid_b)


def schedule_block(design: DesignBatch, t: NetTables, dev: DeviceTables,
                   search: SearchTables, *,
                   fm_tile_rows: int = 2) -> dict[str, torch.Tensor]:
    """Schedule search of one design block: CE maps -> ⟨pf, ph, pw⟩ ->
    coarse layer state -> candidate plane -> argmin -> refined
    composition.  Returns refined + coarse metrics plus the per-layer and
    per-segment detail the artifact is decoded from."""
    m, (pf, ph, pw), st = _coarse_state(design, t, dev, search,
                                        fm_tile_rows)
    coarse = compose_metrics(design, t, dev, m, st)

    pipe, valid = m.pipe_bool, m.valid_b
    plane = plane_of_state(t, dev, st, pipe, valid)
    choice = plane["choice"]
    idx = choice.long()
    st2 = _refine_state(st, plane, idx, dev.bpc)
    refined = compose_metrics(design, t, dev, m, st2)

    valid_f = valid.to(F32)
    pipe_f = pipe.to(F32)
    lat_ref_l = torch.where(pipe, st2.busy_pipe, st2.lat_single) * valid_f
    lat_coarse_l = torch.where(pipe, st.busy_pipe, st.lat_single) * valid_f
    acc_ref_l = torch.where(pipe, st2.w_acc_pipe, st2.acc_single) * valid_f
    acc_coarse_l = torch.where(pipe, st.w_acc_pipe, st.acc_single) * valid_f

    def seg_cyc(state):
        single = _seg_sum(state.lat_single * (1.0 - pipe_f) * valid_f,
                          m.onehot)
        busy = _seg_max(torch.where(pipe & valid, state.busy_pipe, NEG),
                        m.onehot)
        return single + torch.clamp_min(busy, 0.0)

    out = {f"ref_{k}": v for k, v in refined.items()}
    out.update({f"coarse_{k}": v for k, v in coarse.items()})
    out.update(
        choice=choice,
        phi=_chosen(plane["phi"], idx),
        tile_bytes=_chosen(plane["tile_bytes"], idx),
        companion_bytes=_chosen(plane["companion_bytes"], idx),
        floor_bytes=_chosen(plane["floor_bytes"], idx),
        budget_bytes=_chosen(plane["budget_bytes"], idx),
        lat_ref_l=lat_ref_l, lat_coarse_l=lat_coarse_l,
        acc_ref_l=acc_ref_l, acc_coarse_l=acc_coarse_l,
        pf_l=_per_layer(pf, m), ph_l=_per_layer(ph, m),
        pw_l=_per_layer(pw, m),
        ce_of_layer=m.ce_of_layer, seg_of_layer=m.seg_of_layer,
        pipe_l=pipe, valid_l=valid,
        n_tiles_l=st.n_tiles_l,
        ce_buf_l=st.ce_buf_l, buf_l=st.buf_l,
        alloc_seg=st.alloc, seg_valid=m.seg_valid,
        seg_cyc_ref=seg_cyc(st2), seg_cyc_coarse=seg_cyc(st))
    return out


def schedule_batch(design: DesignBatch, tables: NetTables,
                   dev: DeviceSpec | DeviceTables, fm_tile_rows: int = 2,
                   *, tile: int = DEFAULT_TILE,
                   chunk: int = DEFAULT_CHUNK) -> dict[str, torch.Tensor]:
    """DesignBatch -> refined + coarse metrics + per-layer schedule detail,
    tensors on the tables' device (blocked as ``evaluate_batch``)."""
    _, search, parts = _blocks(design, tables, dev, tile=tile, chunk=chunk)
    return _cat_blocks([schedule_block(b, tables, d, search,
                                       fm_tile_rows=fm_tile_rows)
                        for b, d in parts])


def schedule_specs(specs, net, dev, *, tables: NetTables | None = None,
                   tile: int = DEFAULT_TILE, chunk: int = DEFAULT_CHUNK,
                   fm_tile_rows: int = 2, pad_to: int | None = None,
                   device="cuda") -> dict[str, np.ndarray]:
    """Spec list -> host metric/detail arrays, ``chunk`` specs at a time,
    each chunk padded as ``_evaluate_specs`` pads it.  ``device`` is where
    the tables are built when ``tables`` is None."""
    if not specs:
        raise ValueError("no specs to schedule (empty design list)")
    return _evaluate_specs(list(specs), net, dev, chunk, tables=tables,
                           tile=tile, pad_to=pad_to,
                           fm_tile_rows=fm_tile_rows, device=device,
                           batch_fn=schedule_batch)
