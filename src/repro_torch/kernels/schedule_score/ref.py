"""The temporal-mapping candidate scorer, as torch tensor code.

The port of the JAX package's ``kernels/schedule_score/ref.py``.  There it
is written against the array-API subset shared by ``jax.numpy`` and numpy
(an ``xp`` argument); here one statement sequence, the same one in the
same order, serves the CPU and the card.  Every op is elementwise
(mul/div/ceil/floor/clamp/minimum/maximum/where) in float32, with
correctly rounded division, so the plane is bit-equal on both devices and
to the JAX package's numpy plane from the same layer state.

Candidate space (NCAND = 1 + 3 orders x 3 tile fractions x 2 buffering
choices = 19):

- candidate 0, ``ideal``: the mapping the coarse MCCM model assumes (full
  buffer use, perfect load/compute overlap, the Eq. 5/6 residency chain).
  Its cost is the coarse per-layer cost verbatim, so the argmin can never
  exceed the coarse estimate, and the argmin's first-index tie-break keeps
  the refined result bit-identical to coarse whenever no explicit mapping
  beats it.
- ``input_stationary`` (loop order N-C-H-W-K-R-S): feature-map tiles
  pinned on chip, weights streamed: Eq. 6 option A (exact at frac=1.0,
  db=True).
- ``weight_stationary`` (N-K-C-H-W-R-S): weights pinned, feature maps
  streamed: Eq. 6 option B (exact at frac=1.0, db=True).  On pipelined
  layers it is the all-or-nothing residency order.
- ``row_streaming`` (N-H-W-K-C-R-S): outputs produced row by row.  On
  single-CE layers it needs the whole weight tensor resident beside one
  input row band; on pipelined layers it keeps a fraction phi of the
  weights on chip across tile rounds (the refinement over Eq. 7's binary
  keep-all/stream-all choice).

``frac`` scales how much of the free buffer the streamed-operand tile
(single) or the resident-weight slice (pipelined) may claim; ``db`` False
trades load/compute overlap (latency comp + mem instead of max(comp, mem))
for a single-buffered fm tile.
"""
from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

#: large-but-finite infeasibility sentinel (inf would turn masked products
#: into NaN); finite in float32
BIG = 1.0e30

ORDER_NAMES = ("ideal", "input_stationary", "weight_stationary",
               "row_streaming")
FRACS = (1.0, 0.5, 0.25)

F32 = torch.float32


def _build_meta():
    rows = [(0, 1.0, True)]          # candidate 0: the coarse/ideal mapping
    for order in (1, 2, 3):
        for frac in FRACS:
            for db in (True, False):
                rows.append((order, frac, db))
    return tuple(rows)


#: (order_id, tile_frac, double_buffer) per candidate, row-major
CAND_META = _build_meta()
NCAND = len(CAND_META)

CAND_ORDER = np.array([r[0] for r in CAND_META], np.float32)
CAND_FRAC = np.array([r[1] for r in CAND_META], np.float32)
CAND_DB = np.array([1.0 if r[2] else 0.0 for r in CAND_META], np.float32)


class _Candidates(NamedTuple):
    """The candidate tables and scalar constants on one device."""

    frac: torch.Tensor       # (NCAND,) f32
    db_on: torch.Tensor      # (NCAND,) bool: double-buffered
    is_c0: torch.Tensor      # (NCAND,) bool: order masks
    is_is: torch.Tensor
    is_ws: torch.Tensor
    zero: torch.Tensor       # 0-d f32
    one: torch.Tensor
    big: torch.Tensor


@lru_cache(maxsize=None)
def candidates(device: torch.device) -> _Candidates:
    """The tables on ``device``, made once per device and kept: built
    afresh on each call they would be a host-to-device copy and a sync a
    call on the card."""
    on = lambda a: torch.as_tensor(a, dtype=F32, device=device)
    order = on(CAND_ORDER)
    return _Candidates(
        frac=on(CAND_FRAC), db_on=on(CAND_DB) > 0, is_c0=order == 0.0,
        is_is=order == 1.0, is_ws=order == 2.0, zero=on(0.0), one=on(1.0),
        big=on(BIG))


def score_plane(*, comp, wl, ifml, ofml, wtile, fm_tile2, ifm_tile,
                buf, ce_buf, n_tiles, ofm_res, ofm_acc,
                lat_coarse, acc_coarse, wacc_coarse, facc_coarse,
                busy_coarse, wacc_pipe_coarse,
                ideal, ifm_onchip, resident, pipe, valid, bpc):
    """Score every mapping candidate for every layer: (B, L) inputs -> dict
    of (B, L, NCAND) float32 planes on the inputs' device.

    All size inputs are bytes, ``comp`` is cycles, ``bpc`` (a 0-d tensor on
    the same device) bytes/cycle.  ``ideal``/``ifm_onchip``/``resident``/
    ``pipe``/``valid`` are bool masks.  Returns per-candidate refined
    per-layer cost fields (the LayerState substitutions), the argmin key
    ``score``, and the chosen working-set accounting (``tile_bytes``/
    ``companion_bytes``/``floor_bytes``/``budget_bytes``/``phi``) that the
    budget property tests assert against.
    """
    c = candidates(comp.device)
    frac, zero, one, big = c.frac, c.zero, c.one, c.big
    is_c0, is_is, is_ws, db_on = c.is_c0, c.is_is, c.is_ws, c.db_on

    def e(a):                                     # (B, L) -> (B, L, 1)
        return a.to(F32)[..., None]

    def eb(a):                                    # bool mask -> (B, L, 1)
        return a.to(torch.bool)[..., None]

    bpc = bpc.to(F32)

    # ---- single-CE (Eq. 6 world) ------------------------------------------
    # OFM policy is inherited from the coarse state (ofm_res/ofm_acc);
    # candidates choose which streamed operand gets how much of the rest.
    avail_is = e(buf) - e(ofm_res) - e(wtile)
    ifm_buf = torch.maximum(avail_is * frac, e(ifm_tile))
    loads_a = torch.where(
        ifm_buf < e(ifml),
        e(wl) * torch.ceil(e(ifml) / torch.maximum(ifm_buf, one)) + e(ifml),
        e(wl) + e(ifml))
    wacc_a = loads_a - e(ifml)

    avail_ws = e(buf) - e(ofm_res) - e(ifm_tile)
    w_buf = torch.maximum(avail_ws * frac, e(wtile))
    loads_b = torch.where(
        w_buf < e(wl),
        e(ifml) * torch.ceil(e(wl) / torch.maximum(w_buf, one)) + e(wl),
        e(ifml) + e(wl))
    facc_b = loads_b - e(wl)

    # row streaming: whole weight tensor resident beside one row band
    row_fit = e(wl) + e(ifm_tile) + e(ofm_res) <= e(buf)
    loads_r = torch.where(row_fit, e(wl) + e(ifml), big)

    sel_acc = torch.where(is_is, loads_a, torch.where(is_ws, loads_b,
                                                      loads_r))
    sel_wacc = torch.where(is_is, wacc_a,
                           torch.where(is_ws, e(wl) + zero * frac,
                                       torch.where(row_fit,
                                                   e(wl) + zero * frac,
                                                   big)))
    sel_facc = torch.where(is_is, e(ifml) + zero * frac,
                           torch.where(is_ws, facc_b,
                                       torch.where(row_fit,
                                                   e(ifml) + zero * frac,
                                                   big)))
    acc_c = e(ofm_acc) + sel_acc
    facc_c = e(ofm_acc) + sel_facc
    wacc_c = sel_wacc

    # residency-chain regimes (whole working set fits, or the producer left
    # the ifm on chip): every operand already moves at most once, so all
    # candidates collapse to the coarse cost and the first-index tie-break
    # keeps candidate 0.
    chain = eb(ideal) | eb(ifm_onchip)
    acc_c = torch.where(chain, e(acc_coarse), acc_c)
    wacc_c = torch.where(chain, e(wacc_coarse), wacc_c)
    facc_c = torch.where(chain, e(facc_coarse), facc_c)
    mem_c = acc_c / bpc
    lat_c = torch.where(db_on, torch.maximum(e(comp), mem_c),
                        e(comp) + mem_c)

    lat_c = torch.where(is_c0, e(lat_coarse), lat_c)
    acc_c = torch.where(is_c0, e(acc_coarse), acc_c)
    wacc_c = torch.where(is_c0, e(wacc_coarse), wacc_c)
    facc_c = torch.where(is_c0, e(facc_coarse), facc_c)

    # ---- pipelined (Eq. 7 world) ------------------------------------------
    fm_floor = torch.where(db_on, e(fm_tile2), e(fm_tile2) * 0.5)
    w_budget = torch.maximum(e(ce_buf) - fm_floor - e(wtile), zero) * frac
    phi_max = torch.clamp(w_budget / torch.maximum(e(wl), one), 0.0, 1.0)
    # order semantics: IS streams everything, WS is all-or-nothing
    # (floor(phi_max) is 1 only on a full fit), ROW keeps a partial slice.
    # phi is quantized DOWN to 1/256 steps (BRAM-granule slices): on the
    # grid every op of the blend below is exact in f32, so no contraction
    # or reassociation can split the card's plane from the CPU's.
    phi = torch.where(is_is, zero * phi_max,
                      torch.where(is_ws, torch.floor(phi_max), phi_max))
    phi = torch.floor(phi * 256.0) / 256.0
    # streamed rounds per weight byte: phi once + (1-phi) every round,
    # exact (integer/256 arithmetic below 2^24), then ONE rounding at *wl
    blend = (one - phi) * e(n_tiles) + phi
    wacc_p = e(wl) * blend
    wacc_p = torch.where(eb(resident), zero * wacc_p, wacc_p)
    mem_p = wacc_p / bpc
    busy_c = torch.where(db_on, torch.maximum(e(comp), mem_p),
                         e(comp) + mem_p)

    busy_c = torch.where(is_c0, e(busy_coarse), busy_c)
    wacc_p = torch.where(is_c0, e(wacc_pipe_coarse), wacc_p)
    phi = torch.where(is_c0 | eb(resident), one + zero * phi, phi)

    # ---- argmin key + budget accounting -----------------------------------
    pipe_b = eb(pipe)
    valid_b = eb(valid)
    score = torch.where(pipe_b, busy_c, lat_c)
    score = torch.where(valid_b | is_c0, score, big)

    # working-set bookkeeping for the chosen mapping: the property tests
    # assert tile + companions <= budget OR tile == floor (the documented
    # minimal-working-set clamp, mirroring the coarse model's own floors)
    tile_s = torch.where(is_is, ifm_buf, torch.where(is_ws, w_buf, e(wl)))
    comp_s = torch.where(is_is, e(wtile) + e(ofm_res),
                         e(ifm_tile) + e(ofm_res))
    floor_s = torch.where(is_is, e(ifm_tile),
                          torch.where(is_ws, e(wtile), e(wl)))
    tile_p = phi * e(wl) + e(wtile)
    comp_p = fm_floor
    floor_p = e(wtile) + zero * frac
    ws_collapsed = is_c0 | (chain & ~pipe_b) | (eb(resident) & pipe_b)
    tile_bytes = torch.where(ws_collapsed, zero * frac,
                             torch.where(pipe_b, tile_p, tile_s))
    companion_bytes = torch.where(ws_collapsed, zero * frac,
                                  torch.where(pipe_b, comp_p, comp_s))
    floor_bytes = torch.where(ws_collapsed, zero * frac,
                              torch.where(pipe_b, floor_p, floor_s))
    budget_bytes = torch.where(pipe_b, e(ce_buf), e(buf)) + zero * frac

    return {
        "score": score,
        "lat_single": lat_c,
        "acc_single": acc_c,
        "wacc_single": wacc_c,
        "facc_single": facc_c,
        "busy_pipe": busy_c,
        "w_acc_pipe": wacc_p,
        "phi": phi,
        "tile_bytes": tile_bytes,
        "companion_bytes": companion_bytes,
        "floor_bytes": floor_bytes,
        "budget_bytes": budget_bytes,
    }
