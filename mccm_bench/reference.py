"""The plain reference of a bulk evaluation: MCCM's Eqs. 1–9 over a batch
of designs, worked out from a configuration file alone.

A frozen copy of the batch path's arithmetic as plain PyTorch tensor code:
the layer and board tables built again from the configuration's layer
shapes and board resources, the CE maps and the largest-remainder PE
split, the ⟨pf, ph, pw⟩ search as a plain loop over the layers, the
per-layer costs and Eqs. 2–9.  It imports nothing of the program.

The model computes in float32, and where a sum feeds a discrete choice (the
PE split, the search's argmin, the buffer grants) the order of that sum
decides which design wins a tie.  So the copy keeps each such order as the
MCCM reference package fixes it: :func:`_dot_sum` (over the padded layer
axis, hence ``layer_rows``), :func:`_seq_sum`, :func:`_seq_cumsum` and
the search's ascending per-layer sum.  ``dtype`` runs the whole copy in
another precision: ``torch.bfloat16`` is the control that the comparison
has to reject.
"""
from __future__ import annotations

import numpy as np
import torch

NS = 12          # segments a design holds
NC = 16          # CEs a design holds
NEG = -1.0e30

#: PE-budget buckets for pruning the ⟨pf, ph⟩ pair grid: a pair with
#: pf·ph above the board's bucket is infeasible for every CE
PES_HINTS = (2520, 8192, 65536)


# --------------------------------------------------------------------------
# tables from the configuration
# --------------------------------------------------------------------------
def layer_sizes(layer: dict) -> dict:
    """One conv layer's loop dimensions and sizes (elements) from its
    shape: kind, channels, kernel, stride, input size, padding."""
    same = layer.get("padding", "same") == "same"
    s = layer["stride"]
    oh = -(-layer["ih"] // s) if same else (layer["ih"] - layer["kh"]) // s + 1
    ow = -(-layer["iw"] // s) if same else (layer["iw"] - layer["kw"]) // s + 1
    c = 1 if layer["kind"] == "dw" else layer["in_ch"]
    weights = layer["out_ch"] * c * layer["kh"] * layer["kw"]
    return dict(f=layer["out_ch"], c=c, oh=oh, ow=ow, weights=weights,
                macs=weights * oh * ow,
                ifm=layer["in_ch"] * layer["ih"] * layer["iw"],
                ofm=layer["out_ch"] * oh * ow,
                band=layer["in_ch"] * layer["kh"] * layer["iw"],
                ofm_row=layer["out_ch"] * ow)


def net_tables(cfg: dict, device, dtype=torch.float32) -> dict:
    """The network's per-layer tables, built in float64 and cast to
    ``dtype`` on ``device``, padded with zeros to ``layer_rows``."""
    layers = cfg["network"]["layers"]
    L = len(layers)
    rows = cfg["model"]["layer_rows"]
    if L > rows:
        raise ValueError(f"{L} layers exceed layer_rows {rows}")
    cand = np.asarray(cfg["model"]["candidates"], np.float64)
    z = [layer_sizes(l) for l in layers]

    def pad(vals):
        a = np.zeros(rows, np.float64)
        a[:L] = vals
        return a

    F = np.array([d["f"] for d in z], np.float64)
    OH = np.array([d["oh"] for d in z], np.float64)
    OW = np.array([d["ow"] for d in z], np.float64)

    def pad2(tab):
        a = np.zeros((rows, len(cand)), np.float64)
        a[:L] = tab
        return a

    host = dict(
        valid=pad(np.ones(L)), F=pad(F),
        CKK=pad([d["c"] * l["kh"] * l["kw"] for d, l in zip(z, layers)]),
        OH=pad(OH), OW=pad(OW), MACS=pad([d["macs"] for d in z]),
        W=pad([d["weights"] for d in z]), IFM=pad([d["ifm"] for d in z]),
        OFM=pad([d["ofm"] for d in z]),
        EXTRA=pad([d["ofm"] if l["residual"] else 0
                   for d, l in zip(z, layers)]),
        BAND=pad([d["band"] for d in z]),
        OFM_ROW=pad([d["ofm_row"] for d in z]),
        CEIL_F=pad2(np.ceil(F[:, None] / cand[None, :])),
        CEIL_OH=pad2(np.ceil(OH[:, None] / cand[None, :])))
    t = {k: torch.from_numpy(np.array(v, np.float32)).to(device=device,
                                                          dtype=dtype)
         for k, v in host.items()}
    t["L"] = L
    return t


def board_tables(cfg: dict, device, dtype=torch.float32) -> dict:
    """The board as 0-d tensors: PEs, on-chip bytes, off-chip bytes a
    cycle and a second, clock, bytes a word."""
    b = cfg["board"]
    vals = dict(pes=b["pes"], on_chip_bytes=b["on_chip_bytes"],
                bpc=b["off_chip_gbps"] * 1e9 / b["clock_hz"],
                bps=b["off_chip_gbps"] * 1e9, clock_hz=b["clock_hz"],
                wordbytes=b["wordbytes"])
    return {k: torch.from_numpy(np.array(v, np.float32)).to(device=device,
                                                           dtype=dtype)
            for k, v in vals.items()}


def pair_list(cfg: dict) -> dict:
    """The ⟨pf, ph⟩ pairs row-major over the candidate grid, less those
    with pf·ph above the board's PE bucket (host arrays)."""
    cand = np.asarray(cfg["model"]["candidates"], np.float64)
    k = len(cand)
    ii, jj = np.meshgrid(np.arange(k), np.arange(k), indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    prod = cand[ii] * cand[jj]
    hint = next((h for h in PES_HINTS if cfg["board"]["pes"] <= h), None)
    if hint is not None:
        keep = prod <= hint
        keep[0] = True
        ii, jj, prod = ii[keep], jj[keep], prod[keep]
    return dict(pair_i=ii, pair_j=jj, pair_prod=prod, pair_pf=cand[ii],
                pair_ph=cand[jj], cand=cand)


def search_tables(t: dict, pairs: dict) -> dict:
    """What the search reads besides each design's PEs and CE map."""
    dev, dt = t["F"].device, t["F"].dtype
    on = lambda a: torch.from_numpy(np.array(a, np.float32)).to(
        device=dev, dtype=dt)
    pi = torch.as_tensor(pairs["pair_i"], dtype=torch.long, device=dev)
    pj = torch.as_tensor(pairs["pair_j"], dtype=torch.long, device=dev)
    return dict(fc_pair=t["CEIL_F"][:, pi] * t["CKK"][:, None],
                coh_pair=t["CEIL_OH"][:, pj], ow=t["OW"],
                cand=on(pairs["cand"]), pair_prod=on(pairs["pair_prod"]),
                pair_pf=on(pairs["pair_pf"]), pair_ph=on(pairs["pair_ph"]))


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------
def _onehot(idx, n: int, dt):
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dt)


def _seq_sum(x):
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out + x[..., i]
    return out


def _seq_cumsum(x):
    cols = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., i])
    return torch.stack(cols, -1)


def _dot_sum(terms):
    """(B, L, N) summed over L: four 8-wide accumulators over consecutive
    32-layer blocks folded in order, a halving tree over the 8 lanes, then
    the tail layers one by one."""
    B, L, N = terms.shape
    body = L // 32 * 32
    acc = terms.new_zeros(B, 32, N)
    for s in range(0, body, 32):
        acc = acc + terms[:, s:s + 32]
    r = acc[:, 0:8] + acc[:, 8:16]
    r = r + acc[:, 16:24]
    r = r + acc[:, 24:32]
    r = r[:, 0:4] + r[:, 4:8]
    r = r[:, 0:2] + r[:, 2:4]
    r = r[:, 0] + r[:, 1]
    for l in range(body, L):
        r = r + terms[:, l]
    return r


def _largest_remainder(shares, total, valid):
    """Largest-remainder rounding of ``shares`` to ``total`` PEs, at least
    one a valid CE; ties break by index."""
    ssum = _seq_sum(shares)
    s = torch.where(ssum > 0, ssum, 1.0)
    raw = torch.clamp_min(shares / s[:, None] * total, 1.0)
    raw = torch.where(valid, raw, 0.0)
    out = torch.where(valid, torch.clamp_min(torch.floor(raw), 1.0), 0.0)
    rem = total - _seq_sum(out)
    frac = torch.where(valid, raw - torch.floor(raw), -1.0)
    order = torch.argsort(-frac, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    out = out + torch.where(valid & (rank < torch.clamp_min(rem, 0)[:, None]),
                            1.0, 0.0)
    deficit = torch.clamp_min(-rem, 0.0)
    big_order = torch.argsort(-out, dim=-1, stable=True)
    big_rank = torch.argsort(big_order, dim=-1, stable=True)
    take = (big_rank < deficit[:, None]) & (out > 1.0)
    return out - torch.where(take, 1.0, 0.0)


def _seg_sum(x, onehot):
    return (x[..., None] * onehot).sum(1)


def _seg_max(x, onehot):
    return torch.where(onehot > 0, x[..., None], NEG).amax(dim=1)


def _seg_scan_max(vals, start_flags, reverse=False):
    """Running max within groups that a flag starts (ends, reversed)."""
    f = start_flags.flip(1) if reverse else start_flags
    v = vals.flip(1) if reverse else vals
    n, d = v.shape[1], 1
    while d < n:
        fb, vb = f[:, d:], v[:, d:]
        v = torch.cat([v[:, :d], torch.where(
            fb, vb, torch.maximum(v[:, :-d], vb))], 1)
        f = torch.cat([f[:, :d], fb | f[:, :-d]], 1)
        d *= 2
    return v.flip(1) if reverse else v


def _take(a, idx):
    return torch.take_along_dim(a, idx.long(), dim=1)


# --------------------------------------------------------------------------
# the ⟨pf, ph, pw⟩ search
# --------------------------------------------------------------------------
def search(pes_ce, ce_idx, fc_pair, coh_pair, ow, cand, pair_prod, pair_pf,
           pair_ph):
    """For every design and CE, the pair minimising the CE's Eq. 1 cycles
    under its PEs, with pw the largest candidate the rest allows; the cost
    adds the CE's layers in ascending order.  Returns (pf, ph, pw)."""
    B, L = ce_idx.shape
    ce = ce_idx.long()
    ce_oh = (ce[..., None] == torch.arange(NC, device=ce.device)).to(
        pes_ce.dtype)
    budget = pes_ce[:, :, None] / pair_prod[None, None, :]      # (B, NC, P)
    feasible = budget >= 1.0
    pw_idx = (torch.searchsorted(cand.contiguous(), torch.floor(budget),
                                 right=True) - 1).clamp(0, cand.shape[0] - 1)
    pw_sel = torch.take_along_dim(pw_idx, ce.clamp_min(0)[:, :, None], dim=1)
    ceil_ow = torch.ceil(ow.reshape(L, 1) / cand[None, :])
    layer = torch.arange(L, device=ce.device)[None, :, None]
    cost_l = fc_pair[None] * coh_pair[None] * ceil_ow[layer, pw_sel]
    cost_ce = torch.zeros(B, NC, cost_l.shape[2], dtype=cost_l.dtype,
                          device=cost_l.device)
    for l in range(L):
        cost_ce = cost_ce + cost_l[:, l, None, :] * ce_oh[:, l, :, None]
    cost_ce = torch.where(feasible, cost_ce, torch.inf)
    best = torch.argmin(cost_ce, dim=-1)
    pw = cand[torch.take_along_dim(pw_idx, best[..., None], -1)[..., 0]]
    return pair_pf[best], pair_ph[best], pw


# --------------------------------------------------------------------------
# Eqs. 1–9
# --------------------------------------------------------------------------
def _designs(arrays, device) -> dict:
    seg_end, seg_pipe, seg_nce, inter = arrays
    t = lambda a, dt: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    return dict(seg_end=t(seg_end, torch.int32),
                seg_pipe=t(seg_pipe, torch.bool),
                seg_nce=t(seg_nce, torch.int32),
                inter_pipe=t(inter, torch.bool))


def _ce_maps(d: dict, t: dict, pes) -> dict:
    """Layer -> segment and CE maps, and the PE split."""
    dt = t["F"].dtype
    B, max_L = d["seg_end"].shape[0], t["F"].shape[0]
    layer_ix = torch.arange(max_L, device=t["F"].device)
    seg_end = d["seg_end"]
    seg_start = torch.cat(
        [torch.zeros_like(seg_end[:, :1]), seg_end[:, :-1]], 1)
    seg_len = seg_end - seg_start
    seg_valid = seg_len > 0
    n_seg = seg_valid.sum(-1)
    seg_of_layer = torch.clamp_max(
        (layer_ix[None, :, None] >= seg_end[:, None, :]).sum(-1), NS - 1)
    valid_b = (layer_ix < t["L"])[None, :].expand(B, max_L)
    valid_layer = valid_b.to(dt) * t["valid"][None, :]
    onehot = _onehot(seg_of_layer, NS, dt) * valid_layer[..., None]
    idx_in_seg = layer_ix[None, :] - _take(seg_start, seg_of_layer)
    nce_of_layer = _take(d["seg_nce"], seg_of_layer)
    pipe_bool = _take(d["seg_pipe"], seg_of_layer) & valid_b
    nce1 = torch.clamp_min(nce_of_layer, 1)
    slot_of_layer = torch.remainder(idx_in_seg, nce1)
    live_nce = d["seg_nce"] * seg_valid
    ce_base = torch.cumsum(live_nce, -1) - live_nce
    ce_of_layer = _take(ce_base, seg_of_layer) + slot_of_layer
    ce_oh = _onehot(ce_of_layer, NC, dt) * valid_layer[..., None]
    ce_live = (ce_of_layer < NC).to(dt) * valid_layer
    ce_of_layer = ce_of_layer.clamp(0, NC - 1)
    macs_ce = _dot_sum(t["MACS"][None, :, None] * ce_oh)
    ce_valid = ce_oh.amax(1) > 0
    pes_ce = _largest_remainder(macs_ce, pes, ce_valid)
    return dict(seg_start=seg_start, seg_len=seg_len, seg_valid=seg_valid,
                n_seg=n_seg, seg_of_layer=seg_of_layer, onehot=onehot,
                valid_b=valid_b, idx_in_seg=idx_in_seg,
                nce_of_layer=nce_of_layer, pipe_bool=pipe_bool,
                slot_of_layer=slot_of_layer, ce_base=ce_base,
                ce_of_layer=ce_of_layer, ce_oh=ce_oh, ce_live=ce_live,
                pes_ce=pes_ce, ce_valid=ce_valid)


def search_inputs(m: dict) -> torch.Tensor:
    """Each layer's CE for the search, -1 for a layer with no CE."""
    return torch.where(m["ce_live"] > 0, m["ce_of_layer"], -1).to(
        torch.int32)


def _per_layer(x_ce, m):
    return _take(x_ce, m["ce_of_layer"]) * m["ce_live"]


def _per_ce(x, m):
    return (x[..., None] * m["ce_oh"]).sum(1)


def _round_flags(m):
    start = m["slot_of_layer"] == 0
    last = (m["slot_of_layer"] == m["nce_of_layer"] - 1) | \
        (m["idx_in_seg"] == _take(m["seg_len"], m["seg_of_layer"]) - 1)
    return start, last


def _metrics(d: dict, t: dict, b: dict, m: dict, par, fm_tile_rows: int):
    """Eqs. 1 and 4–9 given the CE maps and the search's winners."""
    B, max_L = d["seg_end"].shape[0], t["F"].shape[0]
    device = t["F"].device
    wb, bpc = b["wordbytes"], b["bpc"]
    pf_ce, ph_ce, pw_ce = par
    onehot, valid_b, seg_of_layer = m["onehot"], m["valid_b"], m["seg_of_layer"]
    seg_valid, n_seg, pipe_bool = m["seg_valid"], m["n_seg"], m["pipe_bool"]
    dt = t["F"].dtype
    valid_f = valid_b.to(dt)
    seg_end = d["seg_end"]
    macs, ckk, F, OH, OW = t["MACS"], t["CKK"], t["F"], t["OH"], t["OW"]
    W, IFM, OFM = t["W"], t["IFM"], t["OFM"]
    EXTRA, BAND, OFM_ROW = t["EXTRA"], t["BAND"], t["OFM_ROW"]

    # Eq. 1: compute cycles and utilization
    pf_l = torch.where(valid_b, _per_layer(pf_ce, m), 1.0)
    ph_l = torch.where(valid_b, _per_layer(ph_ce, m), 1.0)
    pw_l = torch.where(valid_b, _per_layer(pw_ce, m), 1.0)
    comp = (torch.ceil(F[None] / pf_l) * ckk[None]
            * torch.ceil(OH[None] / ph_l) * torch.ceil(OW[None] / pw_l))
    util = macs[None] / torch.clamp_min(comp * (pf_l * ph_l * pw_l), 1.0)
    pipe_l = pipe_bool.to(dt)
    single_l = (1.0 - pipe_l) * valid_f

    # Eqs. 4–5: buffer floors and desires
    FMS = IFM + OFM + EXTRA
    wtile = torch.minimum(pf_l, F[None]) * ckk[None] * wb
    fm_tile2 = 2.0 * OFM_ROW[None] * fm_tile_rows * wb
    floor_pipe = _seg_sum((fm_tile2 + wtile) * pipe_l, onehot)
    desire_pipe = _seg_sum((W[None] * wb + fm_tile2) * pipe_l, onehot)
    floor_single = _seg_max(
        torch.where(single_l > 0, wtile + (BAND + OFM_ROW)[None] * wb, NEG),
        onehot)
    max_fms = _seg_max(torch.where(single_l > 0, FMS[None] * wb, NEG), onehot)
    max_wtile = _seg_max(torch.where(single_l > 0, wtile, NEG), onehot)
    desire_single = max_fms + max_wtile
    is_pipe_seg = d["seg_pipe"] & seg_valid
    floors = torch.where(is_pipe_seg, floor_pipe, torch.where(
        seg_valid, torch.clamp_min(floor_single, 0.0), 0.0))
    desires = torch.where(is_pipe_seg, desire_pipe, torch.where(
        seg_valid, torch.clamp_min(desire_single, 0.0), 0.0))
    desires = torch.maximum(desires, floors)

    budget = b["on_chip_bytes"]
    alloc = floors
    over = _seq_sum(alloc) > budget
    scale = torch.where(over, budget / torch.clamp_min(_seq_sum(alloc), 1.0),
                        1.0)
    alloc = torch.floor(alloc * scale[:, None])
    remaining = budget - _seq_sum(alloc)

    # inter-segment double buffers, smallest first
    b_ix = torch.arange(NS, device=device)
    bound_valid = b_ix[None, :] < (n_seg - 1)[:, None]
    last_of_seg = torch.clamp(seg_end - 1, 0, t["L"] - 1).long()
    bound_size = torch.where(bound_valid, OFM[last_of_seg] * wb, torch.inf)
    order = torch.argsort(bound_size, dim=-1, stable=True)
    sorted_sz = torch.take_along_dim(bound_size, order, dim=-1)
    finite = torch.isfinite(sorted_sz)
    csum = _seq_cumsum(torch.where(finite, 2 * sorted_sz, 0.0))
    fit_sorted = (csum <= remaining[:, None]) & finite
    fit = torch.zeros_like(fit_sorted).scatter(1, order, fit_sorted)
    inter_onchip = fit & bound_valid & d["inter_pipe"][:, None]
    remaining = remaining - _seq_sum(
        2 * torch.where(inter_onchip, OFM[last_of_seg] * wb, 0.0))

    # the rest granted toward each segment's desire
    gaps = torch.clamp_min(desires - alloc, 0.0)
    gap_sum = _seq_sum(gaps)
    grant = torch.minimum(torch.clamp_min(remaining, 0.0), gap_sum)
    alloc = alloc + torch.where(
        gap_sum[:, None] > 0,
        torch.floor(grant[:, None] * gaps
                    / torch.clamp_min(gap_sum[:, None], 1.0)), 0.0)

    # a pipelined segment's buffer split among its CEs
    ce_desire_l = (W[None] * wb + fm_tile2) * pipe_l
    ce_desire = _per_ce(ce_desire_l, m)
    seg_of_ce_desire = _seg_sum(ce_desire_l, onehot)
    alloc_of_layer = _take(alloc, seg_of_layer)
    segdes_of_layer = _take(torch.clamp_min(seg_of_ce_desire, 1.0),
                            seg_of_layer)
    ce_buf_of_layer = torch.floor(
        alloc_of_layer * _per_layer(ce_desire, m) / segdes_of_layer)
    resident_l = _take((alloc >= desire_pipe) & is_pipe_seg, seg_of_layer)

    is_round_start, is_round_last = _round_flags(m)
    OH_b = OH[None].expand(B, max_L)
    n_tiles_l = torch.clamp_min(torch.maximum(
        _seg_scan_max(OH_b, is_round_start),
        _seg_scan_max(OH_b, is_round_last, reverse=True)), 1.0)

    # Eq. 7: pipelined off-chip accesses
    w_bytes = W[None] * wb
    w_acc_pipe = torch.where(
        resident_l, 0.0,
        torch.where(ce_buf_of_layer >= w_bytes, w_bytes, w_bytes * n_tiles_l))
    mem_cyc_pipe = w_acc_pipe / bpc

    # Eq. 6: single-CE off-chip accesses
    buf = alloc_of_layer
    wl, ifml, ofml = W[None] * wb, IFM[None] * wb, OFM[None] * wb
    extral = EXTRA[None] * wb
    ideal = ifml + ofml + extral + wtile <= buf
    ifm_tile = torch.minimum(ifml, BAND[None] * wb)
    ofm_on = ofml + extral + wtile + ifm_tile <= buf
    ofm_res = torch.where(ofm_on, ofml + extral, 0.0)
    ofm_acc = torch.where(ofm_on, 0.0, ofml)
    next_on = ideal | ofm_on
    prev_on = torch.cat([torch.zeros_like(next_on[:, :1]), next_on[:, :-1]],
                        1)
    prev_boundary_onchip = _take(
        inter_onchip, torch.clamp_min(seg_of_layer - 1, 0)) \
        & (seg_of_layer > 0)
    ifm_onchip = torch.where(m["idx_in_seg"] == 0, prev_boundary_onchip,
                             prev_on)
    fm_ideal = torch.where(ifm_onchip, 0.0, ifml)
    ifm_buf = torch.maximum(buf - ofm_res - wtile, ifm_tile)
    loads_a = torch.where(
        ifm_buf < ifml,
        wl * torch.ceil(ifml / torch.clamp_min(ifm_buf, 1.0)) + ifml,
        wl + ifml)
    wacc_a = loads_a - ifml
    w_buf = torch.maximum(buf - ofm_res - ifm_tile, wtile)
    loads_b = torch.where(
        w_buf < wl,
        ifml * torch.ceil(wl / torch.clamp_min(w_buf, 1.0)) + wl,
        ifml + wl)
    facc_b = loads_b - wl
    use_a = loads_a <= loads_b
    acc_opt = ofm_acc + torch.where(use_a, loads_a, loads_b)
    wacc_opt = torch.where(use_a, wacc_a, wl)
    facc_opt = ofm_acc + torch.where(use_a, ifml, facc_b)
    acc_single = torch.where(ideal, wl + fm_ideal, torch.where(
        ifm_onchip, ofm_acc + wl, acc_opt))
    wacc_single = torch.where(ideal, wl, torch.where(ifm_onchip, wl,
                                                     wacc_opt))
    facc_single = torch.where(ideal, fm_ideal, torch.where(
        ifm_onchip, ofm_acc, facc_opt))
    lat_single = torch.maximum(comp, acc_single / bpc)
    busy_pipe = torch.maximum(comp, mem_cyc_pipe)

    # Eqs. 2–3: latency and per-CE busy time
    seg_lat_single = _seg_sum(lat_single * single_l, onehot)
    tile_lat = busy_pipe / n_tiles_l
    pmax_seq = _seg_scan_max(tile_lat, is_round_start)
    smax_seq = _seg_scan_max(tile_lat, is_round_last, reverse=True)
    prefix_sum_all = torch.where(pipe_bool, pmax_seq, 0.0).sum(-1)
    suffix_sum_all = torch.where(pipe_bool, smax_seq, 0.0).sum(-1)
    round_last = pipe_bool & is_round_last
    gmax_l = torch.where(round_last, pmax_seq, 0.0)
    slots_round = torch.where(round_last,
                              m["slot_of_layer"].to(dt) + 1.0, 0.0)
    T_round = torch.where(round_last, n_tiles_l, 0.0)
    lat_pipe_total = (prefix_sum_all + suffix_sum_all
                      + ((T_round - slots_round - 1.0) * gmax_l).sum(-1))

    busy_slot = _per_ce(busy_pipe * pipe_l, m)
    seg_of_ce = (torch.arange(NC, device=device)[None, :, None]
                 >= (m["ce_base"] + d["seg_nce"] * seg_valid)[:, None, :]
                 ).sum(-1)
    seg_ce_oh = _onehot(seg_of_ce, NS, dt)
    busy_pipe_seg = torch.where(
        is_pipe_seg,
        torch.where(seg_ce_oh > 0, busy_slot[..., None], NEG).amax(1), 0.0)
    single_seg = ~d["seg_pipe"] & seg_valid
    busy_single_seg = torch.where(single_seg, seg_lat_single, 0.0)
    ce_first = m["ce_base"].long()
    zeros = torch.zeros(B, NC, dtype=dt, device=device)
    in_range = ce_first < NC
    ce_first = ce_first.clamp_max(NC - 1)
    ce_busy = (zeros.scatter_add(1, ce_first, torch.where(
        single_seg & in_range, busy_single_seg, 0.0))
        + zeros.scatter_add(1, ce_first, torch.where(
            in_range, busy_pipe_seg, 0.0)))

    # Eqs. 8–9: interfaces and buffers
    access = (acc_single * single_l + w_acc_pipe * pipe_l).sum(-1)
    w_access = (wacc_single * single_l + w_acc_pipe * pipe_l).sum(-1)
    fm_access = (facc_single * single_l).sum(-1)
    mandatory = (IFM[0] + OFM[t["L"] - 1]) * wb
    access = access + mandatory
    fm_access = fm_access + mandatory
    bound_sz = torch.where(bound_valid, OFM[last_of_seg] * wb, 0.0)
    spill = bound_valid & ~inter_onchip
    spill_acc = _seq_sum(2 * torch.where(spill, bound_sz, 0.0))
    access = access + spill_acc
    fm_access = fm_access + spill_acc
    comm_cyc = _seq_sum((torch.where(spill, 2 * bound_sz, bound_sz)
                         / b["bps"]) * b["clock_hz"] * bound_valid)
    latency_cyc = _seq_sum(seg_lat_single) + lat_pipe_total + comm_cyc
    busy_max = ce_busy.amax(-1)
    multi = (n_seg > 1) & d["inter_pipe"]
    bottleneck = torch.where(multi, busy_max, torch.where(
        n_seg > 1, latency_cyc, torch.clamp_min(busy_max, 1.0)))
    return {
        "latency_s": latency_cyc / b["clock_hz"],
        "throughput_ips": b["clock_hz"] / torch.clamp_min(bottleneck, 1.0),
        "buffer_bytes": _seq_sum(desires) + torch.where(
            d["inter_pipe"], _seq_sum(2 * bound_sz), 0.0),
        "buffer_alloc_bytes": _seq_sum(alloc) + _seq_sum(
            2 * torch.where(inter_onchip, bound_sz, 0.0)),
        "access_bytes": access,
        "weight_access_bytes": w_access,
        "fm_access_bytes": fm_access,
        "utilization": (util * macs[None]).sum(-1) / torch.clamp_min(
            macs.sum(), 1.0),
        "n_ces": m["ce_valid"].sum(-1).to(torch.int32),
    }


class Reference:
    """The configuration's tables on one device in one precision, and the
    evaluation of design rows against them."""

    def __init__(self, cfg: dict, device="cpu", dtype=torch.float32):
        self.cfg = cfg
        self.tables = net_tables(cfg, device, dtype)
        self.board = board_tables(cfg, device, dtype)
        self.pairs = pair_list(cfg)
        self.search_tables = search_tables(self.tables, self.pairs)
        self.device = torch.device(device)

    def ce_maps(self, arrays) -> tuple[dict, dict]:
        """The designs on the device and their CE maps and PE split."""
        d = _designs(arrays, self.device)
        return d, _ce_maps(d, self.tables, self.board["pes"])

    def evaluate(self, arrays, block: int = 4096) -> dict[str, np.ndarray]:
        """Metrics of the design rows ``arrays`` = (seg_end, seg_pipe,
        seg_nce, inter_pipe), host arrays in, float64 / int host arrays
        out, ``block`` rows at a time."""
        n = len(arrays[0])
        outs = []
        for s in range(0, n, block):
            part = tuple(np.asarray(a)[s:s + block] for a in arrays)
            d, m = self.ce_maps(part)
            st = self.search_tables
            par = search(m["pes_ce"], search_inputs(m), st["fc_pair"],
                         st["coh_pair"], st["ow"], st["cand"],
                         st["pair_prod"], st["pair_pf"], st["pair_ph"])
            out = _metrics(d, self.tables, self.board, m, par,
                           self.cfg["model"]["fm_tile_rows"])
            outs.append({k: (v.cpu().numpy() if v.dtype == torch.int32
                             else v.to(torch.float64).cpu().numpy())
                         for k, v in out.items()})
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
