"""Vectorized MCCM: evaluate thousands of multiple-CE designs as tensor code.

The PyTorch port of the JAX package's ``core/batch_eval.py``.  Every design
of a batch is encoded as fixed-shape tensors (segments padded to ``NS``,
CEs to ``NC``, see ``core.dse.encoding``) and Eqs. 1–9 are evaluated with
masked tensor ops: the same model, not an approximation.

* ``NetTables``    — per-CNN layer tables, f32 tensors on one device,
  padded to a shared ``max_L`` with a layer-valid mask.
* ``DeviceTables`` — the board as 0-d f32 tensors on the same device, or
  one board per design row (``(B,)`` leaves: a multinet deployment's
  slices, ``core.multinet``).
* ``eval_design_block`` — CE maps -> the fused ⟨pf, ph, pw⟩ search
  (``kernels.mccm_eval``: the CUDA kernel for a CUDA tensor, the plain
  version for a CPU tensor) -> Eqs. 2–9.
* ``evaluate_batch`` — runs the blocks: ``chunk`` designs per block on the
  card (one kernel launch each), ``tile`` designs on the CPU, where the
  plain search builds a (tile, L, P) cost block.  Results are row-local,
  so the block size changes no number, and ``mesh=`` (``core.shard``)
  shards the rows across devices without changing one.

Exactness against the JAX package.  Where a sum feeds a discrete choice
its order is fixed to the reference's, so the same designs get the same
PE splits and the same ⟨pf, ph, pw⟩: see :func:`_dot_sum` (the per-CE MAC
sums of the PE split), :func:`_seq_sum` and :func:`_seq_cumsum`.  One-hot
index maps are built by comparison (an index out of range gives a zero
row, as ``jax.nn.one_hot`` does), argsorts are stable, and every table is
cast to float32 explicitly.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from functools import partial
from typing import NamedTuple

import numpy as np
import torch

from ..kernels.mccm_eval import pair_tables, parallelism_search
from . import telemetry
from .blocks import CANDIDATES_DEFAULT
from .device import DeviceSpec
from .dse.encoding import NC, NS, DesignBatch, encode_specs
from .notation import AcceleratorSpec
from .workload import Network

NEG = -1.0e30

#: base of the layer-axis padding ladder: covers the whole CNN zoo
#: (resnet152 = 155)
DEFAULT_MAX_L = 160

#: bucket step above the base: larger nets pad to the next multiple
MAX_L_STEP = 32

#: designs per block on the CPU (bounds the plain search's (tile, L, P)
#: cost block)
DEFAULT_TILE = 128

#: designs per block on the card: one kernel launch each
DEFAULT_CHUNK = 2048

#: PE-budget buckets for pruning the ⟨pf, ph⟩ pair grid.  Every
#: registered board (<= 2520 DSPs) lands in the first bucket.
PES_HINTS = (2520, 8192, 65536)

F32 = torch.float32


def bucket_max_L(L: int, base: int = DEFAULT_MAX_L,
                 step: int = MAX_L_STEP) -> int:
    """Shared layer-padding bucket for an L-layer net: the base bucket up
    to ``base`` layers, else the next ``step`` multiple."""
    if L <= base:
        return base
    return -(-L // step) * step


def shared_max_L(layer_counts) -> int:
    """The one bucket a set of nets must share to be stacked (the model
    axis of ``core.multinet``): the max over their own buckets."""
    counts = list(layer_counts)
    if not counts:
        return DEFAULT_MAX_L
    return max(bucket_max_L(int(c)) for c in counts)


def pes_hint(pes: float) -> int | None:
    """Pair-pruning bucket for a concrete PE count (None = no pruning for
    devices beyond the ladder)."""
    for h in PES_HINTS:
        if pes <= h:
            return h
    return None


# --------------------------------------------------------------------------
# tables
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class NetTables:
    """Per-network layer tables, padded to ``max_L`` (= ``F.shape[0]``).

    Every tensor is float32 on one device.  Padded layers carry zeros and
    ``valid`` masks them out.
    """

    L: int                 # true layer count
    valid: torch.Tensor    # (max_L,) 1.0 for real layers
    F: torch.Tensor        # out channels
    CKK: torch.Tensor      # c * kh * kw  (c=1 for depthwise)
    OH: torch.Tensor
    OW: torch.Tensor
    MACS: torch.Tensor
    W: torch.Tensor        # weights (elements)
    IFM: torch.Tensor
    OFM: torch.Tensor
    EXTRA: torch.Tensor    # residual OFM copy (elements)
    BAND: torch.Tensor     # in_ch * kh * iw  (IFM row band)
    OFM_ROW: torch.Tensor  # out_ch * ow
    CEIL_F: torch.Tensor   # (max_L, K) ceil(F / cand)
    CEIL_OH: torch.Tensor
    CEIL_OW: torch.Tensor
    CAND: torch.Tensor     # (K,)
    candidates: tuple = CANDIDATES_DEFAULT

    @property
    def max_L(self) -> int:
        return self.F.shape[0]

    @property
    def device(self) -> torch.device:
        return self.F.device


#: the tensor fields of NetTables, in declaration order
NET_TABLE_FIELDS = tuple(f.name for f in fields(NetTables)
                         if f.name not in ("L", "candidates"))


def net_tables_from_numpy(arrays, candidates=CANDIDATES_DEFAULT, *,
                          device="cuda") -> NetTables:
    """NetTables from host arrays: ``arrays`` maps ``L`` and every name of
    ``NET_TABLE_FIELDS`` to a numpy array (the fields of the JAX package's
    ``NetTables``).  Cast to float32 on ``device``."""
    t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(device)
    return NetTables(L=int(np.asarray(arrays["L"])),
                     **{k: t(arrays[k]) for k in NET_TABLE_FIELDS},
                     candidates=tuple(candidates))


def make_tables(net: Network, candidates=CANDIDATES_DEFAULT,
                max_L: int | None = None, *, device="cuda") -> NetTables:
    """A network's layer tables, built in float64 and cast to float32."""
    cand = np.asarray(candidates, np.float64)
    L = len(net)
    if max_L is None:
        max_L = bucket_max_L(L)
    elif L > max_L:
        max_L = bucket_max_L(L, base=max_L)
    dims = [l.dims() for l in net]

    def pad(vals):
        a = np.zeros(max_L, np.float64)
        a[:L] = vals
        return a

    F = np.array([d["f"] for d in dims], np.float64)
    OH = np.array([d["oh"] for d in dims], np.float64)
    OW = np.array([d["ow"] for d in dims], np.float64)

    def pad2(ceil_tab):
        a = np.zeros((max_L, len(cand)), np.float64)
        a[:L] = ceil_tab
        return a

    return net_tables_from_numpy(dict(
        L=L,
        valid=pad(np.ones(L)),
        F=pad(F),
        CKK=pad([d["c"] * d["kh"] * d["kw"] for d in dims]),
        OH=pad(OH), OW=pad(OW),
        MACS=pad([l.macs for l in net]),
        W=pad([l.weights_size for l in net]),
        IFM=pad([l.ifm_size for l in net]),
        OFM=pad([l.ofm_size for l in net]),
        EXTRA=pad([l.ofm_size if l.residual else 0 for l in net]),
        BAND=pad([l.in_ch * l.kh * l.iw for l in net]),
        OFM_ROW=pad([l.out_ch * l.ow for l in net]),
        CEIL_F=pad2(np.ceil(F[:, None] / cand[None, :])),
        CEIL_OH=pad2(np.ceil(OH[:, None] / cand[None, :])),
        CEIL_OW=pad2(np.ceil(OW[:, None] / cand[None, :])),
        CAND=cand,
    ), candidates, device=device)


@dataclass(frozen=True)
class DeviceTables:
    """A board as float32 tensors on one device: 0-d leaves (one board for
    every design), or ``(B,)`` leaves (row b's design runs on board row b:
    the multinet slices).  A metric reduced to ``(B,)`` reads a field as it
    is; a ``(B, L)``, ``(B, NS)`` or ``(B, NC)`` term reads it through
    :meth:`col`, so both shapes broadcast row by row."""

    pes: torch.Tensor
    on_chip_bytes: torch.Tensor
    bpc: torch.Tensor           # off-chip bytes per cycle
    bps: torch.Tensor           # off-chip bytes per second
    clock_hz: torch.Tensor
    wordbytes: torch.Tensor

    @property
    def per_row(self) -> bool:
        """True for one board per design row (``(B,)`` leaves)."""
        return self.pes.dim() == 1

    def col(self, name: str) -> torch.Tensor:
        """Field ``name`` for a term with a trailing axis: ``(B, 1)`` for
        per-row boards, the 0-d tensor otherwise."""
        return _col(getattr(self, name))

    def take(self, idx) -> "DeviceTables":
        """The boards of a row subset (itself for a 0-d board)."""
        if not self.per_row:
            return self
        return DeviceTables(*(getattr(self, k)[idx]
                              for k in DEVICE_TABLE_FIELDS))


DEVICE_TABLE_FIELDS = tuple(f.name for f in fields(DeviceTables))


def device_tables_from_numpy(arrays, *, device="cuda") -> DeviceTables:
    """DeviceTables from host scalars keyed by ``DEVICE_TABLE_FIELDS`` (the
    fields of the JAX package's ``DeviceTables``), as float32."""
    return DeviceTables(**{
        k: torch.from_numpy(np.array(arrays[k], np.float32)).to(device)
        for k in DEVICE_TABLE_FIELDS})


def make_device_tables(dev: DeviceSpec, *, device="cuda") -> DeviceTables:
    return device_tables_from_numpy(dict(
        pes=dev.pes, on_chip_bytes=dev.on_chip_bytes,
        bpc=dev.off_chip_bytes_per_cycle, bps=dev.off_chip_gbps * 1e9,
        clock_hz=dev.clock_hz, wordbytes=dev.wordbytes), device=device)


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------
def _col(x):
    """A per-row ``(B,)`` value as a ``(B, 1)`` column; a 0-d one as it is."""
    return x[:, None] if x.dim() == 1 else x


def _onehot(idx, n: int):
    """f32 one-hot of ``idx`` over ``n`` classes; an index outside [0, n)
    gives a zero row."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(F32)


def _seq_sum(x):
    """Sum over the last axis, left to right (the reference's order for
    the short NS/NC-wide reductions)."""
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out + x[..., i]
    return out


def _seq_cumsum(x):
    """Running sum over the last axis, left to right."""
    cols = [x[..., 0]]
    for i in range(1, x.shape[-1]):
        cols.append(cols[-1] + x[..., i])
    return torch.stack(cols, -1)


def _dot_sum(terms):
    """Sum (B, L, N) over the layer axis in the order XLA's CPU backend
    sums the reference's per-CE MAC contraction (``einsum("l,blc->bc")``):
    four 8-wide accumulators over consecutive 32-layer blocks, folded in
    order, then a halving tree over the 8 lanes, then any tail layers one
    by one.  The PE split rounds these sums, so an ulp here can move a PE
    between CEs."""
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
    """Vectorized largest-remainder rounding (floor 1 per valid CE).

    shares: (B, NC) f32; total: f32, 0-d (one board) or (B,) (a board
    per row); valid: (B, NC) bool.  Ties break by index (stable argsorts).
    """
    ssum = _seq_sum(shares)
    s = torch.where(ssum > 0, ssum, 1.0)
    raw = torch.clamp_min(shares / s[:, None] * _col(total), 1.0)
    raw = torch.where(valid, raw, 0.0)
    out = torch.where(valid, torch.clamp_min(torch.floor(raw), 1.0), 0.0)
    rem = total - _seq_sum(out)                        # (B,) can be +/-
    frac = torch.where(valid, raw - torch.floor(raw), -1.0)
    # positive remainder: +1 to the rem largest fractions
    order = torch.argsort(-frac, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)   # rank in frac order
    give = rank < torch.clamp_min(rem, 0)[:, None]
    out = out + torch.where(valid & give, 1.0, 0.0)
    # negative remainder: take from the largest allocations
    deficit = torch.clamp_min(-rem, 0.0)
    big_order = torch.argsort(-out, dim=-1, stable=True)
    big_rank = torch.argsort(big_order, dim=-1, stable=True)
    take = (big_rank < deficit[:, None]) & (out > 1.0)
    return out - torch.where(take, 1.0, 0.0)


def _seg_sum(x, onehot):
    """Sum of per-layer x (B, L) into segments -> (B, NS).  A product and
    a sum, not a matmul: no contraction of the port reaches a tensor core,
    whatever the TF32 flags say."""
    return (x[..., None] * onehot).sum(1)


def _seg_max(x, onehot):
    return torch.where(onehot > 0, x[..., None], NEG).amax(dim=1)


def seg_scan_max(vals, start_flags, reverse=False):
    """Running max within groups delimited by start_flags (B, L).

    A Hillis–Steele doubling scan over (flag, value) pairs: log2(L)
    steps, exact since max is exact in any association.  A flagged element
    STARTS its own group; with ``reverse=True`` the scan runs right-to-left
    (flags then mark group *ends*)."""
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
    """``take_along_axis(a, idx, 1)`` for (B, n) ``a`` and (B, m) ``idx``."""
    return torch.take_along_dim(a, idx.long(), dim=1)


# --------------------------------------------------------------------------
# the core (works on any batch size; callers block it)
# --------------------------------------------------------------------------
class _CEMaps(NamedTuple):
    seg_start: torch.Tensor
    seg_len: torch.Tensor
    seg_valid: torch.Tensor
    n_seg: torch.Tensor
    seg_of_layer: torch.Tensor
    onehot: torch.Tensor
    valid_b: torch.Tensor       # (B, max_L) bool
    idx_in_seg: torch.Tensor
    nce_of_layer: torch.Tensor
    pipe_bool: torch.Tensor     # (B, max_L) bool (masked to valid layers)
    slot_of_layer: torch.Tensor
    round_of_layer: torch.Tensor
    ce_base: torch.Tensor
    ce_of_layer: torch.Tensor   # clipped to [0, NC)
    ce_oh: torch.Tensor
    ce_live: torch.Tensor       # (B, max_L) f32: 1.0 where ce_oh's row
                                # is not zero
    pes_ce: torch.Tensor
    ce_valid: torch.Tensor


def _ce_maps(design: DesignBatch, t: NetTables, dev: DeviceTables) -> _CEMaps:
    """Layer -> segment / CE maps + the PE distribution (Eq. 1 prologue)."""
    B, max_L = design.batch, t.max_L
    layer_ix = torch.arange(max_L, device=t.device)

    seg_end = design.seg_end                      # (B, NS)
    seg_start = torch.cat(
        [torch.zeros_like(seg_end[:, :1]), seg_end[:, :-1]], 1)
    seg_len = seg_end - seg_start                 # (B, NS)
    seg_valid = seg_len > 0
    n_seg = seg_valid.sum(-1)                     # (B,)

    # seg of layer: first segment with end > l (padded layers clip to the
    # last column; the valid mask removes them from every reduction)
    seg_of_layer = torch.clamp_max(
        (layer_ix[None, :, None] >= seg_end[:, None, :]).sum(-1), NS - 1)
    valid_b = (layer_ix < t.L)[None, :].expand(B, max_L)
    valid_layer = valid_b.to(F32) * t.valid[None, :]
    onehot = _onehot(seg_of_layer, NS) * valid_layer[..., None]

    idx_in_seg = layer_ix[None, :] - _take(seg_start, seg_of_layer)
    nce_of_layer = _take(design.seg_nce, seg_of_layer)
    pipe_bool = _take(design.seg_pipe, seg_of_layer) & valid_b
    nce1 = torch.clamp_min(nce_of_layer, 1)
    slot_of_layer = torch.remainder(idx_in_seg, nce1)
    round_of_layer = torch.div(idx_in_seg, nce1, rounding_mode="floor")

    live_nce = design.seg_nce * seg_valid
    ce_base = torch.cumsum(live_nce, -1) - live_nce
    ce_of_layer = _take(ce_base, seg_of_layer) + slot_of_layer   # (B, L)
    # overflowing CEs (non-canonical rows) and padded layers map to a zero
    # one-hot row; the clip keeps the gathers in bounds
    ce_oh = _onehot(ce_of_layer, NC) * valid_layer[..., None]
    ce_live = (ce_of_layer < NC).to(F32) * valid_layer
    ce_of_layer = ce_of_layer.clamp(0, NC - 1)

    # PE distribution (largest remainder over per-CE MACs)
    macs_ce = _dot_sum(t.MACS[None, :, None] * ce_oh)
    ce_valid = ce_oh.amax(1) > 0
    pes_ce = _largest_remainder(macs_ce, dev.pes, ce_valid)
    return _CEMaps(seg_start, seg_len, seg_valid, n_seg, seg_of_layer,
                   onehot, valid_b, idx_in_seg, nce_of_layer, pipe_bool,
                   slot_of_layer, round_of_layer, ce_base, ce_of_layer,
                   ce_oh, ce_live, pes_ce, ce_valid)


def _per_layer(x_ce, m: _CEMaps):
    """Each layer's value of its CE's entry of ``x_ce`` (B, NC) -> (B, L);
    0 for a layer with no CE (the one-hot contraction's zero row)."""
    return _take(x_ce, m.ce_of_layer) * m.ce_live


def _per_ce(x, m: _CEMaps):
    """Sum of per-layer x (B, L) into CEs -> (B, NC) (see _seg_sum)."""
    return (x[..., None] * m.ce_oh).sum(1)


def _search_ce(m: _CEMaps) -> torch.Tensor:
    """(B, L) int32 CE of each layer for the fused search: -1 for a layer
    with no CE (the one-hot's zero row)."""
    return torch.where(m.ce_live > 0, m.ce_of_layer, -1).to(torch.int32)


class SearchTables(NamedTuple):
    """What the fused search reads besides each design's PEs and CE map:
    the arguments after ``ce_idx`` of ``parallelism_search``, built once
    per ``evaluate_batch`` on the tables' device."""

    fc_pair: torch.Tensor       # (max_L, P) ceil(F/pf) * CKK
    coh_pair: torch.Tensor      # (max_L, P) ceil(OH/ph)
    ow: torch.Tensor            # (max_L,)
    cand: torch.Tensor          # (K,)
    pair_prod: torch.Tensor     # (P,)
    pair_pf: torch.Tensor       # (P,)
    pair_ph: torch.Tensor       # (P,)


def _pair_layer_tables(t: NetTables, pairs) -> SearchTables:
    """Per-(layer, pair) factor tables and the pair list for the fused
    search."""
    on_dev = lambda a, dtype=F32: torch.as_tensor(a, dtype=dtype,
                                                  device=t.device)
    pi = on_dev(pairs.pair_i, torch.long)
    pj = on_dev(pairs.pair_j, torch.long)
    return SearchTables(t.CEIL_F[:, pi] * t.CKK[:, None], t.CEIL_OH[:, pj],
                        t.OW, on_dev(pairs.cand), on_dev(pairs.pair_prod),
                        on_dev(pairs.pair_pf), on_dev(pairs.pair_ph))


class LayerState(NamedTuple):
    """Per-layer cost state between Eq. 1 and the Eq. 2–9 composition.

    ``layer_state`` computes it; ``compose_metrics`` reduces it to the
    metric dict.  Per-layer tensors are (B, L); per-segment ones (B, NS).
    """

    # Eq. 1 compute + utilization
    comp: torch.Tensor          # compute cycles
    util: torch.Tensor
    # single-CE (Eq. 6) costs
    lat_single: torch.Tensor    # max(comp, mem) — pre single_l masking
    acc_single: torch.Tensor    # off-chip bytes
    wacc_single: torch.Tensor
    facc_single: torch.Tensor
    mem_cyc_single: torch.Tensor
    # pipelined (Eq. 7) costs
    busy_pipe: torch.Tensor     # max(comp, mem) per layer slot
    w_acc_pipe: torch.Tensor
    mem_cyc_pipe: torch.Tensor
    n_tiles_l: torch.Tensor
    # mapping inputs
    buf_l: torch.Tensor         # single: the segment's buffer alloc
    ce_buf_l: torch.Tensor      # pipelined: the layer's CE buffer slice
    wtile: torch.Tensor         # streaming weight-tile bytes (pf rows)
    fm_tile2: torch.Tensor      # double-buffered fm tile bytes
    ofm_res: torch.Tensor       # OFM bytes held resident (Eq. 6)
    ofm_acc: torch.Tensor       # OFM bytes streamed off-chip
    ideal: torch.Tensor         # bool: whole working set fits
    ifm_onchip: torch.Tensor    # bool: IFM left on chip by producer
    use_a: torch.Tensor         # bool: Eq. 6 picked option A (IS) over B
    resident_l: torch.Tensor    # bool: Eq. 5 whole-segment weight regime
    # per-segment allocations / boundaries
    alloc: torch.Tensor
    desires: torch.Tensor
    inter_onchip: torch.Tensor  # bool
    bound_valid: torch.Tensor   # bool
    is_pipe_seg: torch.Tensor   # bool


def layer_state(design: DesignBatch, t: NetTables, dev: DeviceTables,
                m: _CEMaps, par, fm_tile_rows: int) -> LayerState:
    """Eqs. 1 + 4–7 given the CE maps and the ⟨pf, ph, pw⟩ winners:
    buffer allocation, per-layer compute/memory costs, residency regimes."""
    B, max_L = design.batch, t.max_L
    wb = dev.col("wordbytes")
    bpc = dev.col("bpc")
    pf_ce, ph_ce, pw_ce = par
    onehot, valid_b, seg_of_layer = m.onehot, m.valid_b, m.seg_of_layer
    seg_valid, n_seg, pipe_bool = m.seg_valid, m.n_seg, m.pipe_bool
    valid_f = valid_b.to(F32)
    seg_end = design.seg_end

    # ---- per-layer compute cycles & utilization --------------------------
    macs, ckk = t.MACS, t.CKK
    pf_l = torch.where(valid_b, _per_layer(pf_ce, m), 1.0)
    ph_l = torch.where(valid_b, _per_layer(ph_ce, m), 1.0)
    pw_l = torch.where(valid_b, _per_layer(pw_ce, m), 1.0)
    F, OH, OW = t.F, t.OH, t.OW
    comp = (torch.ceil(F[None] / pf_l) * ckk[None]
            * torch.ceil(OH[None] / ph_l) * torch.ceil(OW[None] / pw_l))
    par_total = pf_l * ph_l * pw_l
    util = macs[None] / torch.clamp_min(comp * par_total, 1.0)

    pipe_l = pipe_bool.to(F32)
    single_l = (1.0 - pipe_l) * valid_f

    # ---- buffer floors / desires (Eq. 4 / 5) ------------------------------
    W, IFM, OFM = t.W, t.IFM, t.OFM
    EXTRA, BAND, OFM_ROW = t.EXTRA, t.BAND, t.OFM_ROW
    FMS = IFM + OFM + EXTRA

    wtile = torch.minimum(pf_l, F[None]) * ckk[None] * wb  # (B, L)
    fm_tile2 = 2.0 * OFM_ROW[None] * fm_tile_rows * wb

    # pipelined: floor = sum(2*fm_tile + wtile); desire = sum(W + 2*fm_tile)
    floor_pipe = _seg_sum((fm_tile2 + wtile) * pipe_l, onehot)
    desire_pipe = _seg_sum((W[None] * wb + fm_tile2) * pipe_l, onehot)
    # single: floor = max(wtile + band + ofm_row); desire = max FMS + max wtile
    floor_single = _seg_max(
        torch.where(single_l > 0, wtile + (BAND + OFM_ROW)[None] * wb, NEG),
        onehot)
    max_fms = _seg_max(torch.where(single_l > 0, FMS[None] * wb, NEG),
                       onehot)
    max_wtile = _seg_max(torch.where(single_l > 0, wtile, NEG), onehot)
    desire_single = max_fms + max_wtile

    is_pipe_seg = design.seg_pipe & seg_valid
    floors = torch.where(is_pipe_seg, floor_pipe, torch.where(
        seg_valid, torch.clamp_min(floor_single, 0.0), 0.0))
    desires = torch.where(is_pipe_seg, desire_pipe, torch.where(
        seg_valid, torch.clamp_min(desire_single, 0.0), 0.0))
    desires = torch.maximum(desires, floors)

    budget_b = dev.on_chip_bytes
    alloc = floors
    over = _seq_sum(alloc) > budget_b
    scale = torch.where(
        over, budget_b / torch.clamp_min(_seq_sum(alloc), 1.0), 1.0)
    alloc = torch.floor(alloc * scale[:, None])
    remaining = budget_b - _seq_sum(alloc)               # (B,)

    # ---- inter-segment double buffers, smallest-first ---------------------
    # boundary i lives after segment i (valid while i < n_seg - 1)
    b_ix = torch.arange(NS, device=t.device)
    bound_valid = b_ix[None, :] < (n_seg - 1)[:, None]
    last_of_seg = torch.clamp(seg_end - 1, 0, t.L - 1).long()   # (B, NS)
    bound_size = OFM[last_of_seg] * wb                   # (B, NS)
    bound_size = torch.where(bound_valid, bound_size, torch.inf)
    order = torch.argsort(bound_size, dim=-1, stable=True)
    sorted_sz = torch.take_along_dim(bound_size, order, dim=-1)
    finite = torch.isfinite(sorted_sz)
    csum = _seq_cumsum(torch.where(finite, 2 * sorted_sz, 0.0))
    fit_sorted = (csum <= remaining[:, None]) & finite
    fit = torch.zeros_like(fit_sorted).scatter(1, order, fit_sorted)
    inter_onchip = fit & bound_valid & design.inter_pipe[:, None]
    remaining = remaining - _seq_sum(
        2 * torch.where(inter_onchip, OFM[last_of_seg] * wb, 0.0))

    # ---- grant remaining toward minimum-access desires --------------------
    gaps = torch.clamp_min(desires - alloc, 0.0)
    gap_sum = _seq_sum(gaps)
    grant = torch.minimum(torch.clamp_min(remaining, 0.0), gap_sum)
    alloc = alloc + torch.where(
        gap_sum[:, None] > 0,
        torch.floor(grant[:, None] * gaps
                    / torch.clamp_min(gap_sum[:, None], 1.0)), 0.0)

    # ---- pipelined per-CE buffer split (desire share within segment) ------
    ce_desire_l = (W[None] * wb + fm_tile2) * pipe_l     # (B, L)
    ce_desire = _per_ce(ce_desire_l, m)
    seg_of_ce_desire = _seg_sum(ce_desire_l, onehot)     # (B, NS)
    alloc_of_layer = _take(alloc, seg_of_layer)
    segdes_of_layer = _take(torch.clamp_min(seg_of_ce_desire, 1.0),
                            seg_of_layer)
    cedes_of_layer = _per_layer(ce_desire, m)
    ce_buf_of_layer = torch.floor(
        alloc_of_layer * cedes_of_layer / segdes_of_layer)

    # weights resident (Eq. 5 regime): alloc covers the Eq. 5 requirement
    resident_seg = (alloc >= desire_pipe) & is_pipe_seg
    resident_l = _take(resident_seg, seg_of_layer)

    # n_tiles per layer: max OH over the layers of the same (seg, round),
    # the combine of a forward and a backward segmented max-scan
    is_round_start, is_round_last = _round_flags(m)
    OH_b = OH[None].expand(B, max_L)
    n_tiles_l = torch.clamp_min(torch.maximum(
        seg_scan_max(OH_b, is_round_start),
        seg_scan_max(OH_b, is_round_last, reverse=True)), 1.0)

    # ---- off-chip accesses ------------------------------------------------
    # pipelined (Eq. 7)
    w_bytes = W[None] * wb
    w_acc_pipe = torch.where(
        resident_l, 0.0,
        torch.where(ce_buf_of_layer >= w_bytes, w_bytes,
                    w_bytes * n_tiles_l))
    mem_cyc_pipe = w_acc_pipe / bpc

    # single (Eq. 6): layer l's residency verdict doesn't depend on a
    # carry, so the ifm_onchip chain is a shift by one within a segment
    buf = alloc_of_layer                                 # (B, L)
    wl = W[None] * wb
    ifml = IFM[None] * wb
    ofml = OFM[None] * wb
    extral = EXTRA[None] * wb
    ideal = ifml + ofml + extral + wtile <= buf          # (B, L)

    ifm_tile = torch.minimum(ifml, BAND[None] * wb)
    ofm_on = ofml + extral + wtile + ifm_tile <= buf
    ofm_res = torch.where(ofm_on, ofml + extral, 0.0)
    ofm_acc = torch.where(ofm_on, 0.0, ofml)

    # layer l leaves its OFM on-chip for l+1 iff ideal or ofm_on
    next_on = ideal | ofm_on                             # (B, L)
    prev_on = torch.cat(
        [torch.zeros_like(next_on[:, :1]), next_on[:, :-1]], 1)
    is_seg_start = m.idx_in_seg == 0
    prev_boundary_onchip = _take(
        inter_onchip, torch.clamp_min(seg_of_layer - 1, 0)) \
        & (seg_of_layer > 0)
    ifm_onchip = torch.where(is_seg_start, prev_boundary_onchip, prev_on)

    fm_ideal = torch.where(ifm_onchip, 0.0, ifml)
    acc_prev_resident = ofm_acc + wl                     # ifm already on-chip
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
        ifm_onchip, acc_prev_resident, acc_opt))
    wacc_single = torch.where(ideal, wl, torch.where(ifm_onchip, wl,
                                                     wacc_opt))
    facc_single = torch.where(ideal, fm_ideal, torch.where(
        ifm_onchip, ofm_acc, facc_opt))
    mem_cyc_single = acc_single / bpc

    return LayerState(
        comp=comp, util=util,
        lat_single=torch.maximum(comp, mem_cyc_single),
        acc_single=acc_single, wacc_single=wacc_single,
        facc_single=facc_single, mem_cyc_single=mem_cyc_single,
        busy_pipe=torch.maximum(comp, mem_cyc_pipe),
        w_acc_pipe=w_acc_pipe, mem_cyc_pipe=mem_cyc_pipe,
        n_tiles_l=n_tiles_l,
        buf_l=buf, ce_buf_l=ce_buf_of_layer, wtile=wtile,
        fm_tile2=fm_tile2, ofm_res=ofm_res, ofm_acc=ofm_acc,
        ideal=ideal, ifm_onchip=ifm_onchip, use_a=use_a,
        resident_l=resident_l,
        alloc=alloc, desires=desires, inter_onchip=inter_onchip,
        bound_valid=bound_valid, is_pipe_seg=is_pipe_seg)


def _round_flags(m: _CEMaps):
    """(is_round_start, is_round_last): a layer opens / closes its round
    of a pipelined block's CE slots."""
    is_round_start = m.slot_of_layer == 0
    is_round_last = (m.slot_of_layer == m.nce_of_layer - 1) | \
        (m.idx_in_seg == _take(m.seg_len, m.seg_of_layer) - 1)
    return is_round_start, is_round_last


def compose_metrics(design: DesignBatch, t: NetTables, dev: DeviceTables,
                    m: _CEMaps, st: LayerState) -> dict[str, torch.Tensor]:
    """Eqs. 2–3 + 8–9: per-layer costs -> design metrics."""
    B = design.batch
    wb = dev.col("wordbytes")
    seg_valid, n_seg, pipe_bool = m.seg_valid, m.n_seg, m.pipe_bool
    valid_f = m.valid_b.to(F32)
    seg_end = design.seg_end
    pipe_l = pipe_bool.to(F32)
    single_l = (1.0 - pipe_l) * valid_f
    is_round_start, is_round_last = _round_flags(m)
    last_of_seg = torch.clamp(seg_end - 1, 0, t.L - 1).long()   # (B, NS)
    OFM, IFM, macs = t.OFM, t.IFM, t.MACS
    n_tiles_l = st.n_tiles_l
    inter_onchip, bound_valid = st.inter_onchip, st.bound_valid
    is_pipe_seg = st.is_pipe_seg
    alloc, desires = st.alloc, st.desires

    # ---- latency / busy ---------------------------------------------------
    lat_l_single = st.lat_single * single_l
    seg_lat_single = _seg_sum(lat_l_single, m.onehot)    # (B, NS)

    # pipelined: tile lat per layer; exact stage-sum per round via the
    # prefix/suffix-max identity (segmented max-scans, log2(L) steps).
    tile_lat = st.busy_pipe / n_tiles_l                  # (B, L)
    pmax_seq = seg_scan_max(tile_lat, is_round_start)
    smax_seq = seg_scan_max(tile_lat, is_round_last, reverse=True)
    prefix_sum_all = torch.where(pipe_bool, pmax_seq, 0.0).sum(-1)
    suffix_sum_all = torch.where(pipe_bool, smax_seq, 0.0).sum(-1)
    round_last = pipe_bool & is_round_last
    gmax_l = torch.where(round_last, pmax_seq, 0.0)

    # round latency = prefix_sum(0..n-1) + suffix_sum(0..n-1) - gmax
    #                 + (T - n) * gmax            [T = n_tiles, n = slots]
    slots_round = torch.where(round_last, m.slot_of_layer.to(F32) + 1.0, 0.0)
    T_round = torch.where(round_last, n_tiles_l, 0.0)
    lat_pipe_total = (prefix_sum_all + suffix_sum_all
                      + ((T_round - slots_round - 1.0) * gmax_l).sum(-1))

    # per-CE busy (Eq. 3 / throughput)
    busy_slot = _per_ce(st.busy_pipe * pipe_l, m)       # (B, NC)
    # pipelined block busy = max over its slots; map back per segment
    seg_of_ce = (torch.arange(NC, device=t.device)[None, :, None]
                 >= (m.ce_base + design.seg_nce * seg_valid)[:, None, :]
                 ).sum(-1)                               # (B, NC)
    seg_ce_oh = _onehot(seg_of_ce, NS)
    busy_pipe_seg = torch.where(
        is_pipe_seg,
        torch.where(seg_ce_oh > 0, busy_slot[..., None], NEG).amax(1),
        0.0)
    single_seg = ~design.seg_pipe & seg_valid
    busy_single_seg = torch.where(single_seg, seg_lat_single, 0.0)

    # single-CE ids may serve multiple segments: busy adds per CE.  A
    # segment's first CE id is ce_base; the ids that repeat are those of
    # empty segments, which add 0.0.
    ce_first = m.ce_base.long()                          # (B, NS)
    zeros = torch.zeros(B, NC, dtype=F32, device=t.device)
    in_range = ce_first < NC
    ce_first = ce_first.clamp_max(NC - 1)
    add_single = zeros.scatter_add(1, ce_first, torch.where(
        single_seg & in_range, busy_single_seg, 0.0))
    add_pipe = zeros.scatter_add(1, ce_first, torch.where(
        in_range, busy_pipe_seg, 0.0))
    ce_busy = add_single + add_pipe

    # ---- interfaces: mandatory IO + Eq. 9 ---------------------------------
    access = (st.acc_single * single_l + st.w_acc_pipe * pipe_l).sum(-1)
    w_access = (st.wacc_single * single_l + st.w_acc_pipe * pipe_l).sum(-1)
    fm_access = (st.facc_single * single_l).sum(-1)
    mandatory = (IFM[0] + OFM[t.L - 1]) * dev.wordbytes
    access = access + mandatory
    fm_access = fm_access + mandatory

    bound_sz = torch.where(bound_valid, OFM[last_of_seg] * wb, 0.0)
    spill = bound_valid & ~inter_onchip
    spill_acc = _seq_sum(2 * torch.where(spill, bound_sz, 0.0))
    access = access + spill_acc
    fm_access = fm_access + spill_acc
    comm_cyc = _seq_sum((torch.where(spill, 2 * bound_sz, bound_sz)
                         / dev.col("bps")) * dev.col("clock_hz")
                        * bound_valid)

    latency_cyc = _seq_sum(seg_lat_single) + lat_pipe_total + comm_cyc
    latency_s = latency_cyc / dev.clock_hz

    busy_max = ce_busy.amax(-1)
    multi = (n_seg > 1) & design.inter_pipe
    bottleneck = torch.where(multi, busy_max, torch.where(
        n_seg > 1, latency_cyc, torch.clamp_min(busy_max, 1.0)))
    throughput = dev.clock_hz / torch.clamp_min(bottleneck, 1.0)

    buffer_alloc = _seq_sum(alloc) + _seq_sum(
        2 * torch.where(inter_onchip, bound_sz, 0.0))
    # Eq. 8 requirement (what the paper's buffer metric reports)
    buffer_req = _seq_sum(desires) + torch.where(
        design.inter_pipe, _seq_sum(2 * bound_sz), 0.0)

    util_avg = (st.util * macs[None]).sum(-1) / torch.clamp_min(
        macs.sum(), 1.0)

    return {
        "latency_s": latency_s,
        "throughput_ips": throughput,
        "buffer_bytes": buffer_req,
        "buffer_alloc_bytes": buffer_alloc,
        "access_bytes": access,
        "weight_access_bytes": w_access,
        "fm_access_bytes": fm_access,
        "utilization": util_avg,
        "n_ces": m.ce_valid.sum(-1).to(torch.int32),
    }


def eval_design_block(design: DesignBatch, tables: NetTables,
                      dev: DeviceTables, search: SearchTables, *,
                      fm_tile_rows: int = 2) -> dict[str, torch.Tensor]:
    """Evaluation of one design block (no blocking or padding):
    CE maps -> fused ⟨pf, ph, pw⟩ search -> Eqs. 2–9, each stage a
    span (``batch.block`` and its children)."""
    with telemetry.span("batch.block"):
        with telemetry.span("batch.ce_maps"):
            m = _ce_maps(design, tables, dev)
        with telemetry.span("batch.search"):
            pf, ph, pw, _cost = parallelism_search(m.pes_ce, _search_ce(m),
                                                   *search)
        with telemetry.span("batch.layer_state"):
            st = layer_state(design, tables, dev, m, (pf, ph, pw),
                             fm_tile_rows)
        with telemetry.span("batch.compose"):
            return compose_metrics(design, tables, dev, m, st)


def _pad_rows(design: DesignBatch, n: int) -> DesignBatch:
    """Edge-pad a DesignBatch to ``n`` rows (padded rows are evaluated and
    discarded, so every chunk of a spec list has one shape)."""
    pad = n - design.batch
    if pad <= 0:
        return design
    rep = lambda a: torch.cat([a, a[-1:].repeat_interleave(pad, 0)], 0)
    return DesignBatch(rep(design.seg_end), rep(design.seg_pipe),
                       rep(design.seg_nce), rep(design.inter_pipe))


def padded_rows(B: int, tile: int = DEFAULT_TILE, ndevices: int = 1) -> int:
    """Rows a B-design sharded call executes: B padded to a multiple of
    ``ndevices x tile``, so every shard of the mesh (``core.shard``) holds
    the same whole number of tiles."""
    unit = tile * max(int(ndevices), 1)
    return -(-B // unit) * unit


def search_setup(tables: NetTables, dev: DeviceSpec | DeviceTables,
                 full_pes: float | None = None
                 ) -> tuple[DeviceTables, SearchTables]:
    """The set-up a batch call shares, on the tables' device: the board's
    ``DeviceTables`` and the search's ``SearchTables`` (the pair list).  A
    caller that runs many batches, or the shards of a mesh, builds it once
    and passes it as ``pairs=`` (:func:`evaluate_batch`), so no call does
    this host-side work again.

    The pair list is pruned for the board's PE count, or for ``full_pes``
    when given: a per-row board must name the full board it was cut from
    (slices never exceed it, so pruning for it stays sound on every row).
    """
    device = tables.device
    if isinstance(dev, DeviceSpec):
        hint = pes_hint(dev.pes if full_pes is None else full_pes)
        dev = make_device_tables(dev, device=device)
    elif full_pes is not None:
        hint = pes_hint(full_pes)
    elif dev.per_row:
        raise ValueError("per-row boards need full_pes, the PE count of "
                         "the board they were cut from")
    else:
        hint = pes_hint(float(dev.pes))
    return dev, _pair_layer_tables(tables,
                                   pair_tables(tables.candidates, hint))


def _blocks(design: DesignBatch, tables: NetTables,
            dev: DeviceSpec | DeviceTables, *, tile: int = DEFAULT_TILE,
            chunk: int = DEFAULT_CHUNK, full_pes: float | None = None,
            pairs: SearchTables | None = None):
    """The board's ``DeviceTables``, the search's ``SearchTables`` (from
    :func:`search_setup`, unless ``pairs`` gives them with ``dev`` as
    ``DeviceTables``) and the row blocks, all on the tables' device.  A
    block is ``chunk`` designs on the card (one search-kernel launch) and
    ``tile`` designs on the CPU; each is a ``(designs, boards)`` pair, the
    boards cut to the block's rows when ``dev`` holds one board per row.
    """
    device = tables.device
    with telemetry.span("batch.setup"):
        if pairs is None:
            dev, pairs = search_setup(tables, dev, full_pes)
        if design.batch == 0:
            raise ValueError("no designs to evaluate (empty DesignBatch)")
        if dev.per_row and dev.pes.shape[0] != design.batch:
            raise ValueError(f"{dev.pes.shape[0]} board rows for "
                             f"{design.batch} designs")
        design = design.to(device)
        rows = tile if device.type == "cpu" else chunk
        return dev, pairs, [(design.take(slice(s, s + rows)),
                             dev.take(slice(s, s + rows)))
                            for s in range(0, design.batch, rows)]


def _cat_blocks(outs: list[dict]) -> dict:
    """Row-concatenate the per-block output dicts."""
    if len(outs) == 1:
        return outs[0]
    return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}


def evaluate_batch(design: DesignBatch, tables: NetTables,
                   dev: DeviceSpec | DeviceTables, fm_tile_rows: int = 2,
                   *, tile: int = DEFAULT_TILE, chunk: int = DEFAULT_CHUNK,
                   full_pes: float | None = None,
                   pairs: SearchTables | None = None,
                   mesh=None) -> dict[str, torch.Tensor]:
    """DesignBatch -> metric tensors on the tables' device.

    The batch runs in blocks of ``chunk`` designs on the card (one search
    kernel launch per block) and of ``tile`` designs on the CPU.  ``dev``
    is one board, or ``DeviceTables`` with one board per design row; those
    need ``full_pes`` (see :func:`search_setup`).  ``pairs``, with ``dev``
    as ``DeviceTables``, is the set-up :func:`search_setup` built for
    these tables and this board, used as it is.

    ``mesh`` (a ``core.shard.EvalMesh``, duck-typed to avoid an import
    cycle) shards the design axis across its devices, the metrics landing
    on its first device; a None or single-device mesh takes this
    unchanged single-device path.
    """
    if mesh is not None and getattr(mesh, "is_sharded", False):
        return mesh.evaluate_padded(design, tables, dev, tile=tile,
                                    chunk=chunk, fm_tile_rows=fm_tile_rows,
                                    full_pes=full_pes, pairs=pairs)
    _, search, parts = _blocks(design, tables, dev, tile=tile, chunk=chunk,
                               full_pes=full_pes, pairs=pairs)
    return _cat_blocks([eval_design_block(b, tables, d, search,
                                          fm_tile_rows=fm_tile_rows)
                        for b, d in parts])


# --------------------------------------------------------------------------
# spec lists
# --------------------------------------------------------------------------
def _bucket(b: int, tile: int, ndevices: int = 1) -> int:
    """Smallest power-of-two multiple of ``ndevices x tile`` holding ``b``
    designs: bounds the number of distinct chunk shapes to the ladder
    size, and keeps every bucket evenly shardable across the mesh."""
    n = tile * max(int(ndevices), 1)
    while n < b:
        n *= 2
    return n


def _evaluate_specs(specs: list[AcceleratorSpec], net: Network,
                    dev: DeviceSpec | DeviceTables,
                    chunk: int = DEFAULT_CHUNK, *,
                    tables: NetTables | None = None,
                    tile: int = DEFAULT_TILE, pad_to: int | None = None,
                    fm_tile_rows: int = 2, device="cuda",
                    batch_fn=None, mesh=None) -> dict[str, np.ndarray]:
    """Specs -> stacked host metric arrays, ``chunk`` specs at a time.

    Every chunk, the tail included, is padded to one row count
    (``pad_to``, by default ``chunk`` or the bucket of a shorter list,
    which under a sharded ``mesh`` is a multiple of ``ndevices x tile``).
    ``device`` is where the tables are built when ``tables`` is None.
    ``batch_fn`` is the batch path each chunk runs through: by default
    :func:`evaluate_batch` (sharded over ``mesh``), or the schedule
    layer's ``schedule_batch``, which takes the same arguments.
    """
    if not specs:
        raise ValueError("no specs to evaluate (empty design list)")
    tables = make_tables(net, device=device) if tables is None else tables
    nd = mesh.ndevices if mesh is not None and mesh.is_sharded else 1
    n_layers = len(net)
    outs: list[dict] = []
    n = len(specs)
    if pad_to is None:
        pad_to = chunk if n > chunk else _bucket(max(n, 1), tile, nd)
    if batch_fn is None:
        batch_fn = partial(evaluate_batch, mesh=mesh)
    for i in range(0, n, chunk):
        sub = specs[i:i + chunk]
        batch = _pad_rows(encode_specs(sub, n_layers, device=tables.device),
                          pad_to)
        out = batch_fn(
            batch, tables, dev, fm_tile_rows, tile=tile,
            chunk=max(chunk, pad_to))
        outs.append({k: v[:len(sub)].cpu().numpy() for k, v in out.items()})
    return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
